"""Rule registry for the AST lint engine.

Each rule module exposes a single ``RULE`` object: a name (``LWCnnn``),
a one-line summary, and a ``check(ParsedModule) -> list[Finding]``
callable.  ``ALL_RULES`` is the ordered registry the engine and CLI
iterate; adding a rule means adding a module here and one line below.
The rules keep the reference's ids and predicates
(``llm_weighted_consensus_tpu/analysis/rules/``), with the port's file
names; LWC009 and LWC013 check torch calls where the reference's check
``jax.*`` and ``block_until_ready``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from ..engine import Finding, ParsedModule


@dataclass(frozen=True)
class Rule:
    name: str
    summary: str
    # per-module check; None for purely project-scoped rules
    check: Optional[Callable[[ParsedModule], List[Finding]]]
    # whole-parsed-set check (declared-vs-used registries and other
    # cross-module invariants); runs once after every module is parsed
    project: Optional[
        Callable[[List[ParsedModule]], List[Finding]]
    ] = None


from . import (  # noqa: E402
    lwc001_swallowed_cancellation,
    lwc002_orphaned_task,
    lwc003_release_in_finally,
    lwc004_contextvar_token,
    lwc005_decimal_purity,
    lwc006_blocking_in_async,
    lwc007_envelope_kind,
    lwc008_env_read_outside_config,
    lwc009_torch_in_async,
    lwc010_registry_consistency,
    lwc011_config_readme_drift,
    lwc012_prom_family_registry,
    lwc013_blocking_readiness,
    lwc014_guarded_field,
    lwc015_lock_order,
    lwc016_blocking_under_lock,
    lwc017_frame_rebuild_in_merge_loop,
    lwc018_unbounded_ingest_growth,
)

ALL_RULES: Tuple[Rule, ...] = (
    lwc001_swallowed_cancellation.RULE,
    lwc002_orphaned_task.RULE,
    lwc003_release_in_finally.RULE,
    lwc004_contextvar_token.RULE,
    lwc005_decimal_purity.RULE,
    lwc006_blocking_in_async.RULE,
    lwc007_envelope_kind.RULE,
    lwc008_env_read_outside_config.RULE,
    lwc009_torch_in_async.RULE,
    lwc010_registry_consistency.RULE,
    lwc011_config_readme_drift.RULE,
    lwc012_prom_family_registry.RULE,
    lwc013_blocking_readiness.RULE,
    lwc014_guarded_field.RULE,
    lwc015_lock_order.RULE,
    lwc016_blocking_under_lock.RULE,
    lwc017_frame_rebuild_in_merge_loop.RULE,
    lwc018_unbounded_ingest_growth.RULE,
)

RULES_BY_NAME = {rule.name: rule for rule in ALL_RULES}

__all__ = ["Rule", "ALL_RULES", "RULES_BY_NAME"]
