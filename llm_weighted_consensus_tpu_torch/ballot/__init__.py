"""Randomized prefix-tree ballots + vote extraction (pure core).

The consensus engine asks each judge LLM to *select* the best candidate from a
randomized ballot.  Every candidate is assigned a key of backtick-quoted
letters from a 20-symbol alphabet (A-T); both the letter assignment and the
candidate presentation order are shuffled per judge (anti-position-bias).
When the candidate count exceeds the branching limit the tree nests, giving
multi-letter keys like ```C``B```.

Vote extraction finds the *last* ballot-key occurrence in the judge's output,
walks the prefix tree to the selected leaf, and — when token logprobs are
available — converts the ``top_logprobs`` alternatives of the final key letter
into a normalized probability distribution over candidates (a *soft vote*);
otherwise the vote is one-hot.

Parity target: reference src/score/completions/client.rs:1342-1800
(SelectPfx/SelectPfxTree/get_vote) and 497-659 (ballot prompt + output
forcing).  This module is pure Python: no IO, no device.

The port's copy of ``llm_weighted_consensus_tpu/ballot/``.  The ballot's
generator stays Python's ``random.Random``: parity of a ballot needs the
reference's exact sequence of ``rng.shuffle`` calls, which a torch
generator would not give.
"""

from .tree import (
    ALPHABET,
    MAX_BRANCH,
    PrefixTree,
    branch_limit,
    serialize_ballot,
)
from .vote import InvalidContentError, extract_vote
from .prompting import (
    ballot_instruction,
    response_format_for,
    response_key_schema,
)

__all__ = [
    "ALPHABET",
    "MAX_BRANCH",
    "PrefixTree",
    "branch_limit",
    "serialize_ballot",
    "InvalidContentError",
    "extract_vote",
    "ballot_instruction",
    "response_format_for",
    "response_key_schema",
]
