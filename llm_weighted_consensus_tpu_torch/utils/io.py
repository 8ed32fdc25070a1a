"""Small filesystem helpers shared by the snapshot writers.

The port's copy of ``llm_weighted_consensus_tpu/utils/io.py``: the
training-table snapshot (``TABLES_PATH``) and the score cache's disk tier
write through them.
"""

from __future__ import annotations

import os


def atomic_write(path: str, write_fn) -> None:
    """Write via a temp file + ``os.replace`` so readers never observe a
    truncated file and concurrent writers can't corrupt each other.
    ``write_fn(f)`` receives the open binary file object."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def probe_writable(path: str) -> None:
    """Fail fast (OSError) if ``path`` cannot be written, without writing
    anything expensive: create + remove a tiny sibling temp file."""
    probe = f"{path}.probe.{os.getpid()}"
    with open(probe, "wb") as f:
        f.write(b"")
    os.unlink(probe)


def probe_writable_config(path: str, env_name: str, consequence: str) -> None:
    """``probe_writable`` for an env-configured snapshot path: failures
    name the variable and what would be lost, so a startup refusal points
    the operator at the fix."""
    try:
        probe_writable(path)
    except OSError as exc:
        raise OSError(
            f"{env_name}={path!r} is not writable ({exc}); {consequence}"
        ) from exc
