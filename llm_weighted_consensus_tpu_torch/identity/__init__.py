"""Content-addressed identity: canonical JSON -> xxh3-128 -> base62(22).

Parity target: reference src/score/llm/mod.rs:513-548 and
src/score/model/mod.rs:97-189.  The pipeline is identical (xxh3-128 with seed
0 over a canonical JSON string, base62-encoded and zero-padded to 22 chars),
but the canonical JSON is produced by this framework's own writer
(utils/jsonutil), so ids form this framework's own id space ("v1") rather
than being byte-compatible with the Rust crate's serde output.  Within the
framework ids are fully deterministic and stable — guarded by golden tests
(tests/test_identity.py).

The port's copy of ``llm_weighted_consensus_tpu/identity/__init__.py``:
the hash is this package's own XXH3-128 (``identity/xxh3.py``), since the
card's machine has no ``xxhash``; the ids are the reference's, bit for bit
(tests/test_torch_identity.py).
"""

from __future__ import annotations

from ..utils import jsonutil
from .xxh3 import Xxh3_128, xxh3_128_intdigest

BASE62_ALPHABET = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"

ID_LEN = 22


def base62_encode(n: int) -> str:
    if n == 0:
        return "0"
    out = []
    while n > 0:
        n, r = divmod(n, 62)
        out.append(BASE62_ALPHABET[r])
    return "".join(reversed(out))


def hash_json_obj(obj) -> int:
    """xxh3-128(canonical JSON) as an unsigned 128-bit integer."""
    return xxh3_128_intdigest(jsonutil.dumps(obj).encode("utf-8"))


def id_string(n: int) -> str:
    """base62, zero-padded to 22 chars (llm/mod.rs:520-522)."""
    return base62_encode(n).rjust(ID_LEN, "0")


class IncrementalHasher:
    """Streaming xxh3-128 used for panel ids (model/mod.rs:97-115)."""

    def __init__(self):
        self._h = Xxh3_128()

    def write(self, data: str) -> None:
        self._h.update(data.encode("utf-8"))

    def finish_id(self) -> str:
        return id_string(self._h.intdigest())


from .llm import (  # noqa: E402
    Llm,
    LlmBase,
    LlmWithoutIndices,
    OUTPUT_MODE_DEFAULT,
    Weight,
    WeightStatic,
    WeightTrainingTable,
    default_weight,
)
from .model import (  # noqa: E402
    Model,
    ModelBase,
    PanelWeight,
    PanelWeightStatic,
    PanelWeightTrainingTable,
    WeightTrainingTableEmbeddings,
)

__all__ = [
    "BASE62_ALPHABET",
    "ID_LEN",
    "IncrementalHasher",
    "Llm",
    "LlmBase",
    "LlmWithoutIndices",
    "Model",
    "ModelBase",
    "OUTPUT_MODE_DEFAULT",
    "PanelWeight",
    "PanelWeightStatic",
    "PanelWeightTrainingTable",
    "Weight",
    "WeightStatic",
    "WeightTrainingTable",
    "WeightTrainingTableEmbeddings",
    "base62_encode",
    "default_weight",
    "hash_json_obj",
    "id_string",
]
