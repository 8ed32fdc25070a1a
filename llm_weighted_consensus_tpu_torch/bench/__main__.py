"""``python -m llm_weighted_consensus_tpu_torch.bench <name> [flags]``:
``headline``, ``fwd``, ``attn``, ``configs``, ``http``, ``host`` or
``scaling``
(``--help`` after a name lists its flags)."""

from __future__ import annotations

import importlib
import sys

BENCHES = ("headline", "fwd", "attn", "configs", "http", "host",
           "scaling")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in BENCHES:
        print("usage: python -m llm_weighted_consensus_tpu_torch.bench "
              f"{{{','.join(BENCHES)}}} [flags]", file=sys.stderr)
        return 2
    module = importlib.import_module(f".{argv[0]}", __package__)
    return module.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
