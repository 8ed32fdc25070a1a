"""PyTorch/CUDA port of ``llm_weighted_consensus_tpu``.

The port serves the ``/consensus`` cosine scorer and ``/embeddings`` on
an NVIDIA H100: a BERT-class encoder in PyTorch whose attention and
consensus vote run in CUDA kernels written by hand for Hopper
(``csrc/``); and the ``/consensus`` reward-model scorer, a DeBERTa-v3
encoder whose quantized dense layers run the same hand-written GEMMs.  It imports torch, numpy and the standard library only;
nothing of JAX and nothing of the JAX package.

Float32 matmuls stay at full precision: the reference computes the vote's
Gram matrix at HIGHEST precision, so TF32 is turned off for both cuBLAS
and cuDNN as soon as torch is imported.  Importing the package does not
import torch itself: the lint (``python -m
llm_weighted_consensus_tpu_torch.analysis --no-jaxpr``) stays stdlib-only.
"""

import importlib.abc
import importlib.util
import sys


def _full_precision(torch) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _TorchDefaults(importlib.abc.MetaPathFinder):
    """Sets ``_full_precision`` on torch right after its first import."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname != "torch":
            return None
        sys.meta_path.remove(self)
        spec = importlib.util.find_spec(fullname)
        if spec is not None and spec.loader is not None:
            spec.loader = _AfterExec(spec.loader)
        return spec


class _AfterExec(importlib.abc.Loader):
    def __init__(self, inner) -> None:
        self._inner = inner

    def create_module(self, spec):
        return self._inner.create_module(spec)

    def exec_module(self, module) -> None:
        # torch sees its own loader while it runs and after
        module.__spec__.loader = module.__loader__ = self._inner
        self._inner.exec_module(module)
        _full_precision(module)


if "torch" in sys.modules:
    _full_precision(sys.modules["torch"])
else:
    sys.meta_path.insert(0, _TorchDefaults())
