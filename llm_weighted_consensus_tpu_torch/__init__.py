"""PyTorch/CUDA port of ``llm_weighted_consensus_tpu``.

The port serves the ``/consensus`` cosine scorer and ``/embeddings`` on
an NVIDIA H100: a BERT-class encoder in PyTorch whose attention and
consensus vote run in CUDA kernels written by hand for Hopper
(``csrc/``); and the ``/consensus`` reward-model scorer, a DeBERTa-v3
encoder whose quantized dense layers run the same hand-written GEMMs.  It imports torch, numpy and the standard library only;
nothing of JAX and nothing of the JAX package.

Float32 matmuls stay at full precision: the reference computes the vote's
Gram matrix at HIGHEST precision, so TF32 is turned off here for both
cuBLAS and cuDNN.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
