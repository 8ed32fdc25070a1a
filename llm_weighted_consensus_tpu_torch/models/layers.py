"""Encoder building blocks in PyTorch.

Counterpart of ``llm_weighted_consensus_tpu/models/layers.py``, with its
numerics: LayerNorm is the one-pass form (E[x^2] - mean^2, clamped) in
f32 whatever the activation dtype; GELU is exact erf for f32 and the
Abramowitz-Stegun 7.1.26 form for bf16; dense layers run in the param
dtype with f32 accumulation.  ``F.layer_norm`` and ``F.gelu`` compute
differently and are not used.

``layer_norm`` and ``gelu_erf`` go through ``ops.norm_act``: on the card
its hand-written kernels (the residual add fused into the LayerNorm's
one pass), on the CPU, or with ``plain=True`` on either device (the
trainers' differentiable path), their plain versions.

``dense_cfg`` and ``mlp_cfg`` are the layer stack's dense ops: a torch
``Linear`` runs ``dense``, a ``quant.QuantLinear`` (``EMBEDDER_QUANTIZE``)
its W8A8 / W4A8 kernel, with the MLP's GELU folded into the expansion
layer's epilogue, so no separate GELU pass runs on the quantized path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.norm_act import add_layer_norm, add_layer_norm_plain, gelu
from ..ops.norm_act import gelu_f32  # noqa: F401  (re-exported)
from ..ops.norm_act import gelu_plain
from .quant import QuantLinear


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    residual: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """LayerNorm of ``x + residual`` (``residual`` None: of ``x``), the
    sum rounded to x's dtype first: ``ops.norm_act.add_layer_norm``, or
    with ``plain`` its plain version on either device."""
    fn = add_layer_norm_plain if plain else add_layer_norm
    return fn(x, residual, weight, bias, eps)


def dense(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """x[..., in] @ weight[out, in]^T + bias in the param dtype.  cuBLAS
    (and the CPU's GEMM) accumulate bf16 products in f32, as the
    reference's ``preferred_element_type=f32`` matmul does.  The bias is
    added in the GEMM's epilogue before the one rounding to bf16, where
    the reference rounds, then adds: at most one bf16 ulp apart, and
    identical in f32."""
    return F.linear(x, weight, bias)


def dense_cfg(x: torch.Tensor, linear, gelu: bool = False,
              plain: bool = False) -> torch.Tensor:
    """The layer dense op for ``linear`` as it is held: ``dense`` for a
    torch ``Linear``, the quantized kernel for a ``QuantLinear``.
    ``gelu=True`` applies ``gelu_erf`` (``plain``: its plain version)
    after the dense layer, in place over the dense layer's fresh output,
    or folds the same GELU into the quantized kernel's f32 epilogue
    (before the one rounding, as the reference's Pallas kernel does)."""
    if isinstance(linear, QuantLinear):
        return linear(x, gelu=gelu)
    out = dense(x, linear.weight, linear.bias)
    return gelu_erf(out, plain=plain, inplace=True) if gelu else out


def mlp_cfg(x: torch.Tensor, inter, out) -> torch.Tensor:
    """The encoder MLP: dense -> GELU -> dense, in whichever form the two
    layers are held."""
    return dense_cfg(dense_cfg(x, inter, gelu=True), out)


def gelu_erf(x: torch.Tensor, plain: bool = False,
             inplace: bool = False) -> torch.Tensor:
    """Exact (erf) GELU in f32, rounded once to x's dtype:
    ``ops.norm_act.gelu`` (``inplace``: the kernel may write over ``x``),
    or with ``plain`` its plain version on either device."""
    return gelu_plain(x) if plain else gelu(x, inplace=inplace)
