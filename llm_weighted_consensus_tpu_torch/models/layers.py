"""Encoder building blocks in PyTorch.

Counterpart of ``llm_weighted_consensus_tpu/models/layers.py``, with its
numerics: LayerNorm is the one-pass form (E[x^2] - mean^2, clamped) in
f32 whatever the activation dtype; GELU is exact erf for f32 and the
Abramowitz-Stegun 7.1.26 form for bf16; dense layers run in the param
dtype with f32 accumulation.  ``F.layer_norm`` and ``F.gelu`` compute
differently and are not used.

``dense_cfg`` and ``mlp_cfg`` are the layer stack's dense ops: a torch
``Linear`` runs ``dense``, a ``quant.QuantLinear`` (``EMBEDDER_QUANTIZE``)
its W8A8 / W4A8 kernel, with the MLP's GELU folded into the expansion
layer's epilogue, so no separate GELU pass runs on the quantized path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .quant import QuantLinear


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    meansq = torch.mean(x32 * x32, dim=-1, keepdim=True)
    var = torch.clamp(meansq - mean * mean, min=0.0)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)


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


def dense_cfg(x: torch.Tensor, linear, gelu: bool = False) -> torch.Tensor:
    """The layer dense op for ``linear`` as it is held: ``dense`` for a
    torch ``Linear``, the quantized kernel for a ``QuantLinear``.
    ``gelu=True`` applies ``gelu_erf`` after the dense layer, or folds the
    same GELU into the quantized kernel's f32 epilogue (before the one
    rounding, as the reference's Pallas kernel does)."""
    if isinstance(linear, QuantLinear):
        return linear(x, gelu=gelu)
    out = dense(x, linear.weight, linear.bias)
    return gelu_erf(out) if gelu else out


def mlp_cfg(x: torch.Tensor, inter, out) -> torch.Tensor:
    """The encoder MLP: dense -> GELU -> dense, in whichever form the two
    layers are held."""
    return dense_cfg(dense_cfg(x, inter, gelu=True), out)


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, the activation of HF BERT checkpoints, computed
    in f32: exact erf for f32 inputs, the A&S 7.1.26 form for bf16 (it
    agrees with exact erf to <= 1 bf16 ulp; see the reference's
    ``gelu_erf`` docstring)."""
    return gelu_f32(x.float(), approx=x.dtype == torch.bfloat16).to(x.dtype)


def gelu_f32(x32: torch.Tensor, approx: bool = False) -> torch.Tensor:
    if not approx:
        return x32 * 0.5 * (1.0 + torch.erf(x32 * (2.0 ** -0.5)))
    z = torch.abs(x32) * (2.0 ** -0.5)
    t = 1.0 / (1.0 + 0.3275911 * z)
    poly = t * (
        0.254829592
        + t
        * (
            -0.284496736
            + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429))
        )
    )
    half_erfc = 0.5 * poly * torch.exp(-z * z)
    phi = torch.where(x32 > 0, 1.0 - half_erfc, half_erfc)
    return x32 * phi
