"""The encoder's element-wise passes: residual add + LayerNorm and the
GELU, the CUDA kernels' wrappers and their plain PyTorch versions.

* ``add_layer_norm(x, residual, weight, bias, eps)``: LayerNorm over the
  last axis of ``x + residual`` (``residual`` None: of ``x``), the sum
  rounded to x's dtype first, then the reference's one-pass form in f32
  (mean and E[s^2] - mean^2 clamped at 0, never Welford or
  ``F.layer_norm``), one rounding back to x's dtype;
* ``gelu(x, inplace=False)``: the erf GELU in f32 (``gelu_f32``: exact
  erf for f32, the Abramowitz-Stegun 7.1.26 form for bf16), one rounding
  back; ``inplace=True`` lets the kernel write over ``x`` (a dense
  layer's fresh output, which nothing else holds).

A CPU tensor takes the plain version; a CUDA tensor launches
``csrc/norm_act.cu``'s kernel or raises, and so does one that requires
grad under grad mode (the kernels define no backward:
``launches.refuse_grad``; the trainers take the plain versions through
``encode(..., attention_impl="plain")``).  The kernels read the width
and dtype from the input: f32 or bf16, contiguous, 16-byte aligned, and
for ``add_layer_norm`` a width that is a multiple of 8 and at most
``MAX_WIDTH[dtype]``.

``add_layer_norm.launches`` and ``gelu.launches`` count the kernel
launches (``ops.launches``: a CUDA graph's launches count at each
replay, not at its capture).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, launches

# the widest row the LayerNorm kernel holds in registers (8 vectors of 16
# bytes a lane, csrc/norm_act.cu)
MAX_WIDTH = {torch.bfloat16: 2048, torch.float32: 1024}


def add_layer_norm_plain(
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
) -> torch.Tensor:
    s = x if residual is None else x + residual
    x32 = s.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    meansq = torch.mean(x32 * x32, dim=-1, keepdim=True)
    var = torch.clamp(meansq - mean * mean, min=0.0)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(s.dtype)


def gelu_plain(x: torch.Tensor) -> torch.Tensor:
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


def _dtype_code(what: str, x: torch.Tensor) -> int:
    if x.dtype == torch.float32:
        return 0
    if x.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"{what} takes f32 or bf16, got {x.dtype}")


def _check_launchable(what: str, *tensors) -> None:
    """Contiguous and 16-byte aligned: the kernels move 16-byte vectors."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what} wants contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{what} wants 16-byte aligned tensors")


def add_layer_norm(
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
) -> torch.Tensor:
    """LayerNorm of ``x + residual`` over the last axis (module doc)."""
    operands = [t for t in (x, residual, weight, bias) if t is not None]
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"add_layer_norm operands on several devices: "
                         f"{devices}")
    h = x.shape[-1]
    if residual is not None and residual.shape != x.shape:
        raise ValueError(
            f"add_layer_norm: residual {tuple(residual.shape)} is not x's "
            f"{tuple(x.shape)}")
    if weight.shape != (h,) or bias.shape != (h,):
        raise ValueError(
            f"add_layer_norm wants weight and bias [{h}], got "
            f"{tuple(weight.shape)}, {tuple(bias.shape)}")
    if x.device.type == "cpu":
        return add_layer_norm_plain(x, residual, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"add_layer_norm: unsupported device {x.device}")
    dtype = _dtype_code("add_layer_norm", x)
    if any(t.dtype != x.dtype for t in operands):
        raise TypeError(
            "add_layer_norm takes x, residual, weight and bias of one dtype, "
            f"got {[t.dtype for t in operands]}")
    if h % 8 or h > MAX_WIDTH[x.dtype]:
        raise ValueError(
            f"add_layer_norm kernel takes a width that is a multiple of 8 "
            f"and at most {MAX_WIDTH[x.dtype]} in {x.dtype}, got {h}")
    _check_launchable("add_layer_norm", *operands)
    launches.refuse_grad("add_layer_norm", *operands)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x.numel() // h if h else 0
    if rows == 0:
        return out
    rc = _build.library().lwc_add_layer_norm(
        x.data_ptr(),
        None if residual is None else residual.data_ptr(),
        weight.data_ptr(),
        bias.data_ptr(),
        out.data_ptr(),
        rows,
        h,
        float(eps),
        dtype,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "add_layer_norm")
    launches.count(add_layer_norm)
    return out


add_layer_norm.launches = 0


def gelu(x: torch.Tensor, inplace: bool = False) -> torch.Tensor:
    """The erf GELU of ``x`` in x's dtype (module doc)."""
    if x.device.type == "cpu":
        return gelu_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"gelu: unsupported device {x.device}")
    dtype = _dtype_code("gelu", x)
    _check_launchable("gelu", x)
    launches.refuse_grad("gelu", x)
    out = x if inplace else torch.empty(x.shape, dtype=x.dtype,
                                        device=x.device)
    if x.numel() == 0:
        return out
    rc = _build.library().lwc_gelu(
        x.data_ptr(),
        out.data_ptr(),
        x.numel(),
        dtype,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "gelu")
    launches.count(gelu)
    return out


gelu.launches = 0
