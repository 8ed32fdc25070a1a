"""Which kernel each CUDA call of the port takes, pinned on the CPU.

``ops.attention.attention_route`` and ``ops.kernels.quant_gemm_route``
are pure functions of dtype, shape, strides and base addresses, so the
route of every encoder call is decided here, where no kernel can run:

* bge-base's and bge-large's attention, padded and segment-masked (bf16,
  hd 64, the encoder's ``.view`` of a dense output), takes the TMA +
  wgmma kernel; hd 16/32 the mma.sync kernel; f32, hd 24 and unaligned
  views the FMA kernel;
* W8A8 and W4A8 at every bge preset's K take the TMA + wgmma GEMM;
  W8A8 with K % 16 != 0 and an unaligned weight the mma.sync GEMM.

The kernels themselves are held against their plain versions on the card
(``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import pytest
import torch

from llm_weighted_consensus_tpu_torch.models import configs
from llm_weighted_consensus_tpu_torch.ops import _build, attention, kernels


def _encoder_qkv(b, s, nh, hd, dtype=torch.bfloat16):
    """q/k/v as ``models/bert.py`` makes them: three dense outputs
    [b, s, nh * hd], each viewed as [b, s, nh, hd]."""
    return tuple(
        torch.zeros(b, s, nh * hd, dtype=dtype).view(b, s, nh, hd)
        for _ in range(3)
    )


@pytest.mark.parametrize("preset", ["bge-base-en", "bge-large-en"])
@pytest.mark.parametrize("b,s", [(64, 128), (512, 128), (16, 512), (32, 64),
                                 (3, 77), (2, 200)])
def test_bge_attention_takes_the_tma_route(preset, b, s):
    cfg = configs.PRESETS[preset]
    q, k, v = _encoder_qkv(b, s, cfg.num_heads, cfg.head_dim)
    assert cfg.head_dim == 64
    assert attention.attention_route(q, k, v) == "tma"


def test_fused_projection_views_take_the_tma_route():
    # q/k/v as views into one [b, s, 3, nh, hd] projection: row-major
    # order with a padded row
    fused = torch.zeros(2, 40, 3, 16, 64, dtype=torch.bfloat16)
    views = [fused[:, :, i] for i in range(3)]
    assert not views[0].is_contiguous()
    assert attention.attention_route(*views) == "tma"


@pytest.mark.parametrize(
    "hd,dtype,want",
    [(16, torch.bfloat16, "mma"), (32, torch.bfloat16, "mma"),
     (24, torch.bfloat16, "fma"), (64, torch.float32, "fma"),
     (32, torch.float32, "fma")],
)
def test_other_head_dims_and_f32_keep_the_old_routes(hd, dtype, want):
    q, k, v = _encoder_qkv(3, 77, 4, hd, dtype)
    assert attention.attention_route(q, k, v) == want


def test_a_view_with_65_element_rows_takes_the_fma_route():
    wide = torch.zeros(3, 50, 4, 65, dtype=torch.bfloat16)
    view = wide[..., :64]
    assert attention.attention_route(view, view, view) == "fma"


def test_a_head_major_view_takes_the_tma_route():
    # aligned but not in [b, s, nh, hd] row-major order: [b, nh, s, hd]
    # storage seen as [b, s, nh, hd]; the tensor maps take any strides
    t = torch.zeros(2, 4, 40, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert attention.attention_route(t, t, t) == "tma"


@pytest.mark.parametrize("preset", ["bge-base-en", "bge-large-en"])
@pytest.mark.parametrize("b,s", [(8, 512), (4, 384), (1, 64), (3, 77)])
def test_bge_segment_attention_takes_the_tma_route(preset, b, s):
    cfg = configs.PRESETS[preset]
    q, k, v = _encoder_qkv(b, s, cfg.num_heads, cfg.head_dim)
    assert attention.segment_attention_route(q, k, v) == "tma"


@pytest.mark.parametrize(
    "hd,dtype,want",
    [(16, torch.bfloat16, "mma"), (32, torch.bfloat16, "mma"),
     (24, torch.bfloat16, "fma"), (64, torch.float32, "fma"),
     (16, torch.float32, "fma")],
)
def test_other_segment_attention_calls_keep_the_old_routes(hd, dtype, want):
    q, k, v = _encoder_qkv(3, 77, 4, hd, dtype)
    assert attention.segment_attention_route(q, k, v) == want


def test_an_unaligned_segment_attention_view_takes_the_fma_route():
    wide = torch.zeros(3, 50, 4, 65, dtype=torch.bfloat16)
    view = wide[..., :64]
    assert attention.segment_attention_route(view, view, view) == "fma"


def test_cpu_segment_attention_counts_no_route():
    q, k, v = _encoder_qkv(2, 8, 2, 64, torch.float32)
    seg = torch.tensor([[1, 1, 2, 2, 2, 0, 0, 0]] * 2, dtype=torch.int32)
    before = dict(attention.segment_attention.routes)
    attention.segment_attention(q, k, v, seg, 0.125)
    assert attention.segment_attention.routes == before


def test_cpu_attention_counts_no_route():
    q, k, v = _encoder_qkv(2, 8, 2, 64, torch.float32)
    before = dict(attention.attention.routes)
    attention.attention(q, k, v, torch.zeros(2, 8), 0.125)
    assert attention.attention.routes == before


def _gemm_operands(m, k, n, int4=False):
    kp = -(-k // kernels.QUANT_K_TILE) * kernels.QUANT_K_TILE
    xq = torch.zeros(m, kp, dtype=torch.int8)
    w = (torch.zeros(n, kp // 2, dtype=torch.uint8) if int4
         else torch.zeros(n, k, dtype=torch.int8))
    out = torch.empty(m, n, dtype=torch.bfloat16)
    return xq, w, out


@pytest.mark.parametrize("k", [96, 192, 384, 768, 1024, 3072, 4096])
def test_w8a8_at_every_bge_k_takes_the_tma_route(k):
    assert kernels.quant_gemm_route(k, False, *_gemm_operands(8, k, 24)) == "tma"


@pytest.mark.parametrize("k", [40, 1000])
def test_w8a8_at_other_k_keeps_the_mma_route(k):
    assert kernels.quant_gemm_route(k, False, *_gemm_operands(8, k, 24)) == "mma"


@pytest.mark.parametrize("k", [96, 384, 768, 1024, 4096])
def test_w4a8_at_every_bge_k_takes_the_tma_route(k):
    # xq is Kp wide (zero past K) and Kp / 2 a multiple of 128: any K
    assert kernels.quant_gemm_route(k, True, *_gemm_operands(8, k, 24, True)) == "tma"


def test_an_unaligned_weight_keeps_the_mma_route():
    xq, _, out = _gemm_operands(8, 96, 24)
    w = torch.zeros(24 * 96 + 1, dtype=torch.int8)[1:].view(24, 96)
    assert w.data_ptr() % 16
    assert kernels.quant_gemm_route(96, False, xq, w, out) == "mma"


def test_an_unaligned_w4a8_weight_keeps_the_mma_route():
    xq, _, out = _gemm_operands(8, 96, 24, int4=True)
    kp2 = xq.shape[1] // 2
    w = torch.zeros(24 * kp2 + 1, dtype=torch.uint8)[1:].view(24, kp2)
    assert w.data_ptr() % 16
    assert kernels.quant_gemm_route(96, True, xq, w, out) == "mma"


def test_cpu_w4a8_counts_no_route():
    x = torch.randn(4, 96)
    wq4 = kernels.pack_int4_weights(torch.zeros(24, 96, dtype=torch.int8))
    before = dict(kernels.w4a8_matmul.routes)
    kernels.w4a8_matmul(x, wq4, torch.ones(24), torch.zeros(24))
    assert kernels.w4a8_matmul.routes == before


def test_cpu_quant_matmul_counts_no_route():
    x = torch.randn(4, 96)
    wq = torch.zeros(24, 96, dtype=torch.int8)
    before = dict(kernels.w8a8_matmul.routes)
    kernels.w8a8_matmul(x, wq, torch.ones(24), torch.zeros(24))
    assert kernels.w8a8_matmul.routes == before


def test_the_build_watches_the_shared_headers():
    names = {p.name for p in _build._inputs()}
    assert {"sm90.cuh", "quant_epilogue.cuh"} <= names
    assert {"attention_sm90.cu", "quant_gemm_sm90.cu"} <= set(_build.SOURCES)
