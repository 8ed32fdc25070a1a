"""The port's W8A8 / W4A8 quantization against the JAX package's.

Weight and activation quantisation must be byte-equal to the reference
(same f32 division, round half to even, clip), the port's int4 tensor
byte-equal to ``pack_int4_weights(q).T``, and the plain versions of the
two quantized matmul kernels must match the reference's Pallas kernels
(``dense_int8`` / ``dense_int4`` with ``impl="pallas"``, interpret mode on
the CPU; plain ``int8`` would pick the reference's XLA composition off the
TPU, whose GELU rounds to the activation dtype first).

Tolerances, as the reference's own kernel tests state them
(``tests/test_quant.py``): f32 |diff| <= 2e-5 + 2e-5 |want|, bf16
2e-2 + 2e-2 |want| (one bf16 ulp at |x| ~ 4: an f32 ulp of difference in
the epilogue can flip one bf16 rounding).

The CUDA kernels themselves run only on a card: ``test_torch_cuda.py``
holds them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu.models import quant as jax_quant
from llm_weighted_consensus_tpu.ops import kernels as jax_kernels
from llm_weighted_consensus_tpu_torch.models import configs, quant
from llm_weighted_consensus_tpu_torch.ops import kernels

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _ties(rng, k, n, top):
    """A [k, n] kernel whose first column has max|w| = ``top`` (scale 1
    for int8 at 127, for int4 at 7) and exact half-way values, whose
    second column is all zero (the 1e-12 clamp) and whose other columns
    are random."""
    w = (rng.standard_normal((k, n)) * 0.2).astype(np.float32)
    w[:, 0] = 0.0
    w[:8, 0] = [0.5, 1.5, 2.5, -0.5, -2.5, top - 0.5, -3.5, top]
    w[:, 1] = 0.0
    return w


@pytest.mark.parametrize("k,n", [(48, 24), (300, 16), (1024, 8)])
def test_quantize_weight_is_byte_equal(k, n):
    w = _ties(np.random.default_rng(k), k, n, 127.0)
    want_q, want_s = jax_quant.quantize_weight(jnp.asarray(w))
    got_q, got_s = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q).T)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # the half-way values rounded to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    assert got_q[0, :5].tolist() == [0, 2, 2, 0, -2]
    assert not got_q[1].any() and got_s[1].item() == pytest.approx(1e-12)


@pytest.mark.parametrize("shape", [(8, 48), (2, 5, 48), (6, 96)])
def test_quantize_rows_is_byte_equal(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    rows = x.reshape(-1, shape[-1])
    rows[0] = 0.0  # a zero row: scale clamps to 1e-12, every value 0
    rows[1, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]  # scale 1, ties
    rows[1, 6:] = 0.0
    want_q, want_s = jax_quant._quantize_rows(jnp.asarray(x))
    got_q, got_s = quant._quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q.reshape(-1, shape[-1])[1, :6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("k,n", [(48, 24), (256, 8), (300, 16), (1024, 8)])
def test_quantize_weight_int4_is_byte_equal(k, n):
    w = _ties(np.random.default_rng(k + 1), k, n, 7.0)
    want_q, want_s = jax_quant.quantize_weight_int4(jnp.asarray(w))
    got_q, got_s = quant.quantize_weight_int4(torch.from_numpy(w.T.copy()))
    assert got_q.dtype == torch.uint8
    assert got_q.shape == (n, -(-k // 256) * 128)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q).T)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # ties to even in the int4 range too: 0.5, 1.5, 2.5, -0.5, -2.5, 6.5
    q = kernels.unpack_int4_weights(got_q, k)
    assert q[0, :6].tolist() == [0, 2, 2, 0, -2, 6]


@pytest.mark.parametrize("k", [5, 96, 256, 300, 512])
def test_pack_int4_weights_is_the_transposed_reference_layout(k):
    rng = np.random.default_rng(k)
    q = rng.integers(-7, 8, size=(k, 12)).astype(np.int8)
    want = np.asarray(jax_kernels.pack_int4_weights(jnp.asarray(q))).T
    got = kernels.pack_int4_weights(torch.from_numpy(q.T.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    back = kernels.unpack_int4_weights(got, k)
    np.testing.assert_array_equal(back.numpy(), q.T)
    # pad nibbles unbias to 0
    full = kernels.unpack_int4_weights(got, 2 * got.shape[1])
    assert not full[:, k:].any()


def _dense_params(rng, k, n, int4):
    w = (rng.standard_normal((k, n)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    fn = jax_quant.quantize_weight_int4 if int4 else jax_quant.quantize_weight
    kq, scale = fn(jnp.asarray(w))
    jax_p = {"kernel_q": kq, "scale": scale, "bias": jnp.asarray(b)}
    port = (
        torch.from_numpy(np.asarray(kq).T.copy()),
        torch.from_numpy(np.array(scale)),
        torch.from_numpy(b),
    )
    return jax_p, port


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("int4", [False, True], ids=["w8a8", "w4a8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("shape", [(8, 48), (2, 5, 48), (8, 96)])
def test_plain_matmul_matches_the_pallas_kernel(int4, dtype, gelu, shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    jax_p, (wq, sw, bias) = _dense_params(rng, shape[-1], 24, int4)
    x = rng.standard_normal(shape).astype(np.float32)
    x[(0,) * (len(shape) - 1)] = 0.0  # one all-zero row
    jx = jnp.asarray(x, getattr(jnp, dtype))
    dense = jax_quant.dense_int4 if int4 else jax_quant.dense_int8
    want = np.asarray(dense(jx, jax_p, gelu=gelu, impl="pallas"), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    plain = kernels.w4a8_matmul_plain if int4 else kernels.w8a8_matmul_plain
    got = plain(tx, wq, sw, bias, gelu=gelu)
    assert got.dtype == tx.dtype and tuple(got.shape) == (*shape[:-1], 24)
    _close(got.float().numpy(), want, dtype)
    # the wrapper takes the plain version for a CPU tensor, uncounted
    wrapper = kernels.w4a8_matmul if int4 else kernels.w8a8_matmul
    before = wrapper.launches
    torch.testing.assert_close(wrapper(tx, wq, sw, bias, gelu=gelu), got)
    assert wrapper.launches == before


def test_plain_product_is_exact_at_k_4096():
    """The plain versions take the int8 product in f64: exact, equal to an
    int64 product, where an f32 sum would round once |acc| > 2^24."""
    rng = np.random.default_rng(4096)
    # same-signed operands near full scale: |acc| ~ 4096 * 120 * 64
    x = torch.from_numpy(rng.uniform(0.9, 1.0, (4, 4096)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(0, 128, (8, 4096)).astype(np.int8))
    sw = torch.from_numpy(rng.uniform(1e-3, 2e-3, 8).astype(np.float32))
    bias = torch.zeros(8)
    xq, sx = kernels.quantize_rows_plain(x)
    acc64 = xq.long() @ wq.long().T
    assert acc64.min().item() > 2**24
    want = acc64.float() * sx[:, None] * sw + bias
    got = kernels.w8a8_matmul_plain(x, wq, sw, bias)
    assert torch.equal(got, want)
    exact = torch.matmul(xq.double(), wq.double().T)
    assert torch.equal(exact, acc64.double())


def test_wrappers_refuse_bad_operands():
    x = torch.zeros(2, 48)
    wq = torch.zeros(24, 48, dtype=torch.int8)
    sw = torch.ones(24)
    bias = torch.zeros(24)
    with pytest.raises(TypeError):
        kernels.w8a8_matmul(x, wq.to(torch.uint8), sw, bias)
    with pytest.raises(ValueError):
        kernels.w8a8_matmul(torch.zeros(2, 40), wq, sw, bias)
    with pytest.raises(ValueError):
        kernels.w8a8_matmul(x, wq, sw[:4], bias)
    with pytest.raises(ValueError):
        # packed width 24 -> Kp 48, not a multiple of 256
        kernels.w4a8_matmul(x, torch.zeros(24, 24, dtype=torch.uint8), sw, bias)
    with pytest.raises(ValueError):
        kernels.quantize_rows(x, 50)


def test_quant_linear_keeps_f32_scales_through_casts():
    linear = torch.nn.Linear(48, 24)
    q = quant.QuantLinear.from_linear(linear, int4=False)
    q = q.to(torch.bfloat16)
    assert q.scale.dtype == torch.float32 and q.bias.dtype == torch.float32
    assert q.weight_q.dtype == torch.int8
    q4 = quant.QuantLinear.from_linear(linear, int4=True).to(torch.bfloat16)
    assert q4.scale.dtype == torch.float32 and q4.weight_q.dtype == torch.uint8
    assert q4.weight_q.shape == (24, 128)


def test_quant_modes_and_resolve():
    assert configs.QUANT_MODES == jax_quant.QUANT_MODES
    from llm_weighted_consensus_tpu_torch.models import bert

    model = bert.init_params(configs.TEST_TINY, device="cpu")
    with pytest.raises(ValueError, match="int8-xla"):
        quant.resolve_quantize(model, None, "int8-xla")
    with pytest.raises(ValueError, match="int4-pallas"):
        quant.resolve_quantize(model, None, "int4")
    assert not quant.is_quantized(model)
    assert quant.resolve_quantize(model, None, "none").quantize == "none"
    cfg = quant.resolve_quantize(model, None, "int8-pallas")
    assert cfg.quantize == "int8-pallas" and model.config.quantize == "int8-pallas"
    assert quant.is_quantized(model) and not quant.is_int4(model)
    n_quant = sum(isinstance(m, quant.QuantLinear) for m in model.modules())
    assert n_quant == 6 * configs.TEST_TINY.num_layers
    assert not any(
        isinstance(m, torch.nn.Linear) for m in model.encoder.modules()
    )
    # an int8 model cannot be served as int4 without its full weights
    with pytest.raises(ValueError, match="layout"):
        quant.resolve_quantize(model, None, "int4-pallas")
