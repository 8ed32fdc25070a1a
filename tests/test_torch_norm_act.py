"""The residual add + LayerNorm and GELU wrappers (``ops/norm_act.py``) on
the CPU: their plain versions against the arithmetic the encoder ran
before them, bit for bit; the CPU route; the trainers' plain path never
reaching a kernel wrapper; and the kernels' build entry.

The kernels themselves run only on the card (``chip_smoke.py``'s kernel
phase and ``tests/test_torch_cuda.py``).
"""

import ctypes

import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu_torch.models import bert, deberta, layers
from llm_weighted_consensus_tpu_torch.models.configs import (
    DEBERTA_TEST_TINY,
    PRESETS,
)
from llm_weighted_consensus_tpu_torch.ops import _build, norm_act

DTYPES = [torch.float32, torch.bfloat16]


def _before_layer_norm(x, weight, bias, eps):
    """``layers.layer_norm`` as the encoder ran it before the kernels,
    on ``x + residual`` summed by the caller."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    meansq = torch.mean(x32 * x32, dim=-1, keepdim=True)
    var = torch.clamp(meansq - mean * mean, min=0.0)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)


def _before_gelu_erf(x):
    """``layers.gelu_erf`` before the kernels: ``gelu_f32`` as it was."""
    x32 = x.float()
    if x.dtype != torch.bfloat16:
        return (x32 * 0.5 * (1.0 + torch.erf(x32 * (2.0 ** -0.5)))).to(
            x.dtype)
    z = torch.abs(x32) * (2.0 ** -0.5)
    t = 1.0 / (1.0 + 0.3275911 * z)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    half_erfc = 0.5 * poly * torch.exp(-z * z)
    phi = torch.where(x32 > 0, 1.0 - half_erfc, half_erfc)
    return (x32 * phi).to(x.dtype)


def _tensor(shape, seed, dtype, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * scale + shift
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h", [768, 1024])
@pytest.mark.parametrize("with_residual", [False, True])
def test_layer_norm_plain_is_the_encoders_arithmetic(dtype, h,
                                                     with_residual):
    x = _tensor((3, 17, h), 1, dtype, scale=2.0, shift=0.5)
    r = _tensor((3, 17, h), 2, dtype, scale=3.0) if with_residual else None
    w = _tensor((h,), 3, dtype, scale=0.2, shift=1.0)
    b = _tensor((h,), 4, dtype, scale=0.1)
    want = _before_layer_norm(x if r is None else x + r, w, b, 1e-12)
    for got in (norm_act.add_layer_norm_plain(x, r, w, b, 1e-12),
                norm_act.add_layer_norm(x, r, w, b, 1e-12),
                layers.layer_norm(x, w, b, 1e-12, r),
                layers.layer_norm(x, w, b, 1e-12, r, plain=True)):
        assert got.dtype == dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", [3072, 4096])
def test_gelu_plain_is_the_encoders_arithmetic(dtype, width):
    x = _tensor((5, width), 5, dtype, scale=3.0)
    want = _before_gelu_erf(x)
    for got in (norm_act.gelu_plain(x), norm_act.gelu(x),
                norm_act.gelu(x.clone(), inplace=True),
                layers.gelu_erf(x), layers.gelu_erf(x, plain=True)):
        assert got.dtype == dtype
        assert torch.equal(got, want)


def test_the_cpu_route_launches_nothing():
    n0 = norm_act.add_layer_norm.launches, norm_act.gelu.launches
    x = _tensor((4, 64), 6, torch.float32)
    w, b = torch.ones(64), torch.zeros(64)
    norm_act.add_layer_norm(x, x, w, b, 1e-12)
    norm_act.gelu(x)
    assert (norm_act.add_layer_norm.launches, norm_act.gelu.launches) == n0


def test_the_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="weight and bias"):
        norm_act.add_layer_norm(x, None, torch.ones(32), torch.zeros(64),
                                1e-12)
    with pytest.raises(ValueError, match="residual"):
        norm_act.add_layer_norm(x, torch.zeros(2, 32), torch.ones(64),
                                torch.zeros(64), 1e-12)
    meta = torch.zeros(2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        norm_act.add_layer_norm(meta, None, torch.ones(64, device="meta"),
                                torch.zeros(64, device="meta"), 1e-12)
    with pytest.raises(ValueError, match="unsupported device"):
        norm_act.gelu(meta)


def _refusing(monkeypatch):
    """Patch the kernel wrappers where the encoder calls them to raise;
    returns the calls each would have taken."""
    calls = {"add_layer_norm": 0, "gelu": 0}

    def refuse(name):
        def fn(*args, **kwargs):
            calls[name] += 1
            raise AssertionError(f"{name} wrapper reached")
        return fn

    monkeypatch.setattr(layers, "add_layer_norm", refuse("add_layer_norm"))
    monkeypatch.setattr(layers, "gelu", refuse("gelu"))
    return calls


def test_the_plain_encode_never_reaches_a_kernel_wrapper(monkeypatch):
    config = PRESETS["test-tiny"]
    model = bert.init_params(config, seed=0, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(7).integers(
        0, config.vocab_size, (2, 16), dtype=np.int32))
    mask = torch.ones((2, 16), dtype=torch.int32)
    with torch.no_grad():
        want = bert.embed(model, ids, mask, attention_impl="plain")
    calls = _refusing(monkeypatch)
    with torch.no_grad():
        got = bert.embed(model, ids, mask, attention_impl="plain")
    assert calls == {"add_layer_norm": 0, "gelu": 0}
    assert torch.equal(got, want)
    # the same patch does catch the served path
    with torch.no_grad(), pytest.raises(AssertionError, match="wrapper"):
        bert.embed(model, ids, mask)
    assert calls["add_layer_norm"] == 1


def test_the_plain_reward_never_reaches_a_kernel_wrapper(monkeypatch):
    model = deberta.init_params(DEBERTA_TEST_TINY, seed=0, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(8).integers(
        0, DEBERTA_TEST_TINY.vocab_size, (2, 12), dtype=np.int32))
    mask = torch.ones((2, 12), dtype=torch.int32)
    with torch.no_grad():
        want = deberta.reward(model, ids, mask)
    calls = _refusing(monkeypatch)
    with torch.no_grad():
        got = deberta.reward(model, ids, mask, plain=True)
    assert calls == {"add_layer_norm": 0, "gelu": 0}
    assert torch.equal(got, want)
    with torch.no_grad(), pytest.raises(AssertionError, match="wrapper"):
        deberta.reward(model, ids, mask)


class _FakeLib:
    """Stands in for the loaded library: each symbol a plain object that
    takes ``argtypes`` and ``restype``."""

    def __init__(self):
        self._fns = {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self._fns.setdefault(name, type("Fn", (), {})())


def test_the_build_lists_norm_act_and_binds_pointers_as_void_p():
    assert "norm_act.cu" in _build.SOURCES
    assert (_build.CSRC_DIR / "norm_act.cu").exists()
    lib = _build._bind(_FakeLib())
    vp = ctypes.c_void_p
    ln = lib.lwc_add_layer_norm.argtypes
    # x, residual, weight, bias, out ... stream
    assert ln[:5] == [vp] * 5 and ln[-1] is vp
    assert ln[5:9] == [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int]
    assert lib.lwc_gelu.argtypes == [vp, vp, ctypes.c_longlong,
                                     ctypes.c_int, vp]
    assert lib.lwc_add_layer_norm.restype is ctypes.c_int
    assert lib.lwc_gelu.restype is ctypes.c_int
