"""The PyTorch port's vote and attention against the JAX package.

On the CPU the port's wrappers run their plain versions; these are held
against the reference's Pallas kernels (interpret mode off-TPU, as the
JAX package's own tests run them) and its jnp compositions, on the same
numpy-seeded inputs.  Tolerances: confidences 1e-6 absolute (f32);
attention outputs 1e-5 (f32) and 2e-2 (bf16, one bf16 ulp at |x| ~ 4).

The CUDA kernels themselves run only on a card: ``test_torch_cuda.py``
holds them against the plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu.ops import attention as jax_attention
from llm_weighted_consensus_tpu.ops import kernels as jax_kernels
from llm_weighted_consensus_tpu.ops import similarity as jax_similarity
from llm_weighted_consensus_tpu_torch.ops import attention, kernels, similarity

VOTE_TOL = 1e-6


def _embeddings(shape, seed):
    rng = np.random.default_rng(seed)
    *lead, n, d = shape
    # a shared direction plus noise: candidate embeddings that agree
    # more or less, so the softmax is far from uniform at T=0.05
    center = rng.normal(size=(*lead, 1, d))
    return (center + 0.7 * rng.normal(size=shape)).astype(np.float32)


VOTE_CASES = [
    (n, d, t) for n in (2, 7, 64, 256) for d in (64, 384, 1024)
    for t in (0.05, 0.3)
]


@pytest.mark.parametrize("n,d,temperature", VOTE_CASES)
def test_plain_vote_matches_fused_cosine_vote(n, d, temperature):
    x = _embeddings((n, d), seed=n * d)
    ref = np.asarray(
        jax_kernels.fused_cosine_vote(jnp.asarray(x), temperature=temperature)
    )
    port = kernels.cosine_vote(torch.from_numpy(x)[None], n, temperature)
    assert port.shape == (1, n) and port.dtype == torch.float32
    np.testing.assert_allclose(port[0].numpy(), ref, atol=VOTE_TOL)
    assert float(port.sum()) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("n,d,temperature", VOTE_CASES)
def test_plain_vote_matches_dyn_cosine_vote_batched(n, d, temperature):
    x = _embeddings((3, n, d), seed=7 * n + d)
    ref = np.asarray(jax_similarity.dyn_cosine_vote(jnp.asarray(x), temperature))
    port = kernels.cosine_vote(torch.from_numpy(x), n, temperature)
    np.testing.assert_allclose(port.numpy(), ref, atol=VOTE_TOL)
    # the port's dyn_cosine_vote (the same plain vote, every row live)
    mirror = similarity.dyn_cosine_vote(torch.from_numpy(x), temperature)
    np.testing.assert_allclose(mirror.numpy(), ref, atol=VOTE_TOL)


@pytest.mark.parametrize("n_valid", [1, 2, 5])
def test_vote_n_valid_masks_padding_rows(n_valid):
    x = _embeddings((2, 8, 64), seed=n_valid)
    full = kernels.cosine_vote(torch.from_numpy(x), n_valid, 0.05)
    sliced = kernels.cosine_vote(
        torch.from_numpy(x[:, :n_valid].copy()), n_valid, 0.05
    )
    np.testing.assert_allclose(
        full[:, :n_valid].numpy(), sliced.numpy(), atol=VOTE_TOL
    )
    assert (full[:, n_valid:] == 0).all()
    ref = np.stack([
        np.asarray(jax_kernels.fused_cosine_vote(jnp.asarray(x[i, :n_valid])))
        for i in range(2)
    ])
    np.testing.assert_allclose(sliced.numpy(), ref, atol=VOTE_TOL)


@pytest.mark.parametrize("cap,live", [(8, 3), (16, 16), (16, 1)])
def test_masked_cosine_vote_matches_jax(cap, live):
    x = _embeddings((cap, 32), seed=cap + live)
    valid = np.zeros(cap, np.float32)
    valid[np.random.default_rng(live).permutation(cap)[:live]] = 1.0
    ref = np.asarray(
        jax_similarity.masked_cosine_vote(
            jnp.asarray(x), jnp.asarray(valid), 0.05
        )
    )
    port = similarity.masked_cosine_vote(
        torch.from_numpy(x), torch.from_numpy(valid), 0.05
    )
    np.testing.assert_allclose(port.numpy(), ref, atol=VOTE_TOL)


def test_masked_vote_takes_a_request_axis_with_its_own_masks():
    # the plain vote the kernel is held to: [R, CAP, D] with one valid
    # mask per request, each request against the reference alone
    x = _embeddings((3, 12, 40), seed=21)
    valid = np.zeros((3, 12), np.float32)
    for i, live in enumerate((12, 5, 1)):
        valid[i, :live] = 1.0
    port = similarity.masked_cosine_vote(
        torch.from_numpy(x), torch.from_numpy(valid), 0.2
    )
    ref = np.stack([
        np.asarray(jax_similarity.masked_cosine_vote(
            jnp.asarray(x[i]), jnp.asarray(valid[i]), 0.2
        ))
        for i in range(3)
    ])
    np.testing.assert_allclose(port.numpy(), ref, atol=VOTE_TOL)
    # cosine_vote_plain is this vote with the first n_valid rows live
    np.testing.assert_array_equal(
        kernels.cosine_vote_plain(torch.from_numpy(x), 5, 0.2)[1].numpy(),
        port[1].numpy(),
    )


def test_pairwise_cosine_and_l2_normalize_match_jax():
    x = _embeddings((9, 48), seed=3)
    np.testing.assert_allclose(
        similarity.pairwise_cosine(torch.from_numpy(x)).numpy(),
        np.asarray(jax_similarity.pairwise_cosine(jnp.asarray(x))),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        similarity.l2_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jax_similarity.l2_normalize(jnp.asarray(x))),
        atol=1e-7,
    )


@pytest.mark.parametrize(
    "bad,exc",
    [
        ((np.zeros((4, 8), np.float32), 4, 0.05), ValueError),  # not 3-D
        ((np.zeros((1, 4, 8), np.float32), 5, 0.05), ValueError),  # n_valid
        ((np.zeros((1, 4, 8), np.float32), 0, 0.05), ValueError),
        ((np.zeros((1, 4, 8), np.float32), 4, 0.0), ValueError),  # T <= 0
        ((np.zeros((1, 4, 8), np.float64), 4, 0.05), TypeError),  # dtype
    ],
)
def test_vote_wrapper_rejects_bad_input(bad, exc):
    x, n_valid, temperature = bad
    with pytest.raises(exc):
        kernels.cosine_vote(torch.from_numpy(x), n_valid, temperature)


def test_vote_on_cpu_launches_no_kernel():
    before = kernels.cosine_vote.launches
    kernels.cosine_vote(torch.from_numpy(_embeddings((1, 4, 8), 0)), 4, 0.05)
    assert kernels.cosine_vote.launches == before


# -- attention -------------------------------------------------------------


def _attention_inputs(b, s, nh, hd, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, nh, hd)).astype(np.float32)
               for _ in range(3))
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = s
    mask = np.arange(s)[None, :] < lengths[:, None]
    mask[-1] = False  # one row whose keys are all padding
    bias = np.where(mask, 0.0, -1e9).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,nh,hd", [(3, 16, 2, 16), (2, 40, 4, 64)])
def test_plain_attention_matches_fused_attention_tiled(dtype, b, s, nh, hd):
    q, k, v, bias = _attention_inputs(b, s, nh, hd, seed=b * s + hd)
    scale = hd ** -0.5
    ref = np.asarray(
        jax_attention.fused_attention_tiled(
            *(jnp.asarray(t, dtype) for t in (q, k, v)),
            jnp.asarray(bias), scale, heads_per_step=1,
        ),
        np.float32,
    )
    tdt = getattr(torch, dtype)
    port = attention.attention(
        *(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
        torch.from_numpy(bias), scale,
    )
    assert port.dtype == tdt and port.shape == (b, s, nh, hd)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(port.float().numpy(), ref, atol=tol)
    # the all-padding row softmaxes to the uniform average of v, never NaN
    uniform = torch.from_numpy(v[-1]).to(tdt).float().mean(dim=0)
    np.testing.assert_allclose(
        port[-1].float().numpy(),
        np.broadcast_to(uniform.numpy(), (s, nh, hd)),
        atol=tol,
    )


def test_attention_reads_strided_operands():
    # q/k/v as views into one fused [b, s, 3, nh, hd] projection
    q, k, v, bias = _attention_inputs(2, 12, 2, 16, seed=5)
    fused = torch.from_numpy(np.stack([q, k, v], axis=2))
    views = [fused[:, :, i] for i in range(3)]
    assert not views[0].is_contiguous()
    got = attention.attention(*views, torch.from_numpy(bias), 0.25)
    want = attention.attention_plain(
        *(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(bias), 0.25
    )
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize(
    "change",
    ["shape", "bias_shape", "bias_dtype", "mixed_dtype", "f64"],
)
def test_attention_wrapper_rejects_bad_input(change):
    q, k, v, bias = (torch.from_numpy(t) for t in _attention_inputs(2, 8, 2, 16, 1))
    if change == "shape":
        k = k[:, :4]
    elif change == "bias_shape":
        bias = bias[:, :4]
    elif change == "bias_dtype":
        bias = bias.double()
    elif change == "mixed_dtype":
        v = v.bfloat16()
    else:
        q, k, v = q.double(), k.double(), v.double()
    with pytest.raises((ValueError, TypeError)):
        attention.attention(q, k, v, bias, 0.25)


# -- the kernel build --------------------------------------------------------


def test_build_finds_no_nvcc_here_and_says_so(monkeypatch, tmp_path):
    from llm_weighted_consensus_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_build_is_stale_when_missing_or_older_than_a_source(
    tmp_path, monkeypatch
):
    import os

    from llm_weighted_consensus_tpu_torch.ops import _build

    lib = tmp_path / _build.LIB_NAME
    assert _build._stale(lib)
    lib.write_bytes(b"")
    newest = max(path.stat().st_mtime for path in _build._inputs())
    os.utime(lib, (newest + 10, newest + 10))
    assert not _build._stale(lib)
    os.utime(lib, (newest - 10, newest - 10))
    assert _build._stale(lib)
    assert set(_build.SOURCES) == {
        p.name for p in _build.CSRC_DIR.glob("*.cu")
    }
    # a shared header newer than the library makes it stale too: a copy
    # of csrc/ whose one header is edited after the build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in _build.SOURCES:
        os.utime(_touch(csrc / name), (100, 100))
    header = _touch(csrc / "shared.cuh")
    os.utime(header, (100, 100))
    os.utime(lib, (200, 200))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    assert not _build._stale(lib)
    os.utime(header, (300, 300))
    assert _build._stale(lib)


def _touch(path):
    path.write_bytes(b"")
    return path
