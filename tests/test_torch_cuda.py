"""The PyTorch port's CUDA kernels on the card, against their plain
versions.

Every test here needs an NVIDIA GPU: it is marked ``cuda`` and skips with
a reason where ``torch.cuda.is_available()`` is False (decided in the
``card`` fixture, never at import).  The file imports torch, numpy and the
port only, so it runs on the machine with the card, which has no JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider

(``--noconftest``: the suite's conftest prepares JAX's virtual CPU mesh
and imports the JAX package.)

Tolerances: vote 1e-5 (f32 reassociation of the column-sum identity;
both routes, the cluster kernel at every shape the server makes and the
block kernel past the cluster plan's shared memory; also with an int32
count per request, where the scalar count is bit-equal to a tensor of
equal counts); the grouped stream update on bge-base against single
updates 1e-5;
attention and segment attention 1e-4 f32, 2e-2 bf16 (probabilities
rounded to bf16 before P·V); the GELU kernel bit-equal to its plain
version (the same f32 operations, each rounded alone) and the residual
add + LayerNorm within 1 ulp of bf16 / 4 of f32 at the largest output
(its row sums in another order than torch's mean); packed bge_micro on
the card against the CPU
and against the padded path 1e-5 (f32), a segment beside other row-mates
1e-6;
bge_micro /consensus on the card vs the CPU 1e-5 (f32); W8A8 / W4A8
2e-5 + 2e-5 |want| (f32: erf and exp differ by ulps between the card
and its plain version) and 2e-2 + 2e-2 |want| (bf16: one ulp at |x| ~ 4),
quantized bge_micro confidences card vs CPU 1e-3 (an upstream ulp can
flip one int8 rounding); the tiny DeBERTa reward model's confidences card
vs CPU 1e-5 (f32), 1e-3 quantized, and its packed rewards against
per-row ones on the card 1e-5; the training-table lookup on the card
against the CPU 1e-6 relative (ties in index order), and one
trained-weight score request on bge_micro card vs CPU 1e-5 relative on
the weights, the rest of its final frame equal (also for a
quorum-degraded request through a graphed server); the learners, in f32
with TF32 off: one InfoNCE step on bge_micro card vs CPU, the loss 1e-5
relative, every gradient 1e-4 of the largest gradient plus 1e-3
relative, the next step's loss 1e-4; the judge-weight fit 1e-5 on the
weights and 1e-5 relative on its losses.  Every kernel wrapper refuses an
input that requires grad under grad mode.  Device faults: a real
allocation past the card's memory classifies transient, and a CPU twin's
dispatch completes while a ``torch.cuda._sleep`` spin occupies the card
(its answers within 1e-5 of the card's f32 ones, no kernel launched).
The mesh (shards sharing the one card, or taking distinct cards where
there are): bge-base's tensor-parallel forward at tp 2 against the
one-device forward on the card, f32 1e-5 and bf16 2e-2 (row-split
partials reduced in f32, cast once, against bf16 outputs rounded per
GEMM); under int8 in f32 |Δ| <= 2e-2 and cosine >= 0.999 (the shared
row scale makes the shards' int8 rows the one-device layer's, but an
f32 ulp of a reduced partial can flip one int8 rounding of the next
layer's activations); the ring at sp 4 against the one-device forward, f32
1e-4, with every tp attention on the ``tma`` route in bf16; the
reward model's tensor-parallel layers and head (deberta-v3-base, f32,
tp 2) against one device 1e-4 + 1e-4 |want| (the f32 partials' sums in
another order, through 12 layers).  The fault ladder (test-tiny, f32, 4x2
over the card): every rung's answers 2e-4 from one device, no capture or
eager dispatch after the warmup.  Training on a mesh: bge-base's InfoNCE
step on 2x2 against one device, the loss 1e-4 relative, the parameters
1e-4 of the largest, the update 1e-3 of its norm.
"""

import os

import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu_torch.models import loading, quant, tokenizer
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.ops import _build, attention, kernels
from llm_weighted_consensus_tpu_torch.ops import norm_act
from llm_weighted_consensus_tpu_torch.serve import packing

pytestmark = pytest.mark.cuda

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bge_micro")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _embeddings(shape, seed):
    rng = np.random.default_rng(seed)
    *lead, n, d = shape
    center = rng.normal(size=(*lead, 1, d))
    return (center + 0.7 * rng.normal(size=shape)).astype(np.float32)


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


def _vote_on_route(x, n_valid, temperature, route):
    """One vote launch, held to its route and to the plain version:
    |diff| <= 1e-5, finite, sums 1 +- 1e-5, rows past n_valid exactly 0."""
    r, n, d = x.shape
    assert kernels.vote_route(r, n, d, x.dtype) == route
    before = dict(kernels.cosine_vote.routes)
    launches = kernels.cosine_vote.launches
    got = kernels.cosine_vote(x, n_valid, temperature)
    assert kernels.cosine_vote.launches == launches + 1
    assert kernels.cosine_vote.routes[route] == before[route] + 1
    want = kernels.cosine_vote_plain(x, n_valid, temperature)
    assert got.dtype == torch.float32 and got.shape == (r, n)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-5
    assert (got.sum(-1) - 1).abs().max().item() <= 1e-5
    assert (got[:, n_valid:] == 0).all()
    return got


@pytest.mark.parametrize("n", [2, 64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("temperature", [0.05, 0.7])
def test_vote_kernel_matches_plain(card, n, dtype, temperature):
    x = torch.from_numpy(_embeddings((8, n, 1024), seed=n)).to(
        card, getattr(torch, dtype)
    )
    _vote_on_route(x, n, temperature, "cluster")


@pytest.mark.parametrize("r", [1, 8, 16])
@pytest.mark.parametrize("n", [2, 16, 64, 256])
@pytest.mark.parametrize("d", [64, 384, 768, 1000, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vote_cluster_route_at_served_shapes(card, r, n, d, dtype):
    # every R the batcher makes up to 16, the gateway's N, each bge
    # width and a ragged D: the cluster kernel
    x = torch.from_numpy(_embeddings((r, n, d), seed=r * n + d)).to(
        card, getattr(torch, dtype)
    )
    _vote_on_route(x, n, 0.05 if n % 2 else 0.3, "cluster")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_valid", [1024, 700, 1])
def test_vote_block_route_past_the_plan(card, dtype, n_valid):
    # [2, 1024, 2048] needs more shared memory than a cluster block has
    x = torch.from_numpy(_embeddings((2, 1024, 2048), seed=n_valid)).to(
        card, getattr(torch, dtype)
    )
    got = _vote_on_route(x, n_valid, 0.05, "block")
    if n_valid == 1:
        assert (got[:, 0] == 1).all()


@pytest.mark.parametrize("r,n,d", [(8, 64, 1024), (16, 256, 1024),
                                   (1, 37, 1000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vote_kernel_is_bit_deterministic(card, r, n, d, dtype):
    x = torch.from_numpy(_embeddings((r, n, d), seed=d)).to(
        card, getattr(torch, dtype)
    )
    first = kernels.cosine_vote(x, n, 0.05)
    second = kernels.cosine_vote(x, n, 0.05)
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vote_kernel_reads_unaligned_rows(card, dtype):
    # a contiguous view one element past a 16-byte boundary
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(_embeddings((8, 64, 1024), seed=3)).to(card, tdt)
    flat = torch.empty(x.numel() + 1, device=card, dtype=tdt)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16
    got = _vote_on_route(view, 64, 0.05, "cluster")
    assert (got - kernels.cosine_vote(x, 64, 0.05)).abs().max().item() <= 1e-6


@pytest.mark.parametrize("r,n,d", [(1, 2, 64), (8, 64, 1024), (16, 256, 1024),
                                   (3, 40, 1000), (1, 256, 768)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vote_plan_matches_the_kernels_shared_memory(card, r, n, d, dtype):
    tdt = getattr(torch, dtype)
    plan = kernels.vote_plan(r, n, d, tdt)
    lib = _build.library()
    code = 0 if tdt == torch.float32 else 1
    assert lib.lwc_cosine_vote_cluster_smem(
        n, plan.cols, plan.cluster, code) == plan.smem_bytes


def test_vote_kernel_masks_padding_rows(card):
    x = torch.from_numpy(_embeddings((4, 40, 384), seed=1)).to(card)
    got = _vote_on_route(x, 33, 0.05, "cluster")
    want = kernels.cosine_vote(x[:, :33].contiguous(), 33, 0.05)
    assert (got[:, :33] - want).abs().max().item() <= 1e-5
    # one live row: a confidence of exactly 1
    one = _vote_on_route(x, 1, 0.05, "cluster")
    assert (one[:, 0] == 1).all()


def test_vote_kernel_rejects_non_contiguous(card):
    x = torch.from_numpy(_embeddings((2, 8, 64), seed=2)).to(card)
    with pytest.raises(ValueError):
        kernels.cosine_vote(x.transpose(0, 1), 8, 0.05)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,nh,hd",
    [(4, 128, 16, 64), (2, 77, 12, 32), (3, 200, 4, 16), (2, 33, 4, 24)],
)
def test_attention_kernel_matches_plain(card, dtype, b, s, nh, hd):
    tdt = getattr(torch, dtype)
    q, k, v, bias = (
        torch.from_numpy(t).to(card)
        for t in _attention_inputs(b, s, nh, hd, seed=s)
    )
    q, k, v = q.to(tdt), k.to(tdt), v.to(tdt)
    before = attention.attention.launches
    got = attention.attention(q, k, v, bias, hd ** -0.5)
    assert attention.attention.launches == before + 1
    want = attention.attention_plain(q, k, v, bias, hd ** -0.5)
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert got.dtype == tdt
    assert (got.float() - want.float()).abs().max().item() <= tol
    uniform = v[-1].float().mean(dim=0)
    assert (got[-1].float() - uniform[None]).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,h,width", [(37, 768, 3072), (9, 1024, 4096),
                                          (3, 96, 1001)])
def test_norm_act_kernels_match_plain(card, dtype, rows, h, width):
    """The GELU kernel is bit-equal to its plain version (the same f32
    operations, each rounded alone); the LayerNorm kernel within one ulp
    of bf16, four of f32, at the largest |output| (its row sums run in
    another order than torch's mean: ``chip_smoke.NORM_ULPS``)."""
    tdt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(rows)

    def rand(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * scale + shift).to(card, tdt)

    x, r = rand(rows, h, scale=2.0, shift=0.25), rand(rows, h, scale=3.0)
    w, b = rand(h, scale=0.2, shift=1.0), rand(h, scale=0.1)
    mant, ulps = (23, 4) if dtype == "float32" else (7, 1)
    for res in (r, None):
        before = norm_act.add_layer_norm.launches
        got = norm_act.add_layer_norm(x, res, w, b, 1e-12)
        assert norm_act.add_layer_norm.launches == before + 1
        want = norm_act.add_layer_norm_plain(x, res, w, b, 1e-12)
        assert got.dtype == tdt
        top = want.float().abs().max().item()
        ulp = 2.0 ** (np.frexp(top)[1] - 1 - mant)
        assert (got.float() - want.float()).abs().max().item() <= ulps * ulp
    y = rand(rows, width, scale=3.0)
    before = norm_act.gelu.launches
    got = norm_act.gelu(y)
    want = norm_act.gelu_plain(y)
    assert torch.equal(got, want)
    assert torch.equal(norm_act.gelu(y.clone(), inplace=True), want)
    assert norm_act.gelu.launches == before + 2


def test_attention_kernel_reads_unaligned_strided_views(card):
    q, k, v, bias = (
        torch.from_numpy(t).to(card)
        for t in _attention_inputs(3, 50, 4, 64, seed=9)
    )
    views = []
    for t in (q, k, v):
        wide = torch.zeros(3, 50, 4, 65, device=card, dtype=torch.bfloat16)
        wide[..., :64] = t
        views.append(wide[..., :64])
    got = attention.attention(*views, bias, 0.125)
    want = attention.attention_plain(*views, bias, 0.125)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def test_attention_kernel_rejects_unsupported_head_dim(card):
    q = torch.zeros(1, 4, 2, 128, device=card, dtype=torch.bfloat16)
    bias = torch.zeros(1, 4, device=card)
    with pytest.raises(ValueError, match="hd"):
        attention.attention(q, q, q, bias, 0.1)


def test_bge_micro_consensus_on_card_matches_cpu(card):
    cfg = loading.load_hf_config(FIXTURE)
    tok = tokenizer.load_tokenizer(loading.find_vocab(FIXTURE))
    texts = [
        "paris is the capital of france",
        "the capital of france is paris",
        "bananas are curved and yellow",
    ]
    confs = {}
    for device in ("cpu", "cuda"):
        model = loading.load_params(
            FIXTURE, cfg, dtype=torch.float32, device=device
        )
        emb = TorchEmbedder(
            "bge-micro", model=model, config=cfg, tokenizer=tok,
            max_tokens=64, device=device, dtype=torch.float32,
        )
        confs[device] = emb.consensus_confidence(texts)
    assert np.abs(confs["cuda"] - confs["cpu"]).max() <= 1e-5


def test_embedder_defaults_to_the_card_in_bf16(card):
    emb = TorchEmbedder("test-tiny", max_tokens=32)
    assert emb.device.type == "cuda" and emb.dtype == torch.bfloat16
    conf = emb.consensus_confidence(["a b", "a b c", "d"])
    assert conf.shape == (3,) and abs(float(conf.sum()) - 1.0) <= 1e-5


def _quant_operands(m, k, n, int4, seed, card, dtype):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((n, k)) * 0.05).astype(np.float32))
    fn = quant.quantize_weight_int4 if int4 else quant.quantize_weight
    wq, sw = fn(w)
    bias = torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    x[0] = 0.0  # an all-zero row
    return (x.to(card, getattr(torch, dtype)), wq.to(card), sw.to(card),
            bias.to(card))


@pytest.mark.parametrize("int4", [False, True], ids=["w8a8", "w4a8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize(
    "m,k,n", [(5, 48, 24), (37, 96, 384), (130, 192, 96), (300, 1024, 1024),
              (129, 4096, 136)],
)
def test_quant_matmul_kernel_matches_plain(card, int4, dtype, gelu, m, k, n):
    x, wq, sw, bias = _quant_operands(m, k, n, int4, m + k + n, card, dtype)
    wrapper = kernels.w4a8_matmul if int4 else kernels.w8a8_matmul
    plain = kernels.w4a8_matmul_plain if int4 else kernels.w8a8_matmul_plain
    before = (wrapper.launches, kernels.quantize_rows.launches)
    got = wrapper(x, wq, sw, bias, gelu=gelu)
    assert (wrapper.launches, kernels.quantize_rows.launches) == (
        before[0] + 1, before[1] + 1
    )
    want = plain(x, wq, sw, bias, gelu=gelu)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == (m, n)
    tol = 2e-5 if dtype == "float32" else 2e-2
    err = (got.float() - want.float()).abs()
    assert (err <= tol + tol * want.float().abs()).all(), err.max().item()


def test_quantize_rows_kernel_is_byte_equal_to_plain(card):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((70, 200)).astype(np.float32))
    x[0] = 0.0
    x[1, :6] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    x[1, 6:] = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        xc = x.to(card, dtype)
        got_q, got_s = kernels.quantize_rows(xc, 256)
        want_q, want_s = kernels.quantize_rows_plain(xc, 256)
        assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s)


def test_quant_matmul_takes_leading_axes(card):
    x, wq, sw, bias = _quant_operands(12, 96, 40, False, 3, card, "bfloat16")
    got = kernels.w8a8_matmul(x.view(3, 4, 96), wq, sw, bias)
    assert got.shape == (3, 4, 40)
    flat = kernels.w8a8_matmul(x, wq, sw, bias)
    assert torch.equal(got.reshape(12, 40), flat)


def test_quant_matmul_rejects_cpu_weights_for_a_card_input(card):
    x, wq, sw, bias = _quant_operands(4, 48, 24, False, 5, card, "float32")
    with pytest.raises(ValueError, match="devices"):
        kernels.w8a8_matmul(x, wq.cpu(), sw, bias)


@pytest.mark.parametrize("mode", ["int8", "int4-pallas"])
def test_quantized_bge_micro_on_card_matches_cpu(card, mode):
    cfg = loading.load_hf_config(FIXTURE)
    tok = tokenizer.load_tokenizer(loading.find_vocab(FIXTURE))
    texts = [
        "paris is the capital of france",
        "the capital of france is paris",
        "bananas are curved and yellow",
    ]
    confs = {}
    for device in ("cpu", "cuda"):
        model = loading.load_params(
            FIXTURE, cfg, dtype=torch.float32, device=device
        )
        emb = TorchEmbedder(
            "bge-micro", model=model, config=cfg, tokenizer=tok,
            max_tokens=64, device=device, dtype=torch.float32, quantize=mode,
        )
        assert all(
            m.scale.dtype == torch.float32 for m in emb.model.modules()
            if isinstance(m, quant.QuantLinear)
        )
        confs[device] = emb.consensus_confidence(texts)
    assert np.abs(confs["cuda"] - confs["cpu"]).max() <= 1e-3


def _segment_ids(b, s, seed):
    """Packed-row segment ids [b, s] int32: mixed segment lengths, pad
    gaps and tails, a row that is all pad, one-token segments, a segment
    straddling the 64-key tile edge and one starting past 64."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    for r in range(b):
        off, slot = 0, 1
        while off < s:
            n = int(rng.integers(1, 40))
            if rng.random() < 0.1:
                off += n
                continue
            seg[r, off: off + n] = slot
            off, slot = off + n, slot + 1
    seg[0] = 0
    if b > 1:
        seg[1] = 0
        seg[1, :3] = [1, 2, 3]
        if s > 70:
            seg[1, 60:70] = 4
            seg[1, s - 3:] = 5
    return seg


def _segment_case(card, b, s, nh, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, nh, hd)).astype(
        np.float32)).to(card, getattr(torch, dtype)) for _ in range(3))
    seg = torch.from_numpy(_segment_ids(b, s, seed)).to(card)
    return q, k, v, seg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,nh,hd",
    [(8, 512, 16, 64), (4, 192, 16, 64), (3, 200, 4, 16), (2, 77, 4, 24),
     (2, 130, 4, 32), (1, 64, 2, 64)],
)
def test_segment_attention_kernel_matches_plain(card, dtype, b, s, nh, hd):
    q, k, v, seg = _segment_case(card, b, s, nh, hd, dtype, seed=s + hd)
    before = attention.segment_attention.launches
    got = attention.segment_attention(q, k, v, seg, hd ** -0.5)
    assert attention.segment_attention.launches == before + 1
    want = attention.segment_attention_plain(q, k, v, seg, hd ** -0.5)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert got.dtype == q.dtype and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    # the all-pad row is the uniform mean of v
    uniform = v[0].float().mean(dim=0)
    assert (got[0].float() - uniform[None]).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_attention_kernel_at_64_segments_per_row(card, dtype):
    b, s, nh, hd = 8, 512, 16, 64
    q, k, v, _ = _segment_case(card, b, s, nh, hd, dtype, seed=3)
    seg = torch.arange(s, device=card, dtype=torch.int32) // 8 + 1
    seg = seg.expand(b, s).contiguous()
    got = attention.segment_attention(q, k, v, seg, 0.125)
    want = attention.segment_attention_plain(q, k, v, seg, 0.125)
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_segment_attention_kernel_reads_unaligned_strided_views(card):
    q, k, v, seg = _segment_case(card, 3, 100, 4, 64, "bfloat16", seed=9)
    views = []
    for t in (q, k, v):
        wide = torch.zeros(3, 100, 4, 65, device=card, dtype=torch.bfloat16)
        wide[..., :64] = t
        views.append(wide[..., :64])
    got = attention.segment_attention(*views, seg, 0.125)
    want = attention.segment_attention_plain(*views, seg, 0.125)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("bad", ["int64", "cpu_ids", "strided_ids", "hd"])
def test_segment_attention_rejects_bad_input(card, bad):
    q, k, v, seg = _segment_case(card, 2, 16, 2, 16, "bfloat16", seed=1)
    if bad == "int64":
        seg = seg.long()
    elif bad == "cpu_ids":
        seg = seg.cpu()
    elif bad == "strided_ids":
        seg = torch.cat([seg, seg], dim=1)[:, ::2]
        assert not seg.is_contiguous()
    else:
        q = k = v = torch.zeros(2, 16, 2, 128, device=card,
                                dtype=torch.bfloat16)
    before = attention.segment_attention.launches
    with pytest.raises(ValueError):
        attention.segment_attention(q, k, v, seg, 0.25)
    assert attention.segment_attention.launches == before


def _micro(device):
    cfg = loading.load_hf_config(FIXTURE)
    tok = tokenizer.load_tokenizer(loading.find_vocab(FIXTURE))
    model = loading.load_params(FIXTURE, cfg, dtype=torch.float32,
                                device=device)
    return TorchEmbedder(
        "bge-micro", model=model, config=cfg, tokenizer=tok, max_tokens=64,
        device=device, dtype=torch.float32,
    )


MICRO_TEXTS = [
    "paris is the capital of france",
    "the capital of france is paris",
    "bananas are curved and yellow",
    "a much longer candidate answer that talks about the capital city of "
    "france and the river that runs through it",
    "x",
]


def _packed_embed(emb, texts, row_tokens=64, max_rows=4, max_segments=8):
    calls = packing.build_calls(
        emb.tokenize_ragged(texts), row_tokens, max_rows, max_segments
    )
    out = [None] * len(texts)
    for c in calls:
        vecs = emb.embed_packed(c.ids, c.segment_ids, c.positions,
                                c.seg_starts)
        for si, (r, slot) in c.slots.items():
            out[si] = vecs[r, slot]
    return np.stack(out)


def test_packed_bge_micro_on_card_matches_cpu_and_padded(card):
    cpu, gpu = _micro("cpu"), _micro("cuda")
    before = attention.segment_attention.launches
    on_card = _packed_embed(gpu, MICRO_TEXTS)
    assert attention.segment_attention.launches > before
    assert np.abs(on_card - _packed_embed(cpu, MICRO_TEXTS)).max() <= 1e-5
    assert np.abs(on_card - gpu.embed_texts(MICRO_TEXTS)).max() <= 1e-5


def test_packed_segment_ignores_its_row_mates_on_card(card):
    gpu = _micro("cuda")
    alone = _packed_embed(gpu, MICRO_TEXTS[:1])[0]
    for mates in (MICRO_TEXTS[1:3], MICRO_TEXTS[3:]):
        got = _packed_embed(gpu, MICRO_TEXTS[:1] + mates)[0]
        assert np.abs(got - alone).max() <= 1e-6


# -- the TMA + wgmma routes (csrc/attention_sm90.cu, csrc/quant_gemm_sm90.cu)


def _routed(wrapper, route, call):
    """``call()`` with the check that it launched once, on ``route``."""
    before = dict(wrapper.routes)
    out = call()
    after = dict(wrapper.routes)
    assert {r: after[r] - before[r] for r in after if after[r] != before[r]} == {
        route: 1
    }
    return out


@pytest.mark.parametrize(
    "b,s",
    [(64, 128), (512, 128), (16, 512), (32, 64), (5, 77), (4, 100), (3, 130),
     (2, 200)],
)
def test_tma_attention_matches_plain(card, b, s):
    # bge-large's heads: 16 of 64, the encoder's views of a dense output
    q, k, v, bias = (
        torch.from_numpy(t).to(card)
        for t in _attention_inputs(b, s, 16, 64, seed=b + s)
    )
    q, k, v = (t.bfloat16().reshape(b, s, 1024).view(b, s, 16, 64)
               for t in (q, k, v))
    assert attention.attention_route(q, k, v) == "tma"
    got = _routed(attention.attention, "tma",
                  lambda: attention.attention(q, k, v, bias, 0.125))
    want = attention.attention_plain(q, k, v, bias, 0.125)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    uniform = v[-1].float().mean(dim=0)
    assert (got[-1].float() - uniform[None]).abs().max().item() <= 2e-2


def test_tma_attention_takes_a_head_major_view(card):
    # [b, nh, s, hd] storage seen as [b, s, nh, hd]
    q, k, v, bias = (
        torch.from_numpy(t).to(card) for t in _attention_inputs(3, 77, 4, 64, 5)
    )
    q, k, v = (t.bfloat16().transpose(1, 2).contiguous().transpose(1, 2)
               for t in (q, k, v))
    assert not q.is_contiguous()
    got = _routed(attention.attention, "tma",
                  lambda: attention.attention(q, k, v, bias, 0.125))
    want = attention.attention_plain(q, k, v, bias, 0.125)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize(
    "hd,dtype,route",
    [(32, "bfloat16", "mma"), (16, "bfloat16", "mma"), (24, "bfloat16", "fma"),
     (64, "float32", "fma")],
)
def test_other_attention_routes_are_counted(card, hd, dtype, route):
    q, k, v, bias = (
        torch.from_numpy(t).to(card) for t in _attention_inputs(3, 70, 4, hd, 2)
    )
    q, k, v = (t.to(getattr(torch, dtype)) for t in (q, k, v))
    got = _routed(attention.attention, route,
                  lambda: attention.attention(q, k, v, bias, hd ** -0.5))
    want = attention.attention_plain(q, k, v, bias, hd ** -0.5)
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize(
    "m,k,n",
    [(4096, 1024, 1024), (4096, 1024, 4096), (4096, 4096, 1024),
     (65536, 1024, 1024), (5, 48, 24), (37, 96, 384), (130, 192, 96),
     (300, 768, 3072)],
)
def test_tma_gemm_matches_plain(card, dtype, gelu, m, k, n):
    x, wq, sw, bias = _quant_operands(m, k, n, False, m + k + n, card, dtype)
    got = _routed(kernels.w8a8_matmul, "tma",
                  lambda: kernels.w8a8_matmul(x, wq, sw, bias, gelu=gelu))
    want = kernels.w8a8_matmul_plain(x, wq, sw, bias, gelu=gelu)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == (m, n)
    tol = 2e-5 if dtype == "float32" else 2e-2
    err = (got.float() - want.float()).abs()
    assert (err <= tol + tol * want.float().abs()).all(), err.max().item()


def _unaligned(t):
    """A copy of ``t`` whose base is off 16-byte alignment."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16
    return view


@pytest.mark.parametrize("int4,k", [(False, 1000), (False, 40), (True, 1024),
                                    (True, 96)])
def test_other_quant_gemm_calls_take_the_mma_route(card, int4, k):
    # W8A8 at K % 16 != 0; W4A8 (which takes the TMA route at any K) with
    # an unaligned packed weight
    x, wq, sw, bias = _quant_operands(33, k, 72, int4, k, card, "bfloat16")
    if int4:
        wq = _unaligned(wq)
    wrapper = kernels.w4a8_matmul if int4 else kernels.w8a8_matmul
    plain = kernels.w4a8_matmul_plain if int4 else kernels.w8a8_matmul_plain
    got = _routed(wrapper, "mma", lambda: wrapper(x, wq, sw, bias))
    want = plain(x, wq, sw, bias)
    err = (got.float() - want.float()).abs()
    assert (err <= 2e-2 + 2e-2 * want.float().abs()).all(), err.max().item()


# -- slice 5: the segment TMA kernel and the W4A8 TMA GEMM


@pytest.mark.parametrize(
    "b,s,hard",
    [(8, 512, False), (4, 384, False), (2, 192, False), (1, 64, False),
     (8, 512, True), (3, 300, True), (2, 100, True)],
)
def test_tma_segment_attention_matches_plain(card, b, s, hard):
    # bge-large's heads (16 of 64), bf16 views of a dense output; the
    # packed layouts and the hard ones (an all-pad row, one-token
    # segments, segments across the 64-row and 128-key edges)
    rng = np.random.default_rng(b * s)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, 1024)).astype(
        np.float32)).to(card, torch.bfloat16).view(b, s, 16, 64)
        for _ in range(3))
    if hard:
        seg = _segment_ids(b, s, seed=s)
    else:
        seg = np.zeros((b, s), np.int32)
        for r in range(b):
            off, slot = 0, 1
            while off < s - 8:
                n = int(min(rng.integers(6, 120), s - 4 - off))
                seg[r, off: off + n] = slot
                off, slot = off + n, slot + 1
    seg = torch.from_numpy(seg).to(card)
    assert attention.segment_attention_route(q, k, v) == "tma"
    got = _routed(attention.segment_attention, "tma",
                  lambda: attention.segment_attention(q, k, v, seg, 0.125))
    want = attention.segment_attention_plain(q, k, v, seg, 0.125)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    # pad query rows are the uniform mean of v over every key
    pads = seg == 0
    if pads.any():
        mean_v = v.float().mean(dim=1, keepdim=True).expand_as(got)
        err = (got.float() - mean_v).abs().amax(dim=(2, 3))[pads]
        assert err.max().item() <= 2e-2


def test_tma_segment_attention_at_64_segments_per_row(card):
    q, k, v, _ = _segment_case(card, 8, 512, 16, 64, "bfloat16", seed=4)
    seg = torch.arange(512, device=card, dtype=torch.int32) // 8 + 1
    seg = seg.expand(8, 512).contiguous()
    got = _routed(attention.segment_attention, "tma",
                  lambda: attention.segment_attention(q, k, v, seg, 0.125))
    want = attention.segment_attention_plain(q, k, v, seg, 0.125)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def test_tma_segment_attention_equals_the_mma_kernel_on_an_all_pad_call(card):
    # every logit -1e9: both kernels give the mean of v
    q, k, v, _ = _segment_case(card, 2, 200, 16, 64, "bfloat16", seed=6)
    seg = torch.zeros(2, 200, dtype=torch.int32, device=card)
    got = attention._launch("lwc_attention_seg_tma", q, k, v, seg, 0.125)
    old = attention._launch("lwc_attention_seg", q, k, v, seg, 0.125)
    mean_v = v.float().mean(dim=1, keepdim=True).expand_as(got)
    assert (got.float() - mean_v).abs().max().item() <= 2e-2
    assert (got.float() - old.float()).abs().max().item() <= 2e-2


def _schedule_layout(b, s, layout):
    """Segment ids [b, s] for holding the kernel's schedule to the plain
    one: the hard layouts, non-positive ids (pad slots), an all-pad call,
    8-token segments end to end and one segment per row."""
    if layout == "hard":
        return _segment_ids(b, s, seed=s)
    if layout == "negative":
        seg = _segment_ids(b, s, seed=s + 1)
        seg[:, 5:9] = -2
        seg[-1, s - 3:] = -1
        return seg
    if layout == "all_pad":
        return np.zeros((b, s), np.int32)
    if layout == "8_per_segment":
        return np.broadcast_to(np.arange(s, dtype=np.int32) // 8 + 1,
                               (b, s)).copy()
    return np.ones((b, s), np.int32)


@pytest.mark.parametrize(
    "b,s,layout",
    [(8, 512, "hard"), (3, 300, "hard"), (2, 100, "hard"),
     (3, 300, "negative"), (2, 200, "all_pad"), (8, 512, "8_per_segment"),
     (2, 130, "one_segment")],
)
def test_the_tma_segment_kernel_runs_the_plain_schedule(card, b, s, layout):
    # the schedule the kernel's producer ran, read back, is the plain
    # segment_tile_schedule at the block sizes it assumes, and the
    # output holds to the plain version (pad rows: id <= 0, the mean of v)
    q, k, v, _ = _segment_case(card, b, s, 16, 64, "bfloat16", seed=b + s)
    seg = torch.from_numpy(_schedule_layout(b, s, layout)).to(card)
    launches = attention.segment_attention.launches
    got, ran, blocks = attention.kernel_tile_schedule(q, k, v, seg, 0.125)
    assert attention.segment_attention.launches == launches
    assert blocks == (attention.SEG_BLOCK_Q, attention.SEG_BLOCK_K)
    plan = attention.segment_tile_schedule(seg)
    n = plan.shape[1]
    assert ran.shape[2] == plan.shape[2]
    assert torch.equal(ran[:, :n], plan) and not ran[:, n:].any()
    want = attention.segment_attention_plain(q, k, v, seg, 0.125)
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    pads = seg <= 0
    if pads.any():
        mean_v = v.float().mean(dim=1, keepdim=True).expand_as(got)
        err = (got.float() - mean_v).abs().amax(dim=(2, 3))[pads]
        assert err.max().item() <= 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize(
    "m,k,n",
    [(4096, 1024, 1024), (4096, 1024, 4096), (4096, 4096, 1024), (5, 48, 24),
     (37, 96, 384), (130, 192, 96), (17, 1000, 40), (300, 768, 3072)],
)
def test_tma_w4a8_matches_plain_and_the_mma_route_byte_for_byte(
    card, dtype, gelu, m, k, n
):
    x, wq, sw, bias = _quant_operands(m, k, n, True, m + k + n, card, dtype)
    got = _routed(kernels.w4a8_matmul, "tma",
                  lambda: kernels.w4a8_matmul(x, wq, sw, bias, gelu=gelu))
    want = kernels.w4a8_matmul_plain(x, wq, sw, bias, gelu=gelu)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == (m, n)
    tol = 2e-5 if dtype == "float32" else 2e-2
    err = (got.float() - want.float()).abs()
    assert (err <= tol + tol * want.float().abs()).all(), err.max().item()
    # the mma.sync route on the same quantised rows: the same int32 sums
    # and the same epilogue, so the same bytes
    got_mma = _routed(kernels.w4a8_matmul, "mma",
                      lambda: kernels.w4a8_matmul(x, _unaligned(wq), sw, bias,
                                                  gelu=gelu))
    torch.cuda.synchronize()
    assert torch.equal(got, got_mma)


# -- the DeBERTa reward model (rm scorer) --------------------------------------


def _rm_pair(card, log, quantize="none"):
    """The same random tiny DeBERTa weights as rerankers on the CPU and
    on the card, f32."""
    import dataclasses

    from llm_weighted_consensus_tpu_torch.models import configs, deberta
    from llm_weighted_consensus_tpu_torch.models.reranker import TorchReranker

    cfg = configs.DEBERTA_TEST_TINY
    if log:
        cfg = dataclasses.replace(cfg, position_buckets=8,
                                  max_relative_positions=32)
    state = {k: v.numpy() for k, v in deberta.init_params(
        cfg, seed=3, device="cpu").state_dict().items()}
    return [
        TorchReranker("deberta-test-tiny", device=device,
                      dtype=torch.float32, max_tokens=64, quantize=quantize,
                      model=deberta.from_state(state, cfg, torch.float32,
                                               device))
        for device in ("cpu", card)
    ]


RM_TEXTS = [" ".join(f"t{(7 * i + j) % 300}" for j in range(n))
            for i, n in enumerate((3, 62, 20, 40, 9, 30))]


@pytest.mark.parametrize("log", [False, True])
def test_rm_tiny_on_the_card_matches_the_cpu(card, log):
    cpu, gpu = _rm_pair(card, log)
    for prompt, temp in ((None, 1.0), ("which one", 0.3)):
        want, tokens = cpu.rerank_confidence(RM_TEXTS, prompt, temp)
        got, got_tokens = gpu.rerank_confidence(RM_TEXTS, prompt, temp)
        assert got_tokens == tokens
        assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("mode", ["int8", "int4-pallas"])
def test_rm_quantized_on_the_card_matches_the_cpu(card, mode):
    cpu, gpu = _rm_pair(card, True, mode)
    name = "w4a8_matmul" if mode.startswith("int4") else "w8a8_matmul"
    wrapper = getattr(kernels, name)
    launches = wrapper.launches
    got, _ = gpu.rerank_confidence(RM_TEXTS, "which one")
    assert wrapper.launches - launches == 6 * gpu.config.num_layers
    want, _ = cpu.rerank_confidence(RM_TEXTS, "which one")
    assert np.abs(got - want).max() <= 1e-3


def test_rm_reward_packed_on_the_card_matches_per_row(card):
    from llm_weighted_consensus_tpu_torch.models import deberta

    _, gpu = _rm_pair(card, True)
    ids, mask = gpu.tokenize(RM_TEXTS)
    lens = mask.sum(axis=1)
    with torch.inference_mode():
        per_row = deberta.reward(gpu.model, torch.from_numpy(ids).to(card),
                                 torch.from_numpy(mask).to(card)).cpu()
        ragged = [ids[i, :lens[i]] for i in range(len(RM_TEXTS))]
        for call in packing.build_calls(ragged, 64, 4, 8):
            out = deberta.reward_packed(
                gpu.model, *(torch.from_numpy(a).to(card) for a in
                             (call.ids, call.segment_ids, call.seg_starts))
            ).cpu()
            assert torch.isfinite(out).all()
            for si, (r, slot) in call.slots.items():
                assert abs(float(out[r, slot] - per_row[si])) <= 1e-5


# -- CUDA graphs per bucket (models/graphs.py) and the served pipeline -------
#
# A replay runs the kernels its capture recorded on the inputs copied into
# the graph's static tensors, so against the eager forward at the same
# bucket on the same inputs its output (f32 confidences or embeddings, in
# bf16 and f32 models alike) is held to GRAPH_TOL: only cuBLAS's choice of
# algorithm inside a capture could differ.  Where a test pits two groups
# or two temperatures against each other, their eager answers must differ
# by more than CROSS_TALK_MARGIN times that, so a swap would fail it.

GRAPH_TOL, CROSS_TALK_MARGIN = 1e-6, 10.0


def _max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _apart(answers) -> float:
    """The least max-abs difference between any two of ``answers``."""
    return min(_max_abs(a, b) for i, a in enumerate(answers)
               for b in answers[i + 1:])


@pytest.fixture(scope="module")
def base_model():
    """bge-base-en (bf16, hd 64: every attention on the tma route),
    random weights from seed 0, shared by the graph tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return TorchEmbedder("bge-base-en", seed=0, dtype=torch.bfloat16,
                         max_tokens=128, device="cuda")


@pytest.fixture(scope="module")
def base_int8(base_model):
    """bge-base-en under int8 (W8A8 on the tma route), same seed."""
    return TorchEmbedder("bge-base-en", seed=0, dtype=torch.bfloat16,
                         max_tokens=128, device="cuda", quantize="int8")


def _fresh(emb):
    """An embedder over ``emb``'s weights with no graphs of its own."""
    return TorchEmbedder(emb.model_name, model=emb.model, config=emb.config,
                         tokenizer=emb.tokenizer, max_tokens=emb.max_tokens,
                         device=emb.device, dtype=emb.dtype,
                         quantize=emb.config.quantize)


def _texts(n, words, seed):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(400)]
    stem = list(rng.choice(vocab, size=words // 2))
    return [" ".join(stem + list(rng.choice(vocab, size=words - len(stem))))
            for _ in range(n)]


def _bucket_call(emb, kind, seed=0, temperature=0.05):
    """(warmup arguments, a call at that bucket) for one bucket kind."""
    if kind == "vote1":
        ids, mask = emb.tokenize(_texts(8, 40, seed))
        return (([(8, 48)],), lambda: emb.consensus_confidence_tokens(
            ids, mask, temperature))
    if kind == "many":
        ids, mask = emb.tokenize(_texts(3 * 8, 40, seed))
        ids, mask = ids.reshape(3, 8, -1), mask.reshape(3, 8, -1)
        return (([(8, 48)], [4]), lambda: emb.consensus_confidence_tokens_many(
            ids, mask, temperature))
    if kind == "embed":
        ids, mask = emb.tokenize(_texts(5, 40, seed))
        return (([(5, 48)],), lambda: emb.embed_tokens(ids, mask))
    texts = _texts(9, 30, seed) + _texts(4, 12, seed + 1)
    calls = packing.build_calls(emb.tokenize_ragged(texts), 128, 4, 8)
    call = calls[0]
    bucket = (*call.ids.shape, call.seg_starts.shape[1])
    return (([], [], [bucket]), lambda: emb.embed_packed(
        call.ids, call.segment_ids, call.positions, call.seg_starts))


@pytest.mark.parametrize("kind", ["vote1", "many", "embed", "packed"])
@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_graph_replay_equals_eager(request, kind, quantize):
    emb = _fresh(request.getfixturevalue(
        "base_model" if quantize == "none" else "base_int8"))
    wrapper = kernels.w8a8_matmul
    launches = wrapper.launches
    warm_args, call = _bucket_call(emb, kind)
    eager = call()
    assert emb.graph_stats()["eager_dispatches"] == 1
    timings = emb.warmup(*warm_args)
    assert timings and emb.graph_stats()["captures"] == len(timings)
    got = call()
    stats = emb.graph_stats()
    assert stats["replays"] == 1 and stats["eager_dispatches"] == 1
    assert stats["pool_bytes"] > 0
    assert got.shape == eager.shape and np.isfinite(got).all()
    assert _max_abs(got, eager) <= GRAPH_TOL
    if quantize == "int8":
        # the eager call, one eager run per warmed bucket before its
        # capture, the replay; the capture itself launches nothing
        runs = 2 + len(timings)
        assert wrapper.launches - launches == runs * 6 * emb.config.num_layers


def test_graph_replay_equals_eager_in_f32_on_bge_micro(card):
    emb = _micro("cuda")
    ids, mask = emb.tokenize(MICRO_TEXTS)
    many = (np.stack([ids, ids[::-1]]), np.stack([mask, mask[::-1]]))
    eager = (emb.consensus_confidence_tokens(ids, mask, 0.1),
             emb.consensus_confidence_tokens_many(*many, 0.1),
             emb.embed_tokens(ids, mask))
    emb.warmup([(len(MICRO_TEXTS), ids.shape[1])], [2])
    got = (emb.consensus_confidence_tokens(ids, mask, 0.1),
           emb.consensus_confidence_tokens_many(*many, 0.1),
           emb.embed_tokens(ids, mask))
    assert emb.graph_stats()["replays"] == 3
    for g, e in zip(got, eager):
        assert _max_abs(g, e) <= GRAPH_TOL


def test_rm_graph_replay_equals_eager(card):
    _, gpu = _rm_pair(card, True)
    eager, _ = gpu.rerank_confidence(RM_TEXTS, "which one", 0.7)
    ids, _ = gpu.tokenize([f"which one\n{t}" for t in RM_TEXTS])
    assert gpu.warmup([ids.shape]) and gpu.graph_stats()["captures"] == 1
    got, _ = gpu.rerank_confidence(RM_TEXTS, "which one", 0.7)
    assert gpu.graph_stats()["replays"] == 1
    assert _max_abs(got, eager) <= GRAPH_TOL


def test_one_graph_serves_two_temperatures(base_model):
    emb = _fresh(base_model)
    eager = {t: _bucket_call(emb, "vote1", temperature=t)[1]()
             for t in (0.05, 0.7)}
    emb.warmup([(8, 48)])
    for t in (0.05, 0.7):
        got = _bucket_call(emb, "vote1", temperature=t)[1]()
        assert _max_abs(got, eager[t]) <= GRAPH_TOL
    assert _apart(list(eager.values())) > CROSS_TALK_MARGIN * GRAPH_TOL
    assert emb.graph_stats()["replays"] == 2


def test_kernel_counters_advance_per_replay(base_model):
    emb = _fresh(base_model)
    warm_args, call = _bucket_call(emb, "many")
    emb.warmup(*warm_args)
    layers = emb.config.num_layers
    before = (attention.attention.launches, dict(attention.attention.routes),
              kernels.cosine_vote.launches, dict(kernels.cosine_vote.routes))
    for _ in range(3):
        call()
    assert attention.attention.launches - before[0] == 3 * layers
    assert attention.attention.routes["tma"] - before[1]["tma"] == 3 * layers
    assert kernels.cosine_vote.launches - before[2] == 3
    assert kernels.cosine_vote.routes["cluster"] - before[3]["cluster"] == 3


def test_no_capture_after_warmup_under_mixed_load(base_model):
    emb = _fresh(base_model)
    emb.warmup([(8, 48), (5, 48)], [2, 4])
    stats0 = emb.graph_stats()
    calls = [_bucket_call(emb, "vote1", seed, t)[1]
             for seed, t in ((1, 0.05), (2, 0.3))]
    calls.append(_bucket_call(emb, "many", 3, 0.2)[1])
    calls.append(_bucket_call(emb, "embed", 4)[1])
    for r in (2, 4):
        ids, mask = emb.tokenize(_texts(r * 8, 40, r))
        calls.append(lambda ids=ids, mask=mask, r=r:
                     emb.consensus_confidence_tokens_many(
                         ids.reshape(r, 8, -1), mask.reshape(r, 8, -1)))
    for call in calls * 2:
        call()
    stats1 = emb.graph_stats()
    assert stats1["captures"] == stats0["captures"] == stats0["graphs"]
    assert stats1["eager_dispatches"] == 0
    assert stats1["replays"] == 2 * len(calls)
    assert stats1["pool_bytes"] == stats0["pool_bytes"]


def test_two_dispatches_in_flight_on_one_graph(base_model):
    """Two groups of one bucket launched back to back, neither waited
    for: each copy-out lands in its own pinned buffer before the next
    replay overwrites the graph's static tensors."""
    from llm_weighted_consensus_tpu_torch.models import dispatch_seam

    emb = _fresh(base_model)
    ids = [emb.tokenize(_texts(8, 40, seed)) for seed in (5, 6)]
    eager = [emb.consensus_confidence_tokens(i, m) for i, m in ids]
    emb.warmup([(8, 48)])
    sink = dispatch_seam.DispatchSink()
    with dispatch_seam.deferred_readiness(sink):
        handles = [emb.consensus_confidence_tokens(i, m) for i, m in ids]
    dispatch_seam.drain_sink(sink, release=emb.staging_pool.release)
    for h, e in zip(handles, eager):
        assert _max_abs(h.result(), e) <= GRAPH_TOL
    assert _apart(eager) > CROSS_TALK_MARGIN * GRAPH_TOL
    assert emb.graph_stats()["replays"] == 2


def test_pipelined_batcher_on_warmed_graphs(base_model):
    """The batcher at pipeline depth 2 over warmed buckets: every
    dispatch's output is the eager forward's at the same bucket on the
    same inputs, and every request's answer is its own rows' output."""
    import concurrent.futures

    from llm_weighted_consensus_tpu_torch.serve.batcher import DeviceBatcher

    emb = _fresh(base_model)
    reqs = [_texts(8, 40, 10 + i) for i in range(12)]
    rows = [emb.tokenize(t)[0] for t in reqs]
    assert _apart([emb.consensus_confidence(t) for t in reqs]) > (
        CROSS_TALK_MARGIN * GRAPH_TOL)
    emb.warmup([(8, 48)], [2, 4])
    table, records = emb.graphs, []
    inner = table.dispatch

    def recording(key, label, arrays, forward, post, pool, timed=True):
        kept = {name: np.array(a, copy=True) for name, a in arrays.items()}
        out = inner(key, label, arrays, forward, post, pool, timed)
        records.append((key, kept, forward, post, out))
        return out

    table.dispatch = recording
    try:
        with DeviceBatcher(emb, window_ms=0.0, max_batch=2,
                           pipeline_depth=2) as batcher:
            with concurrent.futures.ThreadPoolExecutor(12) as pool:
                got = list(pool.map(batcher.consensus, reqs))
            util = batcher.utilization()
    finally:
        del table.dispatch
    served = {}
    for key, kept, forward, post, out in records:
        with table.lock, torch.inference_mode():
            eager = post(forward(**{n: torch.from_numpy(a).to(emb.device)
                                    for n, a in kept.items()}))
        value = out.result()
        assert _max_abs(value, eager.float().cpu().numpy()) <= GRAPH_TOL
        ids = kept["ids"].astype(np.int32)
        for g, conf in enumerate(value.reshape(-1, 8)):
            served[ids[g * 8:(g + 1) * 8].tobytes()] = conf
    for (conf, _), ids in zip(got, rows):
        assert np.array_equal(conf, served[ids.astype(np.int32).tobytes()])
    assert len(records) == util["dispatches"] >= 6
    stats = emb.graph_stats()
    assert stats["eager_dispatches"] == len(reqs)  # the eager answers above
    assert stats["replays"] == util["dispatches"]


@pytest.mark.parametrize("kind", ["consensus", "embed"])
def test_traced_graphed_dispatch_matches_the_untraced_one(base_model, kind):
    """A traced request through the batcher at a warmed bucket: the same
    launches on the same routes as untraced, every one from a replay, no
    capture and no eager dispatch, the answer bit-equal to the untraced
    one, and its ``batcher:*`` -> ``device:dispatch`` spans finished by
    the time the caller holds the answer."""
    from llm_weighted_consensus_tpu_torch import obs
    from llm_weighted_consensus_tpu_torch.serve.batcher import DeviceBatcher

    emb = _fresh(base_model)
    texts = _texts(8, 40, 21)
    emb.warmup([(8, 48)])
    stats0 = emb.graph_stats()
    wrappers = (attention.attention, kernels.cosine_vote)
    runs = []
    with DeviceBatcher(emb, window_ms=0.0) as batcher:
        for traced in (False, True, False, True):
            before = [(w.launches, dict(w.routes)) for w in wrappers]
            root = obs.start_trace("test", sampled=True) if traced else None
            token = root.activate() if root is not None else None
            try:
                if kind == "consensus":
                    answer, _ = batcher.consensus(texts)
                else:
                    answer, _ = batcher.embed(texts)
            finally:
                if token is not None:
                    obs.Span.deactivate(token)
            deltas = [
                (w.launches - n, {r: c - routes.get(r, 0)
                                  for r, c in w.routes.items()
                                  if c - routes.get(r, 0)})
                for w, (n, routes) in zip(wrappers, before)
            ]
            runs.append((answer, deltas, root))
    layers = emb.config.num_layers
    votes = 1 if kind == "consensus" else 0
    for answer, deltas, root in runs:
        assert np.array_equal(answer, runs[0][0])
        assert deltas == runs[0][1]
        assert deltas[0] == (layers, {"tma": layers})
        assert deltas[1][0] == votes
        if root is not None:
            spans = {s.name: s for s in root.trace.spans}
            queued, device = spans[f"batcher:{kind}"], spans["device:dispatch"]
            assert device.parent_id == queued.span_id
            assert queued.duration_ms() is not None
            assert device.duration_ms() is not None
            assert device.attributes == {"kind": kind, "batch_size": 1}
    stats = emb.graph_stats()
    assert stats["captures"] == stats0["captures"]
    assert stats["eager_dispatches"] == stats0["eager_dispatches"]
    assert stats["replays"] - stats0["replays"] == 4


# -- the vote with a count per request, and the stream update ------------------
#
# The streaming consensus votes R streams of different lengths in one
# launch: ``cosine_vote(emb, n_valid)`` with ``n_valid`` an int32 tensor
# [R] on the card.  Both routes against the plain version (1e-5), the
# scalar count bit-equal to a tensor of equal counts, a count of 0 a row
# of zeros; the grouped stream update on bge-base against single updates.


def _counts(r, cap, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, cap + 1, r)
    counts[0] = 1
    counts[-1] = cap
    return torch.tensor(counts, dtype=torch.int32, device="cuda")


def _vote_entry(x, counts, route):
    """One launch of ``route``'s kernel through its C entry."""
    r, n, d = x.shape
    conf = torch.empty((r, n), dtype=torch.float32, device="cuda")
    lib, dtype = _build.library(), 0 if x.dtype == torch.float32 else 1
    stream = torch.cuda.current_stream().cuda_stream
    ptr = None if counts is None else counts.data_ptr()
    if route == "cluster":
        plan = kernels.vote_plan(r, n, d, x.dtype)
        rc = lib.lwc_cosine_vote_cluster(
            x.data_ptr(), conf.data_ptr(), r, n, d, n, ptr, 0.05, dtype,
            plan.cluster, plan.cols, stream)
    else:
        rc = lib.lwc_cosine_vote(x.data_ptr(), conf.data_ptr(), r, n, d, n,
                                 ptr, 0.05, dtype, stream)
    _build.check(rc, route)
    return conf


@pytest.mark.parametrize("r", [1, 2, 8, 16])
@pytest.mark.parametrize("cap", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["cluster", "block"])
def test_vote_with_a_count_per_request_matches_plain(card, r, cap, dtype,
                                                     route):
    x = torch.tensor(_embeddings((r, cap, 1024), seed=r + cap),
                     dtype=getattr(torch, dtype), device=card)
    counts = _counts(r, cap, seed=cap)
    if route == "cluster":
        before = kernels.cosine_vote.routes["cluster"]
        got = kernels.cosine_vote(x, counts, 0.05)
        assert kernels.cosine_vote.routes["cluster"] == before + 1
    else:
        got = _vote_entry(x, counts, "block")
    want = kernels.cosine_vote_plain(x, counts, 0.05)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5
    for i, c in enumerate(counts.tolist()):
        assert (got[i, c:] == 0).all()
        assert abs(got[i].sum().item() - 1.0) <= 1e-5
    ones = counts == 1
    assert (got[ones, 0] == 1).all()  # a count of 1: exactly 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["cluster", "block"])
def test_vote_scalar_count_is_bit_equal_to_a_constant_vector(card, dtype,
                                                             route):
    x = torch.tensor(_embeddings((8, 64, 1024), seed=3),
                     dtype=getattr(torch, dtype), device=card)
    for n in (1, 40, 64):
        same = torch.full((8,), n, dtype=torch.int32, device=card)
        lib, dt = _build.library(), 0 if x.dtype == torch.float32 else 1
        stream = torch.cuda.current_stream().cuda_stream
        outs = []
        for ptr in (None, same.data_ptr()):
            conf = torch.empty((8, 64), dtype=torch.float32, device=card)
            if route == "cluster":
                plan = kernels.vote_plan(8, 64, 1024, x.dtype)
                rc = lib.lwc_cosine_vote_cluster(
                    x.data_ptr(), conf.data_ptr(), 8, 64, 1024, n, ptr, 0.05,
                    dt, plan.cluster, plan.cols, stream)
            else:
                rc = lib.lwc_cosine_vote(x.data_ptr(), conf.data_ptr(), 8, 64,
                                         1024, n, ptr, 0.05, dt, stream)
            _build.check(rc, route)
            outs.append(conf)
        assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("route", ["cluster", "block"])
def test_vote_count_of_zero_gives_zeros(card, route):
    x = torch.tensor(_embeddings((3, 32, 1024), seed=5), device=card)
    counts = torch.tensor([0, 32, 7], dtype=torch.int32, device=card)
    got = _vote_entry(x, counts, route)
    want = kernels.cosine_vote_plain(x, counts, 0.05)
    torch.cuda.synchronize()
    assert (got[0] == 0).all() and (got[2, 7:] == 0).all()
    assert (got - want).abs().max().item() <= 1e-5


def test_stream_vote_update_many_matches_single_updates(base_model):
    """bge-base: one grouped update of 5 streams (mixed counts, one
    capacity) against 5 single-stream updates on copies of the same
    buffers: confidences within 1e-5 and each buffer's new row the
    stream's own vector (f32 buffers; bf16 rows of the same padded
    batch of 16)."""
    emb = _fresh(base_model)
    r, cap = 5, 32
    counts = [1, 4, 0, 17, 31]
    rng = np.random.default_rng(7)
    base = rng.normal(size=(r, cap, emb.config.hidden_size)).astype(
        np.float32)
    for i, c in enumerate(counts):
        base[i, c:] = 0.0
    texts = _texts(r, 40, 12)
    bufs = [torch.tensor(base[i], device="cuda") for i in range(r)]
    launches = kernels.cosine_vote.launches
    many = emb.stream_vote_update_many(texts, bufs, counts, 0.05)
    assert kernels.cosine_vote.launches == launches + 1
    for i in range(r):
        buf = torch.tensor(base[i], device="cuda")
        single = emb.stream_vote_update(texts[i], buf, counts[i], 0.05)
        assert _max_abs(single, many[i]) <= 1e-5
        assert _max_abs(buf.cpu(), bufs[i].cpu()) <= 1e-5
        assert (many[i][counts[i] + 1:] == 0).all()
        assert abs(float(many[i].sum()) - 1.0) <= 1e-5


# -- the score path: the training-table lookup and one request --------------


def _tie_tables(seed=3, j=5, t=12, d=24):
    """Per-judge tables with padded rows and, in judge 4, six identical
    nearest rows with different scores (exact ties at the k-th place)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=d).astype(np.float32)
    tables = rng.normal(size=(j, t, d)).astype(np.float32)
    mask = np.ones((j, t), np.float32)
    mask[1, 3:] = 0
    mask[2, 1:] = 0
    near = q + 0.3 * rng.normal(size=d).astype(np.float32)
    for r in (0, 1, 2, 3, 4, 10):
        tables[4, r] = near
    tables[mask == 0] = 0.0
    scores = rng.random((j, t)).astype(np.float32)
    lo = np.ones(j, np.float32)
    hi = np.full(j, 5.0, np.float32)
    return tables, mask, scores, q, lo, hi


@pytest.mark.parametrize("k", [1, 3, 5, 12, 40])
def test_lookup_tie_order_and_weights_on_the_card(card, k):
    """The stable top-k picks the lower index among ties on the card as
    on the CPU (``jax.lax.top_k``'s order), and the weights match the
    CPU's within 1e-6 relative."""
    from llm_weighted_consensus_tpu_torch.ops import similarity

    args = _tie_tables()
    sims = torch.tensor(args[0][4] @ args[3], device=card)
    sims[:] = sims[0]  # every row tied
    _, idx = similarity._top_k(sims, min(k, sims.shape[0]))
    assert idx.tolist() == list(range(min(k, sims.shape[0])))
    want = similarity.training_table_weights_batched(
        *map(torch.from_numpy, args), k).numpy()
    got = similarity.training_table_weights_batched(
        *(torch.from_numpy(a).to(card) for a in args), k).cpu().numpy()
    assert got.dtype == np.float32
    assert np.max(np.abs(got - want) / np.abs(want)) <= 1e-6


def test_one_score_request_with_trained_weights_on_the_card(card):
    """One training-table score request on bge_micro through the port's
    ScoreClient and the batcher on the card, against the same request on
    the CPU: weights within 1e-5 relative, the rest of the final frame
    equal."""
    import asyncio
    import random

    from llm_weighted_consensus_tpu_torch import archive, registry
    from llm_weighted_consensus_tpu_torch.clients import chat as chat_mod
    from llm_weighted_consensus_tpu_torch.clients.score import ScoreClient
    from llm_weighted_consensus_tpu_torch.identity.model import ModelBase
    from llm_weighted_consensus_tpu_torch.serve.batcher import DeviceBatcher
    from llm_weighted_consensus_tpu_torch.types.score_request import (
        ChatCompletionCreateParams,
    )
    from llm_weighted_consensus_tpu_torch.weights import WeightFetchers
    from llm_weighted_consensus_tpu_torch.weights.training_table import (
        TorchTrainingTableFetcher,
        TrainingTableStore,
    )

    class Upstream(chat_mod.Transport):
        """Every judge picks the ballot's first key."""

        async def post_sse(self, url, headers, body):
            import json

            req = json.loads(body)
            ballot = req["messages"][-1]["content"]
            key = ballot.split('"', 2)[1]

            class Resp(chat_mod.TransportResponse):
                status = 200

                async def read_body(self):
                    return b""

                async def byte_stream(self):
                    chunk = {"id": "u", "object": "chat.completion.chunk",
                             "created": 1, "model": req["model"],
                             "choices": [{"index": 0, "delta": {
                                 "content": f"pick {key}"},
                                 "finish_reason": "stop"}]}
                    yield f"data: {json.dumps(chunk)}\n\n".encode()
                    yield b"data: [DONE]\n\n"

            return Resp()

    body = {
        "messages": [{"role": "user", "content": "the capital of france"}],
        "model": {"llms": [{"model": f"judge-{i}", "weight": {
            "type": "training_table", "base_weight": 1, "min_weight": 1,
            "max_weight": 5}} for i in range(3)],
            "weight": {"type": "training_table",
                       "embeddings": {"model": "bge-micro",
                                      "max_tokens": 32}, "top": 2}},
        "choices": ["paris", "lyon", "nice"],
    }
    model = ModelBase.from_json_obj(body["model"]).into_model_validate()
    finals = {}
    for device in ("cpu", "cuda"):
        emb = _micro_embedder(device)
        store = TrainingTableStore()
        rows = emb.embed_texts(["paris is in france", "lyon", "rivers",
                                "france", "capital cities"])
        for llm in model.llms[:2]:
            store.add_rows(llm.training_table_id, rows,
                           np.random.default_rng(7).random(len(rows)))
        with DeviceBatcher(emb, window_ms=1) as batcher:
            client = ScoreClient(
                chat_mod.DefaultChatClient(
                    Upstream(), [chat_mod.ApiBase("https://u", "k")],
                    backoff=chat_mod.BackoffPolicy(max_elapsed_ms=0)),
                registry.InMemoryModelRegistry(),
                archive_fetcher=archive.InMemoryArchive(),
                weight_fetchers=WeightFetchers(
                    training_table_fetcher=TorchTrainingTableFetcher(
                        emb, store, batcher=batcher)),
                rng_factory=lambda: random.Random(5))
            params = ChatCompletionCreateParams.from_json_obj(body)
            result = asyncio.new_event_loop().run_until_complete(
                client.create_unary(None, params))
        finals[device] = result.to_json_obj()
    got, want = finals["cuda"], finals["cpu"]
    w_got = [float(c["weight"]) for c in got["choices"]]
    w_want = [float(c["weight"]) for c in want["choices"]]
    assert np.max(np.abs(np.subtract(w_got, w_want))
                  / np.maximum(np.abs(w_want), 1e-30)) <= 1e-5
    for obj in (got, want):
        obj["id"] = obj["created"] = None
        obj.pop("weight_data")
        for c in obj["choices"]:
            c["weight"] = c["confidence"] = None
    assert got == want


def _quorum_score_on(device):
    """One streamed, quorum-degraded score request through a graphed
    bge_micro server (``build_server``, ``warm_up``) on ``device``: three
    training-table judges behind ``RESILIENCE_QUORUM=0.5`` and
    ``HOST_FASTPATH``, two agreeing at once and the third stalling until
    it is cancelled -> (final frame, graph stats delta, resilience
    counters)."""
    import asyncio
    import http.client
    import json

    from llm_weighted_consensus_tpu_torch.clients import chat as chat_mod
    from llm_weighted_consensus_tpu_torch.identity.model import ModelBase
    from llm_weighted_consensus_tpu_torch.models.embedder import _seq_bucket
    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_server,
        warm_up,
    )
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig

    class Upstream(chat_mod.Transport):
        """Every judge names the key of "paris" on its ballot; judge-2
        first stalls (the quorum cancels it)."""

        async def post_sse(self, url, headers, body):
            req = json.loads(body)
            text = req["messages"][-1]["content"]
            ballot = json.loads(text.split("Select the response:\n\n", 1)[1]
                                .split("\n\nOutput", 1)[0])
            key = next(k for k, v in ballot.items() if v == "paris")

            class Resp(chat_mod.TransportResponse):
                status = 200

                async def read_body(self):
                    return b""

                async def byte_stream(self):
                    if req["model"] == "judge-2":
                        await asyncio.sleep(30.0)
                    chunk = {"id": "u", "object": "chat.completion.chunk",
                             "created": 1, "model": req["model"],
                             "choices": [{"index": 0, "delta": {
                                 "content": f"pick {key}"},
                                 "finish_reason": "stop"}]}
                    yield f"data: {json.dumps(chunk)}\n\n".encode()
                    yield b"data: [DONE]\n\n"

            return Resp()

    body = {
        "stream": True,
        "messages": [{"role": "user", "content": "the capital of france"}],
        "model": {"llms": [{"model": f"judge-{i}", "weight": {
            "type": "training_table", "base_weight": 1, "min_weight": 1,
            "max_weight": 5}} for i in range(3)],
            "weight": {"type": "training_table",
                       "embeddings": {"model": "bge-micro",
                                      "max_tokens": 32}, "top": 2}},
        "choices": ["paris", "lyon", "nice"],
    }
    model = ModelBase.from_json_obj(body["model"]).into_model_validate()
    emb = _micro_embedder(device)
    seq = _seq_bucket(int(emb.tokenize(
        ["user: the capital of france"], 32)[1].sum()), 32)
    config = ServeConfig.from_env({
        "OPENAI_API_BASE": "http://127.0.0.1:9/v1", "OPENAI_API_KEY": "k",
        "BACKOFF_MAX_ELAPSED_TIME_MILLIS": "0", "RESILIENCE_QUORUM": "0.5",
        "HOST_FASTPATH": "1", "WARMUP": f"16x{seq}"})
    server = build_server(emb, None, config, device=device).start()
    try:
        server.score_client.chat_client.transport = Upstream()
        rows = emb.embed_texts(["paris is in france", "lyon", "rivers",
                                "france", "capital cities"])
        for llm in model.llms[:2]:
            server.tables.add_rows(llm.training_table_id, rows,
                                   np.random.default_rng(7).random(len(rows)))
        warm_up(server, config)
        graphs0 = emb.graph_stats()
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)
        conn.request("POST", "/score/completions", body=json.dumps(body),
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        conn.close()
        assert resp.status == 200 and raw.endswith(b"data: [DONE]\n\n")
        final = json.loads(raw.split(b"data: ")[-2])
        graphs1 = emb.graph_stats()
        delta = {k: graphs1[k] - graphs0[k]
                 for k in ("captures", "replays", "eager_dispatches")}
        counters = dict(server.resilience.counters)
        assert server.chat_routes.fastpath_fallbacks == 0
    finally:
        server.close()
    return final, delta, counters


def test_a_quorum_degraded_score_request_on_the_card_matches_the_cpu(card):
    """The quorum cuts the stalled judge on the card as on the CPU: the
    same degraded final frame (the straggler's 499 entry), trained
    weights within 1e-5 relative, the prompt embed replayed from its
    graph (no capture, no eager dispatch after warmup)."""
    got, delta, counters = _quorum_score_on("cuda")
    want, _, want_counters = _quorum_score_on("cpu")
    assert counters == want_counters == {"quorum_degraded": 1}
    assert delta["captures"] == delta["eager_dispatches"] == 0
    assert delta["replays"] >= 1
    assert got["degraded"] is True
    assert [c["error"]["code"] for c in got["choices"]
            if c.get("error")] == [499]
    w_got = [float(c["weight"]) for c in got["choices"]]
    w_want = [float(c["weight"]) for c in want["choices"]]
    assert np.max(np.abs(np.subtract(w_got, w_want))
                  / np.maximum(np.abs(w_want), 1e-30)) <= 1e-5
    for obj in (got, want):
        obj["id"] = obj["created"] = None
        obj.pop("weight_data")
        for c in obj["choices"]:
            c["weight"] = c["confidence"] = None
    assert got == want


def _micro_embedder(device):
    cfg = loading.load_hf_config(FIXTURE)
    model = loading.load_params(FIXTURE, cfg, dtype=torch.float32,
                                device=device)
    return TorchEmbedder("bge-micro", model=model, config=cfg,
                         tokenizer=tokenizer.load_tokenizer(
                             loading.find_vocab(FIXTURE)),
                         max_tokens=64, device=device, dtype=torch.float32)


# -- the device tally and soft votes (archive re-scoring) -------------------


def _tally_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    v = rng.random(shape).astype(np.float32) ** 3
    v /= v.sum(axis=-1, keepdims=True)
    w = rng.uniform(0.5, 3.0, shape[:-1]).astype(np.float32)
    mask = (rng.random(shape[:-1]) > 0.25).astype(np.float32)
    return v, w, mask


@pytest.mark.parametrize("m,n", [(8, 4), (32, 8), (1, 2)])
def test_device_tally_on_the_card_matches_the_cpu(card, m, n):
    """``tally`` / ``judge_confidence`` / ``incremental_tally`` on the card
    against the CPU at 1e-6 (f32, TF32 off), an all-failed mask zeros."""
    from llm_weighted_consensus_tpu_torch.ops import consensus

    assert torch.backends.cuda.matmul.allow_tf32 is False
    v, w, mask = _tally_inputs((m, n), m + n)
    for d_mask in (None, mask, np.zeros(m, np.float32)):
        got = consensus.tally(v, w, d_mask, device=card)
        want = consensus.tally(v, w, d_mask, device="cpu")
        for g, x in zip(got, want):
            assert g.device.type == "cuda"
            assert float((g.cpu() - x).abs().max()) <= 1e-6
    _, conf = consensus.tally(v, w, mask, device=card)
    jc = consensus.judge_confidence(v, conf, device=card).cpu()
    jc_cpu = consensus.judge_confidence(v, conf.cpu(), device="cpu")
    assert float((jc - jc_cpu).abs().max()) <= 1e-6
    running = torch.zeros(n, device=card)
    for j in range(m):
        running, conf = consensus.incremental_tally(running, v[j], float(w[j]))
    _, full = consensus.tally(v, w, device="cpu")
    assert float((conf.cpu() - full).abs().max()) <= 1e-6


def test_tally_batch_and_rescore_batch_on_the_card_match_the_cpu(card):
    from llm_weighted_consensus_tpu_torch.ops import consensus
    from llm_weighted_consensus_tpu_torch.parallel.batch import rescore_batch

    v, w, mask = _tally_inputs((10000, 8, 4), 0)
    mask[3] = 0.0
    cw, conf = rescore_batch(v, w, mask, device=card)
    cw_cpu, conf_cpu = rescore_batch(v, w, mask, device="cpu")
    assert np.abs(cw - cw_cpu).max() <= 1e-6 * max(1.0, np.abs(cw_cpu).max())
    assert np.abs(conf - conf_cpu).max() <= 1e-6
    assert (conf[3] == 0).all() and np.isfinite(conf).all()
    got = consensus.judge_confidence_batch(v, conf, device=card).cpu()
    want = consensus.judge_confidence_batch(v, conf, device="cpu")
    assert float((got - want).abs().max()) <= 1e-6


def test_softmax_votes_on_the_card_match_the_cpu(card):
    """Ids of -1 and of n or more give zero rows (``jax.nn.one_hot``'s),
    as does a row without a valid alternative."""
    from llm_weighted_consensus_tpu_torch.ops import votes

    rng = np.random.default_rng(3)
    m, k, n = 512, 20, 4
    lp = np.log(rng.random((m, k)).astype(np.float32) + 1e-3)
    ids = rng.integers(-1, n + 2, (m, k))
    valid = (rng.random((m, k)) > 0.3).astype(np.float32)
    valid[2] = 0.0
    ids[3] = -1
    got = votes.softmax_votes(lp, ids, valid, n, device=card)
    want = votes.softmax_votes(lp, ids, valid, n, device="cpu")
    assert got.device.type == "cuda"
    assert float((got.cpu() - want).abs().max()) <= 1e-6
    assert not got[2].any() and not got[3].any()


# -- the learners: grad refusal, a training step and the weight fit --------


def _grad_cases(card):
    """(name, call) for every kernel wrapper, on card tensors that
    require grad (the first argument of each)."""
    from llm_weighted_consensus_tpu_torch.models import quant as q

    g = torch.Generator().manual_seed(0)

    def leaf(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g).to(card, dtype) \
            .requires_grad_(True)

    qkv = [leaf(2, 64, 4, 64) for _ in range(3)]
    bias = torch.zeros(2, 64, device=card)
    seg = torch.ones(2, 64, dtype=torch.int32, device=card)
    w = torch.randn(128, 64, generator=g)
    wq, sw = q.quantize_weight(w)
    w4, sw4 = q.quantize_weight_int4(w)
    b = torch.zeros(128, device=card)
    return [
        ("attention", lambda: attention.attention(*qkv, bias, 0.125)),
        ("segment_attention",
         lambda: attention.segment_attention(*qkv, seg, 0.125)),
        ("cosine_vote", lambda: kernels.cosine_vote(
            leaf(2, 8, 64, dtype=torch.float32))),
        ("quantize_rows", lambda: kernels.quantize_rows(leaf(4, 64), 64)),
        ("w8a8_matmul", lambda: kernels.w8a8_matmul(
            leaf(4, 64), wq.to(card), sw.to(card), b)),
        ("w4a8_matmul", lambda: kernels.w4a8_matmul(
            leaf(4, 64), w4.to(card), sw4.to(card), b)),
        ("add_layer_norm", lambda: norm_act.add_layer_norm(
            leaf(4, 64), leaf(4, 64), leaf(64), leaf(64), 1e-12)),
        ("gelu", lambda: norm_act.gelu(leaf(4, 64))),
    ]


def test_every_kernel_wrapper_refuses_an_input_that_requires_grad(card):
    """A kernel's output carries no grad_fn: under grad mode a wrapper
    raises rather than drop the gradient; under no_grad it launches."""
    for name, call in _grad_cases(card):
        wrapper = (getattr(attention, name, None)
                   or getattr(kernels, name, None) or getattr(norm_act, name))
        before = wrapper.launches
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        assert wrapper.launches == before, name
        with torch.no_grad():
            call()
        assert wrapper.launches > before, name


def _train_step(device):
    """One InfoNCE step of a trainable bge_micro on ``device`` from the
    fixture's weights, then a second: (the loss and every parameter's
    gradient of the first step, the second step's loss)."""
    from llm_weighted_consensus_tpu_torch import train
    from llm_weighted_consensus_tpu_torch.models import bert

    cfg = loading.load_hf_config(FIXTURE)
    served = loading.load_params(FIXTURE, cfg, dtype=torch.float32,
                                 device="cpu")
    state = {k: v.numpy() for k, v in served.state_dict().items()}
    model = bert.trainable(bert.BertEncoder, state, cfg, device=device)
    opt = train.make_optimizer(model, lr=1e-3)
    rng = np.random.default_rng(5)
    q = rng.integers(3, cfg.vocab_size, (8, 32)).astype(np.int64)
    p = rng.integers(3, cfg.vocab_size, (8, 32)).astype(np.int64)
    mask = np.ones((8, 32), np.int64)
    mask[3, 20:] = 0
    before = (attention.attention.launches,
              norm_act.add_layer_norm.launches, norm_act.gelu.launches)
    loss = train.contrastive_loss(model, q, mask, p, mask)
    loss.backward()
    grads = {n: t.grad.detach().cpu().numpy()
             for n, t in model.named_parameters()}
    opt.step()
    second = train.contrastive_train_step(model, opt, q, mask, p, mask)
    assert (attention.attention.launches, norm_act.add_layer_norm.launches,
            norm_act.gelu.launches) == before
    for i in range(cfg.num_layers):
        for proj in ("query", "key", "value"):
            name = f"encoder.layer.{i}.attention.self.{proj}.weight"
            assert float(np.abs(grads[name]).max()) > 0, name
    return float(loss.detach()), grads, float(second)


def test_one_bge_micro_training_step_on_the_card_matches_the_cpu(card):
    """f32, TF32 off: the first step's loss and every parameter's
    gradient on the card against the CPU's (loss 1e-5 relative,
    gradients 1e-4 of the largest gradient plus 1e-3 relative: f32
    reassociation across the two matmul libraries; a gradient that is 0
    in exact arithmetic, such as the key biases', is noise on both), and
    the second step's loss 1e-4; no kernel launches."""
    assert not torch.backends.cuda.matmul.allow_tf32
    loss, grads, second = _train_step(card)
    want_loss, want_grads, want_second = _train_step("cpu")
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    scale = max(float(np.abs(g).max()) for g in want_grads.values())
    for name, value in want_grads.items():
        np.testing.assert_allclose(grads[name], value, rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=name)
    np.testing.assert_allclose(second, want_second, atol=1e-4)


def test_fit_weights_on_the_card_matches_the_cpu(card):
    """The judge-weight fit on the card against the CPU on a
    miscalibrated panel: 1e-5 on the mean-normalized weights."""
    from llm_weighted_consensus_tpu_torch.train import fit

    rng = np.random.default_rng(9)
    records = []
    for i in range(200):
        n = int(rng.integers(2, 6))
        judges = []
        for j in range(7):
            vote = rng.random(n) ** 3
            if j == 6 and i >= 50:  # the miscalibrated judge
                vote = vote[::-1]
            judges.append({"model": f"judge-{j}",
                           "vote": (vote / vote.sum()).tolist(),
                           "weight": 1.0 + j % 3})
        records.append({"id": f"r{i}", "n_choices": n, "label": 0,
                        "judges": judges})
    dataset = fit.build_dataset(records)
    got, got_losses = fit.fit_losses(dataset, steps=300, device=card)
    want, want_losses = fit.fit_losses(dataset, steps=300, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)


# -- device faults ------------------------------------------------------------


def test_a_real_oom_classifies_transient(card):
    from llm_weighted_consensus_tpu_torch.resilience import (
        classify_dispatch_error,
    )

    free, total = torch.cuda.mem_get_info()
    with pytest.raises(torch.OutOfMemoryError) as caught:
        torch.empty(int(total) * 2, dtype=torch.uint8, device=card)
    assert classify_dispatch_error(caught.value) == "transient"


def test_a_twin_dispatch_does_not_queue_behind_a_busy_card(card):
    """A spin of ~3 s on the card's stream; the CPU twin's batcher
    dispatch completes before it ends and launches no kernel."""
    import time

    from llm_weighted_consensus_tpu_torch.serve.batcher import DeviceBatcher
    from llm_weighted_consensus_tpu_torch.serve.metrics import (
        kernel_counters,
    )

    emb, twin = _micro(card), _micro("cpu")
    twin.label_suffix = "@cpu"
    want = emb.consensus_confidence(MICRO_TEXTS)
    with DeviceBatcher(emb, window_ms=1.0, fallback_embedder=twin) as b:
        b.use_fallback(True)
        torch.cuda.synchronize()
        rate = torch.cuda.get_device_properties(card).clock_rate  # kHz
        t0 = time.perf_counter()
        torch.cuda._sleep(int(3.0 * rate * 1e3))
        before = kernel_counters()
        conf, _ = b.consensus(MICRO_TEXTS)
        answered = time.perf_counter() - t0
        busy = not torch.cuda.current_stream(card).query()
        torch.cuda.synchronize()
        spin = time.perf_counter() - t0
        assert kernel_counters() == before
        assert b.utilization()["fallback_dispatches"] == 1
    assert busy and answered < spin, (answered, spin)
    np.testing.assert_allclose(conf, want, atol=1e-5)


# -- the mesh ---------------------------------------------------------------------


def _card_mesh(dp, tp, sp=1):
    from llm_weighted_consensus_tpu_torch.parallel.mesh import make_mesh

    n = dp * tp * sp
    cards = torch.cuda.device_count()
    devices = ([torch.device("cuda", i) for i in range(n)] if cards >= n
               else [torch.device("cuda", 0)] * n)
    return make_mesh(dp=dp, tp=tp, sp=sp, devices=devices)


def _base_tokens(b, s, seed):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(1, 30000, (b, s)).astype(np.int32))
    mask = torch.ones((b, s), dtype=torch.int32)
    mask[1, s // 2:] = 0
    return ids.cuda(), mask.cuda()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_tp_forward_on_the_card_matches_one_device(card, dtype, tol):
    from llm_weighted_consensus_tpu_torch.models import bert, configs
    from llm_weighted_consensus_tpu_torch.parallel.sharding import (
        shard_bert_params,
    )

    model = bert.init_params(configs.BGE_BASE, seed=0,
                             dtype=getattr(torch, dtype), device=card)
    ids, mask = _base_tokens(4, 128, 1)
    placed = shard_bert_params(model, _card_mesh(2, 2))
    before = dict(attention.attention.routes)
    with torch.inference_mode():
        want = bert.embed(model, ids, mask)
        got = bert.embed_mesh(placed, ids, mask)
    torch.cuda.synchronize()
    assert float((got - want.to(got.device)).abs().max()) <= tol
    if dtype == "bfloat16":
        delta = attention.attention.routes["tma"] - before["tma"]
        # 12 layers: the one-device forward and two dp rows x two shards
        assert delta == 12 * (1 + 4)


def test_tp_forward_int8_on_the_card_matches_one_device(card):
    from llm_weighted_consensus_tpu_torch.models import bert, configs
    from llm_weighted_consensus_tpu_torch.parallel.sharding import (
        shard_bert_params,
    )

    model = bert.init_params(configs.BGE_BASE, seed=0, dtype=torch.float32,
                             device=card)
    quant.quantize_encoder(model, "int8")
    ids, mask = _base_tokens(4, 64, 2)
    placed = shard_bert_params(model, _card_mesh(1, 2))
    with torch.inference_mode():
        want = bert.embed(model, ids, mask)
        got = bert.embed_mesh(placed, ids, mask).to(want.device)
    # an f32 ulp of a reduced partial can flip one int8 rounding of the
    # next layer's activations: the quantized path's bars, not 1e-5
    assert float((got - want).abs().max()) <= 2e-2
    assert float(torch.nn.functional.cosine_similarity(got, want).min()) \
        >= 0.999


def test_packed_tp_forward_on_the_card_matches_one_device(card):
    from llm_weighted_consensus_tpu_torch.models import bert, configs
    from llm_weighted_consensus_tpu_torch.parallel.sharding import (
        shard_bert_params,
    )

    model = bert.init_params(configs.BGE_BASE, seed=0, dtype=torch.bfloat16,
                             device=card)
    rng = np.random.default_rng(5)
    b, l = 4, 128
    ids = torch.from_numpy(rng.integers(1, 30000, (b, l)).astype(np.int32))
    # three segments of 40 tokens and 8 pad slots a row
    seg = np.repeat([1, 2, 3, 0], [40, 40, 40, 8])[None].repeat(b, 0)
    pos = np.concatenate([np.arange(40)] * 3 + [np.zeros(8, np.int64)])
    starts = torch.tensor([[0, 40, 80]] * b, dtype=torch.int32)
    seg, pos = (torch.from_numpy(np.ascontiguousarray(x, np.int32))
                for x in (seg, pos[None].repeat(b, 0)))
    ids, seg, pos, starts = (t.to(card) for t in (ids, seg, pos, starts))
    placed = shard_bert_params(model, _card_mesh(2, 2))
    before = dict(attention.segment_attention.routes)
    with torch.inference_mode():
        want = bert.embed_packed(model, ids, seg, pos, starts)
        got = bert.embed_packed_mesh(placed, ids, seg, pos, starts)
    torch.cuda.synchronize()
    got = got.to(want.device)
    assert float((got - want).abs().max()) <= 2e-2
    assert float(torch.nn.functional.cosine_similarity(
        got.flatten(0, 1), want.flatten(0, 1)).min()) >= 0.999
    # 12 layers: the one-device forward and two dp rows x two tp shards,
    # each shard's 6 heads on the TMA route
    delta = attention.segment_attention.routes["tma"] - before["tma"]
    assert delta == 12 * (1 + 4)


def test_ring_on_the_card_matches_one_device(card):
    from llm_weighted_consensus_tpu_torch.models import bert, configs
    from llm_weighted_consensus_tpu_torch.parallel.ring import ring_embed

    cfg = configs.BertConfig(hidden_size=256, num_layers=2, num_heads=4,
                             intermediate_size=1024,
                             max_position_embeddings=2048)
    model = bert.init_params(cfg, seed=0, dtype=torch.float32, device=card)
    ids, mask = _base_tokens(2, 2048, 3)
    with torch.inference_mode():
        want = bert.embed(model, ids, mask)
        got = ring_embed(model, ids, mask, _card_mesh(1, 1, sp=4))
    assert float((got - want.to(got.device)).abs().max()) <= 1e-4


def test_reward_model_tp_on_the_card_matches_one_device(card):
    from llm_weighted_consensus_tpu_torch.models import configs, deberta
    from llm_weighted_consensus_tpu_torch.parallel.sharding import (
        deberta_partition_rules,
        shard_by_rules,
    )

    cfg = configs.DEBERTA_V3_BASE
    model = deberta.init_params(cfg, seed=0, dtype=torch.float32,
                                device=card)
    ids, mask = _base_tokens(4, 64, 4)
    ids = ids % cfg.vocab_size
    placed = shard_by_rules(model, _card_mesh(1, 2),
                            deberta_partition_rules())
    with torch.inference_mode():
        want = deberta.reward(model, ids, mask)
        got = deberta.reward_mesh(placed, ids, mask)
    torch.testing.assert_close(got, want.to(got.device), atol=1e-4,
                               rtol=1e-4)


def test_the_fault_ladder_walks_and_recovers_on_the_card(card):
    """test-tiny on a 4x2 mesh over the card: the ladder warmed (one CUDA
    graph per bucket per rung), scripted persistent faults walk 4x2 ->
    2x2 -> 1x2 through the batcher, the ladder is then spent, and the
    probe upsizes; every answer within 2e-4 of the one-device embedder
    (f32), no capture and no eager dispatch after the warmup, every
    attention launch on its route."""
    from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
    from llm_weighted_consensus_tpu_torch.ops import attention
    from llm_weighted_consensus_tpu_torch.parallel.sharding import (
        shard_embedder_mesh,
    )
    from llm_weighted_consensus_tpu_torch.resilience import (
        DeviceFaultPlan,
        MeshFaultManager,
    )
    from llm_weighted_consensus_tpu_torch.serve.batcher import DeviceBatcher

    texts = [f"candidate number {i % 3} under fault" for i in range(8)]
    one = TorchEmbedder("test-tiny", max_tokens=32, seed=3,
                        dtype=torch.float32, device=card)
    want = one.consensus_confidence(texts)
    emb = TorchEmbedder("test-tiny", max_tokens=32, seed=3,
                        dtype=torch.float32, device=card)
    shard_embedder_mesh(emb, _card_mesh(4, 2))
    mgr = MeshFaultManager(emb, shape=(4, 2))
    s = emb.tokenize(texts)[0].shape[1]
    mgr.warm_ladder([(8, s)])
    assert emb.aot_mesh_shapes() == [(4, 2), (2, 2), (1, 2)]
    stats0 = emb.graph_stats()
    scales = []
    mgr.rescale_hooks.append(scales.append)
    shapes = []
    with DeviceBatcher(emb, window_ms=5.0, meshfault=mgr) as batcher:
        for step in range(3):
            if step:
                mgr.fault_plan = DeviceFaultPlan.scripted(["persistent"])
            conf, _ = batcher.consensus(texts)
            mgr.fault_plan = None
            np.testing.assert_allclose(conf, want, atol=2e-4)
            shapes.append(mgr.current_shape)
        assert mgr.downsize() is False
        assert mgr.try_recover() is True
        conf, _ = batcher.consensus(texts)
        np.testing.assert_allclose(conf, want, atol=2e-4)
    assert shapes == [(4, 2), (2, 2), (1, 2)]
    assert mgr.current_shape == (4, 2) and scales == [0.5, 0.25, 1.0]
    snap = mgr.snapshot()
    assert (snap["downsizes"], snap["upsizes"], snap["epoch"]) == (2, 1, 3)
    stats = emb.graph_stats()
    assert stats["captures"] == stats0["captures"]
    assert stats["eager_dispatches"] == stats0["eager_dispatches"] == 0
    assert stats["replays"] > stats0["replays"]
    assert sum(attention.attention.routes.values()) == (
        attention.attention.launches)


def test_the_infonce_step_on_a_2x2_mesh_matches_one_device(card):
    """One f32 InfoNCE step of bge-base on a 2x2 mesh over the card
    against the one-device step: the loss 1e-4 relative, every master
    gradient within 1e-4 of the largest gradient plus 1e-3 relative, and
    every parameter after the step within 1e-4 of the largest parameter;
    no kernel launched."""
    from llm_weighted_consensus_tpu_torch import train
    from llm_weighted_consensus_tpu_torch.models import bert, configs
    from llm_weighted_consensus_tpu_torch.ops import launches

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.PRESETS["bge-base-en"]
    state = bert.random_state(bert.BertEncoder, cfg, 0)
    rng = np.random.default_rng(7)
    batch = [rng.integers(3, cfg.vocab_size, (8, 32)), np.ones((8, 32)),
             rng.integers(3, cfg.vocab_size, (8, 32)), np.ones((8, 32))]
    batch[1][7, 16:] = 0
    batch = [np.asarray(a, np.int64) for a in batch]
    one = bert.trainable(bert.BertEncoder, state, cfg, device=card)
    # lr 1e-5: a gradient that is 0 in exact arithmetic moves its
    # parameter by up to lr on rounding noise, differently on each side
    one_loss = train.contrastive_train_step(
        one, train.make_optimizer(one, lr=1e-5), *batch)
    model = bert.trainable(bert.BertEncoder, state, cfg, device=card)
    with launches.recording() as noted:
        loss = train.contrastive_train_step(
            model, train.make_optimizer(model, lr=1e-5), *batch,
            mesh=_card_mesh(2, 2))
    assert not noted
    np.testing.assert_allclose(float(loss), float(one_loss), rtol=1e-4)
    mine = dict(model.named_parameters())
    g_scale = max(float(p.grad.abs().max()) for p in one.parameters())
    scale = max(float(p.detach().abs().max()) for p in one.parameters())
    for name, p in one.named_parameters():
        assert mine[name].grad is not None, name
        np.testing.assert_allclose(
            mine[name].grad.cpu().numpy(), p.grad.cpu().numpy(), rtol=1e-3,
            atol=1e-4 * g_scale, err_msg=name)
        np.testing.assert_allclose(
            mine[name].detach().cpu().numpy(), p.detach().cpu().numpy(),
            rtol=0, atol=1e-4 * scale, err_msg=name)
