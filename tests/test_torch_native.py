"""The port's native tokenizer paths against the JAX package's Python
tokenizers, token for token.

The port builds ``native/*.cpp`` into ``build/native/liblwc_native.so``
(``utils/native.py``) and sends pure-ASCII texts through the C++
WordPiece and unigram tokenizers.  Each case runs the port's native path
and the reference's Python path (``use_native=False``) on the same
vocabulary and texts: the reference corpora of ``tests/test_native.py``,
seeded random ASCII, non-ASCII texts (the Python path of both), control
characters, concurrent threads, and ``LWC_NATIVE=0``.
"""

import os
import random
import string
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest

from llm_weighted_consensus_tpu.models import spm as jax_spm
from llm_weighted_consensus_tpu.models import tokenizer as jax_tokenizer
from llm_weighted_consensus_tpu_torch.models import spm, tokenizer
from llm_weighted_consensus_tpu_torch.utils import native
from test_native import SPM_TEXTS, WP_TEXTS, WP_VOCAB
from test_spm import XLMR_PIECES

FIXTURE_VOCAB = os.path.join(
    os.path.dirname(__file__), "fixtures", "bge_micro", "vocab.txt"
)
DEBERTA_PIECES = [
    ("[PAD]", 0.0, spm.CONTROL),
    ("[CLS]", 0.0, spm.CONTROL),
    ("[SEP]", 0.0, spm.CONTROL),
    ("[UNK]", 0.0, spm.UNKNOWN),
] + [p for p in XLMR_PIECES if p[2] == spm.NORMAL]


@pytest.fixture(scope="module")
def lib():
    lib = native.load_library()
    assert lib is not None, "the native library did not build (needs g++)"
    return lib


def _vocab():
    return {token: i for i, token in enumerate(dict.fromkeys(WP_VOCAB))}


def _wp_pair(vocab=None):
    vocab = vocab or _vocab()
    ours = tokenizer.WordPieceTokenizer(vocab)
    ref = jax_tokenizer.WordPieceTokenizer(vocab, use_native=False)
    assert ours._native is not None
    return ours, ref


def _spm_pair(pieces, scheme):
    ours = spm.UnigramTokenizer(pieces, scheme=scheme)
    ref = jax_spm.UnigramTokenizer(pieces, scheme=scheme, use_native=False)
    assert ours._native is not None
    return ours, ref


def _same_ids(ours, ref, texts, max_length):
    got, got_mask = ours.encode_batch(texts, max_length)
    want, want_mask = ref.encode_batch(texts, max_length)
    assert got.tolist() == want.tolist()
    assert got_mask.tolist() == want_mask.tolist()


def _random_ascii(seed, n, chars, longest):
    rng = random.Random(seed)
    return [
        "".join(rng.choice(chars) for _ in range(rng.randint(0, longest)))
        for _ in range(n)
    ]


def test_library_builds_under_build_not_native(lib):
    assert native.NATIVE_SO == native.REPO_DIR / "build" / "native" / (
        "liblwc_native.so")
    assert os.path.samefile(lib._name, native.NATIVE_SO)
    assert native.NATIVE_SO.parent != native.NATIVE_DIR
    # every source is older than the library it was built into
    assert native.sources() and not native._stale(native.sources())


def test_native_dir_is_not_written(lib, tmp_path, monkeypatch):
    """A rebuild writes build/native only."""
    before = sorted(os.listdir(native.NATIVE_DIR))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "NATIVE_SO", tmp_path / "native" / "lib.so")
    built = native.build()
    assert built.exists() and built.parent == tmp_path / "native"
    assert sorted(os.listdir(native.NATIVE_DIR)) == before


@pytest.mark.parametrize("max_length", [8, 16, 64])
def test_native_wordpiece_matches_jax_python(lib, max_length):
    _same_ids(*_wp_pair(), WP_TEXTS, max_length)


def test_native_wordpiece_random_ascii_matches_jax(lib):
    texts = _random_ascii(3, 300, string.ascii_letters + string.punctuation
                          + string.digits + " \t\n", 90)
    _same_ids(*_wp_pair(), texts, 32)


def test_native_wordpiece_on_the_bge_micro_vocab(lib):
    vocab = tokenizer.WordPieceTokenizer.from_vocab_file(FIXTURE_VOCAB).vocab
    texts = WP_TEXTS + _random_ascii(4, 100, string.printable, 200)
    _same_ids(*_wp_pair(vocab), texts, 128)


def test_native_wordpiece_non_ascii_and_controls(lib):
    texts = ["café naïve voilà", "Ünïcödé everywhere", "mixed ascii café",
             "a\x1cb", "the\x1dquick", "fox\x1e\x1fdog", "a\x0bb\x0cc",
             "nul\x00byte"]
    _same_ids(*_wp_pair(), texts, 16)


@pytest.mark.parametrize("scheme", ["xlmr", "deberta"])
@pytest.mark.parametrize("max_length", [8, 24, 64])
def test_native_unigram_matches_jax_python(lib, scheme, max_length):
    pieces = XLMR_PIECES if scheme == "xlmr" else DEBERTA_PIECES
    _same_ids(*_spm_pair(pieces, scheme), SPM_TEXTS, max_length)


def test_native_unigram_random_ascii_matches_jax(lib):
    texts = _random_ascii(5, 300, "abchelowrdtknizs " + string.punctuation
                          + "\t", 120)
    _same_ids(*_spm_pair(XLMR_PIECES, "xlmr"), texts, 48)


def test_native_unigram_non_ascii_falls_back_like_jax(lib):
    texts = ["héllo wörld", "ｈｅｌｌｏ fullwidth", "mixed ascii héllo"]
    _same_ids(*_spm_pair(XLMR_PIECES, "xlmr"), texts, 16)


@pytest.mark.parametrize("pieces", ["newline", "normal_at_unk"])
def test_native_unigram_blob_edge_cases(lib, pieces):
    """A piece holding a newline must not shift later ids; a NORMAL piece
    at the unk index still segments (and maps to unk)."""
    pieces = {
        "newline": [("<unk>", 0.0, spm.UNKNOWN), ("\n", -2.5, spm.NORMAL),
                    ("▁hello", -1.0, spm.NORMAL), ("▁world", -1.2, spm.NORMAL)],
        "normal_at_unk": [("▁ab", -1.0, spm.NORMAL), ("▁a", -5.0, spm.NORMAL),
                          ("b", -5.0, spm.NORMAL)],
    }[pieces]
    _same_ids(*_spm_pair(pieces, "xlmr"), ["hello world", "ab", "a b ab"], 8)


@pytest.mark.parametrize("kind", ["wordpiece", "unigram"])
def test_native_paths_are_thread_safe(lib, kind):
    """The native encode runs without the GIL and the server tokenizes on
    concurrent handler threads: each call has its own output buffer."""
    import sys

    if kind == "wordpiece":
        ours, ref = _wp_pair()
        words = ["the", "quick", "brown", "fox", "unbelievable", "dog!"]
    else:
        ours, ref = _spm_pair(XLMR_PIECES, "xlmr")
        words = ["hello", "world", "ab", "abc", "tokens", "zzq"]
    rng = random.Random(9)
    texts = [" ".join(rng.choice(words) for _ in range(rng.randint(1, 60)))
             for _ in range(400)]
    lengths = [8 + (i % 5) * 24 for i in range(len(texts))]
    expected = [ref._encode(t, n) for t, n in zip(texts, lengths)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            got = list(pool.map(lambda tn: ours._encode(*tn),
                                zip(texts, lengths), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert got == expected


def test_lwc_native_0_keeps_the_python_path(lib, monkeypatch):
    monkeypatch.setenv("LWC_NATIVE", "0")
    assert native.load_library() is None
    wp = tokenizer.WordPieceTokenizer(_vocab())
    uni = spm.UnigramTokenizer(XLMR_PIECES, scheme="xlmr")
    assert wp._native is None and uni._native is None
    _same_ids(wp, jax_tokenizer.WordPieceTokenizer(_vocab(), use_native=False),
              WP_TEXTS, 16)
    _same_ids(uni, jax_spm.UnigramTokenizer(XLMR_PIECES, "xlmr",
                                            use_native=False), SPM_TEXTS, 16)
    monkeypatch.setenv("LWC_NATIVE", "1")
    assert native.load_library() is lib


def test_a_custom_word_cap_keeps_the_python_path(lib):
    wp = tokenizer.WordPieceTokenizer(_vocab(), max_chars_per_word=20)
    assert wp._native is None
    ref = jax_tokenizer.WordPieceTokenizer(_vocab(), max_chars_per_word=20,
                                           use_native=False)
    _same_ids(wp, ref, WP_TEXTS, 32)


def test_library_loads_once_across_threads(lib):
    seen = []
    threads = [threading.Thread(target=lambda: seen.append(
        native.load_library())) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(seen) == 8 and all(x is lib for x in seen)
