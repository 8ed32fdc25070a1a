"""The port's SentencePiece tokenizer (``models/spm.py``) against the JAX
package's, token for token.

The same protos and piece lists go through both packages'
``parse_model_proto`` and ``UnigramTokenizer``: the ``tests/test_spm.py``
corpora and vocabularies, seeded random vocabularies, both id schemes,
truncation, the fuzzed and truncated protos each refuses, and the
tokenizer discovery beside a checkpoint (``find_vocab``, which now probes
``spiece.model``).  Every comparison is exact.
"""

import numpy as np
import pytest

from llm_weighted_consensus_tpu.models import loading as jax_loading
from llm_weighted_consensus_tpu.models import spm as jax_spm
from llm_weighted_consensus_tpu_torch.models import loading, spm, tokenizer
from test_spm import PARITY_TEXTS, XLMR_PIECES, serialize_proto

DEBERTA_PIECES = [
    ("[PAD]", 0.0, spm.CONTROL),
    ("[CLS]", 0.0, spm.CONTROL),
    ("[SEP]", 0.0, spm.CONTROL),
    ("[UNK]", 0.0, spm.UNKNOWN),
] + [p for p in XLMR_PIECES if p[2] == spm.NORMAL]

TEXTS = PARITY_TEXTS + [
    "",
    "hello " * 60,
    "ｈｅｌｌｏ fullwidth ① wörld",
    "tabs\tand\nnewlines\r\nhello",
    "ctrl\x00chars\x1cjoin",
    "<s> ab </s> <unk>",
]


def _random_pieces(seed: int):
    rng = np.random.default_rng(seed)
    alphabet = "abcde"
    pieces = [("<unk>", 0.0, spm.UNKNOWN), ("<s>", 0.0, spm.CONTROL)]
    seen = {p for p, _, _ in pieces}
    for length in (1, 2, 3, 4):
        for _ in range(40):
            piece = "".join(rng.choice(list(alphabet), size=length))
            if rng.random() < 0.3:
                piece = spm.SPACE + piece
            if piece not in seen:
                seen.add(piece)
                score = float(np.float32(-rng.uniform(1, 12)))
                pieces.append((piece, score, spm.NORMAL))
    return pieces


def _random_texts(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    return [
        "".join(rng.choice(list("abcdexyz  "), size=int(rng.integers(0, 60))))
        for _ in range(n)
    ]


def test_module_constants_match_the_reference():
    assert spm.SPM_FILES == jax_spm.SPM_FILES
    assert "spiece.model" in spm.SPM_FILES
    assert (spm.NORMAL, spm.UNKNOWN, spm.CONTROL, spm.USER_DEFINED,
            spm.UNUSED, spm.BYTE, spm.SPACE) == (
        jax_spm.NORMAL, jax_spm.UNKNOWN, jax_spm.CONTROL,
        jax_spm.USER_DEFINED, jax_spm.UNUSED, jax_spm.BYTE, jax_spm.SPACE)
    for name in ("bge-m3", "deberta-v3-base", "deberta-test-tiny", "x"):
        assert spm.scheme_for_model(name) == jax_spm.scheme_for_model(name)


@pytest.mark.parametrize("which", ["xlmr", "deberta", "random", "trailer"])
def test_parse_model_proto_matches_jax(which):
    pieces = {"xlmr": XLMR_PIECES, "deberta": DEBERTA_PIECES,
              "random": _random_pieces(3), "trailer": XLMR_PIECES}[which]
    trailer = b"\x12\x03abc\x1a\x02xy" if which == "trailer" else b""
    data = serialize_proto(pieces, trailer=trailer)
    got = spm.parse_model_proto(data)
    assert got == jax_spm.parse_model_proto(data) == pieces


def _outcome(fn, data):
    try:
        return ("ok", fn(data))
    except (ValueError, UnicodeDecodeError) as err:
        return ("raised", type(err))


def test_fuzzed_and_truncated_protos_are_refused_as_in_jax():
    """Random and bit-flipped bytes parse to the same pieces or raise the
    same clean error in both; every truncation raises."""
    rng = np.random.default_rng(13)
    base = serialize_proto(XLMR_PIECES)
    for i in range(300):
        if i % 3 == 0:
            data = bytes(rng.integers(0, 256, size=int(rng.integers(0, 200)),
                                      dtype=np.uint8))
        else:
            buf = bytearray(base)
            for _ in range(int(rng.integers(1, 8))):
                buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
            data = bytes(buf)
        assert _outcome(spm.parse_model_proto, data) == _outcome(
            jax_spm.parse_model_proto, data), data
    for cut in (len(base) - 1, len(base) // 2, 3, 1):
        with pytest.raises(ValueError):
            spm.parse_model_proto(base[:cut])
        with pytest.raises(ValueError):
            jax_spm.parse_model_proto(base[:cut])
    with pytest.raises(ValueError, match="no pieces"):
        spm.parse_model_proto(b"\x12\x00")


@pytest.mark.parametrize("scheme,pieces", [
    ("xlmr", XLMR_PIECES), ("deberta", DEBERTA_PIECES),
    ("xlmr", "random"),
])
@pytest.mark.parametrize("max_length", [8, 16, 64])
def test_unigram_encode_matches_jax(scheme, pieces, max_length):
    if pieces == "random":
        pieces = _random_pieces(7)
        texts = _random_texts(8)
    else:
        texts = TEXTS
    ours = spm.UnigramTokenizer(pieces, scheme=scheme, use_native=False)
    ref = jax_spm.UnigramTokenizer(pieces, scheme=scheme, use_native=False)
    for attr in ("cls_id", "sep_id", "pad_id", "unk_id", "vocab_size"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    ids, mask = ours.encode_batch(texts, max_length)
    want_ids, want_mask = ref.encode_batch(texts, max_length)
    assert ids.tolist() == want_ids.tolist()
    assert mask.tolist() == want_mask.tolist()
    for text in texts:
        assert ours.tokenize_text(text) == ref.tokenize_text(text), text


def test_truncation_keeps_sep_and_pads_with_the_scheme_pad():
    for scheme, pieces in (("xlmr", XLMR_PIECES), ("deberta", DEBERTA_PIECES)):
        tok = spm.UnigramTokenizer(pieces, scheme=scheme, use_native=False)
        ids, mask = tok.encode_batch(["hello world " * 50, "ab"], 16)
        assert mask[0].sum() == 16 and ids[0, -1] == tok.sep_id
        assert ids[1, mask[1].sum() - 1] == tok.sep_id
        assert (ids[1][mask[1] == 0] == tok.pad_id).all()


def test_normalize_matches_jax():
    for text in TEXTS + ["a\x00b\tc", "①②", "ﬁ ligature", "　x"]:
        assert spm.normalize(text) == jax_spm.normalize(text)


def test_load_tokenizer_reads_the_model_file_with_its_scheme(tmp_path):
    path = tmp_path / "spm.model"
    path.write_bytes(serialize_proto(DEBERTA_PIECES))
    tok = tokenizer.load_tokenizer(str(path), scheme="deberta")
    assert isinstance(tok, spm.UnigramTokenizer) and tok.scheme == "deberta"
    ref = jax_spm.UnigramTokenizer.from_model_file(str(path), "deberta")
    assert tok.encode_batch(TEXTS, 24)[0].tolist() == (
        ref.encode_batch(TEXTS, 24)[0].tolist())
    # the default scheme is xlmr, as the reference's
    assert tokenizer.load_tokenizer(str(path)).scheme == "xlmr"


@pytest.mark.parametrize("files,want", [
    (("spiece.model",), "spiece.model"),
    (("spm.model", "spiece.model"), "spm.model"),
    (("sentencepiece.bpe.model", "spm.model"), "sentencepiece.bpe.model"),
    (("vocab.txt", "spiece.model"), "vocab.txt"),
    ((), None),
])
def test_find_vocab_probes_every_spm_file_as_jax_does(tmp_path, files, want):
    """A snapshot that ships only ``spiece.model`` finds it (the port's
    list once missed it); the order of preference is the reference's."""
    (tmp_path / "model.safetensors").write_bytes(b"")
    for name in files:
        (tmp_path / name).write_bytes(serialize_proto(XLMR_PIECES))
    got = loading.find_vocab(str(tmp_path))
    assert got == jax_loading.find_vocab(str(tmp_path))
    assert got == (str(tmp_path / want) if want else None)
    weights = str(tmp_path / "model.safetensors")
    assert loading.find_vocab(weights) == jax_loading.find_vocab(weights)
