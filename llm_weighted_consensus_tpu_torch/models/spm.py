"""SentencePiece unigram-LM tokenization (host side, offline).

Counterpart of ``llm_weighted_consensus_tpu/models/spm.py``, kept as this
package's own copy.  XLM-R (bge-m3) and DeBERTa-v3 checkpoints ship
``sentencepiece.bpe.model`` / ``spm.model`` / ``spiece.model`` protos in
place of a WordPiece ``vocab.txt``.  Two pieces:

* ``parse_model_proto``: a minimal protobuf wire-format reader for the
  SentencePiece ``ModelProto`` (field 1: repeated ``SentencePiece {
  piece, score, type }``), with bounds checks, so a truncated file fails
  loudly instead of yielding a shorter vocabulary;
* ``UnigramTokenizer``: Viterbi (max-sum) segmentation over the piece
  scores with the semantics of HF ``tokenizers``' ``Unigram`` model:
  metaspace pre-tokenization (whitespace split, every chunk prefixed with
  ``▁``), per-chunk Viterbi, unknown characters scored at ``min_score -
  10`` and consecutive unknowns fused.  Pure-ASCII texts take the native
  C++ Viterbi (``native/unigram.cpp``) when the library loads, id for id
  the Python path's.

Id schemes (spm piece id -> model input id):

* ``xlmr``: the fairseq convention of XLM-RoBERTa / bge-m3:
  ``<s>=0, <pad>=1, </s>=2, <unk>=3``, every spm id shifted by +1;
  sequences are ``<s> ... </s>``;
* ``deberta``: DeBERTa-v2/v3, spm ids used directly (the proto reserves
  ``[PAD]=0, [CLS]=1, [SEP]=2, [UNK]=3``); sequences are
  ``[CLS] ... [SEP]``.

Normalization is NFKC plus control-character removal, the reference's
approximation of sentencepiece's ``nmt_nfkc`` without the precompiled
charsmap.
"""

from __future__ import annotations

import struct
import unicodedata
from typing import Dict, List, Tuple

from .tokenizer import BaseTokenizer

# SentencePiece.Type values (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

SPACE = "▁"  # ▁ metaspace marker
_UNK_PENALTY = 10.0  # sentencepiece kUnkPenalty; tokenizers uses the same


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _check_bounds(data: bytes, pos: int, size: int) -> None:
    if pos + size > len(data):
        raise ValueError(
            "truncated ModelProto: field of "
            f"{size} bytes at offset {pos} runs past end "
            f"({len(data)} bytes) — partial download?"
        )


def _skip_field(data: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(data, pos)
        return pos
    if wire_type == 1:
        _check_bounds(data, pos, 8)
        return pos + 8
    if wire_type == 2:
        size, pos = _read_varint(data, pos)
        _check_bounds(data, pos, size)
        return pos + size
    if wire_type == 5:
        _check_bounds(data, pos, 4)
        return pos + 4
    raise ValueError(f"unsupported wire type {wire_type}")


def _parse_piece(data: bytes) -> Tuple[str, float, int]:
    """One ``SentencePiece`` message: piece(1)=string, score(2)=float,
    type(3)=enum (default NORMAL)."""
    piece, score, ptype = "", 0.0, NORMAL
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 2:
            size, pos = _read_varint(data, pos)
            _check_bounds(data, pos, size)
            piece = data[pos : pos + size].decode("utf-8")
            pos += size
        elif field == 2 and wire == 5:
            _check_bounds(data, pos, 4)
            (score,) = struct.unpack("<f", data[pos : pos + 4])
            pos += 4
        elif field == 3 and wire == 0:
            ptype, pos = _read_varint(data, pos)
        else:
            pos = _skip_field(data, pos, wire)
    return piece, score, ptype


def parse_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    """``ModelProto`` bytes -> ordered [(piece, score, type)].

    Only field 1 (the pieces) is decoded; trainer/normalizer specs are
    skipped by wire type.  Piece order IS the spm id space.
    """
    pieces: List[Tuple[str, float, int]] = []
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 2:
            size, pos = _read_varint(data, pos)
            _check_bounds(data, pos, size)
            pieces.append(_parse_piece(data[pos : pos + size]))
            pos += size
        else:
            pos = _skip_field(data, pos, wire)
    if not pieces:
        raise ValueError("no pieces found: not a SentencePiece ModelProto?")
    return pieces


def normalize(text: str) -> str:
    """NFKC + control-character removal (approximation of nmt_nfkc; see
    module doc)."""
    text = unicodedata.normalize("NFKC", text)
    return "".join(
        " " if ch in "\t\n\r\v\f" else ch
        for ch in text
        if unicodedata.category(ch) != "Cc" or ch in "\t\n\r\v\f"
    )


class _Viterbi:
    """Max-sum segmentation over a piece->score table."""

    def __init__(self, scores: Dict[str, float], unk_score: float):
        self.scores = scores
        self.unk_score = unk_score
        self.max_len = max((len(p) for p in scores), default=1)

    def segment(self, chunk: str) -> List[Tuple[str, bool]]:
        """chunk -> [(token_text, known)]; unknown chars surface as their
        raw text with known=False, consecutive unknowns fused into one
        token (tokenizers ``fuse_unk=True`` semantics)."""
        n = len(chunk)
        NEG = float("-inf")
        best_score = [NEG] * (n + 1)
        best_prev = [0] * (n + 1)
        best_known = [False] * (n + 1)
        best_score[0] = 0.0
        for i in range(n):
            si = best_score[i]
            if si == NEG:
                continue
            # known pieces starting at i
            hi = min(n, i + self.max_len)
            for j in range(i + 1, hi + 1):
                score = self.scores.get(chunk[i:j])
                if score is not None and si + score > best_score[j]:
                    best_score[j] = si + score
                    best_prev[j] = i
                    best_known[j] = True
            # single unknown char fallback
            j = i + 1
            if si + self.unk_score > best_score[j]:
                best_score[j] = si + self.unk_score
                best_prev[j] = i
                best_known[j] = False
        spans: List[Tuple[int, int, bool]] = []
        j = n
        while j > 0:
            i = best_prev[j]
            spans.append((i, j, best_known[j]))
            j = i
        spans.reverse()
        out: List[Tuple[str, bool]] = []
        for i, j, known in spans:
            if not known and out and not out[-1][1]:
                prev_text, _ = out[-1]
                out[-1] = (prev_text + chunk[i:j], False)
            else:
                out.append((chunk[i:j], known))
        return out


class UnigramTokenizer(BaseTokenizer):
    """Unigram-LM tokenizer over a SentencePiece vocabulary.

    ``scheme`` picks the piece-id -> input-id mapping ("xlmr" or
    "deberta", module doc).  Construct from a proto via
    ``from_model_file`` / ``from_model_bytes``, or directly from
    [(piece, score, type)] rows (tests).
    """

    def __init__(
        self,
        pieces: List[Tuple[str, float, int]],
        scheme: str = "xlmr",
        use_native: bool = True,
    ):
        if scheme not in ("xlmr", "deberta"):
            raise ValueError(
                f"unknown spm scheme {scheme!r}: expected 'xlmr' or 'deberta'"
            )
        self.scheme = scheme
        self.pieces = pieces
        by_name = {piece: i for i, (piece, _, _) in enumerate(pieces)}
        scores = {
            piece: score
            for piece, score, ptype in pieces
            if ptype in (NORMAL, USER_DEFINED)
        }
        min_score = min(scores.values(), default=0.0)
        self._viterbi = _Viterbi(scores, min_score - _UNK_PENALTY)
        self._spm_id = by_name

        unk_spm = next(
            (i for i, (_, _, t) in enumerate(pieces) if t == UNKNOWN), 0
        )
        if scheme == "xlmr":
            # fairseq: <s>=0 <pad>=1 </s>=2 <unk>=3, pieces shifted +1,
            # <mask> appended last
            self._offset = 1
            self.cls_id = 0
            self.pad_id = 1
            self.sep_id = 2
            self.unk_id = 3
            self._unk_spm = unk_spm
            self.vocab_size = len(pieces) + self._offset + 1  # +<mask>
        else:
            # deberta: proto reserves [PAD]=0 [CLS]=1 [SEP]=2 [UNK]=3
            self._offset = 0
            self.pad_id = by_name.get("[PAD]", 0)
            self.cls_id = by_name.get("[CLS]", 1)
            self.sep_id = by_name.get("[SEP]", 2)
            self.unk_id = by_name.get("[UNK]", unk_spm)
            self._unk_spm = self.unk_id
            self.vocab_size = len(pieces)
        # C++ Viterbi fast path for pure-ASCII texts (native/unigram.cpp;
        # NFKC is the identity there) — parity-tested, Python fallback
        # owns all real Unicode
        self._native = _native_unigram(self) if use_native else None

    @classmethod
    def from_model_bytes(
        cls, data: bytes, scheme: str = "xlmr"
    ) -> "UnigramTokenizer":
        return cls(parse_model_proto(data), scheme)

    @classmethod
    def from_model_file(
        cls, path: str, scheme: str = "xlmr"
    ) -> "UnigramTokenizer":
        with open(path, "rb") as f:
            return cls.from_model_bytes(f.read(), scheme)

    # -- segmentation --------------------------------------------------------

    def tokenize_text(self, text: str) -> List[str]:
        """text -> token strings (no specials); unknown runs surface as
        their raw text (id = unk), matching ``tokenizers`` ``.tokens``."""
        return [
            token
            for word in normalize(text).split()
            for token, _ in self._viterbi.segment(SPACE + word)
        ]

    def _token_to_id(self, token: str, known: bool) -> int:
        if not known:
            return self.unk_id
        spm_id = self._spm_id.get(token)
        if spm_id is None or spm_id == self._unk_spm:
            return self.unk_id
        return spm_id + self._offset

    def _encode(self, text: str, max_length: int):
        if self._native is not None and text.isascii():
            out = self._native.encode(text, max_length)
            if out is not None:
                return out
        ids = [self.cls_id]
        done = False
        for word in normalize(text).split():
            if done:
                break
            for token, known in self._viterbi.segment(SPACE + word):
                ids.append(self._token_to_id(token, known))
                if len(ids) >= max_length - 1:
                    done = True
                    break
        ids = ids[: max_length - 1]
        ids.append(self.sep_id)
        return ids


def _native_unigram(tok: "UnigramTokenizer"):
    """A native bridge for this tokenizer, or None when the native
    library is unavailable or rejects the blob.  Blob: header "cls sep
    unk offset unk_spm", then one "score\\tmatchable\\tpiece" line per
    piece in spm-id order (see ``native/unigram.cpp``).

    Matchability mirrors the Python Viterbi exactly: NORMAL and
    USER_DEFINED pieces, including the one at the unk index (its matches
    remap to unk on emit, which is what ``unk_spm`` in the header is
    for).  Pieces holding framing bytes (newline, tab) can never match an
    ASCII chunk (whitespace splits before segmentation), so they are
    written unmatchable with an empty text field: their raw bytes would
    break the line framing and shift every later piece id."""
    from ..utils.native import load_library
    from .tokenizer import NativeTokenizerBridge

    lib = load_library()
    if lib is None:
        return None
    lines = [
        f"{tok.cls_id} {tok.sep_id} {tok.unk_id} {tok._offset} "
        f"{tok._unk_spm}"
    ]
    for piece, score, ptype in tok.pieces:
        matchable = ptype in (NORMAL, USER_DEFINED) and not any(
            c in piece for c in "\n\r\t"
        )
        lines.append(
            f"{score!r}\t{1 if matchable else 0}\t"
            f"{piece if matchable else ''}"
        )
    blob = ("\n".join(lines) + "\n").encode("utf-8")
    try:
        return NativeTokenizerBridge(lib, "spm", blob)
    except ValueError:  # a score the native parser cannot read
        return None


# filenames probed (in order) next to checkpoint weights
SPM_FILES = ("sentencepiece.bpe.model", "spm.model", "spiece.model")


def scheme_for_model(model_name: str) -> str:
    """Preset name -> id scheme ('deberta' for the RM family, else
    'xlmr')."""
    return "deberta" if "deberta" in model_name else "xlmr"
