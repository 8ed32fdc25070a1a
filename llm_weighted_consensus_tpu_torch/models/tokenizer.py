"""Host-side tokenization for the port's encoders.

Counterpart of ``llm_weighted_consensus_tpu/models/tokenizer.py``, kept
as this package's own copy.  Tokenization stays on the host; the device
sees only int arrays.  Two implementations behind one interface:

* ``WordPieceTokenizer`` — the real BERT algorithm (basic whitespace +
  punctuation split, greedy longest-match with ``##`` continuations) given
  a ``vocab.txt``; loads bge vocabularies from local files (no network),
  with the native C++ fast path for ASCII texts (``native/wordpiece.cpp``
  through ``NativeTokenizerBridge``);
* ``HashTokenizer``     — deterministic hashing into a fixed vocab so the
  whole pipeline (tests, CPU mesh, benches without downloaded assets) runs
  with identical shapes and padding behavior.

Both pad/truncate to a fixed ``max_length`` and return numpy int32 arrays
(ids, attention_mask).  SentencePiece protos tokenize through
``spm.UnigramTokenizer`` (``load_tokenizer`` picks it by file name).
"""

from __future__ import annotations

import unicodedata
from typing import Iterable, Optional

import numpy as np

CLS, SEP, PAD, UNK = "[CLS]", "[SEP]", "[PAD]", "[UNK]"


class BaseTokenizer:
    pad_id: int = 0

    def encode_batch(self, texts: Iterable[str], max_length: int = 512):
        rows = [self._encode(t, max_length) for t in texts]
        n = len(rows)
        ids = np.full((n, max_length), self.pad_id, dtype=np.int32)
        mask = np.zeros((n, max_length), dtype=np.int32)
        for i, row in enumerate(rows):
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask

    def _encode(self, text: str, max_length: int):
        raise NotImplementedError


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (
        33 <= cp <= 47
        or 58 <= cp <= 64
        or 91 <= cp <= 96
        or 123 <= cp <= 126
    ):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str) -> list:
    """Lowercase, strip accents, split on whitespace and punctuation."""
    text = unicodedata.normalize("NFD", text.lower())
    out = []
    word = []
    for ch in text:
        if unicodedata.category(ch) == "Mn":
            continue  # strip accents
        if ch.isspace():
            if word:
                out.append("".join(word))
                word = []
        elif _is_punctuation(ch):
            if word:
                out.append("".join(word))
                word = []
            out.append(ch)
        else:
            word.append(ch)
    if word:
        out.append("".join(word))
    return out


class WordPieceTokenizer(BaseTokenizer):
    """WordPiece with a native (C++) ASCII fast path.

    Pure-ASCII texts encode through ``native/wordpiece.cpp`` when the
    native library loads (``utils.native``; byte for byte the Python
    path's ids); other texts take the Python path, which owns the
    Unicode NFD + combining-mark handling.  ``use_native=False`` keeps
    Python everywhere.
    """

    def __init__(
        self,
        vocab: dict,
        max_chars_per_word: int = 100,
        use_native: bool = True,
    ):
        self.vocab = vocab
        self.max_chars_per_word = max_chars_per_word
        self.pad_id = vocab[PAD]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]
        self.unk_id = vocab[UNK]
        # the C++ path hardcodes the default word-length cap; any other
        # cap keeps the Python path
        self._native = (
            _native_wordpiece(vocab)
            if use_native and max_chars_per_word == 100
            else None
        )

    @classmethod
    def from_vocab_file(cls, path: str, **kwargs) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\r\n")] = i
        return cls(vocab, **kwargs)

    def _wordpiece(self, word: str) -> list:
        if len(word) > self.max_chars_per_word:
            return [self.unk_id]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                pid = self.vocab.get(piece)
                if pid is not None:
                    piece_id = pid
                    break
                end -= 1
            if piece_id is None:
                return [self.unk_id]
            pieces.append(piece_id)
            start = end
        return pieces

    def _encode(self, text: str, max_length: int):
        if self._native is not None and text.isascii():
            out = self._native.encode(text, max_length)
            if out is not None:
                return out
        ids = [self.cls_id]
        for word in basic_tokenize(text):
            ids.extend(self._wordpiece(word))
            if len(ids) >= max_length - 1:
                break
        ids = ids[: max_length - 1]
        ids.append(self.sep_id)
        return ids


class NativeTokenizerBridge:
    """ctypes bridge to one native tokenizer (``<prefix>_new`` /
    ``<prefix>_encode`` / ``<prefix>_free`` in the native library), shared
    by the WordPiece ("wp") and unigram ("spm") fast paths, which expose
    the same C ABI."""

    def __init__(self, lib, prefix: str, blob: bytes):
        import ctypes

        new = getattr(lib, f"{prefix}_new")
        new.restype = ctypes.c_void_p
        new.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        free = getattr(lib, f"{prefix}_free")
        free.restype = None
        free.argtypes = [ctypes.c_void_p]
        encode = getattr(lib, f"{prefix}_encode")
        encode.restype = ctypes.c_int64
        encode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        self._ctypes = ctypes
        self._encode = encode
        self._free = free
        self._blob = blob
        self._handle = new(blob, len(blob))
        if not self._handle:
            raise ValueError(f"native {prefix} tokenizer rejected the blob")

    def encode(self, text: str, max_length: int):
        """ASCII ``text`` -> ids (with the specials), or None where the
        native path declines the text."""
        # a fresh output buffer per call: ctypes releases the GIL during
        # the call, and the server tokenizes on concurrent handler
        # threads, so a shared buffer would race
        buf = (self._ctypes.c_int32 * max_length)()
        raw = text.encode("ascii")
        n = self._encode(self._handle, raw, len(raw), max_length, buf)
        if n < 0:
            return None
        return list(buf[: int(n)])

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._free(handle)


def _native_wordpiece(vocab: dict):
    """A native bridge for this vocab, or None when the native library is
    unavailable or the vocab cannot be serialized (ids must be exactly
    0..n-1, tokens newline-free, the specials present)."""
    from ..utils.native import load_library

    lib = load_library()
    if lib is None:
        return None
    n = len(vocab)
    lines = [None] * n
    for token, i in vocab.items():
        if (
            not isinstance(i, int)
            or not 0 <= i < n
            or lines[i] is not None
            or "\n" in token
            or "\r" in token
        ):
            return None
        lines[i] = token
    if any(line is None for line in lines):
        return None
    blob = ("\n".join(lines) + "\n").encode("utf-8")
    return NativeTokenizerBridge(lib, "wp", blob)


class HashTokenizer(BaseTokenizer):
    """Deterministic hash tokenization: same text -> same ids, same-shaped
    pipeline as WordPiece.  Special ids mirror BERT (0=PAD, 101=CLS,
    102=SEP)."""

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size
        self.pad_id = 0
        self.cls_id = min(101, vocab_size - 3)
        self.sep_id = min(102, vocab_size - 2)
        self._reserved = {self.pad_id, self.cls_id, self.sep_id}

    def _token_id(self, token: str) -> int:
        import hashlib

        h = int.from_bytes(
            hashlib.blake2s(token.encode("utf-8"), digest_size=4).digest(),
            "big",
        )
        tid = h % self.vocab_size
        while tid in self._reserved:
            tid = (tid + 1) % self.vocab_size
        return tid

    def _encode(self, text: str, max_length: int):
        ids = [self.cls_id]
        for word in basic_tokenize(text):
            ids.append(self._token_id(word))
            if len(ids) >= max_length - 1:
                break
        ids = ids[: max_length - 1]
        ids.append(self.sep_id)
        return ids


def load_tokenizer(
    vocab_path: Optional[str] = None,
    vocab_size: int = 30522,
    scheme: Optional[str] = None,
) -> BaseTokenizer:
    """Real tokenizer for ``vocab_path``, hash fallback when none given.

    ``*.txt`` -> WordPiece; ``*.model`` / ``*.spm`` -> SentencePiece
    unigram (``scheme`` picks the xlmr / deberta id convention, default
    xlmr; see ``spm``).  A configured path that does not exist is an
    error, not a silent hash fallback: a typo'd EMBEDDER_VOCAB must not
    serve garbage tokenization that looks valid.
    """
    if vocab_path:
        import os

        if not os.path.exists(vocab_path):
            raise FileNotFoundError(
                f"tokenizer vocab {vocab_path!r} does not exist"
            )
        if vocab_path.endswith((".model", ".spm")):
            from .spm import UnigramTokenizer

            return UnigramTokenizer.from_model_file(
                vocab_path, scheme or "xlmr"
            )
        return WordPieceTokenizer.from_vocab_file(vocab_path)
    return HashTokenizer(vocab_size)
