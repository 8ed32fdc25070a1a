"""A frozen WordPiece tokenizer with the semantics of HF
``BertTokenizer`` (``do_lower_case=True``): clean the text, pad CJK
characters with spaces, lowercase, strip accents, split on whitespace
and punctuation, then greedy longest match with ``##`` continuations.
Sequences are ``[CLS] ... [SEP]``, truncated to ``max_length``."""

from __future__ import annotations

import unicodedata


def _is_whitespace(ch: str) -> bool:
    if ch in " \t\n\r":
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_tokens(text: str) -> list:
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            cleaned.append(f" {ch} ")
        else:
            cleaned.append(" " if _is_whitespace(ch) else ch)
    words = []
    for token in "".join(cleaned).split():
        token = unicodedata.normalize("NFD", token.lower())
        token = "".join(c for c in token if unicodedata.category(c) != "Mn")
        word = ""
        for ch in token:
            if _is_punctuation(ch):
                if word:
                    words.append(word)
                words.append(ch)
                word = ""
            else:
                word += ch
        if word:
            words.append(word)
    return words


class WordPiece:
    def __init__(self, tokens: list, max_chars_per_word: int = 100):
        self.vocab = {t: i for i, t in enumerate(tokens)}
        self.max_chars = max_chars_per_word
        self.cls, self.sep = self.vocab["[CLS]"], self.vocab["[SEP]"]
        self.unk, self.pad = self.vocab["[UNK]"], self.vocab["[PAD]"]
        self._memo = {}

    def pieces(self, word: str) -> list:
        got = self._memo.get(word)
        if got is None:
            got = self._memo[word] = self._pieces(word)
        return got

    def _pieces(self, word: str) -> list:
        if len(word) > self.max_chars:
            return [self.unk]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            found = None
            while start < end:
                piece = ("##" if start else "") + word[start:end]
                if piece in self.vocab:
                    found = self.vocab[piece]
                    break
                end -= 1
            if found is None:
                return [self.unk]
            out.append(found)
            start = end
        return out

    def encode(self, text: str, max_length: int = 512) -> list:
        ids = []
        for word in basic_tokens(text):
            ids.extend(self.pieces(word))
        return [self.cls] + ids[: max_length - 2] + [self.sep]
