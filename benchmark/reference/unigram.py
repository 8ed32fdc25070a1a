"""A frozen SentencePiece unigram tokenizer with the semantics of
sentencepiece's unigram model under the DeBERTa-v3 id scheme: NFKC,
control characters dropped, whitespace split, every word prefixed with
``▁``, the Viterbi (max-sum) segmentation over the piece scores, an
unknown character scored at ``min score - 10`` and runs of unknowns
fused into one ``[UNK]``.  Sequences are ``[CLS] ... [SEP]``."""

from __future__ import annotations

import unicodedata

SPACE = "▁"
UNK_PENALTY = 10.0


class Unigram:
    def __init__(self, pieces: list):
        """``pieces``: [(piece, score, kind)] in id order, kind one of
        ``normal``, ``control``, ``unknown``."""
        self.ids = {p: i for i, (p, _, _) in enumerate(pieces)}
        self.scores = {p: s for p, s, k in pieces if k == "normal"}
        self.unk_score = min(self.scores.values()) - UNK_PENALTY
        self.longest = max(len(p) for p in self.scores)
        self.cls, self.sep = self.ids["[CLS]"], self.ids["[SEP]"]
        self.unk = self.ids["[UNK]"]
        self._memo = {}

    def segment(self, chunk: str) -> list:
        got = self._memo.get(chunk)
        if got is None:
            got = self._memo[chunk] = self._segment(chunk)
        return got

    def _segment(self, chunk: str) -> list:
        n = len(chunk)
        best = [float("-inf")] * (n + 1)
        back = [(0, False)] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            for j in range(i + 1, min(n, i + self.longest) + 1):
                score = self.scores.get(chunk[i:j])
                if score is not None and best[i] + score > best[j]:
                    best[j], back[j] = best[i] + score, (i, True)
            if best[i] + self.unk_score > best[i + 1]:
                best[i + 1], back[i + 1] = best[i] + self.unk_score, (i, False)
        spans, j = [], n
        while j > 0:
            i, known = back[j]
            spans.append((chunk[i:j], known))
            j = i
        ids = []
        for text, known in reversed(spans):
            if not known:
                if ids and ids[-1] is None:
                    continue
                ids.append(None)
            else:
                ids.append(self.ids[text])
        return [self.unk if i is None else i for i in ids]

    def encode(self, text: str, max_length: int = 512) -> list:
        text = unicodedata.normalize("NFKC", text)
        text = "".join(" " if ch in "\t\n\r\v\f" else ch for ch in text
                       if not unicodedata.category(ch) == "Cc"
                       or ch in "\t\n\r\v\f")
        ids = []
        for word in text.split():
            ids.extend(self.segment(SPACE + word))
        return [self.cls] + ids[: max_length - 2] + [self.sep]
