"""Request bodies of a mix, from the seed.

Request k of client c is drawn from ``numpy.random.default_rng((seed,
c, k))``, so the same seed gives the same requests whatever the timing.
Every request of a mix has the same multiset of candidate lengths
(``candidate_tokens``: evenly spaced from the low to the high end, one
per candidate), in an order drawn per request; each candidate is that
many words drawn from ``words``, every one a whole token of the
configuration's vocabulary, so a candidate of L words is L + 2 tokens
with its specials.  With ``prompt_tokens`` every request carries a
prompt of that many words; its length steps through the range in an
order drawn from the seed, so every seed sends the same set of prompt
lengths.  Nothing here depends on the program."""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Request:
    client: int
    index: int
    texts: list
    prompt: Optional[str]
    body: bytes


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 64), *keys])


def candidate_lengths(mix: dict) -> np.ndarray:
    lo, hi = mix["candidate_tokens"]
    return np.rint(np.linspace(lo, hi, mix["candidates"])).astype(int)


def prompt_lengths(mix: dict, seed: int) -> Optional[np.ndarray]:
    if not mix.get("prompt_tokens"):
        return None
    lo, hi = mix["prompt_tokens"]
    return _rng(seed, 2 ** 32).permutation(np.arange(lo, hi + 1))


class RequestSource:
    """``request(c, k)``: the k-th request of client c."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = seed
        self.words = np.array(mix["words"])
        self.lengths = candidate_lengths(mix)
        self.prompts = prompt_lengths(mix, seed)

    def _text(self, rng, n: int) -> str:
        return " ".join(self.words[rng.integers(0, len(self.words), n)])

    def request(self, client: int, index: int) -> Request:
        mix = self.mix
        rng = _rng(self.seed, client, index)
        texts = [self._text(rng, int(n)) for n in rng.permutation(
            self.lengths)]
        body = {"input": texts, "temperature": mix["temperature"]}
        if mix["scorer"] != "cosine":
            body["scorer"] = mix["scorer"]
        prompt = None
        if self.prompts is not None:
            n = self.prompts[(index * 7 + client * 13) % len(self.prompts)]
            prompt = self._text(rng, int(n))
            body["prompt"] = prompt
        return Request(client, index, texts, prompt,
                       json.dumps(body).encode())

    def prebuilt(self, clients: int, per_client: int) -> list:
        """[client][k] for k < per_client."""
        return [[self.request(c, k) for k in range(per_client)]
                for c in range(clients)]


def model_texts(req: Request) -> list:
    """The texts the scorer sees: the candidates, each after the prompt
    and a newline when there is one (the reward model's input)."""
    if req.prompt:
        return [f"{req.prompt}\n{t}" for t in req.texts]
    return list(req.texts)
