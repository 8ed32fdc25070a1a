"""The port's ballots against the JAX package's, exact.

* ``PrefixTree.build`` and ``key_indices`` under the same seeded
  ``random.Random``: the same tree, depth and presentation order (the
  port keeps Python's generator, so the sequence of ``rng.shuffle``
  calls is the reference's);
* ``serialize_ballot``, ``regex_patterns``, ``ballot_instruction``,
  ``response_key_schema``, ``response_format_for``, ``branch_limit`` and
  ``leaf_branch_of``: equal values;
* ``extract_vote`` on the same contents and logprobs (hard votes, soft
  votes, multi-character tokens, partial matches, nested trees,
  unalignable logprobs, stripped ticks, unicode): the same Decimal
  vectors, and ``InvalidContentError`` exactly where the reference
  raises it.

The cases mirror ``tests/test_ballot.py``'s.
"""

import math
import random
from dataclasses import dataclass, field

import pytest

from llm_weighted_consensus_tpu import ballot as ref
from llm_weighted_consensus_tpu.ballot import vote as ref_vote
from llm_weighted_consensus_tpu.errors import (
    InvalidContentError as RefInvalidContent,
)
from llm_weighted_consensus_tpu_torch import ballot as port
from llm_weighted_consensus_tpu_torch.ballot import vote as port_vote
from llm_weighted_consensus_tpu_torch.errors import (
    InvalidContentError as PortInvalidContent,
)


@dataclass
class TopLogprob:
    token: str
    logprob: float = None


@dataclass
class LogprobToken:
    token: str
    logprob: float = None
    top_logprobs: list = field(default_factory=list)


def both(n, max_branch=20, seed=0):
    """(reference tree, pairs), (port tree, pairs) from one seed."""
    out = []
    for pkg in (ref, port):
        rng = random.Random(seed)
        tree = pkg.PrefixTree.build(rng, n, max_branch)
        out.append((tree, tree.key_indices(rng)))
    return out


SHAPES = [(2, 20), (3, 20), (5, 20), (20, 20), (21, 20), (40, 20),
          (64, 20), (400, 20), (401, 20), (2, 2), (3, 2), (9, 2), (40, 5),
          (17, 8), (32, 8), (100, 3)]


@pytest.mark.parametrize("n,max_branch", SHAPES)
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_tree_and_key_order_equal(n, max_branch, seed):
    (rt, rp), (pt, pp) = both(n, max_branch, seed)
    assert pt.depth == rt.depth
    assert pt.root == rt.root
    assert pp == rp
    keys = [k for k, _ in pp]
    assert port.PrefixTree.regex_patterns(keys) == \
        ref.PrefixTree.regex_patterns(keys)
    texts = [f"candidate {i} ✓ \"quoted\"" for i in range(n)]
    assert port.serialize_ballot(texts, pp) == ref.serialize_ballot(texts, rp)
    for key, _ in pp[:8]:
        assert pt.walk(key) == rt.walk(key)
        assert port.PrefixTree.leaf_branch_of(pp, key) == \
            ref.PrefixTree.leaf_branch_of(rp, key)
        assert port.PrefixTree.leaf_branch_of(pp, key[1:-1]) == \
            ref.PrefixTree.leaf_branch_of(rp, key[1:-1])


@pytest.mark.parametrize("top_logprobs", [None, 0, 1, 2, 5, 8, 20, 25])
def test_branch_limit_equal(top_logprobs):
    assert port.branch_limit(top_logprobs) == ref.branch_limit(top_logprobs)


@pytest.mark.parametrize("mode", ["instruction", "json_schema", "tool_call"])
@pytest.mark.parametrize("synthetic", [False, True])
def test_prompting_equal(mode, synthetic):
    (_, rp), (_, pp) = both(6, 20, 3)
    keys = [k for k, _ in pp]
    ballot = port.serialize_ballot(list("abcdef"), pp)
    assert port.ballot_instruction(ballot, keys, mode) == \
        ref.ballot_instruction(ballot, keys, mode)
    assert port.response_key_schema(keys, synthetic) == \
        ref.response_key_schema(keys, synthetic)
    assert port.response_format_for(keys, synthetic) == \
        ref.response_format_for(keys, synthetic)


def _extract(pkg, vote_mod, tree, pairs, n, content, tokens, compiled):
    wt, wo = pkg.PrefixTree.regex_patterns([k for k, _ in pairs])
    if compiled:
        import re

        wt, wo = re.compile(wt), re.compile(wo)
    return vote_mod.extract_vote(tree, wt, wo, n, content, tokens)


def _vote_both(n, max_branch, seed, content_fn, tokens_fn=None,
               compiled=False):
    (rt, rp), (pt, pp) = both(n, max_branch, seed)
    content = content_fn(pp, pt)
    tokens = tokens_fn(pp, pt) if tokens_fn is not None else None
    outcomes = []
    for pkg, vote_mod, tree, pairs, err in (
        (ref, ref_vote, rt, rp, RefInvalidContent),
        (port, port_vote, pt, pp, PortInvalidContent),
    ):
        try:
            outcomes.append(("vote", _extract(pkg, vote_mod, tree, pairs, n,
                                              content, tokens, compiled)))
        except err as exc:
            outcomes.append(("invalid", exc.message()))
    return outcomes


def _soft_tokens(pairs, tree, weights=(0.2, 0.3, 0.5)):
    key = pairs[0][0]
    branch = tree.walk(key)
    top = [TopLogprob(token=c, logprob=math.log(weights[j % len(weights)]
                                                + 0.01 * j))
           for j, c in enumerate(branch)]
    return [LogprobToken(token=key[:-2]),
            LogprobToken(token=key[-2], top_logprobs=top),
            LogprobToken(token="`")]


def _multichar_tokens(pairs, tree):
    key = pairs[0][0]
    other = pairs[1][0]
    return [LogprobToken(token=key, top_logprobs=[
        TopLogprob(token=key, logprob=math.log(0.75)),
        TopLogprob(token=other, logprob=math.log(0.25)),
    ])]


def _partial_tokens(pairs, tree):
    key = pairs[0][0]
    return [LogprobToken(token="`x"), LogprobToken(token="`"),
            LogprobToken(token=key[1],
                         top_logprobs=[TopLogprob(token=key[1], logprob=0.0)]),
            LogprobToken(token="`")]


def _zero_mass_tokens(pairs, tree):
    # the sampled letter's alternatives carry no sibling letter: one-hot
    key = pairs[0][0]
    return [LogprobToken(token=key[:-2]),
            LogprobToken(token=key[-2],
                         top_logprobs=[TopLogprob(token="zz", logprob=-1.0)]),
            LogprobToken(token="`")]


VOTE_CASES = {
    "hard_first_key": (lambda p, t: f"I choose {p[0][0]}.", None),
    "hard_last_key": (lambda p, t: f"I choose {p[-1][0]}", None),
    "last_match_wins": (
        lambda p, t: f"Maybe {p[0][0]}? On reflection {p[1][0]}", None),
    "ticks_eaten": (lambda p, t: f"answer: {p[0][0][1:-1]}", None),
    "no_key": (lambda p, t: "no key here", None),
    "empty": (lambda p, t: "", None),
    "none": (lambda p, t: None, None),
    "unicode": (lambda p, t: f"café ✓ — choosing {p[0][0]} ✓", None),
    "soft": (lambda p, t: f"the answer is {p[0][0]}", _soft_tokens),
    "multichar": (lambda p, t: p[0][0], _multichar_tokens),
    "partial_reset": (lambda p, t: f"junk `x then {p[0][0]}",
                      _partial_tokens),
    "unalignable": (lambda p, t: p[0][0],
                    lambda p, t: [LogprobToken(token="unrelated")]),
    "zero_mass": (lambda p, t: f"pick {p[0][0]}", _zero_mass_tokens),
}


@pytest.mark.parametrize("case", sorted(VOTE_CASES))
@pytest.mark.parametrize("n,max_branch", [(2, 20), (3, 20), (21, 20),
                                          (40, 5), (9, 2), (64, 8)])
def test_extract_vote_equal(case, n, max_branch):
    content_fn, tokens_fn = VOTE_CASES[case]
    want, got = _vote_both(n, max_branch, 11, content_fn, tokens_fn)
    assert got == want
    if want[0] == "vote":
        # the same Decimals, exponents included (they decide the bytes)
        assert [str(v) for v in got[1]] == [str(v) for v in want[1]]


@pytest.mark.parametrize("case", ["hard_first_key", "soft", "ticks_eaten"])
def test_extract_vote_equal_with_compiled_patterns(case):
    content_fn, tokens_fn = VOTE_CASES[case]
    want, got = _vote_both(21, 20, 5, content_fn, tokens_fn, compiled=True)
    assert [str(v) for v in got[1]] == [str(v) for v in want[1]]


@pytest.mark.parametrize("n", [2, 20, 64, 400])
def test_find_key_equal_on_fuzzed_contents(n):
    rng = random.Random(n)
    (_, rp), (_, pp) = both(n, 20, 5)
    keys = [k for k, _ in pp]
    wt, wo = port.PrefixTree.regex_patterns(keys)
    for _ in range(25):
        content = "".join(rng.choices(
            keys + ["lorem ", "`", "``", "ipsum`X`", " "], k=12))
        assert port_vote.find_key(content, wt, wo) == \
            ref_vote.find_key(content, wt, wo)
