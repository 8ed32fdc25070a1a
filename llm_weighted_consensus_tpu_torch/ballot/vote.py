"""Vote extraction: judge output text -> probability vector over candidates.

Reference: get_vote, src/score/completions/client.rs:1661-1800.

The reference does this math in exact decimal (rust_decimal +
MathematicalOps::exp); we use Python ``decimal.Decimal`` whose ``exp`` is
correctly rounded — at least as precise.

The port's copy of ``llm_weighted_consensus_tpu/ballot/vote.py``, held
exactly against it by tests/test_torch_ballot.py.
"""

from __future__ import annotations

import re
from decimal import Decimal
from typing import Optional

from ..errors import InvalidContentError
from .tree import ALPHABET, PrefixTree


def _last_match(pattern: "str | re.Pattern", content: str) -> Optional[str]:
    last = None
    # pre-compiled patterns scan through their own method: re.finditer
    # on a Pattern object pays a failed module-cache probe (KeyError in
    # re._compile) on every call
    if isinstance(pattern, re.Pattern):
        it = pattern.finditer(content)
    else:
        it = re.finditer(pattern, content)
    for m in it:
        last = m
    return last.group(0) if last else None


def _byte_len(c: str) -> int:
    return len(c.encode("utf-8"))


def _char_at_byte(token: str, byte_index: int) -> Optional[str]:
    """Char starting exactly at UTF-8 ``byte_index``, if any.

    Token alignment works in byte offsets so that alternative tokens from
    ``top_logprobs`` index consistently with the sampled token
    (client.rs:1767-1778 uses char_indices over bytes).
    """
    i = 0
    for ch in token:
        if i == byte_index:
            return ch
        i += _byte_len(ch)
        if i > byte_index:
            return None
    return None


def find_key(
    content: Optional[str],
    with_ticks_pattern: "str | re.Pattern",
    without_ticks_pattern: "str | re.Pattern",
) -> Optional[str]:
    """Last ballot-key occurrence in ``content``: models often restate keys
    while reasoning, the final statement is the decision
    (client.rs:1675-1688).  Backticked match preferred, tick-stripped
    fallback.  Patterns may arrive pre-compiled (the HOST_FASTPATH judge
    stream compiles its two ballot patterns once per panel member);
    matches are identical either way."""
    if not content:
        return None
    key = _last_match(with_ticks_pattern, content)
    if key is None:
        key = _last_match(without_ticks_pattern, content)
    return key


def final_letter(key: str) -> str:
    """The key's final alphabet letter — selects within the lowest branch."""
    return next(c for c in reversed(key) if c in ALPHABET)


def extract_vote(
    tree: PrefixTree,
    with_ticks_pattern: "str | re.Pattern",
    without_ticks_pattern: "str | re.Pattern",
    n_choices: int,
    content: Optional[str],
    logprob_tokens: Optional[list] = None,
) -> list:
    """Extract a vote vector (list of Decimal summing to 1) from judge output.

    ``logprob_tokens`` is the accumulated ``logprobs.content`` token list:
    each item must expose ``.token`` (str), and ``.top_logprobs`` — a list of
    items with ``.token`` and ``.logprob``.  When present and alignable, the
    vote is the normalized ``exp(logprob)`` distribution over sibling leaf
    letters; otherwise one-hot on the selected candidate.

    Raises :class:`InvalidContentError` when no ballot key is found.
    """
    if not content:
        raise InvalidContentError("judge output is empty")

    key = find_key(content, with_ticks_pattern, without_ticks_pattern)
    if key is None:
        raise InvalidContentError("no ballot key found in judge output")

    final_char = final_letter(key)

    branch = tree.walk(key)

    vote = [Decimal(0)] * n_choices

    soft = _soft_vote(branch, key, final_char, vote, logprob_tokens)
    if soft is not None:
        return soft

    # one-hot fallback (client.rs:1796-1798)
    leaf = branch.get(final_char)
    if not isinstance(leaf, int):
        raise InvalidContentError(f"ballot key {key!r} selects no candidate")
    vote[leaf] = Decimal(1)
    return vote


def align_key_token(
    key: str, final_char: str, logprob_tokens: Optional[list]
):
    """Reverse-align ``key`` against the token stream to find the token that
    carries the final key letter (client.rs:1721-1762).  Multi-char tokens,
    split keys, and unicode are all handled by byte-offset matching.

    Returns ``(entry, byte_index)`` — the logprob entry and the UTF-8 byte
    offset of the final letter inside its token — or None when the key is
    not alignable (missing/partial logprobs)."""
    if not logprob_tokens:
        return None

    key_rev = key[::-1]
    remaining = key_rev
    key_token = None
    key_byte_index = 0

    done = False
    for entry in reversed(logprob_tokens):
        token = getattr(entry, "token", None)
        if token is None:
            continue
        i = _byte_len(token)
        for c in reversed(token):
            i -= _byte_len(c)
            if remaining.startswith(c):
                remaining = remaining[1:]
                if key_token is None and c == final_char:
                    key_token = entry
                    key_byte_index = i
                if not remaining:
                    done = True
                    break
            elif len(remaining) != len(key_rev):
                # partial match broke: reset and keep scanning backwards
                remaining = key_rev
                key_token = None
                key_byte_index = 0
            # else: unrelated char before any match begins — keep going
        if done:
            break

    if remaining or key_token is None:
        return None
    return key_token, key_byte_index


def soft_vote_alternatives(
    branch: dict, key_token, key_byte_index: int
) -> list:
    """The ``top_logprobs`` alternatives of the aligned key token that map
    to sibling leaves: list of (candidate_index, raw logprob).  This is
    the input of the soft vote, which ``_soft_vote`` exp/normalizes in
    Decimal below."""
    out = []
    for alt in getattr(key_token, "top_logprobs", None) or []:
        token = getattr(alt, "token", None)
        logprob = getattr(alt, "logprob", None)
        if token is None or logprob is None:
            continue
        c = _char_at_byte(token, key_byte_index)
        if c is None or c not in ALPHABET:
            continue
        leaf = branch.get(c)
        if not isinstance(leaf, int):
            continue
        out.append((leaf, logprob))
    return out


def _soft_vote(
    branch: dict,
    key: str,
    final_char: str,
    vote: list,
    logprob_tokens: Optional[list],
) -> Optional[list]:
    """Logprob soft-vote path (client.rs:1721-1792); None -> fall back to one-hot."""
    aligned = align_key_token(key, final_char, logprob_tokens)
    if aligned is None:
        return None
    key_token, key_byte_index = aligned

    total = Decimal(0)
    for leaf, logprob in soft_vote_alternatives(
        branch, key_token, key_byte_index
    ):
        p = Decimal(str(logprob)).exp()
        vote[leaf] += p
        total += p

    if total == 0:
        # the sampled letter was not among the alternatives; degrade to
        # one-hot rather than divide by zero (reference marks this
        # unreachable, client.rs:1784-1786)
        return None
    for i in range(len(vote)):
        vote[i] /= total
    return vote
