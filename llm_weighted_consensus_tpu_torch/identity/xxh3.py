"""XXH3-128 and XXH3-64 (seed 0, the default secret) in pure Python.

The reference hashes panel ids with the ``xxhash`` package
(``llm_weighted_consensus_tpu/identity/__init__.py``); the card's machine
has no ``xxhash``, so the port carries the algorithm itself, from the
xxHash specification (v0.8): one path per length class (0, 1-3, 4-8,
9-16, 17-128, 129-240, and the striped long hash past 240 bytes).  Ids
are computed once per panel validation, off the device path, so speed
is not a concern.  ``xxh3_128_intdigest`` equals
``xxhash.xxh3_128_intdigest`` on every input; ``Xxh3_128`` buffers its
updates and hashes at ``intdigest``, so any split of the input gives
the one-shot value.  ``xxh3_64_intdigest`` equals
``xxhash.xxh3_64_intdigest``: the fleet's ring points, its fault plan's
per-pair seeds and its record digests run on it.  The 64-bit variant
shares the secret and the long hash's accumulate loop, but has its own
short and mid-size paths and its own final merge, so it is not the
128-bit value truncated.
"""

from __future__ import annotations

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1

_P32_1 = 0x9E3779B1
_P32_2 = 0x85EBCA77
_P32_3 = 0xC2B2AE3D
_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5
_PMX_1 = 0x165667919E3779F9
_PMX_2 = 0x9FB21C651E98DF25

_SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e"
)
_STRIPE = 64
_STRIPES_PER_BLOCK = (len(_SECRET) - _STRIPE) // 8
_BLOCK = _STRIPE * _STRIPES_PER_BLOCK


def _r64(b: bytes, i: int) -> int:
    return int.from_bytes(b[i : i + 8], "little")


def _r32(b: bytes, i: int) -> int:
    return int.from_bytes(b[i : i + 4], "little")


def _swap32(x: int) -> int:
    return int.from_bytes(x.to_bytes(4, "little"), "big")


def _swap64(x: int) -> int:
    return int.from_bytes(x.to_bytes(8, "little"), "big")


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _fold64(a: int, b: int) -> int:
    p = a * b
    return (p & _M64) ^ (p >> 64)


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * _P64_2) & _M64
    h ^= h >> 29
    h = (h * _P64_3) & _M64
    return h ^ (h >> 32)


def _xxh3_avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * _PMX_1) & _M64
    return h ^ (h >> 32)


def _mix16(data: bytes, i: int, s: int) -> int:
    return _fold64(
        _r64(data, i) ^ _r64(_SECRET, s), _r64(data, i + 8) ^ _r64(_SECRET, s + 8)
    )


def _mix32(lo: int, hi: int, data: bytes, i1: int, i2: int, s: int):
    lo = (lo + _mix16(data, i1, s)) & _M64
    lo ^= (_r64(data, i2) + _r64(data, i2 + 8)) & _M64
    hi = (hi + _mix16(data, i2, s + 16)) & _M64
    hi ^= (_r64(data, i1) + _r64(data, i1 + 8)) & _M64
    return lo, hi


def _finish_mid(lo: int, hi: int, n: int):
    low = (lo + hi) & _M64
    high = (lo * _P64_1 + hi * _P64_4 + n * _P64_2) & _M64
    return _xxh3_avalanche(low), (-_xxh3_avalanche(high)) & _M64


def _len_0to16(data: bytes, n: int):
    if n > 8:
        flip_l = _r64(_SECRET, 32) ^ _r64(_SECRET, 40)
        flip_h = _r64(_SECRET, 48) ^ _r64(_SECRET, 56)
        in_lo = _r64(data, 0)
        in_hi = _r64(data, n - 8)
        m = (in_lo ^ in_hi ^ flip_l) * _P64_1
        m_lo, m_hi = m & _M64, m >> 64
        m_lo = (m_lo + ((n - 1) << 54)) & _M64
        in_hi ^= flip_h
        m_hi = (m_hi + in_hi + (in_hi & _M32) * (_P32_2 - 1)) & _M64
        m_lo ^= _swap64(m_hi)
        h = m_lo * _P64_2
        h_lo, h_hi = h & _M64, h >> 64
        h_hi = (h_hi + m_hi * _P64_2) & _M64
        return _xxh3_avalanche(h_lo), _xxh3_avalanche(h_hi)
    if n >= 4:
        in64 = _r32(data, 0) + (_r32(data, n - 4) << 32)
        keyed = in64 ^ (_r64(_SECRET, 16) ^ _r64(_SECRET, 24))
        m = keyed * (_P64_1 + (n << 2))
        m_lo, m_hi = m & _M64, m >> 64
        m_hi = (m_hi + (m_lo << 1)) & _M64
        m_lo ^= m_hi >> 3
        m_lo ^= m_lo >> 35
        m_lo = (m_lo * _PMX_2) & _M64
        m_lo ^= m_lo >> 28
        return m_lo, _xxh3_avalanche(m_hi)
    if n:
        combined_l = (data[0] << 16) | (data[n >> 1] << 24) | data[n - 1] | (n << 8)
        combined_h = _rotl32(_swap32(combined_l), 13)
        flip_l = _r32(_SECRET, 0) ^ _r32(_SECRET, 4)
        flip_h = _r32(_SECRET, 8) ^ _r32(_SECRET, 12)
        return (
            _xxh64_avalanche(combined_l ^ flip_l),
            _xxh64_avalanche(combined_h ^ flip_h),
        )
    return (
        _xxh64_avalanche(_r64(_SECRET, 64) ^ _r64(_SECRET, 72)),
        _xxh64_avalanche(_r64(_SECRET, 80) ^ _r64(_SECRET, 88)),
    )


def _len_17to128(data: bytes, n: int):
    lo, hi = (n * _P64_1) & _M64, 0
    if n > 32:
        if n > 64:
            if n > 96:
                lo, hi = _mix32(lo, hi, data, 48, n - 64, 96)
            lo, hi = _mix32(lo, hi, data, 32, n - 48, 64)
        lo, hi = _mix32(lo, hi, data, 16, n - 32, 32)
    lo, hi = _mix32(lo, hi, data, 0, n - 16, 0)
    return _finish_mid(lo, hi, n)


def _len_129to240(data: bytes, n: int):
    lo, hi = (n * _P64_1) & _M64, 0
    for i in range(4):
        lo, hi = _mix32(lo, hi, data, 32 * i, 32 * i + 16, 32 * i)
    lo, hi = _xxh3_avalanche(lo), _xxh3_avalanche(hi)
    for i in range(4, n // 32):
        lo, hi = _mix32(lo, hi, data, 32 * i, 32 * i + 16, 3 + 32 * (i - 4))
    # the last 32 bytes, against the secret's tail (seed 0: no negation)
    lo, hi = _mix32(lo, hi, data, n - 16, n - 32, 136 - 17 - 16)
    return _finish_mid(lo, hi, n)


def _accumulate_512(acc: list, data: bytes, i: int, s: int) -> None:
    for lane in range(8):
        val = _r64(data, i + 8 * lane)
        key = val ^ _r64(_SECRET, s + 8 * lane)
        acc[lane ^ 1] = (acc[lane ^ 1] + val) & _M64
        acc[lane] = (acc[lane] + (key & _M32) * (key >> 32)) & _M64


def _scramble(acc: list) -> None:
    s = len(_SECRET) - _STRIPE
    for lane in range(8):
        a = acc[lane]
        a ^= a >> 47
        a ^= _r64(_SECRET, s + 8 * lane)
        acc[lane] = (a * _P32_1) & _M64


def _merge(acc: list, s: int, start: int) -> int:
    h = start
    for k in range(4):
        h = (
            h
            + _fold64(
                acc[2 * k] ^ _r64(_SECRET, s + 16 * k),
                acc[2 * k + 1] ^ _r64(_SECRET, s + 16 * k + 8),
            )
        ) & _M64
    return _xxh3_avalanche(h)


def _long(data: bytes, n: int):
    acc = [_P32_3, _P64_1, _P64_2, _P64_3, _P64_4, _P32_2, _P64_5, _P32_1]
    blocks = (n - 1) // _BLOCK
    for b in range(blocks):
        for k in range(_STRIPES_PER_BLOCK):
            _accumulate_512(acc, data, b * _BLOCK + k * _STRIPE, 8 * k)
        _scramble(acc)
    base = blocks * _BLOCK
    for k in range(((n - 1) - base) // _STRIPE):
        _accumulate_512(acc, data, base + k * _STRIPE, 8 * k)
    _accumulate_512(acc, data, n - _STRIPE, len(_SECRET) - _STRIPE - 7)
    low = _merge(acc, 11, (n * _P64_1) & _M64)
    high = _merge(
        acc, len(_SECRET) - _STRIPE - 11, ~(n * _P64_2) & _M64
    )
    return low, high


def xxh3_128_intdigest(data: bytes) -> int:
    """XXH3-128 of ``data`` with seed 0, as ``(high64 << 64) | low64``."""
    data = bytes(data)
    n = len(data)
    if n <= 16:
        low, high = _len_0to16(data, n)
    elif n <= 128:
        low, high = _len_17to128(data, n)
    elif n <= 240:
        low, high = _len_129to240(data, n)
    else:
        low, high = _long(data, n)
    return (high << 64) | low


def _rrmxmx(h: int, n: int) -> int:
    h ^= ((h << 49) | (h >> 15)) & _M64 ^ ((h << 24) | (h >> 40)) & _M64
    h = (h * _PMX_2) & _M64
    h ^= (h >> 35) + n
    h = (h * _PMX_2) & _M64
    return h ^ (h >> 28)


def _len_0to16_64(data: bytes, n: int) -> int:
    if n > 8:
        lo = _r64(data, 0) ^ (_r64(_SECRET, 24) ^ _r64(_SECRET, 32))
        hi = _r64(data, n - 8) ^ (_r64(_SECRET, 40) ^ _r64(_SECRET, 48))
        acc = (n + _swap64(lo) + hi + _fold64(lo, hi)) & _M64
        return _xxh3_avalanche(acc)
    if n >= 4:
        in64 = _r32(data, n - 4) + (_r32(data, 0) << 32)
        return _rrmxmx(in64 ^ (_r64(_SECRET, 8) ^ _r64(_SECRET, 16)), n)
    if n:
        combined = (data[0] << 16) | (data[n >> 1] << 24) | data[n - 1] | (n << 8)
        return _xxh64_avalanche(combined ^ (_r32(_SECRET, 0) ^ _r32(_SECRET, 4)))
    return _xxh64_avalanche(_r64(_SECRET, 56) ^ _r64(_SECRET, 64))


def _len_17to128_64(data: bytes, n: int) -> int:
    acc = n * _P64_1
    if n > 32:
        if n > 64:
            if n > 96:
                acc += _mix16(data, 48, 96) + _mix16(data, n - 64, 112)
            acc += _mix16(data, 32, 64) + _mix16(data, n - 48, 80)
        acc += _mix16(data, 16, 32) + _mix16(data, n - 32, 48)
    acc += _mix16(data, 0, 0) + _mix16(data, n - 16, 16)
    return _xxh3_avalanche(acc & _M64)


def _len_129to240_64(data: bytes, n: int) -> int:
    acc = n * _P64_1
    for i in range(8):
        acc += _mix16(data, 16 * i, 16 * i)
    acc = _xxh3_avalanche(acc & _M64)
    for i in range(8, n // 16):
        acc += _mix16(data, 16 * i, 16 * (i - 8) + 3)
    # the last 16 bytes, against the secret's tail (seed 0: no negation)
    acc += _mix16(data, n - 16, 136 - 17)
    return _xxh3_avalanche(acc & _M64)


def xxh3_64_intdigest(data: bytes) -> int:
    """XXH3-64 of ``data`` with seed 0."""
    data = bytes(data)
    n = len(data)
    if n <= 16:
        return _len_0to16_64(data, n)
    if n <= 128:
        return _len_17to128_64(data, n)
    if n <= 240:
        return _len_129to240_64(data, n)
    # the long hash's low half is the 64-bit merge (secret offset 11)
    return _long(data, n)[0]


def xxh3_64_hexdigest(data: bytes) -> str:
    """``xxh3_64_intdigest`` as 16 lower-case hex digits, as
    ``xxhash.xxh3_64_hexdigest`` writes it."""
    return f"{xxh3_64_intdigest(data):016x}"


class Xxh3_128:
    """Streaming form: ``update`` in any pieces, then ``intdigest``."""

    def __init__(self) -> None:
        self._parts: list = []

    def update(self, data: bytes) -> None:
        self._parts.append(bytes(data))

    def intdigest(self) -> int:
        return xxh3_128_intdigest(b"".join(self._parts))
