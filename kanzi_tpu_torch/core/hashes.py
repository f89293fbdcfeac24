"""Block checksums: XXHash32/64 with seed = bitstream magic.

The reference embeds its own XXHash (src/util/XXHash.hpp:31-230) — the
standard XXH32/XXH64 algorithms — seeded with BITSTREAM_TYPE (0x4B414E5A,
src/io/CompressedOutputStream.cpp:104-109). We use the `xxhash` C package
when present and fall back to a pure-Python XXH32/64.
"""

from __future__ import annotations

SEED = 0x4B414E5A

try:
    import xxhash as _xx

    def xxhash32(data: bytes, seed: int = SEED) -> int:
        return _xx.xxh32(bytes(data), seed=seed).intdigest()

except ImportError:  # pure-Python fallback (slow; only correctness path)
    _M32 = 0xFFFFFFFF
    _P32 = (2654435761, 2246822519, 3266489917, 668265263, 374761393)

    def _rotl32(x, r):
        return ((x << r) | (x >> (32 - r))) & _M32

    def xxhash32(data: bytes, seed: int = SEED) -> int:
        data = bytes(data)
        n = len(data)
        i = 0
        if n >= 16:
            v1 = (seed + _P32[0] + _P32[1]) & _M32
            v2 = (seed + _P32[1]) & _M32
            v3 = seed & _M32
            v4 = (seed - _P32[0]) & _M32
            while i <= n - 16:
                for j, v in enumerate((v1, v2, v3, v4)):
                    x = int.from_bytes(data[i + 4 * j:i + 4 * j + 4], "little")
                    v = _rotl32((v + x * _P32[1]) & _M32, 13) * _P32[0] & _M32
                    if j == 0: v1 = v
                    elif j == 1: v2 = v
                    elif j == 2: v3 = v
                    else: v4 = v
                i += 16
            h = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12) + _rotl32(v4, 18)) & _M32
        else:
            h = (seed + _P32[4]) & _M32
        h = (h + n) & _M32
        while i <= n - 4:
            h = (h + int.from_bytes(data[i:i + 4], "little") * _P32[2]) & _M32
            h = _rotl32(h, 17) * _P32[3] & _M32
            i += 4
        while i < n:
            h = (h + data[i] * _P32[4]) & _M32
            h = _rotl32(h, 11) * _P32[0] & _M32
            i += 1
        h ^= h >> 15
        h = h * _P32[1] & _M32
        h ^= h >> 13
        h = h * _P32[2] & _M32
        return h ^ (h >> 16)


# --- XXHash64, kanzi variant ---
# The reference's XXHash64 (src/util/XXHash.hpp:153-211) is NOT standard
# XXH64: after the 4-lane loop it combines lanes with `(v << 1) | (v >> 31)`
# etc. — 32-bit-style rotate amounts applied to 64-bit lanes. We replicate
# that exactly (a standard xxh64 library cannot be used).

_M64 = (1 << 64) - 1
_P64 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
        0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5)


def _rotl64(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def _rnd64(acc, x):
    return _rotl64((acc + x * _P64[1]) & _M64, 31) * _P64[0] & _M64


def xxhash64(data: bytes, seed: int = SEED) -> int:
    import numpy as np
    data = bytes(data)
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + _P64[0] + _P64[1]) & _M64
        v2 = (seed + _P64[1]) & _M64
        v3 = seed & _M64
        v4 = (seed - _P64[0]) & _M64
        nlanes = (n // 32) * 4
        words = np.frombuffer(data, dtype="<u8", count=nlanes).tolist()
        for k in range(0, nlanes, 4):
            v1 = _rotl64((v1 + words[k] * _P64[1]) & _M64, 31) * _P64[0] & _M64
            v2 = _rotl64((v2 + words[k + 1] * _P64[1]) & _M64, 31) * _P64[0] & _M64
            v3 = _rotl64((v3 + words[k + 2] * _P64[1]) & _M64, 31) * _P64[0] & _M64
            v4 = _rotl64((v4 + words[k + 3] * _P64[1]) & _M64, 31) * _P64[0] & _M64
        i = (n // 32) * 32
        # kanzi-specific lane fold: 32-bit-style rotates on 64-bit lanes
        h = (((v1 << 1) | (v1 >> 31)) + ((v2 << 7) | (v2 >> 25)) +
             ((v3 << 12) | (v3 >> 20)) + ((v4 << 18) | (v4 >> 14))) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _rnd64(0, v)) * _P64[0] + _P64[3]) & _M64
    else:
        h = (seed + _P64[4]) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h = (_rotl64(h ^ _rnd64(0, int.from_bytes(data[i:i + 8], "little")), 27)
             * _P64[0] + _P64[3]) & _M64
        i += 8
    while i + 4 <= n:
        h = (_rotl64(h ^ ((int.from_bytes(data[i:i + 4], "little") * _P64[0]) & _M64), 23)
             * _P64[1] + _P64[2]) & _M64
        i += 4
    while i < n:
        h = (_rotl64(h ^ ((data[i] * _P64[4]) & _M64), 11) * _P64[0]) & _M64
        i += 1
    h ^= h >> 33
    h = h * _P64[1] & _M64
    h ^= h >> 29
    h = h * _P64[2] & _M64
    return h ^ (h >> 32)

