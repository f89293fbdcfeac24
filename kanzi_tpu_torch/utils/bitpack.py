"""Vectorized variable-length bit packing/unpacking.

These are the data-parallel primitives shared by the Huffman/ANS coders:
given per-symbol (code, length) pairs, produce the concatenated MSB-first
bit stream in O(total_bits) numpy ops — no per-symbol Python loop. The
same formulation maps directly onto the TPU (prefix-sum of lengths +
scatter), see kanzi_tpu/ops.
"""

from __future__ import annotations

import numpy as np


def pack_bits(codes: np.ndarray, lens: np.ndarray):
    """Concatenate len[i] low bits of codes[i], MSB-first.

    Returns (packed bytes as uint8 array, total_bits). Zero-length entries
    are allowed.
    """
    codes = np.asarray(codes, dtype=np.uint64)
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.uint8), 0
    if lens.max() <= 32:
        from kanzi_tpu_torch.utils import native
        if native.transforms_available():
            return native.pack_bits_native(codes.astype(np.uint32), lens)
    ends = np.cumsum(lens)
    starts = ends - lens
    idx = np.repeat(np.arange(len(codes), dtype=np.int64), lens)
    off = np.arange(total, dtype=np.int64) - np.repeat(starts, lens)
    shift = (lens[idx] - 1 - off).astype(np.uint64)
    bits = ((codes[idx] >> shift) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits), total


def unpack_bits(data, nbits: int) -> np.ndarray:
    """Expand the first nbits of a byte buffer into a uint8 0/1 array."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    bits = np.unpackbits(arr)
    return bits[:nbits]


def sliding_window_values(bits: np.ndarray, width: int) -> np.ndarray:
    """value[p] = int(bits[p:p+width]) MSB-first, for every position p.

    bits is a 0/1 uint8 array; output padded with zeros past the end so
    every p in [0, len(bits)) is valid.
    """
    n = len(bits)
    padded = np.concatenate([bits.astype(np.uint32), np.zeros(width, np.uint32)])
    win = np.lib.stride_tricks.sliding_window_view(padded, width)[:n]
    powers = (1 << np.arange(width - 1, -1, -1, dtype=np.uint32))
    return (win * powers).sum(axis=1, dtype=np.uint32)


def chain_walk(nxt: np.ndarray, start: int, count: int) -> np.ndarray:
    """Follow pos -> nxt[pos] `count` times from `start`, returning the
    positions visited (including start). Pointer-doubling: O(count log count)
    vectorized gathers instead of a sequential loop.
    """
    n = len(nxt)
    pos = np.empty(count, dtype=np.int64)
    if count == 0:
        return pos
    pos[0] = start
    filled = 1
    jump = np.minimum(np.asarray(nxt, dtype=np.int64), n - 1)
    while filled < count:
        m = min(filled, count - filled)
        pos[filled:filled + m] = jump[pos[:m]]
        filled += m
        if filled < count:
            jump = jump[np.minimum(jump, n - 1)]
    return pos
