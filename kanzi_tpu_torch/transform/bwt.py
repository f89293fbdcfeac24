"""Burrows-Wheeler block codec.

Reference: src/transform/BWT.cpp + BWTBlockCodec.cpp. Up to 8 chunks with
8 primary indexes recorded in a 1-byte mode header (logChunks<<2 |
pIndexSize-1) + chunks x pIndexSize big-endian (value-1) indexes —
enabling parallel inverse (the reference's intra-block parallel hook; on
TPU the 8 chunk walks are 8 lanes of a Pallas kernel).

Inverse uses the mergeTPSI packed value+link vector (BWT.cpp:169-292)
with the sequential pointer chase replaced by the vectorized
pointer-doubling chain walk.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

import kanzi_tpu_torch.ops as ops
from kanzi_tpu_torch.core.stats import log2
from kanzi_tpu_torch.ops import block_device
from kanzi_tpu_torch.transform.base import ByteTransform, as_u8
from kanzi_tpu_torch.transform.divsufsort import compute_bwt
from kanzi_tpu_torch.utils.bitpack import chain_walk

MAX_BLOCK_SIZE = 1024 * 1024 * 1024
BLOCK_SIZE_THRESHOLD1 = 256

# The bytes a block from which its BWT forward runs on a card (the device
# suffix array, ops/bwt.py) in place of native SA-IS, and that path's
# peak memory on the card a byte of the block. Set by chip_smoke.py
# --bwt on an H100 (PERF.md) over the level-7 chain's BWT input: the
# card's path costs ~4.4 ms from 4 KiB to 64 KiB (its prefix-doubling
# rounds' fixed cost) and native SA-IS ~0.07 ms a KiB, so native wins at
# 32 KiB (0.64x) and the card from 64 KiB (1.21x), 3.6x at 256 KiB and
# 59x at 16 MiB; the peak reads 97.2-98.3 bytes a byte at 4 KiB to
# 16 MiB, rounded up here for the caching allocator's rounding.
BWT_DEVICE_MIN_BLOCK = 1 << 16
BWT_DEVICE_PEAK_PER_BYTE = 128


def get_bwt_chunks(size: int) -> int:
    return 1 if size < BLOCK_SIZE_THRESHOLD1 else 8


# Held by a BWT forward on a card from its memory check to the end of
# its suffix array: a writer's jobs run the blocks' transforms on
# threads, and two peaks that each fit the card's free memory need not
# fit together. The card's stream runs them one after another anyway.
_CARD_LOCK = threading.Lock()


def _bwt_on_device(dev, n: int) -> bool:
    """True where a block of n bytes may take the card's suffix array:
    ops enabled, a CUDA device, at least BWT_DEVICE_MIN_BLOCK bytes.
    Whether its peak fits (_peak_fits) is asked under _CARD_LOCK."""
    return (ops.ENABLED and dev is not None and dev.type == "cuda"
            and n >= BWT_DEVICE_MIN_BLOCK)


def _peak_fits(dev, n: int) -> bool:
    """True where the card path's peak for n bytes (BWT_DEVICE_PEAK_PER_BYTE
    a byte) is within the memory the card has free, the caching
    allocator's idle part counted."""
    free, _ = torch.cuda.mem_get_info(dev)
    free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return n * BWT_DEVICE_PEAK_PER_BYTE <= free


def bwt_forward(src: np.ndarray, device=None):
    """Returns (bwt bytes, indexes). On a card (``device``, a CUDA
    device; None: the host), from BWT_DEVICE_MIN_BLOCK bytes on where the
    path's peak fits, the device suffix array (kanzi_tpu_torch/ops/
    bwt.py), one block at a time; else native SA-IS; without it, from
    4096 bytes on, the device suffix array on ``device`` (the CPU's torch
    ops there); else the host suffix array. The suffix array is unique,
    so the output is the same on every path. Counts the block's bytes
    under "bwt_forward_device_bytes" where it ran on a card, else
    "bwt_forward_host_bytes"."""
    n = len(src)
    if n > MAX_BLOCK_SIZE:
        raise ValueError("BWT: block too large")
    from kanzi_tpu_torch.ops import bwt as dbwt
    from kanzi_tpu_torch.utils import native as _native
    src = np.asarray(src, np.uint8)
    dev = None if device is None else torch.device(device)
    chunks = get_bwt_chunks(n)
    if n > 1 and _bwt_on_device(dev, n):
        with _CARD_LOCK:
            if _peak_fits(dev, n):
                ops.count("bwt_forward_device_bytes", n)
                out, idx = dbwt.bwt_forward(src, chunks, dev)
                return out, list(idx)
    if n > 1 and _native.sais_available():
        ops.count("bwt_forward_host_bytes", n)
        return _native.bwt_forward(src, chunks)
    if n >= 4096 and ops.ENABLED and dev is not None:
        ops.count("bwt_forward_device_bytes" if dev.type == "cuda"
                  else "bwt_forward_host_bytes", n)
        out, idx = dbwt.bwt_forward(src, chunks, dev)
        return out, list(idx)
    ops.count("bwt_forward_host_bytes", n)
    return compute_bwt(src, chunks)


def bwt_inverse(bwt: np.ndarray, indexes) -> np.ndarray:
    """Inverse via packed value+link walk (inverseMergeTPSI semantics,
    vectorized with pointer doubling). Only indexes[0] is required; the
    additional indexes enable parallel chunk decoding."""
    bwt = as_u8(bwt)
    count = len(bwt)
    if count <= 1:
        return bwt.copy()
    p_idx = indexes[0]
    if p_idx <= 0 or p_idx > count:
        raise ValueError("BWT: invalid primary index")
    from kanzi_tpu_torch.utils import native as _native
    if _native.sais_available():
        ok = all(0 < ix <= count for ix in indexes)
        return _native.bwt_inverse(bwt, indexes if ok else indexes[:1])
    # counting-sort positions by value (stable): buffer[j] = (link<<8)|val
    order = np.argsort(bwt, kind="stable")
    adj = np.arange(count, dtype=np.int64)
    adj[1:p_idx] -= 1  # positions 1..pIdx-1 link to i-1
    adj[0] = 0
    vals = bwt[order].astype(np.int64)
    links = adj[order]
    nxt = links
    pos = chain_walk(nxt, p_idx - 1, count)
    return vals[pos].astype(np.uint8)


class BWTBlockCodec(ByteTransform):
    """BWT + primary-index header (src/transform/BWTBlockCodec.cpp)."""

    def max_encoded_length(self, src_len: int) -> int:
        return src_len + 1 + 32  # mode + 8 indexes

    def forward(self, src: np.ndarray) -> Optional[np.ndarray]:
        src = as_u8(src)
        block_size = len(src)
        if block_size == 0:
            return src.copy()
        if block_size == 1:
            # BWT::forward copies single bytes; header still emitted
            log_block_size = 0
        else:
            log_block_size = log2(block_size)
        if block_size & (block_size - 1):
            log_block_size += 1
        p_index_size = (log_block_size + 7) >> 3
        if p_index_size <= 0 or p_index_size >= 5:
            return None
        chunks = get_bwt_chunks(block_size)
        log_nb_chunks = log2(chunks)
        if log_nb_chunks > 7:
            return None
        if block_size == 1:
            # BWT::forward copies single bytes; primary indexes stay 0
            out_bwt, indexes = src.copy(), [0]
        else:
            out_bwt, indexes = bwt_forward(src, block_device(self.ctx))
        mode = (log_nb_chunks << 2) | (p_index_size - 1)
        header = bytearray([mode])
        for i in range(chunks):
            pi = indexes[i] - 1 if i < len(indexes) else -1
            header += int(pi & ((1 << (8 * p_index_size)) - 1)).to_bytes(
                p_index_size, "big")
        return np.frombuffer(bytes(header) + out_bwt.tobytes(), dtype=np.uint8)

    def _inverse_legacy(self, src: np.ndarray, block_size: int):
        """bsVersion <= 5 layout (BWTBlockCodec.cpp:140-167): per chunk,
        1 mode byte whose top 2 bits give pIndexSizeBytes-1 and low 6
        bits the primary index's high bits, followed by the remaining
        index bytes; chunk count derives from the FULL block size."""
        chunks = get_bwt_chunks(block_size)
        indexes = []
        idx = 0
        remaining = block_size
        for _ in range(chunks):
            block_mode = int(src[idx])
            idx += 1
            p_index_bytes = 1 + ((block_mode >> 6) & 0x03)
            if remaining < p_index_bytes:
                raise ValueError("BWTBlockCodec: truncated legacy header")
            remaining -= p_index_bytes
            shift = (p_index_bytes - 1) << 3
            primary_index = (block_mode & 0x3F) << shift
            for _n in range(1, p_index_bytes):
                shift -= 8
                primary_index |= int(src[idx]) << shift
                idx += 1
            # legacy indexes are stored verbatim (no -1 bias)
            indexes.append(primary_index)
        if not all(0 < ix <= remaining for ix in indexes):
            raise ValueError("BWTBlockCodec: invalid legacy primary index")
        return bwt_inverse(src[idx:], indexes)

    def inverse_into(self, src: np.ndarray, out: np.ndarray):
        """Native packed-walk inverse straight into `out` (BWT output
        length == payload length, so the fit check is exact). Returns
        the length or None (fallback)."""
        src = as_u8(src)
        block_size = len(src)
        if block_size <= 1:
            return None
        from kanzi_tpu_torch.utils import native
        if not native.sais_available():
            return None
        if self.ctx.get_int("bsVersion", 6) <= 5:
            return None
        mode = int(src[0])
        log_nb_chunks = (mode >> 2) & 0x07
        p_index_size = (mode & 0x03) + 1
        chunks = 1 << log_nb_chunks
        header_size = 1 + chunks * p_index_size
        n = block_size - header_size
        if block_size < header_size or n > out.size or n <= 1:
            return None
        if chunks != get_bwt_chunks(n):
            raise ValueError("BWTBlockCodec: chunk count mismatch")
        indexes = []
        idx = 1
        for _ in range(chunks):
            pi = int.from_bytes(src[idx:idx + p_index_size].tobytes(),
                                "big")
            if pi >= 0x7FFFFFFF:
                raise ValueError("BWTBlockCodec: invalid primary index")
            indexes.append(pi + 1)
            idx += p_index_size
        if not all(0 < ix <= n for ix in indexes):
            indexes = indexes[:1]
        native.bwt_inverse(src[header_size:], indexes, out=out[:n])
        return n

    def inverse(self, src: np.ndarray) -> np.ndarray:
        src = as_u8(src)
        block_size = len(src)
        if block_size <= 1:
            if block_size == 0:
                return src.copy()
            raise ValueError("BWTBlockCodec: invalid block")
        bs_version = self.ctx.get_int("bsVersion", 6)
        if bs_version <= 5:
            return self._inverse_legacy(src, block_size)
        mode = int(src[0])
        log_nb_chunks = (mode >> 2) & 0x07
        p_index_size = (mode & 0x03) + 1
        chunks = 1 << log_nb_chunks
        header_size = 1 + chunks * p_index_size
        if block_size < header_size:
            raise ValueError("BWTBlockCodec: truncated header")
        if chunks != get_bwt_chunks(block_size - header_size):
            raise ValueError("BWTBlockCodec: chunk count mismatch")
        indexes = []
        idx = 1
        for _ in range(chunks):
            pi = int.from_bytes(src[idx:idx + p_index_size].tobytes(), "big")
            if pi >= 0x7FFFFFFF:
                raise ValueError("BWTBlockCodec: invalid primary index")
            indexes.append(pi + 1)
            idx += p_index_size
        return bwt_inverse(src[header_size:], indexes)
