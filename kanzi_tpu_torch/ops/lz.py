"""The LZ match pass on a CUDA device: for every position of a block its
hash bucket, the previous position in the same bucket, and the common
prefix length with it, capped at CAP.

The PyTorch counterpart of kanzi_tpu/ops/lz.py (its lz_match_pass,
:108-117, is the contract). The LZX parse stays on the host, as in
kanzi_tpu (its module docstring gives the analysis). kanzi_tpu hands the
pass to a hinted stitch of the parse (opt-in, KANZI_TPU_LZ=1) that keeps
every parse decision, so its output equals the native parse's; that
stitch is a Python loop, ~100x slower than the native parse, so the
port's parse (transform/lz.py) stays the native one and the pass is an
entry point of its own until a native stitch reads its hints.

Kernel K (csrc/lz.cu), two kernels around one library sort:

- ``lz_hash`` (K1): one thread a position, the little-endian 8-byte
  window of the zero-padded block, the reference hash
  ``((w << 24) * 0x1E35A7BD) >> (64 - hash_log)`` exact in 64 bits (the
  TPU needed 32-bit limbs for it, kanzi_tpu/ops/lz.py:58-76), and the
  key ``bucket << 32 | position``;
- ``torch.sort`` of the keys: they are unique, so their order is the
  stable order by (bucket, position) of kanzi_tpu's ``jax.lax.sort``;
- ``lz_prev_lcp`` (K2): one thread a sorted key, the previous key's
  position where its bucket is the same (else -1), and the prefix length
  from 8-byte windows of the padded block, stopping at the first
  differing byte or at CAP.

The block is padded with CAP + 8 zero bytes, as kanzi_tpu's _match_fn
pads it: the last 7 positions hash windows that run into the zeros, and
a match may run past the block's end into them.
"""

from __future__ import annotations

import numpy as np
import torch

import kanzi_tpu_torch.ops as _ops
from kanzi_tpu_torch.ops.ans import (_check, _launch, _on_cpu, _to_device,
                                     _to_numpy)

HASH_SEED = 0x1E35A7BD
CAP = 32                       # lcp cap (a multiple of 8)
PAD = CAP + 8                  # zero bytes after the block
MAX_N = 1 << 31                # positions fit the key's low 32 bits
_U32 = 0xFFFFFFFF


def padded_length(n: int) -> int:
    """The padded block's bytes: n + PAD rounded up to 8, plus one word,
    so that K's aligned 8-byte loads stay inside it."""
    return (n + PAD + 7) // 8 * 8 + 8


def pad_block(src, device) -> torch.Tensor:
    """src [n] uint8 (numpy) -> the zero-padded block [padded_length(n)]
    uint8 on ``device``."""
    src = np.asarray(src, np.uint8)
    buf = np.zeros(padded_length(len(src)), np.uint8)
    buf[:len(src)] = src
    return _to_device(buf, np.uint8, torch.device(device))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def lz_hash_plain(pad, n: int, hash_log: int):
    """Plain version of lz_hash (K1): keys [n] int64, bucket << 32 |
    position. (v << 24) mod 2^64 keeps bytes 0..4 of the window, so the
    bucket is (((b0 * S) >> 8) + (b1..b4) * S) mod 2^32 >> (32 -
    hash_log), with every product inside int64."""
    b = [pad[k:n + k].long() for k in range(5)]
    hi = b[1] | (b[2] << 8) | (b[3] << 16) | (b[4] << 24)
    h32 = (((b[0] * HASH_SEED) >> 8) + hi * HASH_SEED) & _U32
    pos = torch.arange(n, dtype=torch.int64, device=pad.device)
    return ((h32 >> (32 - hash_log)) << 32) | pos


def lz_prev_lcp_plain(pad, keys, n: int):
    """Plain version of lz_prev_lcp (K2): keys [n] int64 sorted. The
    previous key's position where it shares the bucket, then CAP shifted
    byte compares. Returns (prev, lcp) [n] int32 by position."""
    dev = pad.device
    pos = keys & _U32
    bucket = keys >> 32
    same = torch.zeros(n, dtype=torch.bool, device=dev)
    same[1:] = bucket[1:] == bucket[:-1]
    cand = torch.full((n,), -1, dtype=torch.int64, device=dev)
    cand[1:] = pos[:-1]
    prev = torch.empty(n, dtype=torch.int64, device=dev).scatter_(
        0, pos, torch.where(same, cand, -1))
    bi = pad.long()
    j = prev.clamp(min=0)
    run = torch.ones(n, dtype=torch.int64, device=dev)
    lcp = torch.zeros(n, dtype=torch.int64, device=dev)
    for t in range(CAP):
        run = run * (bi[t:n + t] == bi[j + t])
        lcp = lcp + run
    lcp = torch.where(prev >= 0, lcp, 0)
    return prev.to(torch.int32), lcp.to(torch.int32)


def match_pass_plain(src, hash_log: int):
    """The plain match pass: src [n] uint8 tensor (any device) ->
    (prev, lcp) [n] int32 tensors on its device. The same hash, then
    torch.sort(stable=True) of the keys, then the previous item in the
    same bucket and CAP shifted compares."""
    n = src.numel()
    pad = torch.zeros(padded_length(n), dtype=torch.uint8, device=src.device)
    pad[:n] = src
    keys = torch.sort(lz_hash_plain(pad, n, hash_log), stable=True).values
    return lz_prev_lcp_plain(pad, keys, n)


def match_pass_np(src: np.ndarray, hash_log: int):
    """numpy model of the pass, kanzi_tpu/ops/lz.py:120-147, for the
    tests: the same contract as lz_match_pass."""
    n = len(src)
    padded = np.concatenate([src, np.zeros(8, np.uint8)]).astype(np.uint64)
    w = np.zeros(n, np.uint64)
    for k in range(8):
        w |= padded[k:n + k] << np.uint64(8 * k)
    h = ((((w << np.uint64(24)) & np.uint64((1 << 64) - 1))
          * np.uint64(HASH_SEED)) & np.uint64((1 << 64) - 1)) \
        >> np.uint64(64 - hash_log)
    last = {}
    prev = np.full(n, -1, np.int32)
    for i in range(n):
        key = int(h[i])
        if key in last:
            prev[i] = last[key]
        last[key] = i
    bp = np.concatenate([src, np.zeros(CAP + 8, np.uint8)])
    lcp = np.zeros(n, np.int32)
    for i in range(n):
        if prev[i] < 0:
            continue
        j = prev[i]
        t = 0
        while t < CAP and bp[i + t] == bp[j + t]:
            t += 1
        lcp[i] = t
    return prev, lcp


# ---------------------------------------------------------------------------
# K. the kernels
# ---------------------------------------------------------------------------

def _check_pad(pad, n: int, dev) -> None:
    if not 0 < n < MAX_N:
        raise ValueError(f"n {n}: a block of 1 to {MAX_N - 1} bytes")
    _check("pad", pad, torch.uint8, (padded_length(n),), dev)
    if dev.type == "cuda" and pad.data_ptr() % 8:
        raise ValueError("pad: the kernel reads 8-byte words; the tensor "
                         "must start on an 8-byte boundary")


def lz_hash(pad, n: int, hash_log: int):
    """K1. pad [padded_length(n)] uint8, the block zero-padded
    (pad_block); hash_log in [1, 31], so that a key stays positive.
    Returns keys [n] int64, bucket << 32 | position (lz_hash_plain)."""
    dev = pad.device
    if not 1 <= hash_log <= 31:
        raise ValueError(f"hash_log {hash_log} outside [1, 31]")
    _check_pad(pad, n, dev)
    if _on_cpu("lz_hash", dev):
        return lz_hash_plain(pad, n, hash_log)
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    _launch("lz_hash", dev, pad, n, hash_log, keys)
    return keys


def lz_prev_lcp(pad, keys, n: int):
    """K2. pad as for lz_hash; keys [n] int64, lz_hash's keys sorted.
    Returns (prev, lcp) [n] int32 by position (lz_prev_lcp_plain)."""
    dev = pad.device
    _check_pad(pad, n, dev)
    _check("keys", keys, torch.int64, (n,), dev)
    # the kernel writes prev and lcp at each key's position and reads
    # the block there: every position must lie in [0, n)
    if bool(((keys < 0) | ((keys & _U32) >= n)).any()):
        raise ValueError(f"keys: a position outside [0, {n})")
    if _on_cpu("lz_prev_lcp", dev):
        return lz_prev_lcp_plain(pad, keys, n)
    prev = torch.empty(n, dtype=torch.int32, device=dev)
    lcp = torch.empty(n, dtype=torch.int32, device=dev)
    _launch("lz_prev_lcp", dev, pad, keys, n, prev, lcp)
    return prev, lcp


def lz_match_pass(src: np.ndarray, hash_log: int, device):
    """The match pass over one block on ``device``. src [n] uint8.
    Returns (prev [n] int32, lcp [n] int32 capped at CAP) as numpy:
    prev[i] the latest j < i whose window hashes to i's bucket (-1 if
    none), lcp[i] the common prefix of the padded block at i and at
    prev[i] (0 where prev is -1). On a card K1, the sort and K2 (counted
    as lz_match_pass); on the CPU match_pass_plain (lz_match_pass_plain).
    kanzi_tpu.ops.lz.lz_match_pass's contract."""
    dev = torch.device(device)
    src = np.asarray(src, np.uint8)
    n = len(src)
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    if _on_cpu("lz_match_pass", dev):
        prev, lcp = match_pass_plain(torch.from_numpy(src.copy()), hash_log)
        return prev.numpy(), lcp.numpy()
    pad = pad_block(src, dev)
    keys = torch.sort(lz_hash(pad, n, hash_log)).values
    prev, lcp = lz_prev_lcp(pad, keys, n)
    _ops.count("lz_match_pass")
    return _to_numpy(dev, prev, lcp)
