"""The LZ match pass on a CUDA device: for every position of a block its
hash bucket, the previous position in the same bucket, and the common
prefix length with it, capped at CAP.

The PyTorch counterpart of kanzi_tpu/ops/lz.py (its lz_match_pass,
:108-117, is the contract). The LZX parse stays on the host, as in
kanzi_tpu (its module docstring gives the analysis). kanzi_tpu hands the
pass to a hinted stitch of the parse (opt-in, KANZI_TPU_LZ=1, a Python
loop) that keeps every parse decision, so its output equals the native
parse's. The port's LZ transform (transform/lz.py) hands it, on a card,
to a native parse that reads its hints (csrc/lzx_hint.cpp), with the
same bytes.

Kernel K (csrc/lz.cu): the hash, a stable least-significant-digit radix
sort of the keys ``bucket << 32 | position`` on the bucket's hash_log
bits alone (the positions arrive in order, so it gives kanzi_tpu's
``jax.lax.sort((h, pos), num_keys=1, is_stable=True)``), prev from the
sorted order, lcp in position order. The block is cut into tiles of
TILE positions; the sort runs in passes of one digit (digit_plan), each
of three kernels, and no host sync lies between any two of them:

- ``lz_count``: each tile's count of each digit value (pass 0 hashes the
  block, later passes read the keys); in the last pass also the key of
  each tile's last item of each value;
- ``lz_scan``: each value's offsets over the tiles and its total; in
  the last pass the key just before each tile's run of each value;
- ``lz_scatter``: the tile ranked stably and written out by value; the
  last pass writes no keys but prev, scattered once by position;
- ``lz_lcp``: a thread a position, the windows at i and prev[i], up to
  CAP bytes.

The block is padded with CAP + 8 zero bytes, as kanzi_tpu's _match_fn
pads it: the last 7 positions hash windows that run into the zeros, and
a match may run past the block's end into them.
"""

from __future__ import annotations

import numpy as np
import torch

import kanzi_tpu_torch.ops as _ops
from kanzi_tpu_torch.ops.ans import _check, _launch, _on_cpu, _to_numpy

HASH_SEED = 0x1E35A7BD
CAP = 32                       # lcp cap (a multiple of 8)
PAD = CAP + 8                  # zero bytes after the block
MAX_N = 1 << 31                # positions fit the key's low 32 bits
TILE = 8192                    # positions a tile of the sort (csrc/lz.cu)
MAX_DIGIT_BITS = 10            # a digit's values fit a tile's shared bins
_U32 = 0xFFFFFFFF


def padded_length(n: int) -> int:
    """The padded block's bytes: n + PAD rounded up to 8, plus one word,
    so that K's aligned 8-byte loads stay inside it."""
    return (n + PAD + 7) // 8 * 8 + 8


def pad_block(src, device) -> torch.Tensor:
    """src [n] uint8 (numpy) -> the zero-padded block [padded_length(n)]
    uint8 on ``device``: the n bytes copied in once (to a card through a
    pinned buffer, without blocking), the tail zeroed there."""
    src = np.asarray(src, np.uint8)
    n = len(src)
    dev = torch.device(device)
    pad = torch.empty(padded_length(n), dtype=torch.uint8, device=dev)
    pad[n:].zero_()
    if dev.type == "cpu":
        pad.numpy()[:n] = src
    else:
        staged = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        staged.numpy()[:] = src
        pad[:n].copy_(staged, non_blocking=True)
    return pad


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def digit_plan(hash_log: int) -> list:
    """The sort's passes over the bucket's hash_log bits, least significant
    first: [(shift, bits)], as few passes of at most MAX_DIGIT_BITS as
    cover them, the same bits each (16: 8 and 8; 19: 10 and 9 used)."""
    if not 1 <= hash_log <= 31:
        raise ValueError(f"hash_log {hash_log} outside [1, 31]")
    passes = -(-hash_log // MAX_DIGIT_BITS)
    bits = -(-hash_log // passes)
    return [(p * bits, bits) for p in range(passes)]


def block_keys_plain(pad, n: int, hash_log: int):
    """Each position's key [n] int64, bucket << 32 | position. (v << 24)
    mod 2^64 keeps bytes 0..4 of the window, so the bucket is (((b0 * S)
    >> 8) + (b1..b4) * S) mod 2^32 >> (32 - hash_log), with every product
    inside int64."""
    b = [pad[k:n + k].long() for k in range(5)]
    hi = b[1] | (b[2] << 8) | (b[3] << 16) | (b[4] << 24)
    h32 = (((b[0] * HASH_SEED) >> 8) + hi * HASH_SEED) & _U32
    pos = torch.arange(n, dtype=torch.int64, device=pad.device)
    return ((h32 >> (32 - hash_log)) << 32) | pos


def _digit(keys, hash_log: int, p: int):
    shift, bits = digit_plan(hash_log)[p]
    return ((keys >> 32) >> shift) & ((1 << bits) - 1)


def _prev_of_sorted(keys, n: int):
    """keys [n] int64 in the order of their buckets -> prev [n] int32 by
    position: the previous key's position where its bucket is the same,
    else -1."""
    pos = keys & _U32
    bucket = keys >> 32
    same = torch.zeros(n, dtype=torch.bool, device=keys.device)
    same[1:] = bucket[1:] == bucket[:-1]
    cand = torch.full((n,), -1, dtype=torch.int64, device=keys.device)
    cand[1:] = pos[:-1]
    return torch.empty(n, dtype=torch.int64, device=keys.device).scatter_(
        0, pos, torch.where(same, cand, -1)).to(torch.int32)


def lz_count_plain(pad, keys, n: int, hash_log: int, p: int):
    """Plain version of lz_count: (counts [2^bits, tiles] int32, each
    tile's count of each value of pass p's digit; last [2^bits, tiles]
    int64 in the last pass, the key of each tile's last item of each
    value, -1 for none, else None). keys None: pass 0's, from the
    block."""
    if keys is None:
        keys = block_keys_plain(pad, n, hash_log)
    plan = digit_plan(hash_log)
    r = 1 << plan[p][1]
    tiles = -(-n // TILE)
    idx = torch.arange(n, device=keys.device)
    flat = _digit(keys, hash_log, p) * tiles + idx // TILE
    counts = torch.bincount(flat, minlength=r * tiles).view(r, tiles)
    if p < len(plan) - 1:
        return counts.to(torch.int32), None
    top = torch.full((r * tiles,), -1, dtype=torch.int64,
                     device=keys.device).scatter_reduce_(0, flat, idx, "amax")
    last = torch.where(top >= 0, keys[top.clamp(min=0)], -1)
    return counts.to(torch.int32), last.view(r, tiles)


def lz_scan_plain(counts, last):
    """Plain version of lz_scan: (offs [2^bits, tiles] int32, each value's
    exclusive sum of counts over the tiles; totals [2^bits] int32; pred
    [2^bits, tiles] int64 where last is given, the last key of the
    latest earlier tile that holds the value, -1 for none, else None)."""
    offs = (counts.cumsum(1) - counts).to(torch.int32)
    totals = counts.sum(1).to(torch.int32)
    if last is None:
        return offs, totals, None
    r, tiles = counts.shape
    t = torch.arange(tiles, device=counts.device).expand(r, tiles)
    held = torch.where(counts > 0, t, -1).cummax(1).values
    before = torch.cat([torch.full((r, 1), -1, dtype=held.dtype,
                                   device=held.device), held[:, :-1]], 1)
    pred = torch.where(before >= 0, last.gather(1, before.clamp(min=0)), -1)
    return offs, totals, pred


def lz_scatter_plain(pad, keys, n: int, hash_log: int, p: int):
    """Plain version of lz_scatter, one stable pass on pass p's digit: the
    keys (None: the block's) in torch.sort(digit, stable=True)'s order
    [n] int64; in the last pass prev [n] int32 by position from that
    order. It needs nothing of lz_scan, whose offsets and keys the kernel
    reads."""
    if keys is None:
        keys = block_keys_plain(pad, n, hash_log)
    out = keys[torch.sort(_digit(keys, hash_log, p), stable=True).indices]
    if p < len(digit_plan(hash_log)) - 1:
        return out
    return _prev_of_sorted(out, n)


def lz_lcp_plain(pad, prev, n: int):
    """Plain version of lz_lcp: lcp [n] int32 by position, CAP shifted
    byte compares of the padded block at i and at prev[i], 0 where prev
    is -1."""
    bi = pad.long()
    j = prev.long().clamp(min=0)
    run = torch.ones(n, dtype=torch.int64, device=pad.device)
    lcp = torch.zeros(n, dtype=torch.int64, device=pad.device)
    for t in range(CAP):
        run = run * (bi[t:n + t] == bi[j + t])
        lcp = lcp + run
    return torch.where(prev >= 0, lcp, 0).to(torch.int32)


def match_pass_plain(src, hash_log: int):
    """The plain match pass: src [n] uint8 tensor (any device) ->
    (prev, lcp) [n] int32 tensors on its device. The keys of the block,
    one torch.sort of them (unique, so stable by bucket then position),
    the previous key in the same bucket, and CAP shifted compares."""
    n = src.numel()
    pad = torch.zeros(padded_length(n), dtype=torch.uint8, device=src.device)
    pad[:n] = src
    keys = torch.sort(block_keys_plain(pad, n, hash_log)).values
    prev = _prev_of_sorted(keys, n)
    return prev, lz_lcp_plain(pad, prev, n)


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


def _check_pass(pad, keys, n: int, hash_log: int, p: int) -> tuple:
    """Checks of lz_count's and lz_scatter's arguments; returns (shift,
    bits, last pass or not)."""
    plan = digit_plan(hash_log)
    if not 0 <= p < len(plan):
        raise ValueError(f"pass {p}: hash_log {hash_log} sorts in "
                         f"{len(plan)} passes")
    _check_pad(pad, n, pad.device)
    if keys is None and p > 0:
        raise ValueError("keys: only pass 0 hashes the block itself")
    if keys is not None:
        _check("keys", keys, torch.int64, (n,), pad.device)
    return (*plan[p], p == len(plan) - 1)


def _check_positions(name: str, pos, lo: int, n: int) -> None:
    """The kernels write and read at positions they are given: each must
    lie in [lo, n) (a reduction and a host sync: not on the pass's
    path)."""
    if bool(((pos < lo) | (pos >= n)).any()):
        raise ValueError(f"{name}: a position outside [{lo}, {n})")


def lz_count(pad, keys, n: int, hash_log: int, p: int):
    """Pass p's counts (lz_count_plain). pad [padded_length(n)] uint8,
    the block zero-padded (pad_block); keys [n] int64, the previous
    pass's output, or None in pass 0."""
    dev = pad.device
    shift, bits, final = _check_pass(pad, keys, n, hash_log, p)
    if _on_cpu("lz_count", dev):
        return lz_count_plain(pad, keys, n, hash_log, p)
    shape = (1 << bits, -(-n // TILE))
    counts = torch.empty(shape, dtype=torch.int32, device=dev)
    last = torch.empty(shape, dtype=torch.int64, device=dev) if final else None
    _launch("lz_count", dev, pad, keys, n, hash_log, shift, bits, counts,
            last)
    return counts, last


def lz_scan(counts, last):
    """The offsets of a pass (lz_scan_plain). counts [2^bits, tiles]
    int32 and last (None but in the last pass) from lz_count."""
    dev = counts.device
    r, tiles = counts.shape
    bits = r.bit_length() - 1
    if r != 1 << bits or not 1 <= bits <= MAX_DIGIT_BITS or tiles < 1:
        raise ValueError(f"counts: shape {tuple(counts.shape)} is not "
                         f"[2^bits, tiles], bits in [1, {MAX_DIGIT_BITS}]")
    _check("counts", counts, torch.int32, (r, tiles), dev)
    if last is not None:
        _check("last", last, torch.int64, (r, tiles), dev)
    if _on_cpu("lz_scan", dev):
        return lz_scan_plain(counts, last)
    offs = torch.empty_like(counts)
    totals = torch.empty(r, dtype=torch.int32, device=dev)
    pred = None if last is None else torch.empty_like(last)
    _launch("lz_scan", dev, counts, last, bits, tiles, offs, totals, pred)
    return offs, totals, pred


def lz_scatter(pad, keys, n: int, hash_log: int, p: int, offs, totals,
               pred, check: bool = True):
    """Pass p (lz_scatter_plain): the keys (None in pass 0: the block's)
    stably by the digit, [n] int64, at lz_scan's offsets; in the last pass
    prev [n] int32 by position, from lz_scan's pred. With check, the
    keys' positions must lie in [0, n): the last pass writes prev there."""
    dev = pad.device
    shift, bits, final = _check_pass(pad, keys, n, hash_log, p)
    r, tiles = 1 << bits, -(-n // TILE)
    _check("offs", offs, torch.int32, (r, tiles), dev)
    _check("totals", totals, torch.int32, (r,), dev)
    if final:
        if pred is None:
            raise ValueError("pred: the last pass takes lz_scan's pred")
        _check("pred", pred, torch.int64, (r, tiles), dev)
    elif pred is not None:
        raise ValueError("pred: only the last pass takes it")
    if check and keys is not None:
        _check_positions("keys", keys & _U32, 0, n)
    if _on_cpu("lz_scatter", dev):
        return lz_scatter_plain(pad, keys, n, hash_log, p)
    out = prev = None
    if final:
        prev = torch.empty(n, dtype=torch.int32, device=dev)
    else:
        out = torch.empty(n, dtype=torch.int64, device=dev)
    _launch("lz_scatter", dev, pad, keys, n, hash_log, shift, bits, offs,
            totals, pred, out, prev)
    return prev if final else out


def lz_lcp(pad, prev, n: int, check: bool = True):
    """lcp [n] int32 by position (lz_lcp_plain). pad as for lz_count;
    prev [n] int32, each -1 or a position in [0, n) (checked with
    check: the kernel reads the block there)."""
    dev = pad.device
    _check_pad(pad, n, dev)
    _check("prev", prev, torch.int32, (n,), dev)
    if dev.type == "cuda" and prev.data_ptr() % 16:
        raise ValueError("prev: the kernel reads 4 positions at once; the "
                         "tensor must start on a 16-byte boundary")
    if check:
        _check_positions("prev", prev, -1, n)
    if _on_cpu("lz_lcp", dev):
        return lz_lcp_plain(pad, prev, n)
    lcp = torch.empty(n, dtype=torch.int32, device=dev)
    _launch("lz_lcp", dev, pad, prev, n, lcp)
    return lcp


def match_pass_kernels(pad, n: int, hash_log: int):
    """K's pass over the padded block: (prev, lcp) [n] int32 tensors on
    its device. Each pass of digit_plan counts, scans and scatters; then
    lcp. On a card every step is a kernel and none waits for the host; on
    the CPU every step is its plain version."""
    keys = None
    for p in range(len(digit_plan(hash_log))):
        counts, last = lz_count(pad, keys, n, hash_log, p)
        offs, totals, pred = lz_scan(counts, last)
        keys = lz_scatter(pad, keys, n, hash_log, p, offs, totals, pred,
                          check=False)
    return keys, lz_lcp(pad, keys, n, check=False)


def lz_match_pass(src: np.ndarray, hash_log: int, device,
                  lcp_dtype=np.int32):
    """The match pass over one block on ``device``. src [n] uint8.
    Returns (prev [n] int32, lcp [n] lcp_dtype capped at CAP) as numpy:
    prev[i] the latest j < i whose window hashes to i's bucket (-1 if
    none), lcp[i] the common prefix of the padded block at i and at
    prev[i] (0 where prev is -1). On a card match_pass_kernels (counted
    as lz_match_pass); on the CPU match_pass_plain (lz_match_pass_plain).
    kanzi_tpu.ops.lz.lz_match_pass's contract; lcp_dtype np.uint8 (the
    LZ transform's, CAP fits a byte) brings lcp back from the card as a
    quarter of the bytes."""
    dev = torch.device(device)
    src = np.asarray(src, np.uint8)
    n = len(src)
    digit_plan(hash_log)                  # raises outside [1, 31]
    if lcp_dtype not in (np.int32, np.uint8):
        raise ValueError(f"lcp_dtype {lcp_dtype}: np.int32 or np.uint8")
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, lcp_dtype)
    if _on_cpu("lz_match_pass", dev):
        prev, lcp = match_pass_plain(torch.from_numpy(src.copy()), hash_log)
        return prev.numpy(), lcp.numpy().astype(lcp_dtype, copy=False)
    prev, lcp = match_pass_kernels(pad_block(src, dev), n, hash_log)
    if lcp_dtype == np.uint8:
        lcp = lcp.to(torch.uint8)
    _ops.count("lz_match_pass")
    return _to_numpy(dev, prev, lcp)
