"""Batched order-1 interleaved 4-lane rANS encode on a CUDA device.

The PyTorch counterpart of kanzi_tpu/ops/ans1.py, bit-exact with it and
with the reference coder (src/entropy/ANSRangeEncoder.{cpp,hpp}, order
1): chunk = 16384 << 8 = 4 MiB, log range 11, 4 lanes, lane k walking
quarter k of the chunk backwards over (prev << 8 | cur) pair indexes
into the chunk's [256 x 256] frequency tables; the last step of each
lane is (prev = 0, the quarter's first byte).

Plain PyTorch does what the JAX package left to XLA and the host: the
packed per-chunk encode table (``f | cum << 12`` per pair, the value the
TPU split into bf16 byte planes for its one-hot MXU gather), the pair
indexes and the per-row flag counts. Two hand-written CUDA kernels
(csrc/ans1.cu) do the rest, each behind a wrapper with a plain PyTorch
version beside it, and both behind ``ans1_encode_scan``:

- ``ans1_gather`` (F1): the table gather and the invFreq lookup, every
  step's encode constants packed into one 8-byte word (Pallas
  ``_ans1_gather_kernel``);
- ``ans1_chain`` (F2): the 4-lane backward scan over those words, the
  lanes of 8 chunks a warp (Pallas ``_ans1_scan_kernel``).

The renorm slots then go through kanzi_tpu_torch.ops.ans.compact_rows
(kernel B) in rows of 16384, as for ANS0. Decode stays on the host's
native coder, as in kanzi_tpu (see the analysis in its ops/ans1.py).
"""

from __future__ import annotations

import numpy as np
import torch

from kanzi_tpu_torch.ops.ans import (ANS_TOP, CHUNK, _U32, _bit_length,
                                     _check, _launch, _on_cpu, _u32_bits,
                                     compact_rows)

LOG_RANGE1 = 11
SCALE1 = 1 << LOG_RANGE1          # 2048
CHUNK1 = 16384 << 8               # 4 MiB full order-1 chunk
TABLE1 = 256 * 256                # (prev, cur) pairs
ROW = CHUNK                       # compaction row: 16384 slots


def _build_inv_lut() -> torch.Tensor:
    """inv[f] = ANSEncSymbol invFreq for frequency f (0..2048) as u32
    bits in int32: ceil(2^(31 + shift) / f) with shift = ceil(log2 f),
    and all ones for f < 2."""
    f = np.arange(SCALE1 + 1, dtype=np.uint64)
    fx = np.maximum(f, 2)
    shift = np.zeros_like(f)
    for i in range(13):
        shift += (fx - 1) >= (1 << i)
    inv = ((np.uint64(1) << (shift + np.uint64(31))) + fx - np.uint64(1)) // fx
    inv = np.where(f < 2, 0xFFFFFFFF, inv).astype(np.uint32)
    return torch.from_numpy(inv.view(np.int32).copy())


INV_LUT = _build_inv_lut()


def encode_table(freqs: torch.Tensor) -> torch.Tensor:
    """[C, 256, 256] normalized order-1 freqs (ctx, sym) -> [C, 65536]
    int32 table of f | cum << 12 at prev << 8 | cur, f clamped to
    SCALE1 - 1 as the reference's encode tables do."""
    f = freqs.long().clamp(max=SCALE1 - 1)
    cum = f.cumsum(2) - f
    return (f | (cum << 12)).view(f.shape[0], TABLE1).to(torch.int32)


def build_sym_idx(chunks: torch.Tensor) -> torch.Tensor:
    """chunks [C, 4q] uint8 -> [C, 4q] int32 pair indexes in encode
    order, position step * 4 + lane: lane k walks quarter k backwards
    over (ctx << 8 | sym) pairs, its last step is (0, quarter[0])."""
    c, n = chunks.shape
    q = n // 4
    a = chunks.view(c, 4, q).long()
    main = (a[:, :, :q - 1].flip(2) << 8) | a[:, :, 1:].flip(2)
    idx = torch.cat([main, a[:, :, :1]], 2)          # [C, 4, q], steps last
    return idx.transpose(1, 2).reshape(c, n).to(torch.int32)


# ---------------------------------------------------------------------------
# F. encode scan: F1 (gather) and F2 (chain)
# ---------------------------------------------------------------------------

def ans1_gather_plain(chunks, table, lut):
    """Plain version of the ans1_gather kernel (F1): the table gather in
    one torch.gather, then each step's encode constants packed into one
    word, inv | ((shift - 1) | bias << 5 | cmplFreq << 18) << 32.
    Returns [C, q, 4] int64, step-major, lanes last."""
    c, n = chunks.shape
    val = table.long().gather(1, build_sym_idx(chunks).long()).view(
        c, n // 4, 4)
    f, cum = val & 0xFFF, val >> 12
    small = f < 2
    sp = torch.where(small, 1, _bit_length(f.clamp(min=2) - 1))
    bias = torch.where(small, cum + SCALE1 - 1, cum)
    hi = (sp - 1) | (bias << 5) | ((SCALE1 - f) << 18)
    return (lut.long() & _U32)[f] | (hi << 32)


def ans1_chain_plain(consts):
    """Plain version of the ans1_chain kernel (F2): a Python loop over
    the q steps on [C, 4] tensors. consts [C, q, 4] int64 (ans1_gather).
    Returns (states [C, 4] int32 u32 bits, vm [C, 4q] int32)."""
    c, q, _ = consts.shape
    iv = consts & _U32
    hi = consts >> 32
    sh, bias, cmpl = hi & 31, (hi >> 5) & 0x1FFF, hi >> 18
    xmax = (SCALE1 - cmpl) << (31 - LOG_RANGE1)
    st = torch.full((c, 4), ANS_TOP, dtype=torch.int64, device=consts.device)
    slots = torch.empty((c, q, 4), dtype=torch.int64, device=consts.device)
    for t in range(q):
        flag = st >= xmax[:, t]
        slots[:, t] = ((flag.long() << 16) | ((st & 0xFF) << 8)
                       | ((st >> 8) & 0xFF))
        st = torch.where(flag, st >> 16, st)
        st = st + bias[:, t] + (((st * iv[:, t]) >> 32) >> sh[:, t]
                                ) * cmpl[:, t]
    # emission order: reversed steps x reversed lanes
    vm = slots.flip(1, 2).reshape(c, 4 * q)
    return _u32_bits(st), vm.to(torch.int32)


def ans1_gather(chunks, table, lut):
    """F1. chunks [C, 4q] uint8 (4q a multiple of 16384); table
    [C, 65536] int32 (encode_table); lut [2049] int32 (INV_LUT).
    Returns consts [C, q, 4] int64, the packed encode constants of each
    step and lane (ans1_gather_plain)."""
    c, n = chunks.shape
    dev = chunks.device
    if n == 0 or n % ROW:
        raise ValueError(f"chunks: length {n} is not a positive multiple "
                         f"of {ROW}")
    _check("chunks", chunks, torch.uint8, (c, n), dev)
    _check("table", table, torch.int32, (c, TABLE1), dev)
    _check("lut", lut, torch.int32, (SCALE1 + 1,), dev)
    if _on_cpu("ans1_gather", dev):
        return ans1_gather_plain(chunks, table, lut)
    if c and int((table & 0xFFF).max()) > SCALE1:
        raise ValueError(f"table: a frequency above {SCALE1} (the LUT's "
                         "last entry)")
    consts = torch.empty((c, n // 4, 4), dtype=torch.int64, device=dev)
    _launch("ans1_gather", dev, chunks, table, lut, c, n // 4, consts)
    return consts


def ans1_chain(consts):
    """F2. consts [C, q, 4] int64 (ans1_gather; q a multiple of 4096).
    Returns (states [C, 4] int32 final lane states as u32 bits, vm
    [C, 4q] int32 renorm slots flag<<16 | lo<<8 | hi in emission order,
    the layout of kernel A's vm)."""
    c, q, _ = consts.shape
    dev = consts.device
    if q == 0 or q % (ROW // 4):
        raise ValueError(f"consts: {q} steps is not a positive multiple "
                         f"of {ROW // 4}")
    _check("consts", consts, torch.int64, (c, q, 4), dev)
    if _on_cpu("ans1_chain", dev):
        return ans1_chain_plain(consts)
    states = torch.empty((c, 4), dtype=torch.int32, device=dev)
    vm = torch.empty((c, 4 * q), dtype=torch.int32, device=dev)
    _launch("ans1_chain", dev, consts, c, q, states, vm)
    return states, vm


def ans1_encode_scan(chunks, table, lut):
    """chunks [C, 4q] uint8 (4q a multiple of 16384); table [C, 65536]
    int32 (encode_table); lut [2049] int32 (INV_LUT).

    Returns (states [C, 4] int32 final lane states as u32 bits, vm
    [C, 4q] int32 renorm slots flag<<16 | lo<<8 | hi in emission order,
    the layout of kernel A's vm): F1, then F2, their 8-byte-a-symbol
    scratch freed on return."""
    return ans1_chain(ans1_gather(chunks, table, lut))


# ---------------------------------------------------------------------------
# batch entry point
# ---------------------------------------------------------------------------

def ans1_encode_batch(chunks: torch.Tensor, freqs):
    """chunks [C, 4q] uint8 on the coding device; freqs [C, 256, 256]
    normalized order-1 frequencies (numpy or tensor).

    Returns (states [C, 4] int32 u32 bits, flat uint8 payload, plen
    [C] int64 payload bytes). Chunk c's payload is flat[off[c] : off[c] +
    plen[c]] with off the exclusive cumsum of plen, its renorm pairs in
    payload order (hi, lo): the contract of kanzi_tpu.ops.ans1
    .ans1_encode_batch, whose flat u16 slots the host byteswaps."""
    c = chunks.shape[0]
    dev = chunks.device
    if not isinstance(freqs, torch.Tensor):
        freqs = torch.from_numpy(np.ascontiguousarray(freqs, np.int64))
    freqs = freqs.to(dev)
    states, vm = ans1_encode_scan(chunks, encode_table(freqs),
                                  INV_LUT.to(dev))
    rows = vm.view(-1, ROW)
    plen16 = ((rows >> 16) & 1).sum(1)
    off16 = plen16.cumsum(0) - plen16
    flat = compact_rows(rows, off16, int(plen16.sum()))
    return states, flat, 2 * plen16.view(c, -1).sum(1)
