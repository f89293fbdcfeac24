"""Batched SBRT (MTF / RANK / TIMESTAMP) forward and inverse on a CUDA
device.

The PyTorch counterpart of kanzi_tpu/ops/sbrt.py, byte-exact with it and
with the host transform (kanzi_tpu_torch/transform/sbrt.py,
src/transform/SBRT.cpp:22-145). The transform is a sequential
256-symbol rank automaton: per byte i of symbol c, qc = ((i & m1) +
(p[c] & m2)) >> shift; c moves to rank 1 + the largest rank j below its
own whose symbol has q > qc (0 if none), the symbols in between move up
one, and p[c] = i, q[c] = qc. The forward emits c's old rank, the
inverse reads a rank and emits the symbol holding it. Each block runs
its own automaton, so the batch axis is the blocks: the reference's
parallel model (one task per block, src/io/CompressedOutputStream.cpp:
476-540).

Kept from kanzi_tpu: bytes past a block's length pass through
unchanged. Not kept: the TPU's 16-block groups, 2048-byte windows and
big-endian word packing (bytes go in and come out).

The forward is cut into segments of ``segment`` bytes that run side by
side: the rank list stays sorted by q, highest first (qc never falls
below c's old q), and among equal q the symbol moved last ranks first,
so the state before any byte is a function of each symbol's last two
positions before it (``segment_states``), and each segment's automaton
starts from its own entry state. The inverse's state depends on the
symbols it decodes, so it runs one chain a block.

Four hand-written CUDA kernels (csrc/sbrt.cu) replace Pallas
``_sbrt_kernel``: the forward's ``sbrt_occ`` and ``sbrt_entry``
(``segment_states``, plain version ``segment_states_plain``) and
``sbrt_fwd``, and the inverse's ``sbrt_inv``; ``sbrt_plain`` is the
plain version of the automaton. On the CPU the wrapper runs the same
decomposition on the plain versions. The device level-5 chain
(kanzi_tpu_torch/parallel/pipeline.py) runs RANK, mode 2, through
``sbrt`` in both directions; the host transform keeps the native
automaton.
"""

from __future__ import annotations

import numpy as np
import torch

import kanzi_tpu_torch.ops as _ops
from kanzi_tpu_torch.ops.ans import _check, _host_tensor, _launch, _on_cpu

MODE_MTF, MODE_RANK, MODE_TIMESTAMP = 1, 2, 3
_MODES = {1: (-1, 0, 0), 2: (-1, -1, 1), 3: (0, -1, 0)}   # (m1, m2, shift)
MAX_LEN = 1 << 24            # the kernels pack p (< length) and a symbol
                             # into 32 bits
SEGMENT = 16 << 10           # the forward's segment: 16 blocks of 4 MiB
                             # make 4096 warps for 132 SMs


def segment_states_plain(blocks, lens, mode: int, segment: int):
    """Plain version of the sbrt_occ and sbrt_entry kernels: each
    segment's entry state as torch ops. Returns (p, q, seen), each
    [B, nseg, 256] int64 / int64 / bool: a symbol's last position before
    the segment (0 if none), its q, and whether it occurred at all
    (a symbol seen only at position 0 has p = 0 too, yet ranks above
    the unseen ones)."""
    b, L = blocks.shape
    dev = blocks.device
    nseg = max(1, -(-L // segment))
    x = blocks.long()
    idx = torch.arange(L, device=dev).expand(b, L)
    live = idx < lens.long()[:, None]
    # each position's previous position of the same symbol (-1: none)
    order = (x * L + idx).argsort(dim=1)
    sx = x.gather(1, order)
    before = torch.cat([torch.full_like(sx[:, :1], -1), sx[:, :-1]], 1)
    prev_sorted = torch.cat([torch.full_like(order[:, :1], -1),
                             order[:, :-1]], 1)
    prev_of = torch.empty_like(order).scatter_(
        1, order, torch.where(sx == before, prev_sorted, -1))
    # last position of each symbol in each segment, then before each one
    last = torch.full((b, nseg * 256), -1, dtype=torch.int64, device=dev)
    slot = torch.where(live, (idx // segment) * 256 + x, 0)
    last.scatter_reduce_(1, slot, torch.where(live, idx, -1), "amax")
    last = last.view(b, nseg, 256).cummax(1).values
    last = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], 1)
    prev = torch.where(
        last >= 0, prev_of.gather(1, last.clamp(min=0).view(b, -1)).view(
            b, nseg, 256), -1)
    # q from the last two positions (0 for a symbol not seen)
    m1, m2, shift = _MODES[mode]
    q = ((last.clamp(min=0) & m1) + (prev.clamp(min=0) & m2)) >> shift
    return last.clamp(min=0), q, last >= 0


def entry_ranks(p, q, seen):
    """Each symbol's rank from an entry state ([..., 256] each): the
    count of symbols with a greater key (q, seen, p, -symbol)."""
    syms = torch.arange(256, device=p.device)
    key = (q << 34) | (seen.long() << 33) | (p << 8) | (255 - syms)
    order = key.argsort(dim=-1, descending=True)
    return torch.empty_like(order).scatter_(
        -1, order, syms.expand_as(order).contiguous())


def sbrt_plain(blocks, lens, mode: int, inverse: bool, *, state=None,
               start=None):
    """Plain version of the automaton: a Python loop over the bytes on
    [B, 256] state (each symbol's rank, p and q), as the Pallas kernel
    steps it. ``state`` (p, q, seen), [B, 256] each, is each row's entry
    state, whose ranks are built as sbrt_fwd builds them (entry_ranks);
    ``start`` [B] the position of each row's first byte in its block.
    By default each row is a whole block from the standard state."""
    b, L = blocks.shape
    dev = blocks.device
    m1, m2, shift = _MODES[mode]
    syms = torch.arange(256, device=dev).expand(b, 256)
    if state is None:
        ranks = syms.clone()
        p = torch.zeros((b, 256), dtype=torch.int64, device=dev)
        q = torch.zeros_like(p)
    else:
        p, q, seen = (t.long() for t in state)
        ranks = entry_ranks(p, q, seen.bool())
    at = (torch.zeros((b, 1), dtype=torch.int64, device=dev)
          if start is None else start.long()[:, None])
    x = blocks.long()
    lens = lens.long()
    out = blocks.clone()
    for j in range(int(lens.max()) if b else 0):
        i = at + j
        alive = (j < lens)[:, None]
        v = x[:, j:j + 1]
        if inverse:
            r = v
            c = (ranks == r).long().argmax(1, keepdim=True)
            emit = c
        else:
            c = v
            r = ranks.gather(1, c)
            emit = r
        qc = ((i & m1) + (p.gather(1, c) & m2)) >> shift
        above = (ranks < r) & (q > qc)
        new_r = torch.where(above, ranks + 1, 0).amax(1, keepdim=True)
        is_c = (syms == c) & alive
        ranks = torch.where(is_c, new_r,
                            ranks + ((ranks >= new_r) & (ranks < r) & alive))
        p = torch.where(is_c, i, p)
        q = torch.where(is_c, qc, q)
        out[:, j] = torch.where(alive, emit, v)[:, 0]
    return out


def _check_args(blocks, lens, mode, segment) -> None:
    b, L = blocks.shape
    if mode not in _MODES:
        raise ValueError(f"sbrt: mode {mode} is not 1, 2 or 3")
    _check("blocks", blocks, torch.uint8, (b, L), blocks.device)
    _check("lens", lens, torch.int64, (b,), blocks.device)
    if segment <= 0 or segment % 16:
        raise ValueError(f"sbrt: segment {segment} is not a positive "
                         "multiple of 16")


def kernel_rows(blocks, lens):
    """(rows, ld): the blocks as the kernels take them, rows of ld bytes
    (a multiple of 16), 16-byte aligned. Checks the lengths."""
    b, L = blocks.shape
    if L >= MAX_LEN:
        raise ValueError(f"sbrt: blocks of {L} bytes; the kernels take "
                         f"fewer than {MAX_LEN}")
    if b and not 0 <= int(lens.min()) <= int(lens.max()) <= L:
        raise ValueError(f"lens: a block length outside [0, {L}]")
    ld = -(-L // 16) * 16              # the kernels read 16-byte words
    x = blocks
    if ld != L or blocks.data_ptr() % 16:
        x = torch.zeros((b, ld), dtype=torch.uint8, device=blocks.device)
        x[:, :L] = blocks
    return x, ld


# One call of each kernel on rows from kernel_rows (lens [B] int64, all
# on one CUDA device); each allocates its outputs.

def launch_occ(x, lens, segment: int):
    """sbrt_occ: each symbol's last and second-to-last position in each
    segment (-1: none), [B, nseg, 256] int32 each."""
    b, ld = x.shape
    nseg = -(-ld // segment)
    occ_last = torch.empty((b, nseg, 256), dtype=torch.int32,
                           device=x.device)
    occ_sec = torch.empty_like(occ_last)
    _launch("sbrt_occ", x.device, x, lens, b, ld, segment, occ_last,
            occ_sec)
    return occ_last, occ_sec


def launch_entry(occ_last, occ_sec, mode: int):
    """sbrt_entry: each segment's entry state, (the last position before
    it, -1: none; its q), [B, nseg, 256] int32 each."""
    b, nseg, _ = occ_last.shape
    last = torch.empty_like(occ_last)
    q = torch.empty_like(occ_last)
    _launch("sbrt_entry", occ_last.device, occ_last, occ_sec, b, nseg,
            *_MODES[mode], last, q)
    return last, q


def launch_fwd(x, lens, segment: int, last, q, mode: int):
    """sbrt_fwd: the forward of every segment from its entry state."""
    b, ld = x.shape
    out = torch.empty_like(x)
    _launch("sbrt_fwd", x.device, x, lens, b, ld, segment, last, q,
            *_MODES[mode], out)
    return out


def launch_inv(x, lens, mode: int):
    """sbrt_inv: the inverse, one chain a block."""
    b, ld = x.shape
    out = torch.empty_like(x)
    _launch("sbrt_inv", x.device, x, lens, b, ld, *_MODES[mode], out)
    return out


def segment_states(blocks, lens, mode: int, segment: int = SEGMENT):
    """Each forward segment's entry state (p, q, seen), [B, nseg, 256]
    each (see segment_states_plain): the sbrt_occ and sbrt_entry kernels
    for a CUDA tensor."""
    _check_args(blocks, lens, mode, segment)
    if _on_cpu("segment_states", blocks.device):
        return segment_states_plain(blocks, lens, mode, segment)
    x, _ = kernel_rows(blocks, lens)
    last, q = launch_entry(*launch_occ(x, lens, segment), mode)
    return last.clamp(min=0).long(), q.long(), last >= 0


def sbrt(blocks, lens, mode: int, inverse: bool, *,
         segment: int = SEGMENT):
    """blocks [B, L] uint8 (on the card L < MAX_LEN);
    lens [B] int64, 0 <= lens <= L. Returns [B, L] uint8: each block's
    first lens[b] bytes transformed (mode 1 MTF, 2 RANK, 3 TIMESTAMP;
    forward or inverse), the rest passed through. The forward runs in
    segments of ``segment`` bytes (a positive multiple of 16), each
    from its entry state; the inverse one chain a block."""
    b, L = blocks.shape
    _check_args(blocks, lens, mode, segment)
    if _on_cpu("sbrt", blocks.device):
        if inverse or not b or not L:
            return sbrt_plain(blocks, lens, mode, inverse)
        # the card's decomposition: entry states, then rows of segments
        p, q, seen = segment_states(blocks, lens, mode, segment)
        nseg = p.shape[1]
        rows = torch.zeros((b, nseg * segment), dtype=torch.uint8)
        rows[:, :L] = blocks
        start = torch.arange(nseg) * segment
        row_lens = (lens[:, None] - start).clamp(0, segment)
        out = sbrt_plain(rows.view(b * nseg, segment), row_lens.reshape(-1),
                         mode, False,
                         state=(p.view(-1, 256), q.view(-1, 256),
                                seen.view(-1, 256)),
                         start=start.repeat(b))
        return out.view(b, -1)[:, :L].contiguous()
    x, ld = kernel_rows(blocks, lens)
    if inverse:
        out = launch_inv(x, lens, mode)
    else:
        last, q = launch_entry(*launch_occ(x, lens, segment), mode)
        out = launch_fwd(x, lens, segment, last, q, mode)
    _ops.count("sbrt")
    return out if ld == L else out[:, :L].contiguous()


def sbrt_batch(blocks: np.ndarray, lens: np.ndarray, mode: int,
               inverse: bool, device) -> np.ndarray:
    """kanzi_tpu.ops.sbrt.sbrt_batch's contract on ``device``: blocks
    [B, L] u8, lens [B]; returns [B, L] u8."""
    dev = torch.device(device)
    out = sbrt(_host_tensor(blocks, np.uint8).to(dev),
               _host_tensor(lens, np.int64).to(dev), mode, inverse)
    return out.cpu().numpy()
