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

One hand-written CUDA kernel (csrc/sbrt.cu) behind ``sbrt``, with
``sbrt_plain`` beside it (Pallas ``_sbrt_kernel``). The device level-5
chain (kanzi_tpu_torch/parallel/pipeline.py) runs RANK, mode 2, through
it in both directions; the host transform keeps the native automaton.
"""

from __future__ import annotations

import numpy as np
import torch

from kanzi_tpu_torch.ops.ans import _check, _host_tensor, _launch, _on_cpu

MODE_MTF, MODE_RANK, MODE_TIMESTAMP = 1, 2, 3
_MODES = {1: (-1, 0, 0), 2: (-1, -1, 1), 3: (0, -1, 0)}   # (m1, m2, shift)
MAX_LEN = 1 << 24            # the kernel packs q (< length) and a symbol
                             # into 32 bits


def sbrt_plain(blocks, lens, mode: int, inverse: bool):
    """Plain version of the sbrt kernel: a Python loop over the bytes on
    [B, 256] state (each symbol's rank, p and q), as the Pallas kernel
    steps it."""
    b, L = blocks.shape
    dev = blocks.device
    m1, m2, shift = _MODES[mode]
    syms = torch.arange(256, device=dev).expand(b, 256)
    ranks = syms.clone()
    p = torch.zeros((b, 256), dtype=torch.int64, device=dev)
    q = torch.zeros_like(p)
    x = blocks.long()
    lens = lens.long()
    out = blocks.clone()
    for i in range(int(lens.max()) if b else 0):
        alive = (i < lens)[:, None]
        v = x[:, i:i + 1]
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
        out[:, i] = torch.where(alive, emit, v)[:, 0]
    return out


def sbrt(blocks, lens, mode: int, inverse: bool):
    """blocks [B, L] uint8 (on the card L < MAX_LEN);
    lens [B] int64, 0 <= lens <= L. Returns [B, L] uint8: each block's
    first lens[b] bytes transformed (mode 1 MTF, 2 RANK, 3 TIMESTAMP;
    forward or inverse), the rest passed through."""
    b, L = blocks.shape
    dev = blocks.device
    if mode not in _MODES:
        raise ValueError(f"sbrt: mode {mode} is not 1, 2 or 3")
    _check("blocks", blocks, torch.uint8, (b, L), dev)
    _check("lens", lens, torch.int64, (b,), dev)
    if _on_cpu("sbrt", dev):
        return sbrt_plain(blocks, lens, mode, inverse)
    if L >= MAX_LEN:
        raise ValueError(f"sbrt: blocks of {L} bytes; the kernel takes "
                         f"fewer than {MAX_LEN}")
    if b and not 0 <= int(lens.min()) <= int(lens.max()) <= L:
        raise ValueError(f"lens: a block length outside [0, {L}]")
    ld = -(-L // 16) * 16              # the kernel reads 16-byte words
    x = blocks
    if ld != L or blocks.data_ptr() % 16:
        x = torch.zeros((b, ld), dtype=torch.uint8, device=dev)
        x[:, :L] = blocks
    out = torch.empty((b, ld), dtype=torch.uint8, device=dev)
    _launch("sbrt", dev, x, lens, b, ld, *_MODES[mode], int(inverse), out)
    return out if ld == L else out[:, :L].contiguous()


def sbrt_batch(blocks: np.ndarray, lens: np.ndarray, mode: int,
               inverse: bool, device) -> np.ndarray:
    """kanzi_tpu.ops.sbrt.sbrt_batch's contract on ``device``: blocks
    [B, L] u8, lens [B]; returns [B, L] u8."""
    dev = torch.device(device)
    out = sbrt(_host_tensor(blocks, np.uint8).to(dev),
               _host_tensor(lens, np.int64).to(dev), mode, inverse)
    return out.cpu().numpy()
