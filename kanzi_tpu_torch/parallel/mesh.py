"""The block mesh and the ANS0 entropy stage over it.

The PyTorch counterpart of kanzi_tpu/parallel/mesh.py's block mesh and
its sharded ANS0 encode and decode. Chunks (the 16 KiB entropy units
inside a block) are the shard axis: they are independent in the wire
format, so a shard needs no collective, and the ordered commit happens
on the host. A mesh here is a tuple of torch devices of length one:
sharding over more than one card is ROADMAP item 14. The encode runs
kernels A and B (ops.ans.encode_chunks), the decode kernel C
(ops.ans.ans0_decode_flat).
"""

from __future__ import annotations

import numpy as np
import torch

import kanzi_tpu_torch.ops as _ops
from kanzi_tpu_torch.ops import ans as dans


def block_mesh(devices=None) -> tuple:
    """The 1-D "block" mesh: the card (ops.device()), or the one device
    the caller names."""
    devices = (_ops.device(),) if devices is None else tuple(
        torch.device(d) for d in devices)
    if len(devices) != 1:
        raise NotImplementedError(
            f"a block mesh over {len(devices)} devices: more than one card "
            "is ROADMAP item 14")
    return devices


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def shard_ans0_encode(chunks: np.ndarray, mesh=None):
    """Encode [C, 16384] chunks over the mesh; pads C up to a multiple of
    the mesh size with zero chunks and trims the outputs. Returns
    ops.ans.encode_chunks_np's (hdr, bitlen, m, flat, plen): a zero chunk
    is header-only, so the padding adds nothing to flat."""
    if mesh is None:
        mesh = block_mesh()
    c = chunks.shape[0]
    cp = _pad_to(c, len(mesh))
    if cp != c:
        chunks = np.concatenate(
            [chunks, np.zeros((cp - c, chunks.shape[1]), np.uint8)])
    hdr, bitlen, m, flat, plen = dans.encode_chunks_np(chunks, mesh[0])
    return hdr[:c], bitlen[:c], m[:c], flat, plen[:c]


def shard_ans0_decode(freqs: np.ndarray, states: np.ndarray,
                      payload: np.ndarray, mesh=None):
    """Decode [C] chunks over the mesh: freqs [C, 256], states [C, 4]
    u32, payload [C, W] u8 (each chunk's payload from its row's start).
    Same padding contract as shard_ans0_encode. Returns (out [C, 16384]
    u8, consumed payload bytes [C])."""
    if mesh is None:
        mesh = block_mesh()
    c = freqs.shape[0]
    cp = _pad_to(c, len(mesh))
    if cp != c:
        pad = cp - c
        # zero-freq chunks are invalid; pad with a uniform alphabet so the
        # decode stays in bounds, then trim
        freqs = np.concatenate(
            [freqs, np.full((pad, 256), dans.SCALE // 256, freqs.dtype)])
        states = np.concatenate(
            [states, np.full((pad, 4), dans.ANS_TOP, np.uint32)])
        payload = np.concatenate(
            [payload, np.zeros((pad, payload.shape[1]), np.uint8)])
    w = payload.shape[1]
    out, cur = dans.ans0_decode_flat(freqs, states, payload.reshape(-1),
                                     np.arange(cp, dtype=np.int64) * w,
                                     mesh[0])
    return out[:c], cur[:c]
