"""The block mesh and the entropy stages over it.

The PyTorch counterpart of kanzi_tpu/parallel/mesh.py's block mesh and
its sharded ANS0, Huffman and FPAQ encodes and decodes. Chunks (the 16
KiB entropy units inside a block) are the shard axis of ANS0 and
Huffman, blocks (one FPAQ stream each) that of FPAQ: they are
independent in the wire format, so a shard needs no collective, and the
ordered commit happens on the host. A mesh here is a tuple of torch
devices of length one: sharding over more than one card is
ROADMAP item 14. Each function pads its batch to a multiple of the mesh
size with items that decode to nothing the caller keeps, and trims the
outputs. The kernels: ANS0 A and B on encode (ops.ans.encode_chunks), C
on decode (ops.ans.ans0_decode_flat); Huffman D and E
(ops.huffman.encode_chunks_np, huffman_decode_chunks); FPAQ G and H
(ops.fpaq.fpaq_encode_batch, fpaq_decode_records) and CM I and J
(ops.cm.cm_encode_batch, cm_decode_records), every stream in one
launch each way.
"""

from __future__ import annotations

import numpy as np
import torch

import kanzi_tpu_torch.ops as _ops
from kanzi_tpu_torch.ops import ans as dans
from kanzi_tpu_torch.ops import cm as dcm
from kanzi_tpu_torch.ops import fpaq as dfp
from kanzi_tpu_torch.ops import huffman as dhuff


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


def shard_huffman_encode(chunks: np.ndarray, mesh=None):
    """Huffman-encode [C, 16384] chunks over the mesh. Same padding
    contract as shard_ans0_encode (a zero chunk has one symbol: a header
    and no pairs). Returns ops.huffman.encode_chunks_np's nine outputs
    (hdr, hdr_bits, ok, m, flat, npairs, acc, nb, frag_bits)."""
    if mesh is None:
        mesh = block_mesh()
    c = chunks.shape[0]
    cp = _pad_to(c, len(mesh))
    if cp != c:
        chunks = np.concatenate(
            [chunks, np.zeros((cp - c, dhuff.CHUNK), np.uint8)])
    out = dhuff.encode_chunks_np(chunks, mesh[0])
    return tuple(x if k == 4 else x[:c] for k, x in enumerate(out))


def shard_huffman_decode(codes: np.ndarray, sizes: np.ndarray,
                         pay: np.ndarray, bounds: np.ndarray, mesh=None):
    """Decode C full Huffman chunks over the mesh: codes/sizes [C, 256],
    their fragments flat, pay [N] uint8 with bounds [4C + 1]
    (ops.huffman.flat_fragments makes them from kanzi_tpu's rows). Pads
    C with chunks of no symbol and empty fragments. Returns [C, 16384]
    uint8."""
    if mesh is None:
        mesh = block_mesh()
    c = codes.shape[0]
    cp = _pad_to(c, len(mesh))
    if cp != c:
        pad = cp - c
        codes = np.concatenate([codes, np.zeros((pad, 256), codes.dtype)])
        sizes = np.concatenate([sizes, np.zeros((pad, 256), sizes.dtype)])
        bounds = np.concatenate([bounds, np.full(4 * pad, bounds[-1],
                                                 bounds.dtype)])
    return dhuff.huffman_decode_chunks(codes, sizes, pay, bounds,
                                       mesh[0])[:c]


def shard_fpaq_encode(streams: np.ndarray, lens: np.ndarray, mesh=None,
                      chunk_bytes: int = dfp.CHUNK_B):
    """FPAQ-encode [b, L] byte streams (one a block) over the mesh, all
    in one launch of kernel G, with no gate on their number. Pads b with
    empty streams. Returns ops.fpaq.fpaq_encode_batch's (bufs, low56,
    win_words [b, n_win], win_low56 [b, n_win]): kanzi_tpu's
    shard_fpaq_encode framed by windows and with no overflow list (a
    stream that outgrows its region is launched again on the card)."""
    if mesh is None:
        mesh = block_mesh()
    b, n = streams.shape
    bp = _pad_to(b, len(mesh))
    if bp != b:
        streams = np.concatenate([streams, np.zeros((bp - b, n), np.uint8)])
        lens = np.concatenate([lens, np.zeros(bp - b, lens.dtype)])
    bufs, low56, ww, wl = dfp.fpaq_encode_batch(streams, lens, chunk_bytes,
                                                mesh[0])
    return bufs[:b], low56[:b], ww[:b], wl[:b]


def shard_fpaq_decode(frames, lens: np.ndarray, mesh=None,
                      chunk_bytes: int = dfp.CHUNK_B):
    """FPAQ-decode b streams over the mesh, every chunk of every stream
    in one launch of kernel H, from their chunk framing as the host
    parse reads it: frames[s] = [(primed current, payload bytes)] a
    chunk (ops.fpaq.fpaq_decode_records; kanzi_tpu's takes
    decode_batch_jnp's padded rows, ops.fpaq.fpaq_decode_batch here).
    Pads b with empty streams; returns out [b, max(lens)] uint8."""
    if mesh is None:
        mesh = block_mesh()
    b = lens.shape[0]
    bp = _pad_to(b, len(mesh))
    if bp != b:
        frames = list(frames) + [[]] * (bp - b)
        lens = np.concatenate([lens, np.zeros(bp - b, lens.dtype)])
    return dfp.fpaq_decode_records(frames, lens, chunk_bytes, mesh[0])[:b]


def shard_cm_encode(streams: np.ndarray, lens: np.ndarray, mesh=None,
                    bs_version: int = 6):
    """CM-encode [b, L] single-chunk byte streams (one a block, each below
    2^26 bytes) over the mesh, all in one launch of kernel I. Pads b
    with empty streams. Returns ops.cm.cm_encode_batch's (bufs, low56,
    overflow), kanzi_tpu's shard_cm_encode's contract."""
    if mesh is None:
        mesh = block_mesh()
    b, n = streams.shape
    bp = _pad_to(b, len(mesh))
    if bp != b:
        streams = np.concatenate([streams, np.zeros((bp - b, n), np.uint8)])
        lens = np.concatenate([lens, np.zeros(bp - b, lens.dtype)])
    bufs, low56, overflow = dcm.cm_encode_batch(streams, lens, bs_version,
                                                mesh[0])
    return bufs[:b], low56[:b], overflow[:b]


def shard_cm_decode(records, lens: np.ndarray, mesh=None,
                    bs_version: int = 6):
    """CM-decode b single-chunk streams over the mesh, all in one launch
    of kernel J, from their records as the host parse reads them:
    records[s] = (primed current, payload bytes after the 7 priming
    bytes) (ops.cm.cm_decode_records; kanzi_tpu's takes cm_decode_batch's
    padded rows, ops.cm.cm_decode_batch here). Pads b with empty
    streams; returns out [b, max(lens)] uint8."""
    if mesh is None:
        mesh = block_mesh()
    b = lens.shape[0]
    bp = _pad_to(b, len(mesh))
    if bp != b:
        records = list(records) + [(0, b"")] * (bp - b)
        lens = np.concatenate([lens, np.zeros(bp - b, lens.dtype)])
    return dcm.cm_decode_records(records, lens, bs_version, mesh[0])[:b]
