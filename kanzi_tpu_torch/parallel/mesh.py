"""The block mesh and the entropy stages over it.

The PyTorch counterpart of kanzi_tpu/parallel/mesh.py's block mesh and
its sharded ANS0, Huffman, FPAQ and CM encodes and decodes. Chunks (the
16 KiB entropy units inside a block) are the shard axis of ANS0 and
Huffman, blocks (one FPAQ or CM stream each) that of FPAQ and CM: they
are independent in the wire format, so a shard needs no collective, and
the ordered commit happens on the host. A mesh here is a tuple of torch
devices, single-controller and data-parallel as kanzi_tpu's: each
function cuts its batch into len(mesh) contiguous shards (P("block")'s
layout; where the mesh size does not divide the batch the last shards
are one item shorter, as np.array_split cuts, so no padding item is
coded), launches each shard's kernels on its device, one host thread a
distinct device so that cards work at once, and joins the outputs in
shard order. A mesh may name one device more than once: that device
then runs its shards in turn.
The kernels: ANS0 A and B on encode (ops.ans.encode_chunks), C on
decode (ops.ans.ans0_decode_flat); Huffman D and E
(ops.huffman.encode_chunks_np, huffman_decode_chunks); FPAQ G and H
(ops.fpaq.fpaq_encode_batch, fpaq_decode_records) and CM I and J
(ops.cm.cm_encode_batch, cm_decode_records), every item of a shard in
one launch each way.

Each entropy stage is a span (core/trace.py), entropy.<coder>.<encode or
decode>, and each shard a mesh.shard span below it in its worker thread.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import kanzi_tpu_torch.ops as _ops
from kanzi_tpu_torch.core import trace
from kanzi_tpu_torch.ops import ans as dans
from kanzi_tpu_torch.ops import cm as dcm
from kanzi_tpu_torch.ops import fpaq as dfp
from kanzi_tpu_torch.ops import huffman as dhuff


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def block_mesh(devices=None) -> tuple:
    """The 1-D "block" mesh: every visible CUDA device (raises when there
    is none, as ops.device() does), or the devices the caller names, in
    order. A device named k times runs k shards in turn: (cpu,) * k or
    (cuda:0,) * k stands in for k cards."""
    if devices is None:
        _ops.device()
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    mesh = tuple(_device(d) for d in devices)
    if not mesh:
        raise ValueError("a block mesh needs at least one device")
    return mesh


def _bounds(n: int, k: int) -> list:
    """[start, stop) of each of k contiguous shards of n items, in mesh
    order: np.array_split's cut, the first n % k shards one item
    longer."""
    q, r = divmod(n, k)
    cuts = [i * q + min(i, r) for i in range(k + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def _run_shards(mesh, n: int, fn) -> list:
    """[fn(start, stop, device) for each non-empty shard of a batch of n
    items (_bounds)] in shard order (the first shard alone, empty, when
    n is 0); one host thread a distinct device, a device's shards in
    turn. A shard's error raises here. Each shard is a mesh.shard span
    under the span open where _run_shards is called."""
    shards = [(a, b, d) for (a, b), d in zip(_bounds(n, len(mesh)), mesh)
              if b > a] or [(0, 0, mesh[0])]
    by_dev = {}
    for j, (_, _, d) in enumerate(shards):
        by_dev.setdefault(d, []).append(j)
    out = [None] * len(shards)
    parent = trace.current()         # a worker thread does not inherit it

    def work(js):
        for j in js:
            a, b, d = shards[j]
            with (torch.cuda.device(d) if d.type == "cuda"
                  else contextlib.nullcontext()), \
                    trace.span("mesh.shard", parent) as sp:
                if sp:
                    sp.set(device=str(d), items=b - a)
                out[j] = fn(a, b, d)

    with ThreadPoolExecutor(len(by_dev)) as ex:
        for f in [ex.submit(work, js) for js in by_dev.values()]:
            f.result()
    return out


def _cat(parts) -> np.ndarray:
    """The shards' arrays joined on axis 0; one shard's array as it is,
    not copied."""
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _join_rows(parts: list, width: int) -> np.ndarray:
    """Shards' [b_i, w_i] uint8 outputs as one [sum b_i, width] array,
    zero past each row's w_i."""
    return _cat([p if p.shape[1] == width
                 else np.pad(p, ((0, 0), (0, width - p.shape[1])))
                 for p in parts])


def shard_ans0_encode(chunks: np.ndarray, mesh=None):
    """Encode [C, 16384] chunks over the mesh, one contiguous shard of
    chunks a device. Returns ops.ans.encode_chunks_np's (hdr, bitlen, m,
    flat, plen): flat is the shards' streams in shard order, so chunk
    c's payload starts at the exclusive cumsum of plen."""
    if mesh is None:
        mesh = block_mesh()
    with trace.span("entropy.ans0.encode") as sp:
        parts = _run_shards(mesh, chunks.shape[0], lambda a, b, d:
                            dans.encode_chunks_np(chunks[a:b], d))
        res = tuple(_cat(x) for x in zip(*parts))
        if sp:
            sp.set(items=chunks.shape[0], bytes_in=chunks.nbytes,
                   bytes_out=res[3].size)
    return res


def shard_ans0_decode(freqs: np.ndarray, states: np.ndarray,
                      payload: np.ndarray, mesh=None):
    """Decode [C] chunks over the mesh: freqs [C, 256], states [C, 4]
    u32, payload [C, W] u8 (each chunk's payload from its row's start),
    one contiguous shard of chunks a device. Returns (out [C, 16384] u8,
    consumed payload bytes [C])."""
    if mesh is None:
        mesh = block_mesh()
    w = payload.shape[1]

    def run(a, b, d):
        return dans.ans0_decode_flat(
            freqs[a:b], states[a:b], payload[a:b].reshape(-1),
            np.arange(b - a, dtype=np.int64) * w, d)

    with trace.span("entropy.ans0.decode") as sp:
        res = tuple(_cat(x) for x in zip(*_run_shards(mesh, freqs.shape[0],
                                                        run)))
        if sp:
            sp.set(items=freqs.shape[0], bytes_in=int(res[1].sum()),
                   bytes_out=res[0].size)
    return res


def shard_huffman_encode(chunks: np.ndarray, mesh=None):
    """Huffman-encode [C, 16384] chunks over the mesh, one contiguous
    shard of chunks a device. Returns ops.huffman.encode_chunks_np's nine
    outputs (hdr, hdr_bits, ok, m, flat, npairs, acc, nb, frag_bits);
    flat, the one pair stream, is the shards' streams in shard order."""
    if mesh is None:
        mesh = block_mesh()
    with trace.span("entropy.huffman.encode") as sp:
        parts = _run_shards(mesh, chunks.shape[0], lambda a, b, d:
                            dhuff.encode_chunks_np(chunks[a:b], d))
        res = tuple(_cat(x) for x in zip(*parts))
        if sp:
            sp.set(items=chunks.shape[0], bytes_in=chunks.nbytes,
                   bytes_out=res[4].nbytes)
    return res


def shard_huffman_decode(codes: np.ndarray, sizes: np.ndarray,
                         pay: np.ndarray, bounds: np.ndarray, mesh=None):
    """Decode C full Huffman chunks over the mesh: codes/sizes [C, 256],
    their fragments flat, pay [N] uint8 with bounds [4C + 1]
    (ops.huffman.flat_fragments makes them from kanzi_tpu's rows). Each
    shard takes its slice of pay with its bounds rebased to 0. Returns
    [C, 16384] uint8."""
    if mesh is None:
        mesh = block_mesh()

    def run(a, b, d):
        bd = bounds[4 * a:4 * b + 1]
        return dhuff.huffman_decode_chunks(
            codes[a:b], sizes[a:b], pay[bd[0]:bd[-1]], bd - bd[0], d)

    with trace.span("entropy.huffman.decode") as sp:
        res = _cat(_run_shards(mesh, codes.shape[0], run))
        if sp:
            sp.set(items=codes.shape[0], bytes_in=pay.size,
                   bytes_out=res.size)
    return res


def shard_fpaq_encode(streams: np.ndarray, lens: np.ndarray, mesh=None,
                      chunk_bytes: int = dfp.CHUNK_B):
    """FPAQ-encode [b, L] byte streams (one a block) over the mesh, a
    shard's streams in one launch of kernel G, with no gate on their
    number. Returns ops.fpaq.fpaq_encode_batch's (bufs, low56, win_words
    [b, n_win], win_low56 [b, n_win]): kanzi_tpu's shard_fpaq_encode
    framed by windows and with no overflow list (a stream that outgrows
    its region is launched again on the card)."""
    if mesh is None:
        mesh = block_mesh()
    lens = np.asarray(lens)
    with trace.span("entropy.fpaq.encode") as sp:
        parts = _run_shards(mesh, streams.shape[0], lambda a, b, d:
                            dfp.fpaq_encode_batch(streams[a:b], lens[a:b],
                                                  chunk_bytes, d))
        res = ([x for p in parts for x in p[0]],
               [x for p in parts for x in p[1]],
               _cat([p[2] for p in parts]), _cat([p[3] for p in parts]))
        if sp:
            sp.set(items=len(lens), bytes_in=int(lens.sum()),
                   bytes_out=sum(len(x) for x in res[0]))
    return res


def shard_fpaq_decode(frames, lens: np.ndarray, mesh=None,
                      chunk_bytes: int = dfp.CHUNK_B):
    """FPAQ-decode b streams over the mesh, every chunk of a shard's
    streams in one launch of kernel H, from their chunk framing as the
    host parse reads it: frames[s] = [(primed current, payload bytes)] a
    chunk (ops.fpaq.fpaq_decode_records; kanzi_tpu's takes
    decode_batch_jnp's padded rows, ops.fpaq.fpaq_decode_batch here).
    Returns out [b, max(lens)] uint8."""
    if mesh is None:
        mesh = block_mesh()
    frames, lens = list(frames), np.asarray(lens)
    with trace.span("entropy.fpaq.decode") as sp:
        parts = _run_shards(mesh, len(lens), lambda a, b, d:
                            dfp.fpaq_decode_records(frames[a:b], lens[a:b],
                                                    chunk_bytes, d))
        res = _join_rows(parts, int(lens.max(initial=0)))
        if sp:
            sp.set(items=len(lens), bytes_out=int(lens.sum()),
                   bytes_in=sum(len(p) for f in frames for _, p in f))
    return res


def shard_cm_encode(streams: np.ndarray, lens: np.ndarray, mesh=None,
                    bs_version: int = 6):
    """CM-encode [b, L] single-chunk byte streams (one a block, each below
    2^26 bytes) over the mesh, a shard's streams in one launch of kernel
    I. Returns ops.cm.cm_encode_batch's (bufs, low56, overflow),
    kanzi_tpu's shard_cm_encode's contract."""
    if mesh is None:
        mesh = block_mesh()
    lens = np.asarray(lens)
    with trace.span("entropy.cm.encode") as sp:
        parts = _run_shards(mesh, streams.shape[0], lambda a, b, d:
                            dcm.cm_encode_batch(streams[a:b], lens[a:b],
                                                bs_version, d))
        res = tuple([x for p in parts for x in p[k]] for k in range(3))
        if sp:
            sp.set(items=len(lens), bytes_in=int(lens.sum()),
                   bytes_out=sum(len(x) for x in res[0]))
    return res


def shard_cm_decode(records, lens: np.ndarray, mesh=None,
                    bs_version: int = 6):
    """CM-decode b single-chunk streams over the mesh, a shard's streams
    in one launch of kernel J, from their records as the host parse
    reads them: records[s] = (primed current, payload bytes after the 7
    priming bytes) (ops.cm.cm_decode_records; kanzi_tpu's takes
    cm_decode_batch's padded rows, ops.cm.cm_decode_batch here). Returns
    out [b, max(lens)] uint8."""
    if mesh is None:
        mesh = block_mesh()
    records, lens = list(records), np.asarray(lens)
    with trace.span("entropy.cm.decode") as sp:
        parts = _run_shards(mesh, len(lens), lambda a, b, d:
                            dcm.cm_decode_records(records[a:b], lens[a:b],
                                                  bs_version, d))
        res = _join_rows(parts, int(lens.max(initial=0)))
        if sp:
            sp.set(items=len(lens), bytes_out=int(lens.sum()),
                   bytes_in=sum(len(p) + 7 for _, p in records))
    return res
