"""The device block pipelines of the level-2, 3, 5, 6 and 7 containers
over the block mesh (parallel.mesh).

The PyTorch counterpart of kanzi_tpu/parallel/pipeline.py's mesh chains:
each container's per-byte stages of a batch of blocks run as one pass on
the card, the batch axis written out where the JAX package vmaps over
blocks.

Level 5 (TEXT+UTF+BWT+RANK+ZRLT & ANS0), division of labor as in
kanzi_tpu:
- card: BWT and its block-codec header (ops/bwt.py), RANK (ops.sbrt in
  mode 2, the SBRT kernel, in place of kanzi_tpu's lax.scan), ZRLT (torch
  ops: cumsums and scatters), then the ANS0 chunk encode (kernels A and
  B) and, on decode, the ANS0 decode (kernel C) of every full chunk of
  the file in one call;
- host: the stage-skip decisions (TEXT's computeStats, UTF validation,
  the ZRLT capacity gate, the copy-back rule), text blocks and the tail
  block through the host chain, and the ordered container commit.

Levels 2 (DNA+LZ), 3 (TEXT+UTF+PACK+MM+LZX, the default level), 6
(TEXT+UTF+BWT+SRT+ZRLT) and 7 (LZP+TEXT+UTF+BWT+LZP): the transforms run
on the host, one block at a time, and the entropy stage of every block
of the file is one batched call on the card each way: Huffman's kernels
D and E for levels 2 and 3, FPAQ's G and H for level 6 and CM's I and J
for level 7 (one stream a block).

Over a mesh of several devices every stage that runs on the card is
cut into one contiguous shard a device (parallel.mesh): the entropy
stages' chunks or streams, and the level-5 chain's rows of blocks. Each
container is byte-identical with the host writer's whatever the mesh,
and its decompress_*_mesh inverts it and kanzi_tpu's; the tests and
chip_smoke.py hold both.

Each call is a root span (core/trace.py), call.compress or
call.decompress, over the spans of its layers: the level-5 route
(l5.route) and card passes (l5.device.forward, l5.device.inverse), each
block's host work (block.forward; block.entropy and block.inverse), the
entropy stage of every block in one batch (entropy.batch, around the
coder's entropy.<coder>.<encode or decode>), and the container's commit,
frame loop and output join (container.commit, .frames, .output).
"""

from __future__ import annotations

import io as _pyio

import numpy as np
import torch

import kanzi_tpu_torch.ops as _ops
from kanzi_tpu_torch.bitstream import BitReader
from kanzi_tpu_torch.core import trace
from kanzi_tpu_torch.core.context import Context
from kanzi_tpu_torch.core.stats import log2 as _log2
from kanzi_tpu_torch.entropy import fpaq as efpaq
from kanzi_tpu_torch.entropy.ans import ANSRangeDecoder
from kanzi_tpu_torch.entropy.factory import entropy_name_to_type
from kanzi_tpu_torch.entropy.huffman import huffman_flush_sink
from kanzi_tpu_torch.io.compressed_stream import (
    ANS0_TYPE, COPY_BLOCK_MASK, FPAQ_CHUNK, HUFFMAN_TYPE, MAX_BLOCK_ID,
    CompressedReader, CompressedWriter, _encode_block_phase1, _fpaq_blocks, _fpaq_streams, _full_chunks,
    _stash_ans0, _stash_fpaq, _stash_huffman, decode_block)
from kanzi_tpu_torch.ops import ans as dans
from kanzi_tpu_torch.ops import bwt as dbwt
from kanzi_tpu_torch.ops import cm as dcm
from kanzi_tpu_torch.ops import huffman as dhuff
from kanzi_tpu_torch.ops.sbrt import MODE_RANK, sbrt
from kanzi_tpu_torch.parallel.mesh import (_run_shards, block_mesh,
                                           shard_ans0_decode,
                                           shard_ans0_encode,
                                           shard_cm_decode, shard_cm_encode,
                                           shard_fpaq_decode,
                                           shard_fpaq_encode,
                                           shard_huffman_decode,
                                           shard_huffman_encode)
from kanzi_tpu_torch.transform.factory import (new_transform,
                                               transform_name_to_type)

CHAIN = "TEXT+UTF+BWT+RANK+ZRLT"
ENTROPY = "ANS0"
# input bytes of one pass on the card: its peak memory is ~100x this (the
# suffix array's int64 keys, ranks and sort buffers: 97 bytes a byte for
# one block, PERF.md)
GROUP_BYTES = 64 << 20


def _groups(rows: list, n: int):
    per = max(1, GROUP_BYTES // n)
    return [rows[g:g + per] for g in range(0, len(rows), per)]


def _over_mesh(items: list, n: int, mesh, fn) -> list:
    """fn(group, device) -> one result an item of the group, over the
    mesh: the items (blocks of n bytes) cut into len(mesh) contiguous
    shards (parallel.mesh), each shard's items in groups of GROUP_BYTES
    on its device (one host thread a distinct device)."""
    parts = _run_shards(mesh, len(items), lambda a, b, d: [
        r for group in _groups(items[a:b], n) for r in fn(group, d)])
    return [r for part in parts for r in part]


# ---------------------------------------------------------------------------
# RANK (SBRT mode 2) through the SBRT kernel
# ---------------------------------------------------------------------------

def _rank(data: torch.Tensor, inverse: bool) -> torch.Tensor:
    """data [B, M] uint8, each row a whole block -> its RANK transform
    (inverse: the inverse), [B, M] uint8."""
    lens = torch.full((data.shape[0],), data.shape[1], dtype=torch.int64,
                      device=data.device)
    return sbrt(data, lens, MODE_RANK, inverse)


def _rank_forward(data: torch.Tensor) -> torch.Tensor:
    return _rank(data, False)


def _rank_inverse(data: torch.Tensor) -> torch.Tensor:
    return _rank(data, True)


# ---------------------------------------------------------------------------
# ZRLT (kanzi_tpu_torch/transform/zrlt.py), vectorized over [B, M]
# ---------------------------------------------------------------------------

def _shift_right(t: torch.Tensor, fill) -> torch.Tensor:
    """t[:, i - 1] at column i, ``fill`` at column 0."""
    out = torch.empty_like(t)
    out[:, 0] = fill
    out[:, 1:] = t[:, :-1]
    return out


def _zrlt_forward(data: torch.Tensor, out_cap: int):
    """data [B, M] uint8 -> (out [B, out_cap] uint8, total [B] int64).
    A zero run of length L becomes the binary digits of L + 1 below its
    top bit; a literal v < 0xFE becomes v + 1, v >= 0xFE the pair 0xFF,
    v - 0xFE. The caller applies the capacity gate (total > capacity:
    the stage is skipped)."""
    b, m = data.shape
    dev = data.device
    idx = torch.arange(m, device=dev).expand(b, m)
    x = data.long()
    is_zero = x == 0
    start = is_zero & ~_shift_right(is_zero, False)
    # next non-zero position (m if none): a reverse running minimum
    nn = torch.where(is_zero, m, idx).flip(1).cummin(1).values.flip(1)
    rl1 = nn - idx + 1                       # run length + 1 (at starts)
    nb = torch.frexp(rl1.double()).exponent.long() - 1   # bits below the MSB
    lit1 = ~is_zero & (x < 0xFE)
    lit2 = ~is_zero & (x >= 0xFE)
    cont = torch.where(start, nb, 0) + lit1 + 2 * lit2
    csum = cont.cumsum(1)
    off = csum - cont
    # digit j of a run comes from its j-th zero (a run of L zeros has at
    # most L digits)
    run = torch.where(start, idx, 0).cummax(1).values
    j = idx - run
    nb_r = nb.gather(1, run)
    digit = is_zero & (j < nb_r)
    bit = (rl1.gather(1, run) >> (nb_r - 1 - j).clamp(min=0)) & 1
    out = torch.zeros((b, out_cap + 1), dtype=torch.uint8, device=dev)

    def put(mask, pos, val):        # column out_cap sinks what is dropped
        out.scatter_(1, torch.where(mask & (pos < out_cap), pos, out_cap),
                     val.to(torch.uint8))

    put(lit1 | lit2 | digit, torch.where(digit, off.gather(1, run) + j, off),
        torch.where(lit1, x + 1, torch.where(lit2, 0xFF, bit)))
    put(lit2, off + 1, x - 0xFE)
    return out[:, :out_cap], csum[:, -1]


def _zrlt_inverse(data: torch.Tensor, out_n: int,
                  lens: torch.Tensor | None = None) -> torch.Tensor:
    """ZRLT inverse of [B, M] uint8 rows -> [B, out_n] uint8, the same
    function as kanzi_tpu's _zrlt_inverse_jnp scan, vectorized. A byte
    after an escape 0xFF is its operand, and an operand 0xFF escapes
    nothing, so in a run of 0xFF bytes every other one escapes. A run of
    k digits d (bytes 0/1 that are not operands) stands for 2^k + d - 1
    zeros, written where the next literal or escape ends it; a run at
    the end of the input (trailing pad digits) is dropped, and so is
    every byte written at or past out_n. Rows whose runs would overflow
    the scan's int32 state are rejected as malformed.

    With lens [B] (each row's real length, zero digits after it), a row
    is also rejected where its real bytes end in an escape, as the host
    inverse does, or decode to other than out_n bytes (a zero run at
    their end counted in full)."""
    b, m = data.shape
    dev = data.device
    idx = torch.arange(m, device=dev).expand(b, m)
    x = data.long()
    isff = x == 0xFF
    last_other = torch.where(isff, -1, idx).cummax(1).values
    escape = isff & ((idx - last_other) & 1 == 1)
    operand = _shift_right(escape, False)
    digit = ~operand & (x <= 1)
    literal = ~operand & (x >= 2) & ~isff
    prev_digit = _shift_right(digit, False)
    run = torch.where(digit & ~prev_digit, idx, 0).cummax(1).values
    term = prev_digit & ~digit               # a literal or escape ends a run
    k = idx - run                            # the run's digits, at term
    if bool((term & (k > 30)).any()):
        raise ValueError("ZRLT: malformed input (a zero run past 2^31)")
    # digit i of a run ending before position e weighs 2^(e - 1 - i)
    end = torch.where(digit, m, idx).flip(1).cummin(1).values.flip(1)
    contrib = torch.where(digit, x << (end - 1 - idx).clamp(0, 40), 0)
    ecs = contrib.cumsum(1) - contrib
    zeros = (1 << k.clamp(max=40)) + ecs - ecs.gather(1, run) - 1
    emit = literal | operand
    pos = (torch.where(term, zeros, 0) + emit).cumsum(1)
    if bool((pos[:, -1] >= 1 << 31).any()):
        raise ValueError("ZRLT: malformed input (output past 2^31)")
    if lens is not None:
        if bool((lens < 1).any()):
            raise ValueError("ZRLT: an empty row")
        last = (lens - 1)[:, None]
        if bool(escape.gather(1, last).any()):
            raise ValueError("ZRLT: malformed escape at end of input")
        # a row that ends in digits ends in a zero run: its value from
        # the digits in [its start, lens)
        start = run.gather(1, last)
        mine = digit & (idx >= start) & (idx <= last)
        val = torch.where(mine, x << (last - idx).clamp(0, 40), 0).sum(1)
        tail = (1 << (last + 1 - start)[:, 0].clamp(max=40)) + val - 1
        got = pos.gather(1, last)[:, 0] + torch.where(
            digit.gather(1, last)[:, 0], tail, 0)
        if bool((got != out_n).any()):
            raise ValueError(f"ZRLT: malformed input (a row does not "
                             f"decode to {out_n} bytes)")
    wpos = torch.where(emit & (pos <= out_n), pos - 1, out_n)
    val = torch.where(operand, (0xFE + x) & 0xFF, x - 1)
    out = torch.zeros((b, out_n + 1), dtype=torch.uint8, device=dev)
    out.scatter_(1, wpos, val.to(torch.uint8))
    return out[:, :out_n]


# ---------------------------------------------------------------------------
# BWT + BWTBlockCodec header (kanzi_tpu_torch/transform/bwt.py)
# ---------------------------------------------------------------------------

def _p_index_size(n: int) -> int:
    lbs = _log2(n) + (1 if n & (n - 1) else 0)
    return (lbs + 7) >> 3


def _bwt_codec(blocks: torch.Tensor) -> torch.Tensor:
    """blocks [B, n] uint8, n >= 256 (so 8 chunks) -> the BWTBlockCodec
    output [B, 1 + 8 * pis + n] uint8: mode byte, 8 big-endian primary
    indexes - 1, BWT bytes."""
    b, n = blocks.shape
    pis = _p_index_size(n)
    bwt_sorted, rank0, rank = dbwt._bwt_impl(blocks)
    out = dbwt.bwt_output(blocks, bwt_sorted, rank0)
    v = (dbwt.primary_indexes(blocks, rank, 8) - 1) & ((1 << 8 * pis) - 1)
    sh = 8 * torch.arange(pis - 1, -1, -1, device=blocks.device)
    idx = ((v[:, :, None] >> sh) & 0xFF).view(b, 8 * pis).to(torch.uint8)
    mode = torch.full((b, 1), (3 << 2) | (pis - 1), dtype=torch.uint8,
                      device=blocks.device)
    return torch.cat([mode, idx, out], 1)


def _bwt_inverse(payload: torch.Tensor, n: int, pis: int) -> tuple:
    """BWTBlockCodec inverse of [B, 1 + 8 * pis + n] uint8 rows: the
    primary indexes from the header, then the inverse BWT. Returns (the
    inverse [B, n] uint8, ok [B] bool), with no host sync: ok is False
    where a row's header is not the one _bwt_codec writes or its bytes
    are no block's BWT (a corrupt stream), rows whose output is undefined
    and whose host inverse this one would not equal."""
    b = payload.shape[0]
    mode = (3 << 2) | (pis - 1)                  # 8 indexes of pis bytes
    idx = payload[:, 1:1 + 8 * pis].long().view(b, 8, pis)
    sh = 8 * torch.arange(pis - 1, -1, -1, device=payload.device)
    p_idx = (idx << sh).sum(2) + 1               # stored value - 1
    hdr_ok = (payload[:, 0] == mode) & ((p_idx >= 1) & (p_idx <= n)).all(1)
    p_idx = torch.where(hdr_ok[:, None], p_idx, 1)   # in the row either way
    hdr = 1 + 8 * pis
    out, ok = dbwt._bwt_inverse_core(payload[:, hdr:hdr + n].contiguous(),
                                     p_idx[:, 0], p_idx)
    return out, ok & hdr_ok


def _device_l5(blocks: torch.Tensor, zcap: int):
    """BWT(+header) -> RANK -> ZRLT of B same-size blocks on their
    device. Returns (rank_out [B, n + hdr] uint8, zrlt_out [B, zcap]
    uint8, zrlt_total [B] int64)."""
    rk = _rank_forward(_bwt_codec(blocks))
    zo, zt = _zrlt_forward(rk, zcap)
    return rk, zo, zt


def _device_l5_inv(zin: torch.Tensor, zlen: torch.Tensor,
                   zran: torch.Tensor, rank_len: int, n: int,
                   pis: int) -> tuple:
    """ZRLT^-1 (on the rows where it ran) -> RANK^-1 -> BWT^-1 of B rows
    [B, >= rank_len] uint8 on their device, row b's first zlen[b] bytes
    real and zeros after them. Returns ([B, n] uint8, ok [B] bool): ok
    False where only the host's BWT inverse can place a row (_bwt_inverse).
    A row that ZRLT's inverse rejects raises ValueError."""
    rk_in = zin[:, :rank_len].clone()
    if bool(zran.any()):
        rk_in[zran] = _zrlt_inverse(zin[zran], rank_len, zlen[zran])
    return _bwt_inverse(_rank_inverse(rk_in), n, pis)


def l5_chain(blocks: torch.Tensor):
    """The fused level-5 chain of kanzi_tpu's bench (bench.py
    _l5_chain_rate), all on the blocks' device: BWT and its header, RANK
    through the SBRT kernel, ZRLT, then the ANS0 encode of each block's
    full 16 KiB chunks of the ZRLT output. blocks [B, n] uint8. Returns
    (flat payload uint8, payload bytes per chunk [B * n // 16384],
    zrlt_total [B])."""
    b, n = blocks.shape
    rk, zo, zt = _device_l5(blocks, n + 1 + 8 * _p_index_size(n))
    s = n // dans.CHUNK
    _hdr, _bitlen, _m, flat, plen = dans.encode_chunks(
        zo[:, :s * dans.CHUNK].reshape(b * s, dans.CHUNK).contiguous())
    return flat, plen, zt


# ---------------------------------------------------------------------------
# the level-5 container
# ---------------------------------------------------------------------------

def prepare_ans0_batch_mesh(states: list, mesh) -> None:
    """compressed_stream.prepare_ans0_batch over the mesh: every eligible
    block's full 16 KiB chunks in one encode call."""
    elig, counts, chunks = _full_chunks(states, ANS0_TYPE, dans.CHUNK)
    if elig:
        _stash_ans0(elig, counts, shard_ans0_encode(chunks, mesh))


def compress_l5_mesh(data: bytes, block_size: int, mesh=None) -> bytes:
    """The level-5 container with the transform and entropy stages of
    its full blocks over the mesh. The stage-skip decisions (TEXT
    computeStats, UTF validation, the ZRLT capacity gate, the copy-back
    rule) run on the host from per-block results, as the host pipeline
    makes them. Blocks whose TEXT or UTF stage would run (text) take the
    host chain, as does the tail block; the container is byte-identical
    with the host writer's either way."""
    if mesh is None:
        mesh = block_mesh()
    with trace.span("call.compress", bytes=len(data),
                    blocks=-(-len(data) // block_size)):
        return _compress_l5(data, block_size, mesh)


def _compress_l5(data: bytes, n: int, mesh) -> bytes:
    dev = mesh[0]
    full = len(data) // n
    src = np.frombuffer(data, np.uint8)              # a view: no copy
    blocks = src[:full * n].reshape(full, n)

    sink = _pyio.BytesIO()
    w = CompressedWriter(sink, transform=CHAIN, entropy=ENTROPY,
                         block_size=n, original_size=len(data), device=dev)
    t_type = transform_name_to_type(CHAIN)
    e_type = entropy_name_to_type(ENTROPY)

    # host: the TEXT and UTF skip decisions on the raw blocks (each
    # returns None fast when it skips)
    bctx0 = w.ctx.copy()
    bctx0.put("size", n)
    required = new_transform(bctx0, t_type).max_encoded_length(n)
    device_ok = []
    with trace.span("l5.route", blocks=full):
        for b in range(full):
            bctx = w.ctx.copy()
            bctx.put("blockId", b + 1)
            bctx.put("size", n)
            ok = True
            seq = new_transform(bctx, t_type)
            for t, name in zip(seq.transforms[:2], seq.names):  # TEXT, UTF
                t.output_capacity = required
                # a trial: its output is thrown away either way
                with trace.span("transform." + name + ".forward",
                                bytes_in=n, kept=False) as sp:
                    out = t.forward(blocks[b])
                    if sp:
                        sp.set(bytes_out=0 if out is None else len(out))
                if out is not None:
                    ok = False                           # text: host chain
                    break
            device_ok.append(ok)

    rows = [b for b in range(full) if device_ok[b]]
    _ops.count("l5_encode_device_blocks", len(rows))

    def forward(group, d):
        with trace.span("l5.device.forward", blocks=len(group),
                        bytes=len(group) * n) as sp:
            if sp:
                sp.set(device=str(d))
            x = torch.from_numpy(blocks[group]).to(d)
            rk, zo, zt = (t.cpu().numpy() for t in _device_l5(x, required))
            return [(rk[j], zo[j], int(zt[j])) for j in range(len(group))]

    results = dict(zip(rows, _over_mesh(rows, n, mesh, forward)))

    states = []
    for b in range(full):
        slot = b % w.jobs
        if not device_ok[b]:
            states.append(_encode_block_phase1(
                blocks[b], b + 1, w.ctx, t_type, e_type,
                slot_caps=w.slot_caps[slot]))
            continue
        # the card's outputs and the remaining host decisions
        # (TransformSequence's capacity semantics: with TEXT/UTF skipped
        # and BWT/RANK run, the ZRLT stage's output capacity resolves to
        # max(slot work-buffer cap, required))
        rk, zo, zt = results[b]
        zcap = max(w.slot_caps[slot][1], required)
        if zcap != required:
            raise AssertionError(
                "slot capacity diverged from the device buffer bound")
        skip_flags = 0xFF
        skip_flags &= ~(1 << (7 - 2)) & 0xFF             # BWT ran
        skip_flags &= ~(1 << (7 - 3)) & 0xFF             # RANK ran
        if zcap >= len(rk) and zt <= zcap:
            skip_flags &= ~(1 << (7 - 4)) & 0xFF         # ZRLT ran
            tout = zo[:zt]
            swaps = 3
        else:
            tout = rk
            swaps = 2
        if (swaps & 1) == 0 and len(tout) > zcap:        # copy-back rule
            skip_flags = 0xFF
            tout = blocks[b]
        states.append(_encode_block_phase1(
            blocks[b], b + 1, w.ctx, t_type, e_type,
            slot_caps=w.slot_caps[slot],
            transformed=(np.ascontiguousarray(tout, np.uint8), skip_flags)))

    if len(data) > full * n:                             # host chain
        states.append(_encode_block_phase1(
            src[full * n:], full + 1, w.ctx, t_type, e_type,
            slot_caps=w.slot_caps[full % w.jobs]))

    with trace.span("entropy.batch", blocks=len(states)):
        prepare_ans0_batch_mesh(states, mesh)
    w.commit_states(states)
    w.close()
    return sink.getvalue()


def _parse_ans0_block(payload, bits: int, block_size: int, block_id: int):
    """Host parse of one block's framing, then its ANS0 stage through
    the host decoder with a sink, which queues the full 16 KiB chunks
    and decodes the others, in the block's block.entropy span. Returns
    (pre_len, skip_flags, ebuf, records): ebuf [pre_len] uint8, records
    = (start, freqs[256], states[4], payload bytes, size) of the queued
    chunks, whose bytes in ebuf the caller fills; or None where the
    block needs the host path."""
    with trace.span("block.entropy", block=block_id,
                    bytes_in=len(payload)):
        ibs = BitReader(payload)
        mode = ibs.read_bits(8)
        if mode & COPY_BLOCK_MASK:
            return None
        if mode & 0x10:
            skip_flags = ibs.read_bits(8)
        else:
            skip_flags = ((mode << 4) | 0x0F) & 0xFF
        data_size = 1 + ((mode >> 5) & 0x03)
        pre_len = ibs.read_bits(8 * data_size)
        if pre_len <= 32:                             # raw-bytes entropy path
            return None
        sink = []
        ctx = Context()
        ctx.put("_ans0DecodeSink", sink)
        ebuf = ANSRangeDecoder(ibs, ctx).decode(pre_len)
        if len(ebuf) != pre_len:
            return None                               # truncating stream
        return pre_len, skip_flags, ebuf, [rc for _, q in sink for rc in q]


def decompress_l5_mesh(blob: bytes, mesh=None) -> bytes:
    """Decode a level-5 container with the ANS0 stage of every full 16
    KiB chunk of the file in one decode call and the inverse transforms
    (ZRLT, RANK, BWT) of its device-chain blocks over the mesh.
    Blocks that ran TEXT or UTF, copy blocks and the last block take the
    host path; the output equals the host reader's either way."""
    if mesh is None:
        mesh = block_mesh()
    with trace.span("call.decompress", bytes_in=len(blob)) as sp:
        out = _decompress_l5(blob, mesh, sp)
        if sp:
            sp.set(bytes=len(out))
        return out


def _decompress_l5(blob: bytes, mesh, root) -> bytes:
    dev = mesh[0]
    r = CompressedReader(blob, device=dev)           # header parsed here
    n = r.block_size
    pis = _p_index_size(n)
    rank_len = n + 1 + 8 * pis

    frames = []                                       # (payload, bits)
    with trace.span("container.frames"):
        while True:
            lr_ = 3 + r.ibs.read_bits(5)
            bits = r.ibs.read_bits(lr_)
            if bits == 0:
                break
            frames.append((r.ibs.read_payload(bits), bits))
    if root:
        root.set(blocks=len(frames))

    def host(bi):
        payload, bits = frames[bi]
        return decode_block(payload, bits, bi + 1, r.ctx, r.transform_type,
                            r.entropy_type, r.block_size, r.checksum_bits)

    # phase 1: host parse; every full chunk of the file in one decode,
    # its rows written into their blocks' entropy buffers (a block
    # checksum sits in the framing: such files take the host path)
    parsed = [None if r.checksum_bits else _parse_ans0_block(p, b, n, bi + 1)
              for bi, (p, b) in enumerate(frames)]
    all_recs = [rc for p in parsed if p is not None for rc in p[3]]
    if all_recs:
        with trace.span("entropy.batch", blocks=len(parsed)):
            freqs = np.stack([rc[1] for rc in all_recs])
            states = np.stack([rc[2] for rc in all_recs])
            pay = np.zeros((len(all_recs), dans.PAYLOAD_MAX + 2), np.uint8)
            for i, rc in enumerate(all_recs):
                pay[i, :rc[4]] = np.frombuffer(rc[3], np.uint8)
            dec, cur = shard_ans0_decode(freqs, states, pay, mesh)
            for i, rc in enumerate(all_recs):
                if cur[i] != rc[4]:
                    raise ValueError("ANS chunk payload size mismatch")
            i = 0
            for p in parsed:
                for rc in (p[3] if p is not None else ()):
                    p[2][rc[0]:rc[0] + dans.CHUNK] = dec[i]
                    i += 1

    # phase 2: the inverse transforms of the device-chain blocks on the
    # card
    out_rows = {}
    dev_rows = []                                     # (bi, ebuf, zrlt ran)
    for bi, p in enumerate(parsed):
        if p is None or bi == len(frames) - 1:       # the last may be short
            out_rows[bi] = host(bi)
            continue
        pre_len, skip_flags, ebuf, records = p
        # stage pattern: TEXT/UTF skipped, BWT+RANK ran, ZRLT ran|skipped
        text_utf_skipped = (skip_flags & 0xC0) == 0xC0
        bwt_rank_ran = (skip_flags & 0x30) == 0
        zrlt_ran = (skip_flags & 0x08) == 0
        rest_skipped = (skip_flags & 0x07) == 0x07
        if (len(ebuf) >= (1 if zrlt_ran else rank_len)
                and text_utf_skipped and bwt_rank_ran and rest_skipped
                and (zrlt_ran or pre_len == rank_len)):
            dev_rows.append((bi, ebuf, zrlt_ran))
        else:
            out_rows[bi] = host(bi)

    def inverse(group, d):
        with trace.span("l5.device.inverse", blocks=len(group),
                        bytes=len(group) * n) as sp:
            if sp:
                sp.set(device=str(d))
            zin_pad = max(max(len(e) for _, e, _ in group), rank_len)
            zin = np.zeros((len(group), zin_pad), np.uint8)
            for j, (_, e, _) in enumerate(group):
                zin[j, :len(e)] = e
            zlen = torch.tensor([len(e) for _, e, _ in group], device=d)
            zran = torch.tensor([zr for _, _, zr in group], device=d)
            out, ok = _device_l5_inv(torch.from_numpy(zin).to(d), zlen,
                                     zran, rank_len, n, pis)
            out, ok = out.cpu().numpy(), ok.cpu().numpy()
            return [row if good else None for row, good in zip(out, ok)]

    rows = _over_mesh(dev_rows, n, mesh, inverse)
    fell_back = sum(row is None for row in rows)
    _ops.count("l5_decode_device_blocks", len(dev_rows) - fell_back)
    if fell_back:
        _ops.count("l5_decode_host_fallback_blocks", fell_back)
    for (bi, _, _), row in zip(dev_rows, rows):
        # None: a corrupt row only the host's BWT inverse places; its
        # outcome (bytes or error) is the host reader's
        out_rows[bi] = host(bi) if row is None else row

    with trace.span("container.output"):
        return b"".join(np.asarray(out_rows[bi]).tobytes()
                        for bi in range(len(frames)))


# ---------------------------------------------------------------------------
# the level-2, 3 and 6 containers: host transforms, the entropy stage of
# every block in one call on the card each way
# ---------------------------------------------------------------------------

CHAIN_L2 = "DNA+LZ"
ENTROPY_L2 = "HUFFMAN"
CHAIN_L3 = "TEXT+UTF+PACK+MM+LZX"
ENTROPY_L3 = "HUFFMAN"
CHAIN_L6 = "TEXT+UTF+BWT+SRT+ZRLT"
ENTROPY_L6 = "FPAQ"
CHAIN_L7 = "LZP+TEXT+UTF+BWT+LZP"
ENTROPY_L7 = "CM"
CM_TYPE = entropy_name_to_type(ENTROPY_L7)


def prepare_huffman_batch_mesh(states: list, mesh) -> None:
    """compressed_stream.prepare_huffman_batch over the mesh: every
    eligible block's full 16 KiB chunks in one encode call a shard (kernel D),
    ops enabled or not."""
    elig, counts, chunks = _full_chunks(states, HUFFMAN_TYPE, dhuff.CHUNK)
    if elig:
        _stash_huffman(elig, counts, shard_huffman_encode(chunks, mesh))


def prepare_fpaq_batch_mesh(states: list, mesh) -> None:
    """compressed_stream.prepare_fpaq_batch over the mesh: every FPAQ
    block's bytes one stream, all in one encode call a shard (kernel G),
    with no gate on their number. Counts the blocks it encodes on the
    card as l6_encode_device_blocks."""
    elig = _fpaq_blocks(states)
    if elig:
        _ops.count("l6_encode_device_blocks", len(elig))
        lens = np.array([st["post_len"] for st in elig], np.int64)
        _stash_fpaq(elig, lens, shard_fpaq_encode(
            _fpaq_streams(elig, lens), lens, mesh, FPAQ_CHUNK))


def _compress_host_chain_mesh(data: bytes, block_size: int, mesh,
                              chain: str, entropy: str,
                              prepare_fn) -> bytes:
    """The container of ``chain`` & ``entropy``: the transforms of each
    block on the host, in block order (the reference's one task a block,
    src/io/CompressedOutputStream.cpp:476-540), then the entropy stage
    of every block in one call on the mesh (prepare_fn), then the
    ordered commit. Byte-identical with the host writer's."""
    if mesh is None:
        mesh = block_mesh()
    n = block_size
    with trace.span("call.compress", bytes=len(data),
                    blocks=-(-len(data) // n)):
        sink = _pyio.BytesIO()
        w = CompressedWriter(sink, transform=chain, entropy=entropy,
                             block_size=n, original_size=len(data),
                             device=mesh[0])
        t_type = transform_name_to_type(chain)
        e_type = entropy_name_to_type(entropy)
        src = np.frombuffer(data, np.uint8)          # a view: no copy
        states = [_encode_block_phase1(
            src[pos:pos + n], b + 1, w.ctx, t_type, e_type,
            slot_caps=w.slot_caps[b % w.jobs])
            for b, pos in enumerate(range(0, len(data), n))]
        with trace.span("entropy.batch", blocks=len(states)):
            prepare_fn(states, mesh)
        w.commit_states(states)
        w.close()
        return sink.getvalue()


def _decompress_host_chain_mesh(blob: bytes, mesh, key: str,
                                flush) -> bytes:
    """Decode a container whose transforms run on the host through the
    container's reader, its entropy decoders queuing the card's work of
    every block in the sink under ``key``; flush(entries, mesh) decodes
    it all in one call on the mesh once every block is read, then each
    block's inverse transforms run on the host."""
    if mesh is None:
        mesh = block_mesh()

    def batch(entries):
        with trace.span("entropy.batch", blocks=len(entries)):
            flush(entries, mesh)

    with trace.span("call.decompress", bytes_in=len(blob)) as sp:
        r = CompressedReader(blob, device=mesh[0],
                             decode_sinks={key: batch},
                             sink_window=MAX_BLOCK_ID)
        out = r.read_all()
        if sp:
            sp.set(bytes=len(out), blocks=r._blocks_decoded)
        return out


def compress_l2_mesh(data: bytes, block_size: int, mesh=None) -> bytes:
    """The level-2 container (DNA+LZ & HUFFMAN): DNA and LZ on the host,
    the Huffman stage of every block in one call a shard (kernel D) over the
    mesh. Byte-identical with the host writer's."""
    return _compress_host_chain_mesh(data, block_size, mesh, CHAIN_L2,
                                     ENTROPY_L2, prepare_huffman_batch_mesh)


def _flush_huffman(entries: list, mesh) -> None:
    """The queued full chunks of every Huffman block in one decode call
    (kernel E)."""
    huffman_flush_sink(entries,
                       lambda *a: shard_huffman_decode(*a, mesh))


def decompress_l2_mesh(blob: bytes, mesh=None) -> bytes:
    """Decode a level-2 or level-3 container: the Huffman chunk headers
    parsed on the host (HuffmanDecoder, natively in csrc/huff_parse.cpp),
    every full chunk of the file in one decode call a shard (kernel E) over the
    mesh, then each block's inverse transforms on the host (the
    block header names them, so one decoder serves both chains)."""
    return _decompress_host_chain_mesh(blob, mesh, "_huffDecodeSink",
                                       _flush_huffman)


def compress_l3_mesh(data: bytes, block_size: int, mesh=None) -> bytes:
    """The level-3 container (the reference's default level,
    TEXT+UTF+PACK+MM+LZX & HUFFMAN): the transforms on the host, the
    Huffman stage of every block in one call a shard (kernel D) over the
    mesh. Byte-identical with the host writer's."""
    return _compress_host_chain_mesh(data, block_size, mesh, CHAIN_L3,
                                     ENTROPY_L3, prepare_huffman_batch_mesh)


def decompress_l3_mesh(blob: bytes, mesh=None) -> bytes:
    """Decode a level-3 container: decompress_l2_mesh."""
    return decompress_l2_mesh(blob, mesh)


def compress_l6_mesh(data: bytes, block_size: int, mesh=None) -> bytes:
    """The level-6 container (TEXT+UTF+BWT+SRT+ZRLT & FPAQ): the
    transforms on the host, the FPAQ stage of every block, one stream a
    block, in one call a shard (kernel G) over the mesh. Byte-identical
    with the host writer's."""
    return _compress_host_chain_mesh(data, block_size, mesh, CHAIN_L6,
                                     ENTROPY_L6, prepare_fpaq_batch_mesh)


def _flush_fpaq(entries: list, mesh) -> None:
    """Every queued FPAQ block one stream, every chunk of every stream
    in one decode call a shard (kernel H)."""
    _ops.count("l6_decode_device_blocks", len(entries))
    lens = np.array([len(out) for out, _ in entries], np.int64)
    dec = shard_fpaq_decode([chunks for _, chunks in entries], lens, mesh,
                            efpaq.DEFAULT_CHUNK_SIZE)
    for (out, _), row in zip(entries, dec):
        out[:] = row[:len(out)]


def decompress_l6_mesh(blob: bytes, mesh=None) -> bytes:
    """Decode a level-6 container: the FPAQ chunk framing parsed on the
    host, every chunk of every block (one stream a block) in one decode
    call a shard (kernel H) over the mesh, then each block's inverse
    transforms (ZRLT, SRT, BWT, UTF, TEXT) on the host. Counts the
    blocks it decodes on the card as l6_decode_device_blocks."""
    return _decompress_host_chain_mesh(blob, mesh, "_fpaqDecodeSink",
                                       _flush_fpaq)


def prepare_cm_batch_mesh(states: list, mesh) -> None:
    """The CM entropy stage over the mesh: every CM block's post-transform
    bytes one stream, one chunk of the shell (0 < post_len < 2^26, which
    covers every level-7 block), all in one encode call a shard (kernel I). The
    host coder takes a block the card cannot (longer, or a stream past
    its CAP words, kanzi_tpu's overflow list), counted as
    cm_host_blocks."""
    cm = [st for st in states
          if st["e_type"] == CM_TYPE and not (st["mode"] & COPY_BLOCK_MASK)
          and st["post_len"] > 0]
    elig = [st for st in cm if st["post_len"] < dcm.MAX_STREAM]
    if len(elig) < len(cm):
        _ops.count("cm_host_blocks", len(cm) - len(elig))
    if not elig:
        return
    lens = np.array([st["post_len"] for st in elig], np.int64)
    bufs, low56, overflow = shard_cm_encode(
        _fpaq_streams(elig, lens), lens, mesh,
        elig[0]["bctx"].get_int("bsVersion", 7))
    for st, buf, low, over in zip(elig, bufs, low56, overflow):
        if over:
            _ops.count("cm_host_blocks")
        else:
            st["prepared_entropy"] = ([buf], [], low)


def compress_l7_mesh(data: bytes, block_size: int, mesh=None) -> bytes:
    """The level-7 container (LZP+TEXT+UTF+BWT+LZP & CM): the transforms
    on the host, the CM stage of every block, one stream a block, in one
    call (kernel I) over the mesh. Byte-identical with the host
    writer's."""
    return _compress_host_chain_mesh(data, block_size, mesh, CHAIN_L7,
                                     ENTROPY_L7, prepare_cm_batch_mesh)


def _flush_cm(entries: list, mesh) -> None:
    """Every queued CM block one stream, all in one decode call a shard (kernel
    J), at the bsVersion of the container the entries come from."""
    _ops.count("l7_decode_device_blocks", len(entries))
    lens = np.array([len(out) for out, *_ in entries], np.int64)
    dec = shard_cm_decode([(cur, pay) for _, cur, pay, _ in entries], lens,
                          mesh, entries[0][3])
    for (out, *_), row in zip(entries, dec):
        out[:] = row[:len(out)]


def decompress_l7_mesh(blob: bytes, mesh=None) -> bytes:
    """Decode a level-7 container: each block's CM framing (its size, the
    56-bit current, the payload) read on the host, every block (one
    stream a block) in one decode call a shard (kernel J) over the mesh,
    then each block's inverse transforms (LZP, BWT, UTF, TEXT, LZP) on
    the host. Counts the blocks it decodes on the card as
    l7_decode_device_blocks."""
    return _decompress_host_chain_mesh(blob, mesh, "_cmDecodeSink",
                                       _flush_cm)
