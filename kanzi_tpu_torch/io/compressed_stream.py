"""Block-pipeline container: header, block framing, ordered commit.

Reimplements the reference L4 scheduler (src/io/CompressedOutputStream.cpp,
CompressedInputStream.cpp) for a host-orchestrated TPU pipeline:

- The byte stream is cut into fixed-size blocks (1 KiB..1 GiB).
- Each block runs: [checksum] -> transform chain -> entropy coder into a
  private in-memory bitstream (growable_ofixedbuf pattern, :786-788).
- Completed blocks are committed to the shared bitstream in block order:
  `5b (lw-3) | lw bits payload-bit-length | payload bits` (:848-864);
  end-of-stream marker = 5+3 zero bits (:415-417).
- File header layout: writeHeader (:277-342); parse/validate mirrors
  CompressedInputStream::readHeader (:511-663) including the 24-bit
  folded checksum.

Block encoding is embarrassingly parallel (the reference fans out
EncodingTasks over a thread pool); here the full 16 KiB entropy chunks of
every queued block go to the CUDA kernels in one call per coder
(prepare_ans0_batch, prepare_huffman_batch, the full 4 MiB order-1 chunks
in prepare_ans1_batch; the FPAQ blocks too, prepare_fpaq_batch, where
enough of them make a batch), with this module doing the ordered
host-side gather.

The coding device comes from the ``device`` argument of the writer and
the reader (any ``torch.device`` spelling; default: the CUDA device) and
travels to the coders in the context under "device".
"""

from __future__ import annotations

import io as _pyio
from typing import Optional

import numpy as np

from kanzi_tpu_torch.bitstream import BitReader, BitWriter
from kanzi_tpu_torch.core import magic as magiclib
from kanzi_tpu_torch.core import stats, trace
from kanzi_tpu_torch.core.context import Context
from kanzi_tpu_torch.core.errors import Error, KanziError
from kanzi_tpu_torch.core.events import Event, EventType, ListenerBus
from kanzi_tpu_torch.core.hashes import xxhash32, xxhash64
import kanzi_tpu_torch.ops as ops
from kanzi_tpu_torch.entropy import ans as eans
from kanzi_tpu_torch.entropy import factory as efactory
from kanzi_tpu_torch.entropy.ans import (ans0_flush_sink,
                                         ans1_encode_chunks_np, coding_device)
from kanzi_tpu_torch.ops import ans as dans
from kanzi_tpu_torch.ops import fpaq as dfp
from kanzi_tpu_torch.ops import huffman as dhuff
from kanzi_tpu_torch.transform import factory as tfactory
from kanzi_tpu_torch.transform.sequence import SKIP_MASK
from kanzi_tpu_torch.utils import native

def _alloc_bytes_buffer(n: int):
    """(result_bytes, writable uint8 view) — an uninitialized bytes
    object plus an ndarray aliasing its buffer. The caller fills the
    view completely before handing `result` to anyone (same pattern a C
    extension uses with PyBytes_FromStringAndSize(NULL, n))."""
    import ctypes
    try:
        fn = ctypes.pythonapi.PyBytes_FromStringAndSize
        fn.restype = ctypes.py_object
        fn.argtypes = [ctypes.c_char_p, ctypes.c_ssize_t]
        result = fn(None, n)
        ptr = ctypes.cast(ctypes.c_char_p(result),
                          ctypes.POINTER(ctypes.c_uint8))
        view = np.ctypeslib.as_array(ptr, shape=(n,))
        return result, view
    except Exception:                         # non-CPython fallback
        view = np.empty(n, np.uint8)
        return None, view


MAGIC = 0x4B414E5A
FORMAT_VERSION = 6
MIN_BLOCK_SIZE = 1024
MAX_BLOCK_SIZE = 1024 * 1024 * 1024
SMALL_BLOCK_SIZE = 15
COPY_BLOCK_MASK = 0x80
TRANSFORMS_MASK = 0x10
MAX_CONCURRENCY = 64
EXTRA_BUFFER_SIZE = 512
MAX_BLOCK_ID = (1 << 31) - 1
# blocks whose entropy phases are held before one cross-block device
# flush (bounds held post-entropy buffers to ~window x block_size)
_SINK_WINDOW = 16


def _header_checksum(version: int, ck_size: int, entropy_type: int,
                     transform_type: int, block_size: int,
                     sz_mask: int, input_size: int) -> int:
    """24-bit folded header checksum (writeHeader :324-341)."""
    M = 0xFFFFFFFF
    HASH = 0x1E35A7BD
    seed = (0x01030507 * version) & M
    ck = (HASH * seed) & M
    ck ^= (HASH * ((~ck_size) & M)) & M
    ck ^= (HASH * ((~entropy_type) & M)) & M
    ck ^= (HASH * (((~transform_type) >> 32) & M)) & M
    ck ^= (HASH * ((~transform_type) & M)) & M
    ck ^= (HASH * ((~block_size) & M)) & M
    if sz_mask != 0:
        ck ^= (HASH * (((~input_size) >> 32) & M)) & M
        ck ^= (HASH * ((~input_size) & M)) & M
    ck = ((ck >> 23) ^ (ck >> 3)) & M
    return ck & 0xFFFFFF


def _encode_block_phase1(block: np.ndarray, block_id: int, ctx: Context,
                         transform_type: int, entropy_type: int,
                         checksum_bits: int = 0,
                         listeners: Optional[ListenerBus] = None,
                         slot_caps: Optional[list] = None,
                         transformed: Optional[tuple] = None) -> dict:
    """Per-block pipeline up to (and including) the transform chain
    (EncodingTask::run :652-784). Returns the block state consumed by
    _encode_block_phase2. The slot's post-entropy input-buffer regrow is
    applied here (its value only depends on lengths known after the
    transform), preserving the reference's sequential cap evolution even
    when many blocks run phase 1 before any runs phase 2.

    transformed: optional (bytes_u8, skip_flags) precomputed by a device
    pipeline (parallel/pipeline.py); the transform chain is then not run
    here, but every surrounding decision (mode byte, slot-cap evolution,
    framing) still is."""
    with trace.span("block.forward", block=block_id,
                    bytes_in=len(block)) as sp:
        block = np.ascontiguousarray(np.asarray(block, dtype=np.uint8))
        block_len = len(block)
        t_type = transform_type
        e_type = entropy_type
        mode = 0

        checksum = 0
        if checksum_bits == 32:
            checksum = xxhash32(block.tobytes())
        elif checksum_bits == 64:
            checksum = xxhash64(block.tobytes())

        if listeners:
            listeners.notify(Event(EventType.BEFORE_TRANSFORM, block_id, block_len,
                                   checksum=checksum if checksum_bits else None,
                                   hash_bits=checksum_bits))

        if block_len <= SMALL_BLOCK_SIZE:
            t_type = tfactory.NONE_TYPE
            e_type = 0
            mode |= COPY_BLOCK_MASK
        elif ctx.get_int("skipBlocks", 0):
            skip = magiclib.is_compressed(magiclib.get_type(block[:4].tobytes()))
            if not skip:
                histo = stats.compute_histogram(block)
                entropy = stats.first_order_entropy_1024(block_len, histo)
                skip = entropy >= stats.INCOMPRESSIBLE_THRESHOLD
            if skip:
                t_type = tfactory.NONE_TYPE
                e_type = 0
                mode |= COPY_BLOCK_MASK

        bctx = ctx.copy()
        bctx.put("blockId", block_id)
        bctx.put("size", block_len)

        if block_len >= 4:
            mg = magiclib.get_type(block[:4].tobytes())
            if magiclib.is_compressed(mg):
                bctx.put("dataType", stats.BIN)
            elif magiclib.is_multimedia(mg):
                bctx.put("dataType", stats.MULTIMEDIA)
            elif magiclib.is_executable(mg):
                bctx.put("dataType", stats.EXE)

        transform = tfactory.new_transform(bctx, t_type)
        # model the slot's persistent buffers: input buffer starts at
        # blockSize + blockSize/64 floor 64 KiB (processBuffer :461-470), work
        # buffer at requiredSize (EncodingTask :733-740); both only grow
        bsz = ctx.get_int("blockSize", max(block_len, 1024))
        if slot_caps is None:
            slot_caps = [0, 0]
        if slot_caps[0] == 0:
            slot_caps[0] = max(bsz + (bsz >> 6), 65536)
        required = transform.max_encoded_length(block_len)
        if slot_caps[1] < required:
            slot_caps[1] = required
        if transformed is not None:
            out, skip_flags = transformed
            if skip_flags == SKIP_MASK:
                out = block
        else:
            out = transform.forward(block, input_capacity=slot_caps[0],
                                    output_capacity=slot_caps[1])
            if transform.skip_flags == SKIP_MASK:
                out = block  # every stage skipped: payload is the input bytes
            skip_flags = transform.skip_flags
        nb_transforms = len(transform)
        post_len = len(out)
        bctx.put("size", post_len)

        # the entropy scratch regrows the slot's input buffer (:776-784)
        slot_caps[0] = max(slot_caps[0], 256 * 1024, post_len,
                           block_len + (block_len >> 3))

        data_size = 1 if post_len < 256 else (stats.log2(post_len) >> 3) + 1
        if data_size > 4:
            raise KanziError("Invalid block data length", Error.ERR_WRITE_FILE)
        mode |= ((data_size - 1) & 0x03) << 5

        if listeners:
            listeners.notify(Event(EventType.AFTER_TRANSFORM, block_id, post_len,
                                   checksum=checksum if checksum_bits else None,
                                   hash_bits=checksum_bits))

        if sp:
            sp.set(bytes_out=post_len)
        return {"block_id": block_id, "mode": mode, "e_type": e_type,
                "checksum": checksum, "checksum_bits": checksum_bits,
                "out": out, "skip_flags": skip_flags,
                "nb_transforms": nb_transforms, "post_len": post_len,
                "bctx": bctx, "prepared_entropy": None}


def _encode_block_phase2(st: dict,
                         listeners: Optional[ListenerBus] = None) -> tuple:
    """Entropy stage + payload assembly (EncodingTask::run :786-807)."""
    block_id = st["block_id"]
    mode = st["mode"]
    out = st["out"]
    post_len = st["post_len"]
    skip_flags = st["skip_flags"]
    checksum_bits = st["checksum_bits"]
    checksum = st["checksum"]
    data_size = ((mode >> 5) & 0x03) + 1

    obs = BitWriter()
    if (mode & COPY_BLOCK_MASK) or st["nb_transforms"] <= 4:
        mode |= skip_flags >> 4
        obs.write_bits(mode, 8)
    else:
        mode |= TRANSFORMS_MASK
        obs.write_bits(mode, 8)
        obs.write_bits(skip_flags, 8)

    obs.write_bits(post_len, 8 * data_size)
    if checksum_bits:
        obs.write_bits(checksum, checksum_bits)

    if listeners:
        listeners.notify(Event(EventType.BEFORE_ENTROPY, block_id, post_len,
                               checksum=checksum if checksum_bits else None,
                               hash_bits=checksum_bits))

    ee = efactory.new_encoder(obs, st["bctx"], st["e_type"])
    if st["prepared_entropy"] is not None:
        ee.prepared_device = st["prepared_entropy"]
    if ee.encode(out) != post_len:
        raise KanziError("Entropy coding failed", Error.ERR_PROCESS_BLOCK)
    ee.dispose()

    written = obs.written()
    payload = obs.getarray()

    if listeners:
        listeners.notify(Event(EventType.AFTER_ENTROPY, block_id,
                               (written + 7) >> 3,
                               checksum=checksum if checksum_bits else None,
                               hash_bits=checksum_bits,
                               skip_flags=skip_flags))
    return payload, written


def encode_block(block: np.ndarray, block_id: int, ctx: Context,
                 transform_type: int, entropy_type: int,
                 checksum_bits: int = 0,
                 listeners: Optional[ListenerBus] = None,
                 slot_caps: Optional[list] = None) -> tuple:
    """Per-block pipeline (EncodingTask::run :652-807).

    Returns (payload_bytes, payload_bit_length). Pure function of the
    block (given slot_caps) — safe to run concurrently for many blocks.

    slot_caps = [input_capacity, work_capacity] models the task slot's
    persistent buffers (they only grow across the blocks a slot handles,
    and capacity gates transform-skip decisions); mutated in place.
    """
    st = _encode_block_phase1(block, block_id, ctx, transform_type,
                              entropy_type, checksum_bits, listeners,
                              slot_caps)
    return _encode_block_phase2(st, listeners)


ANS0_TYPE = 5
HUFFMAN_TYPE = 1
FPAQ_TYPE = 2
ANS1_TYPE = 8
FPAQ_CHUNK = 4 * 1024 * 1024


# The FPAQ encode goes to the card when the batch's FPAQ blocks, weighted
# by length (their total over the longest), are at least this many: the
# kernel's time is set by its longest stream (one chain a stream), the
# host coder's by their total. Set at the top of the crossovers that
# chip_smoke.py printed on an H100 for the kernel of csrc/fpaq.cu (PERF.md;
# the kernel per launch over the native coder per stream at the same
# length, which moves with the host's speed: 5.18-7.01 streams), rounded
# up, so that a batch sent to the card is not slower there.
FPAQ_MIN_STREAMS = 8


def _fpaq_on_device(dev, lens) -> bool:
    """True where the FPAQ blocks of lengths ``lens`` code faster on
    ``dev`` than on the host: a CUDA device and enough of them."""
    return (dev.type == "cuda" and len(lens) > 0
            and sum(lens) >= FPAQ_MIN_STREAMS * max(lens))


def prepare_fpaq_batch(states: list, ctx: Context) -> None:
    """Cross-block device batching for the FPAQ (l6) entropy stage: the
    per-bit arithmetic-coding loops of up to 64 blocks run as one launch
    on the coding device (ops/fpaq.py, one stream per block),
    byte-identical with the host coder; each block gets its chunk
    framing for emit_prepared. A group of blocks too few to beat the
    host coder (_fpaq_on_device) stays on the host. Reference parallel
    model: one EncodingTask per block
    (src/io/CompressedOutputStream.cpp:476-540); coder:
    src/entropy/FPAQEncoder.hpp encodeBit."""
    if not ops.ENABLED:
        return
    elig = _fpaq_blocks(states)
    if not elig:
        return
    dev = coding_device(ctx)
    for g0 in range(0, len(elig), dfp.NS):
        group = elig[g0:g0 + dfp.NS]
        lens = np.array([st["post_len"] for st in group], np.int64)
        if _fpaq_on_device(dev, lens.tolist()):
            _stash_fpaq(group, lens, dfp.fpaq_encode_batch(
                _fpaq_streams(group, lens), lens, FPAQ_CHUNK, dev))


def _fpaq_blocks(states: list) -> list:
    """The blocks of states whose FPAQ stage codes bytes."""
    return [st for st in states
            if st["e_type"] == FPAQ_TYPE
            and not (st["mode"] & COPY_BLOCK_MASK)
            and st["post_len"] > 0]


def _fpaq_streams(group: list, lens: np.ndarray) -> np.ndarray:
    """The blocks' post-transform bytes (lens[i] of block i) as one
    stream each: [b, max(lens)] uint8, zero past each length."""
    streams = np.zeros((len(group), int(lens.max())), np.uint8)
    for i, st in enumerate(group):
        streams[i, :lens[i]] = st["out"][:lens[i]]
    return streams


def _stash_fpaq(group: list, lens: np.ndarray, enc: tuple) -> None:
    """Give each block of group its FPAQ chunk framing (chunk_bufs,
    boundary_low56s, final_low56, emit_prepared's argument) from one
    fpaq_encode_batch result over their streams."""
    bufs, low56, ww, wl = enc
    wpc = FPAQ_CHUNK // dfp.WIN_B             # windows per FPAQ chunk
    for i, st in enumerate(group):
        nchunks = -(-int(lens[i]) // FPAQ_CHUNK)
        chunk_bufs, bound_lows = [], []
        pos = 0
        for k in range(nchunks):
            w_end = min((k + 1) * wpc, ww.shape[1])
            words = int(ww[i, :w_end].sum()) - pos
            chunk_bufs.append(bufs[i][4 * pos:4 * (pos + words)])
            pos += words
            if k + 1 < nchunks:
                bound_lows.append(int(wl[i, w_end - 1]))
        st["prepared_entropy"] = (chunk_bufs, bound_lows, int(low56[i]))


def _full_chunks(states: list, e_type: int, size: int) -> tuple:
    """The blocks of states that entropy type e_type codes and that hold
    a full chunk of ``size`` bytes, the full chunks of each, and all of
    those chunks as one [C, size] uint8 array."""
    elig = [st for st in states
            if st["e_type"] == e_type
            and not (st["mode"] & COPY_BLOCK_MASK)
            and st["post_len"] >= size]
    counts = [st["post_len"] // size for st in elig]
    chunks = (np.concatenate([st["out"][:n * size].reshape(n, size)
                              for st, n in zip(elig, counts)])
              if elig else None)
    return elig, counts, chunks


def prepare_ans1_batch(states: list, ctx: Context) -> None:
    """Cross-block device batching for the order-1 ANS (-e ANS1) entropy
    stage: the full order-1 chunks of every ANS1 block of the batch in
    ONE launch of the order-1 encode (ops/ans1.py), their frequencies
    from the native host helpers; each block gets its chunk size,
    frequencies, states and payload slice for
    ANSRangeEncoder._encode_device1. The chunk size is that of the coder
    class the entropy factory makes (4 MiB); the gate is the coder's own
    (entropy.ans.ans1_on_device)."""
    size = eans.ANSRangeEncoder.full_chunk(1)
    elig = [st for st in states
            if st["e_type"] == ANS1_TYPE
            and not (st["mode"] & COPY_BLOCK_MASK)
            and st["post_len"] >= size]
    if not elig or not ops.ENABLED or not native.transforms_available():
        return
    dev = coding_device(ctx)
    if not eans.ans1_on_device(dev):
        return
    counts = [st["post_len"] // size for st in elig]
    chunks = np.concatenate([st["out"][:n * size].reshape(n, size)
                             for st, n in zip(elig, counts)])
    freqs, sts, flat, plen = ans1_encode_chunks_np(chunks, dev)
    offs = np.cumsum(plen) - plen
    pos = 0
    for st, n in zip(elig, counts):
        sl = slice(pos, pos + n)
        fend = offs[pos + n - 1] + plen[pos + n - 1]
        st["prepared_entropy"] = (size, freqs[sl], sts[sl],
                                  flat[offs[pos]:fend], plen[sl])
        pos += n


def prepare_huffman_batch(states: list, ctx: Context) -> None:
    """Cross-block device batching for the Huffman entropy stage
    (mirror of prepare_ans0_batch)."""
    if not ops.ENABLED:
        return
    elig, counts, chunks = _full_chunks(states, HUFFMAN_TYPE, dhuff.CHUNK)
    if elig:
        _stash_huffman(elig, counts, dhuff.encode_chunks_np(
            chunks, coding_device(ctx)))


def _stash_huffman(elig: list, counts: list, enc: tuple) -> None:
    """Give each block of elig its slice of one encode_chunks_np result
    (ops.huffman) over all of their full chunks (counts[i] chunks for
    elig[i])."""
    (hdr, hdr_bits, ok, m, flat, npairs, acc, nb, frag_bits) = enc
    plen16 = npairs.sum(1)
    offs16 = np.cumsum(plen16) - plen16
    pos = 0
    for st, n in zip(elig, counts):
        sl = slice(pos, pos + n)
        fstart = 2 * int(offs16[pos])
        fend = 2 * int(offs16[pos + n - 1] + plen16[pos + n - 1])
        st["prepared_entropy"] = (hdr[sl], hdr_bits[sl], ok[sl], m[sl],
                                  flat[fstart:fend], npairs[sl],
                                  acc[sl], nb[sl], frag_bits[sl])
        pos += n


def prepare_ans0_batch(states: list, ctx: Context) -> None:
    """Cross-block device batching: encode every eligible block's full
    16 KiB ANS0 chunks in ONE device call (the device analog of the
    reference's EncodingTask fan-out) and stash per-block slices for
    phase 2. Mutates states in place."""
    if not ops.ENABLED:
        return
    elig, counts, chunks = _full_chunks(states, ANS0_TYPE, dans.CHUNK)
    if elig:
        _stash_ans0(elig, counts, dans.encode_chunks_np(chunks,
                                                        coding_device(ctx)))


def _stash_ans0(elig: list, counts: list, enc: tuple) -> None:
    """Give each block of elig its slice of one encode_chunks_np result
    over all of their full chunks (counts[i] chunks for elig[i])."""
    hdr, bitlen, m, flat, plen = enc
    offs = np.cumsum(plen) - plen
    pos = 0
    for st, n in zip(elig, counts):
        sl = slice(pos, pos + n)
        fstart = offs[pos]
        fend = offs[pos + n - 1] + plen[pos + n - 1]
        st["prepared_entropy"] = (hdr[sl], bitlen[sl], m[sl],
                                  flat[fstart:fend], plen[sl])
        pos += n


def _decode_block_entropy(payload: bytes, bit_len: int, block_id: int,
                          ctx: Context, transform_type: int,
                          entropy_type: int, block_size: int,
                          checksum_bits: int = 0,
                          listeners: Optional[ListenerBus] = None,
                          sinks: Optional[dict] = None):
    """Phase 1 of the per-block inverse pipeline: block header parse +
    entropy decode. With `sinks` ({context key: list}, e.g.
    "_ans0DecodeSink"), the entropy decoder queues its device chunks in
    the list under its key for a later cross-block flush, and the
    returned buffer stays unfilled in those regions until the flush.
    Returns the state tuple for _decode_block_finish."""
    with trace.span("block.entropy", block=block_id,
                    bytes_in=(bit_len + 7) >> 3) as sp:
        ibs = BitReader(payload)
        t_type = transform_type
        e_type = entropy_type

        mode = ibs.read_bits(8)
        skip_flags = 0
        if mode & COPY_BLOCK_MASK:
            t_type = tfactory.NONE_TYPE
            e_type = 0
        else:
            if mode & TRANSFORMS_MASK:
                skip_flags = ibs.read_bits(8)
            else:
                skip_flags = ((mode << 4) | 0x0F) & 0xFF

        data_size = 1 + ((mode >> 5) & 0x03)
        pre_len = ibs.read_bits(8 * data_size)
        max_transform_size = min(max(block_size + block_size // 2, 2048), MAX_BLOCK_SIZE)
        if pre_len <= 0 or pre_len > max_transform_size:
            raise KanziError(f"Invalid compressed block length: {pre_len}",
                             Error.ERR_READ_FILE)

        checksum1 = 0
        if checksum_bits:
            checksum1 = ibs.read_bits(checksum_bits)

        if listeners:
            listeners.notify(Event(EventType.BEFORE_ENTROPY, block_id,
                                   (bit_len + 7) >> 3,
                                   checksum=checksum1 if checksum_bits else None,
                                   hash_bits=checksum_bits))

        bctx = ctx.copy()
        bctx.put("blockId", block_id)
        bctx.put("size", pre_len)
        # the decode output buffer capacity (DecodingTask allocates
        # max(blockLength, payload bytes)); TEXT sizes its dictionary from it
        bctx.put("_decodeCapacity", max(block_size, (bit_len + 7) >> 3))
        for key, sink in (sinks or {}).items():
            bctx.put(key, sink)

        ed = efactory.new_decoder(ibs, bctx, e_type)
        buf = ed.decode(pre_len)
        if len(buf) != pre_len:
            raise KanziError("Entropy decoding failed", Error.ERR_PROCESS_BLOCK)
        ed.dispose()
        if sp:
            sp.set(bytes_out=pre_len)
        return (buf, bctx, block_id, t_type, skip_flags, pre_len,
                checksum_bits, checksum1, listeners)


def _decode_block_finish(state, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Phase 2: inverse transform chain + checksum + events. Must run
    after any pending entropy sink flush."""
    (buf, bctx, block_id, t_type, skip_flags, pre_len,
     checksum_bits, checksum1, listeners) = state
    with trace.span("block.inverse", block=block_id, bytes_in=pre_len) as sp:
        if listeners:
            listeners.notify(Event(EventType.AFTER_ENTROPY, block_id, pre_len,
                                   checksum=checksum1 if checksum_bits else None,
                                   hash_bits=checksum_bits))
            listeners.notify(Event(EventType.BEFORE_TRANSFORM, block_id, pre_len,
                                   checksum=checksum1 if checksum_bits else None,
                                   hash_bits=checksum_bits))

        transform = tfactory.new_transform(bctx, t_type)
        transform.skip_flags = skip_flags
        data = None
        if out is not None and checksum_bits == 0:
            n = transform.inverse_into(buf, out)
            if n is not None:
                data = out[:n]
        if data is None:
            data = transform.inverse(buf)

        if checksum_bits == 32:
            checksum2 = xxhash32(data.tobytes())
            if checksum2 != checksum1:
                raise KanziError(
                    f"Corrupted bitstream: expected checksum {checksum1:x}, found {checksum2:x}",
                    Error.ERR_CRC_CHECK)
        elif checksum_bits == 64:
            checksum2 = xxhash64(data.tobytes())
            if checksum2 != checksum1:
                raise KanziError(
                    f"Corrupted bitstream: expected checksum {checksum1:x}, found {checksum2:x}",
                    Error.ERR_CRC_CHECK)

        if listeners:
            listeners.notify(Event(EventType.AFTER_TRANSFORM, block_id, len(data),
                                   checksum=checksum1 if checksum_bits else None,
                                   hash_bits=checksum_bits))
        if sp:
            sp.set(bytes_out=len(data))
        return data


def decode_block(payload: bytes, bit_len: int, block_id: int, ctx: Context,
                 transform_type: int, entropy_type: int, block_size: int,
                 checksum_bits: int = 0,
                 listeners: Optional[ListenerBus] = None,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-block inverse pipeline (DecodingTask::run :790-1040).
    out: optional preallocated destination view — the final inverse
    stage then writes in place (the returned array is out[:n])."""
    state = _decode_block_entropy(payload, bit_len, block_id, ctx,
                                  transform_type, entropy_type,
                                  block_size, checksum_bits, listeners)
    return _decode_block_finish(state, out)


class CompressedWriter:
    """ostream-facade equivalent: accepts bytes, emits the compressed file.

    Matches CompressedOutputStream(os, jobs, entropy, transform, blockSize,
    checksum, originalSize, headerless) (src/io/CompressedOutputStream.hpp:
    136-172).
    """

    def __init__(self, out, transform: str = "NONE", entropy: str = "NONE",
                 block_size: int = 4 * 1024 * 1024, checksum_bits: int = 0,
                 original_size: int = 0, headerless: bool = False,
                 jobs: int = 1, ctx: Optional[Context] = None, device=None):
        if block_size < MIN_BLOCK_SIZE or block_size > MAX_BLOCK_SIZE:
            raise KanziError(f"Invalid block size: {block_size}", Error.ERR_BLOCK_SIZE)
        if block_size & -16 != block_size:
            # the header stores blockSize>>4: low 4 bits must be zero
            raise KanziError("The block size must be a multiple of 16", Error.ERR_BLOCK_SIZE)
        if checksum_bits not in (0, 32, 64):
            raise KanziError("Invalid checksum size", Error.ERR_INVALID_PARAM)
        if not 1 <= jobs <= MAX_CONCURRENCY:
            raise KanziError(f"Invalid number of jobs: {jobs}", Error.ERR_INVALID_PARAM)
        self.out = out
        self.ctx = ctx.copy() if ctx is not None else Context()
        self.transform_type = tfactory.transform_name_to_type(transform)
        self.entropy_type = efactory.entropy_name_to_type(entropy)
        if device is not None:
            self.ctx.put("device", str(device))
        self.ctx.put("entropy", efactory.entropy_type_to_name(self.entropy_type))
        self.ctx.put("transform", tfactory.transform_type_to_name(self.transform_type))
        self.ctx.put("blockSize", block_size)
        self.ctx.put("bsVersion", FORMAT_VERSION)
        self.block_size = block_size
        self.checksum_bits = checksum_bits
        self.original_size = original_size
        self.headerless = headerless
        self.jobs = jobs
        self.listeners = ListenerBus()
        self._pending = bytearray()
        self._block_id = 0
        self._obs = BitWriter(sink=out)
        self._header_written = False
        self._closed = False
        # per task-slot persistent buffer capacities [input, work]; block
        # b (from 1) runs in slot (b - 1) % jobs
        self.slot_caps = [[0, 0] for _ in range(jobs)]
        # cross-block device batching: queue phase-1 states and run one
        # device call for all queued blocks' entropy chunks (TPU analog of
        # the reference's EncodingTask fan-out); bounded by bytes queued
        self._block_queue = []
        self._batch_bytes_max = self.ctx.get_int(
            "deviceBatchBytes", 256 * 1024 * 1024)

    # --- header (writeHeader :277-342) ---
    def _write_header(self) -> None:
        if self._header_written or self.headerless:
            return
        self._header_written = True
        obs = self._obs
        obs.write_bits(MAGIC, 32)
        obs.write_bits(FORMAT_VERSION, 4)
        ck_size = {0: 0, 32: 1, 64: 2}[self.checksum_bits]
        obs.write_bits(ck_size, 2)
        obs.write_bits(self.entropy_type, 5)
        obs.write_bits(self.transform_type, 48)
        obs.write_bits(self.block_size >> 4, 28)
        if self.original_size == 0 or self.original_size >= (1 << 48):
            sz_mask = 0
        else:
            sz_mask = (stats.log2(self.original_size) >> 4) + 1
        obs.write_bits(sz_mask, 2)
        if sz_mask:
            obs.write_bits(self.original_size, 16 * sz_mask)
        obs.write_bits(0, 15)
        cksum = _header_checksum(FORMAT_VERSION, ck_size, self.entropy_type,
                                 self.transform_type, self.block_size,
                                 sz_mask, self.original_size)
        obs.write_bits(cksum, 24)

    def write(self, data) -> int:
        if self._closed:
            raise KanziError("Stream closed", Error.ERR_WRITE_FILE)
        n = len(data)
        # zero-copy fast path: whole blocks are viewed straight out of
        # the caller's buffer instead of round-tripping through the
        # pending bytearray (2 fewer full copies of the input)
        view = memoryview(data)
        pos = 0
        if self._pending:
            need = self.block_size - len(self._pending)
            if n < need:
                self._pending += view
                return n
            self._pending += view[:need]
            pos = need
            block = bytes(self._pending)
            self._pending.clear()
            self._emit_block(np.frombuffer(block, dtype=np.uint8))
        while n - pos >= self.block_size:
            self._emit_block(np.frombuffer(
                view[pos:pos + self.block_size], dtype=np.uint8))
            pos += self.block_size
        if pos < n:
            self._pending += view[pos:]
        return n

    def _emit_block(self, block: np.ndarray) -> None:
        self._block_queue.append(block)
        queued = sum(len(b) for b in self._block_queue)
        if queued >= self._batch_bytes_max or len(self._block_queue) >= 64:
            self._flush_blocks()

    def _flush_blocks(self) -> None:
        if not self._block_queue:
            return
        self._write_header()
        work = []
        for block in self._block_queue:
            self._block_id += 1
            slot = (self._block_id - 1) % self.jobs
            work.append((block, self._block_id, slot))
        self._block_queue.clear()
        if self.jobs > 1 and len(work) > 1:
            # intra-file block concurrency (the EncodingTask fan-out,
            # CompressedOutputStream.cpp:476-540): one worker per task
            # slot so each slot's buffer-capacity evolution stays
            # sequential (capacity semantics influence skip decisions,
            # so this preserves byte-identity with -j 1); the hot loops
            # are native ctypes calls that release the GIL
            from concurrent.futures import ThreadPoolExecutor
            by_slot = {}
            for i, (block, bid, slot) in enumerate(work):
                by_slot.setdefault(slot, []).append((i, block, bid, slot))
            results = [None] * len(work)

            def run_slot(items):
                for i, block, bid, slot in items:
                    results[i] = _encode_block_phase1(
                        block, bid, self.ctx, self.transform_type,
                        self.entropy_type, self.checksum_bits,
                        self.listeners, slot_caps=self.slot_caps[slot])

            with ThreadPoolExecutor(max_workers=self.jobs) as ex:
                list(ex.map(run_slot, by_slot.values()))
            states = results
        else:
            states = [
                _encode_block_phase1(
                    block, bid, self.ctx, self.transform_type,
                    self.entropy_type, self.checksum_bits, self.listeners,
                    slot_caps=self.slot_caps[slot])
                for block, bid, slot in work]
        prepare_ans0_batch(states, self.ctx)
        prepare_huffman_batch(states, self.ctx)
        prepare_ans1_batch(states, self.ctx)
        prepare_fpaq_batch(states, self.ctx)
        self.commit_states(states)

    def commit_states(self, states: list) -> None:
        """Write the header if it is due, then each block's phase-1 state
        (_encode_block_phase1, in block order, its batched entropy
        prepared or not) through phase 2 into the stream. For a caller
        that runs the blocks' stages itself and then close()s."""
        with trace.span("container.commit", blocks=len(states)):
            self._write_header()
            verbose5 = self.ctx.get_int("verbosity", 0) > 4 and self.listeners
            for st in states:
                payload, bits = _encode_block_phase2(st, self.listeners)
                if verbose5:
                    self.listeners.notify(Event(
                        EventType.BLOCK_INFO, st["block_id"],
                        (bits + 7) >> 3, offset=self._obs.written(),
                        skip_flags=st["skip_flags"]))
                self._commit(payload, bits)

    def _commit(self, payload: bytes, written: int) -> None:
        # ordered commit: [5b lw-3][lw bits bit-length][payload bits]
        lw = 3 if written < 8 else stats.log2(written >> 3) + 4
        self._obs.write_bits(lw - 3, 5)
        self._obs.write_bits(written, lw)
        self._obs._append_bit_run(payload, written)

    def close(self) -> None:
        if self._closed:
            return
        if self._pending:
            block = bytes(self._pending)
            self._pending.clear()
            self._emit_block(np.frombuffer(block, dtype=np.uint8))
        self._flush_blocks()
        with trace.span("container.commit"):
            self._write_header()  # empty input still emits a header
            # end of stream marker (:415-417)
            self._obs.write_bits(0, 5)
            self._obs.write_bits(0, 3)
            self._obs.close_to_sink()
        self._obs = BitWriter(sink=self.out)
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class CompressedReader:
    """istream-facade equivalent of CompressedInputStream."""

    def __init__(self, data, jobs: int = 1, ctx: Optional[Context] = None,
                 headerless: bool = False, transform: str = "NONE",
                 entropy: str = "NONE", block_size: int = 4 * 1024 * 1024,
                 checksum_bits: int = 0, original_size: int = 0,
                 bs_version: int = FORMAT_VERSION, device=None,
                 decode_sinks: Optional[dict] = None,
                 sink_window: int = _SINK_WINDOW):
        """data: bytes-like (in-memory) or a binary file object (streamed
        incrementally -- CompressedInputStream.cpp:336-508 reads the same
        way; peak memory stays O(block size)). decode_sinks: {context
        key: flush(entries)}, the entropy decoders' cross-block sinks and
        what decodes their queued entries, once every sink_window blocks
        (sequential decode only); default the ANS0 sink where the device
        path is live."""
        if isinstance(data, (bytes, bytearray, memoryview)):
            self.ibs = BitReader(data)
        else:
            from kanzi_tpu_torch.bitstream.streaming import StreamingBitReader
            self.ibs = StreamingBitReader(data)
        self.ctx = ctx.copy() if ctx is not None else Context()
        self.jobs = jobs
        self.listeners = ListenerBus()
        self.headerless = headerless
        self._blocks_decoded = 0
        self.output_size = 0
        self.decode_sinks = decode_sinks
        self.sink_window = sink_window
        if headerless:
            self.transform_type = tfactory.transform_name_to_type(transform)
            self.entropy_type = efactory.entropy_name_to_type(entropy)
            self.block_size = block_size
            self.checksum_bits = checksum_bits
            self.output_size = original_size
            self.bs_version = bs_version
        else:
            self._read_header()
        if device is not None:
            self.ctx.put("device", str(device))
        self.ctx.put("bsVersion", self.bs_version)
        self.ctx.put("entropy", efactory.entropy_type_to_name(self.entropy_type))
        self.ctx.put("blockSize", self.block_size)

    def _read_header(self) -> None:
        ibs = self.ibs
        if ibs.read_bits(32) != MAGIC:
            raise KanziError("Invalid stream type", Error.ERR_INVALID_FILE)
        bs_version = ibs.read_bits(4)
        if bs_version > FORMAT_VERSION:
            raise KanziError(
                f"Invalid bitstream, cannot read this version of the stream: {bs_version}",
                Error.ERR_STREAM_VERSION)
        self.bs_version = bs_version
        ck_size = 0
        if bs_version >= 6:
            ck_size = ibs.read_bits(2)
            if ck_size == 3:
                raise KanziError("Invalid bitstream, incorrect block checksum size",
                                 Error.ERR_INVALID_FILE)
            self.checksum_bits = {0: 0, 1: 32, 2: 64}[ck_size]
        else:
            self.checksum_bits = 32 if ibs.read_bit() else 0
        self.entropy_type = ibs.read_bits(5)
        try:
            efactory.entropy_type_to_name(self.entropy_type)
        except ValueError:
            raise KanziError(
                f"Invalid bitstream, unknown entropy type: {self.entropy_type}",
                Error.ERR_INVALID_CODEC)
        self.transform_type = ibs.read_bits(48)
        try:
            tfactory.transform_type_to_name(self.transform_type)
        except ValueError:
            raise KanziError(
                f"Invalid bitstream, unknown transform type: {self.transform_type}",
                Error.ERR_INVALID_CODEC)
        self.block_size = ibs.read_bits(28) << 4
        if self.block_size < MIN_BLOCK_SIZE or self.block_size > MAX_BLOCK_SIZE:
            raise KanziError(
                f"Invalid bitstream, incorrect block size: {self.block_size}",
                Error.ERR_BLOCK_SIZE)
        sz_mask = ibs.read_bits(2)
        if sz_mask:
            self.output_size = ibs.read_bits(16 * sz_mask)
        if bs_version >= 6:
            ibs.read_bits(15)
        crc_size = 16 if bs_version <= 5 else 24
        cksum1 = ibs.read_bits(crc_size)
        if bs_version >= 6:
            cksum2 = _header_checksum(bs_version, ck_size, self.entropy_type,
                                      self.transform_type, self.block_size,
                                      sz_mask, self.output_size)
        else:  # legacy folding (readHeader :628-645)
            M = 0xFFFFFFFF
            HASH = 0x1E35A7BD
            ck = (HASH * bs_version) & M
            ck ^= (HASH * ((~self.entropy_type) & M)) & M
            ck ^= (HASH * (((~self.transform_type) >> 32) & M)) & M
            ck ^= (HASH * ((~self.transform_type) & M)) & M
            ck ^= (HASH * ((~self.block_size) & M)) & M
            if sz_mask:
                ck ^= (HASH * (((~self.output_size) >> 32) & M)) & M
                ck ^= (HASH * ((~self.output_size) & M)) & M
            cksum2 = ((ck >> 23) ^ (ck >> 3)) & M
        if cksum1 != (cksum2 & ((1 << crc_size) - 1)):
            raise KanziError("Invalid bitstream, header checksum mismatch",
                             Error.ERR_CRC_CHECK)
        self.emit_header_event()

    def emit_header_event(self) -> None:
        """Notify AFTER_HEADER_DECODING with the parsed header fields
        (HeaderInfo payload, src/Event.hpp). Safe to call again after
        attaching listeners (the CLI attaches post-construction)."""
        if not self.listeners:
            return
        info = {"bsVersion": self.bs_version,
                "checksum": self.checksum_bits,
                "blockSize": self.block_size,
                "entropy": efactory.entropy_type_to_name(self.entropy_type),
                "transform": tfactory.transform_type_to_name(
                    self.transform_type),
                "originalSize": self.output_size or None,
                "inputName": self.ctx.get_str("inputName", ""),
                "fileSize": self.ctx.get_int("fileSize", 0) or None}
        self.listeners.notify(Event(EventType.AFTER_HEADER_DECODING, 0,
                                    self.block_size, header_info=info))

    def read_all(self, from_block: int = 1, to_block: int = MAX_BLOCK_ID) -> bytes:
        """Decode every block in order; supports --from/--to block ranges
        (CompressedInputStream.cpp:836-867). When the header carries the
        original size (full-range decode), the output buffer is
        preallocated — no bytearray growth reallocs."""
        total = self.output_size
        if total and from_block == 1 and to_block == MAX_BLOCK_ID:
            # decode straight into the result bytes' buffer (filled
            # before the object is ever exposed) — skips the final
            # full-size copy a bytearray/ndarray staging would need
            result, out = _alloc_bytes_buffer(total)
            bs = self.block_size

            def view(block_id):
                # non-final blocks decode to exactly block_size bytes,
                # so block i's destination offset is fixed up front
                start = (block_id - 1) * bs
                if start >= total:
                    return None
                return out[start:min(start + bs, total)]

            pos = 0
            # a corrupt stream's block may decode to other than
            # block_size bytes: the blocks after it no longer sit at
            # their fixed offsets, so from there on each is copied out
            # as it comes (never a byte of out that no block wrote)
            parts = None
            gen = self.read_blocks_np(from_block, to_block,
                                      out_view_fn=view)
            for k, data in enumerate(gen):
                if parts is None and (pos != k * bs or data.size > bs):
                    parts = [np.array(out[:pos])]
                if parts is not None:
                    parts.append(np.array(data))
                    continue
                if pos + data.size > total:      # lying header: fall back
                    rest = [np.array(out[:pos]), data] + list(gen)
                    return np.concatenate(rest).tobytes()
                if data.base is not out:         # not decoded in place
                    with trace.span("container.output", bytes=data.size):
                        out[pos:pos + data.size] = data
                pos += data.size
            if parts is not None:
                return np.concatenate(parts).tobytes()
            if pos == total and result is not None:
                return result
            return out[:pos].tobytes()
        chunks = list(self.read_blocks_np(from_block, to_block))
        if not chunks:
            return b""
        return np.concatenate(chunks).tobytes()

    def read_blocks(self, from_block: int = 1, to_block: int = MAX_BLOCK_ID):
        """Yield decoded blocks in order as bytes."""
        for data in self.read_blocks_np(from_block, to_block):
            yield data.tobytes()

    def read_blocks_np(self, from_block: int = 1,
                       to_block: int = MAX_BLOCK_ID,
                       out_view_fn=None):
        """Yield decoded blocks in order as uint8 arrays (streaming
        decode: with a file-object source and a consumer that writes
        each block out, peak memory is O(block size)). With jobs > 1, up
        to `jobs` block decodes are kept in flight as futures (the
        DecodingTask prefetch, CompressedInputStream.cpp:336-344): the
        shared bitstream is read sequentially here and the
        entropy+inverse work fans out."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        ex = ThreadPoolExecutor(max_workers=self.jobs) \
            if self.jobs > 1 else None
        inflight = deque()
        # cross-block device entropy batching (sequential path only):
        # the ANS0 sink where the device path is live, or the caller's
        flushes = self.decode_sinks
        if flushes is None and ops.ENABLED:
            flushes = {"_ans0DecodeSink":
                       lambda entries: ans0_flush_sink(entries, self.ctx)}
        sinks = {k: [] for k in flushes} if ex is None and flushes else None
        pending = []

        def flush():
            for key, entries in sinks.items():
                if entries:
                    flushes[key](entries)
                entries.clear()
            for st, v in pending:
                self._blocks_decoded += 1
                yield _decode_block_finish(st, out=v)
            pending.clear()
        try:
            block_id = 0
            while True:
                block_id += 1
                lr = 3 + self.ibs.read_bits(5)
                bits = self.ibs.read_bits(lr)
                if bits == 0:
                    break
                if bits > (1 << 34):
                    raise KanziError("Invalid block size",
                                     Error.ERR_BLOCK_SIZE)
                with trace.span("container.frames", block=block_id):
                    payload = self.ibs.read_payload(bits)
                if block_id < from_block:
                    continue
                if block_id >= to_block:
                    break
                if self.ctx.get_int("verbosity", 0) > 4 and self.listeners:
                    self.listeners.notify(Event(
                        EventType.BLOCK_INFO, block_id, (bits + 7) >> 3,
                        offset=self.ibs.tell() - bits))
                view = out_view_fn(block_id) if out_view_fn else None
                if ex is None:
                    if sinks is not None:
                        # cross-block device batching: queue this block's
                        # entropy phase; one flush per window decodes
                        # every queued chunk of every block in O(1)
                        # device calls (CompressedInputStream's prefetch
                        # analog for the accelerator)
                        pending.append((_decode_block_entropy(
                            payload, bits, block_id, self.ctx,
                            self.transform_type, self.entropy_type,
                            self.block_size, self.checksum_bits,
                            self.listeners, sinks=sinks), view))
                        if len(pending) >= self.sink_window:
                            yield from flush()
                        continue
                    data = decode_block(payload, bits, block_id, self.ctx,
                                        self.transform_type,
                                        self.entropy_type,
                                        self.block_size,
                                        self.checksum_bits,
                                        self.listeners, out=view)
                    self._blocks_decoded += 1
                    yield data
                    continue
                inflight.append(ex.submit(
                    decode_block, payload, bits, block_id, self.ctx,
                    self.transform_type, self.entropy_type,
                    self.block_size, self.checksum_bits, self.listeners,
                    view))
                while len(inflight) >= self.jobs:
                    data = inflight.popleft().result()
                    self._blocks_decoded += 1
                    yield data
            if pending:
                yield from flush()
            while inflight:
                data = inflight.popleft().result()
                self._blocks_decoded += 1
                yield data
        finally:
            if ex is not None:
                ex.shutdown(wait=False, cancel_futures=True)


# --- convenience one-shot APIs ---

def compress_bytes(data: bytes, transform: str = "NONE", entropy: str = "NONE",
                   block_size: int = 4 * 1024 * 1024, checksum_bits: int = 0,
                   headerless: bool = False, jobs: int = 1,
                   ctx: Optional[Context] = None, device=None) -> bytes:
    sink = _pyio.BytesIO()
    w = CompressedWriter(sink, transform=transform, entropy=entropy,
                         block_size=block_size, checksum_bits=checksum_bits,
                         original_size=len(data), headerless=headerless,
                         jobs=jobs, ctx=ctx, device=device)
    w.write(data)
    w.close()
    return sink.getvalue()


def decompress_bytes(data: bytes, jobs: int = 1, ctx: Optional[Context] = None,
                     device=None, **headerless_kwargs) -> bytes:
    r = CompressedReader(data, jobs=jobs, ctx=ctx, device=device,
                         **headerless_kwargs)
    return r.read_all()
