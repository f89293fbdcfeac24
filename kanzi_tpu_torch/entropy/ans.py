"""Interleaved 4-state range-ANS (Duda/Giesen), order 0/1.

Reference: src/entropy/ANSRange{Encoder,Decoder}.{cpp,hpp}.
- ANS_TOP = 1<<15; chunk = 16 KiB << 8*order (cap 1<<27); logRange 12
  (order 1: 11). Frequencies normalized to 1<<lr and sent via
  encodeAlphabet + log-packed freqs-1 in groups of 6/8 (:120-155).
- Chunk payload = varint byte count + 4 x 32-bit final states + bytes
  from the backward 4-lane interleave; decoder runs forward
  (ANSRangeDecoder.cpp:decodeChunk). Blocks <= 32 bytes stored raw.
- Symbol step: st' = st + bias + ((st * invFreq) >> invShift) * cmplFreq
  (ANSRangeEncoder.hpp:92-131), 16-bit renorm when st >= xMax.

The implementation is *lane-batched*: every chunk of a block advances its
4 ANS states in lockstep, so each step is one vectorized op over
(num_chunks x 4) lanes instead of a scalar loop — the exact schedule the
Pallas kernel uses with blocks/chunks as grid cells.

In this package the full 16 KiB order-0 chunks run on the CUDA kernels
of kanzi_tpu_torch.ops.ans, on the device the container put in the
context (coding_device), and, where that device is a CUDA card, the full
4 MiB order-1 chunks on the encode kernels of kanzi_tpu_torch.ops.ans1:
those of every -e ANS1 block of a writer batch in one launch
(io.compressed_stream.prepare_ans1_batch), ROLZ's order-1 literal
sub-streams of 4 MiB or more in one launch each.
Order-1 decode runs on the host's native coder, as in the JAX package.
PyTorch's CUDA launches are thread-safe, so worker threads (the reader's
-j prefetch) use the device too, where the JAX package keeps its device
path on the main thread.
"""

from __future__ import annotations

import numpy as np
import torch

import kanzi_tpu_torch.ops as ops
from kanzi_tpu_torch.bitstream import BitReader, BitWriter
from kanzi_tpu_torch.entropy import utils as eu
from kanzi_tpu_torch.entropy.base import EntropyDecoder, EntropyEncoder
from kanzi_tpu_torch.ops import ans as dans
from kanzi_tpu_torch.ops import ans1 as dans1
from kanzi_tpu_torch.utils import native

ANS_TOP = 1 << 15
DEFAULT_CHUNK_SIZE = 16384
DEFAULT_LOG_RANGE = 12
MIN_CHUNK_SIZE = 1024
MAX_CHUNK_SIZE = 1 << 27


def _device_ans_enabled() -> bool:
    return ops.ENABLED


def coding_device(ctx) -> torch.device:
    """The device the container put in the context, else the CUDA
    device (which raises when there is none)."""
    dev = ctx.get("device") if ctx else None
    return torch.device(dev) if dev is not None else ops.device()


def ans1_on_device(dev: torch.device) -> bool:
    """True where the full order-1 chunks go to the order-1 encode kernels
    on ``dev``: a CUDA device. On the CPU their plain version is a
    Python loop of a million steps a chunk, so the native host coder
    codes them."""
    return dev.type == "cuda"


def _sym_encode_tables(freqs: np.ndarray, lr: int):
    """Per-symbol encode constants (ANSEncSymbol::reset).

    freqs: (..., 256) normalized frequencies; returns dict of arrays of the
    same leading shape.
    """
    f = freqs.astype(np.int64)
    f = np.minimum(f, (1 << lr) - 1)
    cum = np.cumsum(f, axis=-1) - f  # cumFreq per symbol
    xmax = ((ANS_TOP >> lr) << 16) * f
    cmpl = (1 << lr) - f
    # freq < 2 path
    small = f < 2
    ftmp = np.maximum(f, 2)
    # smallest shift with freq <= 1<<shift == floor(log2(freq-1)) + 1;
    # exact for freq < 2^15 (float64 cannot mis-round across an integer)
    shift = np.floor(np.log2(ftmp - 1)).astype(np.int64) + 1
    ftmp = np.maximum(f, 1)
    inv_freq = np.where(
        small, 0xFFFFFFFF,
        (((np.uint64(1) << (shift + 31).astype(np.uint64))
          + ftmp.astype(np.uint64) - np.uint64(1)) // ftmp.astype(np.uint64))
        & np.uint64(0xFFFFFFFF))
    inv_shift = np.where(small, 32, 32 + shift - 1)
    bias = np.where(small, cum + (1 << lr) - 1, cum)
    return {"xmax": xmax, "bias": bias, "cmpl": cmpl,
            "inv_freq": inv_freq.astype(np.uint64),
            "inv_shift": inv_shift.astype(np.uint64),
            "freq": f, "cum": cum}


class ANSRangeEncoder(EntropyEncoder):
    # the chunk size (before the order's shift) where the caller gives none
    default_chunk_size = DEFAULT_CHUNK_SIZE

    def __init__(self, obs: BitWriter, ctx=None, order: int = 0,
                 chunk_size: int | None = None,
                 log_range: int = DEFAULT_LOG_RANGE):
        super().__init__(obs, ctx)
        if chunk_size is None:
            chunk_size = self.default_chunk_size
        if order not in (0, 1):
            raise ValueError("ANS Codec: order must be 0 or 1")
        if not MIN_CHUNK_SIZE <= chunk_size <= MAX_CHUNK_SIZE:
            raise ValueError("ANS Codec: invalid chunk size")
        if not 8 <= log_range <= 15:
            raise ValueError("ANS Codec: invalid range")
        self.order = order
        self.chunk_size = min(chunk_size << (8 * order), MAX_CHUNK_SIZE)
        self.log_range = log_range if order == 0 else max(log_range - 1, 8)

    @classmethod
    def full_chunk(cls, order: int) -> int:
        """The chunk the coder cuts at ``order`` where the caller gives no
        chunk size (order 1: 4 MiB)."""
        return min(cls.default_chunk_size << (8 * order), MAX_CHUNK_SIZE)

    # --- header ---
    def _encode_header(self, alphabet, freqs, lr):
        """encodeHeader (:118-155): alphabet + grouped log-packed freqs-1.
        alphabet is always the nonzero support of freqs, so the native
        path derives it itself."""
        if native.transforms_available():
            data, nb = native.ans_enc_header(np.asarray(freqs[:256]), lr)
            self.obs._append_bit_run(data, nb)
            return
        eu.encode_alphabet(self.obs, alphabet)
        count = len(alphabet)
        if count <= 1:
            return
        chk = 8 if count >= 64 else 6
        llr = int(lr).bit_length()  # _log2(lr)+1
        i = 1
        while i < count:
            endj = min(i + chk, count)
            mx = max(int(freqs[alphabet[j]]) - 1 for j in range(i, endj))
            log_max = 0 if mx == 0 else mx.bit_length()
            self.obs.write_bits(log_max, llr)
            if log_max:
                for j in range(i, endj):
                    self.obs.write_bits(int(freqs[alphabet[j]]) - 1, log_max)
            i += chk

    def _normalize_context(self, hist, total, lr):
        f = hist.astype(np.int64).copy()
        alphabet = eu.normalize_frequencies(f, 256, total, 1 << lr)
        return f, alphabet

    def encode(self, block: np.ndarray) -> int:
        block = np.asarray(block, dtype=np.uint8)
        count = len(block)
        if count <= 32:
            self.obs.write_bytes(block)
            return count
        lr = self.log_range
        start = 0
        if (self.order == 0 and lr == 12 and self.chunk_size == 16384
                and count >= 16384 and _device_ans_enabled()):
            start = self._encode_device(block, count)
            if start >= count:
                return count
        elif (self.order == 1 and lr == 11 and count >= self.chunk_size
                and _device_ans_enabled() and native.transforms_available()
                and (self._prepared1(count) is not None
                     or (self.chunk_size == dans1.CHUNK1
                         and ans1_on_device(coding_device(self.ctx))))):
            # the container's batch (prepare_ans1_batch), or this block's
            # own launch
            start = self._encode_device1(block, count)
            if start >= count:
                return count
        if start < count:
            if native.transforms_available():
                # whole-block native path: all chunk headers + payloads
                # in one call (bit-exact with the loop below)
                if self.order == 0:
                    data, nb = native.ans0_enc_block(block[start:],
                                                    self.chunk_size, lr)
                else:
                    data, nb = native.ans1_enc_block(block[start:],
                                                    self.chunk_size, lr)
                self.obs._append_bit_run(data, nb)
                return count
        chunks = []
        while start < count:
            size = min(self.chunk_size, count - start)
            chunks.append((start, size))
            start += size

        for cstart, csize in chunks:
            chunk = block[cstart:cstart + csize]
            self.obs.write_bits(lr - 8, 3)
            if self.order == 0:
                hist = np.bincount(chunk, minlength=256).astype(np.int64)
                freqs, alphabet = self._normalize_context(hist, csize, lr)
                self._encode_header(alphabet, freqs, lr)
                if len(alphabet) <= 1:
                    continue  # single-symbol chunk: header only
                tabs = _sym_encode_tables(freqs, lr)
                self._encode_chunk0(chunk, tabs)
            else:
                if lr == 11 and native.transforms_available():
                    # native histogram + per-context normalize + headers
                    tabs_freqs = native.ans1_norm(native.ans1_hist(chunk))
                    for k in range(256):
                        data, nb = native.ans_enc_header(tabs_freqs[k], lr)
                        self.obs._append_bit_run(data, nb)
                else:
                    hist = self._order1_histogram(chunk)
                    tabs_freqs = np.zeros((256, 256), dtype=np.int64)
                    for k in range(256):
                        total = int(hist[k].sum())
                        if total == 0:
                            eu.encode_alphabet(self.obs,
                                               np.zeros(0, np.int64))
                            continue
                        freqs, alphabet = self._normalize_context(
                            hist[k], total, lr)
                        self._encode_header(alphabet, freqs, lr)
                        tabs_freqs[k] = freqs[:256]
                tabs = _sym_encode_tables(tabs_freqs, lr)
                self._encode_chunk1(chunk, tabs)
        return count

    def _encode_device(self, block: np.ndarray, count: int) -> int:
        """Encode every full 16 KiB chunk with the CUDA kernels
        (kanzi_tpu_torch.ops.ans), or take the container's prepared
        batch, and splice headers and payloads into the bitstream.
        Returns where the host tail starts. Bit-identical with the host
        path by construction."""
        full = count // dans.CHUNK
        prep = getattr(self, "prepared_device", None)
        if prep is not None and len(prep[4]) == full:
            hdr, bitlen, m, flat, plen = prep
        else:
            hdr, bitlen, m, flat, plen = dans.encode_chunks_np(
                block[:full * dans.CHUNK].reshape(full, dans.CHUNK),
                coding_device(self.ctx))
        offs = np.cumsum(plen) - plen
        if native.available():
            # one native splice for the whole batch: headers from hdr
            # (row-aligned), payload spans from flat
            multi = m > 1
            n_runs = full + int(multi.sum())
            sel = np.zeros(n_runs, np.uint8)
            roffs = np.zeros(n_runs, np.uint64)
            rbits = np.zeros(n_runs, np.uint64)
            head = np.arange(full) + np.cumsum(multi) - multi
            roffs[head] = np.arange(full) * hdr.shape[1]
            rbits[head] = bitlen
            body = head[multi] + 1
            sel[body] = 1
            roffs[body] = offs[multi]
            rbits[body] = 8 * plen[multi]
            data, nbits = native.concat_runs(hdr.reshape(-1), flat, sel,
                                             roffs, rbits)
            self.obs._append_bit_run(data, nbits)
        else:
            for c in range(full):
                bl = int(bitlen[c])
                self.obs._append_bit_run(hdr[c, :(bl + 7) >> 3].tobytes(),
                                         bl)
                if m[c] > 1:
                    self.obs.write_bytes(
                        flat[offs[c]:offs[c] + plen[c]].tobytes())
        return full * dans.CHUNK

    def _prepared1(self, count: int):
        """The container's prepared order-1 batch for this block
        (prepare_ans1_batch) where it covers the block's full chunks at
        this coder's chunk size, else None."""
        prep = getattr(self, "prepared_device", None)
        if (prep is not None and prep[0] == self.chunk_size
                and len(prep[4]) == count // self.chunk_size):
            return prep
        return None

    def _encode_device1(self, block: np.ndarray, count: int) -> int:
        """Encode every full order-1 chunk (self.chunk_size bytes): take
        the container's prepared batch, or run all of the block's full
        chunks through one launch of the CUDA kernels
        (kanzi_tpu_torch.ops.ans1); the frequencies and headers come from
        the native host helpers, as in kanzi_tpu. Returns where the host
        tail starts. Bit-identical with the host path by construction."""
        lr = self.log_range
        size = self.chunk_size
        full = count // size
        prep = self._prepared1(count)
        if prep is None:
            prep = (size, *ans1_encode_chunks_np(
                block[:full * size].reshape(full, size),
                coding_device(self.ctx)))
        _, freqs, states, flat, plen = prep
        offs = np.cumsum(plen) - plen
        for ci in range(full):
            self.obs.write_bits(lr - 8, 3)
            for k in range(256):
                data, nb = native.ans_enc_header(freqs[ci, k], lr)
                self.obs._append_bit_run(data, nb)
            self._emit_chunk(states[ci],
                             flat[offs[ci]:offs[ci] + plen[ci]].tobytes(),
                             b"")
        return full * size

    def _order1_histogram(self, chunk):
        """4-quarter order-1 histogram, prev=0 seeded at each quarter start
        (rebuildStatistics + Global::computeHistogram order-1 semantics)."""
        n = len(chunk)
        hist = np.zeros((256, 256), dtype=np.int64)
        quarter = n >> 2
        if quarter == 0:
            spans = [(0, n)]
        else:
            spans = [(k * quarter, quarter) for k in range(4)]
        for (s, ln) in spans:
            part = chunk[s:s + ln]
            if ln == 0:
                continue
            idx = part[:-1].astype(np.int64) * 256 + part[1:]
            np.add.at(hist.reshape(-1), idx, 1)
            hist[0, part[0]] += 1
        return hist

    # --- payload (lane-stepped, vectorized over the 4 lanes) ---
    def _run_lanes(self, sym_idx: np.ndarray, tabs) -> tuple:
        """sym_idx: (steps, 4) table indexes in encode order (backwards).
        Returns (final_states(4,), payload_renorm_bytes)."""
        if native.ans_available():
            return native.ans_enc_lanes(sym_idx, tabs)
        steps = sym_idx.shape[0]
        st = np.full(4, ANS_TOP, dtype=np.int64)
        flags = np.zeros((steps, 4), dtype=bool)
        los = np.zeros((steps, 4), dtype=np.uint8)
        his = np.zeros((steps, 4), dtype=np.uint8)
        xmax = tabs["xmax"].reshape(-1)
        bias = tabs["bias"].reshape(-1)
        cmpl = tabs["cmpl"].reshape(-1)
        inv_f = tabs["inv_freq"].reshape(-1)
        inv_s = tabs["inv_shift"].reshape(-1)
        for t in range(steps):
            s = sym_idx[t]
            xm = xmax[s]
            f = st >= xm
            flags[t] = f
            los[t] = (st & 0xFF).astype(np.uint8)
            his[t] = ((st >> 8) & 0xFF).astype(np.uint8)
            st = np.where(f, st >> 16, st)
            stu = st.astype(np.uint64)
            q = ((stu * inv_f[s]) >> inv_s[s]).astype(np.int64)
            st = st + bias[s] + q * cmpl[s]
        # ascending payload = reverse chronological: steps reversed, lanes
        # reversed, (hi, lo) per renorm
        pair = np.stack([his, los], axis=-1)[::-1, ::-1, :]
        mask = flags[::-1, ::-1]
        payload = pair[mask].reshape(-1).tobytes()
        return st, payload

    def _emit_chunk(self, final_states, renorm, tail: bytes):
        payload = renorm + tail
        eu.write_varint(self.obs, len(payload))
        for k in range(4):
            self.obs.write_bits(int(final_states[k]) & 0xFFFFFFFF, 32)
        self.obs.write_bytes(payload)

    def _encode_chunk0(self, chunk: np.ndarray, tabs):
        end = len(chunk)
        end4 = end & -4
        # lane l at step t encodes position end4-1-4t-l (descending)
        steps = end4 >> 2
        pos = (end4 - 1 - 4 * np.arange(steps)[:, None]
               - np.arange(4)[None, :])
        sym_idx = chunk[pos].astype(np.int32)
        st, renorm = self._run_lanes(sym_idx, tabs)
        self._emit_chunk(st, renorm, chunk[end4:end].tobytes())

    def _encode_chunk1(self, chunk: np.ndarray, tabs):
        end = len(chunk)
        end4 = end & -4
        quarter = end4 >> 2
        # lane k walks its quarter backwards: pairs (ctx=block[i], sym=
        # block[i+1]) for i = quarter-2..0, then final (ctx=0, sym=block[0])
        steps = quarter
        if steps and native.transforms_available():
            sym_idx = native.ans1_sym_idx(chunk)
        else:
            sym_idx = np.zeros((steps, 4), dtype=np.int32)
            base = np.arange(4) * quarter
            if quarter >= 2:
                i_vals = np.arange(quarter - 2, -1, -1)[:, None]
                ctx = chunk[base[None, :] + i_vals].astype(np.int32)
                sym = chunk[base[None, :] + i_vals + 1].astype(np.int32)
                sym_idx[:quarter - 1] = (ctx << 8) | sym
            if steps:
                sym_idx[steps - 1] = chunk[np.arange(4)
                                           * quarter].astype(np.int32)
        st, renorm = self._run_lanes(sym_idx, tabs)
        self._emit_chunk(st, renorm, chunk[end4:end].tobytes())


def ans1_encode_chunks_np(chunks: np.ndarray, device):
    """Full order-1 chunks [C, size] uint8 through one launch of the
    order-1 encode (kanzi_tpu_torch.ops.ans1) on ``device``, their
    frequencies from the native host helpers. Returns (freqs
    [C, 256, 256], states [C, 4] uint32, flat uint8 payload, plen [C]
    int64 payload bytes) as numpy; chunk c's payload is flat[off[c] :
    off[c] + plen[c]] with off the exclusive cumsum of plen."""
    freqs = np.stack([native.ans1_norm(native.ans1_hist(ch))
                      for ch in chunks])
    states, flat, plen = dans1.ans1_encode_batch(
        dans._host_tensor(chunks, np.uint8).to(device), freqs)
    return (freqs, states.cpu().numpy().view(np.uint32), flat.cpu().numpy(),
            plen.cpu().numpy())


def ans0_flush_sink(entries, ctx) -> None:
    """ONE device decode for every (out_buffer, queued-chunk-records)
    pair collected -- within a block (_decode_device) or across many
    blocks via the "_ans0DecodeSink" context key (the decode-side mirror
    of the encode batcher, prepare_ans0_batch). The compact payload
    stream goes to the device (coding_device(ctx)) once; each chunk
    reads its own span."""
    allq = [q for _out, queued in entries for q in queued]
    if not allq:
        return
    freqs = np.stack([q[1][:256] for q in allq])
    states = np.stack([q[2] for q in allq])
    sizes = np.array([q[4] for q in allq], dtype=np.int64)
    offs = np.cumsum(sizes) - sizes
    flat = np.frombuffer(b"".join(q[3] for q in allq), dtype=np.uint8)
    dec, consumed = dans.ans0_decode_flat(freqs, states, flat, offs,
                                          coding_device(ctx))
    i = 0
    for out, queued in entries:
        for (cstart, _, _, _, sz) in queued:
            if consumed[i] != sz:
                raise ValueError("ANS chunk payload size mismatch")
            out[cstart:cstart + dans.CHUNK] = dec[i]
            i += 1


class ANSRangeDecoder(EntropyDecoder):
    default_chunk_size = DEFAULT_CHUNK_SIZE     # as ANSRangeEncoder's

    def __init__(self, ibs: BitReader, ctx=None, order: int = 0,
                 chunk_size: int | None = None):
        super().__init__(ibs, ctx)
        if chunk_size is None:
            chunk_size = self.default_chunk_size
        if order not in (0, 1):
            raise ValueError("ANS Codec: order must be 0 or 1")
        if not MIN_CHUNK_SIZE <= chunk_size <= MAX_CHUNK_SIZE:
            raise ValueError("ANS Codec: invalid chunk size")
        self.order = order
        self.chunk_size = min(chunk_size << (8 * order), MAX_CHUNK_SIZE)

    def _decode_header(self):
        """Returns (freqs (dim,256), alphabets list, lr) — decodeHeader."""
        if native.transforms_available():
            pos, freqs, counts, lr = native.ans_dec_header(
                self.ibs._data, self.ibs._nbits, self.ibs._pos,
                self.order)
            self.ibs.seek(pos)
            alphabets = [np.nonzero(freqs[k])[0]
                         for k in range(freqs.shape[0])]
            return freqs, alphabets, lr
        lr = 8 + self.ibs.read_bits(3)
        if lr > 15:
            raise ValueError(f"Invalid bitstream: range = {lr}")
        dim = 255 * self.order + 1
        scale = 1 << lr
        llr = int(lr).bit_length()
        freqs = np.zeros((dim, 256), dtype=np.int64)
        alphabets = []
        for k in range(dim):
            alphabet = eu.decode_alphabet(self.ibs)
            alphabets.append(alphabet)
            count = len(alphabet)
            if count == 0:
                continue
            chk = 8 if count >= 64 else 6
            s = 0
            i = 1
            while i < count:
                log_max = self.ibs.read_bits(llr)
                if log_max > lr:
                    raise ValueError("Invalid bitstream: incorrect frequency size")
                endj = min(i + chk, count)
                for j in range(i, endj):
                    f = 1 if log_max == 0 else self.ibs.read_bits(log_max) + 1
                    if f >= scale:
                        raise ValueError("Invalid bitstream: incorrect frequency")
                    freqs[k, alphabet[j]] = f
                    s += f
                i += chk
            if scale <= s:
                raise ValueError("Invalid bitstream: incorrect frequency")
            freqs[k, alphabet[0]] = scale - s
        return freqs, alphabets, lr

    def decode(self, count: int) -> np.ndarray:
        if count <= 32:
            return self.ibs.read_bytes_np(count).copy()
        out = np.empty(count, dtype=np.uint8)
        device_ok = (self.order == 0 and self.chunk_size == 16384
                     and count >= 16384 and _device_ans_enabled())
        if not device_ok:
            if native.transforms_available():
                fn = (native.ans0_dec_block if self.order == 0
                      else native.ans1_dec_block)
                pos, dec = fn(self.ibs._data, self.ibs._nbits,
                              self.ibs._pos, count, self.chunk_size)
                self.ibs.seek(pos)
                return dec
        queued = []  # (start, freqs[256], states[4], payload bytes, sz)
        start = 0
        while start < count:
            size = min(self.chunk_size, count - start)
            freqs, alphabets, lr = self._decode_header()
            total_alpha = sum(len(a) for a in alphabets)
            if total_alpha == 0:
                count = start
                break
            if self.order == 0 and len(alphabets[0]) == 1:
                out[start:start + size] = alphabets[0][0]
            elif device_ok and size == 16384 and lr == 12:
                sz = eu.read_varint(self.ibs)
                if sz > dans.PAYLOAD_MAX:
                    raise ValueError("Invalid ANS chunk size")
                states = np.array([self.ibs.read_bits(32) for _ in range(4)],
                                  dtype=np.uint32)
                queued.append((start, freqs[0], states,
                               self.ibs.read_bytes(sz), sz))
            else:
                self._decode_chunk(out, start, size, freqs, lr)
            start += size
        if queued:
            sink = self.ctx.get("_ans0DecodeSink") if self.ctx else None
            if sink is not None:
                # cross-block batching: the owner of the sink flushes all
                # blocks' chunks in ONE device call (ans0_flush_sink) --
                # `out` regions covered by `queued` stay unfilled until
                # then, so the caller must defer its transform stage too
                sink.append((out, queued))
            else:
                self._decode_device(out, queued)
        return out[:count]

    def _decode_device(self, out: np.ndarray, queued) -> None:
        """Batch-decode queued full 16 KiB chunks with the CUDA kernel.
        The compact payload stream (not per-chunk padded buffers) crosses
        the host->device link; per-chunk rows are sliced out on device."""
        ans0_flush_sink([(out, queued)], self.ctx)

    def _decode_chunk(self, out, start, count, freqs, lr):
        sz = eu.read_varint(self.ibs)
        if sz >= MAX_CHUNK_SIZE:
            raise ValueError("Invalid ANS chunk size")
        st = np.array([self.ibs.read_bits(32) for _ in range(4)], dtype=np.int64)
        payload = np.frombuffer(self.ibs.read_bytes(sz) + b"\x00\x00",
                                dtype=np.uint8).astype(np.int64)
        mask = (1 << lr) - 1
        f = np.minimum(freqs, (1 << lr) - 1)  # mirror encoder clamp
        cum = np.cumsum(f, axis=-1) - f
        # freq -> symbol inverse map per context
        if native.transforms_available():
            f2s = native.ans_f2s(freqs, lr)
        else:
            f2s = np.zeros((freqs.shape[0], 1 << lr), dtype=np.uint8)
            for k in range(freqs.shape[0]):
                rep = np.repeat(np.arange(256, dtype=np.uint8), f[k])
                f2s[k, :len(rep)] = rep[: 1 << lr]
        if native.ans_available():
            consumed = native.ans_dec_chunk(
                payload[:sz].astype(np.uint8).tobytes(),
                st.astype(np.uint32), f2s, f, cum, lr, self.order,
                out[start:start + count])
            if consumed != sz:
                raise ValueError("ANS chunk payload size mismatch")
            return
        fflat = f.reshape(-1)
        cflat = cum.reshape(-1)
        count4 = count & -4
        cursor = 0
        if self.order == 0:
            steps = count4 >> 2
            syms = np.empty((steps, 4), dtype=np.uint8)
            for t in range(steps):
                # lanes consume payload in order 3,2,1,0
                for lane in (3, 2, 1, 0):
                    s = int(st[lane])
                    cur = int(f2s[0, s & mask])
                    syms[t, 3 - lane] = cur
                    s = int(fflat[cur]) * (s >> lr) + (s & mask) - int(cflat[cur])
                    if s < ANS_TOP:
                        s = (s << 16) | (int(payload[cursor]) << 8) | int(payload[cursor + 1])
                        cursor += 2
                    st[lane] = s
            out[start:start + count4] = syms.reshape(-1)
        else:
            quarter = count4 >> 2
            prv = [0, 0, 0, 0]
            res = np.empty((quarter, 4), dtype=np.uint8)
            for t in range(quarter):
                for lane in (3, 2, 1, 0):
                    s = int(st[lane])
                    p = prv[lane]
                    cur = int(f2s[p, s & mask])
                    res[t, lane] = cur
                    j = (p << 8) | cur
                    s = int(fflat[j]) * (s >> lr) + (s & mask) - int(cflat[j])
                    if s < ANS_TOP:
                        s = (s << 16) | (int(payload[cursor]) << 8) | int(payload[cursor + 1])
                        cursor += 2
                    st[lane] = s
                    prv[lane] = cur
            out[start:start + count4] = res.T.reshape(-1)
        for i in range(count4, count):
            out[start + i] = payload[cursor]
            cursor += 1
        if cursor != sz:
            raise ValueError("ANS chunk payload size mismatch")
