"""Canonical Huffman coder, bit-exact with the reference.

Reference: src/entropy/Huffman{Common,Encoder,Decoder}.cpp.
- 16 KiB chunks (MAX_CHUNK_SIZE, HuffmanCommon.cpp:21-24), 12-bit max code.
- Code lengths via in-place Moffat–Katajainen (HuffmanEncoder.cpp:246-300)
  with length-limiting by bit-debt repayment (:129-215).
- Lengths transmitted as signed exp-Golomb deltas from 2 (:112-126).
- Each chunk splits into 4 fragments encoded into 4 independent bit
  streams (varint bit counts first) enabling 4-way parallel decode
  (:348-421). Chunks < 32 bytes are stored raw.

This implementation is data-parallel: symbol->code mapping, bit packing
(prefix-sum + scatter) and decoding (sliding-window table lookups +
pointer-doubling chain walk) are all vectorized numpy.

In this package the full 16 KiB chunks run on the CUDA kernels of
kanzi_tpu_torch.ops.huffman, on the device the container put in the
context (entropy.ans.coding_device), from any thread: PyTorch's CUDA
launches are thread-safe.
"""

from __future__ import annotations

import numpy as np

import kanzi_tpu_torch.ops as ops
from kanzi_tpu_torch.bitstream import BitReader, BitWriter
from kanzi_tpu_torch.entropy import utils as eu
from kanzi_tpu_torch.entropy.ans import coding_device
from kanzi_tpu_torch.entropy.base import EntropyDecoder, EntropyEncoder
from kanzi_tpu_torch.entropy.exp_golomb import ExpGolombDecoder, ExpGolombEncoder
from kanzi_tpu_torch.ops import huffman as dhuff
from kanzi_tpu_torch.utils.bitpack import (
    chain_walk, pack_bits, sliding_window_values, unpack_bits)

LOG_MAX_CHUNK_SIZE = 14
MAX_CHUNK_SIZE = 1 << LOG_MAX_CHUNK_SIZE
MAX_SYMBOL_SIZE = 12
DECODING_BATCH_SIZE = 12
TABLE_MASK = (1 << DECODING_BATCH_SIZE) - 1


def _device_huffman_enabled() -> bool:
    return ops.ENABLED


# --- code-length computation (exact Moffat–Katajainen reimplementation) ---

def _compute_inplace_phase1(data, n):
    s = r = 0
    for t in range(n - 1):
        total = 0
        for _ in range(2):
            if s >= n or (r < t and data[r] < data[s]):
                total += data[r]
                data[r] = t
                r += 1
                continue
            total += data[s]
            if s > t:
                data[s] = 0
            s += 1
        data[t] = total
    return data


def _compute_inplace_phase2(data, n):
    if n < 2:
        return 0
    top_level = n - 2
    depth = 1
    nodes_at_level = 2
    while n > 0:
        k = top_level
        while k != 0 and data[k - 1] >= top_level:
            k -= 1
        internal = top_level - k
        leaves = nodes_at_level - internal
        for _ in range(leaves):
            n -= 1
            data[n] = depth
        nodes_at_level = internal << 1
        top_level = k
        depth += 1
    return depth - 1


def compute_code_lengths(freqs_by_rank, ranks_symbols, count):
    """ranks sorted by (freq, symbol) ascending; returns sizes[256], maxlen."""
    data = list(freqs_by_rank)
    if any(f == 0 for f in data):
        return None, 0
    from kanzi_tpu_torch.utils import native
    if native.transforms_available():
        lens, maxlen = native.huff_code_lengths(data, count)
        sizes = np.zeros(256, dtype=np.int64)
        sizes[np.asarray(ranks_symbols[:count], np.int64)] = lens
        return sizes, maxlen
    _compute_inplace_phase1(data, count)
    maxlen = _compute_inplace_phase2(data, count)
    sizes = np.zeros(256, dtype=np.int64)
    for i in range(count):
        sizes[ranks_symbols[i]] = data[i]
    return sizes, maxlen


def generate_canonical_codes(sizes, symbols, count):
    """Canonical codes (HuffmanCommon.cpp:29-70). symbols re-sorted by
    (size, symbol); returns codes[256] or None on over-long code."""
    symbols = list(symbols[:count])
    if count == 0:
        return np.zeros(256, dtype=np.int64)
    if count > 1:
        # sort by (size-1)<<8 | symbol via bucket flags
        key = sorted((int(sizes[s]) - 1) << 8 | int(s) for s in symbols)
        for s in symbols:
            if s > 255 or sizes[s] > MAX_SYMBOL_SIZE:
                return None
        symbols = [k & 0xFF for k in key]
    codes = np.zeros(256, dtype=np.int64)
    cur_len = int(sizes[symbols[0]])
    code = 0
    for s in symbols:
        code <<= int(sizes[s]) - cur_len
        cur_len = int(sizes[s])
        codes[s] = code
        code += 1
    return codes


def _limit_code_lengths(alphabet, freqs, sizes, ranks, count):
    """Bit-debt repayment (HuffmanEncoder.cpp:129-215)."""
    n = 0
    debt = 0
    while sizes[ranks[n]] >= MAX_SYMBOL_SIZE:
        debt += int(sizes[ranks[n]]) - MAX_SYMBOL_SIZE
        sizes[ranks[n]] = MAX_SYMBOL_SIZE
        n += 1
    if debt == 0:
        return MAX_SYMBOL_SIZE, sizes
    v = [[] for _ in range(6)]
    v_head = [0] * 6
    while n < count:
        idx = MAX_SYMBOL_SIZE - 1 - int(sizes[ranks[n]])
        if idx > 5 or debt < (1 << idx):
            break
        v[idx].append(n)
        n += 1
    idx = 5
    while debt > 0 and idx >= 0:
        if v_head[idx] >= len(v[idx]) or debt < (1 << idx):
            idx -= 1
            continue
        sizes[ranks[v[idx][v_head[idx]]]] += 1
        debt -= 1 << idx
        v_head[idx] += 1
    idx = 0
    while debt > 0 and idx < 6:
        if v_head[idx] >= len(v[idx]):
            idx += 1
            continue
        sizes[ranks[v[idx][v_head[idx]]]] += 1
        debt -= 1 << idx
        v_head[idx] += 1
    if debt > 0:
        # slow path: renormalize frequencies to a smaller scale and retry
        f = np.zeros(count, dtype=np.int64)
        total = 0
        for i in range(count):
            f[i] = freqs[alphabet[i]]
            total += int(f[i])
        eu.normalize_frequencies(f, count, total, MAX_CHUNK_SIZE >> 3)
        for i in range(count):
            freqs[alphabet[i]] = f[i]
            ranks[i] = (int(f[i]) << 8) | int(alphabet[i])
        ranks_sorted = sorted(int(r) for r in ranks[:count])
        fr = [r >> 8 for r in ranks_sorted]
        rs = [r & 0xFF for r in ranks_sorted]
        sizes2, maxlen = compute_code_lengths(fr, rs, count)
        return maxlen, sizes2
    return MAX_SYMBOL_SIZE, sizes


class HuffmanEncoder(EntropyEncoder):
    def __init__(self, obs: BitWriter, ctx=None, chunk_size: int = MAX_CHUNK_SIZE):
        super().__init__(obs, ctx)
        if not 1024 <= chunk_size <= MAX_CHUNK_SIZE:
            raise ValueError("Huffman codec: invalid chunk size")
        self.chunk_size = chunk_size
        self.codes = np.arange(256, dtype=np.int64)
        self.lens = np.zeros(256, dtype=np.int64)

    def _update_frequencies(self, freqs: np.ndarray) -> int:
        """Build codes for one chunk + emit table (HuffmanEncoder.cpp:57-127).
        Returns alphabet size."""
        self.codes[:] = 0
        alphabet = np.nonzero(freqs)[0]
        count = len(alphabet)
        eu.encode_alphabet(self.obs, alphabet)
        if count == 0:
            return 0
        sizes = np.zeros(256, dtype=np.int64)
        if count == 1:
            self.codes[alphabet[0]] = 1 << 12
            sizes[alphabet[0]] = 1
        else:
            freqs = freqs.astype(np.int64).copy()
            ranks = np.sort((freqs[alphabet] << 8) | alphabet)
            fr = (ranks >> 8).tolist()
            rs = (ranks & 0xFF).tolist()
            sizes_c, maxlen = compute_code_lengths(fr, rs, count)
            if maxlen == 0:
                raise ValueError("Could not generate Huffman codes: invalid code length 0")
            sizes = sizes_c
            rank_syms = np.array(rs, dtype=np.int64)
            if maxlen > MAX_SYMBOL_SIZE:
                maxlen, sizes = _limit_code_lengths(alphabet, freqs, sizes,
                                                    rank_syms, count)
                if maxlen == 0:
                    raise ValueError("Could not generate Huffman codes: invalid code length 0")
            if maxlen > MAX_SYMBOL_SIZE:
                for n, s in enumerate(alphabet):
                    self.codes[s] = n
                    sizes[s] = 8
            else:
                # pass the alphabet, not rank_syms: the bit-debt slow path
                # rewrites ranks in place as (freq<<8|sym) packed keys, and
                # generate_canonical_codes only needs the symbol set (it
                # re-sorts by (size, symbol) itself)
                codes = generate_canonical_codes(sizes, alphabet, count)
                if codes is None:
                    raise ValueError("Could not generate canonical codes")
                self.codes[:] = codes
        # transmit code lengths as signed exp-Golomb deltas (prev starts at 2)
        eg = ExpGolombEncoder(self.obs, signed=True)
        prev = 2
        for s in alphabet:
            self.codes[s] |= int(sizes[s]) << 12
            eg.encode_byte((int(sizes[s]) - prev) & 0xFF)
            prev = int(sizes[s])
        return count

    def _encode_device(self, block: np.ndarray, count: int) -> int:
        """Encode all full 16 KiB chunks with the CUDA kernels
        (kanzi_tpu_torch.ops.huffman), or take the container's prepared
        batch. The kernels limit over-long codes themselves, so every
        chunk is ok or of one symbol; a chunk that is neither would be
        coded here on the host, counted as huff_host_chunks. Returns the
        new start offset."""
        full = count // MAX_CHUNK_SIZE
        chunks = block[:full * MAX_CHUNK_SIZE].reshape(full, MAX_CHUNK_SIZE)
        prep = getattr(self, "prepared_device", None)
        if prep is not None and len(prep[2]) == full:
            (hdr, hdr_bits, ok, m, flat, npairs,
             acc, nb, frag_bits) = prep
        else:
            (hdr, hdr_bits, ok, m, flat, npairs,
             acc, nb, frag_bits) = dhuff.encode_chunks_np(
                 chunks, coding_device(self.ctx))
        plen16 = npairs.sum(1)
        offs16 = np.cumsum(plen16) - plen16
        from kanzi_tpu_torch.utils import native
        use_native = native.available()
        if use_native:
            # stash fragment residual bits (<16 each) in the header rows'
            # spare tail bytes so the native splice needs two buffers only
            hdr = np.array(hdr)  # the prepared batch's rows are shared
            w = hdr.shape[1]
            rb16 = (acc.astype(np.uint32)
                    & ((1 << np.maximum(nb, 0)) - 1)) << (16 - nb)
            hdr[:, w - 8:w] = np.stack(
                [(rb16 >> 8) & 0xFF, rb16 & 0xFF],
                axis=2).astype(np.uint8).reshape(-1, 8)
        pend_sel = []
        pend_off = []
        pend_bits = []

        def flush_native():
            if pend_sel:
                data, nbits = native.concat_runs(
                    hdr.reshape(-1), flat,
                    np.array(pend_sel, np.uint8),
                    np.array(pend_off, np.uint64),
                    np.array(pend_bits, np.uint64))
                self.obs._append_bit_run(data, nbits)
                pend_sel.clear()
                pend_off.clear()
                pend_bits.clear()

        for ci in range(full):
            if ok[ci] or m[ci] <= 1:
                base = int(offs16[ci])
                if use_native:
                    w = hdr.shape[1]
                    pend_sel.append(0)
                    pend_off.append(ci * w)
                    pend_bits.append(int(hdr_bits[ci]))
                    if ok[ci]:
                        for f in range(4):
                            np_f = int(npairs[ci, f])
                            if np_f:
                                pend_sel.append(1)
                                pend_off.append(2 * base)
                                pend_bits.append(16 * np_f)
                            base += np_f
                            rb = int(nb[ci, f])
                            if rb:
                                pend_sel.append(0)
                                pend_off.append(ci * w + w - 8 + 2 * f)
                                pend_bits.append(rb)
                    continue
                bl = int(hdr_bits[ci])
                self.obs._append_bit_run(hdr[ci, :(bl + 7) >> 3].tobytes(),
                                         bl)
                if ok[ci]:
                    for f in range(4):
                        np_f = int(npairs[ci, f])
                        if np_f:
                            self.obs.write_bytes(
                                flat[2 * base:2 * (base + np_f)].tobytes())
                        base += np_f
                        rb = int(nb[ci, f])
                        if rb:
                            self.obs.write_bits(
                                int(acc[ci, f]) & ((1 << rb) - 1), rb)
            else:
                flush_native()
                ops.count("huff_host_chunks")
                chunk = chunks[ci]
                res = (native.huff_enc_chunk(chunk)
                       if native.transforms_available() else None)
                if res is not None:
                    self.obs._append_bit_run(res[0], res[1])
                else:
                    freqs = np.bincount(chunk,
                                        minlength=256).astype(np.int64)
                    if self._update_frequencies(freqs) > 1:
                        self._encode_chunk(chunk)
        flush_native()
        return full * MAX_CHUNK_SIZE

    def encode(self, block: np.ndarray) -> int:
        block = np.asarray(block, dtype=np.uint8)
        count = len(block)
        if count == 0:
            return 0
        start = 0
        if (self.chunk_size == MAX_CHUNK_SIZE and count >= MAX_CHUNK_SIZE
                and _device_huffman_enabled()):
            start = self._encode_device(block, count)
        from kanzi_tpu_torch.utils import native
        use_native = native.transforms_available()
        if use_native and start < count:
            res = native.huff_enc_block(block[start:], self.chunk_size)
            if res is not None:
                self.obs._append_bit_run(res[0], res[1])
                return count
        while start < count:
            size_chunk = min(self.chunk_size, count - start)
            chunk = block[start:start + size_chunk]
            if size_chunk < 32:
                self.obs.write_bytes(chunk)
            else:
                res = native.huff_enc_chunk(chunk) if use_native else None
                if res is not None:
                    self.obs._append_bit_run(res[0], res[1])
                else:  # no native lib, or the rare bit-debt limit path
                    freqs = np.bincount(chunk,
                                        minlength=256).astype(np.int64)
                    if self._update_frequencies(freqs) > 1:
                        self._encode_chunk(chunk)
            start += size_chunk
        return count

    def _encode_chunk(self, chunk: np.ndarray) -> None:
        """4 independent fragments (HuffmanEncoder.cpp:348-421)."""
        count = len(chunk)
        sz_frag = count // 4
        code_bits = self.codes & 0x0FFF
        code_lens = self.codes >> 12
        frag_packed = []
        frag_bits = []
        for j in range(4):
            src = chunk[j * sz_frag:(j + 1) * sz_frag]
            packed, nbits = pack_bits(code_bits[src], code_lens[src])
            frag_packed.append(packed)
            frag_bits.append(nbits)
        for nb in frag_bits:
            eu.write_varint(self.obs, nb)
        for packed, nb in zip(frag_packed, frag_bits):
            self.obs._append_bit_run(packed.tobytes(), nb)
        # chunk tail bytes (count not divisible by 4) stored raw
        for i in range(4 * sz_frag, count):
            self.obs.write_bits(int(chunk[i]), 8)


def huffman_flush_sink(entries, decode) -> None:
    """ONE decode call for the full chunks of every queued (out,
    chunk_idx, codes, sizes, pay, bounds) entry (HuffmanDecoder's
    _decode_device), within a block or across the blocks of a file:
    decode(codes [K, 256], sizes [K, 256], pay, bounds [4K + 1]) returns
    their [K, 16384] bytes, which go to each entry's out."""
    if len(entries) == 1:
        codes, sizes, pay, bounds = entries[0][2:]
    else:
        codes = np.concatenate([e[2] for e in entries])
        sizes = np.concatenate([e[3] for e in entries])
        offs = np.cumsum([0] + [len(e[4]) for e in entries])
        pay = np.concatenate([e[4] for e in entries])
        bounds = np.concatenate([e[5][:-1] + o for e, o in zip(entries, offs)]
                                + [offs[-1:]])
    dec = decode(codes, sizes, pay, bounds)
    k = 0
    for out, idx, *_ in entries:
        full = out[:(int(idx[-1]) + 1) * MAX_CHUNK_SIZE]
        full.reshape(-1, MAX_CHUNK_SIZE)[idx] = dec[k:k + len(idx)]
        k += len(idx)


class HuffmanDecoder(EntropyDecoder):
    def __init__(self, ibs: BitReader, ctx=None, chunk_size: int = MAX_CHUNK_SIZE):
        super().__init__(ibs, ctx)
        if not 1024 <= chunk_size <= MAX_CHUNK_SIZE:
            raise ValueError("Huffman codec: invalid chunk size")
        self.chunk_size = chunk_size

    def _read_lengths(self):
        """Returns (alphabet, sizes[256], codes[256]) or alphabet size 0."""
        alphabet = eu.decode_alphabet(self.ibs)
        count = len(alphabet)
        if count == 0:
            return alphabet, None, None
        eg = ExpGolombDecoder(self.ibs, signed=True)
        sizes = np.zeros(256, dtype=np.int64)
        cur = 2
        for s in alphabet:
            delta = eg.decode_byte()
            if delta >= 128:
                delta -= 256
            cur += delta
            if cur <= 0 or cur > MAX_SYMBOL_SIZE:
                raise ValueError(f"Invalid bitstream: incorrect size {cur} "
                                 f"for Huffman symbol {s}")
            sizes[s] = cur
        codes = generate_canonical_codes(sizes, alphabet, count)
        if codes is None:
            raise ValueError("Could not generate Huffman codes: max code "
                             "length exceeded")
        return alphabet, sizes, codes

    def decode(self, count: int) -> np.ndarray:
        bs_version = self.ctx.get_int("bsVersion", 6)
        if bs_version < 6:
            return self._decode_v5(count)
        out = np.empty(count, dtype=np.uint8)
        sink = self.ctx.get("_huffDecodeSink") if self.ctx else None
        device_ok = (self.chunk_size == MAX_CHUNK_SIZE
                     and count >= MAX_CHUNK_SIZE
                     and (sink is not None or _device_huffman_enabled()))
        from kanzi_tpu_torch.utils import native
        use_native = native.transforms_available()
        if use_native and not device_ok:
            pos, dec = native.huff_dec_block(
                self.ibs._data, self.ibs._nbits, self.ibs._pos, count,
                self.chunk_size)
            self.ibs.seek(pos)
            return dec
        start = 0
        if device_ok and native.huff_parse_available():
            # every full chunk's header parsed natively in one call
            full = count // MAX_CHUNK_SIZE
            pos, parsed, *queued = native.huff_parse_block(
                self.ibs._data, self.ibs._nbits, self.ibs._pos, full, out)
            self.ibs.seek(pos)
            self._decode_device(out, sink, *queued)
            if parsed < full:
                return out[:parsed * MAX_CHUNK_SIZE]
            start = full * MAX_CHUNK_SIZE
        queued = []  # (chunk index, sizes, codes, (fragment bytes, counts))
        while start < count:
            size_chunk = min(self.chunk_size, count - start)
            if size_chunk < 32:
                out[start:start + size_chunk] = np.frombuffer(
                    self.ibs.read_bytes(size_chunk), dtype=np.uint8)
            elif (use_native
                  and not (device_ok and size_chunk == MAX_CHUNK_SIZE)):
                rc = native.huff_dec_chunk(
                    self.ibs._data, self.ibs._nbits, self.ibs._pos,
                    size_chunk, out, start)
                if rc == -5:
                    return out[:start]
                self.ibs.seek(rc)
            else:
                alphabet, sizes, codes = self._read_lengths()
                if len(alphabet) == 0:
                    return out[:start]
                if len(alphabet) == 1:
                    out[start:start + size_chunk] = alphabet[0]
                elif device_ok and size_chunk == MAX_CHUNK_SIZE:
                    queued.append((start // MAX_CHUNK_SIZE, sizes, codes,
                                   self._read_fragments()))
                else:
                    self._decode_chunk(out, start, size_chunk, alphabet,
                                       sizes, codes)
            start += size_chunk
        if queued:
            pay = np.frombuffer(b"".join(q[3][0] for q in queued), np.uint8)
            nbytes = [n for q in queued for n in q[3][1]]
            self._decode_device(
                out, sink, np.array([q[0] for q in queued]),
                np.stack([np.asarray(q[2], np.int64) for q in queued]),
                np.stack([np.asarray(q[1], np.int64) for q in queued]),
                pay, np.concatenate([[0], np.cumsum(nbytes)]))
        return out

    def _decode_v5(self, count: int) -> np.ndarray:
        """bsVersion <= 5 layout (HuffmanDecoder.cpp decodeV5:349-447):
        per chunk, code lengths as in v6, then a 2-bit stream count
        (must be 0), a varint bit size, and ONE bitstream (no 4-fragment
        split, no <32-byte raw chunks)."""
        out = np.empty(count, dtype=np.uint8)
        start = 0
        while start < count:
            size_chunk = min(self.chunk_size, count - start)
            alphabet, sizes, codes = self._read_lengths()
            if len(alphabet) == 0:
                return out[:start]
            if len(alphabet) == 1:
                out[start:start + size_chunk] = alphabet[0]
                start += size_chunk
                continue
            if self.ibs.read_bits(2) != 0:
                raise ValueError("Invalid bitstream: only one Huffman "
                                 "stream supported")
            sz_bits = eu.read_varint(self.ibs)
            if sz_bits < 0 or sz_bits > size_chunk * MAX_SYMBOL_SIZE:
                raise ValueError("Invalid bitstream: Huffman chunk size")
            if sz_bits:
                tbl_sym = np.zeros(TABLE_MASK + 1, dtype=np.uint8)
                tbl_len = np.full(TABLE_MASK + 1, 7, dtype=np.int64)
                for s in alphabet:
                    ln = int(sizes[s])
                    w = 1 << (DECODING_BATCH_SIZE - ln)
                    idx = int(codes[s]) * w
                    tbl_sym[idx:idx + w] = s
                    tbl_len[idx:idx + w] = ln
                raw = bytearray(self.ibs.read_bytes(sz_bits >> 3))
                if sz_bits & 7:
                    tail = self.ibs.read_bits(sz_bits & 7)
                    raw.append((tail << (8 - (sz_bits & 7))) & 0xFF)
                nbytes = (sz_bits + 7) >> 3
                bits = unpack_bits(bytes(raw), nbytes * 8)
                win = sliding_window_values(bits, DECODING_BATCH_SIZE)
                lens = tbl_len[win]
                nxt = np.arange(len(win), dtype=np.int64) + lens
                pos = chain_walk(nxt, 0, size_chunk)
                out[start:start + size_chunk] = tbl_sym[win[pos]]
            start += size_chunk
        return out

    def _read_fragments(self):
        """Byte-aligned copies of the 4 fragment bitstreams of one full
        chunk (HuffmanDecoder.cpp reads them the same way), back to
        back, and their byte counts."""
        frag_bits = [eu.read_varint(self.ibs) for _ in range(4)]
        raws = []
        for nb in frag_bits:
            if nb > 8 * dhuff.FRAG_MAX_BYTES:
                raise ValueError("Invalid Huffman fragment size")
            raw = bytearray(self.ibs.read_bytes(nb >> 3))
            if nb & 7:
                tail = self.ibs.read_bits(nb & 7)
                raw.append((tail << (8 - (nb & 7))) & 0xFF)
            raws.append(raw)
        return b"".join(raws), [len(r) for r in raws]

    def _decode_device(self, out: np.ndarray, sink, chunk_idx, codes,
                       sizes, pay, bounds) -> None:
        """Decode the full chunks chunk_idx [K] of the block on the card:
        codes/sizes [K, 256] their canonical codes and lengths, their
        fragments at pay[bounds[4k + f] : bounds[4k + f + 1]]. With a
        sink (the "_huffDecodeSink" context key) the chunks are queued
        there instead, and their bytes of out stay unfilled until the
        sink's owner decodes every queued block in one call
        (huffman_flush_sink)."""
        if len(chunk_idx) == 0:
            return
        entry = (out, chunk_idx, codes, sizes, pay, bounds)
        if sink is not None:
            sink.append(entry)
            return
        dev = coding_device(self.ctx)
        huffman_flush_sink([entry], lambda *a: dhuff.huffman_decode_chunks(
            *a, dev))

    def _decode_chunk(self, out, start, count, alphabet, sizes, codes):
        # flat 12-bit prefix table (HuffmanDecoder.cpp:buildDecodingTable)
        tbl_sym = np.zeros(TABLE_MASK + 1, dtype=np.uint8)
        tbl_len = np.full(TABLE_MASK + 1, 7, dtype=np.int64)
        for s in alphabet:
            ln = int(sizes[s])
            w = 1 << (DECODING_BATCH_SIZE - ln)
            idx = int(codes[s]) * w
            tbl_sym[idx:idx + w] = s
            tbl_len[idx:idx + w] = ln
        sz_frag = count // 4
        frag_bits = [eu.read_varint(self.ibs) for _ in range(4)]
        from kanzi_tpu_torch.utils import native
        use_native = native.transforms_available()
        tbl_len_u8 = tbl_len.astype(np.uint8) if use_native else None
        for j in range(4):
            nb = frag_bits[j]
            nbytes = (nb + 7) >> 3
            raw = bytearray(self.ibs.read_bytes(nb >> 3))
            if nb & 7:
                tail = self.ibs.read_bits(nb & 7)
                raw.append((tail << (8 - (nb & 7))) & 0xFF)
            if use_native:
                native.huff_dec_frag(
                    bytes(raw), sz_frag, tbl_sym, tbl_len_u8,
                    out[start + j * sz_frag:start + (j + 1) * sz_frag])
                continue
            bits = unpack_bits(bytes(raw), nbytes * 8)
            win = sliding_window_values(bits, DECODING_BATCH_SIZE)
            lens = tbl_len[win]
            nxt = np.arange(len(win), dtype=np.int64) + lens
            pos = chain_walk(nxt, 0, sz_frag)
            out[start + j * sz_frag:start + (j + 1) * sz_frag] = tbl_sym[win[pos]]
        for i in range(4 * sz_frag, count):
            out[start + i] = self.ibs.read_bits(8)
