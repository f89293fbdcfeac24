"""Reduced-offset LZ codecs: ROLZ (ANS-backed) and ROLZX (binary CM).

Reference: src/transform/ROLZCodec.cpp. 64Ki contexts x 2^logPosChecks
position slots, chunked at 16 MiB. Block header = 4-byte BE count + flags
(litOrder | mm-select | logPosChecks<<4). ROLZ entropy-codes
literal/token/length/match-index streams with internal ANS sub-streams;
ROLZX uses an internal 56-bit binary range coder with two prob tables
("loosely based on balz").
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from kanzi_tpu_torch.bitstream import BitReader, BitWriter
from kanzi_tpu_torch.core import stats
from kanzi_tpu_torch.core.context import Context
from kanzi_tpu_torch.transform.base import ByteTransform, as_u8

HASH_SIZE = 65536
CHUNK_SIZE = 16 * 1024 * 1024
HASH = 200002979
HASH_MASK32 = (~(CHUNK_SIZE - 1)) & 0xFFFFFFFF  # 0xFF000000
MAX_BLOCK_SIZE = 1024 * 1024 * 1024
MIN_BLOCK_SIZE = 64
M64 = (1 << 64) - 1
M32 = 0xFFFFFFFF

MIN_MATCH3 = 3
MIN_MATCH4 = 4
MIN_MATCH7 = 7
MAX_MATCH1 = MIN_MATCH3 + 65535   # codec1
MAX_MATCH2 = MIN_MATCH3 + 255     # codec2
LOG_POS_CHECKS1 = 4
LOG_POS_CHECKS2 = 5


def _key1(b0, b1):
    return (b0 | (b1 << 8)) & (HASH_SIZE - 1)


def _key2(w64):
    return ((w64 * HASH) & M64) >> 40 & (HASH_SIZE - 1)


def _hash32(le32):
    return (((le32 << 8) & M32) * HASH) & M32 & HASH_MASK32


def _emit_length1(buf: bytearray, length: int) -> None:
    """7-bit varint, big-end first (ROLZCodec1::emitLength)."""
    if length < (1 << 7):
        buf.append(length)
        return
    if length >= (1 << 14):
        if length >= (1 << 21):
            buf.append(0x80 | ((length >> 21) & 0x7F))
        buf.append(0x80 | ((length >> 14) & 0x7F))
    buf.append(0x80 | ((length >> 7) & 0x7F))
    buf.append(length & 0x7F)


def _read_length1(data, pos):
    nxt = data[pos]
    pos += 1
    if nxt < 128:
        return nxt, pos
    length = nxt & 0x7F
    nxt = data[pos]
    pos += 1
    length = (length << 7) | (nxt & 0x7F)
    if nxt >= 128:
        nxt = data[pos]
        pos += 1
        length = (length << 7) | (nxt & 0x7F)
        if nxt >= 128:
            nxt = data[pos]
            pos += 1
            length = (length << 7) | (nxt & 0x7F)
    return length, pos


class ROLZCodec(ByteTransform):
    """Wrapper: dispatches to codec1 (ROLZ) or codec2 (ROLZX)."""

    def __init__(self, ctx=None, extra: bool = False):
        super().__init__(ctx)
        if ctx is not None and "ROLZX" in ctx.get_str("transform", "NONE"):
            extra = True
        self.extra = extra
        self._impl = _ROLZCodec2(self.ctx) if extra else _ROLZCodec1(self.ctx)

    def max_encoded_length(self, src_len: int) -> int:
        return self._impl.max_encoded_length(src_len)

    def forward(self, src: np.ndarray) -> Optional[np.ndarray]:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        if count < MIN_BLOCK_SIZE or count > MAX_BLOCK_SIZE:
            return None
        self._impl.output_capacity = self.output_capacity
        return self._impl.forward(src)

    def inverse(self, src: np.ndarray) -> np.ndarray:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        if count < 5 or count > MAX_BLOCK_SIZE:
            raise ValueError("ROLZ codec: invalid block")
        return self._impl.inverse(src)


def _detect_flags(ctx, src, count, allow_mm):
    """Shared dataType detection: returns (min_match, delta, flags)."""
    min_match = MIN_MATCH3
    delta = 2
    flags = 0
    dt = ctx.get_int("dataType", stats.UNDEFINED)
    if dt == stats.UNDEFINED:
        from kanzi_tpu_torch.utils import native as _nat
        if _nat.transforms_available():
            freqs = _nat.hist_o0(src)
        else:
            freqs = np.bincount(src, minlength=256).astype(np.int64)
        dt = stats.detect_simple_type(count, freqs)
        if dt != stats.UNDEFINED:
            ctx.put("dataType", dt)
    if dt == stats.EXE:
        delta = 3
        flags |= 8
    elif dt == stats.DNA:
        delta = 8
        min_match = MIN_MATCH7
        flags |= 4
    elif allow_mm and dt == stats.MULTIMEDIA:
        delta = 8
        min_match = MIN_MATCH4
        flags |= 2
    return min_match, delta, flags


class _MatchTable:
    """counters[64Ki] + matches[64Ki << logPosChecks] circular tables."""

    def __init__(self, log_pos_checks):
        self.lpc = log_pos_checks
        self.pos_checks = 1 << log_pos_checks
        self.mask = self.pos_checks - 1
        self.counters = [0] * HASH_SIZE
        self.matches = [0] * (HASH_SIZE << log_pos_checks)

    def clear_matches(self):
        self.matches = [0] * (HASH_SIZE << self.lpc)


def _find_match1(wl, data, base, pos, end, hash32, table, key, min_match,
                 max_match_c):
    """pos/end are chunk-relative; stored refs are chunk-relative too."""
    s = table.counters[key]
    mbase = key << table.lpc
    best_len = 0
    best_idx = -1
    max_match = min(max_match_c, end - pos) - 8
    for i in range(s, s - table.pos_checks, -1):
        ref = table.matches[mbase + (i & table.mask)]
        if (ref & HASH_MASK32) != hash32:
            continue
        ref &= ~HASH_MASK32 & M32
        if data[base + ref + best_len] != data[base + pos + best_len]:
            continue
        n = 0
        while n < max_match:
            d = wl[base + ref + n] ^ wl[base + pos + n]
            if d:
                n += ((d & -d).bit_length() - 1) >> 3
                break
            n += 8
        if n > best_len:
            best_idx = i
            best_len = n
    if best_len < min_match:
        return -1
    return ((s - best_idx) << 16) | (best_len - min_match)


class _ROLZCodec1:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.lpc = LOG_POS_CHECKS1
        self.output_capacity = None

    def max_encoded_length(self, src_len: int) -> int:
        return src_len + 64 if src_len <= 512 else src_len

    def forward(self, src: np.ndarray) -> Optional[np.ndarray]:
        from kanzi_tpu_torch.entropy.ans import ANSRangeEncoder
        count = len(src)
        capacity = self.output_capacity or self.max_encoded_length(count)
        if capacity < self.max_encoded_length(count):
            return None
        src_end = count - 4
        from kanzi_tpu_torch.utils import native as _nat
        use_native = _nat.transforms_available()
        if not use_native:
            data = src.tolist()
            padded = np.concatenate([src,
                                     np.zeros(8, np.uint8)]).astype(np.uint64)
            w = np.zeros(count, dtype=np.uint64)
            for k in range(8):
                w |= padded[k:count + k] << np.uint64(8 * k)
            wl = w.tolist()
        else:
            data_padded = np.concatenate([src, np.zeros(8, np.uint8)])
            n_counters = np.zeros(HASH_SIZE, np.int32)
            n_matches = np.zeros(HASH_SIZE << self.lpc, np.uint32)

        dst = bytearray()
        dst += (count & M32).to_bytes(4, "big")
        lit_order = 0 if count < (1 << 17) else 1
        min_match, delta, flags = _detect_flags(self.ctx, src, count, True)
        flags |= lit_order
        flags |= self.lpc << 4
        dst.append(flags)
        cond = min_match == MIN_MATCH3
        max_match_c = MAX_MATCH1
        table = _MatchTable(self.lpc) if not use_native else None
        size_chunk = min(count, CHUNK_SIZE)
        start_chunk = 0
        success = True
        src_idx = 0

        while start_chunk < src_end:
            end_chunk = min(start_chunk + size_chunk, src_end)
            size_chunk = end_chunk - start_chunk
            base = start_chunk
            if use_native:
                n_matches[:] = 0
                lit, tk, lens, midx = _nat.rolz1_parse(
                    data_padded, count, base, size_chunk, src_end, cond,
                    delta, min_match, self.lpc, n_counters, n_matches)
                obs = BitWriter()
                obs.write_bits(len(lit), 32)
                obs.write_bits(len(tk), 32)
                obs.write_bits(len(lens), 32)
                obs.write_bits(len(midx), 32)
                # the sub-streams code on the block's device (ANS0 chunks)
                sub_ctx = Context({"bsVersion": 6,
                                   "device": self.ctx.get("device")})
                enc = ANSRangeEncoder(obs, sub_ctx, order=lit_order)
                enc.encode(lit)
                enc.dispose()
                enc2 = ANSRangeEncoder(obs, sub_ctx, order=0,
                                       chunk_size=32768)
                enc2.encode(tk)
                enc2.encode(lens)
                enc2.encode(midx)
                enc2.dispose()
                payload = obs.getvalue()
                if len(dst) + len(payload) > capacity:
                    success = False
                    break
                dst += payload
                start_chunk = end_chunk
                continue
            lit = bytearray()
            lens = bytearray()
            midx = bytearray()
            tk = bytearray()
            table.clear_matches()
            src_idx = 0
            n = min(src_end - start_chunk, 8)
            for _ in range(n):
                lit.append(data[base + src_idx])
                src_idx += 1
            first_lit = src_idx
            src_inc = 0

            while src_idx < size_chunk:
                rpos = base + src_idx - delta
                key = _key1(data[rpos], data[rpos + 1]) if cond else _key2(wl[rpos])
                h32 = _hash32(int.from_bytes(bytes(data[base + src_idx:base + src_idx + 4]), "little"))
                match = _find_match1(wl, data, base, src_idx, size_chunk,
                                     h32, table, key, min_match, max_match_c)
                table.counters[key] = (table.counters[key] + 1) & table.mask
                table.matches[(key << table.lpc) + table.counters[key]] = (h32 | src_idx) & M32

                if match < 0:
                    src_idx += 1 + (src_inc >> 6)
                    src_inc += 1
                    continue

                src_idx1 = src_idx + 1
                rpos1 = base + src_idx1 - delta
                key2 = _key1(data[rpos1], data[rpos1 + 1]) if cond else _key2(wl[rpos1])
                h32b = _hash32(int.from_bytes(bytes(data[base + src_idx1:base + src_idx1 + 4]), "little"))
                match2 = _find_match1(wl, data, base, src_idx1, size_chunk,
                                      h32b, table, key2, min_match, max_match_c)
                if match2 >= 0 and (match2 & 0xFFFF) > (match & 0xFFFF):
                    match = match2
                    src_idx = src_idx1
                    table.counters[key2] = (table.counters[key2] + 1) & table.mask
                    table.matches[(key2 << table.lpc) + table.counters[key2]] = (h32b | src_idx) & M32

                lit_len = src_idx - first_lit
                token = (lit_len << 3) if lit_len < 31 else 0xF8
                mlen = match & 0xFFFF
                if mlen >= 7:
                    tk.append(token | 0x07)
                    _emit_length1(lens, mlen - 7)
                else:
                    tk.append(token | mlen)
                if lit_len > 0:
                    if lit_len >= 31:
                        _emit_length1(lens, lit_len - 31)
                    lit += bytes(data[base + first_lit:base + first_lit + lit_len])
                midx.append((match >> 16) & 0xFF)
                src_idx += mlen + min_match
                first_lit = src_idx
                src_inc = 0

            lit_len = size_chunk - first_lit
            if len(tk) != 0:
                tk.append((lit_len << 3) if lit_len < 31 else 0xF8)
            if lit_len >= 31:
                _emit_length1(lens, lit_len - 31)
            lit += bytes(data[base + first_lit:base + first_lit + lit_len])

            obs = BitWriter()
            obs.write_bits(len(lit), 32)
            obs.write_bits(len(tk), 32)
            obs.write_bits(len(lens), 32)
            obs.write_bits(len(midx), 32)
            sub_ctx = Context({"bsVersion": 6,
                               "device": self.ctx.get("device")})
            enc = ANSRangeEncoder(obs, sub_ctx, order=lit_order)
            enc.encode(np.frombuffer(bytes(lit), dtype=np.uint8))
            enc.dispose()
            enc2 = ANSRangeEncoder(obs, sub_ctx, order=0, chunk_size=32768)
            enc2.encode(np.frombuffer(bytes(tk), dtype=np.uint8))
            enc2.encode(np.frombuffer(bytes(lens), dtype=np.uint8))
            enc2.encode(np.frombuffer(bytes(midx), dtype=np.uint8))
            enc2.dispose()
            payload = obs.getvalue()
            if len(dst) + len(payload) > capacity:
                success = False
                break
            dst += payload
            start_chunk = end_chunk

        if success:
            if len(dst) + 4 <= capacity:
                dst += src[src_end:src_end + 4].tobytes()
            else:
                return None
        else:
            return None
        if len(dst) >= count:
            return None
        return np.frombuffer(bytes(dst), dtype=np.uint8)

    def inverse(self, src: np.ndarray) -> np.ndarray:
        from kanzi_tpu_torch.entropy.ans import ANSRangeDecoder
        count = len(src)
        buf = src.tobytes()
        from kanzi_tpu_torch.utils import native as _nat0
        data = buf if _nat0.transforms_available() else src.tolist()
        end = int.from_bytes(buf[0:4], "big")
        if end <= 4:
            raise ValueError("ROLZ: invalid decoded size")
        dst_end = end - 4
        src_idx = 5
        flags = buf[4]
        lit_order = flags & 1
        min_match = MIN_MATCH3
        delta = 2
        f = flags & 0x0E
        if f == 2:
            min_match = MIN_MATCH4
            delta = 8
        elif f == 4:
            min_match = MIN_MATCH7
            delta = 8
        elif f == 8:
            delta = 3
        lpc = flags >> 4
        if lpc < 2 or lpc > 8:
            raise ValueError("ROLZ: invalid logPosChecks")
        from kanzi_tpu_torch.utils import native as _nat
        use_native = _nat.transforms_available()
        if use_native:
            n_counters = np.zeros(HASH_SIZE, np.int32)
            n_matches = np.zeros(HASH_SIZE << lpc, np.uint32)
            n_out = np.zeros(dst_end + 8, np.uint8)
            n_written = 0
        table = _MatchTable(lpc) if not use_native else None
        cond = min_match == MIN_MATCH3
        size_chunk = min(dst_end, CHUNK_SIZE)
        start_chunk = 0
        out = bytearray()

        ibs_all = BitReader(buf) if use_native else None
        while start_chunk < dst_end:
            end_chunk = min(start_chunk + size_chunk, dst_end)
            size_chunk = end_chunk - start_chunk
            if src_idx >= count:
                raise ValueError("ROLZ: truncated stream")
            if use_native:
                ibs = ibs_all
                ibs.seek(8 * src_idx)
            else:
                ibs = BitReader(bytes(data[src_idx:count]))
            lit_len_total = ibs.read_bits(32)
            tk_len = ibs.read_bits(32)
            mlen_len = ibs.read_bits(32)
            midx_len = ibs.read_bits(32)
            first_lit_len = min(size_chunk, 8)
            if lit_len_total < first_lit_len or lit_len_total > size_chunk or \
                    (tk_len == 0 and midx_len != 0) or \
                    (tk_len > 0 and midx_len + 1 != tk_len):
                raise ValueError("ROLZ: invalid stream layout")
            sub_ctx = Context({"bsVersion": 6,
                               "device": self.ctx.get("device")})
            dec = ANSRangeDecoder(ibs, sub_ctx, order=lit_order)
            lit_np = dec.decode(lit_len_total)
            dec.dispose()
            dec2 = ANSRangeDecoder(ibs, sub_ctx, order=0, chunk_size=32768)
            tk_np = dec2.decode(tk_len)
            lens_np = dec2.decode(mlen_len)
            midx_np = dec2.decode(midx_len)
            dec2.dispose()
            if use_native:
                src_idx = (ibs.tell() + 7) >> 3
            else:
                src_idx += (ibs.tell() + 7) >> 3

            if use_native:
                if tk_len == 0:
                    if lit_len_total != size_chunk:
                        raise ValueError(
                            "ROLZ: literal-only chunk size mismatch")
                    n_out[n_written:n_written + size_chunk] = lit_np
                    n_written += size_chunk
                    start_chunk = end_chunk
                    continue
                n_matches[:] = 0
                _nat.rolz1_rebuild(
                    lit_np, tk_np, lens_np, midx_np, n_out, n_written,
                    size_chunk, dst_end, cond, delta, min_match, lpc,
                    n_counters, n_matches)
                n_written += size_chunk
                start_chunk = end_chunk
                continue

            lit = lit_np.tolist()
            tk = tk_np.tolist()
            lens = lens_np.tolist() + [0] * 4
            midx = midx_np.tolist()

            if tk_len == 0:
                if lit_len_total != size_chunk:
                    raise ValueError("ROLZ: literal-only chunk size mismatch")
                out += bytes(lit)
                start_chunk = end_chunk
                continue

            chunk_base = len(out)
            lit_idx = 0
            lens_idx = 0
            midx_idx = 0
            tk_idx = 0
            dst_idx = 0
            n = min(dst_end - chunk_base, 8)
            for _ in range(n):
                out.append(lit[lit_idx])
                lit_idx += 1
                dst_idx += 1

            while dst_idx < size_chunk:
                token = tk[tk_idx]
                tk_idx += 1
                mlen = token & 0x07
                if mlen == 7:
                    if lens_idx >= mlen_len:
                        raise ValueError("ROLZ: length overrun")
                    extra, lens_idx = _read_length1(lens, lens_idx)
                    mlen = 7 + min_match + extra
                else:
                    mlen += min_match
                lit_len = token >> 3
                if token >= 0xF8:
                    if lens_idx >= mlen_len:
                        raise ValueError("ROLZ: length overrun")
                    lit_len, lens_idx = _read_length1(lens, lens_idx)
                    lit_len += 31
                if lit_len > 0:
                    out += bytes(lit[lit_idx:lit_idx + lit_len])
                    src_inc = 0
                    k = 0
                    while k < lit_len:
                        rp = chunk_base + dst_idx + k - delta
                        if cond:
                            key = _key1(out[rp], out[rp + 1])
                        else:
                            w = int.from_bytes(bytes(out[rp:rp + 8]).ljust(8, b"\x00"), "little")
                            key = _key2(w)
                        table.counters[key] = (table.counters[key] + 1) & table.mask
                        table.matches[(key << lpc) + table.counters[key]] = dst_idx + k
                        k += 1 + (src_inc >> 6)
                        src_inc += 1
                    lit_idx += lit_len
                    dst_idx += lit_len
                    if dst_idx >= size_chunk:
                        if dst_idx == size_chunk:
                            break
                        raise ValueError("ROLZ: chunk overrun")
                if chunk_base + dst_idx + mlen > dst_end:
                    raise ValueError("ROLZ: match overruns output")
                m_idx = midx[midx_idx]
                midx_idx += 1
                rp = chunk_base + dst_idx - delta
                if cond:
                    key = _key1(out[rp], out[rp + 1])
                else:
                    wv = int.from_bytes(bytes(out[rp:rp + 8]).ljust(8, b"\x00"), "little")
                    key = _key2(wv)
                ref = table.matches[(key << lpc) + ((table.counters[key] - m_idx) & table.mask)]
                table.counters[key] = (table.counters[key] + 1) & table.mask
                table.matches[(key << lpc) + table.counters[key]] = dst_idx
                for _ in range(mlen):
                    out.append(out[chunk_base + ref])
                    ref += 1
                dst_idx += mlen

            if tk_idx != tk_len or midx_idx != midx_len or \
                    lit_idx != lit_len_total or lens_idx != mlen_len:
                raise ValueError("ROLZ: buffers not fully consumed")
            start_chunk = end_chunk

        if count - src_idx != 4:
            raise ValueError("ROLZ: missing tail bytes")
        if use_native:
            n_out[n_written:n_written + 4] = src[src_idx:src_idx + 4]
            return n_out[:n_written + 4].copy()
        out += bytes(data[src_idx:src_idx + 4])
        return np.frombuffer(bytes(out), dtype=np.uint8)


class _BinCoder:
    """ROLZEncoder/ROLZDecoder 56-bit binary coder with 2 prob tables."""

    MATCH_FLAG = 0
    LITERAL_FLAG = 1
    PSCALE = 0xFFFF
    TOP = 0x00FFFFFFFFFFFFFF

    def __init__(self, lit_log_size, m_log_size):
        self.log_sizes = {self.MATCH_FLAG: m_log_size,
                          self.LITERAL_FLAG: lit_log_size}
        self.probs = {self.MATCH_FLAG: [self.PSCALE >> 1] * (256 << m_log_size),
                      self.LITERAL_FLAG: [self.PSCALE >> 1] * (256 << lit_log_size)}
        self.low = 0
        self.high = self.TOP
        self.c1 = 1
        self.ctx = 0
        self.p_idx = self.LITERAL_FLAG

    def reset(self):
        for k in self.probs:
            sz = 256 << self.log_sizes[k]
            self.probs[k] = [self.PSCALE >> 1] * sz

    def set_context(self, n, ctx_byte):
        self.p_idx = n
        self.ctx = ctx_byte << self.log_sizes[n]


class _ROLZEncoder(_BinCoder):
    def __init__(self, lit_log_size, m_log_size, buf: bytearray):
        super().__init__(lit_log_size, m_log_size)
        self.buf = buf

    def encode_bit(self, bit):
        p = self.probs[self.p_idx]
        i = self.ctx + self.c1
        split = (((self.high - self.low) >> 4) * (p[i] >> 4)) >> 8
        if bit == 0:
            self.low = (self.low + split + 1) & M64
            p[i] -= p[i] >> 5
            self.c1 += self.c1
        else:
            self.high = (self.low + split) & M64
            p[i] -= (p[i] - self.PSCALE + 32) >> 5
            self.c1 += self.c1 + 1
        while ((self.low ^ self.high) >> 24) == 0:
            self.buf += ((self.high >> 32) & M32).to_bytes(4, "big")
            self.low = (self.low << 32) & M64
            self.high = ((self.high << 32) | 0xFFFFFFFF) & M64

    def encode_bits(self, val, n):
        self.c1 = 1
        while n:
            n -= 1
            self.encode_bit(val & (1 << n))

    def encode9(self, val):
        self.c1 = 1
        for sh in range(8, -1, -1):
            self.encode_bit(val & (1 << sh))

    def dispose(self):
        low = self.low
        for _ in range(8):
            self.buf.append((low >> 56) & 0xFF)
            low = (low << 8) & M64


class _ROLZDecoder(_BinCoder):
    def __init__(self, lit_log_size, m_log_size, data, idx):
        super().__init__(lit_log_size, m_log_size)
        self.data = data
        self.idx = idx
        cur = 0
        for i in range(8):
            cur = (cur << 8) | data[self.idx + i]
        self.idx += 8
        self.current = cur

    def decode_bit(self):
        p = self.probs[self.p_idx]
        i = self.ctx + self.c1
        mid = self.low + ((((self.high - self.low) >> 4) * (p[i] >> 4)) >> 8)
        if mid >= self.current:
            bit = 1
            self.high = mid
            p[i] -= (p[i] - self.PSCALE + 32) >> 5
            self.c1 += self.c1 + 1
        else:
            bit = 0
            self.low = mid + 1
            p[i] -= p[i] >> 5
            self.c1 += self.c1
        while ((self.low ^ self.high) >> 24) == 0:
            self.low = (self.low << 32) & self.TOP
            self.high = ((self.high << 32) | 0xFFFFFFFF) & self.TOP
            val = int.from_bytes(bytes(self.data[self.idx:self.idx + 4]), "big")
            self.current = ((self.current << 32) | val) & self.TOP
            self.idx += 4
        return bit

    def decode_bits(self, n):
        self.c1 = 1
        mask = (1 << n) - 1
        while n:
            self.decode_bit()
            n -= 1
        return self.c1 & mask

    def decode9(self):
        self.c1 = 1
        for _ in range(9):
            self.decode_bit()
        return self.c1 & 0x1FF


class _ROLZCodec2:
    MATCH_CTX = 0
    LITERAL_CTX = 1
    MATCH_FLAG = 0
    LITERAL_FLAG = 1

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.lpc = LOG_POS_CHECKS2
        self.output_capacity = None

    def max_encoded_length(self, src_len: int) -> int:
        return src_len + (1024 if src_len < 32768 else src_len >> 5)

    def forward(self, src: np.ndarray) -> Optional[np.ndarray]:
        count = len(src)
        capacity = self.output_capacity or self.max_encoded_length(count)
        if capacity < self.max_encoded_length(count):
            return None
        src_end = count - 4

        from kanzi_tpu_torch.utils import native as _nat
        if _nat.transforms_available():
            min_match, delta, flags = _detect_flags(self.ctx, src, count,
                                                    False)
            cond = min_match == MIN_MATCH3
            data_padded = np.concatenate([src, np.zeros(8, np.uint8)])
            stream = _nat.rolz2_forward(data_padded, count, cond, delta,
                                        min_match)
            if stream is None or 5 + len(stream) >= count:
                return None
            header = (count & M32).to_bytes(4, "big") + bytes([flags])
            return np.frombuffer(header + stream.tobytes(), dtype=np.uint8)

        data = src.tolist()
        padded = np.concatenate([src, np.zeros(8, np.uint8)]).astype(np.uint64)
        w = np.zeros(count, dtype=np.uint64)
        for k in range(8):
            w |= padded[k:count + k] << np.uint64(8 * k)
        wl = w.tolist()

        min_match, delta, flags = _detect_flags(self.ctx, src, count, False)
        cond = min_match == MIN_MATCH3
        dst = bytearray()
        dst += (count & M32).to_bytes(4, "big")
        dst.append(flags)
        table = _MatchTable(self.lpc)
        enc = _ROLZEncoder(9, self.lpc, dst)
        size_chunk = min(count, CHUNK_SIZE)
        start_chunk = 0
        src_idx = 0

        while start_chunk < src_end:
            table.clear_matches()
            end_chunk = min(start_chunk + size_chunk, src_end)
            size_chunk = end_chunk - start_chunk
            enc.reset()
            base = start_chunk
            src_idx = 0
            n = min(src_end - start_chunk, 8)
            enc.set_context(self.LITERAL_CTX, 0)
            for _ in range(n):
                enc.encode9((self.LITERAL_FLAG << 8) | data[base + src_idx])
                src_idx += 1

            while src_idx < size_chunk:
                enc.set_context(self.LITERAL_CTX, data[base + src_idx - 1])
                rp = base + src_idx - delta
                key = _key1(data[rp], data[rp + 1]) if cond else _key2(wl[rp])
                match = self._find_match2(wl, data, base, src_idx, size_chunk,
                                          table, key, min_match)
                if match < 0:
                    enc.encode9((self.LITERAL_FLAG << 8) | data[base + src_idx])
                    src_idx += 1
                    continue
                mlen = match & 0xFFFF
                enc.encode9((self.MATCH_FLAG << 8) | mlen)
                enc.set_context(self.MATCH_CTX, data[base + src_idx - 1])
                enc.encode_bits(match >> 16, self.lpc)
                src_idx += mlen + min_match
            start_chunk = end_chunk

        for i in range(4):
            enc.set_context(self.LITERAL_CTX, data[base + src_idx - 1])
            enc.encode9((self.LITERAL_FLAG << 8) | data[base + src_idx])
            src_idx += 1
        enc.dispose()
        if base + src_idx != count or len(dst) >= count:
            return None
        return np.frombuffer(bytes(dst), dtype=np.uint8)

    def _find_match2(self, wl, data, base, pos, end, table, key, min_match):
        counter = table.counters[key]
        mbase = key << table.lpc
        h32 = _hash32(int.from_bytes(bytes(data[base + pos:base + pos + 4]), "little"))
        best_len = 0
        best_idx = -1
        max_match = min(MAX_MATCH2, end - pos) - 8
        for i in range(counter, counter - table.pos_checks, -1):
            ref = table.matches[mbase + (i & table.mask)]
            if (ref & HASH_MASK32) != h32:
                continue
            ref &= ~HASH_MASK32 & M32
            if data[base + ref + best_len] != data[base + pos + best_len]:
                continue
            n = 0
            while n < max_match:
                d = wl[base + ref + n] ^ wl[base + pos + n]
                if d:
                    n += ((d & -d).bit_length() - 1) >> 3
                    break
                n += 8
            if n > best_len:
                best_idx = counter - i
                best_len = n
                if best_len == max_match:
                    break
        table.counters[key] = (table.counters[key] + 1) & table.mask
        table.matches[mbase + table.counters[key]] = (h32 | pos) & M32
        if best_len < min_match:
            return -1
        return (best_idx << 16) | (best_len - min_match)

    def inverse(self, src: np.ndarray) -> np.ndarray:
        count = len(src)
        if count < 13:
            raise ValueError("ROLZX: truncated stream")
        hdr = bytes(src[:5].tobytes())
        dst_end0 = int.from_bytes(hdr[0:4], "big")
        flags0 = hdr[4]
        if dst_end0 <= 0:
            raise ValueError("ROLZX: invalid size")
        mm0, d0 = MIN_MATCH3, 2
        if (flags0 & 0x0E) == 8:
            d0 = 3
        elif (flags0 & 0x0E) == 4:
            d0 = 8
            mm0 = MIN_MATCH7
        from kanzi_tpu_torch.utils import native as _nat
        if _nat.transforms_available():
            # idx0 = 5: the coder reads its own 8 initial state bytes
            return _nat.rolz2_inverse(src, 5, dst_end0,
                                      mm0 == MIN_MATCH3, d0, mm0)

        data = src.tolist()
        dst_end = int.from_bytes(bytes(data[0:4]), "big")
        if dst_end <= 0:
            raise ValueError("ROLZX: invalid size")
        src_idx = 5
        min_match = MIN_MATCH3
        flags = data[4]
        delta = 2
        if (flags & 0x0E) == 8:
            delta = 3
        elif (flags & 0x0E) == 4:
            delta = 8
            min_match = MIN_MATCH7
        cond = min_match == MIN_MATCH3
        dec = _ROLZDecoder(9, self.lpc, data, src_idx)
        table = _MatchTable(self.lpc)
        size_chunk = min(dst_end, CHUNK_SIZE)
        start_chunk = 0
        out = bytearray()

        while start_chunk < dst_end:
            table.clear_matches()
            end_chunk = min(start_chunk + size_chunk, dst_end)
            size_chunk = end_chunk - start_chunk
            dec.reset()
            chunk_base = len(out)
            dst_idx = 0
            dec.set_context(self.LITERAL_CTX, 0)
            n = min(dst_end - chunk_base, 8)
            for _ in range(n):
                val = dec.decode9()
                if (val >> 8) == self.MATCH_FLAG:
                    raise ValueError("ROLZX: unexpected match flag")
                out.append(val & 0xFF)
                dst_idx += 1

            while dst_idx < size_chunk:
                saved_idx = dst_idx
                rp = chunk_base + dst_idx - delta
                if cond:
                    key = _key1(out[rp], out[rp + 1])
                else:
                    wv = int.from_bytes(bytes(out[rp:rp + 8]).ljust(8, b"\x00"), "little")
                    key = _key2(wv)
                dec.set_context(self.LITERAL_CTX, out[chunk_base + dst_idx - 1])
                val = dec.decode9()
                if (val >> 8) == self.LITERAL_FLAG:
                    out.append(val & 0xFF)
                    dst_idx += 1
                else:
                    mlen = val & 0xFF
                    if dst_idx + mlen + 3 > dst_end:
                        raise ValueError("ROLZX: match overrun")
                    dec.set_context(self.MATCH_CTX, out[chunk_base + dst_idx - 1])
                    m_idx = dec.decode_bits(self.lpc)
                    ref = table.matches[(key << table.lpc)
                                        + ((table.counters[key] - m_idx) & table.mask)]
                    for _ in range(mlen + min_match):
                        out.append(out[chunk_base + ref])
                        ref += 1
                    dst_idx += mlen + min_match
                table.counters[key] = (table.counters[key] + 1) & 0xFF
                table.matches[(key << table.lpc)
                              + (table.counters[key] & table.mask)] = saved_idx
            start_chunk = end_chunk

        src_idx = dec.idx
        if src_idx != count:
            raise ValueError("ROLZX: stream not fully consumed")
        return np.frombuffer(bytes(out), dtype=np.uint8)
