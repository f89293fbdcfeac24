"""LZ codec family: LZX (hash-table LZ77) and LZP (predict-only LZ).

Reference: src/transform/LZCodec.{cpp,hpp}.
LZX<T>: HASH_LOG 16 (LZ) / 19 (LZX), 2 repeat-distance slots, min match 4
(6 for DNA, skip for SMALL_ALPHABET), distances <= 2^24-2. Output = 4
streams: header (12B stream ends + 1B flags) + literals + tokens +
match-distances + match-lengths; token LLLFFMMM; lengths in 1/3/4-byte
tiers; success requires dstIdx <= count - count/100.
LZP: 32-bit context hash -> position table; matches >= 64 emitted as
0xFC + length/254 bytes; literal 0xFC with live table entry escaped 0xFF.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import kanzi_tpu_torch.ops as ops
from kanzi_tpu_torch.core import stats
from kanzi_tpu_torch.ops import block_device
from kanzi_tpu_torch.transform.base import ByteTransform, as_u8

HASH_SEED = 0x1E35A7BD
MAX_DISTANCE1 = (1 << 16) - 2
MAX_DISTANCE2 = (1 << 24) - 2
MIN_MATCH4 = 4
MIN_MATCH6 = 6
MAX_MATCH = 65535 + 254 + MIN_MATCH4
MIN_BLOCK_LENGTH = 24
M64 = (1 << 64) - 1


# By hash_log (16: LZ, level 2; 19: LZX, levels 1 and 3), the bytes a
# block from which its forward goes to the card: the match pass there
# (kernel K) and the native parse that reads its hints, in place of the
# native parse alone; None: never. Set by chip_smoke.py's CLI compress
# on an H100 with the gate open and closed in turns (PERF.md): LZX wins
# at 1 and 4 MiB blocks and loses at 256 KiB; LZ loses at 4 MiB, where
# the native parse's table fits the host's L2.
LZ_HINT_MIN_BLOCK = {16: None, 19: 1 << 20}


def _lz_on_device(dev, count: int, hash_log: int) -> bool:
    """True where the block's match pass runs on ``dev`` and the parse
    reads its hints: ops enabled, a CUDA device, a block of at least
    LZ_HINT_MIN_BLOCK[hash_log] bytes."""
    least = LZ_HINT_MIN_BLOCK.get(hash_log)
    return (ops.ENABLED and dev is not None and dev.type == "cuda"
            and least is not None and count >= least)


def _hinted_forward(src: np.ndarray, hash_log: int, min_match: int, dev):
    """The LZ match pass over src on dev, then the native parse from its
    hints (native.lzx_forward_hinted): lzx_forward's bytes, or None. A
    failed launch raises; there is no fallback to the native parse."""
    from kanzi_tpu_torch.ops import lz as dlz
    from kanzi_tpu_torch.utils import native
    if not native.lzx_hint_available():
        raise RuntimeError("LZ: the hinted parse (csrc/lzx_hint.cpp) did "
                           "not build")
    prev, lcp = dlz.lz_match_pass(src, hash_log, dev, lcp_dtype=np.uint8)
    ops.count("lz_hinted_blocks")
    return native.lzx_forward_hinted(src, hash_log, min_match, prev, lcp,
                                     cap=dlz.CAP)


def _emit_length(buf: bytearray, length: int) -> None:
    if length < 254:
        buf.append(length)
    elif length < 65536 + 254:
        l = length - 254
        buf.append(0xFE)
        buf.append((l >> 8) & 0xFF)
        buf.append(l & 0xFF)
    else:
        l = length - 255
        buf.append(0xFF)
        buf.append((l >> 16) & 0xFF)
        buf.append((l >> 8) & 0xFF)
        buf.append(l & 0xFF)


def _read_length(data, pos):
    res = data[pos]
    pos += 1
    if res < 254:
        return res, pos
    if res == 254:
        res += (data[pos] << 8) | data[pos + 1]
        return res, pos + 2
    res += (data[pos] << 16) | (data[pos + 1] << 8) | data[pos + 2]
    return res, pos + 3


class LZCodec(ByteTransform):
    """LZXCodec<T> with T = extra searches (LZX id) or not (LZ id)."""

    def __init__(self, ctx=None, extra: bool = False):
        super().__init__(ctx)
        self.extra = extra
        self.hash_log = 19 if extra else 16
        self.hash_rshift = 64 - self.hash_log

    def max_encoded_length(self, src_len: int) -> int:
        return ((src_len + 16 if src_len <= 1024 else src_len + (src_len // 64))
                + 2)  # +2 readLength guard

    def _hash(self, val64: int) -> int:
        return (((val64 << 24) & M64) * HASH_SEED & M64) >> self.hash_rshift

    def forward(self, src: np.ndarray) -> Optional[np.ndarray]:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        if count < MIN_BLOCK_LENGTH:
            return None

        dt = self.ctx.get_int("dataType", stats.UNDEFINED)
        mm = MIN_MATCH4
        if dt == stats.DNA:
            mm = MIN_MATCH6
        elif dt == stats.SMALL_ALPHABET:
            return None
        min_match = mm

        # on a card: the match pass (ops/lz.py, kernel K), then the parse
        # that reads its hints (csrc/lzx_hint.cpp); the same bytes as the
        # native parse below, which the host path and the CPU run
        dev = block_device(self.ctx)
        if _lz_on_device(dev, count, self.hash_log):
            return _hinted_forward(src, self.hash_log, min_match, dev)

        # native fast path (byte-identical C++ port, native/lzx.cpp)
        try:
            from kanzi_tpu_torch.utils import native
            if native.lzx_available():
                out = native.lzx_forward(src, self.hash_log, min_match)
                return None if out is None else out
        except Exception:
            pass

        data = src.tolist()
        # precompute rolling 8-byte little-endian words -> hashes, vectorized
        padded = np.concatenate([src, np.zeros(8, np.uint8)]).astype(np.uint64)
        w = np.zeros(count, dtype=np.uint64)
        for k in range(8):
            w |= padded[k:count + k] << np.uint64(8 * k)
        hashes_all = (((w << np.uint64(24)) * np.uint64(HASH_SEED))
                      >> np.uint64(self.hash_rshift)).astype(np.int64).tolist()

        src_end = count - 16 - 2
        max_dist = MAX_DISTANCE1 if src_end < 4 * MAX_DISTANCE1 else MAX_DISTANCE2
        flags = 0 if max_dist == MAX_DISTANCE1 else 1
        flags |= ((mm - 2) & 0x07) << 1

        table = [0] * (1 << self.hash_log)
        lit = bytearray()  # dst from 13
        tk = bytearray()
        mbuf = bytearray()
        mlen_buf = bytearray()

        wl = w.tolist()

        def find_match(_src, a, b, max_match):
            # 8-byte stride compare (LZCodec.hpp:232-248): match length is
            # capped at the last full-stride boundary, like the reference
            n = 0
            while n + 8 <= max_match:
                d = wl[a + n] ^ wl[b + n]
                if d:
                    return n + (((d & -d).bit_length() - 1) >> 3)
                n += 8
            return n

        def mem_eq4(a, b):
            return (wl[a] ^ wl[b]) & 0xFFFFFFFF == 0

        src_idx = 0
        anchor = 0
        repd = [count, count]
        rep_idx = 0
        src_inc = 0

        while src_idx < src_end:
            best_len = 0
            h0 = hashes_all[src_idx]
            ref0 = table[h0]
            table[h0] = src_idx
            src_idx1 = src_idx + 1
            ref = src_idx1 - repd[rep_idx]
            min_ref = max(src_idx - max_dist, 0)

            if ref > min_ref and mem_eq4(src_idx1, ref):
                best_len = find_match(src, src_idx1, ref,
                                      min(src_end - src_idx1, MAX_MATCH))
            else:
                ref = src_idx1 - repd[rep_idx ^ 1]
                if ref > min_ref and mem_eq4(src_idx1, ref):
                    best_len = find_match(src, src_idx1, ref,
                                          min(src_end - src_idx1, MAX_MATCH))

            if best_len < min_match:
                ref = ref0
                if ref > min_ref and mem_eq4(src_idx, ref):
                    best_len = find_match(src, src_idx, ref,
                                          min(src_end - src_idx, MAX_MATCH))
                if best_len < min_match:
                    src_idx = src_idx1 + (src_inc >> 6)
                    src_inc += 1
                    rep_idx = 0
                    continue
                if (src_idx - ref != repd[0]) and (src_idx - ref != repd[1]):
                    # check for a better match at next position(s)
                    h1 = hashes_all[src_idx1]
                    ref1 = table[h1]
                    table[h1] = src_idx1
                    if (ref1 > min_ref + 1
                            and mem_eq4(src_idx1 + best_len - 3, ref1 + best_len - 3)):
                        best_len1 = find_match(src, src_idx1, ref1,
                                               min(src_end - src_idx1, MAX_MATCH))
                        if best_len1 >= best_len:
                            ref = ref1
                            best_len = best_len1
                            src_idx = src_idx1
                    if self.extra:
                        src_idx2 = src_idx1 + 1
                        h2 = hashes_all[src_idx2]
                        ref2 = table[h2]
                        table[h2] = src_idx2
                        if (ref2 > min_ref + 2
                                and mem_eq4(src_idx2 + best_len - 3, ref2 + best_len - 3)):
                            best_len2 = find_match(src, src_idx2, ref2,
                                                   min(src_end - src_idx2, MAX_MATCH))
                            if best_len2 >= best_len:
                                ref = ref2
                                best_len = best_len2
                                src_idx = src_idx2
                # extend backwards
                while src_idx > anchor and ref > min_ref and data[src_idx - 1] == data[ref - 1]:
                    best_len += 1
                    ref -= 1
                    src_idx -= 1
                if best_len > MAX_MATCH:
                    ref += best_len - MAX_MATCH
                    src_idx += best_len - MAX_MATCH
                    best_len = MAX_MATCH
            else:
                if best_len >= MAX_MATCH or data[src_idx] != data[ref - 1]:
                    src_idx += 1
                    h1 = hashes_all[src_idx]
                    table[h1] = src_idx
                else:
                    best_len += 1
                    ref -= 1

            # emit match
            src_inc = 0
            dist = src_idx - ref
            if dist == repd[0]:
                token = 0x00
                mlen_th = 3
            elif dist == repd[1]:
                token = 0x04
                mlen_th = 3
            else:
                if dist >= 65536:
                    mbuf.append((dist >> 16) & 0xFF)
                if dist >= 256:
                    mbuf.append((dist >> 8) & 0xFF)
                mbuf.append(dist & 0xFF)
                inc = 1 + (1 if dist >= 256 else 0) + (1 if dist >= 65536 else 0)
                token = inc << 3
                mlen_th = 7

            mlen = best_len - min_match
            if mlen >= mlen_th:
                token += mlen_th
                _emit_length(mlen_buf, mlen - mlen_th)
            else:
                token += mlen

            repd[1] = repd[0]
            repd[0] = dist
            rep_idx = 1
            lit_len = src_idx - anchor

            if lit_len == 0:
                tk.append(token)
            else:
                if lit_len >= 7:
                    if lit_len >= (1 << 24):
                        return None
                    tk.append((7 << 5) | token)
                    _emit_length(lit, lit_len - 7)
                else:
                    tk.append((lit_len << 5) | token)
                lit += src[anchor:anchor + lit_len].tobytes()

            # fill hashes for covered positions
            anchor = src_idx + best_len
            for p in range(src_idx + 1, anchor):
                table[hashes_all[p] if p < count else 0] = p
            src_idx = anchor

        # last literals
        lit_len = count - anchor
        dst_idx = 13 + len(lit)
        if dst_idx + lit_len + len(tk) + len(mbuf) + len(mlen_buf) >= count:
            return None
        if lit_len >= 7:
            tk.append(7 << 5)
            _emit_length(lit, lit_len - 7)
        else:
            tk.append(lit_len << 5)
        lit += src[anchor:count].tobytes()

        header = bytearray(13)
        total_lit_end = 13 + len(lit)
        header[0:4] = int(total_lit_end).to_bytes(4, "little")
        header[4:8] = len(tk).to_bytes(4, "little")
        header[8:12] = len(mbuf).to_bytes(4, "little")
        header[12] = flags
        out = bytes(header) + bytes(lit) + bytes(tk) + bytes(mbuf) + bytes(mlen_buf)
        if len(out) > count - (count // 100):
            return None
        return np.frombuffer(out, dtype=np.uint8)

    def inverse_into(self, src: np.ndarray, out: np.ndarray):
        """Native inverse straight into `out` (a view of the final
        result buffer). Returns the output length, or None to make the
        caller fall back to the allocating path."""
        src = as_u8(src)
        if len(src) < 13 or self.ctx.get_int("bsVersion", 6) < 6:
            return None
        from kanzi_tpu_torch.utils import native
        if not native.transforms_available():
            return None
        return native.lzx_inverse_into(src, out)

    def inverse(self, src: np.ndarray) -> np.ndarray:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        if count < 13:
            raise ValueError("LZ codec: block too short")
        bs_version = self.ctx.get_int("bsVersion", 6)
        if bs_version < 6:
            return self._inverse_v5(src, count)
        from kanzi_tpu_torch.utils import native
        if native.transforms_available():
            return native.lzx_inverse(src, max(4 * count, 1 << 20))
        data = src.tolist()
        tk_idx = int.from_bytes(src[0:4].tobytes(), "little", signed=True)
        m_idx = int.from_bytes(src[4:8].tobytes(), "little", signed=True)
        mlen_idx = int.from_bytes(src[8:12].tobytes(), "little", signed=True)
        if tk_idx < 0 or m_idx < 0 or mlen_idx < 0:
            raise ValueError("LZ codec: negative stream index")
        if (tk_idx < 13 or tk_idx > count or m_idx > count - tk_idx
                or mlen_idx > count - tk_idx - m_idx):
            raise ValueError("LZ codec: invalid stream layout")
        m_idx += tk_idx
        mlen_idx += m_idx

        src_end = tk_idx - 13
        lit_end = tk_idx
        max_dist = MAX_DISTANCE1 if (data[12] & 1) == 0 else MAX_DISTANCE2
        min_match = ((data[12] >> 1) & 0x07) + 2
        src_idx = 13
        out = bytearray()
        repd0 = count
        repd1 = count

        while True:
            token = data[tk_idx]
            tk_idx += 1
            if (token & 0x18) == 0:
                mlen = token & 0x03
                if mlen == 3:
                    extra, mlen_idx = _read_length(data, mlen_idx)
                    mlen = 3 + min_match + extra
                else:
                    mlen += min_match
                dist = repd0 if (token & 0x04) == 0 else repd1
            else:
                mlen = token & 0x07
                if mlen == 7:
                    extra, mlen_idx = _read_length(data, mlen_idx)
                    mlen = 7 + min_match + extra
                else:
                    mlen += min_match
                dist = data[m_idx]
                m_idx += 1
                f1 = (token >> 4) & 1
                f2 = (token >> 3) & f1
                if f1:
                    dist = (dist << 8) | data[m_idx]
                    m_idx += 1
                if f2:
                    dist = (dist << 8) | data[m_idx]
                    m_idx += 1

            if token >= 32:
                if token >= 0xE0:
                    extra, src_idx = _read_length(data, src_idx)
                    lit_len = 7 + extra
                else:
                    lit_len = token >> 5
                if lit_len > lit_end - src_idx:
                    raise ValueError("LZ codec: literal overrun")
                out += src[src_idx:src_idx + lit_len].tobytes()
                src_idx += lit_len
                if src_idx >= src_end:
                    break

            repd1 = repd0
            repd0 = dist
            ref = len(out) - dist
            if ref < 0 or dist > max_dist:
                raise ValueError("LZ codec: invalid match distance")
            if dist >= mlen:
                out += out[ref:ref + mlen]
            else:
                for _ in range(mlen):
                    out.append(out[ref])
                    ref += 1
        if src_idx != src_end + 13:
            raise ValueError("LZ codec: stream not fully consumed")
        return np.frombuffer(bytes(out), dtype=np.uint8)

    def _inverse_v5(self, src: np.ndarray, count: int) -> np.ndarray:
        """bsVersion <= 5 wire format (LZCodec.cpp inverseV5:614-760):
        header holds tkIdx/mIdx/mLenIdx as RELATIVE stream offsets,
        token LLLRMMMM (R = repeat-distance select / extra distance
        byte), distances sized by the mFlag bit, minMatch from a
        4-entry table, repeat distances start at 0."""
        data = src.tolist()
        tk_idx = int.from_bytes(src[0:4].tobytes(), "little", signed=True)
        m_idx = int.from_bytes(src[4:8].tobytes(), "little", signed=True)
        mlen_idx = int.from_bytes(src[8:12].tobytes(), "little",
                                  signed=True)
        if tk_idx < 0 or m_idx < 0 or mlen_idx < 0:
            raise ValueError("LZ codec: negative stream index")
        if (tk_idx < 13 or tk_idx > count or m_idx > count - tk_idx
                or mlen_idx > count - tk_idx - m_idx):
            raise ValueError("LZ codec: invalid stream layout")
        m_idx += tk_idx
        mlen_idx += m_idx

        src_end = tk_idx - 13
        lit_end = tk_idx
        m_flag = data[12] & 1
        max_dist = MAX_DISTANCE1 if m_flag == 0 else MAX_DISTANCE2
        min_match = (MIN_MATCH4, 9, MIN_MATCH6,
                     MIN_MATCH6)[(data[12] >> 1) & 0x03]
        src_idx = 13
        out = bytearray()
        repd0 = 0
        repd1 = 0

        while True:
            token = data[tk_idx]
            tk_idx += 1
            if token >= 32:
                if token >= 0xE0:
                    extra, src_idx = _read_length(data, src_idx)
                    lit_len = 7 + extra
                else:
                    lit_len = token >> 5
                if lit_len > lit_end - src_idx:
                    raise ValueError("LZ codec: literal overrun")
                out += src[src_idx:src_idx + lit_len].tobytes()
                src_idx += lit_len
                if src_idx >= src_end:
                    break

            mlen = token & 0x0F
            if mlen == 15:
                extra, mlen_idx = _read_length(data, mlen_idx)
                mlen = min_match + extra
                dist = repd0 if (token & 0x10) == 0 else repd1
            else:
                if mlen == 14:
                    extra, mlen_idx = _read_length(data, mlen_idx)
                    mlen = 14 + min_match + extra
                else:
                    mlen += min_match
                dist = data[m_idx]
                m_idx += 1
                if m_flag != 0:
                    dist = (dist << 8) | data[m_idx]
                    m_idx += 1
                if (token >> 4) & 1:
                    dist = (dist << 8) | data[m_idx]
                    m_idx += 1

            repd1 = repd0
            repd0 = dist
            ref = len(out) - dist
            if ref < 0 or dist > max_dist:
                raise ValueError("LZ codec: invalid match distance")
            if dist >= mlen:
                out += out[ref:ref + mlen]
            else:
                for _ in range(mlen):
                    out.append(out[ref])
                    ref += 1
        if src_idx != src_end + 13:
            raise ValueError("LZ codec: stream not fully consumed")
        return np.frombuffer(bytes(out), dtype=np.uint8)


class LZPCodec(ByteTransform):
    HASH_SEED = 0x7FEB352D
    HASH_LOG = 16
    HASH_SHIFT = 32 - HASH_LOG
    MIN_MATCH = 64
    MIN_BLOCK_LENGTH = 128
    MATCH_FLAG = 0xFC

    def max_encoded_length(self, src_len: int) -> int:
        return src_len + 16 if src_len <= 1024 else src_len + (src_len // 64)

    def forward(self, src: np.ndarray) -> Optional[np.ndarray]:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        if count < 4 or count < self.MIN_BLOCK_LENGTH:
            return None
        from kanzi_tpu_torch.utils import native
        if native.transforms_available():
            return native.lzp_forward(src)
        data = src.tolist()
        padded = np.concatenate([src, np.zeros(8, np.uint8)]).astype(np.uint64)
        w = np.zeros(count, dtype=np.uint64)
        for k in range(8):
            w |= padded[k:count + k] << np.uint64(8 * k)
        wl = w.tolist()
        src_end = count
        dst_end = count - (count >> 6)
        table = [0] * (1 << self.HASH_LOG)
        dst = bytearray(data[:4])
        ctx = int.from_bytes(src[0:4].tobytes(), "little")
        src_idx = 4

        def find_match(_src, a, b, max_match):
            n = 0
            while n + 8 <= max_match:
                d = wl[a + n] ^ wl[b + n]
                if d:
                    return n + (((d & -d).bit_length() - 1) >> 3)
                n += 8
            return n

        while src_idx < src_end - self.MIN_MATCH and len(dst) < dst_end:
            h = ((self.HASH_SEED * ctx) & 0xFFFFFFFF) >> self.HASH_SHIFT
            ref = table[h]
            table[h] = src_idx
            best_len = 0
            if ref != 0 and wl[ref + self.MIN_MATCH - 8] == wl[src_idx + self.MIN_MATCH - 8]:
                best_len = find_match(src, src_idx, ref, src_end - src_idx)
            if best_len < self.MIN_MATCH:
                val = data[src_idx]
                ctx = ((ctx << 8) | val) & 0xFFFFFFFF
                dst.append(val)
                src_idx += 1
                if ref != 0 and val == self.MATCH_FLAG:
                    if len(dst) >= dst_end:
                        return None
                    dst.append(0xFF)
                continue
            src_idx += best_len
            ctx = int.from_bytes(src[src_idx - 4:src_idx].tobytes(), "little")
            dst.append(self.MATCH_FLAG)
            best_len -= self.MIN_MATCH
            while best_len >= 254 and len(dst) < dst_end:
                best_len -= 254
                dst.append(0xFE)
            if len(dst) >= dst_end:
                return None
            dst.append(best_len)

        while src_idx < src_end and len(dst) < dst_end:
            h = ((self.HASH_SEED * ctx) & 0xFFFFFFFF) >> self.HASH_SHIFT
            ref = table[h]
            table[h] = src_idx
            val = data[src_idx]
            ctx = ((ctx << 8) | val) & 0xFFFFFFFF
            dst.append(val)
            src_idx += 1
            if ref != 0 and val == self.MATCH_FLAG:
                if len(dst) >= dst_end:
                    return None
                dst.append(0xFF)

        if not (src_idx == count and len(dst) < dst_end):
            return None
        return np.frombuffer(bytes(dst), dtype=np.uint8)

    def inverse(self, src: np.ndarray) -> np.ndarray:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        if count < 4:
            raise ValueError("LZP: block too short")
        from kanzi_tpu_torch.utils import native
        if native.transforms_available():
            cap = max(4 * count, 4096)
            while True:
                try:
                    return native.lzp_inverse(src, cap)
                except ValueError as e:
                    if "overflow" not in str(e) or cap >= (1 << 30):
                        raise
                    cap *= 4
        data = src.tolist()
        table = [0] * (1 << self.HASH_LOG)
        dst = bytearray(data[:4])
        ctx = int.from_bytes(src[0:4].tobytes(), "little")
        src_idx = 4
        while src_idx < count:
            h = ((self.HASH_SEED * ctx) & 0xFFFFFFFF) >> self.HASH_SHIFT
            ref = table[h]
            table[h] = len(dst)
            if data[src_idx] != self.MATCH_FLAG or ref == 0:
                v = data[src_idx]
                ctx = ((ctx << 8) | v) & 0xFFFFFFFF
                dst.append(v)
                src_idx += 1
                continue
            src_idx += 1
            if src_idx >= count:
                raise ValueError("LZP: truncated stream")
            if data[src_idx] == 0xFF:
                ctx = ((ctx << 8) | self.MATCH_FLAG) & 0xFFFFFFFF
                dst.append(self.MATCH_FLAG)
                src_idx += 1
                continue
            mlen = self.MIN_MATCH
            while src_idx < count and data[src_idx] == 0xFE:
                src_idx += 1
                mlen += 254
            if src_idx >= count:
                raise ValueError("LZP: truncated match length")
            mlen += data[src_idx]
            src_idx += 1
            for i in range(mlen):
                dst.append(dst[ref + i])
            ctx = int.from_bytes(bytes(dst[-4:]), "little")
        return np.frombuffer(bytes(dst), dtype=np.uint8)
