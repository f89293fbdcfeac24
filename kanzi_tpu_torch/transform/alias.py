"""Alias codec (PACK / DNA).

Reference: src/transform/AliasCodec.cpp. Needs >= 16 absent byte values.
Small-alphabet mode packs <= 16 symbols into 4 bits / <= 4 into 2 bits
(n0 >= 240); otherwise digram mode replaces the most frequent byte pairs
with absent-value aliases (requires savings >= count/20). DNA variant
(packOnlyDNA) gates on detected DNA data.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from kanzi_tpu_torch.core import stats
from kanzi_tpu_torch.transform.base import ByteTransform, as_u8

MIN_BLOCK_SIZE = 1024


class AliasCodec(ByteTransform):
    def __init__(self, ctx=None, only_dna: bool = False):
        super().__init__(ctx)
        self.only_dna = only_dna or (ctx is not None and ctx.get_int("packOnlyDNA", 0) != 0)

    def max_encoded_length(self, src_len: int) -> int:
        return src_len + 1024

    def forward(self, src: np.ndarray) -> Optional[np.ndarray]:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        if count < MIN_BLOCK_SIZE:
            return None
        dt = self.ctx.get_int("dataType", stats.UNDEFINED)
        if dt in (stats.MULTIMEDIA, stats.UTF8, stats.EXE, stats.BIN):
            return None
        if self.only_dna and dt not in (stats.UNDEFINED, stats.DNA):
            return None

        from kanzi_tpu_torch.utils import native
        use_native = native.transforms_available()
        if use_native:
            # order-0 only here: the common exits (full alphabet, typed
            # data) never need the 64K order-1 table, which costs ~3x
            freqs0 = native.hist_o0(src)
        else:
            freqs0 = np.bincount(src, minlength=256).astype(np.int64)
        absent = np.nonzero(freqs0 == 0)[0].tolist()
        n0 = len(absent)
        if n0 < 16:
            return None
        if dt == stats.UNDEFINED:
            dt = stats.detect_simple_type(count, freqs0)
            if dt != stats.UNDEFINED:
                self.ctx.put("dataType", dt)
            if dt != stats.DNA and self.only_dna:
                return None

        dst = bytearray()
        if n0 >= 240:
            # small alphabet: pack bits
            dst.append(n0)
            if n0 == 255:
                dst.append(int(src[0]))
                dst += int(count).to_bytes(4, "little")
            else:
                present = np.nonzero(freqs0)[0]
                map8 = np.zeros(256, dtype=np.uint8)
                for j, sym in enumerate(present.tolist()):
                    dst.append(sym)
                    map8[sym] = j
                m = map8[src]
                if n0 >= 252:
                    c3 = count & 3
                    dst.append(c3)
                    dst += src[:c3].tobytes()
                    q = m[c3:].reshape(-1, 4)
                    packed = (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]
                    dst += packed.astype(np.uint8).tobytes()
                else:
                    c1 = count & 1
                    dst.append(c1)
                    if c1:
                        dst += src[:1].tobytes()
                    q = m[c1:].reshape(-1, 2)
                    packed = (q[:, 0] << 4) | q[:, 1]
                    dst += packed.astype(np.uint8).tobytes()
        else:
            # digram mode (freqs1 == order-1 histogram with prev=0 seed)
            if use_native:
                _, h1 = native.hist_o01(src)
                freqs1 = h1.reshape(-1)
            else:
                idx = (src[:-1].astype(np.int64) << 8) | src[1:]
                freqs1 = np.bincount(idx, minlength=65536).astype(np.int64)
                freqs1[src[0]] += 1
            # NOTE: reference uses computeHistogram(..., false) without
            # total: freqs[prv<<8|cur] with prv=0 seed for the first byte
            present1 = np.nonzero(freqs1)[0]
            n1 = len(present1)
            if n1 < n0:
                n0 = n1
                if n0 < 16:
                    return None
            # sort by freq desc then value desc
            order = sorted(present1.tolist(),
                           key=lambda v: (-int(freqs1[v]), -v))
            map16_alias = np.full(65536, -1, dtype=np.int64)
            dst.append(n0)
            dst.append(0)
            savings = 0
            for i in range(n0):
                val = order[i]
                savings += int(freqs1[val])
                map16_alias[val] = absent[i]
                dst.append((val >> 8) & 0xFF)
                dst.append(val & 0xFF)
                dst.append(absent[i])
            if savings < count // 20:
                return None
            if use_native:
                body, odd = native.alias_emit(src, map16_alias)
                dst += body
                if odd:
                    dst[1] = 1
            else:
                data = src.tolist()
                src_idx = 0
                src_end = count - 1
                while src_idx < src_end:
                    pair = (data[src_idx] << 8) | data[src_idx + 1]
                    a = map16_alias[pair]
                    if a >= 0:
                        dst.append(int(a))
                        src_idx += 2
                    else:
                        dst.append(data[src_idx])
                        src_idx += 1
                if src_idx != count:
                    dst[1] = 1
                    dst.append(data[src_idx])
        if len(dst) >= count:
            return None
        return np.frombuffer(bytes(dst), dtype=np.uint8)

    def inverse(self, src: np.ndarray) -> np.ndarray:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        data = src.tolist()
        n = data[0]
        if n < 16:
            raise ValueError("Alias codec: invalid symbol count")
        if n >= 240:
            n = 256 - n
            if n == 1:
                if count < 6:
                    raise ValueError("Alias codec: block too short")
                val = data[1]
                o_size = int.from_bytes(src[2:6].tobytes(), "little")
                if o_size < 0:
                    raise ValueError("Alias codec: invalid size")
                return np.full(o_size, val, dtype=np.uint8)
            if 1 + n + 1 > count:
                raise ValueError("Alias codec: truncated map")
            idx2symb = np.zeros(16, dtype=np.uint8)
            idx2symb[:n] = src[1:1 + n]
            adjust = data[1 + n]
            if adjust >= 4:
                raise ValueError("Alias codec: invalid adjust")
            src_idx = 2 + n
            if n <= 4:
                body = src[src_idx + adjust:]
                out = np.empty(adjust + 4 * len(body), dtype=np.uint8)
                out[:adjust] = src[src_idx:src_idx + adjust]
                out[adjust + 0::4] = idx2symb[(body >> 6) & 3]
                out[adjust + 1::4] = idx2symb[(body >> 4) & 3]
                out[adjust + 2::4] = idx2symb[(body >> 2) & 3]
                out[adjust + 3::4] = idx2symb[body & 3]
                return out
            # 16 symbols or less
            head = bytearray()
            if adjust:
                head.append(data[src_idx])
                src_idx += 1
            body = src[src_idx:]
            out = np.empty(len(head) + 2 * len(body), dtype=np.uint8)
            out[:len(head)] = list(head)
            out[len(head) + 0::2] = idx2symb[(body >> 4) & 0xF]
            out[len(head) + 1::2] = idx2symb[body & 0xF]
            return out
        # digram mode
        if count < 2:
            raise ValueError("Alias codec: block too short")
        adjust = data[1]
        if adjust > 1:
            raise ValueError("Alias codec: invalid adjust")
        src_end = count - adjust
        src_idx = 2
        if src_idx + 3 * n > src_end:
            raise ValueError("Alias codec: truncated map")
        # map alias byte -> (first byte, second byte, len)
        m_lo = np.arange(256, dtype=np.int64)
        m_hi = np.zeros(256, dtype=np.int64)
        m_len = np.ones(256, dtype=np.int64)
        for _ in range(n):
            hi = data[src_idx]
            lo = data[src_idx + 1]
            alias = data[src_idx + 2]
            # map16 = 0x20000 | src[srcIdx] | (src[srcIdx+1] << 8):
            # dst[i] = val & 0xFF (first byte), dst[i+1] = val>>8 (second)
            m_lo[alias] = hi
            m_hi[alias] = lo
            m_len[alias] = 2
            src_idx += 3
        body = src[src_idx:src_end]
        lens = m_len[body]
        offs = np.cumsum(lens) - lens
        total = int(lens.sum())
        out = np.empty(total + adjust, dtype=np.uint8)
        out[offs] = m_lo[body]
        two = lens == 2
        out[offs[two] + 1] = m_hi[body[two]]
        if adjust:
            out[total] = data[count - 1]
        return out
