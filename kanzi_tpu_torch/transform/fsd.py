"""FSD (fixed-step delta) codec for multimedia data.

Reference: src/transform/FSDCodec.cpp. Tries strides {1,2,3,4,8,16} on
three sampled sub-blocks, picks the min-entropy channel distance, then
emits mode byte DELTA (zigzag, 255-escape) or XOR + stride + residuals.
Gated by magic + dataType; validated by a post-transform entropy check.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from kanzi_tpu_torch.core import magic as magiclib
from kanzi_tpu_torch.core import stats
from kanzi_tpu_torch.transform.base import ByteTransform, as_u8

MIN_LENGTH = 1024
ESCAPE_TOKEN = 255
DELTA_CODING = 0
XOR_CODING = 1

# zigzag encode table: delta+127 -> byte (FSDCodec.cpp:32-66)
ZIGZAG1 = np.empty(256, dtype=np.uint8)
for _d in range(255):
    _v = _d - 127
    ZIGZAG1[_d] = (-_v * 2 - 1) if _v < 0 else (_v * 2)
ZIGZAG1[255] = 255
# zigzag decode: byte -> signed delta (FSDCodec.cpp:68-101)
ZIGZAG2 = np.empty(256, dtype=np.int16)
for _b in range(256):
    ZIGZAG2[_b] = (-(_b + 1) >> 1) if (_b & 1) else (_b >> 1)


class FSDCodec(ByteTransform):
    def max_encoded_length(self, src_len: int) -> int:
        return src_len + (64 if src_len < 1024 else src_len >> 4)

    def forward(self, src: np.ndarray) -> Optional[np.ndarray]:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        if count < MIN_LENGTH:
            return None
        dt = self.ctx.get_int("dataType", stats.UNDEFINED)
        if dt not in (stats.UNDEFINED, stats.MULTIMEDIA, stats.BIN):
            return None
        mg = magiclib.get_type(src[:4].tobytes())
        if mg not in (magiclib.BMP, magiclib.RIFF, magiclib.PBM, magiclib.PGM,
                      magiclib.PPM, magiclib.NO_MAGIC):
            return None

        count10 = count // 10
        count5 = 2 * count10
        dists = [0, 1, 2, 3, 4, 8, 16]
        s64 = None                       # built lazily (fallback only)
        from kanzi_tpu_torch.utils import native
        if native.transforms_available():
            h7 = native.fsd_scan(src)
            histo0 = h7[0]
            ent = [stats.first_order_entropy_1024(3 * count10, h7[k])
                   for k in range(7)]
        else:
            ent = []
            histo0 = None
            for k, d in enumerate(dists):
                h = np.zeros(256, dtype=np.int64)
                for blk in range(3):
                    base = count5 * (2 * blk)
                    seg = slice(base + count10, base + count5)
                    if d == 0:
                        vals = src[seg]
                    else:
                        vals = (src[seg]
                                ^ src[base + count10 - d:base + count5 - d])
                    h += np.bincount(vals, minlength=256)
                if k == 0:
                    histo0 = h
                ent.append(stats.first_order_entropy_1024(3 * count10, h))
        min_idx = int(np.argmin(ent))
        if ent[min_idx] >= ent[0]:
            self.ctx.put("dataType", stats.detect_simple_type(3 * count10, histo0))
            return None
        self.ctx.put("dataType", stats.MULTIMEDIA)
        dist = dists[min_idx]

        # int16 covers the +-255 delta range; only the sampled slice is
        # widened (a whole-block int64 copy dominated the stage cost)
        seg = src[2 * count5:3 * count5].astype(np.int16)
        ref = src[2 * count5 - dist:3 * count5 - dist].astype(np.int16)
        deltas = seg - ref
        large_deltas = int(np.count_nonzero((deltas < -127) | (deltas > 127)))
        mode = XOR_CODING if large_deltas > (count5 >> 5) else DELTA_CODING

        dst_end = self.max_encoded_length(count)
        header = bytes([mode, dist]) + src[:dist].tobytes()
        if mode == DELTA_CODING:
            from kanzi_tpu_torch.utils import native
            if native.transforms_available():
                out = native.fsd_forward_delta(src, dist,
                                               dst_end - len(header))
                if out is None:
                    # reference would stop mid-way, fail srcIdx != srcEnd
                    return None
                payload = out.tobytes()
            else:
                if s64 is None:
                    s64 = src.astype(np.int64)
                d_all = 127 + s64[dist:] - s64[:-dist]
                ok = (d_all >= 0) & (d_all < 255)
                lens = np.where(ok, 1, 2)
                total = int(lens.sum())
                # capacity guard (dstIdx < dstEnd - 1 per iteration)
                if len(header) + total > dst_end:
                    return None
                out = np.empty(total, dtype=np.uint8)
                offs = np.cumsum(lens) - lens
                out[offs[ok]] = ZIGZAG1[d_all[ok]]
                esc = ~ok
                out[offs[esc]] = ESCAPE_TOKEN
                out[offs[esc] + 1] = (src[dist:][esc] ^ src[:-dist][esc])
                payload = out.tobytes()
        else:
            payload = (src[dist:] ^ src[:-dist]).tobytes()
        dst = header + payload

        # extra sanity: entropy of two sampled output windows must beat ent[0]
        h = np.bincount(np.frombuffer(dst[count5 * 1:count5 * 1 + count10], dtype=np.uint8),
                        minlength=256).astype(np.int64)
        h += np.bincount(np.frombuffer(dst[count5 * 3:count5 * 3 + count10], dtype=np.uint8),
                         minlength=256)
        if stats.first_order_entropy_1024(count5, h) >= ent[0]:
            return None
        return np.frombuffer(dst, dtype=np.uint8)

    def inverse(self, src: np.ndarray) -> np.ndarray:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        if count < 4:
            raise ValueError("FSD: block too short")
        mode = int(src[0])
        dist = int(src[1])
        if dist < 1 or (dist > 4 and dist not in (8, 16)):
            raise ValueError("FSD: invalid distance")
        if count < dist + 2:
            raise ValueError("FSD: block too short for distance")
        if mode == DELTA_CODING:
            from kanzi_tpu_torch.utils import native
            if native.transforms_available():
                return native.fsd_inverse_delta(src, dist)
        out = bytearray(src[2:2 + dist].tobytes())
        data = src.tolist()
        if mode == DELTA_CODING:
            i = dist + 2
            while i < count:
                v = data[i]
                if v != ESCAPE_TOKEN:
                    out.append((out[-dist] + int(ZIGZAG2[v])) & 0xFF)
                    i += 1
                else:
                    i += 1
                    if i == count:
                        raise ValueError("FSD: truncated escape")
                    out.append(data[i] ^ out[-dist])
                    i += 1
        elif mode == XOR_CODING:
            # vectorizable per residue class; XOR prefix-scan per lane
            res = src[dist + 2:]
            n = len(res)
            out_arr = np.empty(dist + n, dtype=np.uint8)
            out_arr[:dist] = src[2:2 + dist]
            for lane in range(dist):
                lane_vals = res[lane::dist]
                seed = out_arr[lane]
                cum = np.bitwise_xor.accumulate(
                    np.concatenate([[seed], lane_vals]))
                out_arr[dist + lane::dist] = cum[1:]
            return out_arr
        else:
            raise ValueError("FSD: invalid mode")
        return np.frombuffer(bytes(out), dtype=np.uint8)
