"""Run-length transform (src/transform/RLT.cpp).

Runs > 3 are emitted as val + escape + two-tier run code (224 / +16-bit);
the escape byte is the least frequent symbol when a slow entropy backend
follows (findBestEscape), else 0xFB. Refuses DNA/BASE64/UTF8 data and
blocks < 16 bytes; requires compression gain (dstIdx < srcIdx).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from kanzi_tpu_torch.core import stats
from kanzi_tpu_torch.transform.base import ByteTransform, as_u8

RUN_LEN_ENCODE1 = 224
RUN_LEN_ENCODE2 = (255 - RUN_LEN_ENCODE1) << 8
RUN_THRESHOLD = 3
MAX_RUN = 0xFFFF + RUN_LEN_ENCODE2 + RUN_THRESHOLD - 1
MAX_RUN4 = MAX_RUN - 4
MIN_BLOCK_LENGTH = 16
DEFAULT_ESCAPE = 0xFB


class RLT(ByteTransform):
    def max_encoded_length(self, src_len: int) -> int:
        return src_len + 32 if src_len <= 512 else src_len

    def forward(self, src: np.ndarray) -> Optional[np.ndarray]:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        if count < MIN_BLOCK_LENGTH:
            return None
        if self.capacity_for(count) < self.max_encoded_length(count):
            return None

        dt = self.ctx.get_int("dataType", stats.UNDEFINED)
        if dt in (stats.DNA, stats.BASE64, stats.UTF8):
            return None
        find_best_escape = True
        ent = self.ctx.get_str("entropy", "").upper()
        if ent in ("NONE", "ANS0", "HUFFMAN", "RANGE"):
            find_best_escape = False

        escape = DEFAULT_ESCAPE
        if find_best_escape:
            from kanzi_tpu_torch.utils import native as _nat
            if _nat.transforms_available():
                freqs = _nat.hist_o0(src)
            else:
                freqs = np.bincount(src, minlength=256).astype(np.int64)
            if dt == stats.UNDEFINED:
                dt = stats.detect_simple_type(count, freqs)
                if dt != stats.UNDEFINED:
                    self.ctx.put("dataType", dt)
                if dt in (stats.DNA, stats.BASE64, stats.UTF8):
                    return None
            escape = int(np.argmin(freqs))  # first min (matches scan order)

        from kanzi_tpu_torch.utils import native
        if native.transforms_available():
            return native.rlt_forward(src, escape, self.capacity_for(count))
        data = src.tolist()
        dst = bytearray()
        dst_end = self.capacity_for(count)
        src_idx = 0
        src_end = count
        src_end4 = src_end - 4
        res = True
        run = 0
        prev = data[src_idx]
        src_idx += 1
        dst.append(escape)
        dst.append(prev)
        if prev == escape:
            dst.append(0)

        while True:
            if prev == data[src_idx]:
                # match up to 4 bytes at a time
                n = 0
                while n < 4 and src_idx + n < src_end and data[src_idx + n] == prev:
                    n += 1
                if n == 4:
                    src_idx += 4
                    run += 4
                    if run < MAX_RUN4 and src_idx < src_end4:
                        continue
                else:
                    src_idx += n
                    run += n
            if run > RUN_THRESHOLD:
                if len(dst) + 6 >= dst_end:
                    res = False
                    break
                self._emit_run_length(dst, run, escape, prev)
            elif prev != escape:
                if len(dst) + run >= dst_end:
                    res = False
                    break
                dst += bytes([prev]) * run
            else:
                if len(dst) + 2 * run >= dst_end:
                    res = False
                    break
                dst += bytes([escape, 0]) * run
            prev = data[src_idx]
            src_idx += 1
            run = 1
            if src_idx >= src_end4:
                break

        if res:
            # run == 1 tail
            if prev != escape:
                if len(dst) + run < dst_end:
                    dst += bytes([prev]) * run
            else:
                if len(dst) + 2 * run < dst_end:
                    dst += bytes([escape, 0]) * run
            while src_idx < src_end and len(dst) < dst_end:
                if data[src_idx] == escape:
                    if len(dst) + 2 >= dst_end:
                        res = False
                        break
                    dst += bytes([escape, 0])
                    src_idx += 1
                    continue
                dst.append(data[src_idx])
                src_idx += 1
            res = res and (src_idx == src_end)

        if not (res and len(dst) < src_idx):
            return None
        return np.frombuffer(bytes(dst), dtype=np.uint8)

    @staticmethod
    def _emit_run_length(dst: bytearray, run: int, escape: int, val: int) -> None:
        dst.append(val)
        if val == escape:
            dst.append(0)
        dst.append(escape)
        run -= RUN_THRESHOLD
        if run >= RUN_LEN_ENCODE1:
            if run < RUN_LEN_ENCODE2:
                run -= RUN_LEN_ENCODE1
                dst.append(RUN_LEN_ENCODE1 + (run >> 8))
            else:
                run -= RUN_LEN_ENCODE2
                dst.append(0xFF)
                dst.append((run >> 8) & 0xFF)
        dst.append(run & 0xFF)

    def inverse(self, src: np.ndarray) -> np.ndarray:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        from kanzi_tpu_torch.utils import native
        if native.transforms_available():
            cap = max(self.ctx.get_int("_decodeCapacity", 0),
                      self.ctx.get_int("blockSize", 0), 4 * count, 1024)
            while cap <= (1 << 30):       # reference MAX_BLOCK_SIZE cap
                out = native.rlt_inverse(src, cap)
                if out is not None:
                    return out
                cap *= 2                  # capacity guess too small
            raise ValueError("RLT: invalid run")
        data = bytes(src.tobytes())
        out = bytearray()
        src_idx = 0
        escape = data[src_idx]
        src_idx += 1
        if src_idx < count and data[src_idx] == escape:
            src_idx += 1
            if src_idx < count and data[src_idx] != 0:
                raise ValueError("RLT: invalid escaped start")
            out.append(escape)
            src_idx += 1
        while src_idx < count:
            esc_pos = data.find(bytes([escape]), src_idx)
            literal_len = (count - src_idx) if esc_pos < 0 else esc_pos - src_idx
            if literal_len > 0:
                out += data[src_idx:src_idx + literal_len]
                src_idx += literal_len
            if src_idx >= count:
                break
            src_idx += 1  # skip escape
            if src_idx >= count:
                raise ValueError("RLT: truncated run")
            run = data[src_idx]
            src_idx += 1
            if run == 0:
                out.append(escape)
                continue
            if run == 0xFF:
                if src_idx + 1 >= count:
                    raise ValueError("RLT: truncated long run")
                run = (data[src_idx] << 8) | data[src_idx + 1]
                src_idx += 2
                run += RUN_LEN_ENCODE2
            elif run >= RUN_LEN_ENCODE1:
                if src_idx >= count:
                    raise ValueError("RLT: truncated medium run")
                run = ((run - RUN_LEN_ENCODE1) << 8) | data[src_idx]
                src_idx += 1
                run += RUN_LEN_ENCODE1
            run += RUN_THRESHOLD - 1
            if run > MAX_RUN or len(out) == 0:
                raise ValueError("RLT: invalid run")
            out += bytes([out[-1]]) * run
        return np.frombuffer(bytes(out), dtype=np.uint8)
