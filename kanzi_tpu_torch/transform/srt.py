"""Sorted-rank transform (src/transform/SRT.cpp).

Header: 256 LSB-first 7-bit varint frequencies, then the rank stream
grouped in per-symbol buckets ordered by (freq desc, symbol asc). The
rank update is MTF on distinct-symbol runs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from kanzi_tpu_torch.transform.base import ByteTransform, as_u8

MAX_HEADER_SIZE = 1024


def _sorted_symbols(freqs) -> list:
    """Symbols with freq>0 ordered by freq desc then symbol asc
    (shell sort in SRT::preprocess defines this total order)."""
    present = [i for i in range(256) if freqs[i] > 0]
    return sorted(present, key=lambda s: (-freqs[s], s))


class SRT(ByteTransform):
    def max_encoded_length(self, src_len: int) -> int:
        return src_len + MAX_HEADER_SIZE

    def forward(self, src: np.ndarray) -> Optional[np.ndarray]:
        src = as_u8(src)
        length = len(src)
        if length == 0:
            return src.copy()
        if self.capacity_for(length) < self.max_encoded_length(length):
            return None
        from kanzi_tpu_torch.utils import native
        if native.transforms_available():
            dst, freqs = native.srt_forward(src)
            header = self._encode_header([int(f) for f in freqs])
            return np.frombuffer(bytes(header) + dst.tobytes(),
                                 dtype=np.uint8)
        data = src.tolist()
        freqs = [0] * 256
        s2r = [0] * 256
        r2s = [0] * 256
        b = 0
        i = 0
        # first-appearance ranks + run-grouped frequency count
        while i < length:
            c = data[i]
            j = i + 1
            while j < length and data[j] == c:
                j += 1
            if freqs[c] == 0:
                r2s[b] = c
                s2r[c] = b
                b += 1
            freqs[c] += j - i
            i = j

        symbols = _sorted_symbols(freqs)
        buckets = [0] * 256
        pos = 0
        for c in symbols:
            buckets[c] = pos
            pos += freqs[c]

        header = self._encode_header(freqs)
        dst = bytearray(length)
        i = 0
        while i < length:
            c = data[i]
            r = s2r[c]
            p = buckets[c]
            dst[p] = r
            p += 1
            if r != 0:
                while r != 0:
                    t = r2s[r - 1]
                    r2s[r] = t
                    s2r[t] = r
                    r -= 1
                r2s[0] = c
                s2r[c] = 0
            i += 1
            while i < length and data[i] == c:
                dst[p] = 0
                p += 1
                i += 1
            buckets[c] = p
        return np.frombuffer(bytes(header) + bytes(dst), dtype=np.uint8)

    def inverse(self, src: np.ndarray) -> np.ndarray:
        src = as_u8(src)
        length = len(src)
        if length == 0:
            return src.copy()
        if length < 256:
            raise ValueError("SRT: block too short")
        # header is at most 256 5-byte varints: convert only that prefix
        # (a full-block tolist cost more than the native inverse itself)
        data = src[:min(length, 1280)].tolist()
        freqs, header_size = self._decode_header(data, len(data))
        length -= header_size
        from kanzi_tpu_torch.utils import native
        if native.transforms_available():
            return native.srt_inverse(src[header_size:],
                                      np.asarray(freqs, np.int64))
        data = src[header_size:].tolist()
        symbols = _sorted_symbols(freqs)
        nb_symbols = len(symbols)
        buckets = [0] * 256
        bucket_ends = [0] * 256
        r2s = [0] * 256
        pos = 0
        for c in symbols:
            if pos < 0 or pos >= length:
                raise ValueError("SRT: invalid bucket position")
            r2s[data[pos]] = c
            buckets[c] = pos + 1
            pos += freqs[c]
            bucket_ends[c] = pos
        c = r2s[0]
        out = bytearray(length)
        for i in range(length):
            out[i] = c
            if buckets[c] < bucket_ends[c]:
                r = data[buckets[c]]
                buckets[c] += 1
                if r == 0:
                    continue
                # move-to-front shift
                r2s[0:r] = r2s[1:r + 1]
                r2s[r] = c
                c = r2s[0]
            else:
                if nb_symbols == 1:
                    continue
                nb_symbols -= 1
                r2s[0:nb_symbols] = r2s[1:nb_symbols + 1]
                c = r2s[0]
        return np.frombuffer(bytes(out), dtype=np.uint8)

    @staticmethod
    def _encode_header(freqs) -> bytearray:
        dst = bytearray()
        for i in range(256):
            f = freqs[i]
            while f >= 128:
                dst.append(0x80 | (f & 0xFF) & 0xFF)
                f >>= 7
            dst.append(f)
        return dst

    @staticmethod
    def _decode_header(data, src_end):
        freqs = [0] * 256
        idx = 0
        for i in range(256):
            res = 0
            shift = 0
            for j in range(5):
                if idx >= src_end:
                    raise ValueError("SRT: truncated header")
                val = data[idx]
                idx += 1
                res |= (val & 0x7F) << shift
                if (val & 0x80) == 0:
                    break
                if j == 4:
                    raise ValueError("SRT: invalid header varint")
                shift += 7
            freqs[i] = res
        return freqs, idx
