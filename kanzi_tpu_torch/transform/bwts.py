"""Bijective Burrows-Wheeler transform (Scott) — no primary index.

Reference: src/transform/BWTS.cpp. Suffix array + Lyndon-word head
rotations (moveLyndonWordHead :154-179); inverse by LF-mapping cycle
decomposition (:228-265).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from kanzi_tpu_torch.transform.base import ByteTransform, as_u8
from kanzi_tpu_torch.transform.divsufsort import suffix_array

MAX_BLOCK_SIZE = 1024 * 1024 * 1024


class BWTS(ByteTransform):
    def max_encoded_length(self, src_len: int) -> int:
        return src_len

    def forward(self, src: np.ndarray) -> Optional[np.ndarray]:
        src = as_u8(src)
        count = len(src)
        if count > MAX_BLOCK_SIZE:
            raise ValueError("BWTS: block too large")
        if count < 2:
            return src.copy()
        from kanzi_tpu_torch.utils import native as _nat
        if _nat.sais_available():
            return _nat.bwts_forward(src)
        data = src.tolist()
        sa = suffix_array(src).tolist()
        isa = [0] * count
        for i, s in enumerate(sa):
            isa[s] = i

        mn = isa[0]
        idx_min = 0
        i = 1
        while i < count and mn > 0:
            if isa[i] >= mn:
                i += 1
                continue
            ref_rank = self._move_lyndon_word_head(sa, isa, data, count,
                                                   idx_min, i - idx_min, mn)
            for j in range(i - 1, idx_min, -1):
                # iterate through the new Lyndon word from end to start
                test_rank = isa[j]
                start_rank = test_rank
                while test_rank < count - 1:
                    next_rank_start = sa[test_rank + 1]
                    if (j > next_rank_start or data[j] != data[next_rank_start]
                            or ref_rank < isa[next_rank_start + 1]):
                        break
                    sa[test_rank] = next_rank_start
                    isa[next_rank_start] = test_rank
                    test_rank += 1
                sa[test_rank] = j
                isa[j] = test_rank
                ref_rank = test_rank
                if start_rank == test_rank:
                    break
            mn = isa[i]
            idx_min = i
            i += 1

        dst = bytearray(count)
        mn = count
        for i in range(count):
            if isa[i] >= mn:
                dst[isa[i]] = data[i - 1]
                continue
            if mn < count:
                dst[mn] = data[i - 1]
            mn = isa[i]
        dst[0] = data[count - 1]
        return np.frombuffer(bytes(dst), dtype=np.uint8)

    @staticmethod
    def _move_lyndon_word_head(sa, isa, data, count, start, size, rank):
        end = start + size
        while rank + 1 < count:
            next_start0 = sa[rank + 1]
            if next_start0 <= end:
                break
            next_start = next_start0
            k = 0
            while k < size and next_start < count and data[start + k] == data[next_start]:
                k += 1
                next_start += 1
            if k == size and rank < isa[next_start]:
                break
            if k < size and next_start < count and data[start + k] < data[next_start]:
                break
            sa[rank] = next_start0
            isa[next_start0] = rank
            rank += 1
        sa[rank] = start
        isa[start] = rank
        return rank

    def inverse(self, src: np.ndarray) -> np.ndarray:
        src = as_u8(src)
        count = len(src)
        if count > MAX_BLOCK_SIZE:
            raise ValueError("BWTS: block too large")
        if count < 2:
            return src.copy()
        from kanzi_tpu_torch.utils import native as _nat2
        if _nat2.sais_available():
            return _nat2.bwts_inverse(src)
        # LF mapping
        from kanzi_tpu_torch.utils import native as _nat
        if _nat.transforms_available():
            hist = _nat.hist_o0(src)
        else:
            hist = np.bincount(src, minlength=256).astype(np.int64)
        starts = np.cumsum(hist) - hist
        order = np.argsort(src, kind="stable")
        lf = np.empty(count, dtype=np.int64)
        lf[order] = np.arange(count)
        lf = lf.tolist()
        data = src.tolist()
        dst = bytearray(count)
        j = count - 1
        for i in range(count):
            if j < 0:
                break
            if lf[i] < 0:
                continue
            p = i
            while True:
                dst[j] = data[p]
                j -= 1
                t = lf[p]
                lf[p] = -1
                p = t
                if lf[p] < 0:
                    break
        return np.frombuffer(bytes(dst), dtype=np.uint8)
