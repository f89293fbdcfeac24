"""Sort-by-rank transform: unified MTF / RANK / TIMESTAMP.

Reference: src/transform/SBRT.cpp:22-145. q = ((i & m1) + (p[c] & m2)) >>
shift with (m1, m2, shift) selecting MTF (alpha=0), RANK (alpha=1/2) or
TIMESTAMP (alpha=1). A sequential symbol-rank state machine; the card's
path (kanzi_tpu_torch/ops/sbrt.py) batches independent blocks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from kanzi_tpu_torch.transform.base import ByteTransform, as_u8

MODE_MTF = 1
MODE_RANK = 2
MODE_TIMESTAMP = 3


class SBRT(ByteTransform):
    def __init__(self, ctx=None, mode: int = MODE_MTF):
        super().__init__(ctx)
        if mode not in (MODE_MTF, MODE_RANK, MODE_TIMESTAMP):
            raise ValueError("Invalid mode parameter")
        self.mode = mode
        self.mask1 = 0 if mode == MODE_TIMESTAMP else -1
        self.mask2 = 0 if mode == MODE_MTF else -1
        self.shift = 1 if mode == MODE_RANK else 0

    def max_encoded_length(self, src_len: int) -> int:
        return src_len

    def forward(self, src: np.ndarray) -> Optional[np.ndarray]:
        src = as_u8(src)
        n = len(src)
        from kanzi_tpu_torch.utils import native
        if n and native.transforms_available():
            return native.sbrt(src, self.mode, inverse=False)
        out = np.empty(n, dtype=np.uint8)
        p = [0] * 256
        q = [0] * 256
        s2r = list(range(256))
        r2s = list(range(256))
        m1, m2, sh = self.mask1, self.mask2, self.shift
        data = src.tolist()
        res = out  # fill via list for speed then copy
        ol = [0] * n
        for i in range(n):
            c = data[i]
            r = s2r[c]
            ol[i] = r
            qc = ((i & m1) + (p[c] & m2)) >> sh
            p[c] = i
            q[c] = qc
            while r > 0 and q[r2s[r - 1]] <= qc:
                r2s[r] = r2s[r - 1]
                s2r[r2s[r]] = r
                r -= 1
            r2s[r] = c
            s2r[c] = r
        out[:] = ol
        return out

    def inverse(self, src: np.ndarray) -> np.ndarray:
        src = as_u8(src)
        n = len(src)
        from kanzi_tpu_torch.utils import native
        if n and native.transforms_available():
            return native.sbrt(src, self.mode, inverse=True)
        out = np.empty(n, dtype=np.uint8)
        p = [0] * 256
        q = [0] * 256
        r2s = list(range(256))
        m1, m2, sh = self.mask1, self.mask2, self.shift
        data = src.tolist()
        ol = [0] * n
        for i in range(n):
            r = data[i]
            c = r2s[r]
            ol[i] = c
            qc = ((i & m1) + (p[c] & m2)) >> sh
            p[c] = i
            q[c] = qc
            while r > 0 and q[r2s[r - 1]] <= qc:
                r2s[r] = r2s[r - 1]
                r -= 1
            r2s[r] = c
        out[:] = ol
        return out
