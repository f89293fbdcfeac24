"""Linear & logistic adaptive probability maps (src/entropy/AdaptiveProbMap.hpp)."""

from __future__ import annotations

import numpy as np

from kanzi_tpu_torch.core.stats import SQUASH, STRETCH, squash_val


class LinearAdaptiveProbMap:
    def __init__(self, n: int, rate: int):
        self.rate = rate
        size = 65 if n == 0 else n * 65
        base = np.array([j << 10 for j in range(65)], dtype=np.int64)
        base[64] = 65528
        self.data = np.tile(base, max(n, 1)).astype(np.int64)
        if size > len(self.data):
            self.data = np.resize(self.data, size)
        self.index = 0

    def get(self, bit: int, pr: int, ctx: int) -> int:
        d = self.data
        g = (-bit) & 65528
        i = self.index
        d[i] += ((g - int(d[i])) >> self.rate) + bit
        d[i + 1] += ((g - int(d[i + 1])) >> self.rate) + bit
        self.index = (pr >> 6) + 65 * ctx
        i = self.index
        w = pr & 127
        return ((int(d[i]) << 7) + (int(d[i + 1]) - int(d[i])) * w) >> 11


class LogisticAdaptiveProbMap:
    def __init__(self, n: int, rate: int, fast: bool = False):
        self.rate = rate
        self.fast = fast
        mult = 32 if fast else 33
        self.mult = mult
        base = np.array([squash_val((j - 16) * 128) << 4 for j in range(mult)],
                        dtype=np.int64)
        self.data = np.tile(base, max(n, 1))
        self.index = 0

    def get(self, bit: int, pr: int, ctx: int) -> int:
        d = self.data
        g = (-bit) & 65528
        i = self.index
        d[i] += ((g - int(d[i])) >> self.rate) + bit
        if not self.fast:
            d[i + 1] += ((g - int(d[i + 1])) >> self.rate) + bit
            pr = int(STRETCH[pr])
            self.index = ((pr + 2048) >> 7) + 33 * ctx
            i = self.index
            w = pr & 127
            return ((int(d[i]) << 7) + (int(d[i + 1]) - int(d[i])) * w) >> 11
        self.index = ((int(STRETCH[pr]) + 2048) >> 7) + 32 * ctx
        return int(d[self.index]) >> 4
