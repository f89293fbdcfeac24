"""BCM-style context-mixing predictor (src/entropy/CMPredictor.{hpp,cpp}).

counter1[256][257]: bit-tree ctx x previous byte; counter2[512][17]: SSE on
quantized p with run mask. Rates 2/4/6, PSCALE 65536. bsVersion >= 7
changes counter2 init (we emit version-6 streams, matching kanzi 2.5.3).
"""

from __future__ import annotations

from kanzi_tpu_torch.entropy.binary import Predictor

FAST_RATE = 2
MEDIUM_RATE = 4
SLOW_RATE = 6
PSCALE = 65536


class CMPredictor(Predictor):
    def __init__(self, ctx=None):
        bs_version = 7 if ctx is None else ctx.get_int("bsVersion", 7)
        self.bs_version = bs_version
        self._c1 = 0
        self._c2 = 0
        self._ctx = 1
        self._run_mask = 0
        self._counter1 = [[32768] * 257 for _ in range(256)]
        base = [j << 12 for j in range(17)]
        if bs_version >= 7:
            base[16] = 65535
        self._counter2 = [list(base) for _ in range(512)]
        self._pc1 = self._counter1[1]
        self._pc2 = self._counter2[1]
        self._pc2_off = 8

    def get(self) -> int:
        pc1 = self._counter1[self._ctx]
        self._pc1 = pc1
        p = (13 * (pc1[256] + pc1[self._c1]) + 6 * pc1[self._c2]) >> 5
        self._pc2 = self._counter2[self._ctx | self._run_mask]
        self._pc2_off = p >> 12
        pc2 = self._pc2
        off = self._pc2_off
        return (p + p + 3 * (pc2[off] + pc2[off + 1]) + 64) >> 7

    def update(self, bit: int) -> None:
        pc1 = self._pc1
        pc2 = self._pc2
        off = self._pc2_off
        c1 = self._c1
        if bit == 0:
            pc1[256] -= pc1[256] >> FAST_RATE
            pc1[c1] -= pc1[c1] >> MEDIUM_RATE
            pc2[off] -= pc2[off] >> SLOW_RATE
            pc2[off + 1] -= pc2[off + 1] >> SLOW_RATE
            self._ctx += self._ctx
        else:
            pc1[256] -= (pc1[256] - PSCALE + 16) >> FAST_RATE
            pc1[c1] -= (pc1[c1] - PSCALE + 16) >> MEDIUM_RATE
            pc2[off] -= (pc2[off] - PSCALE + 16) >> SLOW_RATE
            pc2[off + 1] -= (pc2[off + 1] - PSCALE + 16) >> SLOW_RATE
            self._ctx += self._ctx + 1
        if self._ctx > 255:
            self._c2 = c1
            self._c1 = self._ctx & 0xFF
            self._ctx = 1
            self._run_mask = 0x100 if self._c1 == self._c2 else 0
