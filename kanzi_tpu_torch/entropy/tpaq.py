"""TPAQ / TPAQX context-mixing predictor.

Reference: src/entropy/TPAQPredictor.{hpp,cpp} (Tangelo/PAQ lineage).
- 7 (TPAQ) / 8 (TPAQX) contexts: order 1/2/3/4, sparse, text-vs-binary
  switched hashes (update :415-541)
- 256-state bit-history FSM (STATE_TRANSITIONS) -> STATE_MAP logits
- per-context-bucket 8-input integer NN mixers with decaying learn rate;
  mixer selected by (c4 & mixersMask) + matchBit (:434)
- LZ-ish match model over ring buffer + hash table (findMatch :543-574)
- 1-2 stage logistic APM/SSE (:509-537)
- table sizes scale with blockSize/size (:301-342) — identical sizing is
  REQUIRED for identical output.

The FSM transition tables and logit map are format constants (pure data,
required bit-for-bit). Host golden implementation; device batching lives
in kanzi_tpu/ops.
"""

from __future__ import annotations

import numpy as np

from kanzi_tpu_torch.core.stats import SQUASH
from kanzi_tpu_torch.entropy.apm import LogisticAdaptiveProbMap
from kanzi_tpu_torch.entropy.binary import Predictor

MAX_LENGTH = 88
BUFFER_SIZE = 64 * 1024 * 1024
HASH_SIZE = 16 * 1024 * 1024
HASH = 0x7FEB352D
MASK_80808080 = 0x80808080
MASK_F0F0F000 = 0xF0F0F000
MASK_4F4FFFFF = 0x4F4FFFFF
BEGIN_LEARN_RATE = 60 << 7
END_LEARN_RATE = 11 << 7
M32 = 0xFFFFFFFF

# bit-history finite state machine (format constants)
STATE_TRANSITIONS = (
    (1, 3, 143, 4, 5, 6, 7, 8, 9, 10,
     11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
     21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
     31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
     41, 42, 43, 44, 45, 46, 47, 48, 49, 50,
     51, 52, 47, 54, 55, 56, 57, 58, 59, 60,
     61, 62, 63, 64, 65, 66, 67, 68, 69, 6,
     71, 71, 71, 61, 75, 56, 77, 78, 77, 80,
     81, 82, 83, 84, 85, 86, 87, 88, 77, 90,
     91, 92, 80, 94, 95, 96, 97, 98, 99, 90,
     101, 94, 103, 101, 102, 104, 107, 104, 105, 108,
     111, 112, 113, 114, 115, 116, 92, 118, 94, 103,
     119, 122, 123, 94, 113, 126, 113, 128, 129, 114,
     131, 132, 112, 134, 111, 134, 110, 134, 134, 128,
     128, 142, 143, 115, 113, 142, 128, 148, 149, 79,
     148, 142, 148, 150, 155, 149, 157, 149, 159, 149,
     131, 101, 98, 115, 114, 91, 79, 58, 1, 170,
     129, 128, 110, 174, 128, 176, 129, 174, 179, 174,
     176, 141, 157, 179, 185, 157, 187, 188, 168, 151,
     191, 192, 188, 187, 172, 175, 170, 152, 185, 170,
     176, 170, 203, 148, 185, 203, 185, 192, 209, 188,
     211, 192, 213, 214, 188, 216, 168, 84, 54, 54,
     221, 54, 55, 85, 69, 63, 56, 86, 58, 230,
     231, 57, 229, 56, 224, 54, 54, 66, 58, 54,
     61, 57, 222, 78, 85, 82, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0),
    (2, 163, 169, 163, 165, 89, 245, 217, 245, 245,
     233, 244, 227, 74, 221, 221, 218, 226, 243, 218,
     238, 242, 74, 238, 241, 240, 239, 224, 225, 221,
     232, 72, 224, 228, 223, 225, 238, 73, 167, 76,
     237, 234, 231, 72, 31, 63, 225, 237, 236, 235,
     53, 234, 53, 234, 229, 219, 229, 233, 232, 228,
     226, 72, 74, 222, 75, 220, 167, 57, 218, 70,
     168, 72, 73, 74, 217, 76, 167, 79, 79, 166,
     162, 162, 162, 162, 165, 89, 89, 165, 89, 162,
     93, 93, 93, 161, 100, 93, 93, 93, 93, 93,
     161, 102, 120, 104, 105, 106, 108, 106, 109, 110,
     160, 134, 108, 108, 126, 117, 117, 121, 119, 120,
     107, 124, 117, 117, 125, 127, 124, 139, 130, 124,
     133, 109, 110, 135, 110, 136, 137, 138, 127, 140,
     141, 145, 144, 124, 125, 146, 147, 151, 125, 150,
     127, 152, 153, 154, 156, 139, 158, 139, 156, 139,
     130, 117, 163, 164, 141, 163, 147, 2, 2, 199,
     171, 172, 173, 177, 175, 171, 171, 178, 180, 172,
     181, 182, 183, 184, 186, 178, 189, 181, 181, 190,
     193, 182, 182, 194, 195, 196, 197, 198, 169, 200,
     201, 202, 204, 180, 205, 206, 207, 208, 210, 194,
     212, 184, 215, 193, 184, 208, 193, 163, 219, 168,
     94, 217, 223, 224, 225, 76, 227, 217, 229, 219,
     79, 86, 165, 217, 214, 225, 216, 216, 234, 75,
     214, 237, 74, 74, 163, 217, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0))

STATE_MAP = (
    -31, -400, 406, -547, -642, -743, -827, -901,
    -901, -974, -945, -955, -1060, -1031, -1044, -956,
    -994, -1035, -1147, -1069, -1111, -1145, -1096, -1084,
    -1171, -1199, -1062, -1498, -1199, -1199, -1328, -1405,
    -1275, -1248, -1167, -1448, -1441, -1199, -1357, -1160,
    -1437, -1428, -1238, -1343, -1526, -1331, -1443, -2047,
    -2047, -2044, -2047, -2047, -2047, -232, -414, -573,
    -517, -768, -627, -666, -644, -740, -721, -829,
    -770, -963, -863, -1099, -811, -830, -277, -1036,
    -286, -218, -42, -411, 141, -1014, -1028, -226,
    -469, -540, -573, -581, -594, -610, -628, -711,
    -670, -144, -408, -485, -464, -173, -221, -310,
    -335, -375, -324, -413, -99, -179, -105, -150,
    -63, -9, 56, 83, 119, 144, 198, 118,
    -42, -96, -188, -285, -376, 107, -138, 38,
    -82, 186, -114, -190, 200, 327, 65, 406,
    108, -95, 308, 171, -18, 343, 135, 398,
    415, 464, 514, 494, 508, 519, 92, -123,
    343, 575, 585, 516, -7, -156, 209, 574,
    613, 621, 670, 107, 989, 210, 961, 246,
    254, -12, -108, 97, 281, -143, 41, 173,
    -209, 583, -55, 250, 354, 558, 43, 274,
    14, 488, 545, 84, 528, 519, 587, 634,
    663, 95, 700, 94, -184, 730, 742, 162,
    -10, 708, 692, 773, 707, 855, 811, 703,
    790, 871, 806, 9, 867, 840, 990, 1023,
    1409, 194, 1397, 183, 1462, 178, -23, 1403,
    247, 172, 1, -32, -170, 72, -508, -46,
    -365, -26, -146, 101, -18, -163, -422, -461,
    -146, -69, -78, -319, -334, -232, -99, 0,
    47, -74, 0, -452, 14, -57, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1)

MATCH_PRED = (
    0, 64, 128, 192, 256, 320, 384, 448,
    512, 576, 640, 704, 768, 832, 896, 960,
    1024, 1038, 1053, 1067, 1082, 1096, 1111, 1125,
    1139, 1154, 1168, 1183, 1197, 1211, 1226, 1240,
    1255, 1269, 1284, 1298, 1312, 1327, 1341, 1356,
    1370, 1385, 1399, 1413, 1428, 1442, 1457, 1471,
    1486, 1500, 1514, 1529, 1543, 1558, 1572, 1586,
    1601, 1615, 1630, 1644, 1659, 1673, 1687, 1702,
    1716, 1731, 1745, 1760, 1774, 1788, 1803, 1817,
    1832, 1846, 1861, 1875, 1889, 1904, 1918, 1933,
    1947, 1961, 1976, 1990, 2005, 2019, 2034, 2047)


def _i32(x):
    x &= M32
    return x - (1 << 32) if x >= (1 << 31) else x


class _Mixer:
    __slots__ = ("w", "p", "pr", "skew", "learn_rate")

    def __init__(self):
        self.w = [32768] * 8
        self.p = [0] * 8
        self.pr = 2048
        self.skew = 0
        self.learn_rate = BEGIN_LEARN_RATE

    def update(self, bit):
        err = (((bit << 12) - self.pr) * self.learn_rate) >> 10
        if err == 0:
            return
        if self.learn_rate > END_LEARN_RATE:
            self.learn_rate -= 1
        self.skew += err
        w = self.w
        p = self.p
        for i in range(8):
            w[i] += (p[i] * err) >> 12

    def get(self, ps):
        self.p = ps
        w = self.w
        s = (ps[0] * w[0] + ps[1] * w[1] + ps[2] * w[2] + ps[3] * w[3] +
             ps[4] * w[4] + ps[5] * w[5] + ps[6] * w[6] + ps[7] * w[7] +
             self.skew + 65536) >> 17
        if s >= 2048:
            self.pr = 4095
        elif s <= -2048:
            self.pr = 0
        else:
            self.pr = int(SQUASH[s + 2047])
        return self.pr


def compute_sizes(ctx=None, extra: bool = False):
    """Table sizing schedule (TPAQPredictor.cpp:296-342). Identical sizing
    is REQUIRED for identical output; shared by the Python golden model and
    the native coder (native/bincoder.cpp). Returns
    (states_size, mixers_size, hash_size, buffer_size)."""
    states_size = 1 << 28
    mixers_size = 1 << 12
    hash_size = HASH_SIZE
    extra_mem = 1 if extra else 0
    buffer_size = BUFFER_SIZE
    bs_version = 7
    if ctx is not None:
        rbsz = ctx.get_int("blockSize", 32768)
        if rbsz >= 64 * 1024 * 1024:
            states_size = 1 << 28
        elif rbsz >= 16 * 1024 * 1024:
            states_size = 1 << 27
        elif rbsz >= 4 * 1024 * 1024:
            states_size = 1 << 26
        else:
            states_size = (1 << 24) if rbsz >= 1024 * 1024 else (1 << 22)
        absz = ctx.get_int("size", rbsz)
        if absz >= 32 * 1024 * 1024:
            mixers_size = 1 << 16
        elif absz >= 16 * 1024 * 1024:
            mixers_size = 1 << 15
        elif absz >= 8 * 1024 * 1024:
            mixers_size = 1 << 14
        elif absz >= 4 * 1024 * 1024:
            mixers_size = 1 << 13
        else:
            mixers_size = (1 << 11) if absz >= 1024 * 1024 else (1 << 8)
        buffer_size = min(rbsz, BUFFER_SIZE)
        mxsz = absz * 16 if absz < (1 << 26) else (1 << 30)
        hash_size = min(hash_size, mxsz)
        bs_version = ctx.get_int("bsVersion", bs_version)
    if bs_version > 6:
        buffer_size = 1 << (max(buffer_size, 1).bit_length() - 1)
        hash_size = 1 << (max(hash_size, 1).bit_length() - 1)
    mixers_size <<= 2 * extra_mem
    states_size <<= 2 * extra_mem
    hash_size <<= 2 * extra_mem
    if bs_version > 5 and hash_size > 1024 * 1024 * 1024:
        hash_size = 1024 * 1024 * 1024
    return states_size, mixers_size, hash_size, buffer_size


class TPAQPredictor(Predictor):
    def __init__(self, ctx=None, extra: bool = False):
        self.extra = extra
        sse0_rate = 6 if extra else 7
        self._sse0 = LogisticAdaptiveProbMap(256, sse0_rate)
        self._sse1 = LogisticAdaptiveProbMap(65536 if extra else 256, 7)
        states_size, mixers_size, hash_size, buffer_size = compute_sizes(
            ctx, extra)

        self._states_mask = states_size - 1
        self._mixers_mask = (mixers_size - 1) & ~1
        self._hash_mask = hash_size - 1
        self._buffer_mask = buffer_size - 1
        self._mixers = [_Mixer() for _ in range(mixers_size)]
        self._big = np.zeros(states_size, dtype=np.uint8)
        self._small0 = np.zeros(1 << 16, dtype=np.uint8)
        self._small1 = np.zeros(1 << 24, dtype=np.uint8)
        self._hashes = np.zeros(hash_size, dtype=np.int64)
        self._buffer = np.zeros(buffer_size, dtype=np.int64)
        # context pointers as (array, index) pairs
        self._cp = [(self._small0, 0), (self._small1, 0), (self._big, 0),
                    (self._big, 0), (self._big, 0), (self._big, 0),
                    (self._big, 0)]
        self._pr = 2048
        self._c0 = 1
        self._c4 = 0
        self._c8 = 0
        self._pos = 0
        self._bpos = 8
        self._bin_count = 0
        self._match_len = 0
        self._match_pos = 0
        self._match_val = 0
        self._hash = 0
        self._mixer = self._mixers[0]
        self._ctx = [0] * 7

    def get(self) -> int:
        return self._pr

    def update(self, bit: int) -> None:
        self._mixer.update(bit)
        self._c0 += self._c0 + bit
        self._bpos -= 1
        ctx = self._ctx

        if self._bpos == 0:
            self._buffer[self._pos & self._buffer_mask] = self._c0 & 0xFF
            self._pos += 1
            self._c8 = ((self._c8 << 8) | ((self._c4 >> 24) & 0xFF)) & M32
            self._c4 = ((self._c4 << 8) | (self._c0 & 0xFF)) & M32
            self._hash = (((self._hash * HASH) << 4) + self._c4) & self._hash_mask
            self._c0 = 1
            self._bpos = 8
            self._bin_count += (self._c4 >> 7) & 1

            self._mixer = self._mixers[(self._c4 & self._mixers_mask)
                                       + (1 if self._match_len != 0 else 0)]
            ctx[0] = (self._c4 & 0xFF) << 8
            ctx[1] = (self._c4 & 0xFFFF) << 8
            ctx[2] = _create_context(2, self._c4 & 0x00FFFFFF)
            ctx[3] = _create_context(3, self._c4)
            if self._bin_count < (self._pos >> 2):
                # mostly text or mixed
                ctx[4] = _create_context(ctx[1] & M32,
                                         self._c4 ^ (self._c8 & 0xFFFF))
                ctx[5] = (self._c8 & MASK_F0F0F000) | ((self._c4 & MASK_F0F0F000) >> 4)
                if self.extra:
                    h1 = self._c4 & (MASK_4F4FFFFF if (self._c4 & MASK_80808080) == 0
                                     else MASK_80808080)
                    h2 = self._c8 & (MASK_4F4FFFFF if (self._c8 & MASK_80808080) == 0
                                     else MASK_80808080)
                    ctx[6] = _hash(h1 << 2, h2 >> 2)
            else:
                # mostly binary
                ctx[4] = _create_context((HASH + self._match_len) & M32,
                                         self._c4 ^ (self._c4 & 0x000FFFFF))
                ctx[5] = ctx[0] | ((self._c8 << 16) & M32)
                if self.extra:
                    ctx[6] = _hash(self._c4 & 0xFFFF0000, self._c8 >> 16)

            self._find_match()
            self._match_val = int(self._buffer[self._match_pos & self._buffer_mask]) | 0x100
            self._hashes[self._hash] = self._pos

        c0 = self._c0
        sm = self._states_mask
        idx2 = ((ctx[2] & M32) + c0) & sm
        idx3 = ((ctx[3] & M32) + c0) & sm
        idx4 = ((ctx[4] & M32) + c0) & sm
        idx5 = ((ctx[5] & M32) ^ c0) & sm

        table = STATE_TRANSITIONS[bit]
        cp = self._cp
        for k in range(6):
            arr, i = cp[k]
            arr[i] = table[arr[i]]
        # NOTE: cp6's transition happens later (extra branch), matching the
        # reference's exact read/write order on the shared big states map

        cp[0] = (self._small0, (ctx[0] + c0) & 0xFFFF)
        cp[1] = (self._small1, (ctx[1] + c0) & 0xFFFFFF)
        cp[2] = (self._big, idx2)
        cp[3] = (self._big, idx3)
        cp[4] = (self._big, idx4)
        cp[5] = (self._big, idx5)
        p0 = STATE_MAP[self._small0[cp[0][1]]]
        p1 = STATE_MAP[self._small1[cp[1][1]]]
        p2 = STATE_MAP[self._big[idx2]]
        p3 = STATE_MAP[self._big[idx3]]
        p4 = STATE_MAP[self._big[idx4]]
        p5 = STATE_MAP[self._big[idx5]]

        p7 = 0 if self._match_len == 0 else self._match_context_pred()

        if not self.extra:
            p = self._mixer.get([p0, p1, p2, p3, p4, p5, p7, p7])
            if self._bin_count < (self._pos >> 3):
                p = (3 * self._sse0.get(bit, p, c0) + p) >> 2
        else:
            idx6 = ((ctx[6] & M32) + c0) & sm
            arr, i = cp[6]
            arr[i] = table[arr[i]]
            cp[6] = (self._big, idx6)
            p6 = STATE_MAP[self._big[idx6]]
            p = self._mixer.get([p0, p1, p2, p3, p4, p5, p6, p7])
            if self._bin_count < (self._pos >> 3):
                p = self._sse1.get(bit, p, ctx[0] + c0)
            else:
                if self._bin_count >= (self._pos >> 2):
                    p = (3 * self._sse0.get(bit, p, c0) + p) >> 2
                p = (3 * self._sse1.get(bit, p, ctx[0] + c0) + p) >> 2

        self._pr = p + (1 if p < 2048 else 0)

    def _find_match(self) -> None:
        if self._match_len > 0:
            if self._match_len < MAX_LENGTH:
                self._match_len += 1
            self._match_pos += 1
            return
        self._match_pos = int(self._hashes[self._hash])
        if self._match_pos != 0 and ((self._pos - self._match_pos) & M32) <= self._buffer_mask:
            r = self._match_len + 2
            buf = self._buffer
            bm = self._buffer_mask
            pos = self._pos
            mpos = self._match_pos
            while r <= MAX_LENGTH:
                if buf[(pos - r - 1) & bm] != buf[(mpos - r - 1) & bm]:
                    break
                if buf[(pos - r) & bm] != buf[(mpos - r) & bm]:
                    break
                r += 2
            self._match_len = r - 2

    def _match_context_pred(self) -> int:
        match_prefix = self._match_val >> self._bpos
        if self._c0 == match_prefix:
            if (self._match_val >> (self._bpos - 1)) & 1:
                return MATCH_PRED[self._match_len - 1]
            return -MATCH_PRED[self._match_len - 1]
        self._match_len = 0
        return 0


def _hash(x: int, y: int) -> int:
    x &= M32  # C callers pass uint32-wrapped expressions (e.g. h1 << 2)
    y &= M32
    h = ((x * HASH) ^ (y * HASH)) & M32
    if h >= (1 << 31):
        h -= (1 << 32)  # reference declares h as signed int: >> is arithmetic
    return ((h >> 1) ^ (h >> 9) ^ (x >> 2) ^ (y >> 3) ^ HASH) & M32


def _create_context(ctx_id: int, cx: int) -> int:
    cx = (cx * 987654323 + ctx_id) & M32
    cx = ((cx << 16) | (cx >> 16)) & M32
    return (cx * 123456791 + ctx_id) & M32
