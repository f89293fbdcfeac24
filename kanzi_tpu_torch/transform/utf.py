"""UTF-8 codepoint aliasing codec.

Reference: src/transform/UTFCodec.cpp. Validates the block as UTF-8,
packs each 1-4 byte sequence into a 22-bit key, maps <= 32768 distinct
codepoints to 1-2 byte aliases sorted by decreasing frequency. Wire:
dst[0]=start dst[1]=tail-adjust, 2-byte map size n, n x 3-byte big-endian
keys, then aliases (rank < 128 -> 1 byte else 2).

Symbol segmentation is vectorized with the pointer-doubling chain walk
(same primitive as the Huffman decoder).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from kanzi_tpu_torch.core import stats
from kanzi_tpu_torch.transform.base import ByteTransform, as_u8
from kanzi_tpu_torch.utils.bitpack import chain_walk

MIN_BLOCK_SIZE = 1024

LEN_SEQ = np.zeros(256, dtype=np.int64)
LEN_SEQ[0x00:0x80] = 1
LEN_SEQ[0xC2:0xE0] = 2
LEN_SEQ[0xE0:0xF0] = 3
LEN_SEQ[0xF0:0xF5] = 4


def _pack_vec(b0, b1, b2, b3):
    """Vectorized UTFCodec::pack (UTFCodec.hpp:71-111). Returns (val, s)."""
    hi = b0 >> 4
    s = np.zeros(len(b0), dtype=np.int64)
    val = np.zeros(len(b0), dtype=np.int64)
    m1 = hi <= 7
    s[m1] = 1
    val[m1] = b0[m1]
    m2 = (hi == 12) | (hi == 13)
    s[m2] = 2
    val[m2] = (1 << 19) | (b0[m2] << 8) | b1[m2]
    m3 = hi == 14
    s[m3] = 3
    val[m3] = (2 << 19) | ((b0[m3] & 0x0F) << 12) | ((b1[m3] & 0x3F) << 6) | (b2[m3] & 0x3F)
    m4 = hi == 15
    s[m4] = 4
    val[m4] = ((4 << 19) | ((b0[m4] & 0x07) << 18) | ((b1[m4] & 0x3F) << 12)
               | ((b2[m4] & 0x3F) << 6) | (b3[m4] & 0x3F))
    return val, s


def _validate(block: np.ndarray) -> bool:
    """Partial UTF-8 validation (UTFCodec.cpp:303-422)."""
    count = len(block)
    if count <= 0:
        return False
    from kanzi_tpu_torch.utils import native
    if native.transforms_available():
        # same prev=0-seeded o1 histogram, one native pass, no temps
        freqs0, freqs1 = native.hist_o01(block)
    else:
        freqs0 = np.bincount(block, minlength=256).astype(np.int64)
        prev = np.concatenate([[0], block[:-1]]).astype(np.int64)
        idx = prev * 256 + block
        freqs1 = np.bincount(idx, minlength=65536).astype(
            np.int64).reshape(256, 256)
    s = int(freqs0[0xC0] + freqs0[0xC1] + freqs0[0xF5:0x100].sum())
    if s != 0:
        return False
    i = np.arange(256)
    out_cont = (i < 0x80) | (i > 0xBF)
    bad = 0
    bad += int(freqs1[0xE0][(i < 0xA0) | (i > 0xBF)].sum())
    bad += int(freqs1[0xED][(i < 0x80) | (i > 0x9F)].sum())
    bad += int(freqs1[0xF0][(i < 0x90) | (i > 0xBF)].sum())
    bad += int(freqs1[0xF4][(i < 0x80) | (i > 0x8F)].sum())
    for j in list(range(0xC2, 0xE0)) + list(range(0xE1, 0xED)) + [0xF1, 0xF2, 0xF3, 0xEE, 0xEF]:
        bad += int(freqs1[j][out_cont].sum())
    if bad != 0:
        return False
    sum2 = int(freqs0[0x80:0xC0].sum())
    return sum2 >= count // 8


class UTFCodec(ByteTransform):
    def max_encoded_length(self, src_len: int) -> int:
        return src_len + 8192

    def forward(self, src: np.ndarray) -> Optional[np.ndarray]:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        if count < MIN_BLOCK_SIZE:
            return None
        dt = self.ctx.get_int("dataType", stats.UNDEFINED)
        if dt not in (stats.UNDEFINED, stats.UTF8):
            return None
        must_validate = dt != stats.UTF8

        start = 0
        if count >= 3 and src[0] == 0xEF and src[1] == 0xBB and src[2] == 0xBF:
            start = 3
        else:
            while start < 4 and LEN_SEQ[src[start]] == 0:
                start += 1

        if must_validate and not _validate(src[start:count - 4]):
            return None
        self.ctx.put("dataType", stats.UTF8)

        # segment into symbols: chain walk over nxt[i] = i + len(src[i])
        s64 = src.astype(np.int64)
        b0 = s64
        b1 = np.concatenate([s64[1:], [0]])
        b2 = np.concatenate([s64[2:], [0, 0]])
        b3 = np.concatenate([s64[3:], [0, 0, 0]])
        vals_all, s_all = _pack_vec(b0, b1, b2, b3)
        nxt = np.arange(count, dtype=np.int64) + np.maximum(s_all, 1)
        limit = count - 4
        max_syms = max(limit - start, 1)
        pos_chain = chain_walk(nxt, start, max_syms)
        # cut at first position >= limit
        past = np.nonzero(pos_chain >= limit)[0]
        nsym = int(past[0]) if len(past) else max_syms
        pos = pos_chain[:nsym]
        if nsym == 0:
            return None
        vals = vals_all[pos]
        ss = s_all[pos]
        # validation of longer sequences
        if np.any(ss == 0):
            return None
        bad3 = (ss == 3) & ((b2[pos] & 0xC0) != 0x80)
        bad4 = (ss == 4) & ((((b2[pos] << 8) | b3[pos]) & 0xC0C0) != 0x8080)
        if np.any(bad3 | bad4):
            return None
        # distinct symbols in first-appearance order (map order irrelevant;
        # only counts + sort order matter)
        uniq, first_idx, counts = np.unique(vals, return_index=True,
                                            return_counts=True)
        n = len(uniq)
        if n >= 32768:
            # the reference fails once the 32768th NEW symbol appears
            return None
        max_target = count - (count // 10)
        if 3 * n + 6 >= max_target:
            return None

        # sort by freq desc then val desc
        order = np.lexsort((-uniq, -counts))
        sorted_vals = uniq[order]
        sorted_freqs = counts[order]
        ranks = np.arange(n, dtype=np.int64)
        est_per = np.where(ranks < 128, sorted_freqs, 2 * sorted_freqs)
        estimate = 4 + 6 + int(est_per.sum())
        if estimate >= max_target:
            return None

        dst = bytearray()
        dst.append(0)  # placeholder start
        dst.append(0)  # placeholder adjust
        dst.append((n >> 8) & 0xFF)
        dst.append(n & 0xFF)
        keys = sorted_vals.astype(np.uint32)
        key_bytes = np.empty((n, 3), dtype=np.uint8)
        key_bytes[:, 0] = (keys >> 16) & 0xFF
        key_bytes[:, 1] = (keys >> 8) & 0xFF
        key_bytes[:, 2] = keys & 0xFF
        dst += key_bytes.tobytes()
        dst += src[:start].tobytes()

        # alias stream
        alias_of = np.empty(1 << 22, dtype=np.int64)
        rank_map = np.where(ranks < 128, ranks,
                            0x10080 | ((ranks << 1) & 0xFF00) | (ranks & 0x7F))
        alias_of[sorted_vals] = rank_map
        aliases = alias_of[vals]
        nbytes = 1 + (aliases >> 16)
        offs = np.cumsum(nbytes) - nbytes
        total = int(nbytes.sum())
        out = np.empty(total, dtype=np.uint8)
        out[offs] = (aliases & 0xFF).astype(np.uint8)
        two = nbytes == 2
        out[offs[two] + 1] = ((aliases[two] >> 8) & 0xFF).astype(np.uint8)
        dst += out.tobytes()

        src_idx = int(pos[-1] + ss[-1])
        dst[0] = start
        dst[1] = (src_idx - limit) & 0xFF
        dst += src[src_idx:count].tobytes()
        if len(dst) >= max_target:
            return None
        return np.frombuffer(bytes(dst), dtype=np.uint8)

    def inverse(self, src: np.ndarray) -> np.ndarray:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        if count < 4:
            raise ValueError("UTF codec: block too short")
        start = int(src[0]) & 0x03
        adjust = int(src[1]) & 0x03
        n = (int(src[2]) << 8) | int(src[3])
        if n == 0 or n >= 32768 or 3 * n > count - 4:
            raise ValueError("UTF codec: invalid map size")
        keys = src[4:4 + 3 * n].reshape(n, 3).astype(np.int64)
        vals = (keys[:, 0] << 16) | (keys[:, 1] << 8) | keys[:, 2]
        # unpack each key to up to 4 bytes + length
        tag = vals >> 19
        sym = np.zeros((n, 4), dtype=np.uint8)
        slen = np.zeros(n, dtype=np.int64)
        m = tag == 0
        sym[m, 0] = vals[m] & 0xFF
        slen[m] = 1
        m = tag == 1
        sym[m, 0] = (vals[m] >> 8) & 0xFF
        sym[m, 1] = vals[m] & 0xFF
        slen[m] = 2
        m = tag == 2
        sym[m, 0] = ((vals[m] >> 12) & 0x0F) | 0xE0
        sym[m, 1] = ((vals[m] >> 6) & 0x3F) | 0x80
        sym[m, 2] = (vals[m] & 0x3F) | 0x80
        slen[m] = 3
        m = tag >= 4
        sym[m, 0] = ((vals[m] >> 18) & 0x07) | 0xF0
        sym[m, 1] = ((vals[m] >> 12) & 0x3F) | 0x80
        sym[m, 2] = ((vals[m] >> 6) & 0x3F) | 0x80
        sym[m, 3] = (vals[m] & 0x3F) | 0x80
        slen[m] = 4
        if np.any(slen == 0) or np.any(tag == 3):
            raise ValueError("UTF codec: invalid map entry")

        src_idx = 4 + 3 * n
        src_end = count - 4 + adjust
        out = bytearray(src[src_idx:src_idx + start].tobytes())
        src_idx += start
        # alias stream: 1 byte < 128, else 2 bytes (self-terminating)
        stream = src[src_idx:src_end].astype(np.int64)
        # resolve 2-byte aliases with a chain walk over positions
        isc = stream >= 128
        step = np.where(isc, 2, 1)
        nxt = np.arange(len(stream), dtype=np.int64) + step
        pos = chain_walk(nxt, 0, max(len(stream), 1))
        cut = np.nonzero(pos >= len(stream))[0]
        nsym = int(cut[0]) if len(cut) else len(stream)
        pos = pos[:nsym]
        if len(stream) and (nsym == 0 or int(pos[-1] + step[pos[-1]]) != len(stream)):
            raise ValueError("UTF codec: misaligned alias stream")
        a0 = stream[pos]
        two = a0 >= 128
        nxt_b = np.zeros(nsym, dtype=np.int64)
        nxt_b[two] = stream[np.minimum(pos[two] + 1, len(stream) - 1)]
        alias = np.where(two, (nxt_b << 7) + (a0 & 0x7F), a0)
        if np.any(alias >= n):
            raise ValueError("UTF codec: invalid alias")
        lens = slen[alias]
        offs2 = np.cumsum(lens) - lens
        total = int(lens.sum())
        res = np.empty(total, dtype=np.uint8)
        for k in range(4):
            mm = lens > k
            res[offs2[mm] + k] = sym[alias[mm], k]
        out += res.tobytes()
        out += src[src_end:count].tobytes()
        return np.frombuffer(bytes(out), dtype=np.uint8)
