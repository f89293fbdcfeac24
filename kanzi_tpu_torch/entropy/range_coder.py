"""Classic 64-bit static range coder, 32 KiB chunks.

Reference: src/entropy/Range{Encoder,Decoder}.cpp. TOP=2^60-style bounds,
28-bit digit flushes, per-chunk normalized frequency tables sharing the
ANS header layout (alphabet + logRange + grouped log-packed freqs-1,
but with logRange written AFTER the alphabet, RangeEncoder.cpp:85-125).
Not part of any compression level; provided for full -e RANGE parity.
"""

from __future__ import annotations

import numpy as np

from kanzi_tpu_torch.bitstream import BitReader, BitWriter
from kanzi_tpu_torch.entropy import utils as eu
from kanzi_tpu_torch.entropy.base import EntropyDecoder, EntropyEncoder

TOP_RANGE = 0x0FFFFFFFFFFFFFFF
BOTTOM_RANGE = 0x000000000000FFFF
RANGE_MASK = 0x0FFFFFFF00000000
DEFAULT_CHUNK_SIZE = 1 << 15
DEFAULT_LOG_RANGE = 12
MAX_CHUNK_SIZE = 1 << 30
M64 = (1 << 64) - 1


def _write_freq_header(obs, alphabet, freqs, lr):
    """logRange + grouped freqs (RangeEncoder::encodeHeader :82-125)."""
    count = len(alphabet)
    eu.encode_alphabet(obs, alphabet)
    if count == 0:
        return
    obs.write_bits(lr - 8, 3)
    if count == 1:
        return
    chk = 8 if count >= 64 else 6
    llr = 3
    while (1 << llr) <= lr:
        llr += 1
    i = 1
    while i < count:
        endj = min(i + chk, count)
        mx = max(int(freqs[alphabet[j]]) - 1 for j in range(i, endj))
        log_max = 0 if mx == 0 else mx.bit_length()
        obs.write_bits(log_max, llr)
        if log_max:
            for j in range(i, endj):
                obs.write_bits(int(freqs[alphabet[j]]) - 1, log_max)
        i += chk


class RangeEncoder(EntropyEncoder):
    def __init__(self, obs: BitWriter, ctx=None,
                 chunk_size: int = DEFAULT_CHUNK_SIZE,
                 log_range: int = DEFAULT_LOG_RANGE):
        super().__init__(obs, ctx)
        if not 1024 <= chunk_size <= MAX_CHUNK_SIZE:
            raise ValueError("The chunk size must be in [1024, 2^30]")
        if not 8 <= log_range <= 15:
            raise ValueError("Invalid range parameter")
        self.chunk_size = chunk_size
        self.log_range = log_range

    def encode(self, block: np.ndarray) -> int:
        block = np.asarray(block, dtype=np.uint8)
        count = len(block)
        if count == 0:
            return 0
        from kanzi_tpu_torch.utils import native
        if native.transforms_available():
            res = native.range_enc_block(block, self.chunk_size,
                                         self.log_range)
            if res is not None:
                data, nb = res
                self.obs._append_bit_run(data, nb)
                return count
        start = 0
        while start < count:
            end = min(start + self.chunk_size, count)
            lr = self.log_range
            while lr > 8 and (1 << lr) > end - start:
                lr -= 1
            chunk = block[start:end]
            freqs = np.bincount(chunk, minlength=256).astype(np.int64)
            alphabet = eu.normalize_frequencies(freqs, 256, end - start, 1 << lr)
            _write_freq_header(self.obs, alphabet, freqs, lr)
            if len(alphabet) <= 1:
                start = end
                continue
            cum = np.concatenate([[0], np.cumsum(freqs[:256])]).astype(np.int64)
            low = 0
            rng = TOP_RANGE
            wb = self.obs.write_bits
            cum_l = cum.tolist()
            for b in chunk.tolist():
                cf = cum_l[b]
                f = cum_l[b + 1] - cf
                rng >>= lr
                low = (low + cf * rng) & M64
                rng = (rng * f) & M64
                while True:
                    if ((low ^ (low + rng)) & RANGE_MASK) != 0:
                        if rng > BOTTOM_RANGE:
                            break
                        rng = (~(low - 1)) & BOTTOM_RANGE
                    wb((low >> 32) & ((1 << 28) - 1), 28)
                    rng = (rng << 28) & M64
                    low = (low << 28) & M64
            wb(low & ((1 << 60) - 1), 60)
            start = end
        return count


class RangeDecoder(EntropyDecoder):
    def __init__(self, ibs: BitReader, ctx=None,
                 chunk_size: int = DEFAULT_CHUNK_SIZE):
        super().__init__(ibs, ctx)
        if not 1024 <= chunk_size <= MAX_CHUNK_SIZE:
            raise ValueError("The chunk size must be in [1024, 2^30]")
        self.chunk_size = chunk_size

    def _decode_header(self):
        alphabet = eu.decode_alphabet(self.ibs)
        if len(alphabet) == 0:
            return alphabet, None, None, 0
        lr = 8 + self.ibs.read_bits(3)
        count = len(alphabet)
        freqs = np.zeros(256, dtype=np.int64)
        if count == 1:
            freqs[alphabet[0]] = 1 << lr
            return alphabet, freqs, None, lr
        scale = 1 << lr
        chk = 8 if count >= 64 else 6
        llr = 3
        while (1 << llr) <= lr:
            llr += 1
        s = 0
        i = 1
        while i < count:
            log_max = self.ibs.read_bits(llr)
            if (1 << log_max) > scale:
                raise ValueError("Invalid bitstream: incorrect frequency size")
            endj = min(i + chk, count)
            for j in range(i, endj):
                f = 1 if log_max == 0 else self.ibs.read_bits(log_max) + 1
                if f <= 0 or f >= scale:
                    raise ValueError("Invalid bitstream: incorrect frequency")
                freqs[alphabet[j]] = f
                s += f
            i += chk
        if scale <= s:
            raise ValueError("Invalid bitstream: incorrect frequency")
        freqs[alphabet[0]] = scale - s
        cum = np.concatenate([[0], np.cumsum(freqs)]).astype(np.int64)
        f2s = np.repeat(np.arange(256, dtype=np.int64), freqs)
        return alphabet, freqs, (cum, f2s), lr

    def decode(self, count: int) -> np.ndarray:
        if count == 0:
            return np.zeros(0, dtype=np.uint8)
        from kanzi_tpu_torch.utils import native
        if native.transforms_available():
            pos, out = native.range_dec_block(
                self.ibs._data, self.ibs._nbits, self.ibs._pos, count,
                self.chunk_size)
            self.ibs.seek(pos)
            return out
        out = np.empty(count, dtype=np.uint8)
        start = 0
        while start < count:
            end = min(start + self.chunk_size, count)
            alphabet, freqs, tabs, lr = self._decode_header()
            if len(alphabet) == 0:
                return out[:start]
            if len(alphabet) == 1:
                out[start:end] = alphabet[0]
                start = end
                continue
            cum, f2s = tabs
            cum_l = cum.tolist()
            f2s_l = f2s.tolist()
            low = 0
            rng = TOP_RANGE
            code = self.ibs.read_bits(60)
            rb = self.ibs.read_bits
            for i in range(start, end):
                rng >>= lr
                if rng == 0:
                    raise ValueError("Invalid bitstream: incorrect range")
                cumv = ((code - low) & M64) // rng
                if cumv >= (1 << lr):
                    raise ValueError("Invalid bitstream: incorrect cumulative frequency")
                sym = f2s_l[cumv]
                cf = cum_l[sym]
                f = cum_l[sym + 1] - cf
                low = (low + cf * rng) & M64
                rng = (rng * f) & M64
                while True:
                    if ((low ^ (low + rng)) & RANGE_MASK) != 0:
                        if rng > BOTTOM_RANGE:
                            break
                        rng = (~(low - 1)) & BOTTOM_RANGE
                    code = ((code << 28) | rb(28)) & M64
                    rng = (rng << 28) & M64
                    low = (low << 28) & M64
                out[i] = sym
            start = end
        return out
