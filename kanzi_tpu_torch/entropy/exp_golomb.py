"""Exp-Golomb bit codes (src/entropy/ExpGolomb{Encoder,Decoder}.{hpp,cpp}).

Used to transmit Huffman code-length deltas. The byte code for value v:
unsigned: (v+1) written with its leading 1 → 2*log2(v+1)+1 bits;
signed:   exp-golomb(|v|) followed by a sign bit (1 = negative).
Zero is the single bit '1'.
"""

from __future__ import annotations

import numpy as np

from kanzi_tpu_torch.bitstream import BitReader, BitWriter


def _code_unsigned(v: int):
    log2 = (v + 1).bit_length() - 1
    return 2 * log2 + 1, v + 1


def code_for_byte(val: int, signed: bool):
    """Return (nbits, bits) for a byte value (reference CACHE tables)."""
    val &= 0xFF
    if val == 0:
        return 1, 1
    # byte interpreted as int8 (|−128| = 128); reference CACHE tables are
    # symmetric around 128 for both signed and unsigned variants
    v = val if val < 128 else 256 - val
    if not signed:
        return _code_unsigned(v)
    sgn = 1 if val >= 128 else 0
    n, bits = _code_unsigned(v)
    return n + 1, (bits << 1) | sgn


# Precomputed (nbits, bits) tables for all byte values
_TAB = {False: [code_for_byte(i, False) for i in range(256)],
        True: [code_for_byte(i, True) for i in range(256)]}

EG_SIGNED_LENS = np.array([_TAB[True][i][0] for i in range(256)], dtype=np.int64)
EG_SIGNED_BITS = np.array([_TAB[True][i][1] for i in range(256)], dtype=np.uint64)


class ExpGolombEncoder:
    def __init__(self, obs: BitWriter, signed: bool = True):
        self.obs = obs
        self.signed = signed
        self._tab = _TAB[signed]

    def encode_byte(self, val: int) -> None:
        n, bits = self._tab[val & 0xFF]
        self.obs.write_bits(bits, n)

    def encode(self, block) -> int:
        for b in bytes(block):
            self.encode_byte(b)
        return len(block)


class ExpGolombDecoder:
    def __init__(self, ibs: BitReader, signed: bool = True):
        self.ibs = ibs
        self.signed = signed

    def decode_byte(self) -> int:
        if self.ibs.read_bit() == 1:
            return 0
        log2 = 1
        while self.ibs.read_bit() == 0:
            log2 += 1
        log2 &= 7  # clamp, do not attempt to detect corruption
        if self.signed:
            res = self.ibs.read_bits(log2 + 1)
            sgn = res & 1
            res = (res >> 1) + (1 << log2) - 1
            return ((res - sgn) ^ -sgn) & 0xFF
        return ((1 << log2) - 1 + self.ibs.read_bits(log2)) & 0xFF

    def decode(self, count: int) -> bytes:
        return bytes(self.decode_byte() for _ in range(count))
