"""Alphabet coding, frequency normalization, varints.

Mirrors src/entropy/EntropyUtils.cpp:
- encodeAlphabet/decodeAlphabet (:57-125): full/partial 256-bit bitmap
- normalizeFrequencies (:131-240): scale freqs to a power-of-2 total
- write/readVarInt (:247-280): 7-bit groups, MSB = continuation
"""

from __future__ import annotations

import numpy as np

from kanzi_tpu_torch.bitstream import BitReader, BitWriter

FULL_ALPHABET = 0
PARTIAL_ALPHABET = 1
ALPHABET_256 = 0
ALPHABET_0 = 1
INCOMPRESSIBLE_THRESHOLD = 973


def encode_alphabet(obs: BitWriter, alphabet: np.ndarray) -> int:
    """alphabet: sorted increasing symbol values present."""
    count = len(alphabet)
    if count == 0:
        obs.write_bit(FULL_ALPHABET)
        obs.write_bit(ALPHABET_0)
    elif count == 256:
        obs.write_bit(FULL_ALPHABET)
        obs.write_bit(ALPHABET_256)
    else:
        obs.write_bit(PARTIAL_ALPHABET)
        masks = np.zeros(32, dtype=np.uint8)
        a = np.asarray(alphabet, dtype=np.int64)
        np.bitwise_or.at(masks, a >> 3, (1 << (a & 7)).astype(np.uint8))
        last_mask = int(a[-1]) >> 3
        obs.write_bits(last_mask, 5)
        obs.write_bytes(masks[:last_mask + 1].tobytes())
    return count


def decode_alphabet(ibs: BitReader) -> np.ndarray:
    if ibs.read_bit() == FULL_ALPHABET:
        size = 256 if ibs.read_bit() == ALPHABET_256 else 0
        return np.arange(size, dtype=np.int64)
    last_mask = ibs.read_bits(5)
    masks = np.frombuffer(ibs.read_bytes(last_mask + 1), dtype=np.uint8)
    bits = np.unpackbits(masks, bitorder="little")
    return np.nonzero(bits)[0].astype(np.int64)


def normalize_frequencies(freqs: np.ndarray, length: int, total_freq: int,
                          scale: int):
    """Scale freqs (len<=256, modified in place) so they sum to `scale`.
    Returns the alphabet (present symbols). Exact reimplementation of
    EntropyUtils::normalizeFrequencies (:131-240) including the error
    spreading so outputs are bit-identical.
    """
    if length > 256:
        raise ValueError("Invalid alphabet size parameter")
    if not 256 <= scale <= 65536:
        raise ValueError("Invalid scale parameter")
    if length == 0 or total_freq == 0:
        return np.zeros(0, dtype=np.int64)

    if total_freq == scale:
        return np.nonzero(freqs[:256])[0].astype(np.int64)

    alphabet = []
    sum_scaled = 0
    sum_freq = 0
    idx_max = 0
    for i in range(length):
        f = int(freqs[i])
        freqs[i] = 0
        if f == 0:
            continue
        alphabet.append(i)
        sf = f * scale
        scaled = 1 if sf <= total_freq else (sf + (total_freq >> 1)) // total_freq
        sum_scaled += scaled
        freqs[i] = scaled
        sum_freq += f
        if scaled > freqs[idx_max]:
            idx_max = i
        if sum_freq >= total_freq:
            break

    alphabet = np.array(alphabet, dtype=np.int64)
    size = len(alphabet)
    if size == 0:
        return alphabet
    if size == 1:
        freqs[alphabet[0]] = scale
        return alphabet
    if sum_scaled == scale:
        return alphabet

    delta = sum_scaled - scale
    err_thr = int(freqs[idx_max]) >> 4
    if abs(delta) <= err_thr:
        freqs[idx_max] -= delta
        return alphabet
    if delta < 0:
        delta += err_thr
        freqs[idx_max] += err_thr
    else:
        delta -= err_thr
        freqs[idx_max] -= err_thr

    inc = 1 if delta < 0 else -1
    delta = abs(delta)
    rnd = 0
    while rnd < 5 and delta > 0:
        rnd += 1
        adjustments = 0
        for i in range(size):
            idx = int(alphabet[i])
            if freqs[idx] <= 2:
                continue
            freqs[idx] += inc
            adjustments += 1
            delta -= 1
            if delta == 0:
                break
        if adjustments == 0:
            break
    freqs[idx_max] = max(int(freqs[idx_max]) - delta, 1)
    return alphabet


def write_varint(obs: BitWriter, value: int) -> int:
    res = 0
    value &= 0xFFFFFFFF
    while value >= 128:
        obs.write_bits(0x80 | (value & 0x7F), 8)
        value >>= 7
        res += 1
    obs.write_bits(value, 8)
    return res


def read_varint(ibs: BitReader) -> int:
    value = ibs.read_bits(8)
    res = value & 0x7F
    shift = 7
    while value >= 128:
        value = ibs.read_bits(8)
        if shift == 28:
            if value >= 128 or (value & 0x70) != 0:
                raise ValueError("Invalid variable-length integer in bitstream")
            res |= (value & 0x0F) << shift
            return res
        res |= (value & 0x7F) << shift
        shift += 7
    return res
