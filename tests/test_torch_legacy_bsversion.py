"""Legacy bitstream (bsVersion <= 5) decode paths of the PyTorch port
(kanzi_tpu_torch), on tests/test_legacy_bsversion.py's hand-made streams
(built from the reference wire-format specs):

- BWT legacy header: per-chunk mode byte (pIndexSize in the top 2 bits,
  the index's high bits in the low 6), the chunk count from the FULL
  block size, indexes stored verbatim (BWTBlockCodec.cpp:140-167).
- LZ inverseV5: token LLLRMMMM, mLen escape at 14/15 with repeat
  distances starting at 0, literal extra-lengths read from the literal
  stream (LZCodec.cpp:614-760).
- Huffman decodeV5: the v6 lengths header, then a 2-bit stream count
  (0), a varint bit size, ONE bitstream (HuffmanDecoder.cpp:349-447).

The port runs with its ops enabled and its device "cpu" in the context;
each stream also goes through kanzi_tpu's decoder (JAX on the CPU), and
both must return the same bytes, the input.
"""

import numpy as np
import pytest

from kanzi_tpu.core.context import Context as RefContext
from kanzi_tpu_torch.core.context import Context

pytestmark = pytest.mark.timeout(120)


def _ctx5():
    return Context({"bsVersion": 5, "device": "cpu"})


def _ref_ctx5():
    return RefContext({"bsVersion": 5})


# ---------------------------------------------------------------------------
# BWT legacy header
# ---------------------------------------------------------------------------

def test_bwt_legacy_header_roundtrip():
    from kanzi_tpu.transform.bwt import BWTBlockCodec as RefCodec
    from kanzi_tpu_torch.transform.bwt import (BWTBlockCodec, bwt_forward,
                                               get_bwt_chunks)
    rng = np.random.default_rng(11)
    data = rng.integers(97, 105, 4000, dtype=np.uint8)
    bwt, indexes = bwt_forward(data, "cpu")
    # legacy writer: per chunk, mode byte + remaining index bytes
    header = bytearray()
    for pi in indexes:
        p = 1
        while pi >= (1 << (6 + 8 * (p - 1))):
            p += 1
        header.append(((p - 1) << 6) | (pi >> (8 * (p - 1))))
        for j in range(p - 2, -1, -1):
            header.append((pi >> (8 * j)) & 0xFF)
    block = np.frombuffer(bytes(header) + bwt.tobytes(), dtype=np.uint8)
    assert get_bwt_chunks(len(block)) == len(indexes)
    out = BWTBlockCodec(_ctx5()).inverse(block)
    assert np.array_equal(out, data)
    assert np.array_equal(RefCodec(_ref_ctx5()).inverse(block), out)


# ---------------------------------------------------------------------------
# LZ inverseV5
# ---------------------------------------------------------------------------

def _lz5_stream(lits, tokens, mstream, mlens):
    """A v5 LZ block: 13-byte header + literal region + token stream +
    match-distance stream + match-length stream."""
    lit_region = b"".join(lits)
    tk_idx = 13 + len(lit_region)
    header = (tk_idx.to_bytes(4, "little")
              + len(tokens).to_bytes(4, "little")
              + len(mstream).to_bytes(4, "little")
              + bytes([0]))          # mFlag=0, minMatch=MIN_MATCH4
    return np.frombuffer(header + lit_region + bytes(tokens)
                         + bytes(mstream) + bytes(mlens), dtype=np.uint8)


def _lz_inverse_both(block):
    from kanzi_tpu.transform.lz import LZCodec as RefLZ
    from kanzi_tpu_torch.transform.lz import LZCodec
    out = LZCodec(_ctx5()).inverse(block).tobytes()
    assert RefLZ(_ref_ctx5()).inverse(block).tobytes() == out
    return out


def test_lz_inverse_v5_matches_and_repeats():
    rng = np.random.default_rng(7)
    r = rng.integers(0, 256, 100, dtype=np.uint8).tobytes()
    s = rng.integers(0, 256, 100, dtype=np.uint8).tobytes()
    want = r + b"wxyz" * 23 + s

    # token1: 104 literals (r + first wxyz, escape len 97) then match
    #         dist=4 mLen=76 (field 14, extra 58)
    # token2: match-only repeat-distance (field 15, repd0=4), mLen=4+8
    # token3: final 100 literals (escape len 93), break
    lits = [bytes([97]) + r + b"wxyz", bytes([93]) + s]
    tokens = [0xEE, 0x0F, 0xE0]
    block = _lz5_stream(lits, tokens, [4], [58, 8])
    assert _lz_inverse_both(block) == want


def test_lz_inverse_v5_literals_only():
    data = b"plain literal block of text!" * 4
    lit = bytes([len(data) - 7]) + data
    block = _lz5_stream([lit], [0xE0], [], [])
    assert _lz_inverse_both(block) == data


# ---------------------------------------------------------------------------
# Huffman decodeV5
# ---------------------------------------------------------------------------

def _huff5_encode(block: np.ndarray, chunk_size: int) -> bytes:
    """A minimal v5 Huffman encoder on the port's v6 lengths header."""
    from kanzi_tpu_torch.bitstream import BitWriter
    from kanzi_tpu_torch.entropy import utils as eu
    from kanzi_tpu_torch.entropy.huffman import HuffmanEncoder
    from kanzi_tpu_torch.utils.bitpack import pack_bits
    obs = BitWriter()
    enc = HuffmanEncoder(obs, Context({"device": "cpu"}),
                         chunk_size=chunk_size)
    start = 0
    count = len(block)
    while start < count:
        chunk = block[start:start + min(chunk_size, count - start)]
        freqs = np.bincount(chunk, minlength=256).astype(np.int64)
        n = enc._update_frequencies(freqs)     # writes the lengths header
        if n > 1:
            obs.write_bits(0, 2)               # stream count
            code_bits = enc.codes & 0x0FFF
            code_lens = enc.codes >> 12
            packed, nbits = pack_bits(code_bits[chunk], code_lens[chunk])
            eu.write_varint(obs, nbits)
            obs._append_bit_run(packed.tobytes(), nbits)
        start += len(chunk)
    return obs.getvalue()


def _huff_decode_both(blob, n):
    from kanzi_tpu.bitstream import BitReader as RefReader
    from kanzi_tpu.entropy.huffman import HuffmanDecoder as RefDecoder
    from kanzi_tpu_torch.bitstream import BitReader
    from kanzi_tpu_torch.entropy.huffman import HuffmanDecoder
    out = HuffmanDecoder(BitReader(blob), _ctx5(),
                         chunk_size=1 << 14).decode(n)
    ref = RefDecoder(RefReader(blob), _ref_ctx5(),
                     chunk_size=1 << 14).decode(n)
    assert np.array_equal(out, ref)
    return out


def test_huffman_decode_v5():
    rng = np.random.default_rng(3)
    # mixed: skewed text-like + a short uniform tail, 2.5 chunks
    a = rng.choice(np.frombuffer(b"etaoin shrdlu", np.uint8), 30000)
    b = rng.integers(0, 256, 11000, dtype=np.uint8)
    block = np.concatenate([a, b]).astype(np.uint8)
    blob = _huff5_encode(block, 1 << 14)
    assert np.array_equal(_huff_decode_both(blob, len(block)), block)


def test_huffman_decode_v5_single_symbol_chunk():
    block = np.full(5000, 42, np.uint8)
    blob = _huff5_encode(block, 1 << 14)
    assert np.array_equal(_huff_decode_both(blob, len(block)), block)
