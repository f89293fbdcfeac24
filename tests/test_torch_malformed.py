"""Malformed-stream handling of the PyTorch port (kanzi_tpu_torch), on
tests/test_malformed.py's inputs (reference: src/test/TestMalformedStream
.cpp; the reference's SECURITY.md treats a crash or hang on malformed
input as a vulnerability, so decode must fail with a typed error, never
crash).

The port runs with its ops enabled on the CPU (device "cpu": the
kernels' plain versions), and every corrupted stream goes through
kanzi_tpu's reader too (JAX on the CPU): the port must raise the same
error class, or return the same bytes, as kanzi_tpu does. Each blob is
the port's, held byte-identical with kanzi_tpu's writer first.
"""

import numpy as np
import pytest

import kanzi_tpu_torch as k
from kanzi_tpu.io.compressed_stream import compress_bytes as ref_compress
from kanzi_tpu.io.compressed_stream import CompressedReader as RefReader
from kanzi_tpu_torch.bitstream.reader import BitStreamError
from kanzi_tpu_torch.core.errors import KanziError

FAILS = (KanziError, ValueError, BitStreamError)
CPU = "cpu"

pytestmark = pytest.mark.timeout(300)


def _compress(data, **kw):
    blob = k.compress_bytes(data, device=CPU, **kw)
    assert blob == ref_compress(data, **kw)
    return blob


def ref_decompress(buf) -> bytes:
    """kanzi_tpu's reader, its blocks joined as they come. Its read_all
    (decompress_bytes) places each block at its fixed offset of a
    preallocated buffer and returns that buffer even where a corrupt
    block decoded to other than block_size bytes, with bytes there that
    no block wrote (ROADMAP.md section 3); the port's copies the blocks
    out from there on, so it equals this join."""
    return b"".join(RefReader(buf).read_blocks())


def _outcome(decompress, buf, **kw):
    """("ok", bytes) or ("err", the exception class's name): any other
    exception fails the test."""
    try:
        return "ok", decompress(bytes(buf), **kw)
    except RecursionError:                  # would be a real bug
        raise
    except Exception as e:                  # compared by class below
        return "err", type(e).__name__


def _expect_same(buf):
    """The port's outcome on buf: a typed failure, or bytes; kanzi_tpu's
    outcome must be the same class of failure, or the same bytes."""
    ours = _outcome(k.decompress_bytes, buf, device=CPU)
    theirs = _outcome(ref_decompress, buf)
    assert ours == theirs
    if ours[0] == "err":
        assert ours[1] in {c.__name__ for c in FAILS}, ours
    return ours


def _expect_fail(buf):
    assert _expect_same(buf)[0] == "err"


@pytest.fixture(scope="module")
def blob():
    rng = np.random.default_rng(4)
    data = (b"malformed stream handling " * 3000
            + rng.integers(0, 256, 30000, dtype=np.uint8).tobytes())
    return data, _compress(data, transform="LZX", entropy="HUFFMAN",
                           checksum_bits=32)


def test_bad_magic(blob):
    _, b = blob
    bad = bytearray(b)
    bad[0] ^= 0xFF
    _expect_fail(bad)


def test_bad_version(blob):
    _, b = blob
    bad = bytearray(b)
    bad[4] ^= 0xF0  # version lives in the top nibble of byte 4
    _expect_fail(bad)


def test_corrupt_header_checksum(blob):
    _, b = blob
    bad = bytearray(b)
    bad[9] ^= 0x01  # inside transform ids -> 24-bit checksum mismatch
    _expect_fail(bad)


def test_truncated(blob):
    _, b = blob
    _expect_fail(b[: len(b) // 2])
    _expect_fail(b[:16])


def test_corrupt_payload_every_region(blob):
    data, b = blob
    n = len(b)
    for pos in (32, n // 4, n // 2, 3 * n // 4, n - 8):
        bad = bytearray(b)
        bad[pos] ^= 0xA5
        kind, out = _expect_same(bad)
        # the stream carries a 32-bit block checksum, so a flipped byte
        # may decode without a typed failure only in a don't-care bit
        # (padding): the output must then be the input
        if kind == "ok":
            assert out == data, f"silent corruption at offset {pos}"


def test_block_checksum_catches_corruption():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 120000, dtype=np.uint8).tobytes()
    b = _compress(data, transform="NONE", entropy="ANS0", checksum_bits=32)
    bad = bytearray(b)
    bad[len(b) // 2] ^= 0x10
    _expect_fail(bad)


def test_empty_and_tiny_inputs_roundtrip():
    for data in (b"", b"x", b"tiny block", bytes(15)):
        assert k.decompress_bytes(_compress(data), device=CPU) == data


def test_corrupt_ans0_chunk_with_deferred_sink():
    """A corrupt ANS0 chunk whose decode is deferred through the
    cross-block sink (full 16 KiB chunks, decoded by the ANS0 decode's
    plain version here) fails with a typed error at flush time or
    returns other bytes, as kanzi_tpu's reader does."""
    rng = np.random.default_rng(9)
    data = (b"deferred sink corruption probe " * 20000
            + rng.integers(0, 256, 100000, dtype=np.uint8).tobytes())
    blob = bytearray(_compress(data, transform="NONE", entropy="ANS0",
                               block_size=128 * 1024))
    assert k.decompress_bytes(bytes(blob), device=CPU) == data
    for off in range(len(blob) // 3, 2 * len(blob) // 3, 997):
        blob[off] ^= 0xFF
    kind, out = _expect_same(blob)
    assert kind == "err" or out != data


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5, 6, 7])
def test_corruption_fuzz_all_levels(level):
    """Random single-byte corruptions across the whole stream at every
    default level: the port fails with kanzi_tpu's error class or
    returns kanzi_tpu's bytes, never crashes or hangs."""
    from kanzi_tpu_torch.app.cli import LEVEL_TABLE
    rng = np.random.default_rng(100 + level)
    data = (b"all-level corruption fuzz " * 4000
            + rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()
            + bytes(20000))
    t, e = LEVEL_TABLE[level]
    blob = _compress(data, transform=t, entropy=e, block_size=64 * 1024)
    assert k.decompress_bytes(blob, device=CPU) == data
    for _ in range(6):
        b = bytearray(blob)
        off = int(rng.integers(0, len(b)))
        b[off] ^= int(rng.integers(1, 256))
        kind, out = _expect_same(b)
        assert kind == "err" or out != data or b == blob
