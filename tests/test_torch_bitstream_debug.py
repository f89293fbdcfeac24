"""The bitstream tracer of the PyTorch port
(kanzi_tpu_torch.bitstream.debug), the counterpart of
tests/test_api.py's test_debug_bitstream_tracer: it traces every bit,
value and byte crossing the port's BitWriter and BitReader and passes
them on unchanged, with the trace and the bytes of kanzi_tpu's tracer.
"""

import io

import pytest

from kanzi_tpu.bitstream import BitWriter as RefWriter
from kanzi_tpu.bitstream.debug import DebugBitWriter as RefDebugWriter
from kanzi_tpu_torch.bitstream import BitReader, BitWriter
from kanzi_tpu_torch.bitstream.debug import DebugBitReader, DebugBitWriter

pytestmark = pytest.mark.timeout(60)


def _write(w):
    w.write_bits(0x4B414E5A, 32)
    w.write_bit(1)
    w.write_bytes(b"\xAB\xCD")
    w.write_bits(5, 3)
    return w.getvalue()


def test_debug_bitstream_tracer():
    log = io.StringIO()
    w = DebugBitWriter(BitWriter(), out=log, hexa=True)
    blob = _write(w)
    assert "4B414E5A" in log.getvalue()
    assert blob == _write(BitWriter())
    r = DebugBitReader(BitReader(blob), out=io.StringIO())
    assert r.read_bits(32) == 0x4B414E5A
    assert r.read_bit() == 1
    assert r.read_bytes(2) == b"\xab\xcd"
    assert r.read_bits(3) == 5


@pytest.mark.parametrize("hexa", [True, False])
def test_trace_matches_kanzi_tpu(hexa):
    """The same writes give kanzi_tpu's trace, line breaks included (a
    narrow width), and its bytes; the reader's trace shows each value."""
    ours, theirs = io.StringIO(), io.StringIO()
    blob = _write(DebugBitWriter(BitWriter(), out=ours, hexa=hexa,
                                 width=16))
    ref_blob = _write(RefDebugWriter(RefWriter(), out=theirs, hexa=hexa,
                                     width=16))
    assert ours.getvalue() == theirs.getvalue()
    assert blob == ref_blob
    log = io.StringIO()
    r = DebugBitReader(BitReader(blob), out=log, hexa=hexa)
    r.read_bits(32)
    want = "[4B414E5A:32] " if hexa else format(0x4B414E5A, "032b") + " "
    assert log.getvalue() == want
