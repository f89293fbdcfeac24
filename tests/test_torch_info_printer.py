"""InfoPrinter of the PyTorch port (kanzi_tpu_torch): rendering and the
ordered release of block events (src/app/InfoPrinter.cpp:76-151), on
tests/test_info_printer.py's events. Each printer's text is held equal
to kanzi_tpu's on the same events; the CLI runs with its ops enabled on
the CPU (--device cpu).
"""

import io

import pytest

from kanzi_tpu.app import info_printer as ref
from kanzi_tpu.core import events as ref_events
from kanzi_tpu_torch.app.info_printer import (COMPRESSION, DECOMPRESSION,
                                              INFO, InfoPrinter)
from kanzi_tpu_torch.core.events import Event, EventType

pytestmark = pytest.mark.timeout(120)


def _block_events(ev, et, bid, sizes=(100, 60, 55)):
    return [ev(et.BEFORE_TRANSFORM, bid, sizes[0]),
            ev(et.AFTER_TRANSFORM, bid, sizes[1]),
            ev(et.BEFORE_ENTROPY, bid, sizes[1]),
            ev(et.AFTER_ENTROPY, bid, sizes[2])]


def _both(verbosity, kind, feed):
    """feed(printer, Event, EventType) through the port's printer and
    kanzi_tpu's; returns the port's text, equal to kanzi_tpu's."""
    ours, theirs = io.StringIO(), io.StringIO()
    feed(InfoPrinter(verbosity, kind, out=ours), Event, EventType)
    feed(ref.InfoPrinter(verbosity, kind, out=theirs), ref_events.Event,
         ref_events.EventType)
    assert ours.getvalue() == theirs.getvalue()
    return ours.getvalue()


def test_blocks_released_in_id_order():
    out = io.StringIO()
    p = InfoPrinter(4, COMPRESSION, out=out)
    # block 2 completes before block 1 (concurrent tasks)
    for e in _block_events(Event, EventType, 2):
        p(e)
    assert out.getvalue() == ""          # held until block 1 completes
    for e in _block_events(Event, EventType, 1):
        p(e)
    lines = [ln for ln in out.getvalue().splitlines() if ln]
    assert lines[0].startswith("Block 1:")
    assert lines[1].startswith("Block 2:")
    assert "(55%)" in lines[0]

    def feed(p, ev, et):
        for bid in (2, 1):
            for e in _block_events(ev, et, bid):
                p(e)

    _both(4, COMPRESSION, feed)


def test_verbosity5_json_and_block_info():
    def feed(p, ev, et):
        p(ev(et.BLOCK_INFO, 1, 55, offset=192, skip_flags=0b11100000))

    s = _both(5, DECOMPRESSION, feed)
    assert '"offset":192' in s and '"skipFlags":"11100000"' in s


def test_info_table():
    info = {"bsVersion": 6, "checksum": 32, "blockSize": 4096,
            "entropy": "ANS0", "transform": "BWT+RANK+ZRLT",
            "originalSize": 10000, "fileSize": 4000,
            "inputName": "/tmp/x/sample.knz"}

    def feed(p, ev, et):
        p(ev(et.AFTER_HEADER_DECODING, 0, 4096, header_info=dict(info)))

    s = _both(4, INFO, feed)
    assert "File Name" in s and "sample.knz" in s and "ANS0" in s


def test_cli_verbosity_and_info(tmp_path, capsys):
    import numpy as np
    from kanzi_tpu.app.cli import main as ref_main
    from kanzi_tpu_torch.app.cli import main
    rng = np.random.default_rng(0)
    src = tmp_path / "f.bin"
    src.write_bytes(rng.integers(0, 64, 120000, dtype=np.uint8).tobytes())
    knz = tmp_path / "f.knz"
    dec = tmp_path / "f.out"
    assert main(["-c", "-f", "-i", str(src), "-o", str(knz), "-l", "1",
                 "-b", "32k", "-v", "5", "--device", "cpu"]) == 0
    assert main(["-d", "-f", "-i", str(knz), "-o", str(dec), "-v", "4",
                 "--device", "cpu"]) == 0
    assert dec.read_bytes() == src.read_bytes()
    assert main(["-y", "-i", str(knz), "-v", "4", "--device", "cpu"]) == 0
    cap = capsys.readouterr()
    assert "File Name" in cap.out
    ref_knz = tmp_path / "r.knz"
    assert ref_main(["-c", "-f", "-i", str(src), "-o", str(ref_knz), "-l",
                     "1", "-b", "32k"]) == 0
    assert ref_knz.read_bytes() == knz.read_bytes()


def test_cli_info_writes_to_each_calls_stdout(tmp_path):
    """Two -y runs in one process, each with its own stdout, each print
    the table to their own: the printer belongs to the run (kanzi_tpu's
    CLI keeps the first run's for the process, so a second run's table
    goes to the first run's stream)."""
    import contextlib

    import numpy as np
    from kanzi_tpu_torch.app.cli import main
    src = tmp_path / "g.bin"
    src.write_bytes(np.random.default_rng(1).integers(
        0, 16, 50000, dtype=np.uint8).tobytes())
    knz = tmp_path / "g.knz"
    assert main(["-c", "-f", "-i", str(src), "-o", str(knz), "-l", "2",
                 "--device", "cpu"]) == 0
    for _ in range(2):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(["-y", "-i", str(knz), "--device", "cpu"]) == 0
        assert "File Name" in out.getvalue() and "g.knz" in out.getvalue()
