"""The level-6 mesh chain's counters and the FPAQ encode's spans
(kanzi_tpu_torch.parallel.pipeline, ops.fpaq, core/trace.py) on a CPU
mesh, the kernels' plain versions: every FPAQ block counted on the
card's side each way, G's second launch counted and in a span of its
own, the bytes unchanged by either, and nothing recorded with the
profiler off."""

import numpy as np
import pytest
import torch

import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.core import trace
from kanzi_tpu_torch.ops import fpaq as tf
from kanzi_tpu_torch.parallel import pipeline as tpp

MESH = (torch.device("cpu"),)
N = 2048
TEXT = b"the quick brown fox jumps over the lazy dog. " * 50


def _data() -> bytes:
    """A random block, a block of zeros, a text block and a tail."""
    rng = np.random.default_rng(24)
    return (rng.integers(0, 256, N, np.uint8).tobytes() + bytes(N)
            + TEXT[:N] + b"tail" * 5)


def _round_trip(data):
    tops.reset_counters()
    blob = tpp.compress_l6_mesh(data, N, MESH)
    enc = dict(tops.COUNTERS)
    tops.reset_counters()
    assert tpp.decompress_l6_mesh(blob, MESH) == data
    return blob, enc, dict(tops.COUNTERS)


def _profiled(fn):
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        res = fn()
    got = trace.spans()
    trace.clear()
    return res, got


@pytest.fixture(scope="module")
def plain():
    """The round trip with the profiler off: (blob, encode counters,
    decode counters, the spans recorded)."""
    trace.clear()
    res = _round_trip(_data())
    return res + (trace.spans(),)


def test_device_block_counters_match_the_blocks(plain):
    """l6_encode_device_blocks and l6_decode_device_blocks each count
    every block of the round trip (the tail among them), and the encode
    batch its streams, none of them launched twice."""
    _, enc, dec, _ = plain
    blocks = -(-len(_data()) // N)
    assert enc["l6_encode_device_blocks"] == blocks == 4
    assert enc["fpaq_encode_streams"] == blocks
    assert "fpaq_encode_relaunch_streams" not in enc
    assert dec["l6_decode_device_blocks"] == blocks
    assert enc["fpaq_encode_plain"] == dec["fpaq_decode_plain"] == 1


def test_nothing_recorded_with_the_profiler_off(plain):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert plain[3] == []


def test_relaunch_counted_in_its_span_bytes_unchanged(plain, monkeypatch):
    """With regions of 64 words a 512-byte window (4 bits a byte), the
    random block's stream outgrows its region and is coded again: the
    counter and the relaunch span's streams agree, the zeros' stream is
    not relaunched, and
    the container is the unpatched run's, byte for byte."""
    blob0 = plain[0]
    monkeypatch.setattr(tf, "REGION_W", 64)
    (blob, enc, dec), spans = _profiled(lambda: _round_trip(_data()))
    assert blob == blob0
    k = enc["fpaq_encode_relaunch_streams"]
    assert 1 <= k < enc["fpaq_encode_streams"] == 4
    assert enc["fpaq_encode_plain"] == 2
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    (encode,) = by["entropy.fpaq.encode"]
    (relaunch,) = by["entropy.fpaq.relaunch"]
    assert encode.attrs["items"] == 4
    assert relaunch.attrs["streams"] == k
    assert 0 < relaunch.attrs["bytes"] <= encode.attrs["bytes_in"]
    assert encode.t0 <= relaunch.t0 <= relaunch.t1 <= encode.t1
    assert relaunch.call == encode.call
    (decode,) = by["entropy.fpaq.decode"]
    assert decode.attrs["items"] == dec["l6_decode_device_blocks"] == 4


def test_no_relaunch_reads_zero_in_the_span():
    """Unpatched and profiled: no stream is relaunched, and no relaunch
    span is recorded."""
    (_, enc, _), spans = _profiled(lambda: _round_trip(TEXT))
    names = [s.name for s in spans]
    assert "entropy.fpaq.relaunch" not in names
    assert "fpaq_encode_relaunch_streams" not in enc
    assert enc["l6_encode_device_blocks"] == enc["fpaq_encode_streams"] == 2
