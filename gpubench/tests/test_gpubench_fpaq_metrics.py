"""The level-6 cell's per-layer readers (fpaq_stage_s_per_GB,
fpaq_roofline, host_srt_s_per_GB, fpaq_relaunch_share) on synthetic
program spans and a synthetic device trace."""

from types import SimpleNamespace

import pytest

from gpubench import program, roofline, trace
from gpubench.run import ROOT, metric_module

GB = 10**9


def _span(i, name, t0, t1, parent, call, **attrs):
    return SimpleNamespace(id=i, name=name, t0=int(t0 * 1e9),
                           t1=int(t1 * 1e9), parent=parent, call=call,
                           attrs=attrs)


def synthetic(counters=True, relaunch=True):
    """A compress call [0, 10] s and a decompress call [10, 20] s over 2
    GB each: the encode span [2, 6] with a relaunch [4, 5] inside it,
    the decode span [12, 15]; SRT 1.5 s forward, 0.5 s inverse; G's
    kernels busy 2 s of the encode span, H's 3 s of the decode span, a
    copy beside each."""
    enc = {"fpaq_encode_streams": 26} if counters else {}
    if counters and relaunch:
        enc["fpaq_encode_relaunch_streams"] = 2
    calls = [dict(phase="compress", nbytes=2 * GB, blocks=26, t0=0.0,
                  t1=10.0, counters=enc),
             dict(phase="decompress", nbytes=2 * GB, blocks=26, t0=10.0,
                  t1=20.0, counters={"l6_decode_device_blocks": 26})]
    recs = [_span(1, "call.compress", 0.5, 9.5, None, 1),
            _span(2, "transform.srt.forward", 1.0, 2.0, 1, 1),
            _span(3, "transform.srt.forward", 6.5, 7.0, 1, 1),
            _span(4, "entropy.fpaq.encode", 2.0, 6.0, 1, 1, items=26,
                  bytes_in=GB, bytes_out=GB // 2),
            _span(6, "call.decompress", 10.5, 19.5, None, 6),
            _span(7, "entropy.fpaq.decode", 12.0, 15.0, 6, 6, items=26,
                  bytes_in=GB // 2, bytes_out=GB),
            _span(8, "transform.srt.inverse", 16.0, 16.5, 6, 6)]
    if relaunch:
        recs.append(_span(5, "entropy.fpaq.relaunch", 4.0, 5.0, 4, 1,
                          streams=2, bytes=10**6))
    kernels = [("fpaq_encode", 2.5, 3.5), ("fpaq_encode", 4.0, 5.0),
               ("Memcpy HtoD (Pageable -> Device)", 5.0, 5.5),
               ("fpaq_decode", 12.0, 15.0),
               ("Memcpy DtoH (Device -> Pageable)", 15.0, 15.2),
               ("other", 7.0, 8.0)]
    return trace.TraceData({"entropy": "FPAQ"}, calls, [], kernels), recs


def read(name, t):
    mod, phase = metric_module(ROOT, name)
    return mod.read(t, phase)


@pytest.fixture
def traced(monkeypatch):
    def make(**kw):
        t, recs = synthetic(**kw)
        monkeypatch.setattr(program, "records", lambda: recs)
        return t
    return make


def test_stage_and_srt_seconds_per_gb(traced):
    t = traced()
    assert read("fpaq_stage_s_per_GB.compress", t) == pytest.approx(2.0)
    assert read("fpaq_stage_s_per_GB.decompress", t) == pytest.approx(1.5)
    assert read("host_srt_s_per_GB.compress", t) == pytest.approx(0.75)
    assert read("host_srt_s_per_GB.decompress", t) == pytest.approx(0.25)


def test_roofline_is_the_bound_over_the_kernels_in_the_spans(traced):
    """The bound counts each stream's bytes once; the relaunch's kernel
    time is device time; copies and kernels outside the spans are not."""
    t = traced()
    g = roofline.bound("fpaq_encode", GB + GB // 2, GB)["bound_ms"] / 1000
    h = roofline.bound("fpaq_decode", GB + GB // 2, GB)["bound_ms"] / 1000
    assert read("fpaq_roofline.compress", t) == pytest.approx(100 * g / 2.0)
    assert read("fpaq_roofline.decompress", t) == pytest.approx(
        100 * h / 3.0)
    assert 0 < read("fpaq_roofline.compress", t) <= 100


def test_relaunch_share(traced):
    assert read("fpaq_relaunch_share.compress",
                traced()) == pytest.approx(25.0)
    assert read("fpaq_relaunch_share.compress",
                traced(relaunch=False)) == 0.0
    # a program that counts no FPAQ streams: nothing to read
    assert read("fpaq_relaunch_share.compress",
                traced(counters=False, relaunch=False)) is None


def test_nothing_to_read_without_the_spans(monkeypatch):
    t, _ = synthetic()
    monkeypatch.setattr(program, "records", lambda: [])
    for name in ("fpaq_stage_s_per_GB.compress", "fpaq_roofline.decompress",
                 "host_srt_s_per_GB.compress",
                 "fpaq_relaunch_share.compress"):
        assert read(name, t) is None, name
