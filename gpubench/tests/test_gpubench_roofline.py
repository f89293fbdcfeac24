"""The frozen bound() arithmetic and the per-layer readers on synthetic
traces."""

import pytest

from gpubench import roofline, trace
from gpubench.run import metric_module, ROOT


def test_bound_of_j_at_16_streams_of_4mib():
    # PERF.md's bound for J (cm_decode) at 16 x 4 MiB: 2.051 ms, by
    # operations (8 bit steps of 64 a byte over 67e12 / 4 a second)
    b = roofline.bound("cm_decode", 16 * (4 << 20), 16 * (4 << 20))
    assert b["bound_by"] == "operations"
    assert round(b["bound_ms"], 3) == 2.051


def test_split_bound_adds_up():
    parts = {"a": (1e9, 1e10), "b": (2e9, 0)}
    res = roofline.split_bound(parts)
    whole = max(3e9 / roofline.HBM_BYTES_PER_S,
                1e10 / roofline.INT32_OPS_PER_S) * 1000
    assert sum(r["bound_ms"] for r in res.values()) == pytest.approx(whole)


def synthetic():
    calls = [dict(phase="compress", nbytes=10**9, blocks=4, t0=0.0, t1=10.0,
                  counters={"l5_encode_device_blocks": 1}),
             dict(phase="decompress", nbytes=10**9, blocks=4, t0=10.0,
                  t1=14.0, counters={"l5_decode_device_blocks": 3})]
    spans = [dict(name="entropy.ans0_encode", t0=2.0, t1=4.0,
                  phase="compress", call=0, coder="ans0_encode_scan",
                  symbols=10**9, coded=3 * 10**8),
             dict(name="host.transform", t0=4.0, t1=9.0, phase="compress",
                  call=0)]
    return trace.TraceData({"entropy": "ANS0"}, calls, spans,
                           [("k", 2.5, 3.5), ("c", 11.0, 13.0),
                            ("Memcpy HtoD (Pinned -> Device)", 3.0, 3.9)])


def read(name):
    mod, phase = metric_module(ROOT, name)
    return mod.read(synthetic(), phase)


def test_readers_on_a_synthetic_trace():
    assert read("device_idle.compress") == pytest.approx(86.0)
    assert read("device_idle.decompress") == pytest.approx(50.0)
    assert read("host_transform_s_per_GB.compress") == pytest.approx(5.0)
    assert read("entropy_stage_s_per_GB.compress") == pytest.approx(2.0)
    assert read("card_block_share.compress") == pytest.approx(25.0)
    assert read("card_block_share.decompress") == pytest.approx(75.0)
    ms = roofline.bound("ans0_encode_scan", 13 * 10**8, 10**9)["bound_ms"]
    assert read("entropy_roofline.compress") == pytest.approx(ms / 1000 / 1.0 * 100)
    assert read("entropy_roofline.decompress") is None   # nothing to read
    assert read("bwt_stage_s_per_GB.compress") is None


def test_busy_clips_to_the_interval():
    t = synthetic()
    assert t.busy(0, 3.0) == pytest.approx(0.5)
    assert t.busy(3.0, 12.0) == pytest.approx(1.9)
    assert t.busy(3.0, 12.0, copies=False) == pytest.approx(1.5)
    assert t.busy(5, 5) == 0.0


class Event:
    def __init__(self, name, dev, t0, t1):
        import torch
        self.name = name
        self.device_type = getattr(torch.autograd.DeviceType, dev)
        self.time_range = type("R", (), {"start": t0, "end": t1})()


def test_device_intervals_on_the_host_clock():
    # the profiler counts microseconds from its own start; the calls'
    # perf_counter spans start 100 s later. A marker's device-side
    # annotation is no device work.
    events = [Event("gpubench/call.compress", "CPU", 1e6, 3e6),
              Event("gpubench/call.decompress", "CPU", 3e6, 4e6),
              Event("gpubench/call.compress", "CUDA", 1.5e6, 2.9e6),
              Event("cm_encode_kernel", "CUDA", 2e6, 2.5e6),
              Event("Memcpy DtoH (Device -> Pinned)", "CUDA", 2.5e6, 2.6e6),
              Event("aten::copy_", "CPU", 2.4e6, 2.6e6)]
    calls = [dict(t0=101.0, t1=103.0), dict(t0=103.0, t1=104.0)]
    k = trace.device_intervals(events, calls)
    assert [n for n, _, _ in k] == ["cm_encode_kernel",
                                    "Memcpy DtoH (Device -> Pinned)"]
    assert k[0][1:] == pytest.approx((102.0, 102.5))
    assert trace.device_intervals(events, calls[:1]) == []
