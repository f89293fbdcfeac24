"""The per-layer metrics that read the program's own spans
(gpubench/program.py): on tiny traced CPU runs every one of them reads
a finite value in each cell that lists it, the host stages nest inside
the host transforms, and untraced_idle counts only the idle time that no
span covers."""

import json
import math
import os
from types import SimpleNamespace

import pytest

from gpubench import program, trace
from gpubench.tests import tiny

NEW = ("host_lzp_s_per_GB", "host_text_s_per_GB", "host_utf_s_per_GB",
       "host_bwt_s_per_GB", "untraced_idle", "entropy_wait_s_per_GB",
       "transform_waste_share")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("cell", ["l7.enwik8", "l5.silesia"])
def test_new_metrics_read_in_tiny_traced_runs(root, cell):
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    want = [m["name"] for m in bench["per_layer"]
            if m["name"].split(".")[0] in NEW and cell in m["workloads"]]
    assert len(want) >= 9
    rc, res = tiny.run(root, cell, seed=2**31 + 7, trace=1)
    assert rc == 0 and res["correct"] is True
    got = res["metrics"]
    for name in want:
        assert name in got, name
        assert math.isfinite(got[name]["value"]), name
    if cell == "l7.enwik8":
        stages = sum(got[f"host_{s}_s_per_GB.compress"]["value"]
                     for s in ("lzp", "text", "utf", "bwt"))
        assert 0 < stages <= got["host_transform_s_per_GB.compress"]["value"]
    assert 0 <= got["transform_waste_share.compress"]["value"] <= 100
    assert got["entropy_wait_s_per_GB.compress"]["value"] >= 0


def _span(i, name, t0, t1, parent):
    return SimpleNamespace(id=i, name=name, t0=int(t0 * 1e9),
                           t1=int(t1 * 1e9), parent=parent, call=1,
                           attrs={})


def test_untraced_idle_counts_uncovered_gaps(monkeypatch):
    """A call [10, 20] s with kernels at [10, 12], [14, 16], [18, 20]:
    the idle gap [12, 14] lies under a program span, [16, 18] under
    none, so half the idle time is untraced."""
    from gpubench.metrics import untraced_idle
    calls = [dict(phase="compress", t0=10.0, t1=20.0, nbytes=1, blocks=1)]
    t = trace.TraceData({}, calls, [], [("k", 10.0, 12.0), ("k", 14.0, 16.0),
                                        ("k", 18.0, 20.0)])
    recs = [_span(1, "call.compress", 10.0, 20.0, None),
            _span(2, "block.forward", 11.5, 14.5, 1)]
    monkeypatch.setattr(program, "records", lambda: recs)
    assert untraced_idle.read(t, "compress") == pytest.approx(50.0)
    assert untraced_idle.read(t, "decompress") is None
    monkeypatch.setattr(program, "records", lambda: [])
    assert untraced_idle.read(t, "compress") is None
