"""The port's span recorder (kanzi_tpu_torch.core.trace): nothing is
recorded and almost nothing spent while torch's profiler is off; under
the profiler, the level-5 and level-7 mesh chains' round trips on a CPU
mesh give one root span a call, every span inside its own call, one span
a transform stage a block whose kept flag matches the block's skip
flags, and the same counters as without the profiler."""

import threading
import time

import numpy as np
import pytest
import torch

import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.bitstream import BitReader
from kanzi_tpu_torch.core import trace
from kanzi_tpu_torch.io.compressed_stream import (COPY_BLOCK_MASK,
                                                  TRANSFORMS_MASK,
                                                  CompressedReader)
from kanzi_tpu_torch.parallel import mesh as tmesh
from kanzi_tpu_torch.parallel import pipeline as tpp

MESH = tmesh.block_mesh(["cpu"])
TEXT = b"the quick brown fox jumps over the lazy dog. " * 1200


def _profiled(fn):
    """fn() under torch.profiler (CPU activity): (its result, the spans
    it recorded)."""
    trace.clear()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        res = fn()
    got = trace.spans()
    trace.clear()
    return res, got


def _skip_flags(blob: bytes) -> list:
    """Each block's skip flags as its header holds them (None for a copy
    block)."""
    r = CompressedReader(blob)
    flags = []
    while True:
        bits = r.ibs.read_bits(3 + r.ibs.read_bits(5))
        if bits == 0:
            return flags
        ibs = BitReader(r.ibs.read_payload(bits))
        mode = ibs.read_bits(8)
        flags.append(None if mode & COPY_BLOCK_MASK else
                     ibs.read_bits(8) if mode & TRANSFORMS_MASK else
                     ((mode << 4) | 0x0F) & 0xFF)


def _round_trip(compress, decompress, data, n):
    tops.reset_counters()
    blob = compress(data, n, MESH)
    assert decompress(blob, MESH) == data
    return blob, dict(tops.COUNTERS)


def _check_calls(spans: list) -> dict:
    """One root a call (call.compress, then call.decompress), every
    parent in its child's call, each entropy stage's shards below it.
    Returns {call name: [its spans]}."""
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert sorted(r.name for r in roots) == ["call.compress",
                                             "call.decompress"]
    for s in spans:
        assert s.t0 <= s.t1
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.call == s.call and p.t0 <= s.t0 and s.t1 <= p.t1
    for s in spans:
        if s.name.startswith("entropy.") and s.name != "entropy.batch":
            kids = [k for k in spans if k.parent == s.id]
            assert kids and all(k.name == "mesh.shard" for k in kids)
            assert by_id[s.parent].name == "entropy.batch"
        if s.name == "mesh.shard":
            assert by_id[s.parent].name.startswith(("entropy.", "call."))
            assert s.attrs["device"] == "cpu" and s.attrs["items"] >= 1
    return {r.name: [s for s in spans if s.call == r.call] for r in roots}


def _check_stages(calls: dict, blob: bytes, chain: list) -> int:
    """Each block.forward that ran the chain has one transform span a
    stage, in order, kept where the block's skip flags say the stage
    ran; its block.inverse runs the kept stages in reverse. Returns the
    blocks checked."""
    flags = _skip_flags(blob)
    comp, dec = calls["call.compress"], calls["call.decompress"]
    inv = {s.attrs["block"]: s for s in dec if s.name == "block.inverse"}
    checked = 0
    for bf in (s for s in comp if s.name == "block.forward"):
        stages = sorted((s for s in comp if s.parent == bf.id),
                        key=lambda s: s.t0)
        if not stages:                    # the card's transforms ran
            continue
        assert [s.name for s in stages] == [
            f"transform.{c}.forward" for c in chain]
        sf = flags[bf.attrs["block"] - 1]
        ran = [not sf & (1 << (7 - i)) for i in range(len(chain))]
        assert [s.attrs["kept"] for s in stages] == ran
        up = inv[bf.attrs["block"]].id
        back = sorted((s for s in dec if s.parent == up), key=lambda s: s.t0)
        assert [s.name for s in back] == [
            f"transform.{c}.inverse" for c, r in zip(chain[::-1], ran[::-1])
            if r]
        checked += 1
    return checked


def test_span_off_records_nothing_and_costs_little():
    """With the profiler off, span() reads one flag and hands out the
    shared no-op context: nothing is recorded, and the call costs under
    1 us."""
    assert not torch.autograd.profiler._is_profiler_enabled
    trace.clear()
    off = trace.span("call.compress", bytes=1)
    assert not off and off is trace.span("block.forward", block=2)
    with trace.span("block.forward", block=1) as sp:
        sp.set(bytes_out=1)
        assert trace.current() is None
    k = 20000
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        for i in range(k):
            trace.span("block.forward", block=i)
        best = min(best, (time.perf_counter() - t) / k)
    assert trace.spans() == []
    assert best < 1e-6, f"{best * 1e9:.0f} ns a span() with nothing recording"


def test_span_parents_across_threads():
    """A worker thread's span takes its parent explicitly; the spans
    record the perf_counter clock and the attributes set inside."""
    def work(parent, out):
        with trace.span("mesh.shard", parent, items=2) as sp:
            with trace.span("inner"):
                pass
            out.append(sp)

    def run():
        with trace.span("call.compress", bytes=5) as root:
            out = []
            th = threading.Thread(target=work, args=(trace.current(), out))
            th.start()
            th.join()
            with trace.span("transform.text.forward", bytes_in=5) as sp:
                sp.set(kept=False)
        return root

    t0 = time.perf_counter_ns()
    root, spans = _profiled(run)
    assert time.perf_counter_ns() >= root.t1 >= root.t0 >= t0
    by = {s.name: s for s in spans}
    assert set(by) == {"call.compress", "mesh.shard", "inner",
                       "transform.text.forward"}
    assert by["mesh.shard"].parent == root.id
    assert by["inner"].parent == by["mesh.shard"].id
    assert {s.call for s in spans} == {root.id} and root.parent is None
    assert by["transform.text.forward"].attrs == {"bytes_in": 5,
                                                  "kept": False}
    assert trace.current() is None and trace.spans() == []


def test_counters_are_the_ops_counters():
    assert tops.COUNTERS is trace.COUNTERS
    assert tops.count is trace.count
    tops.reset_counters()
    tops.count("x", 2)
    assert trace.COUNTERS == {"x": 2}
    trace.reset_counters()
    assert tops.COUNTERS == {}


@pytest.mark.timeout(600)
def test_l7_mesh_round_trip_spans():
    """compress_l7_mesh / decompress_l7_mesh on a CPU mesh, two 1 KiB
    blocks (text, random) and a tail."""
    rng = np.random.default_rng(7)
    data = TEXT[:1024] + rng.integers(0, 256, 1024, np.uint8).tobytes() \
        + TEXT[:200]
    blob0, counts = _round_trip(tpp.compress_l7_mesh, tpp.decompress_l7_mesh,
                                data, 1024)
    (blob, counts_on), spans = _profiled(lambda: _round_trip(
        tpp.compress_l7_mesh, tpp.decompress_l7_mesh, data, 1024))
    assert blob == blob0 and counts_on == counts
    assert counts["cm_encode_plain"] == 1
    calls = _check_calls(spans)
    chain = [c.lower() for c in tpp.CHAIN_L7.split("+")]
    assert _check_stages(calls, blob, chain) == 3
    names = [s.name for s in calls["call.compress"]]
    assert names.count("entropy.cm.encode") == 1
    assert names.count("container.commit") == 2
    dec = calls["call.decompress"]
    assert [s.attrs["block"] for s in dec if s.name == "block.entropy"] \
        == [1, 2, 3]
    assert sum(s.name == "entropy.cm.decode" for s in dec) == 1
    root = next(s for s in dec if s.parent is None)
    assert root.attrs == {"bytes_in": len(blob), "bytes": len(data),
                          "blocks": 3}


@pytest.mark.timeout(600)
def test_l5_mesh_round_trip_spans():
    """compress_l5_mesh / decompress_l5_mesh on a CPU mesh: two 16 KiB
    blocks through the card's chain, a text block through the host
    chain, a tail; the route's trial runs are spans that keep nothing."""
    rng = np.random.default_rng(5)
    n = 16384
    data = (rng.integers(0, 256, n, np.uint8).tobytes()
            + np.repeat(rng.integers(0, 4, n // 4, np.uint8), 4).tobytes()
            + TEXT[:n] + b"tail" * 9)
    blob0, counts = _round_trip(tpp.compress_l5_mesh, tpp.decompress_l5_mesh,
                                data, n)
    (blob, counts_on), spans = _profiled(lambda: _round_trip(
        tpp.compress_l5_mesh, tpp.decompress_l5_mesh, data, n))
    assert blob == blob0 and counts_on == counts
    assert counts["l5_encode_device_blocks"] == 2
    assert counts["l5_decode_device_blocks"] == 2
    calls = _check_calls(spans)
    chain = [c.lower() for c in tpp.CHAIN.split("+")]
    assert _check_stages(calls, blob, chain) == 2       # text block, tail
    comp = calls["call.compress"]
    route = [s for s in comp if s.name == "l5.route"]
    assert len(route) == 1
    trials = [s for s in comp if s.parent == route[0].id]
    # text and UTF skip on both card blocks; TEXT runs on the text block
    assert [s.name for s in trials] == ["transform.text.forward",
                                        "transform.utf.forward"] * 2 + [
        "transform.text.forward"]
    assert not any(s.attrs["kept"] for s in trials)
    by_id = {s.id: s for s in spans}
    for name, phase in (("l5.device.forward", "call.compress"),
                        ("l5.device.inverse", "call.decompress")):
        dev = [s for s in calls[phase] if s.name == name]
        assert sum(s.attrs["blocks"] for s in dev) == 2
        assert all(by_id[s.parent].name == "mesh.shard" for s in dev)
    dec = calls["call.decompress"]
    for name in ("container.frames", "container.output",
                 "entropy.ans0.decode"):
        assert sum(s.name == name for s in dec) == 1
    # each block parsed for the card's batch; the text block and the tail
    # parsed again by the host path
    assert sorted(s.attrs["block"] for s in dec
                  if s.name == "block.entropy") == [1, 2, 3, 3, 4, 4]
