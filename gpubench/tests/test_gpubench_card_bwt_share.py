"""The card_bwt_share reader on a synthetic trace."""

import pytest

from gpubench import trace
from gpubench.run import metric_module, ROOT


def test_card_bwt_share_reads_the_byte_counters():
    """card_bwt_share: the card's BWT forward bytes over both sides',
    summed over the phase's calls; None where no forward ran, as in a
    program without the counters."""
    mod, phase = metric_module(ROOT, "card_bwt_share.compress")
    calls = [dict(phase="compress", nbytes=10**6, blocks=2, t0=0.0, t1=1.0,
                  counters={"bwt_forward_device_bytes": 300,
                            "bwt_forward_host_bytes": 100}),
             dict(phase="compress", nbytes=10**6, blocks=1, t0=1.0, t1=2.0,
                  counters={"bwt_forward_device_bytes": 600}),
             dict(phase="decompress", nbytes=10**6, blocks=3, t0=2.0,
                  t1=3.0, counters={"cm_decode": 1})]
    t = trace.TraceData({"entropy": "CM"}, calls, [], [])
    assert mod.read(t, phase) == pytest.approx(90.0)
    assert mod.read(t, "decompress") is None
    for c in calls:
        c["counters"] = {"cm_encode": 1}
    assert mod.read(t, phase) is None
    calls[0]["counters"] = {"bwt_forward_host_bytes": 5}
    assert mod.read(t, phase) == 0.0
