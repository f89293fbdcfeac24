"""entropy_roofline.<phase>: the entropy stage's share of its roofline.
The bound of the work its input needs (gpubench/roofline.py: bytes in and
out over the memory rate, or the coder's operations a symbol over the
integer rate) over the device time of the kernels that ran inside the stage's calls
(parallel.mesh.shard_cm_* / shard_ans0_*; copies left out), in %."""

from gpubench import roofline
from gpubench.spans import ENTROPY as SPANS


def read(t, phase):
    spans = t.spans_of(phase, "entropy.")
    busy = sum(t.busy(s["t0"], s["t1"], copies=False) for s in spans)
    if not spans or busy <= 0:
        return None
    ms = sum(roofline.bound(s["coder"], s["symbols"] + s["coded"],
                            s["symbols"])["bound_ms"] for s in spans)
    return 100.0 * (ms / 1000.0) / busy
