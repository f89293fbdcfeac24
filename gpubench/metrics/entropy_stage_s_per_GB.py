"""entropy_stage_s_per_GB.<phase>: wall time inside the entropy stage's
shard calls, copies included, per 10^9 input bytes of the phase's calls."""

from gpubench.spans import ENTROPY as SPANS


def read(t, phase):
    spans = t.spans_of(phase, "entropy.")
    gb = t.input_gb(phase)
    if not spans or gb <= 0:
        return None
    return sum(s["t1"] - s["t0"] for s in spans) / gb
