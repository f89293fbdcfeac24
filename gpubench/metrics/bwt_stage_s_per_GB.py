"""bwt_stage_s_per_GB.<phase>: wall time inside the level-5 chain's card
transforms (pipeline._device_l5: BWT, RANK, ZRLT; _device_l5_inv: their
inverses) per 10^9 input bytes of the phase's calls."""

from gpubench.spans import BWT as SPANS


def read(t, phase):
    spans = t.spans_of(phase, "bwt.")
    gb = t.input_gb(phase)
    if not spans or gb <= 0:
        return None
    return sum(s["t1"] - s["t0"] for s in spans) / gb
