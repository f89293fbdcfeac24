"""fpaq_stage_s_per_GB.<phase>: wall time in the program's
entropy.fpaq.encode spans (compress; G's second launch inside them) or
entropy.fpaq.decode spans (decompress), copies included, per 10^9 input
bytes of the phase's calls: the level-6 chain's FPAQ stage on the
card."""

from gpubench import program

SPANS = {}
NAME = {"compress": "entropy.fpaq.encode",
        "decompress": "entropy.fpaq.decode"}


def stage_spans(t, phase) -> list:
    """The phase's FPAQ stage spans, those of every call."""
    return [s for _, spans in program.by_call(t, phase) for s in spans
            if s["name"] == NAME[phase]]


def read(t, phase):
    spans = stage_spans(t, phase)
    gb = t.input_gb(phase)
    if not spans or gb <= 0:
        return None
    return sum(s["t1"] - s["t0"] for s in spans) / gb
