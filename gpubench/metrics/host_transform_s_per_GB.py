"""host_transform_s_per_GB.compress: wall time in the per-block forward
transforms on the host (compressed_stream._encode_block_phase1 as the
mesh chains call it) per 10^9 input bytes."""

from gpubench.spans import HOST as SPANS


def read(t, phase):
    spans = t.spans_of(phase, "host.transform")
    gb = t.input_gb(phase)
    if not spans or gb <= 0:
        return None
    return sum(s["t1"] - s["t0"] for s in spans) / gb
