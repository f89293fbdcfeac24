"""host_inverse_s_per_GB.decompress: wall time in the per-block inverse
transforms on the host (compressed_stream._decode_block_finish) per 10^9
uncompressed bytes."""

from gpubench.spans import HOST as SPANS


def read(t, phase):
    spans = t.spans_of(phase, "host.inverse")
    gb = t.input_gb(phase)
    if not spans or gb <= 0:
        return None
    return sum(s["t1"] - s["t0"] for s in spans) / gb
