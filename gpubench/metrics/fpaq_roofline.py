"""fpaq_roofline.<phase>: kernel G's (compress) or H's (decompress)
share of its roofline. The bound of the work the FPAQ stage's streams
need (gpubench/roofline.py: bytes in and out over the memory rate, or
the coder's operations a byte over the integer rate) over the device
time of the kernels that ran inside the program's entropy.fpaq.encode or
.decode spans (copies left out), in %. G's second launch of the streams
that outgrow their region counts as device time, not as bound."""

from gpubench import roofline
from gpubench.metrics.fpaq_stage_s_per_GB import stage_spans

SPANS = {}
KERNEL = {"compress": "fpaq_encode", "decompress": "fpaq_decode"}


def read(t, phase):
    spans = stage_spans(t, phase)
    busy = sum(t.busy(s["t0"], s["t1"], copies=False) for s in spans)
    if not spans or busy <= 0:
        return None
    # the symbols are the stage's uncompressed bytes: G's input, H's output
    sym = "bytes_in" if phase == "compress" else "bytes_out"
    ms = sum(roofline.bound(KERNEL[phase], s["bytes_in"] + s["bytes_out"],
                            s[sym])["bound_ms"] for s in spans)
    return 100.0 * (ms / 1000.0) / busy
