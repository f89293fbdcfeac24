"""entropy_wait_s_per_GB.compress: how long blocks wait at the batch
barrier. For each block of each compress call, the start of the call's
first entropy.* span less the end of the block's block.forward span,
summed, per 10^9 input bytes of the phase's calls."""

from gpubench import program

SPANS = {}


def read(t, phase):
    wait, found = 0.0, False
    for _, spans in program.by_call(t, phase):
        ent = [s["t0"] for s in spans if s["name"].startswith("entropy.")]
        if not ent:
            continue
        first = min(ent)
        for s in spans:
            if s["name"] == "block.forward":
                wait += first - s["t1"]
                found = True
    gb = t.input_gb(phase)
    if not found or gb <= 0:
        return None
    return wait / gb
