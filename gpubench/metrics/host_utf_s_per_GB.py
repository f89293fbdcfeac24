"""host_utf_s_per_GB.<phase>: wall time in the program's
transform.utf.forward spans (compress; the level-5 route's trial runs
count) or transform.utf.inverse spans (decompress) per 10^9 input bytes
of the phase's calls: the host's UTF stage."""

from gpubench import program

SPANS = {}


def read(t, phase):
    return program.stage_s_per_gb(t, phase, "utf")
