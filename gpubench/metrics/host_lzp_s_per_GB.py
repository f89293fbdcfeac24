"""host_lzp_s_per_GB.<phase>: wall time in the program's
transform.lzp.forward spans (compress; the level-5 route's trial runs
count) or transform.lzp.inverse spans (decompress) per 10^9 input bytes
of the phase's calls: the host's LZP stage."""

from gpubench import program

SPANS = {}


def read(t, phase):
    return program.stage_s_per_gb(t, phase, "lzp")
