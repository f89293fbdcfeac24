"""host_text_s_per_GB.<phase>: wall time in the program's
transform.text.forward spans (compress; the level-5 route's trial runs
count) or transform.text.inverse spans (decompress) per 10^9 input bytes
of the phase's calls: the host's TEXT stage."""

from gpubench import program

SPANS = {}


def read(t, phase):
    return program.stage_s_per_gb(t, phase, "text")
