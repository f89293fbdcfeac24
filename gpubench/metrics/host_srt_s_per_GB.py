"""host_srt_s_per_GB.<phase>: wall time in the program's
transform.srt.forward spans (compress) or transform.srt.inverse spans
(decompress) per 10^9 input bytes of the phase's calls: the host's SRT
stage of the level-6 chain."""

from gpubench import program

SPANS = {}


def read(t, phase):
    return program.stage_s_per_gb(t, phase, "srt")
