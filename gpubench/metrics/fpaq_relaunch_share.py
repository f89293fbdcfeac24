"""fpaq_relaunch_share.compress: seconds in the program's
entropy.fpaq.relaunch spans (G launched again for the streams that
outgrow their region, copies included) over seconds in its
entropy.fpaq.encode spans, in %. None where the program counts no
fpaq_encode_streams in the phase's calls: a program without the
relaunch's span and counter."""

from gpubench import program

SPANS = {}


def read(t, phase):
    if not any("fpaq_encode_streams" in c.get("counters", {})
               for c in t.calls_of(phase)):
        return None
    calls = program.by_call(t, phase)
    enc = sum(program.seconds(ss, "entropy.fpaq.encode") for _, ss in calls)
    if enc <= 0:
        return None
    return 100.0 * sum(program.seconds(ss, "entropy.fpaq.relaunch")
                       for _, ss in calls) / enc
