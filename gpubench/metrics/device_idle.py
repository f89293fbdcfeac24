"""device_idle.<phase>: one minus the device's busy share (the union of
its kernel and copy intervals) over the wall time of the phase's calls,
in %."""

SPANS = {}


def read(t, phase):
    calls = t.calls_of(phase)
    wall = sum(c["t1"] - c["t0"] for c in calls)
    if wall <= 0 or t.starts.size == 0:
        return None
    busy = sum(t.busy(c["t0"], c["t1"]) for c in calls)
    return 100.0 * (1.0 - busy / wall)
