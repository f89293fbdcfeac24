"""decompress_MBps: 10^6 uncompressed bytes a second, all output bytes of
the decompress calls that completed in the window over all the wall time
those calls took (host clock)."""


def read_window(calls):
    cs = [c for c in calls if c["phase"] == "decompress"]
    if not cs:
        return None
    return sum(c["nbytes"] for c in cs) / 1e6 / sum(c["t1"] - c["t0"] for c in cs)
