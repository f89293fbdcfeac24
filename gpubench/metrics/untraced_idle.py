"""untraced_idle.<phase>: the device-idle seconds inside the phase's
calls (each call's interval less the union of the kernel and copy
intervals) that no program span below the call's root covers, over all
device-idle seconds inside those calls, in %: the host work that leaves
the card idle and that no layer's span names."""

import numpy as np

from gpubench import program

SPANS = {}


def union_s(starts, ends) -> float:
    """Seconds covered by the union of [starts[i], ends[i]]."""
    if len(starts) == 0:
        return 0.0
    order = np.argsort(starts, kind="stable")
    total, lo, hi = 0.0, None, None
    for a, b in zip(np.asarray(starts)[order], np.asarray(ends)[order]):
        if hi is None or a > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return float(total + hi - lo)


def untraced_idle_s(t, call, spans) -> tuple:
    """(device-idle seconds inside the call, those of them that no span
    below the call's root covers)."""
    a, b = call["t0"], call["t1"]
    lo = np.searchsorted(t.ends, a, "right")
    hi = np.searchsorted(t.starts, b, "left")
    ks, ke = np.clip(t.starts[lo:hi], a, b), np.clip(t.ends[lo:hi], a, b)
    inner = [s for s in spans if s["parent"] is not None]
    ss = np.clip([s["t0"] for s in inner], a, b)
    se = np.clip([s["t1"] for s in inner], a, b)
    idle = (b - a) - float((ke - ks).sum())
    covered = union_s(np.concatenate([ks, ss]), np.concatenate([ke, se]))
    return idle, (b - a) - covered


def read(t, phase):
    idle = untraced = 0.0
    for call, spans in program.by_call(t, phase):
        i, u = untraced_idle_s(t, call, spans)
        idle, untraced = idle + i, untraced + u
    if idle <= 0:
        return None
    return 100.0 * untraced / idle
