"""Spans, counters and the device trace of a traced run.

Spans are installed from the per-layer metric files (each may declare
SPANS = {name: (module, attribute, sizer)}): the attribute is wrapped
where its caller looks it up, and each call made inside the window is
recorded with its wall time, the phase of the call around it (compress
or decompress) and what the sizer reads from its arguments and result.
Nothing of the program is edited.

The device's activity comes from torch.profiler over the window: every
kernel and copy interval, mapped onto the host clock through the
harness's own call spans (record_function markers). The idle share
follows chip_smoke.py's profile(), with the intervals' union in place of
their sum.
"""

from __future__ import annotations

import importlib
import time

import numpy as np


class Tracer:
    def __init__(self):
        self.on = False
        self.phase = None
        self.call = -1
        self.spans = []
        self._undo = []

    def install(self, specs: dict) -> None:
        import torch
        for name, (module, attr, sizer) in specs.items():
            mod = importlib.import_module(module)
            fn = getattr(mod, attr, None)
            if fn is None:                        # nothing to read: skip
                continue
            setattr(mod, attr, self._wrap(torch, name, fn, sizer))
            self._undo.append((mod, attr, fn))

    def uninstall(self) -> None:
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo.clear()

    def _wrap(self, torch, name, fn, sizer):
        tracer = self

        def wrapped(*args, **kwargs):
            if not tracer.on:
                return fn(*args, **kwargs)
            with torch.profiler.record_function("gpubench/" + name):
                t0 = time.perf_counter()
                res = fn(*args, **kwargs)
                t1 = time.perf_counter()
            info = sizer(args, kwargs, res) if sizer else {}
            tracer.spans.append(dict(name=name, t0=t0, t1=t1,
                                     phase=tracer.phase, call=tracer.call,
                                     **info))
            return res
        return wrapped


def _merge(iv) -> tuple:
    """Sorted, merged [starts], [ends] of (t0, t1) intervals."""
    if not iv:
        return np.zeros(0), np.zeros(0)
    iv = sorted(iv)
    starts, ends = [iv[0][0]], [iv[0][1]]
    for a, b in iv[1:]:
        if a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return np.array(starts), np.array(ends)


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def device_intervals(events, calls: list) -> list:
    """[(name, t0, t1)] of every kernel and copy the profiler's events
    hold, on the host's perf_counter clock. The clock offset comes from
    the harness's call markers ("gpubench/call.<phase>", their host-side
    events) against the calls' own perf_counter spans; the markers'
    device-side annotations, and every other user annotation, are no
    device work and are left out."""
    import torch
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    marks = sorted(e.time_range.start for e in events
                   if e.device_type == cpu
                   and e.name.startswith("gpubench/call."))
    host = sorted(c["t0"] for c in calls)
    if not marks or len(marks) != len(host):
        return []
    off = float(np.median([h - m / 1e6 for h, m in zip(host, marks)]))
    return [(e.name, e.time_range.start / 1e6 + off,
             e.time_range.end / 1e6 + off) for e in events
            if e.device_type == cuda and not e.name.startswith("gpubench/")
            and not getattr(e, "is_user_annotation", False)]


class TraceData:
    """What a per-layer metric reads: the cell's configuration, the
    window's calls (phase, bytes, blocks, wall span, counter deltas), the
    spans, and the device's kernels and copies [(name, t0, t1)]."""

    def __init__(self, config, calls, spans, kernels):
        self.config = config
        self.calls = calls
        self.spans = spans
        self.kernels = kernels
        self.starts, self.ends = _merge([(a, b) for _, a, b in kernels])
        self._compute = _merge([(a, b) for n, a, b in kernels
                                if not is_copy(n)])

    def busy(self, a: float, b: float, copies: bool = True) -> float:
        """Seconds inside [a, b] in which a kernel (or, with copies, a
        kernel or a copy) ran on the device: their intervals' union."""
        starts, ends = (self.starts, self.ends) if copies else self._compute
        if b <= a or starts.size == 0:
            return 0.0
        return float((np.clip(ends, a, b) - np.clip(starts, a, b)).sum())

    def calls_of(self, phase):
        return [c for c in self.calls if c["phase"] == phase]

    def spans_of(self, phase, prefix):
        return [s for s in self.spans if s["phase"] == phase
                and s["name"].startswith(prefix)]

    def input_gb(self, phase) -> float:
        return sum(c["nbytes"] for c in self.calls_of(phase)) / 1e9


def breakdown(t: TraceData, window: tuple) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each gap named by the innermost span (or call) the host was in
    at its middle."""
    ops = {}
    for name, a, b in t.kernels:
        ops[name] = ops.get(name, 0.0) + (b - a)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    lo, hi = window
    edges_s = np.concatenate([[lo], t.ends])
    edges_e = np.concatenate([t.starts, [hi]])
    gaps = sorted(((float(e - s), float(s), float(e))
                   for s, e in zip(edges_s, edges_e) if e > s),
                  reverse=True)[:10]
    named = []
    for g, s, e in gaps:
        mid = (s + e) / 2
        inner = [sp for sp in t.spans if sp["t0"] <= mid <= sp["t1"]]
        if inner:
            sp = min(inner, key=lambda x: x["t1"] - x["t0"])
            label = f"{sp['phase']}:{sp['name']}"
        else:
            cs = [c for c in t.calls if c["t0"] <= mid <= c["t1"]]
            label = f"{cs[0]['phase']}:host" if cs else "between calls"
        named.append([label, g])
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": named}
