"""The program's own spans (kanzi_tpu_torch.core.trace) as the per-layer
metrics read them.

The program records its spans while torch's profiler records, so a
traced run holds those of its window. Each span is taken with the
harness's call that contains its root span (the call.* span), both on
the perf_counter clock, as a dict: name, t0 and t1 in seconds, id,
parent, call and the span's attributes. A program without the recorder
gives none, and the metrics that read them read nothing.
"""

from __future__ import annotations

import bisect


def records() -> list:
    """The program's span records, or [] where it has no recorder."""
    try:
        from kanzi_tpu_torch.core import trace
    except ImportError:
        return []
    return trace.spans()


def by_call(t, phase) -> list:
    """[(call, [span dicts])]: each of the phase's calls whose spans
    were found, with every span whose root lies inside it."""
    calls = sorted(t.calls_of(phase), key=lambda c: c["t0"])
    starts = [c["t0"] for c in calls]
    recs = records()
    owner = {}
    for r in recs:
        if r.parent is None:
            k = bisect.bisect_right(starts, r.t0 / 1e9) - 1
            if k >= 0 and r.t1 / 1e9 <= calls[k]["t1"]:
                owner[r.id] = k
    spans = [[] for _ in calls]
    for r in recs:
        k = owner.get(r.call)
        if k is not None:
            spans[k].append(dict(r.attrs, name=r.name, t0=r.t0 / 1e9,
                                 t1=r.t1 / 1e9, id=r.id, parent=r.parent,
                                 call=r.call))
    return [(c, s) for c, s in zip(calls, spans) if s]


def seconds(spans, name: str) -> float:
    return sum(s["t1"] - s["t0"] for s in spans if s["name"] == name)


def stage_s_per_gb(t, phase, stage: str):
    """Wall time in transform.<stage>.forward spans (compress) or
    .inverse spans (decompress) per 10^9 input bytes of the phase's
    calls."""
    name = f"transform.{stage}." + ("forward" if phase == "compress"
                                    else "inverse")
    calls = by_call(t, phase)
    gb = t.input_gb(phase)
    if not calls or gb <= 0:
        return None
    return sum(seconds(ss, name) for _, ss in calls) / gb

