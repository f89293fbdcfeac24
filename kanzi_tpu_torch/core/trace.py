"""What a call did, and where its time went: the launch counters and the
spans of the codec's layers.

Counters (COUNTERS, count, reset_counters) say which path ran: a kernel
wrapper bumps its kernel's key where it launches the kernel, and key +
"_plain" where it takes the plain version for a CPU tensor. The device
BWT and the device level-5 chain count the blocks they take
("bwt_forward_device", "l5_{encode,decode}_device_blocks"), the BWT
stage the input bytes of each forward on a card and on the host
("bwt_forward_device_bytes", "bwt_forward_host_bytes"), the level-6
mesh encode and the level-6 and level-7 mesh decodes the blocks they
code on the card ("l6_encode_device_blocks", "l6_decode_device_blocks",
"l7_decode_device_blocks"), the FPAQ encode batch its streams and those
it launches a second time ("fpaq_encode_streams",
"fpaq_encode_relaunch_streams"), the Huffman
coder the full chunks it codes on the host beside the kernels
("huff_host_chunks"), the level-7 mesh chain the CM blocks it leaves to
the host coder ("cm_host_blocks"), the LZ match pass each pass on the
card ("lz_match_pass", beside its four kernels' own counts), the LZ
transform the blocks it parses from the pass's hints
("lz_hinted_blocks"). Tests and chip_smoke.py read them to show which
path ran; kanzi_tpu_torch.ops re-exports them.

Spans (span, spans, clear) time the layers of a call on the host's
perf_counter clock (time.perf_counter_ns), the clock a caller times its
calls on and onto which a device trace is mapped. A span is recorded
only while torch's profiler is recording: it then also opens
torch.profiler.record_function("kanzi/<name>"), so that it lies on the
profiler's own timeline beside the kernels it launched, and its record
stays in memory until clear(). With the profiler off, span() reads one
flag and returns a shared no-op context.

A span's parent is the span open around it in its thread, or the one
passed as parent=: a worker thread takes its parent explicitly, since a
context variable does not cross into a thread pool's thread. A span with
no parent is a root (the call.* span of a call), and its id is the call
id of every span below it.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

COUNTERS = {}
_COUNT_LOCK = threading.Lock()


def count(key: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        COUNTERS[key] = COUNTERS.get(key, 0) + n


def reset_counters() -> None:
    with _COUNT_LOCK:
        COUNTERS.clear()


_SPANS = []                  # list.append is atomic: worker threads share it
_IDS = itertools.count(1)
_CURRENT = contextvars.ContextVar("kanzi_span", default=None)


class Span:
    """One recorded span: its name, start and end (perf_counter_ns), its
    id, its parent's id (None for a root), the call id of its root, and
    its attributes (block id, bytes in and out, device, kept, ...)."""

    __slots__ = ("name", "t0", "t1", "id", "parent", "call", "attrs",
                 "_token", "_range")

    def __init__(self, name: str, parent, attrs: dict):
        self.name = name
        self.id = next(_IDS)
        self.parent = None if parent is None else parent.id
        self.call = self.id if parent is None else parent.call
        self.attrs = attrs
        self.t0 = self.t1 = None

    def __bool__(self) -> bool:
        return True

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span (bytes out, kept)."""
        self.attrs.update(attrs)

    def __enter__(self):
        self._range = torch.profiler.record_function("kanzi/" + self.name)
        self._range.__enter__()
        self._token = _CURRENT.set(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        _CURRENT.reset(self._token)
        self._range.__exit__(*exc)
        _SPANS.append(self)
        return False


class _Off:
    """The span handed out while nothing records: falsy, so that a caller
    computes an attribute only where it is kept (``if sp: sp.set(...)``)."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def span(name: str, parent: Span | None = None, **attrs):
    """A context manager that records the layer ``name`` while torch's
    profiler records; parent: the span a worker thread runs under (its
    caller's current()), else the span open around it in this thread."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, _CURRENT.get() if parent is None else parent, attrs)


def current() -> Span | None:
    """The span open in this thread, to hand to a worker thread."""
    return _CURRENT.get()


def spans() -> list:
    """The recorded spans, each as it closed."""
    return list(_SPANS)


def clear() -> None:
    _SPANS.clear()
