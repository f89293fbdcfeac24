"""Thread-safe Printer + WallTimer.

Reference: src/util/Printer.hpp:29-62 (mutex-guarded print/println —
the worker pool emits block progress from several threads) and
src/util/WallTimer.hpp:36-90 (monotonic wall-clock, milliseconds).
"""

from __future__ import annotations

import sys
import threading
import time


class Printer:
    """Serializes writes to a stream across threads (one process-wide
    lock, like the reference's static mutex)."""

    _lock = threading.Lock()

    def __init__(self, stream=None) -> None:
        self._os = stream if stream is not None else sys.stdout

    def print(self, msg, do_print: bool = True) -> None:
        if do_print and msg is not None:
            with Printer._lock:
                self._os.write(str(msg))

    def println(self, msg, do_print: bool = True) -> None:
        if do_print and msg is not None:
            with Printer._lock:
                self._os.write(str(msg) + "\n")
                try:
                    self._os.flush()
                except Exception:
                    pass  # best effort, like the reference destructor

    def flush(self) -> None:
        try:
            self._os.flush()
        except Exception:
            pass


class WallTimer:
    """Accumulating monotonic timer; elapsed() in milliseconds."""

    @staticmethod
    def now_ms() -> float:
        return time.monotonic() * 1000.0

    def __init__(self) -> None:
        self._start = None
        self._elapsed_ms = 0.0

    def start(self) -> None:
        self._start = time.monotonic()

    def stop(self) -> float:
        if self._start is not None:
            self._elapsed_ms += (time.monotonic() - self._start) * 1000.0
            self._start = None
        return self._elapsed_ms

    def elapsed(self) -> float:
        run = 0.0
        if self._start is not None:
            run = (time.monotonic() - self._start) * 1000.0
        return self._elapsed_ms + run
