"""Typed progress events + listener bus (src/Event.hpp:31-42, src/Listener.hpp).

Pipeline stages emit Events; listeners (the CLI InfoPrinter, tests,
profilers) consume them. Events carry block id, sizes, checksum, offset and
skip flags — same observability surface as the reference.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


class EventType(enum.Enum):
    COMPRESSION_START = 0
    DECOMPRESSION_START = 1
    BEFORE_TRANSFORM = 2
    AFTER_TRANSFORM = 3
    BEFORE_ENTROPY = 4
    AFTER_ENTROPY = 5
    COMPRESSION_END = 6
    DECOMPRESSION_END = 7
    AFTER_HEADER_DECODING = 8
    BLOCK_INFO = 9


@dataclass
class Event:
    type: EventType
    block_id: int
    size: int
    time_ns: int = field(default_factory=time.monotonic_ns)
    checksum: Optional[int] = None
    hash_bits: int = 0           # 0 / 32 / 64
    offset: Optional[int] = None  # bitstream offset (BLOCK_INFO)
    skip_flags: Optional[int] = None
    header_info: Optional[dict] = None  # AFTER_HEADER_DECODING payload

    def __str__(self) -> str:
        s = f"[{self.type.name}] id={self.block_id} size={self.size}"
        if self.checksum is not None:
            s += f" hash={self.checksum:0{self.hash_bits // 4}X}"
        if self.offset is not None:
            s += f" offset={self.offset}"
        if self.skip_flags is not None:
            s += f" skipFlags={self.skip_flags:08b}"
        return s


class ListenerBus:
    def __init__(self) -> None:
        self._listeners: List[Callable[[Event], None]] = []

    def add(self, fn: Callable[[Event], None]) -> None:
        self._listeners.append(fn)

    def remove(self, fn: Callable[[Event], None]) -> bool:
        try:
            self._listeners.remove(fn)
            return True
        except ValueError:
            return False

    def notify(self, evt: Event) -> None:
        for fn in self._listeners:
            try:
                fn(evt)
            except Exception:
                pass  # listeners must not break the pipeline

    def __bool__(self) -> bool:
        return bool(self._listeners)
