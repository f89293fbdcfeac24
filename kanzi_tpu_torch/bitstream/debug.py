"""Debug bitstream decorators (bit-level tracing).

Mirrors src/bitstream/Debug{Output,Input}BitStream.hpp: wrap a
BitWriter/BitReader and print every bit or byte crossing it (binary or
hex, configurable line width) while delegating unchanged — the
bitstream tracer used to diagnose format divergences.
"""

from __future__ import annotations

import sys


class DebugBitWriter:
    """Decorates a BitWriter; prints written bits (hex per byte-run or
    binary per bit) to `out`."""

    def __init__(self, delegate, out=None, hexa: bool = True, width: int = 80):
        self.d = delegate
        self.out = out or sys.stdout
        self.hexa = hexa
        self.width = max(width, 8)
        self._col = 0

    def _emit(self, s: str) -> None:
        self.out.write(s)
        self._col += len(s)
        if self._col >= self.width:
            self.out.write("\n")
            self._col = 0

    def write_bit(self, bit: int) -> None:
        self._emit(f"{bit & 1}")
        self.d.write_bit(bit)

    def write_bits(self, value: int, n: int) -> None:
        if self.hexa:
            self._emit(f"[{value & ((1 << n) - 1):0{(n + 3) // 4}X}:{n}] ")
        else:
            self._emit(format(value & ((1 << n) - 1), f"0{n}b") + " ")
        self.d.write_bits(value, n)

    def write_bytes(self, data) -> None:
        b = bytes(data)
        if self.hexa:
            self._emit(b.hex().upper() + " ")
        else:
            for x in b:
                self._emit(format(x, "08b") + " ")
        self.d.write_bytes(b)

    def _append_bit_run(self, data: bytes, nbits: int) -> None:
        self._emit(f"<run:{nbits}b {bytes(data)[:8].hex().upper()}...> ")
        self.d._append_bit_run(data, nbits)

    def written(self) -> int:
        return self.d.written()

    def getvalue(self) -> bytes:
        return self.d.getvalue()


class DebugBitReader:
    """Decorates a BitReader; prints bits as they are read."""

    def __init__(self, delegate, out=None, hexa: bool = True, width: int = 80):
        self.d = delegate
        self.out = out or sys.stdout
        self.hexa = hexa
        self.width = max(width, 8)
        self._col = 0

    def _emit(self, s: str) -> None:
        self.out.write(s)
        self._col += len(s)
        if self._col >= self.width:
            self.out.write("\n")
            self._col = 0

    def read_bit(self) -> int:
        v = self.d.read_bit()
        self._emit(f"{v}")
        return v

    def read_bits(self, n: int) -> int:
        v = self.d.read_bits(n)
        if self.hexa:
            self._emit(f"[{v:0{(n + 3) // 4}X}:{n}] ")
        else:
            self._emit(format(v, f"0{n}b") + " ")
        return v

    def read_bytes(self, n: int) -> bytes:
        v = self.d.read_bytes(n)
        self._emit(bytes(v).hex().upper() + " ")
        return v

    def __getattr__(self, name):
        return getattr(self.d, name)
