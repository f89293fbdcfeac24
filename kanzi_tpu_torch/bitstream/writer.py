"""MSB-first bit writer, wire-compatible with the reference bitstream.

The reference (src/bitstream/DefaultOutputBitStream.hpp:97-119) packs the
n low bits of each value MSB-first into a big-endian 64-bit accumulator
spilled to a byte buffer; the net effect is a single MSB-first bit stream.
`close()` zero-pads the final partial byte
(src/bitstream/DefaultOutputBitStream.cpp:141-149).

This implementation reproduces the bit stream (not the accumulator): bits
accumulate in a Python int and spill to a bytearray; bulk byte-array
writes use numpy shifting so multi-MiB payloads stay vectorized.
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    __slots__ = ("_buf", "_acc", "_nbits", "_pos", "_sink", "_drained")

    def __init__(self, sink=None) -> None:
        """sink: optional binary file object. When set, accumulated
        whole bytes are streamed to it once the internal buffer exceeds
        ~1 MiB (the reference's DefaultOutputBitStream flushes to its
        OutputStream the same way) — O(1) memory and no final full-size
        copy. Seeking backwards past drained bytes is then impossible."""
        self._buf = bytearray()
        self._acc = 0       # pending bits, MSB side = oldest
        self._nbits = 0     # number of pending bits in _acc (< 8 after flush)
        self._pos = 0       # byte write cursor (== len(_buf) unless seek'd)
        self._sink = sink
        self._drained = 0   # bytes already written to sink

    def _maybe_drain(self) -> None:
        if (self._sink is not None and len(self._buf) >= (1 << 20)
                and self._pos == len(self._buf)):
            self._sink.write(self._buf)
            self._drained += len(self._buf)
            self._buf = bytearray()
            self._pos = 0

    def close_to_sink(self) -> int:
        """Zero-pad the final partial byte and flush everything to the
        sink. Returns total bytes written to the sink."""
        if self._nbits:
            pad = 8 - self._nbits
            self._acc <<= pad
            self._nbits = 8
            self._flush_bytes()
        if self._buf:
            self._sink.write(self._buf)
            self._drained += len(self._buf)
            self._buf = bytearray()
            self._pos = 0
        return self._drained

    def _emit(self, data) -> None:
        """Write bytes at the cursor, overwriting then extending.
        Accepts bytes or uint8 ndarrays (appended via the buffer
        protocol, no intermediate bytes object)."""
        if isinstance(data, np.ndarray):
            data = memoryview(data)   # bytearray += ndarray would
        #                               broadcast instead of append
        if self._pos == len(self._buf):
            self._buf += data
            self._pos = len(self._buf)
            self._maybe_drain()
            return
        data = bytes(data)
        end = self._pos + len(data)
        if end <= len(self._buf):
            self._buf[self._pos:end] = data
        else:
            keep = len(self._buf) - self._pos
            self._buf[self._pos:] = data[:keep]
            self._buf += data[keep:]
        self._pos = end

    def write_bit(self, bit: int) -> None:
        self._acc = (self._acc << 1) | (bit & 1)
        self._nbits += 1
        if self._nbits >= 8:
            self._flush_bytes()

    def write_bits(self, value: int, n: int) -> None:
        """Write the n low bits of value, MSB-first. n in [0, 64+]."""
        if n == 0:
            return
        self._acc = (self._acc << n) | (value & ((1 << n) - 1))
        self._nbits += n
        if self._nbits >= 8:
            self._flush_bytes()

    def _flush_bytes(self) -> None:
        nbytes = self._nbits >> 3
        rem = self._nbits & 7
        top = self._acc >> rem
        self._emit(top.to_bytes(nbytes, "big"))
        self._acc &= (1 << rem) - 1
        self._nbits = rem

    def write_bytes(self, data) -> None:
        """Bulk write of whole bytes (bit count = 8*len), any alignment.
        Accepts bytes or uint8 ndarrays (zero-copy)."""
        if isinstance(data, np.ndarray):
            if data.dtype != np.uint8 or not data.flags.c_contiguous:
                data = np.ascontiguousarray(data, np.uint8)
        else:
            data = bytes(data)
        if len(data) == 0:
            return
        if self._nbits == 0:
            self._emit(data)
            return
        r = self._nbits
        arr = np.frombuffer(data, dtype=np.uint8)
        # carry chain: out[i] = pending-bits | arr[i] >> r; equivalently
        # out[i] = v[i] << (8-r) | v[i+1] >> r with v = [acc] + arr --
        # i.e. one kz_shift_bytes pass at shift 8-r
        out = np.empty(len(arr), dtype=np.uint8)
        first = np.uint8((self._acc << (8 - r)) & 0xFF)
        out[0] = first | (arr[0] >> np.uint8(r))
        if len(arr) > 1:
            n1 = len(arr) - 1
            done = False
            if n1 >= 4096:
                try:
                    from kanzi_tpu_torch.utils import native
                    if native.transforms_available():
                        native.shift_bytes(data, 0, n1, 8 - r,
                                           out=out[1:])
                        done = True
                except Exception:
                    pass
            if not done:
                hi = (arr >> np.uint8(r)).astype(np.uint8)
                lo = (arr << np.uint8(8 - r)).astype(np.uint8)
                out[1:] = lo[:-1] | hi[1:]
        self._emit(out)
        self._acc = int(arr[-1]) & ((1 << r) - 1)
        # _nbits unchanged (still r pending bits)

    def write_bits_array(self, values: np.ndarray, nbits: np.ndarray) -> None:
        """Vectorized write of many (value, nbits) pairs in order.

        values: uint64 array; nbits: int array (0..32 each). Produces the
        identical stream to sequential write_bits calls.
        """
        values = np.asarray(values, dtype=np.uint64)
        nbits = np.asarray(nbits, dtype=np.int64)
        total = int(nbits.sum())
        if total == 0:
            return
        # bit start offsets
        starts = np.concatenate(([0], np.cumsum(nbits)[:-1]))
        nbytes = (total + 7) >> 3
        # place each value's bits into a big bit buffer via 128-bit safe math:
        # use python-int path only when small; else chunked numpy approach.
        # Simple robust approach: build per-value byte spans with shifts.
        bitbuf = np.zeros(nbytes + 16, dtype=np.uint8)
        # positions
        for v, s, n in zip(values.tolist(), starts.tolist(), nbits.tolist()):
            if n == 0:
                continue
            end = s + n
            # write bits [s, end) of stream = n low bits of v MSB-first
            byte0 = s >> 3
            bitoff = s & 7
            span = (bitoff + n + 7) >> 3
            chunk = (v & ((1 << n) - 1)) << ((span << 3) - bitoff - n)
            b = chunk.to_bytes(span, "big")
            for i in range(span):
                bitbuf[byte0 + i] |= b[i]
        self._append_bit_run(bitbuf[:nbytes].tobytes(), total)

    def _append_bit_run(self, data, nbits_total: int) -> None:
        """Append the first nbits_total bits of data (MSB-first).
        data: bytes or uint8 ndarray."""
        full = nbits_total >> 3
        rem = nbits_total & 7
        if full:
            arr = (data[:full] if isinstance(data, np.ndarray)
                   else np.frombuffer(data, np.uint8, full))
            self.write_bytes(arr)
        if rem:
            self.write_bits(int(data[full]) >> (8 - rem), rem)

    def written(self) -> int:
        """Bits written so far (including pending)."""
        return 8 * (self._drained + len(self._buf)) + self._nbits

    def tell(self) -> int:
        """Current bit position incl. pending bits (Seekable, reference
        DefaultOutputBitStream::tell :134-142)."""
        return 8 * (self._drained + self._pos) + self._nbits

    def seek(self, bitpos: int) -> bool:
        """Byte-aligned reposition; subsequent writes overwrite in place
        (DefaultOutputBitStream::seek :145-170 semantics: whole pending
        bytes are flushed, sub-byte remainder bits are discarded)."""
        if bitpos < 0 or (bitpos & 7) != 0:
            return False
        bitpos -= 8 * self._drained
        if bitpos < 0:
            return False            # already streamed to the sink
        nbytes = self._nbits >> 3
        if nbytes:
            self._emit((self._acc >> (self._nbits & 7))
                       .to_bytes(nbytes, "big"))
        self._acc = 0
        self._nbits = 0
        target = bitpos >> 3
        if target > len(self._buf):
            self._buf += bytes(target - len(self._buf))
        self._pos = target
        return True

    def getvalue(self) -> bytes:
        """Close: zero-pad last partial byte and return the byte stream."""
        if self._nbits:
            pad = 8 - self._nbits
            self._acc <<= pad
            self._nbits = 8
            self._flush_bytes()
        return bytes(self._buf)

    def getarray(self) -> np.ndarray:
        """getvalue without the copy: a uint8 view of the stream
        buffer. Only for writers that receive no further writes (the
        view pins the buffer against resize)."""
        if self._nbits:
            pad = 8 - self._nbits
            self._acc <<= pad
            self._nbits = 8
            self._flush_bytes()
        return np.frombuffer(self._buf, np.uint8)
