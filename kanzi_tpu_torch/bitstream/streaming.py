"""Forward-streaming bit reader over a file object.

The container format is strictly forward-decodable (length-prefixed
blocks, src/io/CompressedInputStream.cpp:336-508 reads incrementally),
so the reader holds only a sliding byte window: bytes are pulled from the
underlying stream on demand and the consumed prefix is discarded once it
exceeds the trim threshold. Peak memory = O(block size), not O(file)."""

from __future__ import annotations

import numpy as np

from kanzi_tpu_torch.bitstream.reader import BitStreamError

_TRIM_BYTES = 8 * 1024 * 1024
_READ_CHUNK = 1024 * 1024


class StreamingBitReader:
    """Same interface as BitReader; seeks are limited to the buffered
    window (enough for the container's forward parse)."""

    __slots__ = ("_fp", "_buf", "_base", "_pos", "_eof")

    def __init__(self, fp) -> None:
        self._fp = fp
        self._buf = bytearray()
        self._base = 0          # absolute byte offset of _buf[0]
        self._pos = 0           # absolute bit position
        self._eof = False

    def _avail_bits(self) -> int:
        return 8 * (self._base + len(self._buf))

    def _fill(self, need_bytes: int) -> None:
        while not self._eof and self._base + len(self._buf) < need_bytes:
            chunk = self._fp.read(max(_READ_CHUNK,
                                      need_bytes - self._base
                                      - len(self._buf)))
            if not chunk:
                self._eof = True
                break
            self._buf += chunk

    def _ensure(self, nbits: int) -> None:
        end_byte = (self._pos + nbits + 7) >> 3
        if self._avail_bits() < self._pos + nbits:
            self._fill(end_byte)
            if self._avail_bits() < self._pos + nbits:
                raise BitStreamError("read past end of bitstream")
        # trim the consumed prefix
        consumed = (self._pos >> 3) - self._base
        if consumed > _TRIM_BYTES:
            del self._buf[:consumed]
            self._base += consumed

    def read_bit(self) -> int:
        self._ensure(1)
        b = self._buf[(self._pos >> 3) - self._base]
        bit = (b >> (7 - (self._pos & 7))) & 1
        self._pos += 1
        return bit

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        self._ensure(n)
        pos = self._pos
        self._pos = pos + n
        first = (pos >> 3) - self._base
        last = ((pos + n - 1) >> 3) - self._base
        chunk = int.from_bytes(bytes(self._buf[first:last + 1]), "big")
        tail = 8 * (last + 1 + self._base) - (pos + n)
        return (chunk >> tail) & ((1 << n) - 1)

    def read_bytes(self, count: int) -> bytes:
        self._ensure(8 * count)
        pos = self._pos
        self._pos = pos + 8 * count
        i = (pos >> 3) - self._base
        if (pos & 7) == 0:
            return bytes(self._buf[i:i + count])
        r = pos & 7
        arr = np.frombuffer(bytes(self._buf[i:i + count + 1]), np.uint8)
        out = ((arr[:-1] << np.uint8(r))
               | (arr[1:] >> np.uint8(8 - r))).astype(np.uint8)
        return out.tobytes()

    def read_bytes_np(self, count: int) -> np.ndarray:
        """Array variant of read_bytes (copies out of the sliding
        window; the window may be trimmed after this returns)."""
        self._ensure(8 * count)
        pos = self._pos
        self._pos = pos + 8 * count
        i = (pos >> 3) - self._base
        if (pos & 7) == 0:
            return np.frombuffer(self._buf, np.uint8, count, i).copy()
        r = pos & 7
        have = len(self._buf) - i
        if have >= count + 1:
            a = np.frombuffer(self._buf, np.uint8, count + 1, i)
        else:
            a = np.zeros(count + 1, np.uint8)
            a[:have] = np.frombuffer(self._buf, np.uint8, have, i)
        return ((a[:-1] << np.uint8(r))
                | (a[1:] >> np.uint8(8 - r))).astype(np.uint8)

    def read_payload(self, bits: int) -> np.ndarray:
        """Block-payload read, same contract as BitReader.read_payload
        (uint8 array of (bits+7)//8 bytes, final byte's low bits
        zeroed)."""
        if bits <= 0:
            return np.zeros(0, np.uint8)
        self._ensure(bits)
        pos = self._pos
        nbytes = (bits + 7) >> 3
        r = pos & 7
        i = (pos >> 3) - self._base
        if r == 0:
            arr = np.frombuffer(self._buf, np.uint8, nbytes, i).copy()
        else:
            have = len(self._buf) - i
            if have >= nbytes + 1:
                a = np.frombuffer(self._buf, np.uint8, nbytes + 1, i)
            else:
                a = np.zeros(nbytes + 1, np.uint8)
                a[:have] = np.frombuffer(self._buf, np.uint8, have, i)
            arr = ((a[:-1] << np.uint8(r))
                   | (a[1:] >> np.uint8(8 - r))).astype(np.uint8)
        if bits & 7:
            arr[nbytes - 1] &= (0xFF << (8 - (bits & 7))) & 0xFF
        self._pos = pos + bits
        return arr

    def tell(self) -> int:
        return self._pos

    def seek(self, bitpos: int) -> None:
        if bitpos < 8 * self._base:
            raise BitStreamError("seek before the streaming window")
        if bitpos > self._avail_bits():
            self._fill((bitpos + 7) >> 3)
            if bitpos > self._avail_bits():
                raise BitStreamError("seek out of range")
        self._pos = bitpos

    def remaining(self) -> int:
        # best effort: bits still buffered (more may arrive from the fp)
        return max(self._avail_bits() - self._pos, 0)

    def has_more(self) -> bool:
        if self._pos < self._avail_bits():
            return True
        self._fill((self._pos >> 3) + 1)
        return self._pos < self._avail_bits()
