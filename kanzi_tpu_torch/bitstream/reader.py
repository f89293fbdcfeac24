"""MSB-first bit reader, mirror of BitWriter.

Reference: src/bitstream/DefaultInputBitStream.{hpp,cpp}. Reading past the
end raises BitStreamError (the reference throws BitStreamException).
"""

from __future__ import annotations

import numpy as np


class BitStreamError(Exception):
    pass


def _shift_extract(buf, offset: int, n: int, r: int) -> np.ndarray:
    """n bytes starting r bits into buf[offset:]: one native C pass when
    available, else the 3-pass numpy shift."""
    if n >= 4096:
        try:
            from kanzi_tpu_torch.utils import native
            if native.transforms_available():
                return native.shift_bytes(buf, offset, n, r)
        except Exception:
            pass
    a = np.frombuffer(buf, np.uint8, n + 1, offset)
    return ((a[:-1] << np.uint8(r))
            | (a[1:] >> np.uint8(8 - r))).astype(np.uint8)


class BitReader:
    __slots__ = ("_data", "_pos", "_nbits")

    def __init__(self, data) -> None:
        # bytes and uint8 ndarrays are held as-is (zero-copy: block
        # payloads arrive as ndarray views sliced out of the container)
        if isinstance(data, np.ndarray):
            if data.dtype != np.uint8 or not data.flags.c_contiguous:
                data = np.ascontiguousarray(data, np.uint8)
        elif not isinstance(data, bytes):
            data = bytes(data)
        self._data = data
        self._nbits = 8 * len(self._data)
        self._pos = 0  # bit position

    def read_bit(self) -> int:
        if self._pos >= self._nbits:
            raise BitStreamError("read past end of bitstream")
        b = self._data[self._pos >> 3]
        bit = (b >> (7 - (self._pos & 7))) & 1
        self._pos += 1
        return bit

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        pos = self._pos
        if pos + n > self._nbits:
            raise BitStreamError("read past end of bitstream")
        self._pos = pos + n
        first = pos >> 3
        last = (pos + n - 1) >> 3
        chunk = int.from_bytes(self._data[first:last + 1], "big")
        tail = 8 * (last + 1) - (pos + n)
        return (chunk >> tail) & ((1 << n) - 1)

    def read_bytes(self, count: int) -> bytes:
        """Read count whole bytes (any bit alignment)."""
        pos = self._pos
        n = 8 * count
        if pos + n > self._nbits:
            raise BitStreamError("read past end of bitstream")
        self._pos = pos + n
        if (pos & 7) == 0:
            i = pos >> 3
            chunk = self._data[i:i + count]
            return chunk if isinstance(chunk, bytes) else chunk.tobytes()
        r = pos & 7
        i = pos >> 3
        arr = np.frombuffer(self._data, dtype=np.uint8, count=count + 1, offset=i)
        out = ((arr[:-1] << np.uint8(r)) | (arr[1:] >> np.uint8(8 - r))).astype(np.uint8)
        return out.tobytes()

    def read_bytes_np(self, count: int) -> np.ndarray:
        """Read count whole bytes as a uint8 array. Zero-copy view when
        byte-aligned over array-backed data; one vectorized shift pass
        otherwise (no bytes materialization — use instead of
        np.frombuffer(read_bytes(n)))."""
        pos = self._pos
        n = 8 * count
        if pos + n > self._nbits:
            raise BitStreamError("read past end of bitstream")
        self._pos = pos + n
        i = pos >> 3
        if (pos & 7) == 0:
            return np.frombuffer(self._data, np.uint8, count, i)
        return _shift_extract(self._data, i, count, pos & 7)

    def read_payload(self, bits: int) -> np.ndarray:
        """Read a `bits`-bit block payload in ONE vectorized pass as a
        uint8 array of (bits+7)//8 bytes, the final byte's unused low
        bits zeroed — the framing contract of read_blocks
        (CompressedInputStream.cpp:336-508 reads block payloads the same
        way). Replaces read_bytes(n-1) + a full-buffer concat of the
        tail byte (which copied every payload twice)."""
        if bits <= 0:
            return np.zeros(0, np.uint8)
        pos = self._pos
        if pos + bits > self._nbits:
            raise BitStreamError("read past end of bitstream")
        nbytes = (bits + 7) >> 3
        r = pos & 7
        i = pos >> 3
        if r == 0:
            arr = np.frombuffer(self._data, np.uint8, nbytes, i).copy()
        elif i + nbytes + 1 <= len(self._data):
            arr = _shift_extract(self._data, i, nbytes, r)
        else:
            # payload ends in the stream's final byte: widen via a
            # zero-padded copy (the shifted window needs one byte past
            # the end)
            a = np.frombuffer(self._data, np.uint8, len(self._data) - i, i)
            ext = np.zeros(nbytes + 1, np.uint8)
            ext[:len(a)] = a
            arr = ((ext[:-1] << np.uint8(r))
                   | (ext[1:] >> np.uint8(8 - r))).astype(np.uint8)
        if bits & 7:
            arr[nbytes - 1] &= (0xFF << (8 - (bits & 7))) & 0xFF
        self._pos = pos + bits
        return arr

    def tell(self) -> int:
        return self._pos

    def seek(self, bitpos: int) -> None:
        if not (0 <= bitpos <= self._nbits):
            raise BitStreamError("seek out of range")
        self._pos = bitpos

    def remaining(self) -> int:
        return self._nbits - self._pos

    def has_more(self) -> bool:
        return self._pos < self._nbits
