"""Public API: kanzi-compatible Compressor/Decompressor classes.

Mirrors the reference's Python binding surface (src/api/kanzi.py:18-146
over the C API src/api/Compressor.hpp:59-117 / Decompressor.hpp):
file-handle lifecycle, per-call `compress(data)` with data no larger
than the block size, `close()` returning the total output size, and
headerless mode where the caller stores the stream parameters
out-of-band. Backed by the same block pipeline the CLI uses. Both
classes take the coding ``device`` (default: the CUDA device).
"""

from __future__ import annotations

from typing import Optional, Union

from kanzi_tpu_torch.core.context import Context
from kanzi_tpu_torch.io.compressed_stream import (FORMAT_VERSION, CompressedReader,
                                            CompressedWriter)

__all__ = ["Compressor", "Decompressor"]


def _as_str(v: Union[str, bytes]) -> str:
    return v.decode() if isinstance(v, (bytes, bytearray)) else str(v)


class Compressor:
    """Streaming compressor over a file path or binary file object.

    >>> with Compressor("out.knz", transform="LZ", entropy="HUFFMAN",
    ...                 block_size=1 << 20) as c:
    ...     c.compress(data)
    """

    def __init__(self, dst, transform: Union[str, bytes] = "LZ",
                 entropy: Union[str, bytes] = "HUFFMAN",
                 block_size: int = 1 << 20, jobs: int = 1,
                 checksum: int = 0, headerless: bool = False, device=None):
        if hasattr(dst, "write"):
            self._file = dst
            self._own = False
        else:
            self._file = open(dst, "wb")
            self._own = True
        self.block_size = block_size
        self._written = 0

        class _Counting:
            def __init__(self, f, parent):
                self.f = f
                self.parent = parent

            def write(self, b):
                self.parent._written += len(b)
                return self.f.write(b)

        self._writer = CompressedWriter(
            _Counting(self._file, self), transform=_as_str(transform),
            entropy=_as_str(entropy), block_size=block_size,
            checksum_bits=checksum, headerless=headerless, jobs=jobs,
            device=device)

    def compress(self, data: bytes) -> int:
        """Feed up to block_size bytes (C API contract,
        src/api/Compressor.hpp:96-104). Returns bytes written so far."""
        if len(data) > self.block_size:
            raise ValueError("compress() accepts at most block_size bytes "
                             "per call")
        self._writer.write(data)
        return self._written

    def close(self) -> int:
        """Flush + end-of-stream marker; returns total output size."""
        if self._writer is not None:
            self._writer.close()
            self._writer = None
            if self._own:
                self._file.close()
        return self._written

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class Decompressor:
    """Streaming decompressor over a file path or binary file object.

    Headerless streams need the parameters the header would carry
    (Decompressor C API: bsVersion/transform/entropy/blockSize/
    originalSize, src/api/Decompressor.hpp)."""

    def __init__(self, src, headerless: bool = False,
                 transform: Union[str, bytes] = "NONE",
                 entropy: Union[str, bytes] = "NONE",
                 block_size: int = 1 << 20, original_size: int = 0,
                 bs_version: int = FORMAT_VERSION, jobs: int = 1,
                 ctx: Optional[Context] = None, device=None):
        if hasattr(src, "read"):
            data = src.read()
            self._own = False
        else:
            with open(src, "rb") as f:
                data = f.read()
            self._own = True
        kwargs = {}
        if headerless:
            kwargs = dict(headerless=True, transform=_as_str(transform),
                          entropy=_as_str(entropy), block_size=block_size,
                          original_size=original_size,
                          bs_version=bs_version)
        self._reader = CompressedReader(data, jobs=jobs, ctx=ctx,
                                        device=device, **kwargs)
        self._result: Optional[bytes] = None

    def decompress(self, max_bytes: Optional[int] = None) -> bytes:
        """Decode the stream (whole-stream; a block-range variant is
        available via read_all(from_block, to_block))."""
        if self._result is None:
            self._result = self._reader.read_all()
        if max_bytes is None:
            return self._result
        return self._result[:max_bytes]

    def read_all(self, from_block: int = 1, to_block: int = (1 << 31) - 1):
        return self._reader.read_all(from_block, to_block)

    def close(self) -> None:
        self._reader = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False