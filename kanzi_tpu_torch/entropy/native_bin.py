"""Native-backed binary entropy coders (FPAQ / CM / TPAQ / TPAQX).

Same wire format as the Python golden models (entropy/binary.py,
entropy/fpaq.py — reference: src/entropy/BinaryEntropyEncoder.cpp:75-128,
FPAQEncoder.cpp): chunk framing (varint byte counts, 56-bit inter-chunk
flushes) stays here; the per-bit adaptive loops run in
native/bincoder.cpp with the coder state held in an opaque handle.

Set KANZI_TPU_NO_NATIVE=1 to force the pure-Python models (used by the
golden-equality tests)."""

from __future__ import annotations

import os

import numpy as np

from kanzi_tpu_torch.bitstream import BitReader, BitWriter
from kanzi_tpu_torch.entropy import utils as eu
from kanzi_tpu_torch.entropy.base import EntropyDecoder, EntropyEncoder
from kanzi_tpu_torch.entropy.binary import (MASK_0_24, MAX_BLOCK_SIZE,
                                      _chunk_length)
from kanzi_tpu_torch.utils import native

KIND_FPAQ = 0
KIND_CM = 1
KIND_TPAQ = 2
KIND_TPAQX = 3

FPAQ_CHUNK = 4 * 1024 * 1024


def native_bin_enabled() -> bool:
    return (not os.environ.get("KANZI_TPU_NO_NATIVE")
            and native.bincoder_available())


def _new_handle(kind: int, ctx):
    bs_version = 7 if ctx is None else ctx.get_int("bsVersion", 7)
    if kind in (KIND_TPAQ, KIND_TPAQX):
        from kanzi_tpu_torch.entropy.tpaq import compute_sizes
        sizes = compute_sizes(ctx, extra=(kind == KIND_TPAQX))
    else:
        sizes = (0, 0, 0, 0)
    return native.bincoder_new(kind, bs_version, *sizes)


class NativeBinEncoder(EntropyEncoder):
    """FPAQ uses 4 MiB chunks; the shell coders use _chunk_length(count)."""

    def __init__(self, obs: BitWriter, ctx, kind: int):
        super().__init__(obs, ctx)
        self.kind = kind
        self._h = _new_handle(kind, ctx)
        if self._h is None:
            raise RuntimeError("native bincoder unavailable")
        self._disposed = False

    def encode(self, block: np.ndarray) -> int:
        block = np.ascontiguousarray(block, dtype=np.uint8)
        count = len(block)
        if count >= MAX_BLOCK_SIZE:
            raise ValueError("Invalid block size parameter (max is 1<<30)")
        prep = getattr(self, "prepared_device", None)
        if prep is not None:
            # device-prepared payload: (chunk_bufs, boundary_lows,
            # final_low) — the framing (varint + payload + inter-chunk
            # low56) is identical for every binary coder, the producer
            # guarantees chunk boundaries match this kind's chunk size
            from kanzi_tpu_torch.entropy.fpaq import emit_prepared
            self._final_low = emit_prepared(self.obs, prep)
            return count
        length = FPAQ_CHUNK if self.kind == KIND_FPAQ else _chunk_length(count)
        start = 0
        while start < count:
            chunk_size = min(length, count - start)
            buf, n_out = native.bincoder_enc_chunk(
                self._h, block[start:start + chunk_size])
            if n_out < 0:
                raise ValueError("binary coder chunk overflow")
            eu.write_varint(self.obs, n_out)
            self.obs.write_bytes(buf[:n_out])
            start += chunk_size
            if start < count:
                self.obs.write_bits(
                    native.bincoder_get_low(self._h) | MASK_0_24, 56)
        return count

    def dispose(self) -> None:
        if self._disposed:
            return
        self._disposed = True
        low = getattr(self, "_final_low", None)
        if low is None:
            low = native.bincoder_get_low(self._h)
        self.obs.write_bits(low | MASK_0_24, 56)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h is not None:
            native.bincoder_free(h)
            self._h = None


class NativeBinDecoder(EntropyDecoder):
    def __init__(self, ibs: BitReader, ctx, kind: int):
        super().__init__(ibs, ctx)
        self.kind = kind
        self._h = _new_handle(kind, ctx)
        if self._h is None:
            raise RuntimeError("native bincoder unavailable")

    def decode(self, count: int) -> np.ndarray:
        if count >= MAX_BLOCK_SIZE:
            raise ValueError("Invalid block size parameter (max is 1<<30)")
        out = np.empty(count, dtype=np.uint8)
        length = (FPAQ_CHUNK if self.kind == KIND_FPAQ
                  else _chunk_length(count))
        start = 0
        while start < count:
            chunk_size = min(length, count - start)
            sz_bytes = eu.read_varint(self.ibs)
            if self.kind == KIND_FPAQ:
                if sz_bytes >= 2 * count:
                    raise ValueError("Invalid FPAQ chunk size")
            elif sz_bytes > min(chunk_size << 5, (1 << 32) >> 3):
                raise ValueError("Invalid binary entropy chunk size")
            current = self.ibs.read_bits(56)
            payload = np.frombuffer(
                self.ibs.read_bytes(sz_bytes) + b"\x00" * 8, dtype=np.uint8)
            rc = native.bincoder_dec_chunk(
                self._h, payload, sz_bytes, current,
                out[start:start + chunk_size])
            if rc != 0:
                raise ValueError("FPAQ payload overrun")
            start += chunk_size
        return out

    def __del__(self):
        h = getattr(self, "_h", None)
        if h is not None:
            native.bincoder_free(h)
            self._h = None
