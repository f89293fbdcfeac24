"""FPAQ order-0 binary arithmetic coder.

Reference: src/entropy/FPAQ{Encoder,Decoder}.{cpp,hpp}. 56-bit coder state,
32-bit flushes when the top 32 bits of low/high agree; probs[4][256]
(16-bit P(bit=1), ctx = top-2 bits of previous byte + bit-tree path);
4 MiB chunks, payload framed as varint byte-count + payload; the first 56
bits of each chunk's arithmetic stream are read directly as the initial
'current' value (FPAQDecoder.cpp:64-71).

Host golden implementation (scalar). Where a writer batch holds enough
FPAQ blocks to beat the host coder, the container encodes them on the
CUDA card instead, one stream per block
(io.compressed_stream.prepare_fpaq_batch, ops.fpaq), and hands each
encoder the result (emit_prepared). The decoder reads the chunk framing
and, with a sink in the context ("_fpaqDecodeSink", the level-6 mesh
decode's), queues each chunk's primed current and payload there in
place of decoding it.
"""

from __future__ import annotations

import numpy as np

from kanzi_tpu_torch.bitstream import BitReader, BitWriter
from kanzi_tpu_torch.entropy import utils as eu
from kanzi_tpu_torch.entropy.base import EntropyDecoder, EntropyEncoder

TOP = 0x00FFFFFFFFFFFFFF
MASK_0_24 = 0x0000000000FFFFFF
MASK_0_32 = 0x00000000FFFFFFFF
MASK_0_56 = 0x00FFFFFFFFFFFFFF
DEFAULT_CHUNK_SIZE = 4 * 1024 * 1024
MAX_BLOCK_SIZE = 1 << 30
PSCALE = 65536


def emit_prepared(obs: BitWriter, prep) -> int:
    """Write a device-encoded FPAQ entropy payload. prep = (chunk_bufs,
    boundary_low56s, final_low56) from
    io.compressed_stream.prepare_fpaq_batch — the exact bytes + 56-bit
    inter-chunk flushes the scalar coder would emit (FPAQEncoder.cpp
    chunk framing). Returns the final low for dispose()."""
    chunk_bufs, bound_lows, final_low = prep
    for i, buf in enumerate(chunk_bufs):
        eu.write_varint(obs, len(buf))
        obs.write_bytes(buf)
        if i + 1 < len(chunk_bufs):
            obs.write_bits(bound_lows[i], 56)
    return final_low


class FPAQEncoder(EntropyEncoder):
    def __init__(self, obs: BitWriter, ctx=None):
        super().__init__(obs, ctx)
        self._low = 0
        self._high = TOP
        self._disposed = False
        self._probs = [[PSCALE >> 1] * 256 for _ in range(4)]
        self._buf = bytearray()

    def encode(self, block: np.ndarray) -> int:
        block = np.asarray(block, dtype=np.uint8)
        count = len(block)
        if count >= MAX_BLOCK_SIZE:
            raise ValueError("Invalid block size parameter (max is 1<<30)")
        prep = getattr(self, "prepared_device", None)
        if prep is not None:
            self._low = emit_prepared(self.obs, prep)
            return count
        start = 0
        data = block.tolist()
        while start < count:
            chunk_size = min(DEFAULT_CHUNK_SIZE, count - start)
            self._buf = bytearray()
            p = self._probs[0]
            low = self._low
            high = self._high
            buf = self._buf
            for i in range(start, start + chunk_size):
                val = data[i]
                bits = val + 256
                for sh in (7, 6, 5, 4, 3, 2, 1, 0):
                    ctx = bits >> (sh + 1)
                    prob = p[ctx]
                    bit = (val >> sh) & 1
                    if bit == 0:
                        low = low + ((((high - low) >> 8) * prob) >> 8) + 1
                        p[ctx] = prob - (prob >> 6)
                    else:
                        high = low + ((((high - low) >> 8) * prob) >> 8)
                        p[ctx] = prob - ((prob - PSCALE + 64) >> 6)
                    if ((low ^ high) >> 24) == 0:
                        buf += ((high >> 24) & MASK_0_32).to_bytes(4, "big")
                        low = (low << 32) & MASK_0_56
                        high = ((high << 32) | MASK_0_32) & MASK_0_56
                p = self._probs[val >> 6]
            self._low = low
            self._high = high
            eu.write_varint(self.obs, len(buf))
            self.obs.write_bytes(bytes(buf))
            start += chunk_size
            if start < count:
                self.obs.write_bits(self._low | MASK_0_24, 56)
        return count

    def dispose(self) -> None:
        if self._disposed:
            return
        self._disposed = True
        self.obs.write_bits(self._low | MASK_0_24, 56)


class FPAQDecoder(EntropyDecoder):
    def __init__(self, ibs: BitReader, ctx=None):
        super().__init__(ibs, ctx)
        self._probs = [[PSCALE >> 1] * 256 for _ in range(4)]
        self._low = 0
        self._high = TOP  # persists across chunks (FPAQDecoder::reset)

    def decode(self, count: int) -> np.ndarray:
        if count >= MAX_BLOCK_SIZE:
            raise ValueError("Invalid block size parameter (max is 1<<30)")
        out = np.empty(count, dtype=np.uint8)
        sink = self.ctx.get("_fpaqDecodeSink") if self.ctx else None
        queued = []         # with a sink: (current, payload bytes) a chunk
        start = 0
        while start < count:
            sz_bytes = eu.read_varint(self.ibs)
            if sz_bytes >= 2 * count:
                raise ValueError("Invalid FPAQ chunk size")
            current = self.ibs.read_bits(56)
            if sink is not None:
                queued.append((current, self.ibs.read_bytes(sz_bytes)))
                start += min(DEFAULT_CHUNK_SIZE, count - start)
                continue
            buf = self.ibs.read_bytes(sz_bytes) + b"\x00" * 8
            low = self._low
            high = self._high
            index = 0
            buf_limit = sz_bytes
            chunk_size = min(DEFAULT_CHUNK_SIZE, count - start)
            p = self._probs[0]
            probs = self._probs
            for i in range(start, start + chunk_size):
                ctx = 1
                for _ in range(8):
                    prob = p[ctx]
                    split = ((((high - low) >> 8) * prob) >> 8) + low
                    if split >= current:
                        high = split
                        p[ctx] = prob - ((prob - PSCALE + 64) >> 6)
                        ctx += ctx + 1
                    else:
                        low = split + 1
                        p[ctx] = prob - (prob >> 6)
                        ctx += ctx
                    if ((low ^ high) >> 24) == 0:
                        low = (low << 32) & MASK_0_56
                        high = ((high << 32) | MASK_0_32) & MASK_0_56
                        if index + 4 > buf_limit:
                            current = (current << 32) & MASK_0_56
                            index = buf_limit + 1
                        else:
                            val = int.from_bytes(buf[index:index + 4], "big")
                            current = ((current << 32) | val) & MASK_0_56
                            index += 4
                out[i] = ctx & 0xFF
                if index > sz_bytes + 1:
                    raise ValueError("FPAQ payload overrun")
                p = probs[(ctx & 0xFF) >> 6]
            self._low = low
            self._high = high
            start += chunk_size
        if sink is not None:
            # the sink's owner decodes every queued block, one stream a
            # block, in one call (parallel.pipeline, kernel H): out stays
            # unfilled until then
            sink.append((out, queued))
        return out
