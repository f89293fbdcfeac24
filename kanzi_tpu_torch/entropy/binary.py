"""56-bit binary arithmetic shell + Predictor contract.

Reference: src/entropy/BinaryEntropy{Encoder,Decoder}.{cpp,hpp} and
src/Predictor.hpp. The shell pairs with any Predictor (CM/TPAQ/TPAQX):
split = low + (((high-low) >> 4) * p12) >> 8, 32-bit flush when the top
32 of the 56-bit bounds agree. Chunks <= 2^26 with varint byte counts;
56-bit state flush between chunks and at dispose().
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
MAX_BLOCK_SIZE = 1 << 30
MAX_CHUNK_SIZE = 1 << 26


class Predictor:
    """Adaptive bit model: update(bit), get() -> P(bit=1) in [0..4095]."""

    def update(self, bit: int) -> None:
        raise NotImplementedError

    def get(self) -> int:
        raise NotImplementedError


def _chunk_length(count: int) -> int:
    length = max(count, 64)
    if length >= MAX_CHUNK_SIZE:
        length = count >> 3 if (length // 8) < MAX_CHUNK_SIZE else count >> 4
    return length


class BinaryEntropyEncoder(EntropyEncoder):
    def __init__(self, obs: BitWriter, ctx, predictor: Predictor):
        super().__init__(obs, ctx)
        self.predictor = predictor
        self._low = 0
        self._high = TOP
        self._disposed = False

    def encode(self, block: np.ndarray) -> int:
        block = np.asarray(block, dtype=np.uint8)
        count = len(block)
        if count >= MAX_BLOCK_SIZE:
            raise ValueError("Invalid block size parameter (max is 1<<30)")
        prep = getattr(self, "prepared_device", None)
        if prep is not None:
            from kanzi_tpu_torch.entropy.fpaq import emit_prepared
            self._low = emit_prepared(self.obs, prep)
            return count
        length = _chunk_length(count)
        data = block.tolist()
        start = 0
        pred = self.predictor
        while start < count:
            chunk_size = min(length, count - start)
            buf = bytearray()
            low = self._low
            high = self._high
            for i in range(start, start + chunk_size):
                val = data[i]
                for sh in (7, 6, 5, 4, 3, 2, 1, 0):
                    bit = (val >> sh) & 1
                    mid = low + ((((high - low) >> 4) * pred.get()) >> 8)
                    if bit:
                        high = mid
                    else:
                        low = mid + 1
                    pred.update(bit)
                    if ((low ^ high) >> 24) == 0:
                        buf += ((high >> 24) & MASK_0_32).to_bytes(4, "big")
                        low = (low << 32) & MASK_0_56
                        high = ((high << 32) | MASK_0_32) & MASK_0_56
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


class BinaryEntropyDecoder(EntropyDecoder):
    def __init__(self, ibs: BitReader, ctx, predictor: Predictor):
        super().__init__(ibs, ctx)
        self.predictor = predictor
        self._low = 0
        self._high = TOP

    def _cm_sink(self, count: int):
        """The level-7 mesh decode's sink ("_cmDecodeSink" in the
        context) where the predictor is CM and the block one chunk (count
        below 2^26): the decoder then reads the chunk's framing and
        queues (out, current, payload bytes, bsVersion) there. A CM block
        that the sink cannot take is decoded here and counted as
        cm_host_blocks."""
        sink = self.ctx.get("_cmDecodeSink") if self.ctx else None
        if sink is None:
            return None
        from kanzi_tpu_torch.entropy.cm import CMPredictor
        if not isinstance(self.predictor, CMPredictor):
            return None
        if count >= MAX_CHUNK_SIZE:
            from kanzi_tpu_torch import ops
            ops.count("cm_host_blocks")
            return None
        return sink

    def decode(self, count: int) -> np.ndarray:
        if count >= MAX_BLOCK_SIZE:
            raise ValueError("Invalid block size parameter (max is 1<<30)")
        out = np.empty(count, dtype=np.uint8)
        sink = self._cm_sink(count)
        length = _chunk_length(count)
        start = 0
        pred = self.predictor
        while start < count:
            chunk_size = min(length, count - start)
            sz_bytes = eu.read_varint(self.ibs)
            if sz_bytes > min(chunk_size << 5, (1 << 32) >> 3):
                raise ValueError("Invalid binary entropy chunk size")
            current = self.ibs.read_bits(56)
            if sink is not None:
                # the sink's owner decodes every queued block, one stream a
                # block, in one call (parallel.pipeline, kernel J): out
                # stays unfilled until then
                sink.append((out, current, self.ibs.read_bytes(sz_bytes),
                             pred.bs_version))
                return out
            buf = self.ibs.read_bytes(sz_bytes) + b"\x00" * 8
            low = self._low
            high = self._high
            index = 0
            for i in range(start, start + chunk_size):
                val = 0
                for _ in range(8):
                    split = ((((high - low) >> 4) * pred.get()) >> 8) + low
                    if split >= current:
                        bit = 1
                        high = split
                    else:
                        bit = 0
                        low = split + 1
                    pred.update(bit)
                    val = (val << 1) | bit
                    if ((low ^ high) >> 24) == 0:
                        low = (low << 32) & MASK_0_56
                        high = ((high << 32) | MASK_0_32) & MASK_0_56
                        v = int.from_bytes(buf[index:index + 4], "big")
                        current = ((current << 32) | v) & MASK_0_56
                        index += 4
                out[i] = val
            self._low = low
            self._high = high
            start += chunk_size
        return out
