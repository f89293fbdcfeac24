"""Entropy coder contracts (src/EntropyEncoder.hpp:25-40, EntropyDecoder.hpp).

Encoders write a byte block into a BitWriter; decoders read a byte block
out of a BitReader. Per-block construction resets statistics (the
reference rebuilds coders per block). dispose() flushes trailing coder
state (arithmetic coders write final bits there).
"""

from __future__ import annotations

import numpy as np

from kanzi_tpu_torch.bitstream import BitReader, BitWriter
from kanzi_tpu_torch.core.context import Context


class EntropyEncoder:
    def __init__(self, obs: BitWriter, ctx: Context | None = None):
        self.obs = obs
        self.ctx = ctx if ctx is not None else Context()

    def encode(self, block: np.ndarray) -> int:
        """Encode block, return number of bytes consumed."""
        raise NotImplementedError

    def dispose(self) -> None:
        pass


class EntropyDecoder:
    def __init__(self, ibs: BitReader, ctx: Context | None = None):
        self.ibs = ibs
        self.ctx = ctx if ctx is not None else Context()

    def decode(self, count: int) -> np.ndarray:
        """Decode exactly count bytes."""
        raise NotImplementedError

    def dispose(self) -> None:
        pass
