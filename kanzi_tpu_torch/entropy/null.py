"""Pass-through entropy coder (src/entropy/NullEntropy{Encoder,Decoder}.hpp)."""

from __future__ import annotations

import numpy as np

from kanzi_tpu_torch.entropy.base import EntropyDecoder, EntropyEncoder


class NullEntropyEncoder(EntropyEncoder):
    def encode(self, block: np.ndarray) -> int:
        data = np.asarray(block, dtype=np.uint8).tobytes()
        self.obs.write_bytes(data)
        return len(data)


class NullEntropyDecoder(EntropyDecoder):
    def decode(self, count: int) -> np.ndarray:
        return self.ibs.read_bytes_np(count)
