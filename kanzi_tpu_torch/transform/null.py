"""Identity transform (src/transform/NullTransform.hpp)."""

from __future__ import annotations

import numpy as np

from kanzi_tpu_torch.transform.base import ByteTransform, as_u8


class NullTransform(ByteTransform):
    def forward(self, src: np.ndarray) -> np.ndarray:
        return as_u8(src).copy()

    def inverse(self, src: np.ndarray) -> np.ndarray:
        return as_u8(src).copy()

    def inverse_into(self, src: np.ndarray, out: np.ndarray):
        src = as_u8(src)
        if src.size > out.size:
            return None
        out[:src.size] = src
        return src.size

    def max_encoded_length(self, src_len: int) -> int:
        return src_len
