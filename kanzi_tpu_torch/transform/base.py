"""Transform contract.

The reference contract is Transform<T>::forward/inverse over SliceArrays
(src/Transform.hpp:30-48): forward may *fail* (return false), which the
sequence records as a skipped stage. We express the same as:

- forward(src) -> np.ndarray(uint8) or None   (None == stage skipped)
- inverse(src, original_size) -> np.ndarray(uint8)  (raises on corrupt data)
- max_encoded_length(n) -> int   (worst-case forward output size)

Transforms are constructed per block with a Context carrying hints
(dataType, blockSize, entropy, bsVersion) — the blackboard pattern of the
reference. original_size on inverse is the known post-inverse byte count
when the container provides it (the reference passes output capacity).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from kanzi_tpu_torch.core.context import Context


class ByteTransform:
    def __init__(self, ctx: Optional[Context] = None):
        self.ctx = ctx if ctx is not None else Context()
        # Output buffer capacity for the current forward call, set by
        # TransformSequence (capacity-gated transforms consult this; the
        # reference checks output._length during forward)
        self.output_capacity: Optional[int] = None

    def capacity_for(self, src_len: int) -> int:
        if self.output_capacity is not None:
            return self.output_capacity
        return self.max_encoded_length(src_len)

    def forward(self, src: np.ndarray) -> Optional[np.ndarray]:
        raise NotImplementedError

    def inverse(self, src: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def max_encoded_length(self, src_len: int) -> int:
        return src_len


def as_u8(data) -> np.ndarray:
    a = np.asarray(data, dtype=np.uint8)
    return np.ascontiguousarray(a)
