"""Transform chain with per-stage skip flags.

Mirrors TransformSequence<T> (src/transform/TransformSequence.hpp:88-247):
up to 8 stages run in order; a stage whose forward fails is recorded in an
8-bit skip mask (bit (7-i) CLEAR means stage i ran; SKIP_MASK=0xFF means
nothing ran). The inverse runs un-skipped stages in reverse. Each stage's
forward, and each inverse that runs, is a span (core/trace.py):
transform.<stage>.forward or .inverse, <stage> the factory's name in lower
case, its kept attribute False where the stage's output was thrown away.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from kanzi_tpu_torch.core import trace
from kanzi_tpu_torch.transform.base import ByteTransform, as_u8

SKIP_MASK = 0xFF


class TransformSequence:
    def __init__(self, transforms: List[ByteTransform], names: List[str]):
        """names: each stage's name in its spans."""
        if not 1 <= len(transforms) <= 8:
            raise ValueError("1..8 transforms required")
        self.transforms = transforms
        self.names = names
        self.skip_flags = SKIP_MASK

    def __len__(self) -> int:
        return len(self.transforms)

    def forward(self, src: np.ndarray, input_capacity: int = 0,
                output_capacity: int = 0) -> Optional[np.ndarray]:
        """Apply all stages; returns transformed bytes (skip_flags records
        which stages ran). Returns the input copy if every stage skipped
        (caller checks skip_flags == SKIP_MASK, reference returns false).

        Capacity protocol (TransformSequence.hpp:104-146): stages ping-pong
        between the container's input buffer and the task's work buffer
        (both persist and only grow across blocks, so callers thread the
        slot's current capacities in). A stage whose output capacity is
        below requiredSize gets a fresh requiredSize buffer. Capacity-gated
        transforms (e.g. ZRLT) skip based on this exact output capacity.

        Final copy-back rule (:148-157): after an even number of successful
        stages the result is copied back to the output buffer; if it no
        longer fits, the reference sets SKIP_MASK *but still emits the
        stale expanded buffer, producing a stream its own decoder rejects*.
        We keep the SKIP_MASK decision and return the original input — a
        valid all-skipped block the reference decoder handles.
        """
        data = as_u8(src)
        self.skip_flags = SKIP_MASK
        required = self.max_encoded_length(len(data))
        orig_cap_out = max(output_capacity, required)
        caps = [max(input_capacity, len(data)), orig_cap_out]
        swaps = 0
        ran = []                     # the spans of the stages that ran
        for i, t in enumerate(self.transforms):
            if caps[1] < required:
                caps[1] = required  # fresh requiredSize buffer
            t.output_capacity = caps[1]
            with trace.span("transform." + self.names[i] + ".forward",
                            bytes_in=len(data)) as sp:
                out = t.forward(data)
                if sp:
                    sp.set(bytes_out=0 if out is None else len(out),
                           kept=out is not None)
                    ran.append(sp)
            if out is None:
                continue  # stage skipped, flag bit stays set
            self.skip_flags &= ~(1 << (7 - i)) & 0xFF
            data = out
            caps.reverse()
            swaps += 1
        if (swaps & 1) == 0 and len(data) > orig_cap_out:
            self.skip_flags = SKIP_MASK
            for sp in ran:           # every stage's output thrown away
                sp.set(kept=False)
            return as_u8(src)
        return data

    def _inverse(self, i: int, data: np.ndarray) -> np.ndarray:
        """Stage i's inverse, in its span."""
        with trace.span("transform." + self.names[i] + ".inverse",
                        bytes_in=len(data), kept=True) as sp:
            data = self.transforms[i].inverse(data)
            if sp:
                sp.set(bytes_out=len(data))
        return data

    def inverse(self, src: np.ndarray) -> np.ndarray:
        data = as_u8(src)
        if self.skip_flags == SKIP_MASK:
            return data.copy()
        for i in range(len(self.transforms) - 1, -1, -1):
            if self.skip_flags & (1 << (7 - i)):
                continue
            data = self._inverse(i, data)
        return data

    def inverse_into(self, src: np.ndarray, out: np.ndarray):
        """Inverse chain with the FINAL active stage writing straight
        into `out` (a view of the caller's result buffer) — saves the
        full-block staging copy for the common decode path. Returns the
        output length, or None when `out` is too small (caller falls
        back to inverse())."""
        data = as_u8(src)
        if self.skip_flags == SKIP_MASK:
            if data.size > out.size:
                return None
            out[:data.size] = data
            return data.size
        active = [i for i in range(len(self.transforms))
                  if not (self.skip_flags & (1 << (7 - i)))]
        for i in reversed(active[1:]):
            data = self._inverse(i, data)
        fn = getattr(self.transforms[active[0]], "inverse_into", None)
        if fn is not None:
            with trace.span("transform." + self.names[active[0]] + ".inverse",
                            bytes_in=len(data), kept=True) as sp:
                n = fn(data, out)
                if sp:
                    sp.set(bytes_out=n or 0)
            if n is not None:
                return n
        data = self._inverse(active[0], data)
        if data.size > out.size:
            return None
        out[:data.size] = data
        return data.size

    def max_encoded_length(self, src_len: int) -> int:
        required = src_len
        for t in self.transforms:
            nxt = t.max_encoded_length(required)
            if nxt > required:
                required = nxt
        return required
