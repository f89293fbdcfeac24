"""Suffix array + BWT construction.

The reference uses Yuta Mori's DivSufSort (src/transform/DivSufSort.cpp,
2553 lines of induced sorting). The suffix array of a string is unique,
so we are free to build it with a TPU-friendly algorithm and still get
bit-identical BWT output: prefix-doubling with radix (lex) sorts — O(n
log^2 n) fully vectorized numpy here, and the same formulation maps to
on-device sorts in the Pallas path.

computeBWT semantics (DivSufSort.cpp:171-290):
- out[0] = src[n-1]; for SA rank j != pIdx: bwt[j] = src[SA[j]-1];
  out[1..pIdx] = bwt[0..pIdx-1], out[pIdx+1..] = bwt[pIdx+1..] where
  pIdx = rank of suffix 0.
- indexes[t] = rank(suffix t*step) + 1 with step = ceil(n/idxCount)
  (exactly: st = n/idxCount, step = st if idxCount*st==n else st+1),
  EXCEPT t*step == n-1 with src[n-2] < src[n-1] which stores n
  (constructBWT :245-253 consumes that suffix before the rank scan).
"""

from __future__ import annotations

import numpy as np


def suffix_array(s: np.ndarray) -> np.ndarray:
    """Suffix array (ascending suffix order): native SA-IS
    (native/sais.cpp) when available, else prefix doubling in numpy."""
    s = np.asarray(s, dtype=np.uint8)
    n = len(s)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n == 1:
        return np.zeros(1, dtype=np.int64)
    from kanzi_tpu_torch.utils import native
    if native.sais_available():
        return native.suffix_array(s).astype(np.int64)
    rank = s.astype(np.int64)
    k = 1
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[:n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        r1 = rank[order]
        r2 = key2[order]
        changed = np.empty(n, dtype=np.int64)
        changed[0] = 0
        changed[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new_rank_sorted = np.cumsum(changed)
        if new_rank_sorted[-1] == n - 1:
            return order
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_rank_sorted
        k <<= 1
        if k >= n:
            # all ranks distinct is guaranteed once k >= n
            return np.lexsort((np.arange(n), rank))


def compute_bwt(src: np.ndarray, idx_count: int):
    """Returns (bwt_output uint8[n], indexes list[idx_count])."""
    src = np.asarray(src, dtype=np.uint8)
    n = len(src)
    from kanzi_tpu_torch.utils import native
    if n > 1 and native.sais_available():
        out, indexes = native.bwt_forward(src, idx_count)
        return out, indexes
    sa = suffix_array(src)
    rank = np.empty(n, dtype=np.int64)
    rank[sa] = np.arange(n)

    st = n // idx_count
    step = st if idx_count * st == n else st + 1
    indexes = [int(rank[t * step]) + 1 for t in range(idx_count)]
    if (n - 1) % step == 0 and (n - 1) // step < idx_count and n >= 2 \
            and src[n - 2] < src[n - 1]:
        indexes[(n - 1) // step] = n

    p_idx = int(rank[0])
    out = np.empty(n, dtype=np.uint8)
    out[0] = src[n - 1]
    # bwt[j] = src[sa[j]-1] for j != p_idx
    prev = src[sa - 1]  # sa==0 gives src[-1], masked out below
    out[1:p_idx + 1] = prev[:p_idx]
    out[p_idx + 1:] = prev[p_idx + 1:]
    return out, indexes
