"""Suffix array, BWT forward and BWT inverse as torch ops on an explicit
device.

The PyTorch counterpart of kanzi_tpu/ops/bwt.py. The suffix array is
unique, so any algorithm reproduces the reference's BWT bytes exactly
(reference: Yuta Mori's DivSufSort, src/transform/DivSufSort.cpp:171-290;
kanzi_tpu_torch/transform/divsufsort.py). These are XLA stages in the JAX
package, with no Pallas kernel, so torch ops are their port. Every
function takes a batch of same-length blocks, [B, n] uint8, so that the
device level-5 chain (kanzi_tpu_torch/parallel/pipeline.py) runs all of
its binary blocks in one pass. Every other BWT forward (kanzi_tpu_torch/
transform/bwt.py bwt_forward: the host chains, the level-5 chain's text
and tail blocks) runs bwt_forward here, one block at a time, on a card
from the block size at which it beats native SA-IS (BWT_DEVICE_MIN_BLOCK
there) where its peak fits, and native SA-IS otherwise; the inverse
stays native outside the level-5 chain.

Forward, prefix doubling with one sort a round:

  rank <- dense rank of 2-byte keys (second byte absent past the end)
  repeat while any rank is shared (at most log2(n) rounds):
      key = rank[i] << b | (rank[i+k] + 1, or 0 past the end)
      sort all blocks' keys at once (the block id above the key bits)
      rank <- dense rank in sorted order, scattered back by position
  bwt[j] = s[sa[j] - 1]: one gather

Inverse, the n-step walk of inverseMergeTPSI (src/transform/BWT.cpp:
169-292) as cycle ranking: a stable sort of the BWT bytes links each
sorted slot to the next; closing the walk's one artificial link gives a
single n-cycle, and each slot's distance to the start comes from
ceil(log2 n) rounds of pointer doubling, d[J] and J[J] by gather.

Not kept from kanzi_tpu: the all-sort formulation (permutations applied
by payload sorts, because XLA's gathers are slow on a TPU; here gather
and scatter are direct), and the power-of-two shape buckets (_sa_bucket,
which bound XLA's recompiles; torch runs any n as it is).
"""

from __future__ import annotations

import numpy as np
import torch

import kanzi_tpu_torch.ops as _ops
from kanzi_tpu_torch.ops.ans import _host_tensor


def _rerank(key: torch.Tensor, kb: int):
    """key [B, n] int64 below 2^kb -> (sa [B, n] the positions in key
    order, rank [B, n] the dense rank of each position's key within its
    block, all distinct: bool, the round's one sync)."""
    b, n = key.shape
    dev = key.device
    if kb + max(b - 1, 1).bit_length() > 62:
        raise ValueError(f"suffix array: {b} blocks of {n} bytes do not fit "
                         "one 63-bit sort key")
    rows = torch.arange(b, device=dev)[:, None]
    ks, order = torch.sort((key + (rows << kb)).view(-1))
    neq = torch.ones_like(ks, dtype=torch.int64)
    neq[1:] = ks[1:] != ks[:-1]
    dense = neq.cumsum(0).view(b, n)
    dense = dense - dense[:, :1]                  # each block from rank 0
    sa = order.view(b, n) - rows * n
    rank = torch.empty_like(sa).scatter_(1, sa, dense)
    return sa, rank, bool(neq.sum() == b * n)


def _suffix_array_impl(s: torch.Tensor):
    """s [B, n] uint8 -> (sa [B, n] int64 ascending suffix order, rank
    [B, n] int64 its inverse permutation)."""
    b, n = s.shape
    x = s.long()
    b1 = torch.zeros_like(x)
    b1[:, :-1] = x[:, 1:] + 1                    # 0: second byte absent
    sa, rank, done = _rerank(x << 9 | b1, 17)      # 255 << 9 | 256 < 2^17
    # a rank is at most n - 1, rank2 at most n
    kb = (n - 1).bit_length() + n.bit_length()
    k = 2
    while not done:
        rank2 = torch.zeros_like(rank)
        if k < n:
            rank2[:, :n - k] = rank[:, k:] + 1
        sa, rank, done = _rerank(rank << n.bit_length() | rank2, kb)
        k *= 2
    return sa, rank


def _bwt_impl(s: torch.Tensor):
    """s [B, n] uint8 -> (bwt_sorted [B, n] uint8 with bwt_sorted[j] =
    s[sa[j] - 1] (0 at j == rank0), rank0 [B] the rank of suffix 0, rank
    [B, n])."""
    sa, rank = _suffix_array_impl(s)
    sprev = torch.zeros_like(s)
    sprev[:, 1:] = s[:, :-1]
    return sprev.gather(1, sa), rank[:, 0], rank


def primary_indexes(s: torch.Tensor, rank: torch.Tensor, idx_count: int):
    """[B, idx_count] int64: the primary index of each decode chunk
    (DivSufSort.cpp:171-290): rank + 1 at the chunk's start, or n where
    the last chunk starts at n - 1 after a smaller byte."""
    n = s.shape[1]
    st = n // idx_count
    step = st if st * idx_count == n else st + 1
    cols = []
    for i in range(idx_count):
        pos = i * step
        pi = rank[:, pos] + 1
        if pos == n - 1 and n >= 2:
            pi = torch.where(s[:, n - 2] < s[:, n - 1], n, pi)
        cols.append(pi)
    return torch.stack(cols, 1)


def bwt_output(s: torch.Tensor, bwt_sorted: torch.Tensor,
               rank0: torch.Tensor) -> torch.Tensor:
    """The BWT bytes as BWT.cpp writes them: the last input byte, then the
    sorted column without its primary slot."""
    n = s.shape[1]
    shifted = torch.cat([s[:, n - 1:], bwt_sorted[:, :-1]], 1)
    j = torch.arange(n, device=s.device)
    return torch.where(j <= rank0[:, None], shifted, bwt_sorted)


def _bwt_inverse_core(src: torch.Tensor, p_idx: torch.Tensor,
                      starts: torch.Tensor | None = None):
    """src [B, n] uint8 BWT bytes; p_idx [B] int64 primary index
    (1-based, 0 < p_idx <= n). Returns (the inverse [B, n] uint8, ok [B]
    bool), with no host sync.

    The host's walk (native/sais.cpp kz_bwt_inverse) follows the links
    from the primary index n steps; a BWT of some input has links that
    form one cycle through it, and then this is that walk. Corrupt bytes
    can make several cycles, which the walk repeats and this formulation
    cannot place: ok is False for such a row, whose output is undefined
    (no index leaves it). With starts [B, k] (1-based, the primary
    indexes from which the host walks its k lanes, lane t from position
    t * ceil(n / k)), ok is False too where a lane's index does not sit
    at its lane's start in the walk, whose output would differ."""
    b, n = src.shape
    dev = src.device
    inf = 1 << 40
    idx = torch.arange(n, device=dev)
    pi = p_idx[:, None]
    # links in the original domain: 0 -> 0, 1..p_idx-1 -> i-1, the rest i
    adj = torch.where((idx >= 1) & (idx < pi), idx - 1, idx)
    vals, order = torch.sort(src, dim=1, stable=True)
    start = pi - 1
    nxt = torch.where(order == 0, start, adj.gather(1, order))
    d = torch.where(nxt == start, 1, inf)
    jump = nxt
    for k in range(max((n - 1).bit_length(), 1)):
        d_at = d.gather(1, jump)
        jump = jump.gather(1, jump)
        d = torch.where(d != inf, d,
                        torch.where(d_at != inf, d_at + (1 << k), inf))
    ok = (d <= n).all(1)
    if starts is not None:
        k = starts.shape[1]
        step = -(-n // k)
        at = (n - d.gather(1, starts - 1)) % n        # each lane's position
        ok &= (at == torch.arange(k, device=dev) * step).all(1)
    pos = torch.where(ok[:, None], n - d, idx)
    return torch.empty_like(src).scatter_(1, pos, vals), ok


def suffix_array(block: np.ndarray, device) -> np.ndarray:
    """Suffix array (ascending suffix order) of one block on ``device``,
    numpy in and out."""
    s = _host_tensor(block, np.uint8).to(device)[None]
    return _suffix_array_impl(s)[0][0].cpu().numpy()


def bwt_forward(block: np.ndarray, idx_count: int, device):
    """BWT bytes and primary indexes of one block on ``device``, as
    kanzi_tpu_torch.transform.divsufsort.compute_bwt gives them. Returns
    (out [n] u8, indexes [idx_count] int64)."""
    _ops.count("bwt_forward_device")
    s = _host_tensor(block, np.uint8).to(device)[None]
    bwt_sorted, rank0, rank = _bwt_impl(s)
    out = bwt_output(s, bwt_sorted, rank0)
    return (out[0].cpu().numpy(),
            primary_indexes(s, rank, idx_count)[0].cpu().numpy())


def bwt_inverse(bwt: np.ndarray, p_idx: int, device) -> np.ndarray:
    """Inverse BWT of one block on ``device``, numpy in and out. Only the
    first primary index is needed (the others let a sequential host
    decode its chunks in parallel)."""
    if not 0 < p_idx <= len(bwt):
        raise ValueError("BWT: invalid primary index")
    src = _host_tensor(bwt, np.uint8).to(device)[None]
    p = torch.tensor([p_idx], dtype=torch.int64, device=src.device)
    out, ok = _bwt_inverse_core(src, p)
    if not bool(ok[0]):
        raise ValueError("BWT: corrupt block (its links are not one cycle)")
    return out[0].cpu().numpy()
