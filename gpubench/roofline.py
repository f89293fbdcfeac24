"""The least time an H100 could take for a stage's work: a frozen copy of
chip_smoke.py's bound() and split_bound() arithmetic and its table of
peaks (NVIDIA H100 SXM data sheet).

A bound counts the work the stage's input needs, not what one kernel
design does: each input byte read once and each output byte written once
over the memory rate, or the coder's integer operations per symbol over
the integer rate, whichever is larger.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
# The coders' work is 32-bit integer ALU operations. The data sheet's
# 67e12 fp32 rate counts an FMA as two operations on 128 fp32 lanes an SM;
# an SM has 64 INT32 lanes, so its integer issue rate is a quarter of it.
INT32_OPS_PER_S = 67e12 / 4
# integer operations per symbol, counted from the coders' inner loops
# (chip_smoke.py's OPS): an ANS0 symbol 12 each way; a CM byte 8 bit
# steps of 64 (64-bit operations counted twice: the bit or the compare
# with current, counter1's row and three loads, p, counter2's index and
# two loads, p12, the split, the bound kept, four counter updates and
# stores, the context, the flush test)
OPS = {"ans0_encode_scan": 12, "ans0_compact": 4, "ans0_decode": 12,
       "huff_code_tables": 4, "huff_pack": 12, "huff_decode": 8,
       "ans1_gather": 11, "ans1_chain": 11, "fpaq_encode": 8 * 24,
       "fpaq_decode": 8 * 24, "sbrt": 10, "cm_encode": 8 * 64,
       "cm_decode": 8 * 64, "lz_count": 8, "lz_scan": 0, "lz_scatter": 4,
       "lz_lcp": 0}


def bound(name: str, moved: int, items: int, extra_ops: int = 0) -> dict:
    """The least time the card could take, in ms: bytes moved (each input
    read once, each output written once) over the memory rate, or the
    operations (OPS per item, plus extra_ops) over the integer rate,
    whichever is larger."""
    t_bytes = 1000 * moved / HBM_BYTES_PER_S
    t_ops = 1000 * (OPS[name] * items + extra_ops) / INT32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def split_bound(parts: dict) -> dict:
    """The bounds of the kernels that compute one function together:
    parts {kernel: (bytes, operations)}, each in the share of the one
    kernel that reads, writes or does it. The function's bound is the
    larger of its bytes and operations times; each kernel gets its share
    of the one that binds, so the kernels' bounds add up to the
    function's."""
    t_bytes = {k: 1000 * b / HBM_BYTES_PER_S for k, (b, _) in parts.items()}
    t_ops = {k: 1000 * o / INT32_OPS_PER_S for k, (_, o) in parts.items()}
    by_bytes = sum(t_bytes.values()) >= sum(t_ops.values())
    t = t_bytes if by_bytes else t_ops
    return {k: dict(bound_ms=t[k],
                    bound_by="bytes" if by_bytes else "operations")
            for k in parts}
