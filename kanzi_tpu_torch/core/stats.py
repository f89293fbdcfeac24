"""Global statistics helpers (histograms, entropy, log2, squash/stretch).

Numpy-native equivalents of the reference's Global (src/Global.{hpp,cpp}):
- log2 family: src/Global.hpp:89-160, src/Global.cpp:139-180
- computeHistogram: src/Global.cpp:180-309
- computeFirstOrderEntropy1024: src/Global.cpp:313-329
- squash/stretch tables: src/Global.cpp:96-125
- detectSimpleType: src/Global.cpp:354-397
- computeJobsPerTask: src/Global.cpp:331-352

Bulk histogram/entropy scans also have JAX device versions in
kanzi_tpu.ops.stats_ops for the sharded block pipeline.
"""

from __future__ import annotations

import numpy as np

# --- data types (reference Global::DataType enum order) ---
UNDEFINED, TEXT, MULTIMEDIA, EXE, NUMERIC, BASE64, DNA, BIN, UTF8, SMALL_ALPHABET = range(10)

# int(log2(x-1)) table for x in 1..256 (reference Global::LOG2)
_LOG2_TABLE = np.array([max(0, (x - 1).bit_length() - 1) if x > 1 else 0 for x in range(1, 257)] , dtype=np.int32)

# 4096*log2(x) for x in 0..256 (reference Global::LOG2_4096); regenerate exactly
_LOG2_4096 = np.zeros(257, dtype=np.int64)
_LOG2_4096[1] = 0
for _x in range(2, 257):
    _LOG2_4096[_x] = int(round(4096 * np.log2(_x)))
# the reference table is int-rounded 4096*log2(x); verified equal in tests

INCOMPRESSIBLE_THRESHOLD = 973  # 0.95 * 1024, src/entropy/EntropyUtils.cpp:30


def log2(x: int) -> int:
    """Floor log2; x must be > 0 (src/Global.hpp:_log2)."""
    if x <= 0:
        raise ValueError("log2 of non-positive value")
    return x.bit_length() - 1


def log2_1024(x: int) -> int:
    """1024 * log2(x), ~0.1% accurate (src/Global.cpp:139-155)."""
    if x <= 0:
        raise ValueError("log of non-positive value")
    if x < 256:
        return int(_LOG2_4096[x] + 2) >> 2
    lg = log2(x)
    if (x & (x - 1)) == 0:
        return lg << 10
    return ((lg - 7) * 1024) + ((int(_LOG2_4096[x >> (lg - 7)]) + 2) >> 2)


def compute_histogram(block: np.ndarray, order0: bool = True) -> np.ndarray:
    """Order-0 (256,) or order-1 (65536,) histogram of a uint8 array."""
    block = np.asarray(block, dtype=np.uint8)
    if order0:
        try:
            from kanzi_tpu_torch.utils import native
            if native.transforms_available():
                return native.hist_o0(block).astype(np.uint32)
        except Exception:
            pass
        return np.bincount(block, minlength=256).astype(np.uint32)
    if len(block) < 2:
        return np.zeros(65536, dtype=np.uint32)
    # freqs[prev<<8 | cur]; the reference seeds prev=0 for the first byte
    idx = (block[:-1].astype(np.uint32) << 8) | block[1:]
    h = np.bincount(idx, minlength=65536).astype(np.uint32)
    h[block[0]] += 1  # first byte with prev=0
    return h


def first_order_entropy_1024(block_len: int, histo: np.ndarray) -> int:
    """Zero-order entropy scaled to [0..1024] (src/Global.cpp:313-329)."""
    if block_len == 0:
        return 0
    log_len = log2_1024(block_len)
    h = np.asarray(histo, dtype=np.uint64)
    nz = h[h > 0]
    logs = np.array([log2_1024(int(v)) for v in nz.tolist()], dtype=np.uint64)
    s = int(np.sum((nz * (np.uint64(log_len) - logs)) >> np.uint64(3)))
    return s // block_len


_DNA_SYMBOLS = np.frombuffer(b"acgntuACGNTU", dtype=np.uint8)
_NUMERIC_SYMBOLS = np.frombuffer(b"0123456789+-*/=,.:; ", dtype=np.uint8)
_BASE64_SYMBOLS = np.frombuffer(
    b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/",
    dtype=np.uint8)


def detect_simple_type(count: int, freqs0: np.ndarray) -> int:
    """DNA/NUMERIC/BASE64/BIN/SMALL_ALPHABET detector (src/Global.cpp:354-397)."""
    f = np.asarray(freqs0, dtype=np.int64)
    if int(f[_DNA_SYMBOLS].sum()) > count - count // 12:
        return DNA
    if int(f[_NUMERIC_SYMBOLS].sum()) == count:
        return NUMERIC
    s = (1 if f[0x3D] == 1 else 0) + int(f[_BASE64_SYMBOLS].sum())
    if s == count:
        return BASE64
    nsym = int(np.count_nonzero(f[:256]))
    if nsym == 256:
        return BIN
    return SMALL_ALPHABET if nsym <= 4 else UNDEFINED


def compute_jobs_per_task(jobs: int, tasks: int) -> list:
    """Split jobs among tasks (src/Global.cpp:331-352)."""
    if jobs <= 0 or tasks <= 0:
        raise ValueError("jobs and tasks must be positive")
    q = 1 if jobs <= tasks else jobs // tasks
    r = 0 if jobs <= tasks else jobs - q * tasks
    out = [q] * tasks
    for i in range(r):
        out[i] += 1
    return out


# --- squash/stretch (12-bit logistic tables, src/Global.cpp:96-125) ---
def _build_squash_stretch():
    inv_exp = np.array([
        0, 8, 22, 47, 88, 160, 283, 492,
        848, 1451, 2459, 4117, 6766, 10819, 16608, 24127,
        32768, 41409, 48928, 54717, 58770, 61419, 63077, 64085,
        64688, 65044, 65253, 65376, 65448, 65489, 65514, 65528,
        65536], dtype=np.int64)
    squash = np.zeros(4096, dtype=np.int32)
    x = np.arange(1, 4096)
    w = x & 127
    y = x >> 7
    squash[x - 1] = ((inv_exp[y] * (128 - w) + inv_exp[y + 1] * w) >> 11).astype(np.int32)
    squash[4095] = 4095

    stretch = np.zeros(4096, dtype=np.int32)
    n = 0
    for xx in range(-2047, 2048):
        sq = squash_val(xx, squash)
        while n <= sq:
            stretch[n] = xx
            n += 1
            if n >= 4096:
                break
        if n >= 4096:
            break
    stretch[4095] = 2047
    return squash, stretch


def squash_val(d: int, table=None) -> int:
    if d >= 2048:
        return 4095
    if d <= -2048:
        return 0
    t = SQUASH if table is None else table
    return int(t[d + 2047])


SQUASH, STRETCH = _build_squash_stretch()


def squash(d):
    """p12 = 4096/(1+exp(-d/256)); accepts scalars or arrays."""
    d = np.asarray(d, dtype=np.int64)
    clipped = np.clip(d, -2048, 2047)
    out = SQUASH[clipped + 2047]
    out = np.where(d >= 2048, 4095, out)
    out = np.where(d <= -2048, 0, out)
    return out if out.ndim else int(out)


def stretch(p):
    p = np.asarray(p, dtype=np.int64)
    out = STRETCH[p]
    return out if out.ndim else int(out)
