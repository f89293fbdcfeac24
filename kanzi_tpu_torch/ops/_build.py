"""Build kanzi_tpu_torch/csrc/*.cu with nvcc for sm_90a and bind the
shared libraries with ctypes.

Each source has a plain C interface (no PyTorch headers), so nvcc builds
it in seconds; every source is its own library, and the nvcc processes
of all sources run at once. A library lands in the repository's
git-ignored ``build/kanzi_tpu_torch/`` under a name that carries a hash
of its source and the flags: a changed source builds a new library, an
unchanged one is reused. ptxas's register and shared-memory report is
kept beside it as ``<name>.log``. A failed build raises with nvcc's
stderr; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kanzi_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# every launcher returns cudaGetLastError() after its launch; pointers
# and the stream go as c_void_p so ctypes never truncates them to 32 bits
SIGNATURES = {
    "ans0.cu": {
        # chunks, packed, inv, n_chunks, states, vm, nren, device, stream
        "ans0_encode_scan": [_P, _P, _P, _I, _P, _P, _P, _I, _P],
        # vm, off16, n_rows, total16, out, device, stream
        "ans0_compact": [_P, _P, _I, _L, _P, _I, _P],
        # f2s, fc, states, pay, n_pay, off_bytes, n_chunks, out, consumed,
        # device, stream
        "ans0_decode": [_P, _P, _P, _P, _L, _P, _I, _P, _P, _I, _P],
    },
    "huffman.cu": {
        # chunks, hist, n_chunks, codes, sizes, maxlen, m, ok, bits, device,
        # stream
        "huff_code_tables": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P],
        # chunks, codes, ok, off16, n_chunks, flat, acc, nb, npairs, device,
        # stream
        "huff_pack": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P],
        # tbl, pay, n_pay, bounds, n_chunks, out, device, stream
        "huff_decode": [_P, _P, _L, _P, _I, _P, _I, _P],
    },
    "ans1.cu": {
        # chunks, table, lut, n_chunks, q, consts, device, stream
        "ans1_gather": [_P, _P, _P, _I, _I, _P, _I, _P],
        # consts, n_chunks, q, states, vm, device, stream
        "ans1_chain": [_P, _I, _I, _P, _P, _I, _P],
    },
    "cm.cu": {
        # streams, lens, n_streams, ld, cap, words, cnt, low, high, counter1,
        # counter2, c1, c2, run_mask, device, stream
        "cm_encode": [_P, _P, _I, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _P],
        # pay, off, nw, cur, lens, n_streams, ld, out, consumed, low, high,
        # counter1, counter2, c1, c2, run_mask, device, stream
        "cm_decode": [_P, _P, _P, _P, _P, _I, _L, _P, _P, _P, _P, _P, _P, _P,
                      _P, _P, _I, _P],
    },
    "fpaq.cu": {
        # streams, lens, n_streams, lp, chunk_win, cap, words, win_cnt,
        # win_low, device, stream
        "fpaq_encode": [_P, _P, _I, _L, _I, _L, _P, _P, _P, _I, _P],
    },
    "fpaq_dec.cu": {
        # pay, chunk_off, chunk_nw, chunk_cur, first, lens, n_streams,
        # chunk_bytes, ld, out, consumed, low, high, probs, device, stream
        "fpaq_decode": [_P, _P, _P, _P, _P, _P, _I, _L, _L, _P, _P, _P, _P,
                        _P, _I, _P],
    },
    "lz.cu": {
        # pad, keys, n, hash_log, shift, bits, counts, last, device, stream
        "lz_count": [_P, _P, _L, _I, _I, _I, _P, _P, _I, _P],
        # counts, last, bits, tiles, offs, totals, pred, device, stream
        "lz_scan": [_P, _P, _I, _I, _P, _P, _P, _I, _P],
        # pad, keys, n, hash_log, shift, bits, offs, totals, pred, out,
        # prev, device, stream
        "lz_scatter": [_P, _P, _L, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P],
        # pad, prev, n, lcp, device, stream
        "lz_lcp": [_P, _P, _L, _P, _I, _P],
    },
    "sbrt.cu": {
        # blocks, lens, n_blocks, ld, seg, occ_last, occ_sec, device, stream
        "sbrt_occ": [_P, _P, _I, _L, _I, _P, _P, _I, _P],
        # occ_last, occ_sec, n_blocks, nseg, m1, m2, shift, ent_last, ent_q,
        # device, stream
        "sbrt_entry": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P],
        # blocks, lens, n_blocks, ld, seg, ent_last, ent_q, m1, m2, shift,
        # out, device, stream
        "sbrt_fwd": [_P, _P, _I, _L, _I, _P, _P, _I, _I, _I, _P, _I, _P],
        # blocks, lens, n_blocks, ld, m1, m2, shift, out, device, stream
        "sbrt_inv": [_P, _P, _I, _L, _I, _I, _I, _P, _I, _P],
    },
}

_lock = threading.Lock()
_kernels = {}   # launcher name -> (ctypes function, its library)


def _nvcc() -> str:
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    nvcc = cuda_home / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(source: str) -> Path:
    """Where the library of one csrc/ source lives (built or not)."""
    src = CSRC / source
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"libkanzi_tpu_torch_{src.stem}_{h.hexdigest()[:16]}.so"


def _build_one(source: str) -> Path:
    so = library_path(source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {r.returncode}: "
                           f"{' '.join(cmd)}\n{r.stderr}")
    so.with_suffix(".log").write_text(r.stderr)
    os.replace(tmp, so)     # atomic: no process loads half a library
    return so


def build() -> list:
    """Compile every csrc/ source that has no library yet, all nvcc
    processes at once. Returns the library paths in SIGNATURES order."""
    with ThreadPoolExecutor(len(SIGNATURES)) as ex:
        return list(ex.map(_build_one, SIGNATURES))


def kernel(name: str):
    """The ctypes launcher `name` and its library, building and binding
    every library on first use."""
    with _lock:
        if not _kernels:
            for source, so in zip(SIGNATURES, build()):
                lib = ctypes.CDLL(str(so))
                lib.kanzi_cuda_error_string.argtypes = [ctypes.c_int]
                lib.kanzi_cuda_error_string.restype = ctypes.c_char_p
                for fname, argtypes in SIGNATURES[source].items():
                    fn = getattr(lib, fname)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    _kernels[fname] = (fn, lib)
        return _kernels[name]
