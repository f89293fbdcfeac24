"""ctypes loader for the native host runtime (the repository's shared
C++ sources, native/*.cpp).

Compiles each library on first use with g++ (no packages are installed)
into the git-ignored build/kanzi_tpu_torch/native/ beside the checkout,
under a name that carries a hash of its source, its headers and the
build host's target (g++ -march=native resolves to the host's CPU), so a
changed source builds a new library and a library built for another CPU
is never loaded. It never loads the libraries kanzi_tpu builds next to
the sources. The port's own host sources, csrc/huff_parse.cpp and
csrc/lzx_hint.cpp, build the same way. Falls back cleanly: callers must
check `available()`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_libs = {}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _find_native_dir() -> str:
    """An installed wheel ships the C++ sources inside the package at
    kanzi_tpu_torch/native (setup.py); a repository checkout keeps them
    at <root>/native."""
    wheel = os.path.join(_PKG, "native")
    if os.path.isdir(wheel):
        return wheel
    return os.path.join(os.path.dirname(_PKG), "native")


_NATIVE_DIR = _find_native_dir()
_CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kanzi_tpu_torch",
                         "native")
_FLAGS = ["-O3", "-fomit-frame-pointer", "-DNDEBUG", "-fno-rtti", "-shared",
          "-fPIC", "-pthread"]


_target = None


def _host_target():
    """(g++ flags, key of the build host's target). -march=native
    resolves to the CPU it runs on; its resolved target options go into
    each library's name. Toolchains without -march=native build generic
    code under the key "generic"."""
    global _target
    if _target is None:
        r = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                           capture_output=True, timeout=60)
        _target = ((["-march=native"], r.stdout) if r.returncode == 0
                   else ([], b"generic"))
    return _target


def _build(name: str) -> str:
    """Path of the library for the current sources of `name` on this
    host, compiled first if absent. A file lock keeps concurrent
    processes from compiling the same library twice; the library appears
    atomically."""
    src_dir = (_CSRC_DIR if os.path.exists(os.path.join(_CSRC_DIR,
                                                         f"{name}.cpp"))
               else _NATIVE_DIR)
    src = os.path.join(src_dir, f"{name}.cpp")
    march, target = _host_target()
    h = hashlib.sha256(target)
    with open(src, "rb") as f:
        h.update(f.read())
    for fn in sorted(os.listdir(src_dir)):
        if fn.endswith(".h"):
            with open(os.path.join(src_dir, fn), "rb") as f:
                h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libkanzi{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["g++", *march, *_FLAGS, src, "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
    return so


def _embed() -> tuple:
    """(include dir, library dir, library name) of this interpreter's
    embedding library, libpythonX.Y.so."""
    import sys
    import sysconfig
    return (sysconfig.get_paths()["include"],
            sysconfig.get_config_var("LIBDIR"),
            f"python{sys.version_info.major}.{sys.version_info.minor}")


def capi_library() -> str:
    """Path of the port's C API library (csrc/capi.cpp: the FILE* calls
    of native/kanzi_tpu_capi.h over an embedded interpreter that imports
    kanzi_tpu_torch from this checkout), compiled with g++ at first use
    into BUILD_DIR under a name keyed by its source, the header, the
    package root baked into it and the embedding library, and under a
    lock, as _build keeps the others. Raises RuntimeError where this
    interpreter has no shared libpython to embed."""
    inc, libdir, ver = _embed()
    if not (libdir and os.path.exists(os.path.join(libdir, f"lib{ver}.so"))):
        raise RuntimeError(f"no lib{ver}.so to embed the interpreter")
    src = os.path.join(_CSRC_DIR, "capi.cpp")
    root = os.path.dirname(_PKG)
    flags = ["-O2", "-shared", "-fPIC", f"-I{_NATIVE_DIR}", f"-I{inc}",
             f'-DKANZI_TPU_TORCH_PYROOT="{root}"', src, f"-L{libdir}",
             f"-l{ver}", "-ldl", f"-Wl,-rpath,{libdir}"]
    h = hashlib.sha256("\0".join(flags).encode())
    for path in (src, os.path.join(_NATIVE_DIR, "kanzi_tpu_capi.h")):
        with open(path, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR,
                      f"libkanzitpu_torch_capi_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "capi.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["g++", *flags, "-o", tmp], check=True,
                           capture_output=True, timeout=300)
            os.replace(tmp, so)
    return so


def capi_link_flags(so: str) -> list:
    """The flags a C program needs to include native/kanzi_tpu_capi.h,
    link the library `so` (capi_library()) and run against both; the
    interpreter's library comes with them, for a program that runs
    Python through it too."""
    inc, libdir, ver = _embed()
    return [f"-I{_NATIVE_DIR}", f"-I{inc}", so, f"-L{libdir}", f"-l{ver}",
            f"-Wl,-rpath,{libdir}", f"-Wl,-rpath,{os.path.dirname(so)}"]


def _load(name: str):
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = None
        try:
            so = _build(name)
            lib = ctypes.CDLL(so)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            i32p = ctypes.POINTER(ctypes.c_int32)
            if name == "bitrun":
                lib.kz_concat_runs.restype = ctypes.c_uint64
                lib.kz_concat_runs.argtypes = [
                    u8p, ctypes.c_uint64, u8p, u8p, u8p, u64p, u64p,
                    ctypes.c_int64]
            elif name == "lzx":
                lib.kz_lzx_forward.restype = ctypes.c_int64
                lib.kz_lzx_forward.argtypes = [
                    u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                    u8p, ctypes.c_int64, i32p]
            elif name == "ans":
                i64 = ctypes.c_int64
                i64p = ctypes.POINTER(i64)
                u32p = ctypes.POINTER(ctypes.c_uint32)
                lib.kz_ans_enc_lanes.restype = i64
                lib.kz_ans_enc_lanes.argtypes = [
                    i32p, i64, i64p, i64p, i64p, u64p, u64p, u32p, u8p, i64]
                lib.kz_ans_dec_chunk.restype = i64
                lib.kz_ans_dec_chunk.argtypes = [
                    u8p, i64, u32p, u8p, i64p, i64p, ctypes.c_int,
                    ctypes.c_int, u8p, i64]
            elif name == "transforms":
                i64 = ctypes.c_int64
                i64p = ctypes.POINTER(i64)
                lib.kz_sbrt_forward.restype = None
                lib.kz_sbrt_forward.argtypes = [u8p, i64, ctypes.c_int, u8p]
                lib.kz_sbrt_inverse.restype = None
                lib.kz_sbrt_inverse.argtypes = [u8p, i64, ctypes.c_int, u8p]
                lib.kz_srt_forward.restype = ctypes.c_int
                lib.kz_srt_forward.argtypes = [u8p, i64, u8p, i64p]
                lib.kz_srt_inverse.restype = ctypes.c_int
                lib.kz_srt_inverse.argtypes = [u8p, i64, i64p, u8p]
                lib.kz_rlt_forward.restype = i64
                lib.kz_rlt_forward.argtypes = [u8p, i64, ctypes.c_int,
                                               u8p, i64]
                lib.kz_rlt_inverse.restype = i64
                lib.kz_rlt_inverse.argtypes = [u8p, i64, u8p, i64]
                lib.kz_lzp_forward.restype = i64
                lib.kz_lzp_forward.argtypes = [u8p, i64, u8p]
                lib.kz_lzp_inverse.restype = i64
                lib.kz_lzp_inverse.argtypes = [u8p, i64, u8p, i64]
                lib.kz_exe_detect_scan.restype = None
                lib.kz_exe_detect_scan.argtypes = [u8p, i64, i64, i64p, i64p]
                lib.kz_lzx_inverse.restype = i64
                lib.kz_lzx_inverse.argtypes = [u8p, i64, u8p, i64]
                lib.kz_pack_bits.restype = i64
                lib.kz_pack_bits.argtypes = [
                    ctypes.POINTER(ctypes.c_uint32), u8p, i64, u8p]
                lib.kz_huff_code_lengths.restype = ctypes.c_int
                lib.kz_huff_code_lengths.argtypes = [i64p, ctypes.c_int]
                lib.kz_fsd_inverse_delta.restype = i64
                lib.kz_fsd_inverse_delta.argtypes = [u8p, i64,
                                                     ctypes.c_int, u8p]
                lib.kz_ans_enc_header.restype = i64
                lib.kz_ans_enc_header.argtypes = [i64p, ctypes.c_int, u8p]
                lib.kz_ans_dec_header.restype = i64
                lib.kz_ans_dec_header.argtypes = [
                    u8p, i64, i64, ctypes.c_int, i64p, i32p,
                    ctypes.POINTER(ctypes.c_int32)]
                lib.kz_fsd_scan.restype = None
                lib.kz_fsd_scan.argtypes = [u8p, i64, i64p]
                lib.kz_alias_emit.restype = i64
                lib.kz_alias_emit.argtypes = [
                    u8p, i64, i64p, u8p, ctypes.POINTER(ctypes.c_int)]
                lib.kz_ans1_sym_idx.restype = None
                lib.kz_ans1_sym_idx.argtypes = [u8p, i64, i32p]
                lib.kz_ans_f2s.restype = None
                lib.kz_ans_f2s.argtypes = [i64p, ctypes.c_int,
                                           ctypes.c_int, u8p]
                lib.kz_ans1_hist.restype = None
                lib.kz_ans1_hist.argtypes = [u8p, i64, i64p]
                lib.kz_ans1_norm.restype = None
                lib.kz_ans1_norm.argtypes = [i64p]
                lib.kz_zrlt_forward.restype = i64
                lib.kz_zrlt_forward.argtypes = [u8p, i64, u8p, i64]
                lib.kz_zrlt_inverse.restype = i64
                lib.kz_zrlt_inverse.argtypes = [u8p, i64, u8p, i64]
                lib.kz_hist_o01.restype = None
                lib.kz_hist_o01.argtypes = [u8p, i64, i64p, i64p]
                lib.kz_shift_bytes.restype = None
                lib.kz_shift_bytes.argtypes = [u8p, i64, ctypes.c_int,
                                               u8p]
                lib.kz_hist_o0.restype = None
                lib.kz_hist_o0.argtypes = [u8p, i64, i64p]
                lib.kz_ans0_enc_block.restype = i64
                lib.kz_ans0_enc_block.argtypes = [u8p, i64, i64,
                                                  ctypes.c_int, u8p, i64]
                lib.kz_ans0_dec_block.restype = i64
                lib.kz_ans0_dec_block.argtypes = [u8p, i64, i64, i64,
                                                  i64, u8p, i64p]
                lib.kz_ans1_enc_block.restype = i64
                lib.kz_ans1_enc_block.argtypes = [u8p, i64, i64,
                                                  ctypes.c_int, u8p, i64]
                lib.kz_ans1_dec_block.restype = i64
                lib.kz_ans1_dec_block.argtypes = [u8p, i64, i64, i64,
                                                  i64, u8p, i64p]
                lib.kz_huff_enc_block.restype = i64
                lib.kz_huff_enc_block.argtypes = [u8p, i64, i64, u8p, i64]
                lib.kz_huff_dec_block.restype = i64
                lib.kz_huff_dec_block.argtypes = [u8p, i64, i64, i64,
                                                  i64, u8p, i64p]
                lib.kz_exe_fwd_x86.restype = i64
                lib.kz_exe_fwd_x86.argtypes = [u8p, i64, i64, i64, i64,
                                               u8p]
                lib.kz_exe_fwd_arm.restype = i64
                lib.kz_exe_fwd_arm.argtypes = [u8p, i64, i64, i64, i64,
                                               u8p]
                lib.kz_exe_inv_x86.restype = i64
                lib.kz_exe_inv_x86.argtypes = [u8p, i64, u8p]
                lib.kz_exe_inv_arm.restype = i64
                lib.kz_exe_inv_arm.argtypes = [u8p, i64, u8p]
                lib.kz_fsd_forward_delta.restype = i64
                lib.kz_fsd_forward_delta.argtypes = [u8p, i64,
                                                     ctypes.c_int, i64, u8p]
                lib.kz_huff_enc_chunk.restype = i64
                lib.kz_huff_enc_chunk.argtypes = [u8p, i64, u8p]
                lib.kz_huff_dec_chunk.restype = i64
                lib.kz_huff_dec_chunk.argtypes = [u8p, i64, i64, i64, u8p]
                lib.kz_huff_dec_frag.restype = i64
                lib.kz_huff_dec_frag.argtypes = [u8p, i64, u8p, u8p, u8p]
                lib.kz_rolz1_parse.restype = ctypes.c_int
                lib.kz_rolz1_parse.argtypes = [
                    u8p, i64, i64, i64, i64, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, i32p,
                    ctypes.POINTER(ctypes.c_uint32),
                    u8p, i64p, u8p, i64p, u8p, i64p, u8p, i64p]
                lib.kz_range_enc_block.restype = i64
                lib.kz_range_enc_block.argtypes = [u8p, i64, i64,
                                                   ctypes.c_int, u8p, i64]
                lib.kz_range_dec_block.restype = i64
                lib.kz_range_dec_block.argtypes = [u8p, i64, i64, i64,
                                                   i64, u8p, i64p]
                lib.kz_rolz2_forward.restype = i64
                lib.kz_rolz2_forward.argtypes = [
                    u8p, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    u8p, i64]
                lib.kz_rolz2_inverse.restype = i64
                lib.kz_rolz2_inverse.argtypes = [
                    u8p, i64, i64, i64, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, u8p]
                lib.kz_rolz1_rebuild.restype = i64
                lib.kz_rolz1_rebuild.argtypes = [
                    u8p, i64, u8p, i64, u8p, i64, u8p, i64, u8p, i64, i64,
                    i64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, i32p, ctypes.POINTER(ctypes.c_uint32)]
            elif name == "lzx_hint":
                i64 = ctypes.c_int64
                lib.kz_lzx_forward_hinted.restype = i64
                lib.kz_lzx_forward_hinted.argtypes = [
                    u8p, i64, ctypes.c_int, ctypes.c_int, i32p, u8p,
                    ctypes.c_int, u8p, i64, ctypes.POINTER(i64),
                    ctypes.c_int]
                lib.kz_lzx_hint_stats.restype = ctypes.c_int
                lib.kz_lzx_hint_stats.argtypes = []
                if lib.kz_lzx_hint_stats() != len(LZX_HINT_STATS):
                    raise RuntimeError("lzx_hint: its counters differ from "
                                       "LZX_HINT_STATS")
            elif name == "huff_parse":
                i64 = ctypes.c_int64
                i64p = ctypes.POINTER(i64)
                lib.kz_huff_parse_block.restype = i64
                lib.kz_huff_parse_block.argtypes = [
                    u8p, i64, i64, i64, u8p, i32p, i32p, i32p, u8p, i64p,
                    i64p, i64p]
            elif name == "sais":
                lib.kz_bwts_forward.restype = ctypes.c_int
                lib.kz_bwts_forward.argtypes = [u8p, ctypes.c_int64, u8p]
                lib.kz_bwts_inverse.restype = ctypes.c_int
                lib.kz_bwts_inverse.argtypes = [u8p, ctypes.c_int64, u8p]
                i64 = ctypes.c_int64
                i64p = ctypes.POINTER(i64)
                lib.kz_sa.restype = ctypes.c_int
                lib.kz_sa.argtypes = [u8p, i64, i32p]
                lib.kz_bwt_forward.restype = ctypes.c_int
                lib.kz_bwt_forward.argtypes = [u8p, i64, ctypes.c_int32,
                                               u8p, i64p]
                lib.kz_bwt_inverse.restype = ctypes.c_int
                lib.kz_bwt_inverse.argtypes = [u8p, i64, i64p,
                                               ctypes.c_int32, u8p]
            elif name == "bincoder":
                i64 = ctypes.c_int64
                lib.kz_bin_new.restype = ctypes.c_void_p
                lib.kz_bin_new.argtypes = [
                    ctypes.c_int, ctypes.c_int, i64, i64, i64, i64]
                lib.kz_bin_free.restype = None
                lib.kz_bin_free.argtypes = [ctypes.c_void_p]
                lib.kz_bin_get_low.restype = ctypes.c_uint64
                lib.kz_bin_get_low.argtypes = [ctypes.c_void_p]
                lib.kz_bin_enc_chunk.restype = i64
                lib.kz_bin_enc_chunk.argtypes = [
                    ctypes.c_void_p, u8p, i64, u8p, i64]
                lib.kz_bin_dec_chunk.restype = i64
                lib.kz_bin_dec_chunk.argtypes = [
                    ctypes.c_void_p, u8p, i64, ctypes.c_uint64, u8p, i64]
            elif name == "text":
                lib.kz_text_set_dict.restype = None
                lib.kz_text_set_dict.argtypes = [
                    u8p, ctypes.c_int64, i32p, i32p, ctypes.c_int]
                lib.kz_text_forward.restype = ctypes.c_int64
                lib.kz_text_forward.argtypes = [
                    u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, u8p]
                lib.kz_text_inverse.restype = ctypes.c_int64
                lib.kz_text_inverse.argtypes = [
                    u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, u8p, ctypes.c_int64]
                _init_text_dict(lib)
        except Exception:
            lib = None
        _libs[name] = lib
        return lib


def _init_text_dict(lib) -> None:
    from kanzi_tpu_torch.transform.text import _STATIC_WORDS
    blob = b"".join(_STATIC_WORDS)
    offs = np.zeros(len(_STATIC_WORDS), np.int32)
    lens = np.zeros(len(_STATIC_WORDS), np.int32)
    p = 0
    for i, w in enumerate(_STATIC_WORDS):
        offs[i] = p
        lens[i] = len(w)
        p += len(w)
    b = np.frombuffer(blob, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.kz_text_set_dict(b.ctypes.data_as(u8p), len(blob),
                         offs.ctypes.data_as(i32p),
                         lens.ctypes.data_as(i32p), len(_STATIC_WORDS))


def available() -> bool:
    return _load("bitrun") is not None


def text_available() -> bool:
    return _load("text") is not None


def text_forward(src: np.ndarray, variant: int, log_hash: int,
                 dict_size0: int, mode: int):
    lib = _load("text")
    count = len(src)
    dst = np.zeros(count + 8, np.uint8)
    src = np.ascontiguousarray(src, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.kz_text_forward(src.ctypes.data_as(u8p), count, variant,
                            log_hash, dict_size0, mode,
                            dst.ctypes.data_as(u8p))
    return None if n < 0 else dst[:n]


def text_inverse(src: np.ndarray, variant: int, log_hash: int,
                 dict_size0: int, dst_cap: int,
                 out: np.ndarray | None = None):
    """out: optional destination view — the inverse then writes in
    place with out.size as the exact capacity (kz_text_inverse guards
    every emit against the limit); returns the length, or None on
    overflow/invalid stream."""
    lib = _load("text")
    if out is None:
        dst = np.zeros(dst_cap + 8, np.uint8)
        cap = dst_cap + 8
    else:
        dst = out
        cap = out.size
    src = np.ascontiguousarray(src, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.kz_text_inverse(src.ctypes.data_as(u8p), len(src), variant,
                            log_hash, dict_size0,
                            dst.ctypes.data_as(u8p), cap)
    if n < 0:
        return None
    return int(n) if out is not None else dst[:n]


def lzx_available() -> bool:
    return _load("lzx") is not None


def bincoder_available() -> bool:
    return _load("bincoder") is not None


def sais_available() -> bool:
    return _load("sais") is not None


def transforms_available() -> bool:
    return _load("transforms") is not None


def ans_available() -> bool:
    return _load("ans") is not None


def ans_enc_lanes(sym_idx: np.ndarray, tabs):
    """Returns (states uint32[4], renorm payload bytes)."""
    lib = _load("ans")
    steps = sym_idx.shape[0]
    sym_idx = np.ascontiguousarray(sym_idx, np.int32)
    cap = 2 * 4 * steps + 16
    buf = np.empty(cap, np.uint8)
    states = np.zeros(4, np.uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    xmax = np.ascontiguousarray(tabs["xmax"].reshape(-1), np.int64)
    bias = np.ascontiguousarray(tabs["bias"].reshape(-1), np.int64)
    cmpl = np.ascontiguousarray(tabs["cmpl"].reshape(-1), np.int64)
    invf = np.ascontiguousarray(tabs["inv_freq"].reshape(-1), np.uint64)
    invs = np.ascontiguousarray(tabs["inv_shift"].reshape(-1), np.uint64)
    n = lib.kz_ans_enc_lanes(
        sym_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), steps,
        xmax.ctypes.data_as(i64p), bias.ctypes.data_as(i64p),
        cmpl.ctypes.data_as(i64p), invf.ctypes.data_as(u64p),
        invs.ctypes.data_as(u64p),
        states.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        _u8ptr(buf), cap)
    if n < 0:
        raise ValueError("ANS encode buffer overflow")
    return states, buf[cap - n:].tobytes()


def ans_dec_chunk(payload: bytes, states: np.ndarray, f2s: np.ndarray,
                  freq: np.ndarray, cum: np.ndarray, lr: int, order: int,
                  out: np.ndarray) -> int:
    """Decodes one chunk into `out`; returns bytes consumed or raises."""
    lib = _load("ans")
    sz = len(payload)
    buf = np.frombuffer(payload + b"\x00\x00", np.uint8)
    states = np.ascontiguousarray(states, np.uint32)
    f2s = np.ascontiguousarray(f2s, np.uint8).reshape(-1)
    freq = np.ascontiguousarray(freq.reshape(-1), np.int64)
    cum = np.ascontiguousarray(cum.reshape(-1), np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = lib.kz_ans_dec_chunk(
        _u8ptr(buf), sz,
        states.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        _u8ptr(f2s), freq.ctypes.data_as(i64p), cum.ctypes.data_as(i64p),
        lr, order, _u8ptr(out), len(out))
    if n < 0:
        raise ValueError("ANS chunk payload overrun")
    return int(n)


def _u8ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _bufp(buf):
    """uint8* into bytes / uint8 ndarray / any buffer, without copying.
    numpy's data_as keeps a reference to the array on the returned
    pointer object, so temporaries stay alive for the call."""
    if isinstance(buf, np.ndarray):
        return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    if isinstance(buf, bytes):
        return ctypes.cast(ctypes.c_char_p(buf),
                           ctypes.POINTER(ctypes.c_uint8))
    return np.frombuffer(buf, np.uint8).ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8))


def sbrt(src: np.ndarray, mode: int, inverse: bool) -> np.ndarray:
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    out = np.empty(len(src), np.uint8)
    fn = lib.kz_sbrt_inverse if inverse else lib.kz_sbrt_forward
    fn(_u8ptr(src), len(src), mode, _u8ptr(out))
    return out


def srt_forward(src: np.ndarray):
    """Returns (rank_stream uint8[n], freqs int64[256])."""
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    dst = np.empty(len(src), np.uint8)
    freqs = np.zeros(256, np.int64)
    lib.kz_srt_forward(_u8ptr(src), len(src), _u8ptr(dst),
                       freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return dst, freqs


def srt_inverse(data: np.ndarray, freqs: np.ndarray) -> np.ndarray:
    lib = _load("transforms")
    data = np.ascontiguousarray(data, np.uint8)
    freqs = np.ascontiguousarray(freqs, np.int64)
    out = np.empty(len(data), np.uint8)
    rc = lib.kz_srt_inverse(
        _u8ptr(data), len(data),
        freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _u8ptr(out))
    if rc != 0:
        raise ValueError("SRT: invalid bucket position")
    return out


def lzp_forward(src: np.ndarray):
    """Returns output array or None (transform skipped)."""
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    dst = np.empty(len(src) + 8, np.uint8)
    n = lib.kz_lzp_forward(_u8ptr(src), len(src), _u8ptr(dst))
    return None if n < 0 else dst[:n]


def lzp_inverse(src: np.ndarray, dst_cap: int) -> np.ndarray:
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    dst = np.empty(dst_cap, np.uint8)
    n = lib.kz_lzp_inverse(_u8ptr(src), len(src), _u8ptr(dst), dst_cap)
    if n == -2:
        raise ValueError("LZP: truncated stream")
    if n < 0:
        raise ValueError("LZP: output overflow")
    return dst[:n]


def huff_enc_chunk(chunk: np.ndarray):
    """Encode one Huffman chunk (header + fragments). Returns
    (bitrun bytes, nbits), or None when the chunk needs the Python
    bit-debt path. Raises ValueError on invalid code lengths."""
    lib = _load("transforms")
    chunk = np.ascontiguousarray(chunk, np.uint8)
    out = np.empty(2 * len(chunk) + 1300, np.uint8)
    nbits = lib.kz_huff_enc_chunk(_u8ptr(chunk), len(chunk), _u8ptr(out))
    if nbits == -1:
        return None
    if nbits < 0:
        raise ValueError(
            "Could not generate Huffman codes: invalid code length 0")
    return out[:(nbits + 7) >> 3].tobytes(), int(nbits)


def huff_dec_chunk(buf: bytes, nbits: int, bitpos: int, sz_chunk: int,
                   out: np.ndarray, start: int) -> int:
    """Decode one Huffman chunk from the bitstream buffer into
    out[start:start+sz_chunk]. Returns the new bit position; -5 means
    empty alphabet (end marker). Raises on malformed streams."""
    from kanzi_tpu_torch.bitstream.reader import BitStreamError
    lib = _load("transforms")
    dst = out[start:start + sz_chunk]
    rc = lib.kz_huff_dec_chunk(
        _bufp(buf),
        nbits, bitpos, sz_chunk, _u8ptr(dst))
    if rc == -5:
        return -5
    if rc == -2:
        raise BitStreamError("read past end of bitstream")
    if rc == -3:
        raise ValueError("Invalid variable-length integer in bitstream")
    if rc == -4:
        raise ValueError("Invalid bitstream: incorrect size for Huffman "
                         "symbol")
    if rc < 0:
        raise ValueError("Could not generate Huffman codes: max code "
                         "length exceeded")
    return int(rc)


def ans_enc_header(freqs: np.ndarray, lr: int):
    """One context's ANS header (alphabet + grouped freqs). Returns
    (bitrun bytes, nbits)."""
    lib = _load("transforms")
    freqs = np.ascontiguousarray(freqs, np.int64)
    out = np.empty(1024, np.uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    nbits = lib.kz_ans_enc_header(freqs.ctypes.data_as(i64p), lr,
                                  _u8ptr(out))
    return out[:(nbits + 7) >> 3].tobytes(), int(nbits)


def ans_dec_header(buf: bytes, nbits: int, bitpos: int, order: int):
    """Full ANS chunk header parse. Returns (newpos, freqs [dim,256]
    int64, alpha_counts [dim] int32, lr). Raises on malformed data."""
    from kanzi_tpu_torch.bitstream.reader import BitStreamError
    lib = _load("transforms")
    dim = 255 * order + 1
    freqs = np.zeros(dim * 256, np.int64)
    counts = np.zeros(dim, np.int32)
    lr = ctypes.c_int32(0)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.kz_ans_dec_header(
        _bufp(buf),
        nbits, bitpos, order, freqs.ctypes.data_as(i64p),
        counts.ctypes.data_as(i32p), ctypes.byref(lr))
    if rc == -2:
        raise BitStreamError("read past end of bitstream")
    if rc < 0:
        raise ValueError("Invalid bitstream: incorrect ANS header")
    return int(rc), freqs.reshape(dim, 256), counts, int(lr.value)


def ans0_enc_block(block: np.ndarray, chunk_size: int, lr: int):
    """Whole-block order-0 ANS encode (headers + payloads for every
    chunk). Returns (bitrun bytes, nbits). Bit-exact with the per-chunk
    Python path (kanzi_tpu/entropy/ans.py encode order 0)."""
    lib = _load("transforms")
    block = np.ascontiguousarray(block, np.uint8)
    cap = 2 * len(block) + 4096 * (len(block) // chunk_size + 2)
    out = np.empty(cap, np.uint8)
    nbits = lib.kz_ans0_enc_block(_u8ptr(block), len(block), chunk_size,
                                  lr, _u8ptr(out), cap)
    if nbits < 0:
        raise RuntimeError("ANS block encode: output capacity exceeded")
    return out[:(int(nbits) + 7) >> 3], int(nbits)


def ans0_dec_block(buf: bytes, nbits: int, bitpos: int, count: int,
                   chunk_size: int):
    """Whole-block order-0 ANS decode. Returns (newpos, out bytes
    ndarray). Raises on malformed data."""
    from kanzi_tpu_torch.bitstream.reader import BitStreamError
    lib = _load("transforms")
    out = np.empty(count, np.uint8)
    decoded = ctypes.c_int64(0)
    rc = lib.kz_ans0_dec_block(
        _bufp(buf),
        nbits, bitpos, count, chunk_size, _u8ptr(out),
        ctypes.byref(decoded))
    if rc == -2:
        raise BitStreamError("read past end of bitstream")
    if rc < 0:
        raise ValueError("Invalid bitstream: bad ANS chunk")
    return int(rc), out[:decoded.value]

def huff_enc_block(block: np.ndarray, chunk_size: int):
    """Whole-block Huffman encode (every chunk: header + 4 fragments).
    Returns (bitrun bytes, nbits) or None if the native path cannot
    encode this block (pathological code lengths)."""
    lib = _load("transforms")
    block = np.ascontiguousarray(block, np.uint8)
    cap = 2 * len(block) + 4096 * (len(block) // chunk_size + 2)
    out = np.empty(cap, np.uint8)
    nbits = lib.kz_huff_enc_block(_u8ptr(block), len(block), chunk_size,
                                  _u8ptr(out), cap)
    if nbits < 0:
        return None
    return out[:(int(nbits) + 7) >> 3], int(nbits)


def huff_dec_block(buf: bytes, nbits: int, bitpos: int, count: int,
                   chunk_size: int):
    """Whole-block Huffman decode. Returns (newpos, out ndarray)."""
    from kanzi_tpu_torch.bitstream.reader import BitStreamError
    lib = _load("transforms")
    out = np.empty(count, np.uint8)
    decoded = ctypes.c_int64(0)
    rc = lib.kz_huff_dec_block(
        _bufp(buf),
        nbits, bitpos, count, chunk_size, _u8ptr(out),
        ctypes.byref(decoded))
    if rc == -2:
        raise BitStreamError("read past end of bitstream")
    if rc < 0:
        raise ValueError("Invalid bitstream: bad Huffman chunk")
    return int(rc), out[:decoded.value]


def huff_parse_available() -> bool:
    return _load("huff_parse") is not None


def huff_parse_block(buf, nbits: int, bitpos: int, n_full: int,
                     out: np.ndarray):
    """Parse the first n_full full chunks of a Huffman block for the
    card (csrc/huff_parse.cpp). Chunks of one symbol are written to
    `out`. Returns (new bit position, chunks parsed, chunk indexes [K],
    codes [K, 256], sizes [K, 256], pay, bounds [4K + 1]) for the K
    chunks left to the card; chunks parsed < n_full when an empty
    alphabet ended the block. Raises on malformed streams."""
    from kanzi_tpu_torch.bitstream.reader import BitStreamError
    from kanzi_tpu_torch.ops.huffman import CHUNK, FRAG_MAX_BYTES
    lib = _load("huff_parse")
    dev_chunk = np.empty(n_full, np.int32)
    codes = np.empty((n_full, 256), np.int32)
    sizes = np.empty((n_full, 256), np.int32)
    pay = np.empty(4 * n_full * FRAG_MAX_BYTES, np.uint8)
    bounds = np.empty(4 * n_full + 1, np.int64)
    n_dev = ctypes.c_int64(0)
    n_parsed = ctypes.c_int64(0)
    i32p = ctypes.POINTER(ctypes.c_int32)
    assert out.size >= n_full * CHUNK
    rc = lib.kz_huff_parse_block(
        _bufp(buf), nbits, bitpos, n_full, _u8ptr(out),
        dev_chunk.ctypes.data_as(i32p), codes.ctypes.data_as(i32p),
        sizes.ctypes.data_as(i32p), _u8ptr(pay),
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(n_dev), ctypes.byref(n_parsed))
    if rc == -2:
        raise BitStreamError("read past end of bitstream")
    if rc == -3:
        raise ValueError("Invalid variable-length integer in bitstream")
    if rc == -4:
        raise ValueError("Invalid bitstream: incorrect size for Huffman "
                         "symbol")
    if rc == -7:
        raise ValueError("Invalid Huffman fragment size")
    if rc < 0:
        raise ValueError("Could not generate Huffman codes: max code "
                         "length exceeded")
    k = n_dev.value
    return (int(rc), n_parsed.value, dev_chunk[:k], codes[:k], sizes[:k],
            pay[:bounds[4 * k]], bounds[:4 * k + 1])


def ans1_enc_block(block: np.ndarray, chunk_size: int, lr: int):
    """Whole-block order-1 ANS encode (256-context headers + quarter-
    stride 4-lane payloads for every chunk). Returns (bitrun bytes,
    nbits); bit-exact with the per-chunk Python path."""
    lib = _load("transforms")
    block = np.ascontiguousarray(block, np.uint8)
    n_chunks = len(block) // chunk_size + 2
    cap = 2 * len(block) + 300000 * n_chunks
    out = np.empty(cap, np.uint8)
    nbits = lib.kz_ans1_enc_block(_u8ptr(block), len(block), chunk_size,
                                  lr, _u8ptr(out), cap)
    if nbits < 0:
        raise RuntimeError("ANS1 block encode: output capacity exceeded")
    return out[:(int(nbits) + 7) >> 3], int(nbits)


def ans1_dec_block(buf: bytes, nbits: int, bitpos: int, count: int,
                   chunk_size: int):
    """Whole-block order-1 ANS decode. Returns (newpos, out ndarray)."""
    from kanzi_tpu_torch.bitstream.reader import BitStreamError
    lib = _load("transforms")
    out = np.empty(count, np.uint8)
    decoded = ctypes.c_int64(0)
    rc = lib.kz_ans1_dec_block(
        _bufp(buf),
        nbits, bitpos, count, chunk_size, _u8ptr(out),
        ctypes.byref(decoded))
    if rc == -2:
        raise BitStreamError("read past end of bitstream")
    if rc < 0:
        raise ValueError("Invalid bitstream: bad ANS chunk")
    return int(rc), out[:decoded.value]



def fsd_scan(src: np.ndarray) -> np.ndarray:
    """FSD stride-XOR histograms [7,256] int64 for strides
    {0,1,2,3,4,8,16} over the 3 sampled sub-blocks."""
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    h = np.empty((7, 256), np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.kz_fsd_scan(_u8ptr(src), len(src), h.ctypes.data_as(i64p))
    return h


def alias_emit(src: np.ndarray, map16: np.ndarray):
    """Digram substitution pass. Returns (bytes, odd_flag)."""
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    map16 = np.ascontiguousarray(map16, np.int64)
    dst = np.empty(len(src) + 1, np.uint8)
    odd = ctypes.c_int(0)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = lib.kz_alias_emit(_u8ptr(src), len(src),
                          map16.ctypes.data_as(i64p), _u8ptr(dst),
                          ctypes.byref(odd))
    return dst[:n].tobytes(), bool(odd.value)


def ans1_sym_idx(chunk: np.ndarray) -> np.ndarray:
    """Order-1 lane-walk [steps,4] int32 table indexes."""
    lib = _load("transforms")
    chunk = np.ascontiguousarray(chunk, np.uint8)
    steps = (len(chunk) & -4) >> 2
    out = np.empty((steps, 4), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.kz_ans1_sym_idx(_u8ptr(chunk), len(chunk),
                        out.ctypes.data_as(i32p))
    return out


def ans_f2s(freqs: np.ndarray, lr: int) -> np.ndarray:
    """freq->symbol inverse map [dim, 1<<lr] u8 (clamped + truncated)."""
    lib = _load("transforms")
    freqs = np.ascontiguousarray(freqs, np.int64)
    dim = freqs.shape[0]
    out = np.empty((dim, 1 << lr), np.uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.kz_ans_f2s(freqs.ctypes.data_as(i64p), dim, lr, _u8ptr(out))
    return out


def ans1_hist(chunk: np.ndarray) -> np.ndarray:
    """Order-1 histogram [256,256] int64 (4-quarter semantics)."""
    lib = _load("transforms")
    chunk = np.ascontiguousarray(chunk, np.uint8)
    hist = np.empty(65536, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.kz_ans1_hist(_u8ptr(chunk), len(chunk), hist.ctypes.data_as(i64p))
    return hist.reshape(256, 256)


def ans1_norm(hist: np.ndarray) -> np.ndarray:
    """Normalize all 256 contexts of an order-1 histogram in place to
    scale 2048; returns the freqs array [256,256] int64."""
    lib = _load("transforms")
    hist = np.ascontiguousarray(hist, np.int64).reshape(-1)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.kz_ans1_norm(hist.ctypes.data_as(i64p))
    return hist.reshape(256, 256)


def zrlt_forward(src: np.ndarray, cap: int):
    """Returns output array or None (output would not fit in cap)."""
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    dst = np.empty(cap, np.uint8)
    n = lib.kz_zrlt_forward(_u8ptr(src), len(src), _u8ptr(dst), cap)
    return None if n < 0 else dst[:n]


def zrlt_inverse(src: np.ndarray, limit: int | None = None) -> np.ndarray:
    """ZRLT inverse of src; limit (None: none) the most bytes the output
    may hold: past it ValueError, before a byte of the run is written (a
    corrupt run of k digits asks for 2^k bytes)."""
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    cap = 8 * len(src) + 1024
    if limit is not None:
        cap = min(cap, limit)
    while True:
        dst = np.empty(cap, np.uint8)
        n = lib.kz_zrlt_inverse(_u8ptr(src), len(src), _u8ptr(dst), cap)
        if n == -2:
            raise ValueError("ZRLT: malformed escape at end of input")
        if n == -3:
            if limit is not None and cap >= limit:
                raise ValueError(f"ZRLT: malformed input (output past "
                                 f"{limit} bytes)")
            cap = cap * 4 if limit is None else min(cap * 4, limit)
            continue
        return dst[:n]


def hist_o01(src: np.ndarray):
    """Returns (freqs0[256], freqs1[256,256]) int64, prev seeded 0."""
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    h0 = np.empty(256, np.int64)
    h1 = np.empty(65536, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.kz_hist_o01(_u8ptr(src), len(src),
                    h0.ctypes.data_as(i64p), h1.ctypes.data_as(i64p))
    return h0, h1.reshape(256, 256)


def shift_bytes(buf, offset_bytes: int, n: int, r: int,
                out: np.ndarray | None = None) -> np.ndarray:
    """dst[i] = buf[off+i]<<r | buf[off+i+1]>>(8-r) for i in [0,n) --
    the misaligned payload extraction, one C pass. buf needs n+1
    readable bytes at offset. `out` (uint8, contiguous, >= n) is
    written in place when given."""
    lib = _load("transforms")
    if out is None:
        out = np.empty(n, np.uint8)
    src = np.frombuffer(buf, np.uint8, n + 1, offset_bytes)
    lib.kz_shift_bytes(_bufp(src), n, r, _u8ptr(out))
    return out


def hist_o0(src: np.ndarray):
    """Order-0 histogram only (freqs0[256] int64) -- ~3x faster than
    hist_o01 when the order-1 table isn't needed."""
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    h0 = np.empty(256, np.int64)
    lib.kz_hist_o0(_u8ptr(src), len(src),
                   h0.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return h0


def fsd_forward_delta(src: np.ndarray, dist: int, max_out: int):
    """Returns the zigzag/escape payload bytes, or None when it would
    exceed max_out (caller skips the transform)."""
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    dst = np.empty(min(max_out, 2 * len(src)) + 2, np.uint8)
    n = lib.kz_fsd_forward_delta(_u8ptr(src), len(src), dist, max_out,
                                 _u8ptr(dst))
    return None if n < 0 else dst[:n]


def fsd_inverse_delta(src: np.ndarray, dist: int) -> np.ndarray:
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    dst = np.empty(len(src), np.uint8)
    n = lib.kz_fsd_inverse_delta(_u8ptr(src), len(src), dist, _u8ptr(dst))
    if n < 0:
        raise ValueError("FSD: truncated escape")
    return dst[:n]


def pack_bits_native(codes: np.ndarray, lens: np.ndarray):
    """Returns (packed uint8 array, total_bits)."""
    lib = _load("transforms")
    codes = np.ascontiguousarray(codes, np.uint32)
    lens = np.ascontiguousarray(lens, np.uint8)
    n = len(codes)
    out = np.zeros(int(lens.sum(dtype=np.int64)) // 8 + 16, np.uint8)
    total = lib.kz_pack_bits(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        _u8ptr(lens), n, _u8ptr(out))
    return out[:(total + 7) // 8], int(total)


def huff_code_lengths(freqs_by_rank, count: int):
    """Returns (lengths list, maxlen)."""
    lib = _load("transforms")
    data = np.ascontiguousarray(np.asarray(freqs_by_rank[:count], np.int64))
    maxlen = lib.kz_huff_code_lengths(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), count)
    return data, int(maxlen)


def lzx_inverse_into(src: np.ndarray, out: np.ndarray):
    """LZ inverse writing into `out`. Returns the output length, or
    None when `out` is too small (caller falls back to the growing
    path). Raises on malformed streams."""
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    n = lib.kz_lzx_inverse(_u8ptr(src), len(src), _u8ptr(out), out.size)
    if n == -2:
        raise ValueError("LZ codec: malformed stream")
    if n == -3:
        return None
    return int(n)


def lzx_inverse(src: np.ndarray, dst_cap: int):
    """Returns output array; raises ValueError on malformed stream."""
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    cap = dst_cap
    while True:
        dst = np.empty(cap, np.uint8)
        n = lib.kz_lzx_inverse(_u8ptr(src), len(src), _u8ptr(dst), cap)
        if n == -2:
            raise ValueError("LZ codec: malformed stream")
        if n == -3:
            if cap >= (1 << 30):
                raise ValueError("LZ codec: output overflow")
            cap *= 4
            continue
        return dst[:n]


def huff_dec_frag(buf: bytes, sz_frag: int, tbl_sym: np.ndarray,
                  tbl_len: np.ndarray, out: np.ndarray) -> int:
    """Decode one Huffman fragment; returns bits consumed."""
    lib = _load("transforms")
    b = np.frombuffer(buf + b"\x00" * 8, np.uint8)
    tbl_sym = np.ascontiguousarray(tbl_sym, np.uint8)
    tbl_len = np.ascontiguousarray(tbl_len, np.uint8)
    return int(lib.kz_huff_dec_frag(_u8ptr(b), sz_frag, _u8ptr(tbl_sym),
                                    _u8ptr(tbl_len), _u8ptr(out)))


def rolz1_parse(data_padded: np.ndarray, count: int, base: int,
                size_chunk: int, src_end: int, cond: bool, delta: int,
                min_match: int, lpc: int, counters: np.ndarray,
                matches: np.ndarray):
    """Returns (lit, tk, lens, midx) byte arrays for one chunk."""
    lib = _load("transforms")
    cap = size_chunk + 32
    lit = np.empty(cap, np.uint8)
    tk = np.empty(cap, np.uint8)
    lens = np.empty(cap, np.uint8)
    midx = np.empty(cap, np.uint8)
    outl = np.zeros(4, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)

    def p64(i):
        return ctypes.cast(outl.ctypes.data + 8 * i, i64p)

    lib.kz_rolz1_parse(
        _u8ptr(data_padded), count, base, size_chunk, src_end,
        int(cond), delta, min_match, lpc,
        counters.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        matches.ctypes.data_as(u32p),
        _u8ptr(lit), p64(0), _u8ptr(tk), p64(1),
        _u8ptr(lens), p64(2), _u8ptr(midx), p64(3))
    return (lit[:outl[0]], tk[:outl[1]], lens[:outl[2]], midx[:outl[3]])


def range_enc_block(src: np.ndarray, chunk_size: int, log_range: int):
    """Whole-block range encode. Returns (bits array, nbits) or None."""
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    cap = 2 * len(src) + 65536
    dst = np.empty(cap, np.uint8)
    nb = lib.kz_range_enc_block(_u8ptr(src), len(src), chunk_size,
                                log_range, _u8ptr(dst), cap)
    if nb < 0:
        return None
    return dst[:(nb + 7) // 8], int(nb)


def range_dec_block(buf: np.ndarray, nbits: int, pos: int, count: int,
                    chunk_size: int):
    """Whole-block range decode. Returns (new bit pos, out array)."""
    lib = _load("transforms")
    out = np.empty(count, np.uint8)
    dec = np.zeros(1, np.int64)
    p = lib.kz_range_dec_block(_bufp(buf), nbits, pos, count, chunk_size,
                               _u8ptr(out),
                               dec.ctypes.data_as(
                                   ctypes.POINTER(ctypes.c_int64)))
    if p < 0:
        raise ValueError("Range decoder: malformed stream")
    return int(p), out[:dec[0]]


def rolz2_forward(data_padded: np.ndarray, count: int, cond: bool,
                  delta: int, min_match: int):
    """ROLZX coder stream (without the 5-byte header); None = skip."""
    lib = _load("transforms")
    dst = np.empty(count + 64, np.uint8)
    n = lib.kz_rolz2_forward(_u8ptr(data_padded), count, int(cond),
                             delta, min_match, _u8ptr(dst), count + 64)
    if n < 0:
        return None
    return dst[:n]


def rolz2_inverse(data: np.ndarray, idx0: int, dst_end: int, cond: bool,
                  delta: int, min_match: int) -> np.ndarray:
    """ROLZX inverse; raises on malformed streams."""
    lib = _load("transforms")
    out = np.empty(dst_end, np.uint8)
    data = np.ascontiguousarray(data, np.uint8)
    n = lib.kz_rolz2_inverse(_u8ptr(data), len(data), idx0, dst_end,
                             int(cond), delta, min_match, _u8ptr(out))
    if n < 0:
        raise ValueError("ROLZX: malformed stream")
    return out[:n]


def rolz1_rebuild(lit: np.ndarray, tk: np.ndarray, lens: np.ndarray,
                  midx: np.ndarray, out: np.ndarray, chunk_base: int,
                  size_chunk: int, dst_end: int, cond: bool, delta: int,
                  min_match: int, lpc: int, counters: np.ndarray,
                  matches: np.ndarray) -> int:
    lib = _load("transforms")
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lens_p = np.concatenate([np.asarray(lens, np.uint8),
                             np.zeros(4, np.uint8)])
    rc = lib.kz_rolz1_rebuild(
        _u8ptr(np.ascontiguousarray(lit, np.uint8)), len(lit),
        _u8ptr(np.ascontiguousarray(tk, np.uint8)), len(tk),
        _u8ptr(lens_p), len(lens),
        _u8ptr(np.ascontiguousarray(midx, np.uint8)), len(midx),
        _u8ptr(out), chunk_base, size_chunk, dst_end,
        int(cond), delta, min_match, lpc,
        counters.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        matches.ctypes.data_as(u32p))
    if rc == -2:
        raise ValueError("ROLZ: malformed chunk")
    if rc == -3:
        raise ValueError("ROLZ: buffers not fully consumed")
    return int(rc)


def exe_forward(src: np.ndarray, arm: bool, code_start: int,
                code_end: int, dst_capacity: int):
    """EXE x86/ARM64 forward rewrite loop. Returns output array or None
    (transform skipped)."""
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    dst = np.empty(dst_capacity + 8, np.uint8)
    fn = lib.kz_exe_fwd_arm if arm else lib.kz_exe_fwd_x86
    n = fn(_u8ptr(src), len(src), code_start, code_end, dst_capacity,
           _u8ptr(dst))
    return None if n < 0 else dst[:n]


def exe_inverse(src: np.ndarray, arm: bool):
    """EXE inverse rewrite loop. Raises on malformed stream."""
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    dst = np.empty(len(src) + 8, np.uint8)
    fn = lib.kz_exe_inv_arm if arm else lib.kz_exe_inv_x86
    n = fn(_u8ptr(src), len(src), _u8ptr(dst))
    if n < 0:
        raise ValueError("EXE codec: invalid stream")
    return dst[:n]


def exe_detect_scan(src, code_start: int, code_end: int):
    """Returns (histo int64[256], jumps_x86, jumps_arm). src may be an
    ndarray, bytes, or a list of ints."""
    lib = _load("transforms")
    if isinstance(src, (bytes, bytearray)):
        src = np.frombuffer(src, np.uint8)
    src = np.ascontiguousarray(src, np.uint8)
    histo = np.zeros(256, np.int64)
    jumps = np.zeros(2, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.kz_exe_detect_scan(_u8ptr(src), code_start, code_end,
                           histo.ctypes.data_as(i64p),
                           jumps.ctypes.data_as(i64p))
    return histo, int(jumps[0]), int(jumps[1])


def rlt_forward(src: np.ndarray, escape: int, dst_end: int):
    """Returns output array or None (transform skipped)."""
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    dst = np.empty(dst_end + 8, np.uint8)
    n = lib.kz_rlt_forward(_u8ptr(src), len(src), escape, _u8ptr(dst),
                           dst_end)
    return None if n < 0 else dst[:n]


def suffix_array(src: np.ndarray) -> np.ndarray:
    lib = _load("sais")
    n = len(src)
    sa = np.empty(n, np.int32)
    src = np.ascontiguousarray(src, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.kz_sa(src.ctypes.data_as(u8p), n,
                   sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise MemoryError("kz_sa failed")
    return sa


def bwt_forward(src: np.ndarray, idx_count: int):
    lib = _load("sais")
    n = len(src)
    out = np.empty(n, np.uint8)
    idxs = np.zeros(idx_count, np.int64)
    src = np.ascontiguousarray(src, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.kz_bwt_forward(src.ctypes.data_as(u8p), n, idx_count,
                            out.ctypes.data_as(u8p),
                            idxs.ctypes.data_as(i64p))
    if rc != 0:
        raise MemoryError("kz_bwt_forward failed")
    return out, [int(v) for v in idxs]


def rlt_inverse(src: np.ndarray, dst_cap: int) -> np.ndarray:
    """RLT inverse; raises on malformed streams, returns None when the
    caller's capacity guess was too small (retry bigger)."""
    lib = _load("transforms")
    src = np.ascontiguousarray(src, np.uint8)
    dst = np.empty(dst_cap, np.uint8)
    n = lib.kz_rlt_inverse(_u8ptr(src), len(src), _u8ptr(dst), dst_cap)
    if n == -2:
        raise ValueError("RLT: malformed stream")
    if n == -3:
        return None
    return dst[:n]


def bwts_forward(src: np.ndarray) -> np.ndarray:
    lib = _load("sais")
    src = np.ascontiguousarray(src, np.uint8)
    dst = np.empty(len(src), np.uint8)
    lib.kz_bwts_forward(_u8ptr(src), len(src), _u8ptr(dst))
    return dst


def bwts_inverse(src: np.ndarray) -> np.ndarray:
    lib = _load("sais")
    src = np.ascontiguousarray(src, np.uint8)
    dst = np.empty(len(src), np.uint8)
    lib.kz_bwts_inverse(_u8ptr(src), len(src), _u8ptr(dst))
    return dst


def bwt_inverse(bwt: np.ndarray, indexes,
                out: np.ndarray | None = None) -> np.ndarray:
    lib = _load("sais")
    n = len(bwt)
    dst = out if out is not None else np.empty(n, np.uint8)
    idxs = np.ascontiguousarray(np.asarray(indexes, np.int64))
    bwt = np.ascontiguousarray(bwt, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.kz_bwt_inverse(bwt.ctypes.data_as(u8p), n,
                            idxs.ctypes.data_as(i64p), len(idxs),
                            dst.ctypes.data_as(u8p))
    if rc == -2:
        raise ValueError("BWT: invalid primary index")
    if rc != 0:
        raise MemoryError("kz_bwt_inverse failed")
    return dst


def bincoder_new(kind: int, bs_version: int, states_size: int,
                 mixers_size: int, hash_size: int, buffer_size: int):
    lib = _load("bincoder")
    h = lib.kz_bin_new(kind, bs_version, states_size, mixers_size,
                       hash_size, buffer_size)
    return h or None


def bincoder_free(h) -> None:
    lib = _load("bincoder")
    if lib is not None:
        lib.kz_bin_free(h)


def bincoder_get_low(h) -> int:
    return int(_load("bincoder").kz_bin_get_low(h))


def bincoder_enc_chunk(h, src: np.ndarray):
    """Encode one chunk; returns (buf, n_out). n_out < 0 on overflow."""
    lib = _load("bincoder")
    n = len(src)
    cap = 2 * n + 64  # worst case: <= 16 output bits per input bit / 8
    dst = np.empty(cap, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    src = np.ascontiguousarray(src, np.uint8)
    n_out = lib.kz_bin_enc_chunk(h, src.ctypes.data_as(u8p), n,
                                 dst.ctypes.data_as(u8p), cap)
    return dst, int(n_out)


def bincoder_dec_chunk(h, payload: np.ndarray, sz: int, current: int,
                       out: np.ndarray) -> int:
    lib = _load("bincoder")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    payload = np.ascontiguousarray(payload, np.uint8)
    return int(lib.kz_bin_dec_chunk(h, payload.ctypes.data_as(u8p), sz,
                                    current, out.ctypes.data_as(u8p),
                                    len(out)))


_lzx_tables: dict = {}


def lzx_forward(src: np.ndarray, hash_log: int, min_match: int):
    """Native LZX forward; returns output bytes array or None (skip)."""
    lib = _load("lzx")
    count = len(src)
    cap = (count + 16 if count <= 1024 else count + count // 64) + 2 + 16
    dst = np.empty(cap, np.uint8)      # kernel writes every byte it returns
    # reuse the hash-table scratch: a fresh np.zeros is a new mmap whose
    # page faults cost more than the memset
    import threading
    key = (hash_log, threading.get_ident())
    table = _lzx_tables.get(key)
    if table is None:
        table = _lzx_tables.setdefault(key, np.zeros(1 << hash_log, np.int32))
    else:
        table.fill(0)
    src = np.ascontiguousarray(src, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.kz_lzx_forward(
        src.ctypes.data_as(u8p), count, hash_log, min_match,
        dst.ctypes.data_as(u8p), cap,
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if n < 0:
        return None
    return dst[:n]


# the counters of kz_lzx_forward_hinted (csrc/lzx_hint.cpp), in order
LZX_HINT_STATS = ("checked", "table_miss", "lcp_miss", "dense_visits",
                  "table_visits", "flushes", "flushed", "lcp_decided",
                  "cap_resumed", "unmarked", "rep_matches",
                  "marked_prev", "walks", "run_visits")


def lzx_hint_available() -> bool:
    return _load("lzx_hint") is not None


def lzx_forward_hinted(src: np.ndarray, hash_log: int, min_match: int,
                       prev: np.ndarray, lcp: np.ndarray, cap: int = 32,
                       stats: dict = None, check: bool = False):
    """The LZX forward (lzx_forward's bytes; None: skip) parsed from the
    LZ match pass's hints (csrc/lzx_hint.cpp): prev [n] int32 and lcp [n]
    (uint8, or any integers that fit it), capped at cap, of
    ops.lz.lz_match_pass over src at hash_log. stats, a dict, receives
    the parse's counters (LZX_HINT_STATS); check runs the native hash
    table beside the hints and counts each difference ("table_miss",
    "lcp_miss")."""
    lib = _load("lzx_hint")
    count = len(src)
    src = np.ascontiguousarray(src, dtype=np.uint8)
    prev = np.ascontiguousarray(prev, dtype=np.int32)
    lcp = np.ascontiguousarray(lcp, dtype=np.uint8)
    if prev.shape != (count,) or lcp.shape != (count,):
        raise ValueError(f"prev and lcp: [{count}] each")
    cap_out = (count + 16 if count <= 1024 else count + count // 64) + 2 + 16
    dst = np.empty(cap_out, np.uint8)  # the parse writes every byte it returns
    st = np.zeros(len(LZX_HINT_STATS), np.int64)
    n = lib.kz_lzx_forward_hinted(
        _u8ptr(src), count, hash_log, min_match,
        prev.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _u8ptr(lcp),
        cap, _u8ptr(dst), cap_out,
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), int(check))
    if n == -2:
        raise ValueError(f"hash_log {hash_log} or cap {cap} out of range")
    if stats is not None:
        stats.update(zip(LZX_HINT_STATS, st.tolist()))
    return None if n < 0 else dst[:n]


def concat_runs(buf0: np.ndarray, buf1: np.ndarray, sel: np.ndarray,
                offs: np.ndarray, bitlens: np.ndarray):
    """Concatenate bit runs (see native/bitrun.cpp). Returns
    (bytes, total_bits). Runs are byte-aligned in their source buffers;
    the output is a packed MSB-first bit string."""
    lib = _load("bitrun")
    total_bits = int(bitlens.sum())
    out = np.zeros((total_bits + 7) // 8 + 8, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    sel = np.ascontiguousarray(sel, dtype=np.uint8)
    offs = np.ascontiguousarray(offs, dtype=np.uint64)
    bl = np.ascontiguousarray(bitlens, dtype=np.uint64)
    buf0 = np.ascontiguousarray(buf0, dtype=np.uint8)
    buf1 = np.ascontiguousarray(buf1, dtype=np.uint8)
    end = lib.kz_concat_runs(
        out.ctypes.data_as(u8p), 0,
        buf0.ctypes.data_as(u8p), buf1.ctypes.data_as(u8p),
        sel.ctypes.data_as(u8p), offs.ctypes.data_as(u64p),
        bl.ctypes.data_as(u64p), len(sel))
    assert end == total_bits
    return out[: (total_bits + 7) // 8].tobytes(), total_bits
