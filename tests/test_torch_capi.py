"""The port's FILE* C API (kanzi_tpu_torch/csrc/capi.cpp, built by
kanzi_tpu_torch.utils.native.capi_library()) against kanzi_tpu's
(native/capi.cpp, built as tests/test_capi.py builds it).

One script driver (tests/test_torch_capi.c) runs every combination in one
process a library, on the host path (KANZI_TPU_DISABLE=1): the four
entropy coders of the container, an LZ and the level-3 transform chain,
checksums 0, 32 and 64, headerless streams, jobs 1 and 4. Both libraries
must write the bytes of the port's Python API with the same settings
(python_api: a CompressedWriter, as the libraries stream the input, so
the header holds no original size, where compress_bytes writes it; ops
disabled), decode them back to the input, and return the same error
codes. With the ops enabled and no card the port's library must fail,
not code on the CPU. tests/test_capi.c runs unchanged against the port's library too.
Skipped without a C toolchain or the interpreter's shared library.
"""

import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import kanzi_tpu_torch as ktt
import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")
TESTS = os.path.join(REPO, "tests")

# (transform, entropy, block size, jobs, checksum, headerless)
COMBOS = [
    ("NONE", "ANS0", 65536, 1, 0, 0),
    ("NONE", "ANS0", 32768, 4, 0, 1),
    ("NONE", "HUFFMAN", 65536, 4, 32, 0),
    ("NONE", "ANS1", 65536, 1, 64, 0),
    ("NONE", "FPAQ", 32768, 4, 0, 0),
    ("LZ", "HUFFMAN", 65536, 4, 32, 0),
    ("TEXT+UTF+PACK+MM+LZX", "HUFFMAN", 65536, 1, 64, 0),
    ("TEXT+UTF+PACK+MM+LZX", "HUFFMAN", 65536, 4, 0, 1),
]
# calls that fail: an oversized compress() (and its dispose), an unknown
# transform and entropy name, NULL arguments
ERRORS = ["o NONE ANS0 65536", "o BOGUS ANS0 65536", "o NONE BOGUS 65536",
          "m"]
TIMEOUT = 240


def _data() -> bytes:
    rng = np.random.default_rng(19)
    words = [b"the ", b"file ", b"api ", b"kanzi ", b"card ", b"stream "]
    text = b"".join(words[i] for i in rng.integers(0, len(words), 20000))
    return (text[:80000] + rng.integers(0, 256, 40000, np.uint8).tobytes()
            + bytes(20000) + rng.integers(0, 4, 30000, np.uint8).tobytes())


def python_api(data: bytes, transform: str, entropy: str, block: int,
               jobs: int, checksum: int, headerless: int) -> bytes:
    """The container the C API writes, from the port's Python API in
    this process: a CompressedWriter fed the input a block at a time."""
    sink = io.BytesIO()
    w = ktt.CompressedWriter(sink, transform=transform, entropy=entropy,
                             block_size=block, checksum_bits=checksum,
                             headerless=bool(headerless), jobs=jobs)
    for pos in range(0, len(data), block):
        w.write(data[pos:pos + block])
    w.close()
    return sink.getvalue()


def _corrupt(blob: bytes) -> dict:
    n = len(blob)
    bad = {"magic": bytes([blob[0] ^ 0xFF]) + blob[1:],
           "truncated": blob[:n // 2], "empty": b""}
    for off in (n // 3, 2 * n // 3):
        b = bytearray(blob)
        b[off] ^= 0xA5
        bad[f"payload {off}"] = bytes(b)
    return bad


def _script(d, data_path) -> list:
    lines = []
    for i, (t, e, bs, jobs, ck, hl) in enumerate(COMBOS):
        knz, out = os.path.join(d, f"{i}.knz"), os.path.join(d, f"{i}.out")
        lines.append(f"c {data_path} {knz} {t} {e} {bs} {jobs} {ck} {hl}")
        if hl:
            lines.append(f"d {knz} {out} {jobs} 1 {t} {e} {bs} "
                         f"{os.path.getsize(data_path)} {ck}")
        else:
            lines.append(f"d {knz} {out} {jobs} 0")
    return lines


def _run(exe, d, lines, disable=True):
    path = os.path.join(d, "script.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    env = dict(os.environ)
    env["KANZI_TPU_PYROOT"] = REPO        # kanzi_tpu's library
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTHONPATH", None)
    env.pop("KANZI_TPU_DISABLE", None)
    if disable:
        env["KANZI_TPU_DISABLE"] = "1"
    r = subprocess.run([exe, path], cwd=d, env=env, capture_output=True,
                       text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-2000:]
    out = [ln.split() for ln in r.stdout.splitlines()
           if ln[:2] in ("c ", "d ", "o ", "m ", "p ")]
    assert len(out) == len(lines), r.stdout[-2000:] + r.stderr[-2000:]
    return out


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """(the port's driver, kanzi_tpu's driver, scratch dir, the input's
    path): tests/test_torch_capi.c linked against each library."""
    gxx, gcc = shutil.which("g++"), shutil.which("gcc")
    if not (gxx and gcc):
        pytest.skip("no C/C++ toolchain")
    try:
        ours = native.capi_library()
    except RuntimeError as e:
        pytest.skip(str(e))
    d = str(tmp_path_factory.mktemp("capi"))
    theirs = os.path.join(d, "libkanzitpu_capi.so")
    inc, libdir, ver = native._embed()
    r = subprocess.run(
        [gxx, "-O2", "-shared", "-fPIC", os.path.join(NATIVE, "capi.cpp"),
         f"-I{inc}", f"-L{libdir}", f"-l{ver}", "-ldl", "-o", theirs],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-1500:]
    exes = []
    for so, name in ((ours, "drv_ours"), (theirs, "drv_theirs")):
        exe = os.path.join(d, name)
        r = subprocess.run(
            [gcc, "-O2", os.path.join(TESTS, "test_torch_capi.c"),
             *native.capi_link_flags(so), "-o", exe],
            capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-1500:]
        exes.append(exe)
    data_path = os.path.join(d, "in.bin")
    with open(data_path, "wb") as f:
        f.write(_data())
    return exes[0], exes[1], d, data_path


@pytest.fixture(scope="module")
def runs(libs):
    """Each library's combinations, its output files kept apart, then
    the error calls and the corrupt streams of the first combination."""
    ours, theirs, d, data_path = libs
    res = {}
    for who, exe in (("ours", ours), ("theirs", theirs)):
        sub = os.path.join(d, who)
        os.makedirs(sub, exist_ok=True)
        out = _run(exe, sub, _script(sub, data_path) + ERRORS)
        blobs = [open(os.path.join(sub, f"{i}.knz"), "rb").read()
                 for i in range(len(COMBOS))]
        backs = [open(os.path.join(sub, f"{i}.out"), "rb").read()
                 for i in range(len(COMBOS))]
        res[who] = (out, blobs, backs)
    return res


def test_capi_writes_the_python_apis_bytes(runs):
    """For every combination both libraries write the bytes of the
    port's Python API with the same settings (host path), and those equal
    compress_bytes' past the header's original size field."""
    data = _data()
    tops.disable()
    try:
        want = [python_api(data, *combo) for combo in COMBOS]
        whole = ktt.compress_bytes(data, *COMBOS[0][:2],
                                   block_size=COMBOS[0][2])
    finally:
        tops.enable()
    assert len(whole) > len(want[0]) and whole[-64:] == want[0][-64:]
    for who in ("ours", "theirs"):
        out, blobs, _ = runs[who]
        for i, combo in enumerate(COMBOS):
            c = out[2 * i]
            assert c[:2] == ["c", "0"], (who, combo, c)
            assert int(c[3]) == len(blobs[i]), (who, combo)
            assert c[5:] == list(combo[:2]), (who, combo, c)
            assert blobs[i] == want[i], (who, combo)


def test_capi_decodes_to_the_input(runs):
    data = _data()
    for who in ("ours", "theirs"):
        out, _, backs = runs[who]
        for i, combo in enumerate(COMBOS):
            assert out[2 * i + 1][:3] == ["d", "0", str(len(data))], \
                (who, combo)
            assert backs[i] == data, (who, combo)


def test_capi_error_codes_match(runs):
    """An oversized compress() (18), an unknown transform or entropy
    name, NULL arguments (1): the same codes from both libraries."""
    k = 2 * len(COMBOS)
    ours, theirs = runs["ours"][0][k:], runs["theirs"][0][k:]
    assert ours == theirs
    assert ours[0] == ["o", "0", "18", "0"]
    assert ours[1][1] != "0" and ours[2][1] != "0"
    assert ours[3] == ["m"] + ["1"] * 6


def test_capi_corrupt_streams_match(libs, runs):
    """Corrupt streams (a bad magic, a truncation, no bytes, flipped
    payload bytes under a 32-bit checksum) decoded by both libraries:
    the same return code, non-zero but for a stream that decodes."""
    ours, theirs, d, _ = libs
    i = next(j for j, c in enumerate(COMBOS) if c[4] == 32)
    bad = _corrupt(runs["ours"][1][i])
    lines = []
    for j, (name, blob) in enumerate(sorted(bad.items())):
        p = os.path.join(d, f"bad{j}.knz")
        with open(p, "wb") as f:
            f.write(blob)
        lines.append(f"d {p} {p}.out 1 0")
    got = {who: _run(exe, d, lines) for who, exe in (("ours", ours),
                                                     ("theirs", theirs))}
    assert [c[1] for c in got["ours"]] == [c[1] for c in got["theirs"]]
    assert sum(c[1] != "0" for c in got["ours"]) >= 4


def test_capi_without_a_card_fails(libs):
    """The ops enabled and no card: the port's library returns non-zero
    codes (the container raises); it never codes on the CPU itself."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ours, _, d, data_path = libs
    sub = os.path.join(d, "nocard")
    os.makedirs(sub, exist_ok=True)
    out = _run(ours, sub, [f"c {data_path} {sub}/a.knz NONE ANS0 65536 1 0 0",
                           "p kanzi_tpu_torch.ops"], disable=False)
    assert out[0][1] != "0"
    assert out[1] == ["p", "{}"]


def test_capi_c_program_runs_against_the_port(libs, tmp_path):
    """tests/test_capi.c, unchanged, linked against the port's library:
    its compress, decompress and error paths pass (CAPI-OK), and its
    container decodes with kanzi_tpu_torch's reader."""
    so = native.capi_library()
    exe = tmp_path / "test_capi"
    r = subprocess.run(
        ["gcc", "-O2", os.path.join(TESTS, "test_capi.c"),
         *native.capi_link_flags(so), "-o", str(exe)],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-1500:]
    env = dict(os.environ, KANZI_TPU_DISABLE="1")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([str(exe)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, f"rc={r.returncode}\n{r.stderr[-1500:]}"
    assert "CAPI-OK" in r.stdout
    blob = (tmp_path / "capi_test.knz").read_bytes()
    assert len(ktt.decompress_bytes(blob, device="cpu")) == 300000


def test_capi_library_is_keyed_and_cached():
    """capi_library() builds into build/kanzi_tpu_torch/native/ once: a
    second call returns the same file."""
    try:
        so = native.capi_library()
    except RuntimeError as e:
        pytest.skip(str(e))
    assert so == native.capi_library()
    assert os.path.dirname(so) == native.BUILD_DIR
    assert os.path.basename(so).startswith("libkanzitpu_torch_capi_")


_CTYPES = r"""
import ctypes, sys
import kanzi_tpu_torch as ktt

class CData(ctypes.Structure):
    _fields_ = [("transform", ctypes.c_char * 64),
                ("entropy", ctypes.c_char * 16),
                ("blockSize", ctypes.c_size_t), ("jobs", ctypes.c_uint),
                ("checksum", ctypes.c_int), ("headerless", ctypes.c_int)]

lib = ctypes.CDLL(sys.argv[1])
libc = ctypes.CDLL(None)
libc.fopen.restype = ctypes.c_void_p
libc.fopen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
libc.fclose.argtypes = [ctypes.c_void_p]
lib.initCompressor.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p]
lib.compress.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                         ctypes.c_void_p]
lib.disposeCompressor.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
data = bytes(range(256)) * 400 + b"loaded into a running interpreter" * 99
p = CData(b"LZ", b"HUFFMAN", 65536, 2, 32, 0)
f = libc.fopen(sys.argv[2].encode(), b"wb")
ctx = ctypes.c_void_p()
n = ctypes.c_size_t()
rcs = [lib.initCompressor(ctypes.byref(p), f, ctypes.byref(ctx))]
for pos in range(0, len(data), 65536):
    rcs.append(lib.compress(ctx, data[pos:pos + 65536],
                            len(data[pos:pos + 65536]), ctypes.byref(n)))
rcs.append(lib.disposeCompressor(ctypes.byref(ctx), ctypes.byref(n)))
libc.fclose(f)
blob = open(sys.argv[2], "rb").read()
print("RCS", rcs, len(blob) == n.value,
      ktt.decompress_bytes(blob, device="cpu") == data)
"""


def test_capi_in_a_running_interpreter(libs, tmp_path):
    """The port's library loaded with ctypes into a running interpreter
    (Py_IsInitialized() already true, the caller's GIL released by
    ctypes around each call): it uses that interpreter, -j 2 and a
    checksum included, and writes a container its reader decodes."""
    env = dict(os.environ, KANZI_TPU_DISABLE="1", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _CTYPES, native.capi_library(),
                        str(tmp_path / "a.knz")], env=env,
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-1500:]
    assert "RCS [0, 0, 0, 0] True True" in r.stdout, r.stdout[-500:]
