"""kanzi_tpu_torch imports neither JAX nor kanzi_tpu. Checked in a fresh
interpreter per level (tests/conftest.py imports jax into the test
process itself) and in the sources."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

_ROUNDTRIP = """
import sys
import numpy as np
import kanzi_tpu_torch as k
import kanzi_tpu_torch.api, kanzi_tpu_torch.app.cli, kanzi_tpu_torch.ops._build
import kanzi_tpu_torch.ops as ops
from kanzi_tpu_torch.app.cli import LEVEL_TABLE
level = int(sys.argv[1])
rng = np.random.default_rng(0)
words = [b"entropy", b"kernel", b"block", b"stream", b"the"]
data = (b" ".join(words[i] for i in rng.integers(0, 5, 12000))
        + rng.integers(0, 256, 60000, dtype=np.uint8).tobytes())
blob = k.compress_bytes(data, *LEVEL_TABLE[level], block_size=1 << 16,
                        device="cpu")
assert k.decompress_bytes(blob, device="cpu") == data
encoder = {2: "huff_pack", 3: "huff_pack", 4: "ans0_encode_scan",
           5: "ans0_encode_scan"}.get(level)
if encoder:
    assert ops.COUNTERS[encoder + "_plain"] >= 1, ops.COUNTERS
    decoder = encoder.split("_")[0] + "_decode_plain"
    assert ops.COUNTERS[decoder] >= 1, ops.COUNTERS
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "kanzi_tpu"))
print("FOREIGN_MODULES", bad)
"""


@pytest.mark.parametrize("level", range(10))
def test_roundtrip_imports_no_jax(level):
    """A round trip at each level leaves no jax* and no kanzi_tpu or
    kanzi_tpu.* module in sys.modules (level 4 once reached JAX through
    ROLZ's ANS sub-streams)."""
    r = subprocess.run([sys.executable, "-c", _ROUNDTRIP, str(level)],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "FOREIGN_MODULES []" in r.stdout, r.stdout


_FPAQ_DEVICE = """
import sys
import numpy as np
import kanzi_tpu_torch as k
import kanzi_tpu_torch.ops.ans1, kanzi_tpu_torch.ops.fpaq
import kanzi_tpu_torch.io.compressed_stream as cs
import kanzi_tpu_torch.ops as ops
cs._fpaq_on_device = lambda dev, lens: True
rng = np.random.default_rng(1)
data = b"fpaq " * 600 + rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
blob = k.compress_bytes(data, "NONE", "FPAQ", block_size=4096, device="cpu")
assert ops.COUNTERS == {"fpaq_encode_plain": 1,
                       "fpaq_encode_streams": 2}, ops.COUNTERS
assert k.decompress_bytes(blob, device="cpu") == data
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "kanzi_tpu"))
print("FOREIGN_MODULES", bad)
"""


def test_fpaq_device_path_imports_no_jax():
    """-t NONE -e FPAQ through the container's FPAQ batch (its gate
    opened, so the FPAQ encode's plain version runs on the CPU), after
    importing the ANS1 and FPAQ ops, leaves
    no jax* and no kanzi_tpu module in sys.modules."""
    r = subprocess.run([sys.executable, "-c", _FPAQ_DEVICE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "FOREIGN_MODULES []" in r.stdout, r.stdout


_L5_DEVICE = """
import sys
import numpy as np
import torch
import kanzi_tpu_torch.ops as ops
from kanzi_tpu_torch.parallel import pipeline as pp
rng = np.random.default_rng(2)
data = (np.repeat(rng.integers(0, 5, 2048, dtype=np.uint8), 4).tobytes()
        + rng.integers(0, 256, 8192, dtype=np.uint8).tobytes() + b"tail")
mesh = (torch.device("cpu"),)
blob = pp.compress_l5_mesh(data, 4096, mesh)
assert pp.decompress_l5_mesh(blob, mesh) == data
assert ops.COUNTERS["sbrt_plain"] == 2, ops.COUNTERS
assert ops.COUNTERS["l5_decode_device_blocks"] == 4, ops.COUNTERS
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "kanzi_tpu"))
print("FOREIGN_MODULES", bad)
"""


def test_l5_device_chain_imports_no_jax():
    """The device level-5 chain (parallel.pipeline: BWT, RANK through the
    SBRT wrapper, ZRLT, ANS0) round trip on the CPU leaves no jax* and no
    kanzi_tpu module in sys.modules."""
    r = subprocess.run([sys.executable, "-c", _L5_DEVICE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "FOREIGN_MODULES []" in r.stdout, r.stdout


def test_csrc_sources_are_bound():
    """Every CUDA source in csrc/ is built and bound by ops/_build.py, each
    bound launcher is an extern "C" function of its source, and no source
    includes PyTorch's headers (which would make nvcc take minutes)."""
    from kanzi_tpu_torch.ops import _build
    csrc = ROOT / "kanzi_tpu_torch" / "csrc"
    assert sorted(p.name for p in csrc.glob("*.cu")) == sorted(
        _build.SIGNATURES)
    for source, launchers in _build.SIGNATURES.items():
        text = (csrc / source).read_text()
        assert 'extern "C"' in text and "kanzi_cuda_error_string" in text
        assert "torch/" not in text and "ATen" not in text, source
        for name, argtypes in launchers.items():
            m = re.search(rf"^int {name}\(([^)]*)\)", text, re.M)
            assert m, f"{source}: no launcher {name}"
            assert m.group(1).count(",") + 1 == len(argtypes), name


_FOREIGN_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|kanzi_tpu[. ]|"
                             r"kanzi_tpu$)")


def _embedded_python(text: str) -> list:
    """The Python a C++ source embeds: its raw string literals
    R"PY( ... )PY"."""
    return re.findall(r'R"PY\((.*?)\)PY"', text, re.S)


def test_sources_name_no_jax_module():
    """No source file of the port, nor chip_smoke.py, nor the Python that
    the port's C++ sources embed (csrc/capi.cpp's bootstrap), imports jax
    or anything of kanzi_tpu."""
    paths = [*(ROOT / "kanzi_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    for path in paths:
        for line in path.read_text().splitlines():
            assert not _FOREIGN_IMPORT.match(line), f"{path}: {line}"
    blocks = {path: _embedded_python(path.read_text())
              for path in (ROOT / "kanzi_tpu_torch" / "csrc").glob("*.cpp")}
    assert blocks[ROOT / "kanzi_tpu_torch" / "csrc" / "capi.cpp"]
    for path, texts in blocks.items():
        for text in texts:
            for line in text.splitlines():
                assert not _FOREIGN_IMPORT.match(line), f"{path}: {line}"
    # the check reads the bootstrap of kanzi_tpu's own library as foreign
    assert any(_FOREIGN_IMPORT.match(line)
               for text in _embedded_python(
                   (ROOT / "native" / "capi.cpp").read_text())
               for line in text.splitlines())
