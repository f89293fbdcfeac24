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
coder = {2: "huff", 3: "huff", 4: "ans0", 5: "ans0"}.get(level)
if coder:
    assert ops.COUNTERS[coder + "_encode_scan_plain"] >= 1, ops.COUNTERS
    assert ops.COUNTERS[coder + "_decode_plain"] >= 1, ops.COUNTERS
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


_FOREIGN_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|kanzi_tpu[. ]|"
                             r"kanzi_tpu$)")


def test_sources_name_no_jax_module():
    """No source file of the port, nor chip_smoke.py, imports jax or
    anything of kanzi_tpu."""
    paths = [*(ROOT / "kanzi_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    for path in paths:
        for line in path.read_text().splitlines():
            assert not _FOREIGN_IMPORT.match(line), f"{path}: {line}"
