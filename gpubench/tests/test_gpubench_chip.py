"""One short run of a cell on the card (skips here, where there is none):
the result line's shape as the contract has it."""

import json
import os
import subprocess
import sys

import pytest

from gpubench import run


@pytest.mark.needs_cuda
def test_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures only there")
    p = subprocess.run([sys.executable, os.path.join(run.HERE, "run.py"),
                        "--workload", "l7.chunks", "--seed", str(2**31 + 99),
                        "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, cwd=run.ROOT,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert {"setup_s", "compress_MBps"} <= set(res["metrics"])


def test_no_card_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, os.path.join(run.HERE, "run.py"),
                        "--workload", "l7.chunks", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=run.ROOT,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
