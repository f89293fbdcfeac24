"""A copy of the benchmark's files at a size the CPU runs: the cells of
BENCHMARK.json with their configurations' blocks cut to a few KiB and
their traffics' members to a few KB, for runs of gpubench/run.py with the
kernels' plain versions (device_check=False and a CPU mesh)."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SIZES = {"kanzi-l7": 2048, "kanzi-l5": 32768}


def make_root(path: str) -> str:
    """BENCHMARK.json and gpubench/{configs,traffic,metrics} under path,
    cut to CPU sizes."""
    os.makedirs(os.path.join(path, "gpubench"), exist_ok=True)
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(REPO, "gpubench", sub),
                        os.path.join(path, "gpubench", sub), dirs_exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), path)
    for name, bs in SIZES.items():
        p = os.path.join(path, "gpubench", "configs", name + ".json")
        cfg = json.load(open(p))
        cfg["block_size"] = bs
        json.dump(cfg, open(p, "w"))
    for name in ("enwik8", "chunks", "silesia"):
        p = os.path.join(path, "gpubench", "traffic", name + ".json")
        tr = json.load(open(p))
        for m in tr["members"]:
            m["size"] = 6000 if name != "silesia" else 3000
            # a block of code whose entropy stage has a full 16 KiB chunk
            m["size"] = 40000 if m["name"] == "mozilla" else m["size"]
        if name == "silesia":
            tr["tar_size"] = sum(512 + m["size"] + (-m["size"] % 512)
                                 for m in tr["members"]) + 1024
        if name == "chunks":
            tr["split"].update(min=1024, mean_extra=1024, max=4096)
        json.dump(tr, open(p, "w"))
    return path


def run(root: str, workload: str, seed: int = 5, seconds: float = 0.1,
        trace: int = 0, fault: str | None = None) -> tuple:
    """(exit code, the result line as a dict or None) of one CPU run."""
    from gpubench import run as harness
    argv = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    if fault:
        argv += ["--fault", fault]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = harness.main(argv, device_check=False,
                          mesh=(torch.device("cpu"),), root=root)
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
