"""How a run decides `correct`: what the timed calls produced, held to the
inputs the harness made and to the plain reference decoder
(gpubench/reference/), once the window has closed.

- every decompress call of the window: its output equals the file that
  the round trip compressed, byte for byte;
- every compress call of the window: the reference reads its container
  (header fields as the configuration states them, one frame a block);
- a sample drawn from the seed: whole blocks of one compress call of the
  window, decoded by the reference alone (entropy stage and every
  inverse transform) and held to the input's bytes.

Each number has the limit 0: the format is exact.
"""

from __future__ import annotations

import concurrent.futures as cf
import importlib
import multiprocessing as mp

import numpy as np


def wrong_bytes(got: bytes, want: bytes) -> int:
    n = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, n)
    b = np.frombuffer(want, np.uint8, n)
    return int(np.count_nonzero(a != b)) + abs(len(got) - len(want))


def container_faults(cfg: dict, blob: bytes, size: int) -> tuple:
    """(faults, parsed header or None): the stream's header against the
    configuration and the input, and its frame count."""
    ref = importlib.import_module(cfg["reference"]["module"])
    try:
        hdr = ref.parse(blob)
    except ref.Malformed:
        return 1, None
    want = {"version": 6, "checksum_bits": 0, "entropy": cfg["entropy"],
            "transforms": cfg["transform"].split("+"),
            "block_size": cfg["block_size"], "size": size}
    faults = sum(hdr[k] != v for k, v in want.items())
    faults += len(hdr["frames"]) != -(-size // cfg["block_size"])
    return faults, hdr


def ref_block(module: str, hdr: dict, k: int, want: bytes) -> tuple:
    """(faults, wrong bytes, error) of block k decoded by the reference
    module."""
    ref = importlib.import_module(module)
    try:
        got = ref.decode_block(hdr, k)
    except (ref.Malformed, IndexError) as e:
        return 1, len(want), f"{type(e).__name__}: {e}"
    return 0, wrong_bytes(got, want), None


def sample(rng, trips: list, blocks: int) -> list:
    """[(trip, block)]: one compress call of the window, then `blocks` of
    its blocks, without replacement."""
    done = [i for i, t in enumerate(trips) if t["blob"] is not None]
    if not done:
        return []
    i = done[int(rng.integers(len(done)))]
    n = trips[i]["nblocks"]
    ks = rng.choice(n, min(blocks, n), replace=False)
    return [(i, int(k)) for k in sorted(ks)]


def run_checks(cfg: dict, files: list, trips: list, seed: int,
               log) -> dict:
    """The numbers compared, each {"value", "limit"}."""
    failed_calls = sum(t["error"] is not None for t in trips)
    rt_wrong = sum(wrong_bytes(t["out"], files[t["file"]])
                   for t in trips if t["out"] is not None)
    faults, hdrs = 0, {}
    for i, t in enumerate(trips):
        if t["blob"] is None:
            continue
        f, hdrs[i] = container_faults(cfg, t["blob"], len(files[t["file"]]))
        faults += f
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 1 << 21]))
    picks = [(i, k) for i, k in sample(rng, trips, cfg["reference"]["blocks"])
             if hdrs.get(i) is not None]
    ref_faults, ref_wrong = 0, 0
    bs = cfg["block_size"]
    jobs = []
    for i, k in picks:
        h = dict(hdrs[i], frames=[])
        h["frames"] = {k: hdrs[i]["frames"][k]}
        want = files[trips[i]["file"]][k * bs:(k + 1) * bs]
        jobs.append((cfg["reference"]["module"], h, k, want))
    if len(jobs) > 1:
        ctx = mp.get_context("spawn")
        with cf.ProcessPoolExecutor(len(jobs), mp_context=ctx) as ex:
            res = list(ex.map(ref_block, *zip(*jobs)))
    else:
        res = [ref_block(*j) for j in jobs]
    for (i, k), (f, w, err) in zip(picks, res):
        log(f"reference: call {i} block {k}: faults {f}, wrong bytes {w}"
            + (f" ({err})" if err else ""))
        ref_faults += f
        ref_wrong += w
    unchecked = 0 if picks else 1                 # nothing to decode
    return {"calls_failed": {"value": failed_calls, "limit": 0},
            "roundtrip_wrong_bytes": {"value": rt_wrong, "limit": 0},
            "container_faults": {"value": faults, "limit": 0},
            "ref_block_faults": {"value": ref_faults + unchecked,
                                 "limit": 0},
            "ref_wrong_bytes": {"value": ref_wrong, "limit": 0}}
