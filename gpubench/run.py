"""The benchmark of kanzi_tpu_torch: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (BENCHMARK.json "workloads") names a configuration
(gpubench/configs/<name>.json: the level's chain, coder, block size, entry
functions, warm-up and reference sample) and a traffic mix
(gpubench/traffic/<name>.json, read by gpubench/corpus.py). The run makes
its files from the seed, warms the cell's chain up, then one client
round-trips the files in turn for --seconds: a compress call, then a
decompress call of its output, each timed on the host clock. After the
window it checks what the calls produced (gpubench/check.py) and prints
one JSON line last: with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics (gpubench/metrics/<name>.py, read from
spans, counters and torch.profiler's device trace).

The run fails, and prints no result, without the CUDA cards the cell
asks for, or if jax, jaxlib, flax or kanzi_tpu is loaded once the window
has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "gpubench")
FORBIDDEN = ("jax", "jaxlib", "flax", "kanzi_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole: kanzi_tpu_torch is not kanzi_tpu."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def traffic_of(root: str, name: str) -> dict:
    return load_json(root, "gpubench", "traffic", name + ".json")


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"gpubench: no workload {name!r} in BENCHMARK.json")


def entry(spec: str):
    module, attr = spec.split(":")
    return getattr(importlib.import_module(module), attr)


def metric_module(root: str, name: str):
    """metrics/<name>.py, else metrics/<name before its first dot>.py; the
    part after the dot is the phase the reader is asked for."""
    base, _, phase = name.partition(".")
    for stem in (name, base):
        path = os.path.join(root, "gpubench", "metrics", stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                "gpubench_metric_" + stem.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod, (phase if stem == base else None)
    raise SystemExit(f"gpubench: no reader for metric {name!r}")


def cell_metrics(bench: dict, cell: str, key: str) -> list:
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


def warmup_input(files: list) -> bytes:
    """The warm-up: one round trip of the cell's largest file, so that
    every library, kernel and buffer size the window uses is loaded and
    grown before it (a call's first run otherwise pays its allocations
    inside the window)."""
    return max(files, key=len)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None,
                   help="plant a named fault (gpubench/faults.py) under the "
                        "timed path: for the controls, never in the "
                        "benchmark's own runs")
    return p.parse_args(argv)


def main(argv=None, device_check=True, mesh=None, root=ROOT) -> int:
    """One run. The CPU tests pass device_check=False and a CPU mesh (the
    kernels' plain versions), and root: where BENCHMARK.json and
    gpubench/{configs,traffic,metrics} are read."""
    a = parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "gpubench_cache", sub)
    os.environ.pop("KANZI_TPU_DISABLE", None)
    os.environ["USE_FLAX"] = "0"

    bench = load_json(root, "BENCHMARK.json")
    cell = cell_of(bench, a.workload)
    cfg = load_json(root, "gpubench", "configs", cell["config"] + ".json")
    traffic = traffic_of(root, cell["traffic"])
    from gpubench import corpus, trace

    import torch
    if device_check and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell["chips"]):
        log(f"gpubench: {cell['chips']} CUDA device(s) needed, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " found")
        return 3

    t = time.perf_counter()
    files = corpus.make_files(traffic, a.seed)
    gen_s = time.perf_counter() - t
    total = sum(len(f) for f in files)
    log(f"data: {len(files)} file(s), {total} bytes, made in {gen_s:.3f} s")

    restore = None
    if a.fault:
        from gpubench import faults
        restore = faults.plant(a.fault, cfg)
    tracer = trace.Tracer() if a.trace else None
    try:
        return _measure(a, bench, cell, cfg, traffic, files, gen_s, mesh,
                        device_check, root, tracer)
    finally:
        if tracer:
            tracer.uninstall()
        if restore:
            restore()


def _measure(a, bench, cell, cfg, traffic, files, gen_s, mesh, device_check,
             root, tracer) -> int:
    """The warm-up, the window and the checks of one run (main's body
    once the data is made and any fault planted)."""
    import torch

    from gpubench import check, trace
    compress, decompress = entry(cfg["compress"]), entry(cfg["decompress"])
    if mesh is None:
        from kanzi_tpu_torch.parallel.mesh import block_mesh
        mesh = block_mesh([f"cuda:{i}" for i in range(cell["chips"])])
    bs = cfg["block_size"]

    per_layer = cell_metrics(bench, a.workload, "per_layer") if a.trace else []
    readers = {}
    if a.trace:
        specs = {}
        for m in per_layer:
            mod, phase = metric_module(root, m["name"])
            readers[m["name"]] = (mod, phase)
            for k, v in getattr(mod, "SPANS", {}).items():
                specs.setdefault(k, v)
        tracer.install(specs)

    w = warmup_input(files)
    t = time.perf_counter()
    try:
        if decompress(compress(w, bs, mesh), mesh) != w:
            log("gpubench: the warm-up round trip differs from its input")
    except Exception as e:           # the window's calls count the failure
        log(f"gpubench: the warm-up round trip failed: {type(e).__name__}: {e}")
    for d in mesh if device_check else ():
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    log(f"warm-up: {len(w)} bytes round-tripped in "
        f"{time.perf_counter() - t:.3f} s")

    import kanzi_tpu_torch.ops as kops
    prof = None
    if a.trace:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        tracer.on = True

    trips, calls = [], []

    def timed(phase, fn, nbytes, blocks, k):
        rec = dict(phase=phase, nbytes=nbytes, blocks=blocks, error=None)
        before = dict(kops.COUNTERS) if a.trace else None
        if tracer:
            tracer.phase, tracer.call = phase, k
        ctx = (torch.profiler.record_function("gpubench/call." + phase)
               if a.trace else None)
        if ctx:
            ctx.__enter__()
        rec["t0"] = time.perf_counter()
        try:
            out = fn()
        except Exception as e:               # a failed call is counted
            out = None
            rec["error"] = f"{type(e).__name__}: {e}"
            log(f"call {k} {phase} failed: {rec['error']}")
        rec["t1"] = time.perf_counter()
        if ctx:
            ctx.__exit__(None, None, None)
        if a.trace:
            rec["counters"] = {k2: v - before.get(k2, 0)
                               for k2, v in kops.COUNTERS.items()
                               if v != before.get(k2, 0)}
        calls.append(rec)
        return out, rec

    setup_s = time.perf_counter() - T0 - gen_s
    t_start = time.perf_counter()
    t_end = t_start + a.seconds
    k = 0
    while time.perf_counter() < t_end:
        i = k % len(files)
        f = files[i]
        nb = -(-len(f) // bs)
        blob, rc = timed("compress", lambda: compress(f, bs, mesh), len(f),
                         nb, k)
        trip = dict(file=i, blob=blob, out=None, nblocks=nb,
                    error=rc["error"])
        if blob is not None:
            out, rd = timed("decompress", lambda: decompress(blob, mesh),
                            len(f), nb, k)
            trip["out"], trip["error"] = out, rd["error"]
        trips.append(trip)
        k += 1
    t_close = time.perf_counter()
    if a.trace:
        tracer.on = False
        for d in mesh if device_check else ():
            torch.cuda.synchronize(d)
        prof.stop()
    peak = max(torch.cuda.max_memory_allocated(d) for d in mesh) \
        if device_check else 0

    done = {p: [c for c in calls if c["phase"] == p and c["t1"] <= t_end
                and c["error"] is None] for p in ("compress", "decompress")}
    log(f"window: {a.seconds} s, closed after {t_close - t_start:.3f} s; "
        f"{k} round trip(s); completed in the window: "
        f"{len(done['compress'])} compress, {len(done['decompress'])} "
        f"decompress")
    for c in calls:
        log(f"  {c['phase']:10s} {c['nbytes']:10d} B "
            f"{c['t1'] - c['t0']:9.4f} s"
            + ("" if c["t1"] <= t_end else "  (after the window)"))

    result_metrics, extra = {}, {}
    if a.trace:
        kernels = trace.device_intervals(prof.events(), calls)
        # the traced run reads every call it made, the one the window's
        # close found in flight too
        td = trace.TraceData(cfg, calls, tracer.spans, kernels)
        for m in per_layer:
            mod, phase = readers[m["name"]]
            v = mod.read(td, phase)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        window = (t_start, t_close)
        extra["busy_s"] = td.busy(*window)
        extra["window_s"] = window[1] - window[0]
        extra_breakdown = trace.breakdown(td, window)
        tracer.uninstall()            # before the checks: none of it is timed
        del prof
    else:
        window_calls = done["compress"] + done["decompress"]
        for m in cell_metrics(bench, a.workload, "end_to_end"):
            v = setup_s if m["name"] == "setup_s" else \
                metric_module(root, m["name"])[0].read_window(window_calls)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    if device_check:
        torch.cuda.empty_cache()
    comp = {}
    for tr in trips:
        if tr["blob"] is not None:
            comp.setdefault(tr["file"], len(tr["blob"]))
    pub = traffic.get("published_compressed", {})
    if comp and len(files) == 1 and cell["config"] in pub:
        log(f"compressed size {comp[0]} B; the real corpus: "
            f"{pub[cell['config']]} B (kanzi's README), not a gate")
    checks = check.run_checks(cfg, files, trips, a.seed, log)
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    attempted = len(calls)
    failed = sum(c["error"] is not None for c in calls) + sum(
        1 for tr in trips if tr["out"] is not None
        and tr["out"] != files[tr["file"]])
    device = {"platform": "gpu" if device_check else "cpu",
              "kind": torch.cuda.get_device_name(mesh[0]) if device_check
              else "cpu", "count": len(mesh), "memory_peak_bytes": peak}
    res = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": result_metrics, "device": device}
    if a.trace:
        device.update(extra)
        res["breakdown"] = extra_breakdown
    res["checks"] = checks
    found = forbidden_modules(sys.modules)
    if found:
        log(f"gpubench: forbidden modules loaded: {', '.join(found)}")
        return 4
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
