"""A configuration, a traffic and a per-layer metric added as new files
plus entries in BENCHMARK.json, with no edit of any file there: the
harness finds them by name."""

import json
import os

from gpubench.tests import tiny


def test_new_cell_from_files_and_entries(tmp_path):
    root = tiny.make_root(str(tmp_path))
    g = os.path.join(root, "gpubench")
    cfg = json.load(open(os.path.join(g, "configs", "kanzi-l5.json")))
    cfg["about"] = "a dummy configuration"
    json.dump(cfg, open(os.path.join(g, "configs", "dummy-l5.json"), "w"))
    json.dump({"members": [{"name": "d", "class": "xml", "size": 40000}],
               "container": "raw"},
              open(os.path.join(g, "traffic", "dummy.json"), "w"))
    with open(os.path.join(g, "metrics", "dummy_calls.py"), "w") as f:
        f.write("SPANS = {'dummy.host': ('kanzi_tpu_torch.parallel.pipeline',"
                " '_encode_block_phase1', None)}\n\n\n"
                "def read(t, phase):\n"
                "    return float(len(t.spans_of(phase, 'dummy.')))\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "dummy-l5", "source": "https://example.org",
                             "file": "gpubench/configs/dummy-l5.json",
                             "reduced": [], "why": "dummy"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy-l5",
                               "traffic": "dummy", "chips": 1, "why": "dummy"})
    bench["per_layer"].append({"name": "dummy_calls.compress", "unit": "1",
                               "better": "lower", "source": "program_span",
                               "layer": "host transforms",
                               "moves": "compress_MBps",
                               "workloads": ["dummy.cell"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    rc, res = tiny.run(root, "dummy.cell", trace=1)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["dummy_calls.compress"]["value"] >= 3
    rc, res = tiny.run(root, "dummy.cell", trace=0)
    assert rc == 0 and set(res["metrics"]) >= {"compress_MBps", "setup_s"}
