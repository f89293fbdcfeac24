"""The benchmark of kanzi_tpu_torch (see run.py and BENCHMARK.json)."""
