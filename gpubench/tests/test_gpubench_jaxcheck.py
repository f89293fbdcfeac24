"""The end-of-run check for JAX and the JAX package, by whole top-level
module names."""

from gpubench import run


def test_forbidden_by_whole_top_level_name():
    names = ["kanzi_tpu_torch", "kanzi_tpu_torch.ops", "numpy", "jaxtyping",
             "kanzi_tpu_tools", "flaxen"]
    assert run.forbidden_modules(names) == []
    assert run.forbidden_modules(names + ["jax", "jax.numpy", "jaxlib.xla",
                                          "flax.linen", "kanzi_tpu",
                                          "kanzi_tpu.ops"]) == \
        ["flax.linen", "jax", "jax.numpy", "jaxlib.xla", "kanzi_tpu",
         "kanzi_tpu.ops"]


def test_harness_sources_import_no_jax():
    import ast
    import os
    bad = set(run.FORBIDDEN)
    for dirpath, _, files in os.walk(run.HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                else:
                    continue
                assert not {m.split(".")[0] for m in mods} & bad, (f, mods)


def test_run_prints_no_result_with_jax_loaded(tmp_path, monkeypatch):
    import sys
    import types

    from gpubench.tests import tiny
    root = tiny.make_root(str(tmp_path))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, res = tiny.run(root, "l7.chunks")
    assert rc == 4 and res is None
