"""The check of `correct` against a run of the harness with the timed
path broken underneath (gpubench/faults.py), on the CPU at a size a test
run holds: each fault a cell can have comes out not correct, and a sound
run correct."""

import pytest

from gpubench import faults
from gpubench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", ["l7.enwik8", "l5.silesia"])
def test_sound_run_is_correct(root, cell):
    rc, res = tiny.run(root, cell, seed=2**32 + 5)
    assert rc == 0 and res["correct"] is True
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("cell", ["l7.enwik8", "l5.silesia"])
def test_fault_is_not_correct(root, cell, fault):
    rc, res = tiny.run(root, cell, seed=2**32 + 6, fault=fault)
    assert rc == 0 and res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
