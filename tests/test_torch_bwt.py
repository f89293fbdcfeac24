"""PyTorch port of the device suffix array and BWT (kanzi_tpu_torch.ops.bwt)
against the JAX package's (kanzi_tpu.ops.bwt, on JAX-CPU) and the native
SA-IS BWT, byte for byte: the suffix array is unique, so every tolerance
here is exact equality. These are torch ops without a kernel, so the CPU
run is the port's own code path; chip_smoke.py holds it on the card
against native.bwt_forward at 4 MiB.
"""

import numpy as np
import pytest

import kanzi_tpu_torch
import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.ops import bwt as tb
from kanzi_tpu_torch.utils import native as tnative


def _case(name):
    rng = np.random.default_rng(11)
    return {
        "n256": rng.integers(0, 4, 256, dtype=np.uint8),
        "odd": rng.integers(0, 3, 4097, dtype=np.uint8),
        "zeros": np.zeros(5000, np.uint8),
        "runs": np.repeat(rng.integers(0, 3, 400, dtype=np.uint8),
                          77)[:30001],
        "random": rng.integers(0, 256, 20000, dtype=np.uint8),
        # past 64 KiB: kanzi_tpu's next shape bucket (128 Ki)
        "text": np.frombuffer((b"the bwt of the text " * 4000)[:70001],
                              np.uint8),
    }[name]


@pytest.mark.parametrize("name", ["n256", "odd", "zeros", "runs", "random",
                                  "text"])
def test_bwt_matches_jax_and_native(name):
    """suffix_array, bwt_forward (bytes and the 8 primary indexes) and
    bwt_inverse == kanzi_tpu.ops.bwt's on JAX-CPU, and bwt_forward ==
    native.bwt_forward."""
    from kanzi_tpu.ops import bwt as jb
    block = _case(name)
    assert np.array_equal(tb.suffix_array(block, "cpu"),
                          jb.suffix_array(block))
    out, idx = tb.bwt_forward(block, 8, "cpu")
    want, want_idx = jb.bwt_forward(block, 8)
    assert np.array_equal(out, want)
    assert list(idx) == list(want_idx)
    nat, nat_idx = tnative.bwt_forward(block, 8)
    assert np.array_equal(out, nat) and list(idx) == list(nat_idx)
    back = tb.bwt_inverse(out, int(idx[0]), "cpu")
    assert np.array_equal(back, jb.bwt_inverse(want, int(want_idx[0])))
    assert np.array_equal(back, block)


def test_device_bwt_without_native_sais(monkeypatch):
    """With native SA-IS missing in both packages, an 8 KiB block takes
    each package's device BWT: the same bytes and indexes, and the port
    does not raise (it once did). The port's BWT container then equals
    its own with SA-IS and decodes without it."""
    import kanzi_tpu.ops as kops
    from kanzi_tpu.transform import bwt as jbwt
    from kanzi_tpu.utils import native as jnative

    from kanzi_tpu_torch.transform import bwt as tbwt
    rng = np.random.default_rng(4)
    block = np.repeat(rng.integers(0, 40, 2048, dtype=np.uint8), 4)
    data = block.tobytes() * 2
    gold = kanzi_tpu_torch.compress_bytes(data, "BWT", "NONE",
                                          block_size=8192, device="cpu")
    monkeypatch.setattr(jnative, "sais_available", lambda: False)
    monkeypatch.setattr(tnative, "sais_available", lambda: False)
    kops.enable()
    tops.enable()
    tops.reset_counters()
    kops.reset_counters()
    out, idx = tbwt.bwt_forward(block, "cpu")
    want, want_idx = jbwt.bwt_forward(block)
    assert np.array_equal(out, want) and list(idx) == list(want_idx)
    assert tops.COUNTERS == {"bwt_forward_device": 1}
    assert kops.COUNTERS == {"bwt_forward_device": 1}
    blob = kanzi_tpu_torch.compress_bytes(data, "BWT", "NONE",
                                          block_size=8192, device="cpu")
    assert tops.COUNTERS == {"bwt_forward_device": 3}
    assert blob == gold
    assert kanzi_tpu_torch.decompress_bytes(blob, device="cpu") == data
