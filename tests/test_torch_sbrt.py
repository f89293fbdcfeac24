"""PyTorch port of the SBRT kernel (kanzi_tpu_torch.ops.sbrt) against the
JAX package, byte for byte: the transform is integer-only, so every
tolerance here is exact equality.

The JAX package's SBRT kernel runs only on a TPU; its host transform
(kanzi_tpu.transform.sbrt.SBRT) and the level-5 pipeline's RANK scans
(_rank_forward_jnp / _rank_inverse_jnp, on JAX-CPU) are the references
here. On the CPU the port's wrapper runs its plain PyTorch version; the
kernel itself is held against that version by the needs_cuda test at the
end, which skips without a card:

    KANZI_TEST_TPU=1 python -m pytest -m needs_cuda tests/test_torch_sbrt.py

The plain version costs ~150 us a byte here (a dozen small ops on
[B, 256] state a step), so the blocks are a few KiB.
"""

import numpy as np
import pytest
import torch

import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.ops import sbrt as ts
from kanzi_tpu_torch.parallel import pipeline as tpp


def _cases(rng):
    """The four blocks of tests/test_ops_sbrt.py."""
    return [
        rng.integers(0, 256, 5000, dtype=np.uint8),
        rng.integers(0, 4, 7000, dtype=np.uint8),
        np.frombuffer((b"sbrt rank state " * 500)[:6000], np.uint8),
        np.zeros(3000, np.uint8),
    ]


def _batch(cases, fill_seed):
    """[B, L] rows with random bytes past each case's length (which must
    pass through), and the lengths."""
    L = max(len(c) for c in cases)
    blocks = np.random.default_rng(fill_seed).integers(
        0, 256, (len(cases), L), dtype=np.uint8)
    for i, c in enumerate(cases):
        blocks[i, :len(c)] = c
    return blocks, np.array([len(c) for c in cases], np.int64)


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_plain_matches_host_transform(mode):
    """sbrt_batch on the CPU (the plain version) == kanzi_tpu's SBRT
    forward on each block, inverts it, and passes the bytes past each
    length through, both ways."""
    from kanzi_tpu.transform.sbrt import SBRT
    cases = _cases(np.random.default_rng(99 + mode))
    blocks, lens = _batch(cases, mode)
    tops.reset_counters()
    fwd = ts.sbrt_batch(blocks, lens, mode, False, "cpu")
    inv = ts.sbrt_batch(fwd, lens, mode, True, "cpu")
    assert tops.COUNTERS == {"sbrt_plain": 2}
    t = SBRT(mode=mode)
    for i, c in enumerate(cases):
        assert fwd[i, :len(c)].tobytes() == t.forward(c).tobytes(), i
        assert np.array_equal(fwd[i, len(c):], blocks[i, len(c):]), i
    assert np.array_equal(inv, blocks)


def test_rank_matches_jax_scans():
    """RANK (mode 2) through the pipeline's _rank_forward / _rank_inverse
    == kanzi_tpu's _rank_forward_jnp / _rank_inverse_jnp lax.scans on
    JAX-CPU, on a block of BWT-like runs over a small alphabet."""
    import jax.numpy as jnp
    from kanzi_tpu.parallel import pipeline as jpp
    rng = np.random.default_rng(5)
    block = np.repeat(rng.integers(0, 12, 600, dtype=np.uint8),
                      rng.integers(1, 9, 600))[:3000]
    x = torch.from_numpy(block.copy())[None]
    fwd = tpp._rank_forward(x)
    want = np.asarray(jpp._rank_forward_jnp(jnp.asarray(block)))
    assert np.array_equal(fwd[0].numpy(), want.astype(np.uint8))
    inv = tpp._rank_inverse(fwd)
    want_inv = np.asarray(jpp._rank_inverse_jnp(jnp.asarray(want)))
    assert np.array_equal(inv[0].numpy(), want_inv.astype(np.uint8))
    assert np.array_equal(inv[0].numpy(), block)


def _host_walk(block, mode):
    """(forward output, ranks visited by the walks) of the host loop
    (kanzi_tpu_torch/transform/sbrt.py forward), counted step by step."""
    m1, m2, shift = ts._MODES[mode]
    p, q = [0] * 256, [0] * 256
    s2r, r2s = list(range(256)), list(range(256))
    out, visits = [], 0
    for i, c in enumerate(block.tolist()):
        r = s2r[c]
        out.append(r)
        qc = ((i & m1) + (p[c] & m2)) >> shift
        p[c], q[c] = i, qc
        while r > 0:
            visits += 1
            if q[r2s[r - 1]] > qc:
                break
            r2s[r] = r2s[r - 1]
            s2r[r2s[r]] = r
            r -= 1
        r2s[r], s2r[c] = c, r
    return np.array(out, np.uint8), visits


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_bound_counts_the_host_walk(mode):
    """chip_smoke.py's operations bound of the SBRT kernel counts the
    ranks the host automaton's walks visit without walking
    (sbrt_visits); the count equals the host loop's on each case."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for i, block in enumerate(_cases(np.random.default_rng(40 + mode))):
        fwd, want = _host_walk(block, mode)
        got = smoke.sbrt_visits(torch.from_numpy(block.copy())[None],
                                torch.from_numpy(fwd)[None],
                                *ts._MODES[mode])
        assert got == want, i


def test_wrapper_checks_its_inputs():
    blocks = torch.zeros((2, 64), dtype=torch.uint8)
    lens = torch.full((2,), 64, dtype=torch.int64)
    with pytest.raises(ValueError, match="mode"):
        ts.sbrt(blocks, lens, 4, False)
    with pytest.raises(ValueError, match="lens"):
        ts.sbrt(blocks, lens.int(), 2, False)
    with pytest.raises(ValueError, match="blocks"):
        ts.sbrt(blocks.int(), lens, 2, False)
    with pytest.raises(ValueError, match="no kernel"):
        ts.sbrt(blocks.to("meta"), lens.to("meta"), 2, False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.needs_cuda
def test_kernel_matches_plain_on_cuda(cuda_device):
    """The SBRT kernel against its plain version on the card: 16 blocks
    of 16 KiB + 5 (the kernel pads to 16-byte rows), ragged lengths (one
    empty, one whole), every mode, both ways."""
    rng = np.random.default_rng(3)
    L = (16 << 10) + 5
    rows = []
    for i in range(16):
        k = i % 4
        rows.append(rng.integers(0, 256, L) if k == 0 else
                    rng.integers(0, 4, L) if k == 1 else
                    np.repeat(rng.integers(0, 256, L // 7 + 1), 7)[:L]
                    if k == 2 else np.zeros(L))
    blocks = torch.from_numpy(np.stack(rows).astype(np.uint8)).to(
        cuda_device)
    lens = torch.from_numpy(rng.integers(0, L + 1, 16)).to(cuda_device)
    lens[:2] = torch.tensor([L, 0])
    for mode in (1, 2, 3):
        for inverse in (False, True):
            got = ts.sbrt(blocks, lens, mode, inverse)
            want = ts.sbrt_plain(blocks, lens, mode, inverse)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (mode, inverse)
