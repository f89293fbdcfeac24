"""PyTorch port of the SBRT kernel (kanzi_tpu_torch.ops.sbrt) against the
JAX package, byte for byte: the transform is integer-only, so every
tolerance here is exact equality.

The JAX package's SBRT kernel runs only on a TPU; its host transform
(kanzi_tpu.transform.sbrt.SBRT) and the level-5 pipeline's RANK scans
(_rank_forward_jnp / _rank_inverse_jnp, on JAX-CPU) are the references
here. On the CPU the port's wrapper runs the card's decomposition on the
plain versions: the forward cut into segments, each from the entry state
that segment_states_plain gives it. The kernels themselves are held
against the plain versions by the needs_cuda tests at the end, which
skip without a card:

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


@pytest.mark.parametrize("segment", [ts.SEGMENT, 2000])
@pytest.mark.parametrize("mode", [1, 2, 3])
def test_plain_matches_host_transform(mode, segment):
    """sbrt on the CPU (the plain versions; segments of 2000 bytes cut
    the blocks inside, at and past their lengths), then sbrt_batch's
    inverse == both packages' host SBRT forward on each block, inverts
    it, and passes the bytes past each length through, both ways."""
    from kanzi_tpu.transform.sbrt import SBRT
    from kanzi_tpu_torch.transform.sbrt import SBRT as TorchSBRT
    cases = _cases(np.random.default_rng(99 + mode))
    blocks, lens = _batch(cases, mode)
    tops.reset_counters()
    fwd = ts.sbrt(torch.from_numpy(blocks), torch.from_numpy(lens), mode,
                  False, segment=segment).numpy()
    inv = ts.sbrt_batch(fwd, lens, mode, True, "cpu")
    assert tops.COUNTERS == {"sbrt_plain": 2, "segment_states_plain": 1}
    for i, c in enumerate(cases):
        want = SBRT(mode=mode).forward(c).tobytes()
        assert fwd[i, :len(c)].tobytes() == want, i
        assert TorchSBRT(mode=mode).forward(c).tobytes() == want, i
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


def _host_walk(block, mode, cuts=()):
    """(forward output, ranks visited by the walks, {cut: state before
    byte cut}) of the host loop (kanzi_tpu_torch/transform/sbrt.py
    forward), counted step by step; a state is each symbol's (p, q,
    seen, rank)."""
    m1, m2, shift = ts._MODES[mode]
    p, q, seen = [0] * 256, [0] * 256, [False] * 256
    s2r, r2s = list(range(256)), list(range(256))
    out, visits, states = [], 0, {}
    for i, c in enumerate(block.tolist() + [None]):
        if i in cuts:
            states[i] = (list(p), list(q), list(seen), list(s2r))
        if c is None:
            break
        r = s2r[c]
        out.append(r)
        qc = ((i & m1) + (p[c] & m2)) >> shift
        p[c], q[c], seen[c] = i, qc, True
        while r > 0:
            visits += 1
            if q[r2s[r - 1]] > qc:
                break
            r2s[r] = r2s[r - 1]
            s2r[r2s[r]] = r
            r -= 1
        r2s[r], s2r[c] = c, r
    return np.array(out, np.uint8), visits, states


def _more_cases(rng):
    """_cases, a block whose symbol at position 0 recurs later (seen
    with p = 0 ranks above the unseen symbols) and one of zeros."""
    head = np.array([200], np.uint8)
    return _cases(rng) + [
        np.concatenate([head, rng.integers(0, 8, 2500, dtype=np.uint8),
                        head, rng.integers(190, 210, 1500, dtype=np.uint8)]),
        np.zeros(1500, np.uint8)]


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_segment_states_match_host_walk(mode):
    """segment_states_plain (the plain version of kernels sbrt_occ and
    sbrt_entry) == the host loop's state before each segment of 656
    bytes, with ragged lengths: p, q, seen, and the ranks entry_ranks
    builds from them."""
    segment = 656
    cases = _more_cases(np.random.default_rng(70 + mode))
    blocks, lens = _batch(cases, mode)
    p, q, seen = ts.segment_states_plain(torch.from_numpy(blocks),
                                         torch.from_numpy(lens), mode,
                                         segment)
    ranks = ts.entry_ranks(p, q, seen)
    nseg = p.shape[1]
    assert nseg == -(-blocks.shape[1] // segment)
    for i, c in enumerate(cases):
        # past a block's length its state stands still
        cuts = [min(k * segment, len(c)) for k in range(nseg)]
        _, _, states = _host_walk(c, mode, set(cuts))
        for k, cut in enumerate(cuts):
            want = [torch.tensor(v) for v in states[cut]]
            assert torch.equal(p[i, k], want[0]), (i, k)
            assert torch.equal(q[i, k], want[1]), (i, k)
            assert torch.equal(seen[i, k], want[2]), (i, k)
            assert torch.equal(ranks[i, k], want[3]), (i, k)


def _state_at(c, mode, cut):
    """The entry state (p, q, seen) before byte `cut` of block c: the
    second segment's of segment_states_plain at segment length `cut`,
    the standard state at 0."""
    if cut == 0:
        zero = torch.zeros(256, dtype=torch.int64)
        return zero, zero, zero.bool()
    x = torch.zeros((1, len(c) + 1), dtype=torch.uint8)
    x[0, :len(c)] = torch.from_numpy(c.copy())
    st = ts.segment_states_plain(x, torch.tensor([len(c)]), mode, cut)
    return tuple(t[0, 1] for t in st)


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_cut_forward_matches_host_transforms(mode):
    """A block cut at 0, 1, its length and random points: the forward
    from the entry state at the cut (segment_states_plain with the cut
    as segment length; the standard state at 0) over the rest of the
    block == both packages' host SBRT forward there."""
    from kanzi_tpu.transform.sbrt import SBRT
    from kanzi_tpu_torch.transform.sbrt import SBRT as TorchSBRT
    rng = np.random.default_rng(80 + mode)
    rows, lens, starts, states, wants = [], [], [], [], []
    for c in _more_cases(rng):
        want = SBRT(mode=mode).forward(c)
        assert TorchSBRT(mode=mode).forward(c).tobytes() == want.tobytes()
        for cut in [0, 1, len(c), *rng.integers(2, len(c), 3).tolist()]:
            states.append(_state_at(c, mode, cut))
            rows.append(c[cut:])
            lens.append(len(c) - cut)
            starts.append(cut)
            wants.append(want[cut:])
    L = max(lens)
    blocks = np.zeros((len(rows), L), np.uint8)
    for i, r in enumerate(rows):
        blocks[i, :len(r)] = r
    out = ts.sbrt_plain(torch.from_numpy(blocks), torch.tensor(lens), mode,
                        False, state=[torch.stack(t) for t in zip(*states)],
                        start=torch.tensor(starts))
    for i, w in enumerate(wants):
        assert out[i, :len(w)].numpy().tobytes() == w.tobytes(), (
            i, starts[i])


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
        fwd, want, _ = _host_walk(block, mode)
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


def _card_batch(dev):
    """16 blocks of 16 KiB + 5 (the kernels pad to 16-byte rows): random,
    4 symbols, runs of 7, zeros; ragged lengths (one whole, one empty)."""
    rng = np.random.default_rng(3)
    L = (16 << 10) + 5
    rows = []
    for i in range(16):
        k = i % 4
        rows.append(rng.integers(0, 256, L) if k == 0 else
                    rng.integers(0, 4, L) if k == 1 else
                    np.repeat(rng.integers(0, 256, L // 7 + 1), 7)[:L]
                    if k == 2 else np.zeros(L))
    blocks = torch.from_numpy(np.stack(rows).astype(np.uint8)).to(dev)
    lens = torch.from_numpy(rng.integers(0, L + 1, 16)).to(dev)
    lens[:3] = torch.tensor([L, 0, 2048])
    return blocks, lens


@pytest.mark.needs_cuda
@pytest.mark.parametrize("segment", [ts.SEGMENT, 1024, 48])
def test_kernel_matches_plain_on_cuda(cuda_device, segment):
    """The SBRT kernels against the plain automaton over whole rows on
    the card, every mode, both ways; the forward's segments of 1024 and
    48 bytes fall inside, at and past the blocks' lengths."""
    blocks, lens = _card_batch(cuda_device)
    for mode in (1, 2, 3):
        for inverse in (False, True):
            got = ts.sbrt(blocks, lens, mode, inverse, segment=segment)
            want = ts.sbrt_plain(blocks, lens, mode, inverse)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (mode, inverse)


@pytest.mark.needs_cuda
def test_state_kernels_match_plain_on_cuda(cuda_device):
    """sbrt_occ + sbrt_entry (segment_states on the card) ==
    segment_states_plain, every mode, at segments of 1024 and 48."""
    blocks, lens = _card_batch(cuda_device)
    tops.reset_counters()
    for mode in (1, 2, 3):
        for segment in (1024, 48):
            got = ts.segment_states(blocks, lens, mode, segment)
            want = ts.segment_states_plain(blocks, lens, mode, segment)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (mode, segment)
    assert tops.COUNTERS == {"sbrt_occ": 6, "sbrt_entry": 6}
