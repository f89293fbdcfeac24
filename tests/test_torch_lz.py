"""The LZ match pass of the PyTorch port (kanzi_tpu_torch.ops.lz, kernel
K) against kanzi_tpu's (JAX on the CPU), its numpy model and its
consumers, kanzi_tpu's hinted LZX stitch (KANZI_TPU_LZ=1) and the port's
LZ transform with its card gate opened, which the port's native parse
equals: prev and lcp are exact, so every tolerance here is exact
equality (tests/test_torch_lz_hinted.py holds the hinted parse itself).

On the CPU the wrappers take their plain versions (the digit passes'
count, scan and scatter, then lcp); the needs_cuda test holds each
kernel against its plain version on the card:

    KANZI_TEST_TPU=1 python -m pytest -m needs_cuda tests/test_torch_lz.py
"""

import numpy as np
import pytest
import torch

import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.core.context import Context
from kanzi_tpu_torch.ops import lz as tlz
from kanzi_tpu_torch.transform import lz as lzt
from kanzi_tpu_torch.transform.lz import LZCodec

pytestmark = pytest.mark.timeout(300)


def _golden_input():
    """tests/test_ops_lz.py's golden-model input."""
    rng = np.random.default_rng(7)
    return np.concatenate(
        [rng.integers(0, 6, 3000, dtype=np.uint8),
         np.frombuffer(b"abcabcabd " * 200, np.uint8)])


def _edges():
    rng = np.random.default_rng(5)
    return {
        "golden": _golden_input(),
        "one_byte": np.array([7], np.uint8),
        "below_8": np.frombuffer(b"abcab", np.uint8).copy(),
        "exactly_8": np.frombuffer(b"abababab", np.uint8).copy(),
        # matches that run past the end into the zero padding
        "zero_tail": np.concatenate(
            [rng.integers(0, 3, 900, dtype=np.uint8),
             np.zeros(100, np.uint8)]),
        "repeated": np.full(2000, 0x41, np.uint8),        # lcp CAP nearly
                                                          # everywhere
        "random": rng.integers(0, 256, 3000, dtype=np.uint8),
    }


def _corpora():
    """tests/test_ops_lz.py's stitch corpora."""
    rng = np.random.default_rng(23)
    text = np.frombuffer(
        (b"the compression literature repeats itself; the compression "
         b"literature repeats itself differently. " * 300)[:20000],
        np.uint8).copy()
    rand = rng.integers(0, 256, 20000, dtype=np.uint8)
    mixed = np.concatenate(
        [text[:8000], rand[:6000], np.zeros(3000, np.uint8),
         np.repeat(rng.integers(0, 8, 800, dtype=np.uint8), 4)])
    runs = np.repeat(rng.integers(0, 256, 700, dtype=np.uint8),
                     rng.integers(1, 60, 700))[:20000].copy()
    return {"text": text, "rand": rand, "mixed": mixed, "runs": runs}


@pytest.mark.parametrize("hash_log", [16, 19])
@pytest.mark.parametrize("name", sorted(_edges()))
def test_match_pass_matches_jax_and_numpy(name, hash_log):
    """match_pass_plain == kanzi_tpu's lz_match_pass (JAX) ==
    match_pass_np, prev and lcp; lz_match_pass on the CPU is the plain
    version (counted as lz_match_pass_plain)."""
    from kanzi_tpu.ops import lz as jlz
    data = _edges()[name]
    prev, lcp = tlz.match_pass_plain(torch.from_numpy(data.copy()), hash_log)
    jprev, jlcp = jlz.lz_match_pass(data, hash_log)
    gprev, glcp = tlz.match_pass_np(data, hash_log)
    assert np.array_equal(prev.numpy(), jprev)
    assert np.array_equal(lcp.numpy(), jlcp)
    assert np.array_equal(prev.numpy(), gprev)
    assert np.array_equal(lcp.numpy(), glcp)
    tops.reset_counters()
    cprev, clcp = tlz.lz_match_pass(data, hash_log, "cpu")
    assert tops.COUNTERS == {"lz_match_pass_plain": 1}
    assert cprev.dtype == np.int32 and clcp.dtype == np.int32
    assert np.array_equal(cprev, gprev) and np.array_equal(clcp, glcp)
    if name == "repeated":            # every full window matches its
        n = len(data)                   # predecessor for CAP bytes
        assert (prev[1:n - 7] == torch.arange(n - 8)).all()
        assert (lcp[1:n - tlz.CAP + 1] == tlz.CAP).all()


def _digit_cases():
    """_edges(), a block in which every position shares one bucket (all
    zeros: one bin of each pass holds every item) across three tiles, and
    blocks that are not a whole number of tiles."""
    rng = np.random.default_rng(11)
    cases = dict(_edges())
    cases["one_bucket"] = np.zeros(2 * tlz.TILE + 5, np.uint8)
    cases["tiles_text"] = np.frombuffer(
        (b"stable digit passes, tile by tile; " * 600)[:2 * tlz.TILE + 1000],
        np.uint8).copy()
    cases["tiles_random"] = rng.integers(0, 256, tlz.TILE + 333,
                                         dtype=np.uint8)
    return cases


@pytest.mark.parametrize("hash_log", [1, 8, 16, 19, 31])
def test_digit_passes_match_jax_and_numpy(hash_log):
    """The plain versions of the kernels composed as the card runs them
    (match_pass_kernels on CPU tensors: each pass of digit_plan counted,
    scanned and scattered, then lcp) == kanzi_tpu's lz_match_pass (JAX)
    == match_pass_np == match_pass_plain, prev and lcp; at hash_log 19
    and 31 the top digit is shorter than the others."""
    from kanzi_tpu.ops import lz as jlz
    passes = len(tlz.digit_plan(hash_log))
    for name, data in _digit_cases().items():
        n = len(data)
        tops.reset_counters()
        prev, lcp = tlz.match_pass_kernels(tlz.pad_block(data, "cpu"), n,
                                           hash_log)
        assert tops.COUNTERS == {
            "lz_count_plain": passes, "lz_scan_plain": passes,
            "lz_scatter_plain": passes, "lz_lcp_plain": 1}, name
        jprev, jlcp = jlz.lz_match_pass(data, hash_log)
        gprev, glcp = tlz.match_pass_np(data, hash_log)
        wprev, wlcp = tlz.match_pass_plain(torch.from_numpy(data.copy()),
                                           hash_log)
        for want in ((jprev, jlcp), (gprev, glcp),
                     (wprev.numpy(), wlcp.numpy())):
            assert np.array_equal(prev.numpy(), want[0]), name
            assert np.array_equal(lcp.numpy(), want[1]), name
        if name == "one_bucket":
            assert (prev[1:] == torch.arange(n - 1)).all()


def test_digit_plan_and_plain_steps():
    """digit_plan's passes cover hash_log with digits of at most
    MAX_DIGIT_BITS; each plain step on a block of three tiles: counts sum
    to each tile's length, offsets are the exclusive sums of the counts,
    a pass is torch.sort(digit, stable=True) of the keys, the last pass's
    pred is the key before each tile's run in the sorted order."""
    assert tlz.digit_plan(1) == [(0, 1)]
    assert tlz.digit_plan(8) == [(0, 8)]
    assert tlz.digit_plan(16) == [(0, 8), (8, 8)]
    assert tlz.digit_plan(19) == [(0, 10), (10, 10)]
    assert tlz.digit_plan(31) == [(0, 8), (8, 8), (16, 8), (24, 8)]
    for hl in range(1, 32):
        plan = tlz.digit_plan(hl)
        assert plan[-1][0] < hl <= plan[-1][0] + plan[-1][1]
        assert all(b <= tlz.MAX_DIGIT_BITS for _, b in plan)
    data = _digit_cases()["tiles_text"]
    n = len(data)
    pad = tlz.pad_block(data, "cpu")
    full = torch.sort(tlz.block_keys_plain(pad, n, 16)).values
    keys = None
    for p, (shift, bits) in enumerate(tlz.digit_plan(16)):
        counts, last = tlz.lz_count_plain(pad, keys, n, 16, p)
        assert counts.shape == (1 << bits, 3)
        assert counts.sum(0).tolist() == [tlz.TILE, tlz.TILE, 1000]
        offs, totals, pred = tlz.lz_scan_plain(counts, last)
        assert torch.equal(offs[:, 1:], offs[:, :-1] + counts[:, :-1])
        assert torch.equal(totals, counts.sum(1).int())
        src = keys if keys is not None else tlz.block_keys_plain(pad, n, 16)
        out = tlz.lz_scatter_plain(pad, keys, n, 16, p)
        if p == 0:
            assert last is None and pred is None
            digit = (src >> 32 >> shift) & ((1 << bits) - 1)
            assert torch.equal(
                out, src[torch.sort(digit, stable=True).indices])
            keys = out
            continue
        # the last pass: the fully sorted order; pred of (value, tile) is
        # the sorted key just before the tile's first item of that value
        digit = (keys >> 32 >> shift) & ((1 << bits) - 1)
        tile = torch.arange(n) // tlz.TILE
        order = torch.sort(digit, stable=True).indices
        assert torch.equal(keys[order], full)
        at = torch.arange(n)
        for v, t in {(int(digit[i]), int(tile[i])) for i in range(n)}:
            first = int(at[(digit[order] == v) & (tile[order] == t)][0])
            want = int(full[first - 1]) if first > 0 and int(
                (full[first - 1] >> 32 >> shift) & 255) == v else -1
            assert int(pred[v, t]) == want
        prev = out
    assert torch.equal(prev, tlz.match_pass_plain(
        torch.from_numpy(data), 16)[0])


@pytest.mark.parametrize("n", [1, 5, 8, 1000, (4 << 20) + 3])
def test_pad_block(n):
    """pad_block: the block, then zeros to padded_length(n), byte for byte
    the zero-filled copy the pass padded before."""
    data = np.random.default_rng(n).integers(1, 256, n, dtype=np.uint8)
    want = np.zeros(tlz.padded_length(n), np.uint8)
    want[:n] = data
    pad = tlz.pad_block(data, "cpu")
    assert pad.dtype == torch.uint8 and pad.is_contiguous()
    assert np.array_equal(pad.numpy(), want)
    assert tlz.padded_length(n) % 8 == 0
    assert tlz.padded_length(n) >= n + tlz.PAD + 8


def test_kernel_wrappers_take_plain_versions_on_cpu(monkeypatch):
    """The kernels' wrappers on CPU tensors: their plain versions, each
    counted as such, composing to match_pass_plain with no reduction
    that waits for the host on the pass's path; bad arguments raise, and
    the positions that a caller hands lz_scatter and lz_lcp are checked
    unless the pass hands them."""
    data = _golden_input()
    n = len(data)
    pad = tlz.pad_block(data, "cpu")
    tops.reset_counters()
    counts, last = tlz.lz_count(pad, None, n, 16, 0)
    offs, totals, pred = tlz.lz_scan(counts, last)
    keys = tlz.lz_scatter(pad, None, n, 16, 0, offs, totals, pred)
    counts, last = tlz.lz_count(pad, keys, n, 16, 1)
    offs, totals, pred = tlz.lz_scan(counts, last)
    prev = tlz.lz_scatter(pad, keys, n, 16, 1, offs, totals, pred)
    lcp = tlz.lz_lcp(pad, prev, n)
    assert tops.COUNTERS == {"lz_count_plain": 2, "lz_scan_plain": 2,
                             "lz_scatter_plain": 2, "lz_lcp_plain": 1}
    want = tlz.match_pass_plain(torch.from_numpy(data), 16)
    assert torch.equal(prev, want[0]) and torch.equal(lcp, want[1])

    def no_sync(*a, **k):
        raise AssertionError("a host sync on the pass's path")

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "any", no_sync)
        got = tlz.match_pass_kernels(pad, n, 16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    with pytest.raises(ValueError, match="hash_log"):
        tlz.lz_count(pad, None, n, 32, 0)
    with pytest.raises(ValueError, match="passes"):
        tlz.lz_count(pad, None, n, 16, 2)
    with pytest.raises(ValueError, match="pass 0"):
        tlz.lz_count(pad, None, n, 16, 1)
    with pytest.raises(ValueError):
        tlz.lz_count(pad[:-1], None, n, 16, 0)
    with pytest.raises(ValueError):
        tlz.lz_count(pad, keys.int(), n, 16, 1)
    with pytest.raises(ValueError, match="bits"):
        tlz.lz_scan(counts[:-1], None)
    with pytest.raises(ValueError, match="only the last"):
        tlz.lz_scatter(pad, None, n, 16, 0, offs, totals, pred)
    with pytest.raises(ValueError, match="last pass"):
        tlz.lz_scatter(pad, keys, n, 16, 1, offs, totals, None)
    with pytest.raises(ValueError, match="outside"):
        tlz.lz_scatter(pad, keys + n, n, 16, 1, offs, totals, pred)
    with pytest.raises(ValueError, match="outside"):
        tlz.lz_lcp(pad, prev + n, n)
    with pytest.raises(ValueError, match="outside"):
        tlz.lz_lcp(pad, prev - n - 1, n)
    with pytest.raises(ValueError, match="hash_log"):
        tlz.lz_match_pass(data, 0, "cpu")
    assert tlz.lz_match_pass(np.zeros(0, np.uint8), 16, "cpu")[0].size == 0


def _parse(data, extra, monkeypatch, flag):
    if flag:
        monkeypatch.setenv("KANZI_TPU_LZ", "1")
    else:
        monkeypatch.delenv("KANZI_TPU_LZ", raising=False)
    return LZCodec(Context({"device": "cpu"}), extra=extra).forward(data)


def _jax_hinted_parse(data, extra, monkeypatch):
    """kanzi_tpu's LZCodec with KANZI_TPU_LZ=1: its match pass, then its
    hinted stitch. Returns (output, passes run)."""
    import kanzi_tpu.ops as kops
    from kanzi_tpu.core.context import Context as RefContext
    from kanzi_tpu.transform.lz import LZCodec as RefLZ
    monkeypatch.setenv("KANZI_TPU_LZ", "1")
    kops.reset_counters()
    out = RefLZ(RefContext(), extra=extra).forward(data)
    return out, kops.COUNTERS.get("lz_match_pass_device", 0)


@pytest.mark.parametrize("extra", [False, True])
def test_parse_matches_jax_hinted_parse(extra, monkeypatch):
    """The port's LZCodec with the card's gate opened (its match pass, the
    plain version on the CPU, then the native parse that reads its hints)
    == the port's LZCodec with the gate closed (the native parse, with
    KANZI_TPU_LZ set or not: the port has no such flag) == kanzi_tpu's
    LZCodec under KANZI_TPU_LZ=1 (its match pass on JAX-CPU, then its
    hinted stitch), and inverts; one pass and one hinted parse a block
    with the gate open, none with it closed."""
    for name, data in _corpora().items():
        tops.reset_counters()
        native = _parse(data, extra, monkeypatch, False)
        flagged = _parse(data, extra, monkeypatch, True)
        assert tops.COUNTERS == {}, name
        with monkeypatch.context() as m:
            m.setattr(lzt, "_lz_on_device", lambda *a: True)
            hinted = _parse(data, extra, monkeypatch, False)
        assert tops.COUNTERS == {"lz_match_pass_plain": 1,
                                 "lz_hinted_blocks": 1}, name
        theirs, passes = _jax_hinted_parse(data, extra, monkeypatch)
        assert passes == 1, name
        if native is None:
            assert flagged is None and hinted is None and theirs is None, name
            continue
        assert flagged.tobytes() == native.tobytes(), name
        assert hinted.tobytes() == native.tobytes(), name
        assert theirs.tobytes() == native.tobytes(), name
        back = LZCodec(Context({"size": len(data)}), extra=extra)
        assert back.inverse(native).tobytes() == data.tobytes(), name


def test_pass_drives_jax_hinted_parse(monkeypatch):
    """The port's lz_match_pass (its plain version on the CPU) in place of
    kanzi_tpu's pass: kanzi_tpu's hinted stitch reads its prev and lcp
    and gives the port's native parse, at hash_log 16 (LZ) and 19
    (LZX)."""
    from kanzi_tpu.ops import lz as jlz
    calls = []

    def ours(src, hash_log):
        calls.append(hash_log)
        return tlz.lz_match_pass(src, hash_log, "cpu")

    monkeypatch.setattr(jlz, "lz_match_pass", ours)
    for extra in (False, True):
        for name in ("text", "mixed"):
            data = _corpora()[name]
            theirs, _ = _jax_hinted_parse(data, extra, monkeypatch)
            native = _parse(data, extra, monkeypatch, False)
            assert theirs.tobytes() == native.tobytes(), (name, extra)
    assert calls == [16, 16, 19, 19]


def test_failing_pass_raises(monkeypatch):
    """A failed launch of K raises through lz_match_pass: there is no
    fallback to the plain version."""
    def broken(kernel, *a):
        raise RuntimeError(f"{kernel}: CUDA launch failed")

    monkeypatch.setattr(tlz, "_on_cpu", lambda kernel, dev: False)
    monkeypatch.setattr(tlz, "_launch", broken)
    tops.reset_counters()
    with pytest.raises(RuntimeError, match="lz_count: CUDA launch failed"):
        tlz.lz_match_pass(_corpora()["text"], 16, "cpu")
    assert tops.COUNTERS == {}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("hash_log", [16, 19])
def test_kernels_match_plain_on_cuda(cuda_device, hash_log):
    """Each kernel (lz_count, lz_scan, lz_scatter each pass, then lz_lcp)
    against its plain version on the card, fed the same inputs, on the
    edge inputs, a 4 MiB block in one bucket and a 4 MiB mix; the pass
    against match_pass_plain, and lz_match_pass against match_pass_np
    on the edges."""
    rng = np.random.default_rng(hash_log)
    cases = dict(_digit_cases())
    cases["one_bucket_4m"] = np.zeros(4 << 20, np.uint8)
    cases["mix_4m"] = np.concatenate(
        [np.frombuffer(b"kernel K: count, scan, scatter, lcp. " * 60000,
                       np.uint8),
         rng.integers(0, 256, (4 << 20) - 38 * 60000, dtype=np.uint8),
         np.zeros(1 << 16, np.uint8)])
    for name, data in cases.items():
        n = len(data)
        pad = tlz.pad_block(data, cuda_device)
        keys = None
        for p in range(len(tlz.digit_plan(hash_log))):
            got = tlz.lz_count(pad, keys, n, hash_log, p)
            want = tlz.lz_count_plain(pad, keys, n, hash_log, p)
            assert torch.equal(got[0], want[0]), (name, p)
            assert (got[1] is None) == (want[1] is None), (name, p)
            assert got[1] is None or torch.equal(got[1], want[1]), (name, p)
            scan = tlz.lz_scan(*want)
            for g, w in zip(scan, tlz.lz_scan_plain(*want)):
                assert (g is None and w is None) or torch.equal(g, w), (
                    name, p)
            out = tlz.lz_scatter(pad, keys, n, hash_log, p, *scan)
            want_out = tlz.lz_scatter_plain(pad, keys, n, hash_log, p)
            assert torch.equal(out, want_out), (name, p)
            keys = want_out
        lcp = tlz.lz_lcp(pad, keys, n)
        assert torch.equal(lcp, tlz.lz_lcp_plain(pad, keys, n)), name
        wprev, wlcp = tlz.match_pass_plain(
            torch.from_numpy(data.copy()).to(cuda_device), hash_log)
        prev, lcp = tlz.match_pass_kernels(pad, n, hash_log)
        assert torch.equal(prev, wprev) and torch.equal(lcp, wlcp), name
        if n <= 4096:
            gprev, glcp = tlz.match_pass_np(data, hash_log)
            got = tlz.lz_match_pass(data, hash_log, cuda_device)
            assert np.array_equal(got[0], gprev), name
            assert np.array_equal(got[1], glcp), name
