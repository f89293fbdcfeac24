"""The LZ match pass of the PyTorch port (kanzi_tpu_torch.ops.lz, kernel
K) against kanzi_tpu's (JAX on the CPU), its numpy model and its
consumer, kanzi_tpu's hinted LZX stitch (KANZI_TPU_LZ=1), which the
port's native parse equals: prev and lcp are exact, so every tolerance
here is exact equality.

On the CPU the wrappers take their plain versions; the needs_cuda test
holds K1 and K2 against them on the card:

    KANZI_TEST_TPU=1 python -m pytest -m needs_cuda tests/test_torch_lz.py
"""

import numpy as np
import pytest
import torch

import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.core.context import Context
from kanzi_tpu_torch.ops import lz as tlz
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


def test_kernel_wrappers_take_plain_versions_on_cpu():
    """K1 and K2's wrappers on CPU tensors: their plain versions,
    counted as such, composing to match_pass_plain; bad shapes raise."""
    data = _edges()["golden"]
    n = len(data)
    pad = tlz.pad_block(data, "cpu")
    tops.reset_counters()
    keys = tlz.lz_hash(pad, n, 16)
    prev, lcp = tlz.lz_prev_lcp(pad, torch.sort(keys).values, n)
    assert tops.COUNTERS == {"lz_hash_plain": 1, "lz_prev_lcp_plain": 1}
    want = tlz.match_pass_plain(torch.from_numpy(data), 16)
    assert torch.equal(prev, want[0]) and torch.equal(lcp, want[1])
    with pytest.raises(ValueError):
        tlz.lz_hash(pad[:-1], n, 16)
    with pytest.raises(ValueError):
        tlz.lz_hash(pad, n, 32)
    with pytest.raises(ValueError, match="outside"):
        tlz.lz_prev_lcp(pad, torch.sort(keys).values + n, n)
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
    """The port's LZCodec (the native parse, with KANZI_TPU_LZ set or
    not) == kanzi_tpu's LZCodec under KANZI_TPU_LZ=1 (its match pass on
    JAX-CPU, then the hinted stitch), inverts, and runs no match pass:
    the pass is not wired into the port's parse."""
    for name, data in _corpora().items():
        tops.reset_counters()
        native = _parse(data, extra, monkeypatch, False)
        flagged = _parse(data, extra, monkeypatch, True)
        assert tops.COUNTERS == {}, name
        theirs, passes = _jax_hinted_parse(data, extra, monkeypatch)
        assert passes == 1, name
        if native is None:
            assert flagged is None and theirs is None, name
            continue
        assert flagged.tobytes() == native.tobytes(), name
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
    with pytest.raises(RuntimeError, match="lz_hash: CUDA launch failed"):
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
    """K1 (keys) and K2 (prev, lcp) against their plain versions on the
    card, on the edge inputs and a 1 MiB mix; lz_match_pass against
    match_pass_np on the edges."""
    rng = np.random.default_rng(hash_log)
    cases = dict(_edges())
    cases["mix"] = np.concatenate(
        [np.frombuffer(b"kernel K: hash, sort, prev, lcp. " * 12000,
                       np.uint8),
         rng.integers(0, 256, 1 << 19, dtype=np.uint8),
         np.zeros(1 << 16, np.uint8)])
    for name, data in cases.items():
        n = len(data)
        pad = tlz.pad_block(data, cuda_device)
        keys = tlz.lz_hash(pad, n, hash_log)
        assert torch.equal(keys, tlz.lz_hash_plain(pad, n, hash_log)), name
        skeys = torch.sort(keys).values
        prev, lcp = tlz.lz_prev_lcp(pad, skeys, n)
        pprev, plcp = tlz.lz_prev_lcp_plain(pad, skeys, n)
        assert torch.equal(prev, pprev) and torch.equal(lcp, plcp), name
        if n <= 4096:
            gprev, glcp = tlz.match_pass_np(data, hash_log)
            got = tlz.lz_match_pass(data, hash_log, cuda_device)
            assert np.array_equal(got[0], gprev), name
            assert np.array_equal(got[1], glcp), name
