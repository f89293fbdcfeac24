"""The LZ transform's hinted parse (kanzi_tpu_torch/csrc/lzx_hint.cpp,
utils.native.lzx_forward_hinted) and the card gate that sends a block to
it (transform/lz.py _lz_on_device): the LZ match pass's prev and lcp
(its plain version on the CPU) feed a native parse whose bytes equal the
native parse's (native/lzx.cpp), and with the check flag the native hash
table runs beside the hints and every read and lcp decision is compared
with it. Outputs are bytes: every comparison is exact equality.

The needs_cuda test runs the transform with kernel K on the card:

    KANZI_TEST_TPU=1 python -m pytest -m needs_cuda tests/test_torch_lz_hinted.py
"""

import numpy as np
import pytest
import torch

import kanzi_tpu_torch as ktt
import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.app.cli import LEVEL_TABLE
from kanzi_tpu_torch.core.context import Context
from kanzi_tpu_torch.ops import lz as tlz
from kanzi_tpu_torch.transform import lz as lzt
from kanzi_tpu_torch.transform.lz import LZCodec
from kanzi_tpu_torch.utils import native

from test_torch_lz import _corpora

pytestmark = pytest.mark.timeout(300)


def _mixtures():
    """Seeded numpy mixtures: repeated words, a 12-symbol alphabet, DNA,
    fixed-size records with random fields (binary tables), and regions of
    text, random bytes, zeros and runs in turn."""
    rng = np.random.default_rng(2026)
    vocab = [b"match", b"pass", b"hint", b"the", b"parse", b"of", b"table",
             b"skipped", b"bucket", b"chain"]
    words = np.frombuffer(b" ".join(
        vocab[i] for i in rng.integers(0, len(vocab), 6000))[:30000],
        np.uint8)
    records = np.zeros((1500, 20), np.uint8)
    records[:, :4] = np.frombuffer(b"REC\x01", np.uint8)
    records[:, 4:8] = rng.integers(0, 4, (1500, 4))
    records[:, 8:] = rng.integers(0, 256, (1500, 12))
    text = np.frombuffer(b"a hinted parse reads prev and lcp; " * 400,
                         np.uint8)
    regions = []
    for k in range(4):
        regions += [text[k * 1000:k * 1000 + 3000],
                    rng.integers(0, 256, 2000 + 1000 * k, dtype=np.uint8),
                    rng.choice(np.arange(12, dtype=np.uint8), 2500),
                    np.zeros(700, np.uint8),
                    np.repeat(rng.integers(0, 256, 60, dtype=np.uint8),
                              rng.integers(1, 40, 60))]
    return {
        "words": words,
        "sparse": rng.choice(np.arange(12, dtype=np.uint8), 30000),
        "dna": np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 30000)],
        "records": records.ravel(),
        "regions": np.concatenate(regions),
    }


def _cases():
    return {**_corpora(), **_mixtures()}


def _pass(data, hash_log):
    prev, lcp = tlz.match_pass_plain(torch.from_numpy(data.copy()), hash_log)
    return prev.numpy(), lcp.numpy()


def _hinted(data, hash_log, min_match, lcp_dtype=np.int32, check=False):
    prev, lcp = _pass(data, hash_log)
    stats = {}
    out = native.lzx_forward_hinted(data, hash_log, min_match, prev,
                                    lcp.astype(lcp_dtype), stats=stats,
                                    check=check)
    return out, stats


def _same(got, want) -> bool:
    if got is None or want is None:
        return got is None and want is None
    return got.tobytes() == want.tobytes()


@pytest.mark.parametrize("min_match", [4, 6])
@pytest.mark.parametrize("hash_log", [16, 19])
@pytest.mark.parametrize("name", sorted(_cases()))
def test_hinted_parse_equals_native_parse(name, hash_log, min_match):
    """native.lzx_forward_hinted == native.lzx_forward at LZ (16) and LZX
    (19), min_match 4 and 6 (DNA), with lcp as int32 (the pass's
    contract, which the wrapper narrows) and as uint8 (the transform's
    copy from the card)."""
    data = _cases()[name]
    want = native.lzx_forward(data, hash_log, min_match)
    for dtype in (np.int32, np.uint8):
        got, _ = _hinted(data, hash_log, min_match, dtype)
        assert _same(got, want), (name, dtype)


@pytest.mark.parametrize("hash_log", [16, 19])
def test_native_table_agrees_with_hints(hash_log):
    """The invariant the parse stands on, held by a model: with check set
    the native hash table runs beside the parse, and at every visit and
    every lookahead the candidate derived from prev, the bitmap of
    positions not inserted and the lazily written table equals the native
    table's read, and every compare that lcp decides equals the byte
    compare, on every corpus; the bytes equal the native parse's."""
    for name, data in _cases().items():
        for min_match in (4, 6):
            got, st = _hinted(data, hash_log, min_match, check=True)
            assert _same(got, native.lzx_forward(data, hash_log,
                                                 min_match)), name
            assert st["checked"] > 0, name
            assert st["table_miss"] == 0 and st["lcp_miss"] == 0, (name, st)


def _branches():
    """Hand-made inputs, each with the counters of the parse's branch it
    drives: {name: (data, counters that must be positive)}."""
    rng = np.random.default_rng(17)
    r = rng.integers(0, 256, 4000, dtype=np.uint8)
    r2 = rng.integers(0, 256, 2000, dtype=np.uint8)
    text = np.frombuffer(b"hinted parse: skipped positions, walks and the "
                         b"table. " * 40, np.uint8)
    long_text = np.frombuffer(b"a match longer than the lcp cap of 32 "
                              b"bytes resumes the stride loop. " * 200,
                              np.uint8)
    far = np.concatenate([
        np.frombuffer(b"a block past four times MAX_DISTANCE1, " * 7000,
                      np.uint8),
        rng.integers(0, 256, 30000, dtype=np.uint8)])
    return {
        # more than 64 random literals (the parser skips), then text, then
        # a copy of the skipped stretch: prev points at skipped positions
        "skip_then_text": (np.concatenate([r, text, r[1000:1600],
                                           text[:500]]),
                           ("marked_prev", "walks", "unmarked")),
        # a copy of a stretch, reached while skipping: its match extends
        # back over skipped positions, which it inserts again
        "back_extension": (np.concatenate([text[:300], r, r2, r[1000:2000],
                                           text[:300]]),
                           ("unmarked",)),
        # matches longer than CAP: lcp says CAP, the stride loop resumes
        "past_cap": (long_text, ("cap_resumed", "lcp_decided")),
        # 310000 bytes, over 4 * MAX_DISTANCE1: distances up to 2^24 - 2
        "distance2": (far, ("cap_resumed",)),
        # runs: matches at a repeat distance
        "rep": (_corpora()["runs"], ("rep_matches",)),
        # random bytes: the table answers where prev was skipped
        "table_mode": (rng.integers(0, 256, 120000, dtype=np.uint8),
                       ("table_visits", "flushes", "marked_prev")),
    }


@pytest.mark.parametrize("name", sorted(_branches()))
def test_hand_made_inputs_hit_each_branch(name):
    """Each hand-made input drives its branch of the parse (its counters
    positive, at LZ and LZX), the native table agrees with the hints
    throughout, and the bytes equal the native parse's."""
    data, keys = _branches()[name]
    for hash_log in (16, 19):
        got, st = _hinted(data, hash_log, 4, check=True)
        assert _same(got, native.lzx_forward(data, hash_log, 4)), hash_log
        assert st["table_miss"] == 0 and st["lcp_miss"] == 0, st
        for k in keys:
            assert st[k] > 0, (hash_log, k, st)
        if name == "distance2":
            assert len(data) > 4 * lzt.MAX_DISTANCE1
            assert got[12] & 1, "flags: the MAX_DISTANCE2 path"


def test_gate_closed_on_cpu_and_when_disabled(monkeypatch):
    """_lz_on_device: open only for a CUDA device, ops enabled, a hash_log
    whose LZ_HINT_MIN_BLOCK is set and a block of at least that many
    bytes; LZCodec on device 'cpu', or with ops disabled on any device,
    runs the native parse and no pass."""
    cuda = torch.device("cuda", 0)
    for hl, n in lzt.LZ_HINT_MIN_BLOCK.items():
        if n is None:
            assert not lzt._lz_on_device(cuda, 1 << 30, hl)
            continue
        assert lzt._lz_on_device(cuda, n, hl)
        assert not lzt._lz_on_device(cuda, n - 1, hl)
        assert not lzt._lz_on_device(torch.device("cpu"), n, hl)
        assert not lzt._lz_on_device(None, n, hl)
    assert not lzt._lz_on_device(cuda, 1 << 30, 12)
    assert lzt.block_device(Context({"device": "cpu"})) == torch.device("cpu")
    assert lzt.block_device(Context({"device": "cuda:0"})) == cuda
    if not torch.cuda.is_available():
        assert lzt.block_device(Context()) is None
    data = _corpora()["mixed"]
    monkeypatch.setattr(lzt, "LZ_HINT_MIN_BLOCK", {16: 1, 19: 1})
    for extra, hl in ((False, 16), (True, 19)):
        want = native.lzx_forward(data, hl, 4)
        tops.reset_counters()
        got = LZCodec(Context({"device": "cpu"}), extra=extra).forward(data)
        assert tops.COUNTERS == {} and _same(got, want)
        tops.disable()
        try:
            assert not lzt._lz_on_device(cuda, 1 << 30, hl)
            got = LZCodec(Context({"device": "cuda:0"}),
                          extra=extra).forward(data)
        finally:
            tops.enable()
        assert tops.COUNTERS == {} and _same(got, want)


def test_failing_pass_raises_through_transform(monkeypatch):
    """A failed launch of K raises through LZCodec.forward: no fallback
    to the native parse, no hinted block counted."""
    def broken(kernel, *a):
        raise RuntimeError(f"{kernel}: CUDA launch failed")

    monkeypatch.setattr(lzt, "_lz_on_device", lambda *a: True)
    monkeypatch.setattr(tlz, "_on_cpu", lambda kernel, dev: False)
    monkeypatch.setattr(tlz, "_launch", broken)
    tops.reset_counters()
    with pytest.raises(RuntimeError, match="lz_count: CUDA launch failed"):
        LZCodec(Context({"device": "cpu"}), extra=True).forward(
            _corpora()["text"])
    assert tops.COUNTERS == {}


def _container_input() -> bytes:
    rng = np.random.default_rng(9)
    vocab = [b"the", b"hinted", b"parse", b"of", b"block", b"kernel",
             b"match"]
    eng = b" ".join(vocab[i] for i in rng.integers(0, len(vocab), 30000))
    return (eng[:100000] + rng.integers(0, 256, 30000, dtype=np.uint8)
            .tobytes() + bytes(20000) + _corpora()["runs"].tobytes()
            + _mixtures()["records"].tobytes())[:200000]


@pytest.mark.parametrize("jobs", [1, 4])
@pytest.mark.parametrize("level", [1, 2, 3])
def test_containers_with_gate_open(level, jobs, monkeypatch):
    """Levels 1 (LZX), 2 (DNA+LZ) and 3 (TEXT+UTF+PACK+MM+LZX) on device
    'cpu' at 64 KiB blocks, -j 1 and -j 4 (the writer's block threads):
    with the gate opened every LZ block runs the pass (its plain version)
    and the hinted parse, and the container is byte-identical with the
    gate closed and decodes back."""
    data = _container_input()
    args = dict(block_size=1 << 16, jobs=jobs, device="cpu")
    tops.reset_counters()
    closed = ktt.compress_bytes(data, *LEVEL_TABLE[level], **args)
    assert "lz_hinted_blocks" not in tops.COUNTERS
    monkeypatch.setattr(lzt, "_lz_on_device", lambda *a: True)
    tops.reset_counters()
    opened = ktt.compress_bytes(data, *LEVEL_TABLE[level], **args)
    counts = dict(tops.COUNTERS)
    assert counts["lz_hinted_blocks"] == counts["lz_match_pass_plain"] >= 1
    assert counts["lz_hinted_blocks"] <= -(-len(data) // (1 << 16))
    assert opened == closed
    assert ktt.decompress_bytes(opened, device="cpu") == data


@pytest.mark.parametrize("chain", ["l2", "l3"])
def test_mesh_chains_reach_hinted_path(chain, monkeypatch):
    """The level-2 and level-3 mesh chains (parallel.pipeline, mesh
    (cpu,)) run their LZ and LZX through the same transform: with the
    gate opened every block's pass and hinted parse run, and the
    container is byte-identical with the gate closed and decodes back."""
    from kanzi_tpu_torch.parallel import pipeline as tpp
    mesh = (torch.device("cpu"),)
    data = _container_input()[:3 * (1 << 16)]
    cm = getattr(tpp, f"compress_{chain}_mesh")
    tops.reset_counters()
    closed = cm(data, 1 << 16, mesh)
    assert "lz_hinted_blocks" not in tops.COUNTERS
    monkeypatch.setattr(lzt, "_lz_on_device", lambda *a: True)
    tops.reset_counters()
    opened = cm(data, 1 << 16, mesh)
    counts = dict(tops.COUNTERS)
    assert counts["lz_hinted_blocks"] == counts["lz_match_pass_plain"] >= 1
    assert opened == closed
    assert getattr(tpp, f"decompress_{chain}_mesh")(opened, mesh) == data


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("extra", [False, True])
def test_transform_on_card_matches_native(cuda_device, extra, monkeypatch):
    """LZCodec on the card (gate opened whatever LZ_HINT_MIN_BLOCK says):
    K's kernels once a block, the hinted parse, the native parse's
    bytes, on a 4 MiB mix and the corpora."""
    rng = np.random.default_rng(int(extra))
    mix = np.concatenate(
        [np.frombuffer(b"the hinted parse on the card; " * 70000, np.uint8),
         rng.integers(0, 256, (4 << 20) - 30 * 70000, dtype=np.uint8)])
    monkeypatch.setattr(lzt, "LZ_HINT_MIN_BLOCK", {16: 1, 19: 1})
    hl = 19 if extra else 16
    for name, data in {"mix_4m": mix, **_corpora()}.items():
        tops.reset_counters()
        got = LZCodec(Context({"device": str(cuda_device)}),
                      extra=extra).forward(data)
        counts = dict(tops.COUNTERS)
        assert counts["lz_match_pass"] == 1, (name, counts)
        assert counts["lz_hinted_blocks"] == 1, (name, counts)
        assert counts["lz_lcp"] == 1, (name, counts)
        assert counts["lz_count"] == len(tlz.digit_plan(hl)), (name, counts)
        assert _same(got, native.lzx_forward(data, hl, 4)), name
