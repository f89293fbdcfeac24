"""PyTorch port of the device suffix array and BWT (kanzi_tpu_torch.ops.bwt)
against the JAX package's (kanzi_tpu.ops.bwt, on JAX-CPU) and the native
SA-IS BWT, byte for byte: the suffix array is unique, so every tolerance
here is exact equality. These are torch ops without a kernel, so the CPU
run is the port's own code path; chip_smoke.py holds it on the card
against native.bwt_forward at 4 MiB.

The host chains' BWT stage (transform/bwt.py bwt_forward) takes this
path on a card from BWT_DEVICE_MIN_BLOCK bytes on where its peak fits,
and native SA-IS otherwise; the needs_cuda test runs a level-7 block
through it on the card:

    KANZI_TEST_TPU=1 python -m pytest -m needs_cuda tests/test_torch_bwt.py
"""

import numpy as np
import pytest
import torch

import kanzi_tpu_torch
import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.core.context import Context
from kanzi_tpu_torch.ops import bwt as tb
from kanzi_tpu_torch.transform import bwt as tbwt
from kanzi_tpu_torch.utils import native as tnative


def _post_text_wiki(size: int, seed: int = 2147490001) -> np.ndarray:
    """The bytes a BWT stage gets from a block of the benchmark's enwik8
    stand-in (gpubench/corpus.py): the block after LZP, TEXT and UTF."""
    from gpubench import corpus
    from kanzi_tpu_torch.core.context import Context
    from kanzi_tpu_torch.transform.factory import (new_transform,
                                                   transform_name_to_type)
    block = corpus.gen_wiki(corpus.member_rng(seed, 0), size)
    ctx = Context()
    ctx.put("blockSize", size)
    ctx.put("size", size)
    return new_transform(ctx, transform_name_to_type("LZP+TEXT+UTF")
                         ).forward(block)


def _case(name):
    rng = np.random.default_rng(11)
    if name == "wiki":
        return _post_text_wiki(256 << 10)
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
        "one_byte": np.full(30000, 0x61, np.uint8),
        # long zero runs between short random stretches
        "zero_runs": np.concatenate([np.concatenate(
            [np.zeros(int(z), np.uint8), rng.integers(1, 256, 200, np.uint8)])
            for z in rng.integers(2000, 6000, 6)]),
    }[name]


@pytest.mark.parametrize("name", ["n256", "odd", "zeros", "runs", "random",
                                  "text", "wiki", "one_byte", "zero_runs"])
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
    # the device suffix array on the CPU: the host's bytes
    assert tops.COUNTERS == {"bwt_forward_device": 1,
                             "bwt_forward_host_bytes": len(block)}
    assert kops.COUNTERS == {"bwt_forward_device": 1}
    blob = kanzi_tpu_torch.compress_bytes(data, "BWT", "NONE",
                                          block_size=8192, device="cpu")
    assert tops.COUNTERS == {"bwt_forward_device": 3,
                             "bwt_forward_host_bytes": 3 * len(block)}
    assert blob == gold
    assert kanzi_tpu_torch.decompress_bytes(blob, device="cpu") == data


# case: (the block's device, ops enabled, its bytes less the floor, the
# card's free bytes less the path's peak, whether the card takes it)
ROUTES = {
    "card": ("cuda:0", True, 0, 0, True),
    "card_above_floor": ("cuda", True, 1 << 20, 0, True),
    "cpu": ("cpu", True, 0, 0, False),
    "no_device": (None, True, 0, 0, False),
    "ops_disabled": ("cuda:0", False, 0, 0, False),
    "below_floor": ("cuda:0", True, -1, 0, False),
    "over_ceiling": ("cuda:0", True, 0, -1, False),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_bwt_forward_route(case, monkeypatch):
    """A block goes to the card's suffix array only from a CUDA device,
    with ops enabled, at or above the floor, and where the path's peak
    fits the card's free memory (the memory queries monkeypatched)."""
    dev, enabled, over, spare, want = ROUTES[case]
    n = tbwt.BWT_DEVICE_MIN_BLOCK + over
    free = n * tbwt.BWT_DEVICE_PEAK_PER_BYTE + spare
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d=None: (free, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d=None: 0)
    monkeypatch.setattr(tops, "ENABLED", enabled)
    dev = None if dev is None else torch.device(dev)
    assert (tbwt._bwt_on_device(dev, n) and tbwt._peak_fits(dev, n)) is want


@pytest.mark.parametrize("on_card", [True, False])
def test_bwt_codec_counts_bytes_by_side(on_card, monkeypatch):
    """BWTBlockCodec with a CUDA device in its context: where the route
    takes the card, ops.bwt.bwt_forward gets the block and its device
    (run here on the CPU) and bwt_forward_device_bytes its bytes, else
    native SA-IS runs and bwt_forward_host_bytes counts them; the codec's
    output equals the host codec's either way."""
    block = _post_text_wiki(64 << 10, seed=7)
    want = tbwt.BWTBlockCodec(Context({"device": "cpu"})).forward(block)
    real, seen = tb.bwt_forward, []

    def on_cpu(src, idx_count, device):
        seen.append(device)
        return real(src, idx_count, "cpu")
    monkeypatch.setattr(tb, "bwt_forward", on_cpu)
    monkeypatch.setattr(tbwt, "_bwt_on_device", lambda dev, n: on_card)
    monkeypatch.setattr(tbwt, "_peak_fits", lambda dev, n: True)
    tops.reset_counters()
    got = tbwt.BWTBlockCodec(Context({"device": "cuda:0"})).forward(block)
    assert np.array_equal(got, want)
    if on_card:
        assert seen == [torch.device("cuda:0")]
        assert tops.COUNTERS == {"bwt_forward_device": 1,
                                 "bwt_forward_device_bytes": len(block)}
    else:
        assert seen == []
        assert tops.COUNTERS == {"bwt_forward_host_bytes": len(block)}


def test_bwt_forward_card_peaks_never_overlap(monkeypatch):
    """Two threads' blocks (a writer's jobs) where the card's free memory
    holds one path's peak: the memory check and the suffix array run
    under one lock, so the second block reads the memory the first
    left, and the two never hold the card at once (ops.bwt.bwt_forward
    run here on the CPU, the memory queries monkeypatched to what the
    blocks on the card hold)."""
    import threading
    import time
    n = 8192
    peak = n * tbwt.BWT_DEVICE_PEAK_PER_BYTE
    real, lock, held = tb.bwt_forward, threading.Lock(), [0, 0]

    def on_cpu(src, idx_count, device):
        with lock:
            held[0] += 1
            held[1] = max(held)
        time.sleep(0.2)
        try:
            return real(src, idx_count, "cpu")
        finally:
            with lock:
                held[0] -= 1
    monkeypatch.setattr(tb, "bwt_forward", on_cpu)
    monkeypatch.setattr(tbwt, "BWT_DEVICE_MIN_BLOCK", 4096)
    monkeypatch.setattr(tops, "ENABLED", True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d=None: (peak + peak // 2 - held[0] * peak,
                                        80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d=None: 0)
    rng = np.random.default_rng(3)
    blocks = [rng.integers(0, 4, n, dtype=np.uint8) for _ in range(2)]
    start, got = threading.Barrier(2), [None, None]

    def run(i):
        start.wait()
        got[i] = tbwt.bwt_forward(blocks[i], "cuda:0")
    tops.reset_counters()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert held[1] == 1
    assert tops.COUNTERS["bwt_forward_device_bytes"] == 2 * n
    for b, (out, idx) in zip(blocks, got):
        want, want_idx = tnative.bwt_forward(b, 8)
        assert np.array_equal(out, want) and list(idx) == list(want_idx)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the route takes the card only there")
    return torch.device("cuda", 0)


@pytest.mark.needs_cuda
def test_l7_mesh_bwt_forward_on_card(cuda_device, monkeypatch):
    """A 16 MiB block of the enwik8 stand-in through compress_l7_mesh:
    its BWT forward on the card (bwt_forward_device_bytes holds the
    block's BWT input, no host bytes), the same container as with the
    card's BWT forward off (the floor above the block), and the stream
    decodes through decompress_l7_mesh."""
    from gpubench import corpus
    from kanzi_tpu_torch.parallel import pipeline as tpp
    n = 16 << 20
    data = corpus.gen_wiki(corpus.member_rng(2147490001, 0), n).tobytes()
    mesh = (cuda_device,)
    tops.reset_counters()
    blob = tpp.compress_l7_mesh(data, n, mesh)
    on = dict(tops.COUNTERS)
    monkeypatch.setattr(tbwt, "BWT_DEVICE_MIN_BLOCK", n + 1)
    tops.reset_counters()
    host = tpp.compress_l7_mesh(data, n, mesh)
    off = dict(tops.COUNTERS)
    assert "bwt_forward_host_bytes" not in on
    assert on["bwt_forward_device_bytes"] > n // 2
    assert "bwt_forward_device_bytes" not in off
    assert off["bwt_forward_host_bytes"] == on["bwt_forward_device_bytes"]
    assert blob == host
    assert tpp.decompress_l7_mesh(blob, mesh) == data
