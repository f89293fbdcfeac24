"""The block mesh of the PyTorch port over more than one device
(kanzi_tpu_torch.parallel.mesh, parallel.dryrun) on the CPU: a mesh that
names the CPU k times runs k shards in turn, as kanzi_tpu's tests stand
in for chips with virtual CPU devices (tests/test_multichip.py), and a
mesh of two distinct device objects (cpu, cpu:0) runs each in its own
host thread. The format is exact, so every tolerance here is exact
equality.

On the CPU the kernels' plain versions run (FPAQ's G and H cost ~1 ms a
byte a call, CM's I and J ~2.5 ms), so dryrun_multichip runs at 1/16 of
kanzi_tpu's block sizes (1 KiB blocks for l6 and l7; l2 and l3 keep one
full 16 KiB Huffman chunk a block) and the shard functions at a few
streams of a few hundred bytes.
"""

import threading

import numpy as np
import pytest
import torch

import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.ops import ans as tans
from kanzi_tpu_torch.ops import huffman as thuff
from kanzi_tpu_torch.parallel import dryrun
from kanzi_tpu_torch.parallel import mesh as tmesh

CPU = torch.device("cpu")
CPU0 = torch.device("cpu", 0)        # a device object distinct from CPU
SCALE = 1 / 16

# the kernels (plain versions on the CPU) of each chain, each way, that
# launch once a shard
CHAIN_KERNELS = {
    ("l5", "encode"): ("sbrt_plain", "segment_states_plain"),
    ("l5", "decode"): ("sbrt_plain",),
    ("l2", "encode"): ("huff_code_tables_plain", "huff_pack_plain"),
    ("l2", "decode"): ("huff_decode_plain",),
    ("l3", "encode"): ("huff_code_tables_plain", "huff_pack_plain"),
    ("l3", "decode"): ("huff_decode_plain",),
    ("l6", "encode"): ("fpaq_encode_plain",),
    ("l6", "decode"): ("fpaq_decode_plain",),
    ("l7", "encode"): ("cm_encode_plain",),
    ("l7", "decode"): ("cm_decode_plain",),
}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_dryrun_multichip_cpu(k, capsys):
    """Every chain at the 1-device submesh and over k CPU shards (l7 over
    the k only) is byte-identical with the host writer and decodes back
    (dryrun_multichip raises otherwise); each chain's kernels launch
    once a shard; the MESH_SCALING line lists 1, 2, 4, ... devices."""
    res = dryrun.dryrun_multichip((CPU,) * k, SCALE)
    for (name, way), kernels in CHAIN_KERNELS.items():
        for d in ((k,) if name == "l7" or k == 1 else (1, k)):
            counts = res["launches"][(name, d, way)]
            for kern in kernels:
                assert counts.get(kern) == d, (name, d, way, counts)
    assert [p["devices"] for p in res["scaling"]] == [
        d for d in (1, 2, 4) if d <= k]
    assert "MESH_SCALING " in capsys.readouterr().out


def test_block_mesh():
    """block_mesh names the devices given, in order, repeats included;
    with no devices it takes every card, and raises without one."""
    assert tmesh.block_mesh([CPU]) == (CPU,)
    assert tmesh.block_mesh(["cpu", "cpu", "cpu"]) == (CPU,) * 3
    with pytest.raises(ValueError):
        tmesh.block_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.block_mesh()
    else:
        assert len(tmesh.block_mesh()) == torch.cuda.device_count()


def _huffman_case(rng, c):
    chunks = rng.integers(0, 30, (c, thuff.CHUNK), dtype=np.uint8)
    chunks[1] = 5                                   # one symbol: no pairs
    return chunks


@pytest.mark.timeout(300)
@pytest.mark.parametrize("k", [2, 3])
def test_shard_functions_uneven_match_one_device(k):
    """Every shard function over k CPU shards at a batch size that is not
    a multiple of k (so the shards differ in length, as np.array_split
    cuts them) equals the 1-device result, and launches its kernel once
    a shard."""
    mesh, one = (CPU,) * k, (CPU,)
    rng = np.random.default_rng(k)

    def same(a, b):
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b)
        else:
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y) if isinstance(x, (tuple, list, np.ndarray)) \
                    else (x == y or pytest.fail(f"{x!r} != {y!r}"))

    def run(fn, *args, kernel, **kw):
        tops.reset_counters()
        got = fn(*args, mesh=mesh, **kw)
        assert tops.COUNTERS.get(kernel) == k, (kernel, tops.COUNTERS)
        want = fn(*args, mesh=one, **kw)
        same(got, want)
        return got

    # ANS0, 4 chunks (k = 3: shards of 2, 1 and 1) or 3 (k = 2: 2 and 1)
    c = 4 if k == 3 else 3
    chunks = rng.integers(0, 50, (c, tans.CHUNK), dtype=np.uint8)
    chunks[1] = 9                                   # header-only chunk
    hdr, bitlen, m, flat, plen = run(tmesh.shard_ans0_encode, chunks,
                                     kernel="ans0_encode_scan_plain")
    freqs = tans.normalize(tans.histogram(torch.from_numpy(chunks))).numpy()
    states = dryrun._chunk_states(hdr, bitlen, m)
    keep = m > 1
    pay = np.zeros((c, tans.PAYLOAD_MAX + 2), np.uint8)
    off = np.cumsum(plen) - plen
    for i in range(c):
        pay[i, :plen[i]] = flat[off[i]:off[i] + plen[i]]
    out, cur = run(tmesh.shard_ans0_decode, freqs[keep], states[keep],
                   pay[keep], kernel="ans0_decode_plain")
    assert np.array_equal(out, chunks[keep]) and np.array_equal(
        cur, plen[keep])

    # Huffman, the same chunk counts; the decode takes each ok chunk's 4
    # fragments, its pairs and then the last nb bits of acc
    hchunks = _huffman_case(rng, c)
    enc = run(tmesh.shard_huffman_encode, hchunks,
              kernel="huff_pack_plain")
    _, _, ok, _, hflat, npairs, acc, nb, _ = enc
    assert list(ok) == [i != 1 for i in range(c)]
    codes, sizes = thuff.compute_code_tables(torch.from_numpy(np.stack(
        [np.bincount(x, minlength=256) for x in hchunks[ok]])))[:2]
    frags, base = [], 0
    for i in np.nonzero(ok)[0]:
        for f in range(4):
            kp, n_bits = int(npairs[i, f]), int(nb[i, f])
            tail = [(int(acc[i, f]) >> (n_bits - 1 - j)) & 1
                    for j in range(n_bits)]
            frags.append(np.concatenate(
                [hflat[2 * base:2 * (base + kp)],
                 np.packbits(np.array(tail, np.uint8))]))
            base += kp
    hpay = np.concatenate(frags)
    bounds = np.concatenate([[0], np.cumsum([len(x) for x in frags])])
    dec = run(tmesh.shard_huffman_decode, codes.numpy(), sizes.numpy(),
              hpay, bounds, kernel="huff_decode_plain")
    assert np.array_equal(dec, hchunks[ok])

    # FPAQ and CM, 4 or 3 streams of up to 200 bytes, one of them empty
    b = 4 if k == 3 else 3
    lens = np.array([200, 64, 0, 129][:b])
    streams = rng.integers(0, 7, (b, 200), dtype=np.uint8)
    bufs, low56, _, _ = run(tmesh.shard_fpaq_encode, streams, lens,
                            chunk_bytes=1024,
                            kernel="fpaq_encode_plain")
    frames = []
    for w, low, n in zip(bufs, low56, lens):
        t = w + low.to_bytes(7, "big")
        frames.append([(int.from_bytes(t[:7], "big"), t[7:7 + len(w)])]
                      if n else [])
    out = run(tmesh.shard_fpaq_decode, frames, lens, chunk_bytes=1024,
              kernel="fpaq_decode_plain")
    for i, n in enumerate(lens):
        assert np.array_equal(out[i, :n], streams[i, :n])

    cbufs, clow, over = run(tmesh.shard_cm_encode, streams, lens, bs_version=6,
                            kernel="cm_encode_plain")
    assert not any(over)
    records = []
    for w, low in zip(cbufs, clow):
        t = w + low.to_bytes(7, "big")
        records.append((int.from_bytes(t[:7], "big"), t[7:]))
    out = run(tmesh.shard_cm_decode, records, lens, bs_version=6,
              kernel="cm_decode_plain")
    for i, n in enumerate(lens):
        assert np.array_equal(out[i, :n], streams[i, :n])


def test_failed_shard_raises(monkeypatch):
    """A shard whose launch fails raises through the shard function:
    nothing falls back or carries on."""
    calls = []

    def broken(chunks, device):
        calls.append(len(chunks))
        if len(calls) == 2:
            raise RuntimeError("ans0_encode_scan: CUDA launch failed")
        return real(chunks, device)

    real = tans.encode_chunks_np
    monkeypatch.setattr(tans, "encode_chunks_np", broken)
    chunks = np.zeros((3, tans.CHUNK), np.uint8)
    with pytest.raises(RuntimeError, match="launch failed"):
        tmesh.shard_ans0_encode(chunks, (CPU,) * 3)
    assert calls == [1, 1]


def test_shards_over_distinct_devices(monkeypatch):
    """Over a mesh of two distinct device objects (cpu, cpu:0), each
    device's shards run in one host thread of their own, in mesh order,
    and the outputs join in shard order: equal to the 1-device result."""
    seen = []
    real = tans.encode_chunks_np

    def on(chunks, device):                     # every shard on the CPU
        seen.append((device, threading.get_ident(), len(chunks)))
        return real(chunks, CPU)

    monkeypatch.setattr(tans, "encode_chunks_np", on)
    rng = np.random.default_rng(11)
    chunks = rng.integers(0, 50, (7, tans.CHUNK), dtype=np.uint8)
    mesh = (CPU, CPU0, CPU, CPU0, CPU)          # shards of 2, 2, 1, 1, 1
    got = tmesh.shard_ans0_encode(chunks, mesh)
    by_dev = {}
    for d, thread, n in seen:
        by_dev.setdefault(d, []).append((thread, n))
    assert [n for _, n in by_dev[CPU]] == [2, 1, 1]
    assert [n for _, n in by_dev[CPU0]] == [2, 1]
    threads = {d: {t for t, _ in v} for d, v in by_dev.items()}
    assert all(len(t) == 1 for t in threads.values())
    assert threads[CPU] != threads[CPU0]
    assert threading.get_ident() not in threads[CPU] | threads[CPU0]
    want = tmesh.shard_ans0_encode(chunks, (CPU,))
    for x, y in zip(got, want):
        assert np.array_equal(x, y)
