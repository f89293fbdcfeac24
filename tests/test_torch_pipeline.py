"""PyTorch port of the device level-5 pipeline (kanzi_tpu_torch.parallel)
against the JAX package's (kanzi_tpu.parallel, on a 1-device JAX-CPU
mesh) and the host writer, byte for byte: the format is exact, so every
tolerance here is exact equality.

On the CPU the SBRT and ANS0 wrappers run their plain versions (RANK
costs ~150 us a byte), so the blocks are 48 KiB, the l5 mix of
kanzi_tpu's dryrun (__graft_entry__.py).
"""

import numpy as np
import pytest
import torch

import kanzi_tpu_torch
import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.ops import ans as tans
from kanzi_tpu_torch.parallel import mesh as tmesh
from kanzi_tpu_torch.parallel import pipeline as tpp
from kanzi_tpu_torch.transform.zrlt import ZRLT

CPU = torch.device("cpu")


def _zrlt_case(name):
    rng = np.random.default_rng(21)
    if name == "escapes":                # 0xFE / 0xFF literals among zeros
        return rng.choice(np.array([0, 0, 1, 7, 0xFD, 0xFE, 0xFF],
                                   np.uint8), 3000)
    if name == "long_runs":              # runs of 2^k - 1, 2^k, 2^k + 1
        parts = []
        for k in (1, 2, 5, 8, 12):
            for run in (2 ** k - 1, 2 ** k, 2 ** k + 1):
                parts += [np.zeros(run, np.uint8), np.array([9], np.uint8)]
        return np.concatenate(parts)
    # a trailing zero run: its digits end the forward output
    return np.concatenate([rng.integers(0, 3, 500, dtype=np.uint8),
                           np.zeros(777, np.uint8)])


@pytest.mark.parametrize("name", ["escapes", "long_runs", "trailing"])
def test_zrlt_matches_jax(name):
    """_zrlt_forward == kanzi_tpu's _zrlt_forward_jnp (bytes and total,
    at a capacity of the input length) and the host transform where that
    fits; _zrlt_inverse of the output followed by 64 pad digits ==
    _zrlt_inverse_jnp's and the input."""
    import jax
    import jax.numpy as jnp
    from kanzi_tpu.parallel import pipeline as jpp
    data = _zrlt_case(name)
    m = len(data)
    out, total = tpp._zrlt_forward(torch.from_numpy(data.copy())[None], m)
    want, want_total = jax.jit(jpp._zrlt_forward_jnp, static_argnums=1)(
        jnp.asarray(data), m)
    assert int(total[0]) == int(want_total)
    assert np.array_equal(out[0].numpy(), np.asarray(want))
    host = ZRLT().forward(data)
    if int(total[0]) <= m:
        assert np.array_equal(out[0, :int(total[0])].numpy(), host)
    enc = np.asarray(want)[:min(int(want_total), m)]
    padded = np.concatenate([enc, np.zeros(64, np.uint8)])
    back = tpp._zrlt_inverse(torch.from_numpy(padded)[None], m)
    want_back = np.asarray(jpp._zrlt_inverse_jnp(jnp.asarray(padded), m))
    assert np.array_equal(back[0].numpy(), want_back)
    if int(want_total) <= m:
        assert np.array_equal(back[0].numpy(), data)
        # told the real length, the row decodes to exactly m bytes (a
        # trailing zero run counted in full) and passes the check
        checked = tpp._zrlt_inverse(torch.from_numpy(padded)[None], m,
                                    torch.tensor([len(enc)]))
        assert np.array_equal(checked[0].numpy(), data)


def test_zrlt_inverse_matches_jax_on_any_bytes():
    """Bytes that no forward writes (operand 0xFF, runs of 0xFF, an
    escape at the end, operands of any value): still _zrlt_inverse_jnp's
    output, row by row, and a run past the scan's int32 state raises.
    Given the rows' real lengths, a row that ends in an escape or
    decodes to more or fewer bytes than asked raises, as the host
    inverse does on an escape at the end."""
    import jax.numpy as jnp
    from kanzi_tpu.parallel import pipeline as jpp
    rng = np.random.default_rng(8)
    rows = rng.choice(np.array([0, 1, 1, 2, 0x41, 0xFE, 0xFF, 0xFF],
                               np.uint8), (3, 2000))
    rows[1, -1] = 0xFF
    got = tpp._zrlt_inverse(torch.from_numpy(rows), 2500)
    for i in range(3):
        want = np.asarray(jpp._zrlt_inverse_jnp(jnp.asarray(rows[i]), 2500))
        assert np.array_equal(got[i].numpy(), want), i
    long_run = np.concatenate([np.ones(31, np.uint8), [5]])
    with pytest.raises(ValueError, match="malformed"):
        tpp._zrlt_inverse(torch.from_numpy(long_run)[None], 100)
    # [9, 0xFF, 0, 1, 1, 5] -> 8, 0xFE, then 2^2 + 3 - 1 = 6 zeros, 4
    row = np.array([9, 0xFF, 0, 1, 1, 5, 0, 0], np.uint8)
    good = tpp._zrlt_inverse(torch.from_numpy(row)[None], 9,
                             torch.tensor([6]))
    assert list(good[0].numpy()) == [8, 0xFE] + [0] * 6 + [4]
    for n_real, out_n in ((2, 1),      # ends in the escape 0xFF
                          (6, 10),     # decodes to 9 bytes, not 10
                          (6, 8),      # not 8
                          (5, 9)):     # a trailing run of 6 zeros: 8 bytes
        with pytest.raises(ValueError, match="malformed"):
            tpp._zrlt_inverse(torch.from_numpy(row)[None], out_n,
                              torch.tensor([n_real]))


def test_block_mesh_and_sharded_ans0():
    """block_mesh gives the devices named, one or several (a device named
    twice stands in for two cards); shard_ans0_encode's output decodes
    back through shard_ans0_decode with kanzi_tpu's [C, W] payload
    rows."""
    assert tmesh.block_mesh([CPU]) == (CPU,)
    assert tmesh.block_mesh([CPU, CPU]) == (CPU, CPU)
    rng = np.random.default_rng(3)
    chunks = rng.integers(0, 40, (2, tans.CHUNK), dtype=np.uint8)
    chunks[1] = 7                                   # header-only chunk
    hdr, bitlen, m, flat, plen = tmesh.shard_ans0_encode(chunks, (CPU,))
    assert list(m) == [40, 1] and plen[1] == 0
    pay = np.zeros((2, tans.PAYLOAD_MAX + 2), np.uint8)
    pay[0, :plen[0]] = flat
    freqs = tans.normalize(tans.histogram(torch.from_numpy(chunks))).numpy()
    states = np.zeros((2, 4), np.uint32)
    states[0] = tans.ans0_encode_scan(
        torch.from_numpy(chunks[:1]),
        *tans.encode_tables(torch.from_numpy(freqs[:1])))[0].numpy().view(
            np.uint32)
    out, cur = tmesh.shard_ans0_decode(freqs[:1], states[:1], pay[:1],
                                       (CPU,))
    assert np.array_equal(out[0], chunks[0]) and cur[0] == plen[0]


def _l5_data():
    """The dryrun's l5 mix for one device (sparse, random, binary runs;
    48 KiB each), one text block that takes the host chain, and a tail."""
    rng = np.random.default_rng(1)
    n = 49152
    parts = [np.repeat(rng.integers(0, 4, n // 4, dtype=np.uint8), 4)[:n],
             rng.integers(0, 256, n, dtype=np.uint8),
             np.repeat(rng.integers(0, 2, n // 8, dtype=np.uint8), 8)[:n],
             np.frombuffer((b"the quick brown fox jumps over the lazy "
                            b"dog. " * 1200)[:n], np.uint8)]
    return np.concatenate(parts).tobytes() + b"tail" * 9, n


def test_compress_l5_mesh_matches_jax_and_host():
    """The port's compress_l5_mesh on the CPU == kanzi_tpu's on a 1-device
    JAX-CPU mesh == the host writer (with three blocks through the device
    chain and the text block and tail through the host chain); the port's
    decompress_l5_mesh decodes kanzi_tpu's bytes and kanzi_tpu's
    decompress_bytes the port's."""
    import jax
    import kanzi_tpu
    from kanzi_tpu.parallel import mesh as jmesh
    from kanzi_tpu.parallel import pipeline as jpp
    data, n = _l5_data()
    tops.disable()
    try:
        gold = kanzi_tpu_torch.compress_bytes(data, tpp.CHAIN, tpp.ENTROPY,
                                              block_size=n)
    finally:
        tops.enable()
    tops.reset_counters()
    ours = tpp.compress_l5_mesh(data, n, tmesh.block_mesh([CPU]))
    assert tops.COUNTERS["l5_encode_device_blocks"] == 3, tops.COUNTERS
    assert tops.COUNTERS["sbrt_plain"] == 1
    theirs = jpp.compress_l5_mesh(data, n,
                                  jmesh.block_mesh(jax.devices()[:1]))
    assert ours == gold
    assert theirs == gold
    tops.reset_counters()
    assert tpp.decompress_l5_mesh(theirs, (CPU,)) == data
    assert tops.COUNTERS["l5_decode_device_blocks"] == 3, tops.COUNTERS
    assert tops.COUNTERS["sbrt_plain"] == 1
    assert kanzi_tpu.decompress_bytes(ours) == data


def test_l5_chain_matches_host_stages():
    """The fused chain on two 16 KiB blocks: its ZRLT totals and the ANS0
    payload of each block's one full chunk of ZRLT output == the host
    transforms (BWT codec, RANK, ZRLT) followed by the ANS0 encode of
    that chunk."""
    from kanzi_tpu_torch.transform.bwt import BWTBlockCodec
    from kanzi_tpu_torch.transform.sbrt import MODE_RANK, SBRT
    rng = np.random.default_rng(6)
    n = tans.CHUNK
    blocks = np.stack([
        np.repeat(rng.integers(0, 6, n // 8, dtype=np.uint8), 8),
        np.repeat(rng.integers(0, 40, n // 2, dtype=np.uint8), 2)])
    flat, plen, zt = tpp.l5_chain(torch.from_numpy(blocks))
    firsts = np.zeros((2, n), np.uint8)
    for i, block in enumerate(blocks):
        rk = SBRT(mode=MODE_RANK).forward(BWTBlockCodec().forward(block))
        z = ZRLT().forward(rk)
        assert int(zt[i]) == len(z)
        firsts[i, :min(n, len(z))] = z[:n]
    want = tans.encode_chunks_np(firsts, CPU)
    assert np.array_equal(plen.numpy(), want[4])
    assert np.array_equal(flat.numpy(), want[3])
