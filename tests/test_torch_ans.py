"""PyTorch port of the ANS0 stage (kanzi_tpu_torch.ops.ans) against the
JAX package (kanzi_tpu.ops.ans, on the CPU as its own tests run it) and
the numpy golden models, bit for bit: the format is integer-only, so
every tolerance here is exact equality.

On the CPU the kernel wrappers run their plain PyTorch versions; the
kernels themselves are held against those versions by the needs_cuda
tests at the end, which skip without a card. The JAX package comes in
through the ``dans`` fixture, so that the needs_cuda tests also run on a
machine without JAX (KANZI_TEST_TPU=1 keeps conftest.py from importing
it):

    KANZI_TEST_TPU=1 python -m pytest -m needs_cuda tests/test_torch_ans.py
"""

import numpy as np
import pytest
import torch

from kanzi_tpu.bitstream import BitWriter
from kanzi_tpu.entropy import utils as eu
from kanzi_tpu.entropy.ans import ANSRangeEncoder, _sym_encode_tables

import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.ops import ans as tans

CPU = torch.device("cpu")
CHUNK = tans.CHUNK


@pytest.fixture(scope="module")
def dans():
    """kanzi_tpu.ops.ans, the JAX reference (on the CPU backend)."""
    from kanzi_tpu.ops import ans
    return ans


def _chunk_corpus():
    """The six chunks of tests/test_ops_ans.py plus two skewed ones whose
    normalization takes the hard (error-spreading) path: 8 chunks, one
    JAX shape bucket."""
    rng = np.random.default_rng(7)
    text = (b"the quick brown fox jumps over the lazy dog " * 500)[:CHUNK]
    return np.stack([
        rng.integers(0, 256, CHUNK).astype(np.uint8),
        rng.choice(np.arange(4, dtype=np.uint8), CHUNK),
        np.frombuffer(text, dtype=np.uint8),
        np.zeros(CHUNK, dtype=np.uint8),
        np.full(CHUNK, 0xAB, dtype=np.uint8),
        rng.choice(np.arange(255, 256, dtype=np.uint8), CHUNK),
        (rng.geometric(0.02, CHUNK) % 256).astype(np.uint8),
        (rng.integers(0, 256, CHUNK) // 3).astype(np.uint8),
    ])


def _scan(chunks):
    """The port's plain pipeline up to the scan, on CPU tensors."""
    t = torch.from_numpy(chunks)
    freqs = tans.normalize(tans.histogram(t))
    packed, inv = tans.encode_tables(freqs)
    states, vm, nren = tans.ans0_encode_scan(t, packed, inv)
    return freqs, states, vm, nren


def test_encode_matches_jax(dans):
    """hdr, bitlen, m, flat, plen == kanzi_tpu.ops.ans.encode_chunks_np."""
    chunks = _chunk_corpus()
    tops.reset_counters()
    got = tans.encode_chunks_np(chunks, CPU)
    ref = dans.encode_chunks_np(chunks)
    for name, g, r in zip(("hdr", "bitlen", "m", "flat", "plen"), got, ref):
        assert g.shape == r.shape, name
        assert np.array_equal(g, r), name
    assert tops.COUNTERS == {"ans0_encode_scan_plain": 1,
                             "ans0_compact_plain": 1}


def test_encode_matches_numpy_golden():
    """Normalized freqs == eu.normalize_frequencies; final states and the
    renorm stream == the golden lane runner (_sym_encode_tables +
    _run_lanes)."""
    chunks = _chunk_corpus()
    freqs, states, vm, nren = _scan(chunks)
    enc = ANSRangeEncoder.__new__(ANSRangeEncoder)
    enc.obs = BitWriter()
    enc.order, enc.log_range, enc.chunk_size = 0, 12, CHUNK
    pos = CHUNK - 1 - 4 * np.arange(CHUNK // 4)[:, None] - np.arange(4)
    for i, ch in enumerate(chunks):
        f = np.bincount(ch, minlength=256).astype(np.int64)
        alpha = eu.normalize_frequencies(f, 256, CHUNK, 4096)
        assert np.array_equal(freqs[i].numpy(), f[:256])
        if len(alpha) <= 1:
            assert nren[i].sum() == 0          # header-only chunk
            continue
        st, renorm = enc._run_lanes(ch[pos].astype(np.int64),
                                    _sym_encode_tables(f[None, :256], 12))
        assert np.array_equal(states[i].numpy(), st & 0xFFFFFFFF)
        row = torch.zeros(1, dtype=torch.int64)
        n16 = int(nren[i].sum())
        assert tans.compact_rows(vm[i:i + 1].contiguous(), row,
                                 n16).numpy().tobytes() == renorm


def test_headers_match_numpy_packer(dans):
    chunks = _chunk_corpus()
    freqs, states, vm, nren = _scan(chunks)
    plen = 2 * nren.long().sum(1)
    hdr, bitlen, m = tans.pack_headers(freqs, states, plen)
    hdr_n, bitlen_n, m_n = dans.pack_ans0_headers(
        freqs.numpy(), states.numpy().astype(np.uint32), plen.numpy())
    assert np.array_equal(hdr.numpy(), hdr_n)
    assert np.array_equal(bitlen.numpy(), bitlen_n)
    assert np.array_equal(m.numpy(), m_n)


@pytest.mark.parametrize("seed", range(4))
def test_headers_match_numpy_packer_random_alphabets(dans, seed):
    """Random alphabets of every size class (1, < 64, >= 64, 256
    symbols) and payload lengths of 1-3 varint bytes."""
    rng = np.random.default_rng(100 + seed)
    c = 16
    freqs = np.zeros((c, 256), np.int64)
    for i in range(c):
        k = int(rng.choice([1, 2, 5, 63, 64, 200, 256]))
        syms = rng.choice(256, k, replace=False)
        cuts = np.sort(rng.choice(np.arange(1, 4096), k - 1, replace=False))
        freqs[i, syms] = np.diff(np.concatenate([[0], cuts, [4096]]))
    states = rng.integers(1 << 15, 1 << 31, (c, 4)).astype(np.uint32)
    plen = 2 * rng.integers(0, CHUNK, c)
    hdr, bitlen, m = tans.pack_headers(*tans.from_numpy(
        (freqs, states, plen), CPU))
    ref = dans.pack_ans0_headers(freqs, states, plen)
    for g, r in zip((hdr, bitlen, m), ref):
        assert np.array_equal(g.numpy(), r)


def test_decode_matches_jax_and_roundtrips(dans):
    chunks = _chunk_corpus()
    freqs, states, vm, nren = _scan(chunks)
    plen16 = nren.long().sum(1)
    off16 = plen16.cumsum(0) - plen16
    flat = tans.compact_rows(vm, off16, int(plen16.sum()))
    f2s, fc = tans.decode_tables(freqs)
    tops.reset_counters()
    out, consumed = tans.ans0_decode(f2s, fc, states, flat, 2 * off16)
    assert tops.COUNTERS == {"ans0_decode_plain": 1}
    multi = (freqs > 0).sum(1) > 1
    assert torch.equal(out[multi], torch.from_numpy(chunks)[multi])
    assert torch.equal(consumed[multi].long(), 2 * plen16[multi])
    # kanzi_tpu's decode over the same padded payload rows
    pay = np.zeros((len(chunks), dans.PAYLOAD_MAX + 2), np.uint8)
    flat_np = flat.numpy()
    for i in range(len(chunks)):
        s = 2 * int(off16[i])
        pay[i, :2 * int(plen16[i])] = flat_np[s:s + 2 * int(plen16[i])]
    ref_out, ref_cur = dans.decode_chunks_np(
        freqs.numpy().astype(np.int32), states.numpy().astype(np.uint32),
        pay)
    assert np.array_equal(out.numpy()[multi.numpy()],
                          ref_out[multi.numpy()])
    assert np.array_equal(consumed.numpy()[multi.numpy()],
                          ref_cur[multi.numpy()])


def test_decode_flat_of_jax_encoded_chunks(dans):
    """from_numpy + ans0_decode_flat on kanzi_tpu's padded encode."""
    chunks = _chunk_corpus()
    freqs, states, payload, plen = dans.ans0_encode_chunks_padded(chunks)
    freqs, states, payload, plen = (np.asarray(a) for a in
                                    (freqs, states, payload, plen))
    offs = np.arange(len(chunks)) * payload.shape[1]
    out, consumed = tans.ans0_decode_flat(freqs, states, payload.reshape(-1),
                                          offs, CPU)
    f_t, st_t = tans.from_numpy((freqs, states), CPU)
    assert st_t.dtype == torch.int64 and torch.equal(f_t.long().sum(1),
                                                     torch.full((8,), 4096))
    for i, ch in enumerate(chunks):
        if (np.bincount(ch, minlength=256) > 0).sum() > 1:
            assert np.array_equal(out[i], ch)
            assert consumed[i] == plen[i]


def test_decode_reads_zero_past_the_payload():
    """A truncated stream is decoded as if zero-padded: the decode reads
    0 past the end of the payload (as the kernel does) instead of out of
    bounds, and the chunks before the cut come out intact."""
    chunks = _chunk_corpus()[:3]
    freqs, states, vm, nren = _scan(chunks)
    plen16 = nren.long().sum(1)
    off16 = plen16.cumsum(0) - plen16
    flat = tans.compact_rows(vm, off16, int(plen16.sum()))
    f2s, fc = tans.decode_tables(freqs)
    n = int(2 * off16[2]) + 100
    cut = flat[:n].clone()
    padded = torch.cat([cut, torch.zeros(flat.numel() - n,
                                          dtype=torch.uint8)])
    out, consumed = tans.ans0_decode(f2s, fc, states, cut, 2 * off16)
    out_p, consumed_p = tans.ans0_decode(f2s, fc, states, padded, 2 * off16)
    assert torch.equal(out, out_p) and torch.equal(consumed, consumed_p)
    assert torch.equal(out[:2], torch.from_numpy(chunks[:2]))
    assert not torch.equal(out[2], torch.from_numpy(chunks[2]))


@pytest.mark.parametrize("case", ["offset-0", "offset-2", "offset-6",
                                  "offset-14", "cut"])
def test_decode_at_payload_offsets_matches_jax(dans, case):
    """The port's ans0_decode over one flat payload stream placed behind
    k filler bytes, or cut 100 bytes into chunk 2's payload, against
    kanzi_tpu's decode_chunks_np over the same bytes as padded rows (0
    past the cut): symbols and consumed bytes of every coded chunk."""
    chunks = _chunk_corpus()
    freqs, states, vm, nren = _scan(chunks)
    plen16 = nren.long().sum(1)
    off16 = plen16.cumsum(0) - plen16
    flat = tans.compact_rows(vm, off16, int(plen16.sum())).numpy()
    k = 0 if case == "cut" else int(case.split("-")[1])
    if case == "cut":
        flat = flat[:2 * int(off16[2]) + 100]
    rng = np.random.default_rng(k)
    pay = np.concatenate([rng.integers(0, 256, k).astype(np.uint8), flat])
    f2s, fc = tans.decode_tables(freqs)
    out, consumed = tans.ans0_decode(f2s, fc, states, torch.from_numpy(pay),
                                     k + 2 * off16)
    rows = np.zeros((len(chunks), dans.PAYLOAD_MAX + 2), np.uint8)
    for i in range(len(chunks)):
        part = flat[2 * int(off16[i]):2 * int(off16[i] + plen16[i])]
        rows[i, :len(part)] = part
    ref_out, ref_cur = dans.decode_chunks_np(
        freqs.numpy().astype(np.int32), states.numpy().astype(np.uint32),
        rows)
    multi = ((freqs > 0).sum(1) > 1).numpy()
    assert np.array_equal(out.numpy()[multi], ref_out[multi])
    assert np.array_equal(consumed.numpy()[multi], ref_cur[multi])
    if case == "cut":
        assert np.array_equal(out.numpy()[:2], chunks[:2])
        assert not np.array_equal(out.numpy()[2], chunks[2])
    else:
        assert np.array_equal(out.numpy()[multi], chunks[multi])


def _compact_reference(vm, off16, total16):
    out = np.zeros(2 * total16, np.uint8)
    for r in range(vm.shape[0]):
        d = off16[r]
        for v in vm[r]:
            if (v >> 16) & 1:
                out[2 * d] = v & 0xFF
                out[2 * d + 1] = (v >> 8) & 0xFF
                d += 1
    return out


@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 0.5, 1.0])
def test_compaction_fuzz(density):
    """compact_rows == a row-by-row loop, for flag densities from none to
    all, random garbage in the unflagged slots."""
    rng = np.random.default_rng(int(density * 1000) + 1)
    c = 5
    flags = rng.random((c, CHUNK)) < density
    vals = rng.integers(0, 1 << 16, (c, CHUNK))
    junk = rng.integers(0, 1 << 15, (c, CHUNK)) << 17     # high bits set
    vm = ((flags.astype(np.int64) << 16) | vals | junk).astype(np.int32)
    counts = flags.sum(1)
    off16 = np.cumsum(counts) - counts
    total16 = int(counts.sum())
    got = tans.compact_rows(torch.from_numpy(vm), torch.from_numpy(off16),
                            total16)
    assert np.array_equal(got.numpy(), _compact_reference(vm, off16, total16))


def test_wrappers_check_their_inputs():
    chunks = torch.zeros((2, CHUNK), dtype=torch.uint8)
    packed = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="packed"):
        tans.ans0_encode_scan(chunks, packed.long(), packed)
    with pytest.raises(ValueError, match="chunks"):
        tans.ans0_encode_scan(chunks[:, :100], packed, packed)
    with pytest.raises(ValueError, match="contiguous"):
        tans.compact_rows(torch.zeros((CHUNK, 2), dtype=torch.int32).t(),
                          torch.zeros(2, dtype=torch.int64), 0)
    with pytest.raises(ValueError, match="no kernel"):
        tans.ans0_encode_scan(chunks.to("meta"), packed.to("meta"),
                              packed.to("meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("n_chunks", [8, 64, 256])
def test_kernels_match_plain_on_cuda(cuda_device, n_chunks):
    """Kernels A, B and C against their plain versions on the card, on
    incompressible chunks (the shape class that once miscompiled on the
    TPU, tests/test_device_regression.py) plus the corpus above."""
    rng = np.random.default_rng(n_chunks)
    host = rng.integers(0, 256, (n_chunks, CHUNK)).astype(np.uint8)
    host[:8] = _chunk_corpus()
    chunks = torch.from_numpy(host).to(cuda_device)
    freqs = tans.normalize(tans.histogram(chunks))
    packed, inv = tans.encode_tables(freqs)
    got = tans.ans0_encode_scan(chunks, packed, inv)
    ref = tans.ans0_encode_scan_plain(chunks, packed, inv)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    states, vm, nren = got
    plen16 = nren.long().sum(1)
    off16 = plen16.cumsum(0) - plen16
    total16 = int(plen16.sum())
    flat = tans.compact_rows(vm, off16, total16)
    assert torch.equal(flat, tans.compact_rows_plain(vm, off16, total16))
    f2s, fc = tans.decode_tables(freqs)
    got = tans.ans0_decode(f2s, fc, states, flat, 2 * off16)
    ref = tans.ans0_decode_plain(f2s, fc, states, flat, 2 * off16)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    multi = (freqs > 0).sum(1) > 1
    assert torch.equal(got[0][multi], chunks[multi])


def _card_encode(host, device):
    """(freqs, states, flat, off16) of host [C, CHUNK] coded by kernels A
    and B on the card."""
    chunks = torch.from_numpy(host).to(device)
    freqs = tans.normalize(tans.histogram(chunks))
    packed, inv = tans.encode_tables(freqs)
    states, vm, nren = tans.ans0_encode_scan(chunks, packed, inv)
    plen16 = nren.long().sum(1)
    off16 = plen16.cumsum(0) - plen16
    return freqs, states, tans.compact_rows(vm, off16, int(plen16.sum())), \
        off16


def _decode_case(case, device):
    """(f2s, fc, states, pay, off_bytes, chunks) of one needs_cuda case of
    kernel C; chunks [C, CHUNK] is what the decode must give back for
    the chunks of more than one symbol, None where the payload is cut."""
    rng = np.random.default_rng(13)
    if case.startswith("chunks-"):
        n = int(case.split("-")[1])
        host = rng.integers(0, 256, (n, CHUNK)).astype(np.uint8)
        host[n // 3:] = rng.geometric(0.05, (n - n // 3, CHUNK)).astype(
            np.uint8)
        host[:min(n, 8)] = _chunk_corpus()[:n]
    elif case == "all-random":
        host = rng.integers(0, 256, (64, CHUNK)).astype(np.uint8)
    elif case == "single-symbol":
        host = np.repeat(_chunk_corpus(), 2, axis=0)
        host[1::4] = 0x5A               # one symbol: no payload
        host[2::8] = 0
    else:
        host = _chunk_corpus()
        if case == "end-of-pay":        # the most renorms last
            host = host[[3, 1, 2, 4, 5, 6, 7, 0]]
    freqs, states, flat, off16 = _card_encode(host, device)
    pay, off = flat, 2 * off16
    chunks = host
    if case.startswith("offset-") or case == "misaligned":
        k = 3 if case == "misaligned" else int(case.split("-")[1])
        filler = torch.from_numpy(rng.integers(0, 256, 16 + k).astype(
            np.uint8)).to(device)
        pay = torch.cat([filler, flat])
        if case == "misaligned":        # pay itself starts at 3 mod 16
            pay = pay[3:]
            off = off + 16
        else:
            pay = pay[16:]
            off = off + k
    elif case == "cut":
        pay = flat[:int(off[5]) + 300].clone()
        chunks = None
    f2s, fc = tans.decode_tables(freqs)
    return f2s, fc, states, pay, off, chunks


@pytest.mark.needs_cuda
@pytest.mark.parametrize("case", [f"offset-{k}" for k in range(16)] + [
    "misaligned", "cut", "end-of-pay", "single-symbol", "all-random",
    "chunks-13", "chunks-256", "chunks-4096", "chunks-8192"])
def test_decode_kernel_matches_plain_on_cuda(cuda_device, case):
    """Kernel C against its plain version on the card: payloads behind
    0-15 filler bytes (every start mod 16) and a pay tensor that itself
    starts at 3 mod 16, a payload cut short (0 past it), the last
    chunk's payload ending at pay's end, single-symbol chunks among coded
    ones, random chunks (the most renorms), 13 chunks (a ragged last
    block) and 256, 4096 and 8192 chunks (more than one wave); the coded
    cases give their chunks back."""
    f2s, fc, states, pay, off, chunks = _decode_case(case, cuda_device)
    got = tans.ans0_decode(f2s, fc, states, pay, off)
    ref = tans.ans0_decode_plain(f2s, fc, states, pay, off)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    if chunks is not None:
        multi = ((torch.from_numpy(chunks) != torch.from_numpy(
            chunks[:, :1])).any(1)).to(cuda_device)
        assert torch.equal(got[0][multi],
                           torch.from_numpy(chunks).to(cuda_device)[multi])


@pytest.mark.needs_cuda
@pytest.mark.parametrize("rows", [1, 13, 4096])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 0.5, 1.0])
def test_compact_kernel_matches_plain_on_cuda(cuda_device, rows, density):
    """Kernel B against its plain version on the card: flag densities
    from none to all with junk in the unflagged slots and above the
    flag, at 1, 13 and 4096 rows; total16 whole and cut short (the u16s
    past it dropped)."""
    gen = torch.Generator(device=cuda_device).manual_seed(
        rows * 1000 + int(1000 * density))
    flags = torch.rand((rows, CHUNK), generator=gen,
                       device=cuda_device) < density
    vals = torch.randint(0, 1 << 16, (rows, CHUNK), generator=gen,
                         device=cuda_device)
    junk = torch.randint(0, 1 << 15, (rows, CHUNK), generator=gen,
                         device=cuda_device) << 17
    vm = ((flags.long() << 16) | vals | junk).to(torch.int32)
    counts = flags.long().sum(1)
    off16 = counts.cumsum(0) - counts
    total16 = int(counts.sum())
    for cut in (total16, total16 // 2, max(total16 - 1, 0)):
        got = tans.compact_rows(vm, off16, cut)
        torch.cuda.synchronize()
        assert torch.equal(got, tans.compact_rows_plain(vm, off16, cut))


@pytest.mark.needs_cuda
def test_compact_kernel_takes_order1_rows_on_cuda(cuda_device):
    """Kernel B on the rows of the order-1 chain F2 (ops.ans1), which
    ans1_encode_batch compacts: the same bytes as the plain version."""
    from kanzi_tpu_torch.ops import ans1 as t1
    from kanzi_tpu_torch.utils import native
    rng = np.random.default_rng(4)
    host = np.stack([rng.integers(0, 256, CHUNK).astype(np.uint8),
                     rng.choice(np.arange(6, dtype=np.uint8), CHUNK),
                     np.frombuffer((b"order one " * 2000)[:CHUNK], np.uint8),
                     rng.geometric(0.1, CHUNK).astype(np.uint8)])
    freqs = np.stack([native.ans1_norm(native.ans1_hist(ch)) for ch in host])
    _, vm = t1.ans1_encode_scan(
        torch.from_numpy(host).to(cuda_device),
        t1.encode_table(torch.from_numpy(freqs).to(cuda_device)),
        t1.INV_LUT.to(cuda_device))
    rows = vm.view(-1, CHUNK)
    plen16 = ((rows >> 16) & 1).sum(1)
    off16 = plen16.cumsum(0) - plen16
    got = tans.compact_rows(rows, off16, int(plen16.sum()))
    torch.cuda.synchronize()
    assert torch.equal(got, tans.compact_rows_plain(rows, off16,
                                                    int(plen16.sum())))
