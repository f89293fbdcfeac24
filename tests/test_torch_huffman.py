"""PyTorch port of the Huffman stage (kanzi_tpu_torch.ops.huffman and
kanzi_tpu_torch.entropy.huffman) against the JAX package, bit for bit:
the format is integer-only, so every tolerance here is exact equality.

The JAX side runs as its own tests run it on the CPU:
kanzi_tpu.ops.huffman.encode_chunks_np through huffman_encode_chunks
(use_pallas=False) and huffman_decode_chunks through _huff_decode_xla,
on one bucket of 8 chunks. On the CPU the port's kernel wrappers run
their plain PyTorch versions; the kernels themselves are held against
those versions by the needs_cuda tests at the end, which skip without a
card. The JAX package comes in through the ``jh`` fixture, so that the
needs_cuda tests also run on a machine without JAX (KANZI_TEST_TPU=1
keeps conftest.py from importing it):

    KANZI_TEST_TPU=1 python -m pytest -m needs_cuda tests/test_torch_huffman.py
"""

import contextlib

import numpy as np
import pytest
import torch

import kanzi_tpu.ops as kops
from kanzi_tpu.bitstream import BitWriter as RefBitWriter
from kanzi_tpu.entropy.huffman import HuffmanEncoder as RefHuffmanEncoder
from kanzi_tpu.entropy.huffman import _limit_code_lengths as _ref_limit

import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.bitstream import BitReader, BitWriter
from kanzi_tpu_torch.core.context import Context
from kanzi_tpu_torch.entropy import utils as eu
from kanzi_tpu_torch.entropy.exp_golomb import ExpGolombEncoder
from kanzi_tpu_torch.entropy.huffman import HuffmanDecoder, HuffmanEncoder
from kanzi_tpu_torch.ops import ans as tans
from kanzi_tpu_torch.ops import huffman as th
from kanzi_tpu_torch.utils import native

CPU = torch.device("cpu")
CHUNK = th.CHUNK


@pytest.fixture(scope="module")
def jh():
    """kanzi_tpu.ops.huffman, the JAX reference (on the CPU backend)."""
    from kanzi_tpu.ops import huffman
    return huffman


def _blocks():
    """The input classes of tests/test_ops_huffman.py."""
    rng = np.random.default_rng(5)
    text = (b"huffman fragments on the systolic array " * 3000)
    return {
        "mixed": np.concatenate([
            rng.integers(0, 256, 40000).astype(np.uint8),
            np.frombuffer(text[:30000], dtype=np.uint8),
            rng.choice(np.arange(3, dtype=np.uint8), 20000),
            np.zeros(17000, np.uint8),
        ]),
        "skewed": np.concatenate([
            rng.choice(np.arange(256, dtype=np.uint8), 49152,
                       p=np.arange(1, 257) / np.arange(1, 257).sum()),
            np.frombuffer(text[:20000], dtype=np.uint8),
        ]),
        # near-degenerate freqs push code lengths past 12 (host path)
        "fib": np.repeat(np.arange(16, dtype=np.uint8),
                         np.array([1, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89,
                                   144, 233, 377, 610, 15788])),
    }


def _geometric(seed):
    """A chunk of geometric bytes: a long tail of rare symbols."""
    rng = np.random.default_rng(seed)
    return rng.geometric(rng.uniform(0.3, 0.7), CHUNK).astype(np.uint8)


# _geometric seeds whose codes run past 12 bits (17, 13, 14 and 15 bits);
# the bit-debt repayment limits them
OVER_SEEDS = (2, 3, 6, 8)
# the _geometric seeds whose debt is left after both repayment passes
# (the limit's slow path: renormalised to 2048, lengths rebuilt), found
# by a search of seeds 0-599 on the CPU with the repayment of
# kanzi_tpu.entropy.huffman._limit_code_lengths (90, 263, 348); the
# rebuilt lengths of 90 still run past 12 bits, so it takes 8-bit codes
SLOW_SEEDS = (90, 348)


def _over_length_chunks():
    """The chunks whose Moffat-Katajainen codes run past 12 bits: the
    "fib" chunk, seeded skewed chunks and the slow-path chunk."""
    return {"fib": _blocks()["fib"][:CHUNK],
            **{f"geometric-{s}": _geometric(s) for s in OVER_SEEDS},
            **{f"slow-{s}": _geometric(s) for s in SLOW_SEEDS}}


def _chunk_corpus():
    """8 chunks, one JAX shape bucket: five of "mixed" (random, text,
    a 3-symbol alphabet, zeros), one "skewed" and the "fib" chunk, whose
    codes run past 12 bits, and a single-symbol chunk."""
    b = _blocks()
    return np.stack([b["mixed"][i * CHUNK:(i + 1) * CHUNK] for i in range(5)]
                    + [b["skewed"][:CHUNK], b["fib"][:CHUNK],
                       np.full(CHUNK, 7, np.uint8)])


def _hist(chunks):
    return np.stack([np.bincount(r, minlength=256)
                     for r in chunks]).astype(np.int32)


def _fragments(enc):
    """The byte-aligned fragments of each ok chunk from the nine encode
    outputs (pairs, then the residual bits MSB first), as
    HuffmanDecoder._read_fragments returns them."""
    hdr, hdr_bits, ok, m, flat, npairs, acc, nb, frag_bits = enc
    frags, base = [], 0
    for ci in range(len(ok)):
        row = []
        for f in range(4):
            k = int(npairs[ci, f])
            raw = flat[2 * base:2 * (base + k)].tobytes()
            base += k
            r = int(nb[ci, f]) if ok[ci] else 0
            if r:
                v = (int(acc[ci, f]) & ((1 << r) - 1)) << (16 - r)
                raw += v.to_bytes(2, "big")[:(r + 7) // 8]
            assert 8 * len(raw) - 7 <= frag_bits[ci, f] <= 8 * len(raw)
            row.append(raw)
        frags.append(row)
    return frags


@contextlib.contextmanager
def _host_only():
    """kanzi_tpu's host path (its ops disabled) for the duration."""
    kops.disable()
    try:
        yield
    finally:
        kops.enable()


def _host_coder_bits(chunk):
    """The bits kanzi_tpu's host HuffmanEncoder writes for one chunk
    (header, fragment bit counts, fragments), and its bit count."""
    ref = RefBitWriter()
    with _host_only():
        RefHuffmanEncoder(ref).encode(chunk)
    return ref.getvalue(), ref.written()


def _chunk_bits(enc, ci):
    """Chunk ci's bits from the nine encode outputs: its header, then
    each fragment's pairs and residual bits; and the bit count."""
    hdr, hdr_bits, ok, _, flat, npairs, acc, nb, _ = enc
    assert ok[ci]
    base = int(npairs[:ci].sum())
    w = BitWriter()
    w._append_bit_run(hdr[ci, :(int(hdr_bits[ci]) + 7) >> 3].tobytes(),
                      int(hdr_bits[ci]))
    for f in range(4):
        k = int(npairs[ci, f])
        w.write_bytes(flat[2 * base:2 * (base + k)].tobytes())
        base += k
        if nb[ci, f]:
            w.write_bits(int(acc[ci, f]) & ((1 << int(nb[ci, f])) - 1),
                         int(nb[ci, f]))
    return w.getvalue(), w.written()


def _pair_rows(flat, npairs, rows):
    """The pair bytes of each chunk of rows, from a flat pair stream."""
    off = 2 * (np.cumsum(npairs.sum(1)) - npairs.sum(1))
    return [flat[off[ci]:off[ci] + 2 * int(npairs[ci].sum())].tobytes()
            for ci in rows]


def _kept_and_over(ref_ok, m):
    """The rows kanzi_tpu's device function codes itself or that have
    one symbol (the port's outputs equal its there), and the rows whose
    codes run past 12 bits, which it leaves to its host coder (the
    port limits them on the kernels, so there its bits equal the host
    coder's)."""
    over = ~ref_ok & (m > 1)
    return np.nonzero(~over)[0], np.nonzero(over)[0]


def test_code_tables_match_jax(jh):
    """(codes, sizes, maxlen, m) == kanzi_tpu.ops.huffman's on every
    chunk it codes or that has one symbol, both from compute_code_tables
    and as the first outputs of kernel D's plain version (int32, with ok
    = m > 1). On the "skewed" and "fib" chunks, whose codes run past 12
    bits, the codes and lengths == those kanzi_tpu's host coder limits
    them to, and maxlen is the limited 12."""
    import jax.numpy as jnp
    chunks = _chunk_corpus()
    hist = _hist(chunks)
    ref = [np.asarray(x).astype(np.int64)
           for x in jh.compute_code_tables(jnp.asarray(hist))]
    got = th.compute_code_tables(torch.from_numpy(hist))
    scan = th.huff_encode_scan(torch.from_numpy(chunks),
                               torch.from_numpy(hist).long())
    maxlen, m = ref[2:]
    kept, over = _kept_and_over(maxlen <= th.MAX_SYMBOL_SIZE, m)
    assert list(over) == [5, 6] and (m == 1).any()
    for name, g, d, r in zip(("codes", "sizes", "maxlen", "m"), got, scan,
                             ref):
        assert np.array_equal(g.numpy()[kept], r[kept]), name
        assert d.dtype == torch.int32 and torch.equal(d, g.int()), name
    assert np.array_equal(scan[4].numpy(), m > 1)
    for ci in over:
        enc = RefHuffmanEncoder(RefBitWriter())
        enc._update_frequencies(hist[ci].astype(np.int64))
        assert np.array_equal(got[0][ci].numpy(), enc.codes)
        assert np.array_equal(got[1][ci].numpy(), enc.codes >> 12)
        assert int(got[2][ci]) == th.MAX_SYMBOL_SIZE < maxlen[ci]


def test_encode_matches_jax(jh):
    """All nine outputs == kanzi_tpu.ops.huffman.encode_chunks_np, in
    dtype and value, on every chunk it codes or that has one symbol (the
    row outputs, and each chunk's pairs in flat); the "skewed" and "fib"
    chunks, which it leaves to its host coder, are coded here too, and
    their bits (header, pairs, residual bits) == kanzi_tpu's host
    coder's."""
    chunks = _chunk_corpus()
    tops.reset_counters()
    got = th.encode_chunks_np(chunks, CPU)
    ref = [np.asarray(r) for r in jh.encode_chunks_np(chunks)]
    kept, over = _kept_and_over(ref[2], ref[3])
    assert list(over) == [5, 6]
    names = ("hdr", "hdr_bits", "ok", "m", "flat", "npairs", "acc", "nb",
             "frag_bits")
    for name, g, r in zip(names, got, ref):
        assert g.dtype == r.dtype and g.shape[1:] == r.shape[1:], name
        if name != "flat":
            assert len(g) == len(r) and np.array_equal(g[kept], r[kept]), \
                name
    assert _pair_rows(got[4], got[5], kept) == _pair_rows(ref[4], ref[5],
                                                          kept)
    assert len(got[4]) == 2 * got[5].sum()
    assert np.array_equal(got[2], ref[3] > 1)
    for ci in over:
        assert _chunk_bits(got, ci) == _host_coder_bits(chunks[ci])
    # the pack writes the pair stream itself: no compaction (kernel B)
    assert tops.COUNTERS == {"huff_code_tables_plain": 1,
                             "huff_pack_plain": 1}


def _pairs(scan):
    """The used front of huff_encode_scan's flat pair stream."""
    return scan[5][:2 * int(scan[9].long().sum())]


def test_encode_scan_pairs_match_jax(jh):
    """Kernel D's plain version on the corpus (the "skewed" and "fib"
    chunks whose codes run past 12 bits, a one-symbol chunk): the pairs
    of each chunk
    that kanzi_tpu.ops.huffman.encode_chunks_np codes, and their acc, nb
    and npairs, == its; the offsets are the cumsum of npairs; the rest
    of flat is zero; the over-length chunks' bits (the header from the
    scan's tables, the pairs and residual bits) == kanzi_tpu's host
    coder's."""
    chunks = _chunk_corpus()
    ref = jh.encode_chunks_np(chunks)
    _, _, ok, m, r_flat, r_np, r_acc, r_nb, _ = (np.asarray(x) for x in ref)
    kept, over = _kept_and_over(ok, m)
    assert list(over) == [5, 6] and (m == 1).any()
    scan = th.huff_encode_scan(torch.from_numpy(chunks),
                               th.histogram(torch.from_numpy(chunks)))
    _, sizes, _, s_m, s_ok, flat, off16, acc, nb, npairs = scan
    assert flat.shape == (len(chunks) * 4 * th.FRAG_MAX_BYTES,)
    pairs = _pairs(scan).numpy()
    assert not flat[len(pairs):].any()
    np16 = npairs.numpy().reshape(-1).astype(np.int64)
    assert np.array_equal(off16.numpy().reshape(-1), np.cumsum(np16) - np16)
    assert (_pair_rows(pairs, npairs.numpy(), kept)
            == _pair_rows(r_flat, r_np, kept))
    assert np.array_equal(acc.numpy().view(np.uint32)[kept], r_acc[kept])
    assert np.array_equal(nb.numpy()[kept], r_nb[kept])
    assert np.array_equal(npairs.numpy()[kept], r_np[kept])
    frag_bits = 16 * npairs + nb * s_ok[:, None]
    hdr, hdr_bits = th.pack_huff_headers(sizes, s_m.long(), s_ok, frag_bits)
    enc = (hdr.numpy(), hdr_bits.numpy(), s_ok.numpy(), None, pairs,
           npairs.numpy(), acc.numpy().view(np.uint32), nb.numpy(), None)
    for ci in over:
        assert _chunk_bits(enc, ci) == _host_coder_bits(chunks[ci])


@pytest.mark.parametrize("name", list(_over_length_chunks()))
def test_length_limit_matches_kanzi_tpu(name):
    """limit_code_lengths on a chunk whose code runs past 12 bits ==
    kanzi_tpu.entropy.huffman._limit_code_lengths: the lengths by symbol
    (8 bits each where it returns a maxlen past 12, as its encoder
    does), and the slow path taken on the chunks whose debt is left."""
    chunk = _over_length_chunks()[name]
    h = torch.from_numpy(np.bincount(chunk, minlength=256))[None]
    lens, ranks, m = th.code_lengths_by_rank(h)
    assert int(lens[0, 0]) > th.MAX_SYMBOL_SIZE
    got, sbr, slow = th.limit_code_lengths(lens, ranks, m, h)
    n = int(m[0])
    sizes = np.zeros(256, np.int64)
    sizes[sbr[0, :n].numpy()] = got[0, :n].numpy()

    freqs = h[0].numpy().astype(np.int64)
    alphabet = np.nonzero(freqs)[0]
    ranks = ranks[0, :n].numpy()
    ref_sizes = np.zeros(256, np.int64)
    ref_sizes[ranks] = lens[0, :n].numpy()
    maxlen, ref_sizes = _ref_limit(alphabet, freqs, ref_sizes, ranks, n)
    if maxlen > th.MAX_SYMBOL_SIZE:
        assert name == "slow-90"
        ref_sizes = np.where(freqs > 0, 8, 0)
    assert np.array_equal(sizes, ref_sizes)
    assert bool(slow[0]) == name.startswith("slow")


@pytest.mark.parametrize("name", list(_over_length_chunks()))
def test_over_length_chunk_matches_host_coder(name):
    """A chunk whose code runs past 12 bits is coded by kernel D's plain
    version (ok), and its bits == kanzi_tpu's host coder's."""
    chunk = _over_length_chunks()[name]
    enc = th.encode_chunks_np(chunk[None], CPU)
    assert enc[2][0]
    assert _chunk_bits(enc, 0) == _host_coder_bits(chunk)


def test_none_huffman_codes_every_chunk_on_the_kernels():
    """-t NONE -e HUFFMAN over the over-length chunks and the corpus, on
    the CPU: one batched encode codes every full chunk, none goes to the
    host coder (huff_host_chunks), and the bytes == kanzi_tpu's."""
    import kanzi_tpu
    import kanzi_tpu_torch
    data = np.concatenate([*_over_length_chunks().values(),
                           *_chunk_corpus()]).tobytes() + b"tail" * 99
    tops.reset_counters()
    ours = kanzi_tpu_torch.compress_bytes(data, "NONE", "HUFFMAN",
                                          block_size=64 * 1024, device="cpu")
    assert tops.COUNTERS.get("huff_code_tables_plain") == 1
    assert "huff_host_chunks" not in tops.COUNTERS
    assert ours == kanzi_tpu.compress_bytes(data, "NONE", "HUFFMAN",
                                            block_size=64 * 1024)
    assert kanzi_tpu_torch.decompress_bytes(ours, device="cpu") == data


def test_decode_matches_jax_and_roundtrips(jh):
    """The plain decode of the flat fragment stream == kanzi_tpu's
    decode of the same fragments in its padded rows, and == the input."""
    import jax.numpy as jnp
    chunks = _chunk_corpus()
    enc = th.encode_chunks_np(chunks, CPU)
    # the JAX package's code tables, handed to the port as tensors; for
    # the chunks whose codes it leaves unlimited (maxlen > 12), the
    # port's limited ones, which are the host coder's
    ref_tables = jh.compute_code_tables(jnp.asarray(_hist(chunks)))
    codes, sizes = tans.from_numpy(ref_tables[:2], CPU)
    over = np.asarray(ref_tables[2]) > th.MAX_SYMBOL_SIZE
    port = th.compute_code_tables(torch.from_numpy(_hist(chunks)))
    codes[over] = port[0][over].to(codes.dtype)
    sizes[over] = port[1][over].to(sizes.dtype)
    sel = np.nonzero(enc[2])[0]
    frags = _fragments(enc)
    nbytes = np.array([[len(frags[ci][f]) for f in range(4)] for ci in sel])
    rows = np.zeros((len(sel), 4, 2 * jh._FRAG_WPAD), np.uint8)
    for i, ci in enumerate(sel):
        for f in range(4):
            rows[i, f, :nbytes[i, f]] = np.frombuffer(frags[ci][f], np.uint8)
    codes = (codes.numpy() & 0xFFF)[sel]
    sizes = sizes.numpy()[sel]
    ref = jh.huffman_decode_chunks(codes.astype(np.uint32),
                                   sizes.astype(np.int32), rows)
    pay, bounds = th.flat_fragments(rows, nbytes)
    tops.reset_counters()
    got = th.huffman_decode_chunks(codes, sizes, pay, bounds, CPU)
    assert tops.COUNTERS == {"huff_decode_plain": 1}
    assert np.array_equal(got, ref)
    assert np.array_equal(got, chunks[sel])


def _decode_parts(tbl, parts, bounds_end=None):
    """huff_decode of one fragment list as a flat payload; the last
    bound is bounds_end where given (past the payload's end)."""
    n = np.array([len(p) for p in parts])
    pay = torch.from_numpy(np.frombuffer(b"".join(parts), np.uint8).copy())
    bounds = np.concatenate([[0], np.cumsum(n)])
    if bounds_end is not None:
        bounds[-1] = bounds_end
    return th.huff_decode(tbl, pay, torch.from_numpy(bounds))


@pytest.mark.parametrize("cut", [0, 1, 2, 3, "empty"])
def test_decode_reads_zero_past_the_fragment(cut):
    """A fragment cut short decodes as if zero-padded (the kernel reads
    0 past a fragment's end, never the next fragment's bytes), and the
    other fragments come out intact. Fragment 3 is cut at the payload's
    end with its bound left where it was, so its bytes run past the
    payload; an empty fragment (of fragment 1) reads as zeros."""
    chunks = _chunk_corpus()[:1]
    enc = th.encode_chunks_np(chunks, CPU)
    codes, sizes, _, _ = th.compute_code_tables(
        torch.from_numpy(_hist(chunks)))
    tbl = th.decode_table(codes & 0xFFF, sizes)
    frags = _fragments(enc)[0]
    f, keep = (1, 0) if cut == "empty" else (cut, 100)
    cut_parts = frags[:f] + [frags[f][:keep]] + frags[f + 1:]
    zero = frags[:f] + [frags[f][:keep] + bytes(len(frags[f]) - keep)] \
        + frags[f + 1:]
    past = sum(len(p) for p in frags) if f == 3 else None
    got = _decode_parts(tbl, cut_parts, past)
    assert torch.equal(got, _decode_parts(tbl, zero))
    ref = torch.from_numpy(chunks)
    frag = th.FRAG
    for k in range(4):
        same = torch.equal(got[:, k * frag:(k + 1) * frag],
                           ref[:, k * frag:(k + 1) * frag])
        assert same == (k != f)


@pytest.fixture
def _ref_host_path():
    kops.disable()
    yield
    kops.enable()


@pytest.mark.parametrize("name", ["mixed", "skewed", "fib"])
def test_coder_matches_kanzi_tpu(name, _ref_host_path):
    """HuffmanEncoder/HuffmanDecoder of the port == kanzi_tpu's host
    coder (kanzi_tpu.ops disabled), with the port's full chunks on the
    plain versions of kernels D, B and E."""
    block = _blocks()[name]
    ref = RefBitWriter()
    RefHuffmanEncoder(ref).encode(block)
    ctx = Context({"device": "cpu"})
    tops.reset_counters()
    w = BitWriter()
    assert HuffmanEncoder(w, ctx).encode(block) == len(block)
    assert w.getvalue() == ref.getvalue()
    dec = HuffmanDecoder(BitReader(w.getvalue()), ctx).decode(len(block))
    assert np.array_equal(dec, block)
    assert tops.COUNTERS["huff_code_tables_plain"] == 1
    assert tops.COUNTERS["huff_pack_plain"] == 1
    assert tops.COUNTERS["huff_decode_plain"] == 1


@pytest.mark.parametrize("name", ["mixed", "skewed", "fib"])
def test_native_parse_matches_python_parse(name):
    """The native parse of a block's full chunks (csrc/huff_parse.cpp)
    lists the same chunks, codes, lengths and byte-aligned fragments as
    the Python parse (_read_lengths, _read_fragments), fills the chunks
    of one symbol, and ends at the same bit."""
    block = _blocks()[name]
    block = np.concatenate([block, np.full(CHUNK, 9, np.uint8)])
    w = BitWriter()
    HuffmanEncoder(w, Context({"device": "cpu"})).encode(block)
    full = len(block) // CHUNK
    got_out = np.zeros(full * CHUNK, np.uint8)
    r = BitReader(w.getvalue())
    pos, parsed, idx, codes, sizes, pay, bounds = native.huff_parse_block(
        r._data, r._nbits, 0, full, got_out)
    assert parsed == full
    dec = HuffmanDecoder(BitReader(w.getvalue()), Context({"device": "cpu"}))
    ref_idx, ref_frags = [], []
    for c in range(full):
        alphabet, sz, cd = dec._read_lengths()
        if len(alphabet) == 1:
            assert (got_out[c * CHUNK:(c + 1) * CHUNK] == alphabet[0]).all()
            continue
        k = len(ref_idx)
        assert np.array_equal(sizes[k], sz) and np.array_equal(codes[k], cd)
        ref_idx.append(c)
        raw, nbytes = dec._read_fragments()
        ref_frags.append(raw)
        assert list(np.diff(bounds[4 * k:4 * k + 5])) == nbytes
    assert list(idx) == ref_idx and len(idx) >= 1
    assert pay.tobytes() == b"".join(ref_frags)
    assert pos == dec.ibs._pos


@pytest.mark.parametrize("parser", ["python", "native"])
def test_fragment_size_limit(parser):
    """A fragment longer than 4096 codes of 12 bits is refused before any
    decode, by either parse."""
    w = BitWriter()
    if parser == "native":
        eu.encode_alphabet(w, np.array([1, 2]))
        ExpGolombEncoder(w, signed=True).encode_byte(0xFF)   # lengths 1, 1
        ExpGolombEncoder(w, signed=True).encode_byte(0)
    for nbits in (8 * th.FRAG_MAX_BYTES + 1, 8, 8, 8):
        eu.write_varint(w, nbits)
    w.write_bytes(bytes(7000))
    r = BitReader(w.getvalue())
    with pytest.raises(ValueError, match="fragment size"):
        if parser == "native":
            native.huff_parse_block(r._data, r._nbits, 0, 1,
                                    np.zeros(CHUNK, np.uint8))
        else:
            HuffmanDecoder(r, Context({"device": "cpu"}))._read_fragments()


def test_wrappers_check_their_inputs():
    chunks = torch.zeros((2, CHUNK), dtype=torch.uint8)
    hist = torch.zeros((2, 256), dtype=torch.int64)
    with pytest.raises(ValueError, match="hist"):
        th.huff_encode_scan(chunks, hist.int())
    with pytest.raises(ValueError, match="hist"):
        th.huff_encode_scan(chunks, hist[:1])
    with pytest.raises(ValueError, match="chunks"):
        th.huff_encode_scan(chunks.int(), hist)
    with pytest.raises(ValueError, match="bounds"):
        th.huff_decode(torch.zeros((2, th.TABLE), dtype=torch.int16),
                       torch.zeros(4, dtype=torch.uint8),
                       torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError, match="no kernel"):
        th.huff_encode_scan(chunks.to("meta"), hist.to("meta"))
    # E's kernel reads pay 16 bytes at a time from an aligned base
    tbl = torch.zeros((2, th.TABLE), dtype=torch.int16, device="meta")
    bounds = torch.zeros(9, dtype=torch.int64, device="meta")
    pay = torch.zeros(64, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="pay: must be 16-byte aligned"):
        th.huff_decode(tbl, pay[3:], bounds)
    with pytest.raises(ValueError, match="no kernel"):
        th.huff_decode(tbl, pay[16:], bounds)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("n_chunks", [8, 64, 256])
def test_kernels_match_plain_on_cuda(cuda_device, n_chunks):
    """Kernels D (the code-table prologue and the pack: pair stream,
    offsets, acc, nb, npairs) and E against their plain versions on the
    card: the corpus above, the chunks past 12 bits (the slow path's
    too, from 64 chunks) and random and skewed chunks; every chunk of
    more than one symbol is ok."""
    rng = np.random.default_rng(n_chunks)
    host = rng.integers(0, 256, (n_chunks, CHUNK)).astype(np.uint8)
    host[n_chunks // 2:] = rng.geometric(0.05, (n_chunks - n_chunks // 2,
                                               CHUNK)).astype(np.uint8)
    special = np.concatenate([_chunk_corpus(),
                              np.stack(list(_over_length_chunks().values()))])
    host[:len(special)] = special[:n_chunks]
    chunks = torch.from_numpy(host).to(cuda_device)
    hist = th.histogram(chunks)
    got = th.huff_encode_scan(chunks, hist)
    tables = th.huff_code_tables_plain(chunks, hist)
    codes, _, _, _, ok, bits = tables
    off16 = th.pair_offsets(ok, bits)
    flat, acc, nb, npairs = th.huff_pack_plain(chunks, codes, ok, off16)
    ref = (*tables[:5], flat, off16, acc, nb, npairs)
    # flat: the pair stream; past it the kernel's buffer is unspecified
    for g, r in zip(got[:5] + got[6:], ref[:5] + ref[6:]):
        assert torch.equal(g, r)
    assert torch.equal(_pairs(got), _pairs(ref))
    assert torch.equal(got[4], got[3] > 1)
    codes, sizes = ref[:2]
    enc = th.encode_chunks_np(host, cuda_device)
    sel = np.nonzero(enc[2])[0]
    frags = _fragments(enc)
    parts = [frags[ci][f] for ci in sel for f in range(4)]
    pay = torch.from_numpy(np.frombuffer(b"".join(parts), np.uint8).copy())
    bounds = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
    tbl = th.decode_table(codes[sel] & 0xFFF, sizes[sel])
    args = (tbl, pay.to(cuda_device), torch.from_numpy(bounds).to(
        cuda_device))
    got = th.huff_decode(*args)
    ref = th.huff_decode_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(got.cpu(), torch.from_numpy(host[sel]))


def _table(sizes):
    """decode_table of one chunk's canonical code from its lengths by
    symbol ([256], 0: absent), as [1, 4096] int16."""
    sizes = np.asarray(sizes, np.int64)
    codes, first = np.zeros(256, np.int64), 0
    for ln in range(1, th.MAX_SYMBOL_SIZE + 1):
        for sym in np.nonzero(sizes == ln)[0]:
            codes[sym] = first
            first += 1
        first <<= 1
    return th.decode_table(torch.from_numpy(codes)[None],
                           torch.from_numpy(sizes)[None])


def _encoded(host, device):
    """(tbl, fragments, chunks) of the chunks of more than one symbol of
    host [C, CHUNK], coded on device."""
    enc = th.encode_chunks_np(host, device)
    sel = np.nonzero(enc[2])[0]
    codes, sizes = th.compute_code_tables(
        torch.from_numpy(_hist(host[sel])).to(device))[:2]
    frags = _fragments(enc)
    return (th.decode_table(codes & 0xFFF, sizes),
            [frags[ci][f] for ci in sel for f in range(4)], host[sel])


def _decode_case(case, device):
    """(tbl, pay, bounds, chunks) of one needs_cuda case of kernel E;
    chunks are the input the decode gives back, None where the payload
    is not a coded one."""
    rng = np.random.default_rng(11)
    if case.startswith("chunks-"):
        n = int(case.split("-")[1])
        host = rng.integers(0, 256, (n, CHUNK)).astype(np.uint8)
        host[n // 3:] = rng.geometric(0.05, (n - n // 3, CHUNK)).astype(
            np.uint8)
        special = np.concatenate(
            [_chunk_corpus(), np.stack(list(_over_length_chunks().values()))])
        host[:min(n, len(special))] = special[:n]
        tbl, parts, chunks = _encoded(host, device)
        bounds = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
        pay = np.frombuffer(b"".join(parts), np.uint8)
    elif case in ("all-12-bit", "one-bit"):
        # every entry of the table 12 bits long (256 codes of 12 bits,
        # the rest of the table the last one's) or 1 bit long: random
        # fragments of 6144 and 512 bytes, 4 chunks
        sizes = np.full(256, 12) if case == "all-12-bit" else \
            np.array([1, 1] + [0] * 254)
        tbl = _table(sizes).repeat(4, 1)
        nb = 6144 if case == "all-12-bit" else 512
        pay = rng.integers(0, 256, 16 * nb).astype(np.uint8)
        bounds = np.arange(17) * nb
        chunks = None
    else:
        tbl, parts, chunks = _encoded(_chunk_corpus(), device)
        parts = list(parts)
        if case == "cut":
            parts[5] = parts[5][:300]
            chunks = None
        elif case == "empty":
            parts[6] = b""
            chunks = None
        bounds = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
        pay = np.frombuffer(b"".join(parts), np.uint8)
        if case == "end-of-pay":
            bounds[-1] += 100      # past the payload: reads 0 there
        elif case.startswith("offset-"):
            k = int(case.split("-")[1])
            pay = np.concatenate([rng.integers(0, 256, k).astype(np.uint8),
                                  pay])
            bounds = bounds + k
    return (tbl.to(device), torch.from_numpy(pay.copy()).to(device),
            torch.from_numpy(np.asarray(bounds, np.int64)).to(device),
            chunks)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("case", [f"offset-{k}" for k in range(16)] + [
    "cut", "empty", "end-of-pay", "all-12-bit", "one-bit", "chunks-8",
    "chunks-256", "chunks-4000"])
def test_decode_kernel_matches_plain_on_cuda(cuda_device, case):
    """Kernel E against its plain version on the card: fragments that
    start at every byte offset mod 16 (the payload behind 0-15 filler
    bytes), a fragment cut short, an empty one, the last fragment ending
    at the payload's end with its bound past it, codes all 12 bits long
    (fragments of 6144 bytes) and all 1 bit long, and coded chunks in
    batches of 8, 256 and 4000 (more than one wave of blocks); the coded
    cases give their chunks back."""
    tbl, pay, bounds, chunks = _decode_case(case, cuda_device)
    got = th.huff_decode(tbl, pay, bounds)
    ref = th.huff_decode_plain(tbl, pay, bounds)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if chunks is not None:
        assert torch.equal(got.cpu(), torch.from_numpy(chunks))
