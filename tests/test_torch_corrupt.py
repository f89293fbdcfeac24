"""Corrupt streams through the port's decode kernels: C (the ANS0 sink),
E (the Huffman decode), sbrt_inv (the level-5 mesh decode), H and J
(the level-6 and level-7 mesh decodes).

kanzi_tpu_torch.testing.corrupt builds the corrupt streams
(corrupt_cases), as chip_smoke.py's phase 9d does: payload bytes flipped
past the headers, ANS0 chunks and Huffman fragments cut short inside the
sinks that feed C and E, FPAQ and CM payloads written 1-3 bytes short,
level-5 streams whose ZRLT bytes no input makes, and
tests/test_torch_malformed.py's streams. On the CPU the kernels' plain
versions decode them: each outcome is a typed failure or bytes, and where
the stream is a real one it equals the host path's (ops disabled). The
needs_cuda test takes every stream through the kernels on the card:

    KANZI_TEST_TPU=1 python -m pytest -m needs_cuda tests/test_torch_corrupt.py

The outcome on the card must equal the one on the CPU (device cpu, the
plain versions) or the host path's, with no CUDA error, and a good
stream must decode on the card after each.
"""

import time

import numpy as np
import pytest
import torch

import kanzi_tpu_torch as ktt
import kanzi_tpu_torch.ops as tops
from kanzi_tpu.io.compressed_stream import CompressedReader as RefReader
from kanzi_tpu_torch.ops import bwt as tbwt
from kanzi_tpu_torch.parallel import pipeline as tpp
from kanzi_tpu_torch.testing import corrupt

CPU = torch.device("cpu")


def _data(n_text: int, n_rand: int, seed: int = 1) -> bytes:
    rng = np.random.default_rng(seed)
    return ((b"corrupt streams through the decode kernels " * 4000)[:n_text]
            + rng.integers(0, 256, n_rand, dtype=np.uint8).tobytes())


def _host(blob):
    return corrupt.corrupt_outcome("container", blob, None, None)


def test_read_all_copies_the_blocks_after_a_short_one():
    """A level-7 container whose CM payloads end 2 bytes early: its
    blocks decode to other than the block size. The reader returns the
    blocks joined, the same on every call (before, read_all left them at
    their fixed offsets and returned bytes there that no block wrote),
    as kanzi_tpu's reader yields them one by one."""
    data = _data(5000, 3000, seed=7)
    blob = corrupt.cut_stream(data, tpp.CHAIN_L7, tpp.ENTROPY_L7,
                            2048, 2)
    tops.disable()
    try:
        outs = [ktt.decompress_bytes(blob) for _ in range(3)]
        joined = b"".join(ktt.CompressedReader(blob).read_blocks())
    finally:
        tops.enable()
    assert outs[0] == outs[1] == outs[2] == joined
    assert len(joined) != len(data)
    assert joined == b"".join(RefReader(blob).read_blocks())


def _bwt_rows(rng, bad_rows: int = 20):
    """A block, and [1 + bad_rows, n] rows of BWT bytes with the block's
    primary indexes [1 + bad_rows, 8]: row 0 the block's BWT, the others
    it with 8 bytes flipped (their links mostly not one cycle)."""
    block = np.frombuffer(_data(3000, 1096), np.uint8)
    bwt, idx = tbwt.bwt_forward(block, 8, CPU)
    src = torch.from_numpy(np.ascontiguousarray(bwt))[None].repeat(
        1 + bad_rows, 1)
    for r in range(1, 1 + bad_rows):
        src[r, rng.integers(0, src.shape[1], 8)] ^= 0x5A
    starts = torch.tensor(np.asarray(idx, np.int64))[None].repeat(
        1 + bad_rows, 1)
    return block, src, starts


def test_bwt_inverse_rejects_links_off_one_cycle():
    """_bwt_inverse_core (the level-5 mesh decode's BWT inverse): a
    block's BWT inverts to the block; a row whose links make several
    cycles, or whose primary indexes are off the walk, has ok False and
    no index leaves it, where the host's walk would repeat a cycle; the
    good row beside them inverts all the same. ops.bwt.bwt_inverse raises
    ValueError on such a block."""
    block, src, starts = _bwt_rows(np.random.default_rng(3))
    back, ok = tbwt._bwt_inverse_core(src, starts[:, 0], starts)
    assert bool(ok[0]) and np.array_equal(back[0].numpy(), block)
    assert not bool(ok[1:].all())
    _, ok = tbwt._bwt_inverse_core(src[:1], starts[:1, 0],
                                   starts[:1].roll(1, 1))
    assert not bool(ok[0])
    _, ok_first = tbwt._bwt_inverse_core(src, starts[:, 0])
    r = int(torch.nonzero(~ok_first)[0, 0])
    with pytest.raises(ValueError, match="cycle"):
        tbwt.bwt_inverse(src[r].numpy(), int(starts[r, 0]), CPU)
    assert np.array_equal(
        tbwt.bwt_inverse(src[0].numpy(), int(starts[0, 0]), CPU), block)


def _oversubscribed():
    """Code lengths that pass the Huffman parse (1-12 bits) but fit no
    prefix code, with their canonical codes: codes past their lengths
    (prefixes past the table) and, once the codes wrap at 12 bits, two
    symbols on one prefix (three 1-bit codes, then a 12-bit one on the
    second's prefix)."""
    from kanzi_tpu_torch.entropy.huffman import generate_canonical_codes
    rng = np.random.default_rng(11)
    cases = []
    for lengths in ({0: 1, 1: 1, 2: 1, 3: 12, 4: 12},
                    {s: 4 for s in range(40)},
                    {s: int(rng.integers(1, 13)) for s in range(0, 256, 3)}):
        sizes = np.zeros(256, np.int64)
        for sym, ln in lengths.items():
            sizes[sym] = ln
        alphabet = sorted(lengths)
        codes = generate_canonical_codes(sizes, alphabet, len(alphabet))
        cases.append((codes, sizes))
    return cases


def _table_model(codes, sizes):
    """decode_table's rule, one entry at a time."""
    vt = np.zeros(4097, np.int64)
    for sym in range(256):
        ln = int(sizes[sym])
        if ln:
            st = (int(codes[sym]) & 0xFFF) << (12 - ln)
            if st < 4096:
                vt[st] = max(vt[st], (st << 16) | (ln << 8) | sym)
    return (np.maximum.accumulate(vt[:4096]) & 0xFFFF).astype(np.int16)


def test_huffman_table_of_corrupt_lengths():
    """decode_table on code lengths that fit no prefix code (a corrupt
    chunk's, which the parse lets through): prefixes past the table are
    dropped and a shared prefix goes to the longest code, then the
    highest symbol; before, a prefix past the table was an index error
    (on a card: an illegal address) and a shared one went to whichever
    write a card made last. E's plain version decodes on the table."""
    from kanzi_tpu_torch.ops import huffman as thuff
    cases = _oversubscribed()
    codes = torch.tensor(np.stack([c for c, _ in cases]))
    sizes = torch.tensor(np.stack([s for _, s in cases]))
    tbl = thuff.decode_table(codes, sizes)
    for i, (c, s) in enumerate(cases):
        assert np.array_equal(tbl[i].numpy(), _table_model(c, s)), i
    assert int(tbl[0, 2048]) == 3 | 12 << 8          # the shared prefix
    pay = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, 3 * 4 * 64, dtype=np.uint8))
    bounds = torch.arange(0, pay.numel() + 1, 64, dtype=torch.int64)
    tops.reset_counters()
    out = thuff.huff_decode(tbl, pay, bounds)
    assert out.shape == (3, thuff.CHUNK)
    assert tops.COUNTERS == {"huff_decode_plain": 1}


@pytest.mark.parametrize("pos", [1, 40, 3000])
def test_l5_mesh_corrupt_transform_bytes_take_the_host_path(pos):
    """A level-5 container whose ANS0 stage is intact but whose ZRLT
    bytes no input makes: decompress_l5_mesh on the CPU (RANK's inverse
    through the SBRT kernel's plain version) gives the host path's
    outcome. Before, the BWT inverse scattered to a negative index (on a
    card: an illegal address). Only the rows that the BWT inverse cannot
    place take the host path, counted apart from the device's blocks."""
    data = _data(5000, 4000)
    blob = corrupt.l5_bad_stream(data, 4096, (CPU,), pos)
    tops.reset_counters()
    got = corrupt.corrupt_outcome("l5", blob, None, CPU)
    counts = dict(tops.COUNTERS)
    assert counts.get("sbrt_plain", 0) >= 1
    assert got == _host(blob)
    assert got[0] == "err" or got[1] != data
    if got[0] == "ok":
        assert counts["l5_decode_host_fallback_blocks"] >= 1, counts
    if "l5_decode_device_blocks" in counts:           # past ZRLT's checks
        tops.reset_counters()
        assert tpp.decompress_l5_mesh(tpp.compress_l5_mesh(
            data, 4096, (CPU,)), (CPU,)) == data
        assert counts["l5_decode_device_blocks"] + counts.get(
            "l5_decode_host_fallback_blocks", 0) == \
            tops.COUNTERS["l5_decode_device_blocks"], counts


def _peak_rss_bytes() -> int:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


# (text bytes, random bytes): the last block short (the host chain's on
# both sides), or the last of two random blocks full (the device
# chain's on encode, the host's on decode: its size is not known before)
ZERO_RUN_DATA = {"tail short": (5000, 4000), "last block full": (0, 8192)}


@pytest.mark.parametrize("shape", sorted(ZERO_RUN_DATA))
@pytest.mark.parametrize("digits", [31, 34])
def test_l5_mesh_zero_run_past_2_31_raises(digits, shape):
    """A level-5 container whose ZRLT rows hold a run of 31 or 34 zero
    digits (2^31 or more zeros): decompress_l5_mesh raises ValueError at
    once, from the device ZRLT inverse's bound on its device rows and
    from the host ZRLT inverse's output limit on the last block, which
    takes the host path; no row falls back, no GiBs are allocated. The
    host path (ops disabled) raises ValueError too."""
    data = _data(*ZERO_RUN_DATA[shape])
    blob = corrupt.l5_long_run_stream(data, 4096, (CPU,), 40, digits)
    rss, t0 = _peak_rss_bytes(), time.perf_counter()
    tops.reset_counters()
    with pytest.raises(ValueError, match="2\\^31|past"):
        tpp.decompress_l5_mesh(blob, (CPU,))
    assert "l5_decode_host_fallback_blocks" not in tops.COUNTERS
    assert _host(blob) == ("err", "ValueError")
    assert time.perf_counter() - t0 < 30
    assert _peak_rss_bytes() - rss < 1 << 30


def test_host_zrlt_inverse_bounds_its_output():
    """The host ZRLT inverse (native and pure Python) in a block decode
    (a context with the block size) raises ValueError where a run would
    take the output past 4 times the block size and 1 MiB, before it
    writes the run; a valid block with a long zero run still inverts;
    without a block context there is no bound, as before."""
    from kanzi_tpu_torch.core.context import Context
    from kanzi_tpu_torch.transform.zrlt import ZRLT
    from kanzi_tpu_torch.utils import native
    ctx = Context()
    ctx.put("blockSize", 4096)
    bad = np.array([5] * 3 + [1] * 34 + [7], np.uint8)
    block = np.zeros(1 << 20, np.uint8)
    block[[5, 70000]] = 3
    assert ZRLT(ctx).output_limit(len(bad)) == 4 * 4096 + (1 << 20)
    assert ZRLT(Context()).output_limit(len(bad)) is None
    for with_native in (True, False):
        real = native.transforms_available
        if not with_native:
            native.transforms_available = lambda: False
        try:
            with pytest.raises(ValueError, match="past 1064960 bytes"):
                ZRLT(ctx).inverse(bad)
            fwd = ZRLT(ctx).forward(block)
            assert len(fwd) < 64
            assert np.array_equal(ZRLT(ctx).inverse(fwd), block)
        finally:
            native.transforms_available = real
    with pytest.raises(ValueError, match="past 100 bytes"):
        native.zrlt_inverse(bad, 100)


def _raising_rank(inverse_msg):
    real = tpp.sbrt

    def sbrt(data, lens, mode, inverse):
        if inverse:
            raise ValueError(inverse_msg)
        return real(data, lens, mode, inverse)
    return sbrt


def test_l5_mesh_wrapper_error_raises():
    """A ValueError from a wrapper on the level-5 mesh decode's device
    path (here sbrt_inv's, on a valid stream) propagates: no block takes
    the host path in its place."""
    data = _data(5000, 4000)
    blob = tpp.compress_l5_mesh(data, 4096, (CPU,))
    assert tpp.decompress_l5_mesh(blob, (CPU,)) == data
    tops.reset_counters()
    with corrupt.patched(tpp, "sbrt", _raising_rank("sbrt: bad lens")):
        with pytest.raises(ValueError, match="bad lens"):
            tpp.decompress_l5_mesh(blob, (CPU,))
    assert "l5_decode_host_fallback_blocks" not in tops.COUNTERS


def _container_cases(entropy):
    data = _data(40000, 60000)
    cases, good = corrupt.corrupt_cases(data, 32768, (CPU,),
                                        malformed=False, paths=(entropy,))
    return cases, good


@pytest.mark.parametrize("entropy,kernel", [("ANS0", "ans0_decode"),
                                            ("HUFFMAN", "huff_decode")])
def test_container_corrupt_payloads_plain(entropy, kernel):
    """The container's decode kernel's plain version (device cpu) on
    payload bytes flipped past the headers and on chunks or fragments cut
    short in its sink: each outcome a typed failure or bytes other than
    the input, the plain version launched; a flipped payload (a real
    stream) gets the host path's error class or bytes."""
    cases, good = _container_cases(entropy)
    assert len(cases) >= 8
    for name, path, blob, patch, base in cases:
        tops.reset_counters()
        got = corrupt.corrupt_outcome(path, blob, patch, CPU)
        assert tops.COUNTERS.get(f"{kernel}_plain", 0) >= 1, name
        if got[0] == "err":
            assert got[1] in corrupt.CORRUPT_FAILS, (name, got)
        else:
            assert got[1] != good[entropy][1], name
        if patch is None and got[0] == "err":
            assert _host(blob)[0] == "err", name


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.needs_cuda
def test_corrupt_streams_on_card(cuda_device):
    """Every corrupt stream of corrupt.corrupt_cases (192 KiB of text
    and random bytes at 64 KiB blocks, and test_torch_malformed.py's)
    through C, E, sbrt_inv, H and J on the card: the outcome of its base
    path (device cpu or the host path), no CUDA error, a good stream
    decoded after each, every one of those kernels launched."""
    data = _data(96 << 10, 96 << 10)
    cases, good = corrupt.corrupt_cases(data, 64 << 10, (cuda_device,))
    launches, _ = corrupt.check_corrupt(cases, good, cuda_device)
    for kernel in corrupt.CORRUPT_KERNELS:
        assert launches.get(kernel, 0) >= 1, kernel


@pytest.mark.needs_cuda
def test_bwt_inverse_rejects_links_off_one_cycle_on_card(cuda_device):
    """The repaired BWT inverse on the card, on the CPU test's rows: the
    block back from its BWT; ok and the good rows' bytes equal to the
    CPU's where the links are not one cycle or the primary indexes are
    off the walk, and the context stays usable."""
    block, src, starts = _bwt_rows(np.random.default_rng(3))
    for st in (starts, starts.roll(1, 1)):
        want, want_ok = tbwt._bwt_inverse_core(src, st[:, 0], st)
        got, ok = tbwt._bwt_inverse_core(src.to(cuda_device),
                                         st[:, 0].to(cuda_device),
                                         st.to(cuda_device))
        assert torch.equal(ok.cpu(), want_ok)
        assert torch.equal(got.cpu()[want_ok], want[want_ok])
    back, ok = tbwt._bwt_inverse_core(src.to(cuda_device),
                                      starts[:, 0].to(cuda_device))
    assert bool(ok[0]) and np.array_equal(back[0].cpu().numpy(), block)
    torch.cuda.synchronize(cuda_device)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("shape", sorted(ZERO_RUN_DATA))
@pytest.mark.parametrize("digits", [31, 34])
def test_l5_mesh_zero_run_past_2_31_raises_on_card(cuda_device, digits,
                                                   shape):
    """The CPU test's long zero runs through decompress_l5_mesh on the
    card: the same ValueError, no fallback, no GiBs, and a good stream
    decodes on the card after it; a wrapper's ValueError on that good
    stream raises."""
    data = _data(*ZERO_RUN_DATA[shape])
    blob = corrupt.l5_long_run_stream(data, 4096, (CPU,), 40, digits)
    rss, t0 = _peak_rss_bytes(), time.perf_counter()
    tops.reset_counters()
    with pytest.raises(ValueError, match="2\\^31|past"):
        tpp.decompress_l5_mesh(blob, (cuda_device,))
    assert time.perf_counter() - t0 < 30
    assert _peak_rss_bytes() - rss < 1 << 30
    assert "l5_decode_host_fallback_blocks" not in tops.COUNTERS
    good = tpp.compress_l5_mesh(data, 4096, (cuda_device,))
    assert tpp.decompress_l5_mesh(good, (cuda_device,)) == data
    with corrupt.patched(tpp, "sbrt", _raising_rank("sbrt: bad lens")):
        with pytest.raises(ValueError, match="bad lens"):
            tpp.decompress_l5_mesh(good, (cuda_device,))


@pytest.mark.needs_cuda
def test_huffman_table_of_corrupt_lengths_on_card(cuda_device):
    """The CPU test's corrupt code lengths on the card: decode_table equal
    to the CPU's, and E equal to its plain version on that table, the
    fragments' bits running out early."""
    from kanzi_tpu_torch.ops import huffman as thuff
    cases = _oversubscribed()
    codes = torch.tensor(np.stack([c for c, _ in cases]))
    sizes = torch.tensor(np.stack([s for _, s in cases]))
    tbl = thuff.decode_table(codes, sizes)
    tbl_card = thuff.decode_table(codes.to(cuda_device), sizes.to(cuda_device))
    assert torch.equal(tbl_card.cpu(), tbl)
    pay = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, 3 * 4 * 64, dtype=np.uint8))
    bounds = torch.arange(0, pay.numel() + 1, 64, dtype=torch.int64)
    want = thuff.huff_decode(tbl, pay, bounds)
    got = thuff.huff_decode(tbl_card, pay.to(cuda_device),
                            bounds.to(cuda_device))
    assert torch.equal(got.cpu(), want)
