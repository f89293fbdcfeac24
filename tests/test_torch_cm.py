"""PyTorch port of the CM lockstep coder (kanzi_tpu_torch.ops.cm: kernels
I, the encode, and J, the decode) against the JAX package and the host
coder, bit for bit: the format is integer-only, so every tolerance here
is exact equality.

The plain versions are held against kanzi_tpu.ops.cm_jnp's
cm_encode_batch and cm_decode_batch (XLA on the CPU), against the port's
host BinaryEntropyEncoder / BinaryEntropyDecoder with CMPredictor at
bsVersion 6 and 7, and their end state against the host predictor's.
The level-7 decode's sink is held against kanzi_tpu's host parse of the
same container. On the CPU the kernel wrappers run their plain versions;
the kernels themselves are held against those by the needs_cuda tests at
the end, which skip without a card. JAX comes in through the ``jcm``
fixture, so those tests also run on a machine without JAX:

    KANZI_TEST_TPU=1 python -m pytest -m needs_cuda tests/test_torch_cm.py

The plain versions cost about 0.3 ms a bit step here (a Python loop of
~40 small torch ops), so the streams are up to 1 KiB.
"""

import numpy as np
import pytest
import torch

import kanzi_tpu_torch
import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.bitstream import BitReader, BitWriter
from kanzi_tpu_torch.core.context import Context
from kanzi_tpu_torch.entropy import utils as eu
from kanzi_tpu_torch.entropy.binary import (BinaryEntropyDecoder,
                                            BinaryEntropyEncoder)
from kanzi_tpu_torch.entropy.cm import CMPredictor
from kanzi_tpu_torch.ops import cm as tcm
from kanzi_tpu_torch.parallel import pipeline as tpp

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jcm():
    """kanzi_tpu.ops.cm_jnp, the JAX reference (XLA on the CPU)."""
    from kanzi_tpu.ops import cm_jnp
    return cm_jnp


def _streams():
    """4 ragged streams of up to 1 KiB, [4, 1024] uint8 zero past their
    lengths: text-like, random, a skewed alphabet with runs, 40 bytes of
    one symbol."""
    rng = np.random.default_rng(17)
    lens = np.array([1024, 777, 600, 40])
    rows = [rng.integers(97, 123, 1024),
            rng.integers(0, 256, 1024),
            np.repeat(np.minimum(rng.geometric(0.3, 256), 255), 4),
            np.full(1024, 0xA5)]
    streams = np.zeros((4, 1024), np.uint8)
    for j, (row, n) in enumerate(zip(rows, lens)):
        streams[j, :n] = row[:n]
    return streams, lens


def _records(bufs, low56):
    """The encoder's outputs as the decoder reads them: the payload, then
    the 56-bit low, the first 7 bytes priming current."""
    out = []
    for buf, low in zip(bufs, low56):
        tail = buf + low.to_bytes(7, "big")
        out.append((int.from_bytes(tail[:7], "big"), tail[7:]))
    return out


def _padded(records):
    """kanzi_tpu's cm_decode_batch rows of the records, as its level-7
    mesh decode builds them: [b, W] u32 words, the last partial word
    zero-padded on the right, and [b] u64 currents."""
    w = max(2, max((len(x) + 3) // 4 for _, x in records) + 1)
    pay = np.zeros((len(records), w), np.uint32)
    for j, (_, x) in enumerate(records):
        rest = x + bytes(8)
        n = min(len(rest) // 4, w)
        pay[j, :n] = np.frombuffer(rest[:4 * n], ">u4")
    return pay, np.array([c for c, _ in records], np.uint64)


@pytest.fixture(scope="module")
def encoded(jcm):
    """The streams through the plain encode and through kanzi_tpu's."""
    streams, lens = _streams()
    tops.reset_counters()
    ours = tcm.cm_encode_batch(streams, lens, 6, CPU)
    assert tops.COUNTERS == {"cm_encode_plain": 1}
    return streams, lens, ours, jcm.cm_encode_batch(streams, lens, 6)


@pytest.mark.timeout(300)
def test_encode_matches_jax(encoded):
    """cm_encode_batch (the plain version) == kanzi_tpu's: every stream's
    words, its final low and no overflow."""
    _, _, ours, theirs = encoded
    assert ours[0] == theirs[0]
    assert ours[1] == [int(x) for x in theirs[1]]
    assert ours[2] == theirs[2] == [False] * 4


@pytest.mark.timeout(300)
def test_decode_matches_jax(jcm, encoded):
    """cm_decode_batch (the plain version) == kanzi_tpu's on the same
    padded rows, and both return the input; cm_decode_records on the
    records does too, with each stream's consumed words its payload's."""
    streams, lens, (bufs, low56, _), _ = encoded
    records = _records(bufs, low56)
    pay, cur = _padded(records)
    theirs = jcm.cm_decode_batch(pay, cur, lens, 6)
    ours = tcm.cm_decode_batch(pay, cur, lens, 6, CPU)
    assert np.array_equal(ours, theirs)
    for j, n in enumerate(lens):
        assert np.array_equal(ours[j, :n], streams[j, :n])
    flat = [torch.from_numpy(a) for a in tcm.flat_records(records)]
    out, consumed, _ = tcm.cm_decode(*flat, torch.from_numpy(lens),
                                     tcm.cm_init_state(4, 6))
    assert np.array_equal(out.numpy(), ours)
    assert consumed.tolist() == [-(-len(x) // 4) for _, x in records]


def _host_encode(data, bs_version):
    """The host coder's bytes for one block and its predictor after it."""
    ctx = Context({"bsVersion": bs_version})
    w = BitWriter()
    enc = BinaryEntropyEncoder(w, ctx, CMPredictor(ctx))
    enc.encode(data)
    enc.dispose()
    return w.getvalue(), enc


@pytest.mark.timeout(300)
@pytest.mark.parametrize("bs_version", [6, 7])
def test_matches_host_coder(bs_version):
    """At bsVersion 6 and 7: cm_encode_batch framed as the host frames a
    block (varint size, payload, 56-bit low) == the host encoder's bytes;
    the host decoder reads the stream back, and cm_decode_records decodes
    the host's bytes to the input; the plain encode's end state equals
    the host's (low, high, both counter tables, the context registers)."""
    streams, lens = _streams()
    bufs, low56, _ = tcm.cm_encode_batch(streams, lens, bs_version, CPU)
    _, cnt, end = tcm.cm_encode(torch.from_numpy(streams),
                                torch.from_numpy(lens), 1024 + 64,
                                tcm.cm_init_state(4, bs_version))
    records = []
    for j, n in enumerate(lens):
        host, enc = _host_encode(streams[j, :n], bs_version)
        w = BitWriter()
        eu.write_varint(w, len(bufs[j]))
        w.write_bytes(bufs[j])
        w.write_bits(low56[j], 56)
        assert w.getvalue() == host
        assert int(cnt[j]) * 4 == len(bufs[j])
        pred = enc.predictor
        assert int(end.low[j]) == enc._low
        assert int(end.high[j]) == enc._high
        assert end.counter1[j].tolist() == sum(pred._counter1, [])
        assert end.counter2[j].tolist() == sum(pred._counter2, [])
        assert (int(end.c1[j]), int(end.c2[j]), int(end.run_mask[j])) == (
            pred._c1, pred._c2, pred._run_mask)
        ctx = Context({"bsVersion": bs_version})
        back = BinaryEntropyDecoder(BitReader(host), ctx,
                                    CMPredictor(ctx)).decode(int(n))
        assert np.array_equal(back, streams[j, :n])
        r = BitReader(host)
        eu.read_varint(r)
        cur = r.read_bits(56)
        records.append((cur, r.read_bytes(len(bufs[j]))))
    out = tcm.cm_decode_records(records, lens, bs_version, CPU)
    for j, n in enumerate(lens):
        assert np.array_equal(out[j, :n], streams[j, :n])


@pytest.mark.timeout(120)
@pytest.mark.parametrize("bs_version", [6, 7])
def test_state_from_limbs(jcm, bs_version):
    """kanzi_tpu's start state (_init_cm_state: 28-bit limbs, u32
    tables) carried across by cm_state_from_limbs == cm_init_state; the
    host predictor's tables at its start are the same."""
    got = tcm.cm_state_from_limbs(
        *(np.asarray(x) for x in jcm._init_cm_state(3, bs_version)))
    want = tcm.cm_init_state(3, bs_version)
    for name, g, w in zip(tcm.CMState._fields, got, want):
        assert torch.equal(g, w), name
    pred = CMPredictor(Context({"bsVersion": bs_version}))
    assert want.counter1[0].tolist() == sum(pred._counter1, [])
    assert want.counter2[0].tolist() == sum(pred._counter2, [])
    assert int(want.counter2[0, 16]) == (65536 if bs_version < 7 else 65535)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kind", ["ones", "zeros", "alternating"])
def test_counter_bounds(kind):
    """The kernels hold counter1 as u16 and counter2 as u32: on 768 bytes
    of 0xFF, of 0x00 and of 0x00 and 0xFF in turns, counter1 stays in [0,
    65520] (all ones drive it to 65520) and counter2's entry 16 stays at
    65536 under bit 1 before bsVersion 7; each stream decodes back."""
    n = 768
    row = {"ones": np.full(n, 0xFF), "zeros": np.zeros(n),
           "alternating": np.tile([0x00, 0xFF], n // 2)}[kind]
    streams = row.astype(np.uint8)[None]
    lens = np.array([n])
    _, _, end = tcm.cm_encode(torch.from_numpy(streams),
                              torch.from_numpy(lens), n + 64,
                              tcm.cm_init_state(1, 6))
    c1, c2 = end.counter1, end.counter2
    assert 0 <= int(c1.min()) and int(c1.max()) <= tcm.C1_MAX
    assert 0 <= int(c2.min()) and int(c2.max()) == tcm.PSCALE
    if kind == "ones":
        assert int(c1.max()) == tcm.C1_MAX
        assert int((c2.view(512, 17)[:, 16] == tcm.PSCALE).sum()) == 512
    bufs, low56, _ = tcm.cm_encode_batch(streams, lens, 6, CPU)
    out = tcm.cm_decode_records(_records(bufs, low56), lens, 6, CPU)
    assert np.array_equal(out, streams)


@pytest.mark.timeout(300)
def test_sink_matches_host_parse():
    """The level-7 decode's sink: the records the CM shell queues for a
    container (its blocks' 56-bit currents and payloads, their lengths,
    bsVersion 6) == kanzi_tpu's host parse of the same blocks
    (_parse_cm_block), and the flush decodes them to the input."""
    from kanzi_tpu.io.compressed_stream import CompressedReader as RefReader
    from kanzi_tpu.parallel.pipeline import _parse_cm_block
    rng = np.random.default_rng(3)
    data = (b"a rose is a rose is a rose " * 300)[:6000] + \
        rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    tops.disable()
    try:
        blob = kanzi_tpu_torch.compress_bytes(data, tpp.CHAIN_L7, "CM",
                                              block_size=4096)
    finally:
        tops.enable()
    seen = []

    def flush(entries):
        seen.extend((len(out), cur, pay, v) for out, cur, pay, v in entries)
        tpp._flush_cm(entries, (CPU,))

    r = tpp.CompressedReader(blob, device=CPU,
                             decode_sinks={"_cmDecodeSink": flush},
                             sink_window=tpp.MAX_BLOCK_ID)
    assert r.read_all() == data
    ref = RefReader(blob)
    parsed = []
    while True:
        bits = ref.ibs.read_bits(3 + ref.ibs.read_bits(5))
        if bits == 0:
            break
        parsed.append(_parse_cm_block(ref.ibs.read_payload(bits), bits,
                                      ref.block_size))
    assert len(seen) == len(parsed) == 3
    for (n, cur, pay, v), (pre_len, _, prime, buf) in zip(seen, parsed):
        assert (n, cur, pay, v) == (pre_len, prime, buf, 6)


@pytest.mark.timeout(60)
def test_wrappers_check_their_inputs():
    streams = torch.zeros((2, 64), dtype=torch.uint8)
    lens = torch.tensor([64, 3])
    st = tcm.cm_init_state(2, 6)
    words, cnt, _ = tcm.cm_encode(streams, lens, 80, st)
    assert words.shape == (2, 80) and cnt.shape == (2,)
    with pytest.raises(ValueError, match="cap"):
        tcm.cm_encode(streams, lens, -1, st)
    with pytest.raises(ValueError, match="lens"):
        tcm.cm_encode(streams, lens.int(), 80, st)
    with pytest.raises(ValueError, match="lens"):
        tcm.cm_encode(streams, lens + 1, 80, st)
    with pytest.raises(ValueError, match="counter2"):
        tcm.cm_encode(streams, lens, 80, st._replace(
            counter2=st.counter2.long()))
    with pytest.raises(ValueError, match="state"):
        tcm.cm_encode(streams, lens, 80, st[:6])
    with pytest.raises(ValueError, match="no kernel"):
        tcm.cm_encode(streams.to("meta"), lens.to("meta"), 80,
                      tcm.CMState(*(t.to("meta") for t in st)))
    pay = torch.zeros(4, dtype=torch.int32)
    i64 = torch.zeros(2, dtype=torch.int64)
    out, consumed, _ = tcm.cm_decode(pay, i64, i64 + 2, i64, lens, st)
    assert out.shape == (2, 64) and consumed.shape == (2,)
    with pytest.raises(ValueError, match="pay"):
        tcm.cm_decode(pay.long(), i64, i64 + 2, i64, lens, st)
    with pytest.raises(ValueError, match="nw"):
        tcm.cm_decode(pay, i64, i64[:1], i64, lens, st)
    with pytest.raises(ValueError, match="outside"):
        tcm.cm_decode(pay, i64 + 3, i64 + 2, i64, lens, st)
    with pytest.raises(ValueError, match="outside"):
        tcm.cm_decode(pay, i64, i64 + 2, i64, lens - 4, st)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _run_streams():
    """3 streams of up to 1 KiB: 600 bytes of one symbol then two symbols
    in turns, 8 runs of 128 bytes, random bytes."""
    rng = np.random.default_rng(9)
    streams = np.zeros((3, 1024), np.uint8)
    streams[0, :600] = 0x41
    streams[0, 600:] = np.tile(np.array([0x41, 0xC2], np.uint8), 212)
    streams[1] = np.repeat(rng.integers(0, 256, 8), 128)
    streams[2] = rng.integers(0, 256, 1024)
    return streams, np.array([1024, 1024, 1000])


# kernel I's window of bytes (kWin in kanzi_tpu_torch/csrc/cm.cu)
ENCODE_WINDOW = 128


def _edge_streams(rng):
    """6 streams of 0, 1, W - 1, W, W + 1 and 2W + 3 bytes, W kernel I's
    window: random bytes, then a 10-symbol alphabet."""
    w = ENCODE_WINDOW
    lens = np.array([0, 1, w - 1, w, w + 1, 2 * w + 3])
    streams = rng.integers(0, 256, (6, 2 * w + 3)).astype(np.uint8)
    streams[3:] = rng.integers(60, 70, (3, 2 * w + 3))
    return streams, lens


def _kernel_case(name):
    """(streams [b, L] u8, lens [b], start state) of one case of the
    needs_cuda tests."""
    if name == "ragged":
        streams, lens = _streams()
        return streams, lens, tcm.cm_init_state(4, 6)
    rng = np.random.default_rng(8)
    if name == "runs":
        # b1 == b2 for hundreds of bytes (run mask 0x100), then two
        # symbols in turns; runs of 128; random
        streams, lens = _run_streams()
        return streams, lens, tcm.cm_init_state(3, 6)
    if name == "flushes":
        # random bytes from counter1 at its ends, 0 or 65520 at random:
        # confident predictions, half of them wrong, so a flush every ~27
        # bit steps (~32 for random bytes from the block's start)
        streams = rng.integers(0, 256, (4, 1024)).astype(np.uint8)
        st = tcm.cm_init_state(4, 6)
        return streams, np.array([1024, 1024, 513, 96]), st._replace(
            counter1=torch.from_numpy((rng.integers(
                0, 2, st.counter1.shape) * tcm.C1_MAX).astype(np.int32)))
    if name == "window_edges":
        # streams of 0, 1, W - 1, W, W + 1 and 2W + 3 bytes around kernel
        # I's window of W bytes, at bsVersion 7
        return (*_edge_streams(rng), tcm.cm_init_state(6, 7))
    if name == "many":
        # 20 streams of up to 1 KiB, one empty and one of a byte
        lens = rng.integers(0, 1025, 20)
        lens[:2] = [0, 1]
        streams = rng.integers(0, 256, (20, 1024)).astype(np.uint8)
        streams[10:] = rng.integers(40, 48, (10, 1024))
        return streams, lens, tcm.cm_init_state(20, 7)
    # the ragged streams from a state that is not the start's: counters
    # anywhere in their ranges, context registers, low and high mid-block
    streams, lens = _streams()
    st = tcm.cm_init_state(4, 6)
    low = rng.integers(0, 1 << 40, 4)
    return streams, lens, st._replace(
        low=torch.from_numpy(low),
        high=torch.from_numpy(low + rng.integers(1 << 41, 1 << 50, 4)),
        counter1=torch.from_numpy(rng.integers(
            0, tcm.C1_MAX + 1, st.counter1.shape).astype(np.int32)),
        counter2=torch.from_numpy(rng.integers(
            0, tcm.PSCALE + 1, st.counter2.shape).astype(np.int32)),
        c1=torch.tensor([3, 7, 7, 255], dtype=torch.int32),
        c2=torch.tensor([9, 7, 0, 255], dtype=torch.int32),
        run_mask=torch.tensor([0, 256, 0, 256], dtype=torch.int32))


@pytest.mark.timeout(300)
@pytest.mark.needs_cuda
@pytest.mark.parametrize("case", ["ragged", "many", "from_state", "runs",
                                  "flushes", "window_edges"])
def test_kernels_match_plain_on_cuda(cuda_device, case):
    """Kernels I and J on the card against their plain versions on the
    host's CPU (the same function): I's words, counts and end state; J,
    on I's output framed as the decoder reads it, its bytes (the input),
    consumed words and end state."""
    streams, lens, state = _kernel_case(case)
    s, n = torch.from_numpy(streams), torch.from_numpy(lens.astype(np.int64))
    cap = streams.shape[1] + 64
    dev_state = tcm.CMState(*(t.to(cuda_device) for t in state))
    ref = tcm.cm_encode(s, n, cap, state)
    got = tcm.cm_encode(s.to(cuda_device), n.to(cuda_device), cap, dev_state)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu(), ref[1])
    for name, g, r in zip(tcm.CMState._fields, got[2], ref[2]):
        assert torch.equal(g.cpu(), r), name
    words, cnt = ref[0].numpy().view(np.uint32), ref[1].numpy()
    low56 = [int(x) | tcm.MASK_0_24 for x in ref[2].low]
    records = _records([words[j, :cnt[j]].astype(">u4").tobytes()
                        for j in range(len(lens))], low56)
    flat = [torch.from_numpy(a) for a in tcm.flat_records(records)]
    ref = tcm.cm_decode(*flat, n, state)
    got = tcm.cm_decode(*(t.to(cuda_device) for t in flat),
                        n.to(cuda_device), dev_state)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu(), ref[1])
    for name, g, r in zip(tcm.CMState._fields, got[2], ref[2]):
        assert torch.equal(g.cpu(), r), name
    if case != "from_state":
        for j, m in enumerate(lens):
            assert np.array_equal(ref[0][j, :m].numpy(), streams[j, :m])


def _upd(v, bit, rate):
    """A counter's update (CMPredictor::update), Python's shift arithmetic."""
    return v - ((v - (65520 if bit else 0)) >> rate)


def _model_decode(pay, off, nw, cur, n, st, j):
    """Stream j of cm_decode in kernel J's order of table reads, plain
    Python: a step reads both children's counter1 entries before its own
    stores, and after the byte's seventh bit the next byte's root row for
    both values of the last bit (row 1 was written at the byte's first
    step); the chosen child's or root's entries stand in where the plain
    version reads counter1 afresh. Counter2 is read at the step, as the
    plain version reads it. Returns (bytes, words consumed, low, high,
    counter1, counter2, c1, c2, run mask)."""
    c1t = st.counter1[j].tolist()
    c2t = st.counter2[j].tolist()
    low, high = int(st.low[j]), int(st.high[j])
    b1, b2, rm = int(st.c1[j]), int(st.c2[j]), int(st.run_mask[j])
    words = [int(x) & tcm.MASK_0_32
             for x in pay[int(off[j]):int(off[j]) + int(nw[j])]]
    cur, widx = int(cur[j]), 0

    def row(ctx, b1, b2):
        r = ctx * 257
        t256, tc1, tc2 = c1t[r + 256], c1t[r + b1], c1t[r + b2]
        return (13 * (t256 + tc1) + 6 * tc2) >> 5, t256, tc1

    out = []
    nd = row(1, b1, b2)
    for _ in range(n):
        ctx = 1
        for k in range(8):
            kids = ((row(2 * ctx, b1, b2), row(2 * ctx + 1, b1, b2))
                    if k < 7 else roots)
            p, t256, tc1 = nd
            i2 = (ctx | rm) * 17 + (p >> 12)
            s0, s1 = c2t[i2], c2t[i2 + 1]
            p12 = (p + p + 3 * (s0 + s1) + 64) >> 7
            mid = low + ((((high - low) >> 4) * p12) >> 8)
            bit = int(mid >= cur)
            high, low = (mid, low) if bit else (high, mid + 1)
            c1t[ctx * 257 + 256] = _upd(t256, bit, 2)
            c1t[ctx * 257 + b1] = _upd(tc1, bit, 4)
            c2t[i2], c2t[i2 + 1] = _upd(s0, bit, 6), _upd(s1, bit, 6)
            nd = kids[bit]
            ctx = 2 * ctx + bit
            if k == 6:
                v0 = (2 * ctx) & 0xFF
                roots = row(1, v0, b1), row(1, v0 | 1, b1)
            if ((low ^ high) >> 24) == 0:
                low = (low & tcm.MASK_0_24) << 32
                high = ((high & tcm.MASK_0_24) << 32) | tcm.MASK_0_32
                nxt = words[widx] if widx < len(words) else 0
                cur = ((cur & tcm.MASK_0_24) << 32) | nxt
                widx += 1
        out.append(ctx & 0xFF)
        b2, b1 = b1, ctx & 0xFF
        rm = 0x100 if b1 == b2 else 0
    return out, widx, low, high, c1t, c2t, b1, b2, rm


@pytest.mark.timeout(300)
@pytest.mark.parametrize("case", ["from_state", "runs"])
def test_read_order_model_matches_plain(case):
    """Kernel J's argument that a step may read both children's counter1
    entries before its own stores, and the next byte's root row after the
    byte's seventh bit: a model that reads the tables in that order (and
    uses the values it read where cm_decode_plain reads afresh) decodes
    byte for byte as the plain version, with the same words consumed and
    end state, from random counters and run masks 0x100 and on long runs
    then two symbols in turns."""
    streams, lens, state = _kernel_case(case)
    n = torch.from_numpy(lens.astype(np.int64))
    words, cnt, end = tcm.cm_encode_plain(torch.from_numpy(streams), n,
                                          streams.shape[1] + 64, state)
    w = words.numpy().view(np.uint32)
    records = _records([w[j, :cnt[j]].astype(">u4").tobytes()
                        for j in range(len(lens))],
                       [int(x) | tcm.MASK_0_24 for x in end.low])
    pay, off, nw, cur = tcm.flat_records(records)
    ref, consumed, ref_end = tcm.cm_decode_plain(
        *(torch.from_numpy(a) for a in (pay, off, nw, cur)), n, state)
    for j, m in enumerate(lens):
        got = _model_decode(pay, off, nw, cur, int(m), state, j)
        assert got[0] == ref[j, :m].tolist(), j
        assert got[1] == int(consumed[j]), j
        assert got[2:] == (int(ref_end.low[j]), int(ref_end.high[j]),
                           ref_end.counter1[j].tolist(),
                           ref_end.counter2[j].tolist(),
                           int(ref_end.c1[j]), int(ref_end.c2[j]),
                           int(ref_end.run_mask[j])), j
        if case != "from_state":
            assert got[0] == streams[j, :m].tolist(), j


def _model_encode(streams, lens, cap, st, j):
    """Stream j of cm_encode as kernel I splits it, plain Python: first
    the predictor alone over the stream's bytes, every bit step's p12
    with no coder state (the tables and context registers updated as it
    goes); then the coder over those p12s a window of
    ENCODE_WINDOW bytes at a time, in the kernel's words: low and
    high shifted left by 8 as 32-bit words, the split r1 * (p12 << 20
    mod 2^32) + ((r1 & M) << 32) + (r0 >> 12) * p12 + add (M all ones
    where p12 = 4096, add 256 for a 0 bit) for the range r = (high - low)
    << 8, the new bound masked to the byte grid, a window's flush words
    staged and then copied to the row from the window's first index,
    those past cap dropped. Returns (row [cap], flushes, low, high,
    counter1, counter2, c1, c2, run mask)."""
    m32, m64 = tcm.MASK_0_32, (1 << 64) - 1
    c1t = st.counter1[j].tolist()
    c2t = st.counter2[j].tolist()
    b1, b2, rm = int(st.c1[j]), int(st.c2[j]), int(st.run_mask[j])
    n = int(lens[j])
    ops = []
    for val in streams[j, :n].tolist():
        for k in range(8):
            ctx, bit = (val | 256) >> (8 - k), (val >> (7 - k)) & 1
            r = ctx * 257
            t256, tc1, tc2 = c1t[r + 256], c1t[r + b1], c1t[r + b2]
            p = (13 * (t256 + tc1) + 6 * tc2) >> 5
            i2 = (ctx | rm) * 17 + (p >> 12)
            s0, s1 = c2t[i2], c2t[i2 + 1]
            c1t[r + 256], c1t[r + b1] = _upd(t256, bit, 2), _upd(tc1, bit, 4)
            c2t[i2], c2t[i2 + 1] = _upd(s0, bit, 6), _upd(s1, bit, 6)
            ops.append(((p + p + 3 * (s0 + s1) + 64) >> 7, bit))
        b2, b1 = b1, val
        rm = 0x100 if b1 == b2 else 0
    lo, hi = int(st.low[j]) << 8, int(st.high[j]) << 8
    l0, l1, h0, h1 = lo & m32, lo >> 32, hi & m32, hi >> 32
    row, cnt, w = [0] * cap, 0, ENCODE_WINDOW
    for start in range(0, 8 * n, 8 * w):
        stage = []
        for p12, bit in ops[start:start + 8 * w]:
            pw, add = (p12 << 20) & m32, 0 if bit else 256
            r = (((h1 << 32) | h0) - ((l1 << 32) | l0)) & m64
            r0, r1 = r & m32, r >> 32
            t = r1 * pw + (((r1 & (m32 if p12 >> 12 else 0)) << 32)
                           | ((r0 >> 12) * p12 + add))
            nb = (((l1 << 32) | l0) + t) & m64
            n0, n1 = nb & 0xFFFFFF00, nb >> 32
            flush = n1 == (l1 if bit else h1)
            if bit:
                h0, h1 = n0, n1
            else:
                l0, l1 = n0, n1
            if flush:
                stage.append(n1)
                l0, l1, h0, h1 = 0, l0, 0xFFFFFF00, h0 | 0xFF
        for i, word in enumerate(stage):
            if cnt + i < cap:
                row[cnt + i] = word
        cnt += len(stage)
    return (row, cnt, (l1 << 24) | (l0 >> 8), (h1 << 24) | (h0 >> 8), c1t,
            c2t, b1, b2, rm)


def _window_case(case):
    """(streams, lens, cap, start state) of one window-model case."""
    rng = np.random.default_rng(21)
    if case.startswith("len"):
        # one length around the window at one bsVersion: a random stream
        # and one of a 10-symbol alphabet
        n, bs_version = (int(x) for x in case[3:].split("_bs"))
        streams, _ = _edge_streams(rng)
        return (np.ascontiguousarray(streams[[0, 5], :max(n, 1)]),
                np.array([n, n]), max(n, 1) + 64,
                tcm.cm_init_state(2, bs_version))
    if case == "cap":
        # a flush every ~27 bit steps, the rows capped at 40 words
        streams, lens, st = _kernel_case("flushes")
        return streams, lens, 40, st
    if case == "p12_4096":
        # counter1 at 65520 and counter2's entries 15 and 16 at 65536:
        # every step's p12 is 4096, whose P wraps to 0
        st = tcm.cm_init_state(2, 6)
        c2 = st.counter2.view(2, 512, 17).clone()
        c2[:, :, 15:] = tcm.PSCALE
        return (np.full((2, 300), 0xFF, np.uint8), np.array([300, 7]), 364,
                st._replace(counter1=torch.full_like(st.counter1,
                                                     tcm.C1_MAX),
                            counter2=c2.view(2, -1).contiguous()))
    streams, lens, st = _kernel_case(case)
    return streams, lens, streams.shape[1] + 64, st


_W = ENCODE_WINDOW


@pytest.mark.timeout(300)
@pytest.mark.parametrize("case", [
    f"len{n}_bs{v}" for v in (6, 7)
    for n in (0, 1, _W - 1, _W, _W + 1, 2 * _W + 3)] + [
    "from_state", "runs", "cap", "p12_4096"])
def test_encode_window_model_matches_plain(case):
    """Kernel I's argument that the predictor needs no coder state, so a
    producer may run it a window ahead: a model that runs the predictor
    alone over a stream and then codes its p12s a window at a time, in
    the kernel's 32-bit words and staged flushes (_model_encode), gives
    cm_encode_plain's words, flush count and end state, at lengths
    around the window at bsVersion 6 and 7, from random counters and
    bounds, on runs (run mask 0x100), with a cap below the flush count
    and where p12 is 4096."""
    streams, lens, cap, state = _window_case(case)
    words, cnt, end = tcm.cm_encode_plain(
        torch.from_numpy(streams), torch.from_numpy(lens.astype(np.int64)),
        cap, state)
    w = words.numpy().view(np.uint32)
    for j in range(len(lens)):
        got = _model_encode(streams, lens, cap, state, j)
        assert got[0] == w[j].tolist(), j
        assert got[1] == int(cnt[j]), j
        assert got[2:] == (int(end.low[j]), int(end.high[j]),
                           end.counter1[j].tolist(),
                           end.counter2[j].tolist(), int(end.c1[j]),
                           int(end.c2[j]), int(end.run_mask[j])), j
    if case == "cap":
        assert int(cnt.min()) < cap < int(cnt.max())
