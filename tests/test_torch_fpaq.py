"""PyTorch port of the FPAQ encode (kanzi_tpu_torch.ops.fpaq and the
container's prepare_fpaq_batch) and of the lockstep FPAQ decode (kernel
H) against the JAX package, bit for bit: the format is integer-only, so
every tolerance here is exact equality. The decode is held against
kanzi_tpu's numpy model decode_streams_np chunk by chunk (from its state,
through fpaq_state_from_limbs), against decode_batch_jnp (JAX on the CPU)
once, and against the host decoder where a payload runs out.

The JAX package's kernel runs only on a TPU; on the CPU its
fpaq_encode_batch takes the numpy lockstep model _encode_batch_np, the
reference of every output here. On the CPU the port's kernel wrapper
runs its plain PyTorch version; the kernel itself is held against that
version by the needs_cuda test at the end, which skips without a card.
JAX comes in through the ``jf`` fixture, so that test also runs on a
machine without JAX:

    KANZI_TEST_TPU=1 python -m pytest -m needs_cuda tests/test_torch_fpaq.py

The plain versions cost about a millisecond per byte here (8 bit steps
of ~30 small ops), so the streams are a few KiB.
"""

import numpy as np
import pytest
import torch

import kanzi_tpu
import kanzi_tpu.io.compressed_stream as ref_cs
import kanzi_tpu.ops as kops

import kanzi_tpu_torch
import kanzi_tpu_torch.entropy.fpaq as fq
import kanzi_tpu_torch.io.compressed_stream as cs
import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.bitstream import BitWriter
from kanzi_tpu_torch.core.context import Context
from kanzi_tpu_torch.ops import fpaq as tf

CH = 2048                        # a small FPAQ chunk: 4 windows of 512


@pytest.fixture(scope="module")
def jf():
    """kanzi_tpu.ops.fpaq, the JAX reference (numpy model on the CPU)."""
    from kanzi_tpu.ops import fpaq
    return fpaq


@pytest.fixture
def fpaq_device(monkeypatch):
    """The container's FPAQ batch on the CPU at any stream count (its gate
    sends it to a CUDA card only), and kanzi_tpu's opt-in batch."""
    monkeypatch.setattr(cs, "_fpaq_on_device", lambda dev, lens: True)
    monkeypatch.setenv("KANZI_TPU_FPAQ", "1")
    tops.enable()
    kops.enable()
    tops.reset_counters()
    yield
    tops.enable()
    kops.enable()


def _streams(seed, lens):
    """Text-like, random and skewed rows, zero past each length."""
    rng = np.random.default_rng(seed)
    out = np.zeros((len(lens), max(lens)), np.uint8)
    for i, n in enumerate(lens):
        kind = i % 3
        if kind == 0:
            row = rng.integers(97, 123, n)
        elif kind == 1:
            row = rng.integers(0, 256, n)
        else:
            row = np.minimum(rng.geometric(0.1, n), 255)
        out[i, :n] = row
    return out


def _bank_data(n):
    """A block of n bytes whose every FPAQ chunk boundary byte is >= 64,
    so a bank carried across a boundary would show (the regression of
    tests/test_fpaq_device_path.py)."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, n, dtype=np.uint8)
    data[: n // 2] = rng.integers(97, 123, n // 2, dtype=np.uint8)
    for k in range(1, -(-n // CH)):
        data[k * CH - 1] = 200
    return data


def _assert_batch_equal(got, ref):
    """The port's (bufs, low56, win_words, win_low) == kanzi_tpu's
    outputs of the same names (its overflow list, ref[2], has none)."""
    assert not any(ref[2])
    names = ("bufs", "low56", "win_words", "win_low")
    for name, g, r in zip(names, got, (ref[0], ref[1], ref[3], ref[4])):
        if isinstance(r, np.ndarray):
            assert g.shape == r.shape and g.dtype == r.dtype, name
            assert np.array_equal(g, r), name
        else:
            assert g == r, name


def test_encode_batch_matches_jax_model(jf):
    """Every output == kanzi_tpu.ops.fpaq._encode_batch_np's, at three
    streams of 2-4.5 KiB with 2 KiB FPAQ chunks (the bank reset
    crossed)."""
    lens = np.array([2048, 3000, 4608])
    streams = _streams(3, lens)
    tops.reset_counters()
    got = tf.fpaq_encode_batch(streams, lens, CH, "cpu")
    assert tops.COUNTERS == {"fpaq_encode_plain": 1}
    _assert_batch_equal(got, jf._encode_batch_np(streams, lens,
                                                 chunk_bytes=CH))


@pytest.mark.parametrize("n", [0, 1, 15, 16, 511, 512, 513, "reset"])
def test_plain_matches_jax_model(jf, n):
    """fpaq_encode_plain == kanzi_tpu.ops.fpaq._encode_batch_np on a
    text-like and a random stream of n bytes, at the window's edges; and
    ("reset") at 1536 bytes with 1 KiB chunks, a bank reset on the
    window boundary at 1024 whose byte before is >= 64."""
    chunk = CH
    if n == "reset":
        n, chunk = 3 * tf.WIN_B, 2 * tf.WIN_B
    lens = np.array([n, n])
    rows = _streams(9, [max(n, 1)] * 2)[:, :n]
    if n > chunk:
        rows[:, chunk - 1] = 200
    lp = -(-max(n, 1) // tf.WIN_B) * tf.WIN_B
    streams = np.zeros((2, lp), np.uint8)
    streams[:, :n] = rows
    cap = lp // tf.WIN_B * tf.REGION_W
    words, win_cnt, win_low = tf.fpaq_encode_plain(
        torch.from_numpy(streams), torch.from_numpy(lens), chunk // tf.WIN_B,
        cap)
    bufs, low56, _, win_words, ref_low = jf._encode_batch_np(
        rows, lens, chunk_bytes=chunk)
    assert np.array_equal(win_cnt.numpy(), win_words)
    assert np.array_equal(win_low.numpy(), ref_low.astype(np.int64))
    assert [int(x) for x in win_low[:, -1]] == low56
    for i in range(2):
        got = words[i, :int(win_cnt[i].sum())].numpy().view(np.uint32)
        assert got.astype(">u4").tobytes() == bufs[i]


def test_fpaq_batch_byte_identical(fpaq_device):
    """Three 4 KiB blocks of mixed content in one plain launch: the
    container == the port's host path and kanzi_tpu's device batch
    (its numpy model here), and it decodes."""
    rng = np.random.default_rng(42)
    data = (b"abab" * 1024 + rng.integers(0, 256, 4096, dtype=np.uint8)
            .tobytes() + bytes(3000))
    blob = kanzi_tpu_torch.compress_bytes(data, "NONE", "FPAQ",
                                          block_size=4096, device="cpu")
    assert tops.COUNTERS == {"fpaq_encode_plain": 1}, tops.COUNTERS
    kops.reset_counters()
    assert blob == kanzi_tpu.compress_bytes(data, "NONE", "FPAQ",
                                            block_size=4096)
    assert kops.COUNTERS.get("fpaq_encode_device", 0) >= 3, kops.COUNTERS
    tops.disable()
    assert blob == kanzi_tpu_torch.compress_bytes(data, "NONE", "FPAQ",
                                                  block_size=4096)
    assert kanzi_tpu_torch.decompress_bytes(blob) == data


def test_fpaq_multichunk_bank_reset(fpaq_device, monkeypatch):
    """A block of four 2 KiB FPAQ chunks (the last partial): the bank
    context resets to probs[0] at every chunk start while the
    probabilities and low/high carry across. The prepared payload, as
    emit_prepared writes it, == the scalar host coder's with the same
    chunk size, and == kanzi_tpu's prepared payload under the same
    patch (the chunk size is a wire constant: only its framing is
    patched here)."""
    monkeypatch.setattr(cs, "FPAQ_CHUNK", CH)
    monkeypatch.setattr(fq, "DEFAULT_CHUNK_SIZE", CH)
    monkeypatch.setattr(ref_cs, "FPAQ_CHUNK", CH)
    n = 3 * CH + 513
    data = _bank_data(n)
    st, ref_st = ({"e_type": cs.FPAQ_TYPE, "mode": 0, "post_len": n,
                   "out": data, "prepared_entropy": None} for _ in range(2))
    cs.prepare_fpaq_batch([st], Context({"device": "cpu"}))
    ref_cs.prepare_fpaq_batch([ref_st])
    assert st["prepared_entropy"] == ref_st["prepared_entropy"]
    chunk_bufs, bound_lows, _final = st["prepared_entropy"]
    assert len(chunk_bufs) == 4 and len(bound_lows) == 3

    obs_dev = BitWriter()
    low = fq.emit_prepared(obs_dev, st["prepared_entropy"])
    obs_dev.write_bits(low | fq.MASK_0_24, 56)      # dispose
    obs_ref = BitWriter()
    enc = fq.FPAQEncoder(obs_ref)
    enc.encode(data)
    enc.dispose()
    assert obs_dev.getvalue() == obs_ref.getvalue()


def test_fpaq_batch_gate():
    """The FPAQ batch goes to a CUDA card only, and only where its blocks,
    weighted by length, reach FPAQ_MIN_STREAMS; on the CPU the container
    codes FPAQ on the host and launches nothing."""
    n, mib = cs.FPAQ_MIN_STREAMS, 1 << 20
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert cs._fpaq_on_device(cuda, [4 * mib] * n)
    assert not cs._fpaq_on_device(cuda, [4 * mib] * (n - 1))
    assert not cs._fpaq_on_device(cuda, [4 * mib] * (n - 1) + [mib])
    assert cs._fpaq_on_device(cuda, [4 * mib] * (n - 1) + [4 * mib, 1])
    assert not cs._fpaq_on_device(cuda, [])
    assert not cs._fpaq_on_device(cpu, [4 * mib] * 64)
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (n + 1) * 1024, dtype=np.uint8).tobytes()
    tops.reset_counters()
    blob = kanzi_tpu_torch.compress_bytes(data, "NONE", "FPAQ",
                                          block_size=1024, device="cpu")
    assert tops.COUNTERS == {}
    assert kanzi_tpu_torch.decompress_bytes(blob, device="cpu") == data


def test_stream_over_its_region_is_relaunched(jf, fpaq_device, monkeypatch):
    """A stream that emits more flush words than its region holds is
    launched again with a region of MAX_REGION_W words a window: the
    outputs equal the one-launch outputs (kanzi_tpu's model), and the
    container still writes the host path's bytes."""
    lens = np.array([1024, 1536])
    streams = _streams(5, lens)
    ref = jf._encode_batch_np(streams, lens, chunk_bytes=CH)
    monkeypatch.setattr(tf, "REGION_W", 4)
    tops.reset_counters()
    got = tf.fpaq_encode_batch(streams, lens, CH, "cpu")
    assert tops.COUNTERS == {"fpaq_encode_plain": 2}
    assert (got[2] > 4).any()
    _assert_batch_equal(got, ref)
    data = streams[0, :lens[0]].tobytes()
    tops.reset_counters()
    blob = kanzi_tpu_torch.compress_bytes(data, "NONE", "FPAQ",
                                          block_size=4096, device="cpu")
    assert tops.COUNTERS == {"fpaq_encode_plain": 2}
    tops.disable()
    assert blob == kanzi_tpu_torch.compress_bytes(data, "NONE", "FPAQ",
                                                  block_size=4096)


def test_wrapper_checks_its_inputs():
    streams = torch.zeros((2, 1024), dtype=torch.uint8)
    lens = torch.full((2,), 1024, dtype=torch.int64)
    with pytest.raises(ValueError, match="multiple"):
        tf.fpaq_encode(streams[:, :1000], lens, 4, 512)
    with pytest.raises(ValueError, match="cap"):
        tf.fpaq_encode(streams, lens, 4, -1)
    with pytest.raises(ValueError, match="lens"):
        tf.fpaq_encode(streams, lens.int(), 4, 512)
    with pytest.raises(ValueError, match="no kernel"):
        tf.fpaq_encode(streams.to("meta"), lens.to("meta"), 4, 512)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _kernel_case(name):
    """(streams [S, L] u8, lens [S], chunk_win, cap) of one case of
    test_kernel_matches_plain_on_cuda."""
    rng = np.random.default_rng(2)
    if name in ("ragged", "cap3"):
        # 40 streams of up to 2 KiB (two warps' worth, one empty) with
        # 1 KiB chunks
        lens = rng.integers(0, 2049, 40)
        lens[:3] = [2048, 0, 1]
        streams = _streams(4, lens.tolist())
        cap = 3 if name == "cap3" else (
            streams.shape[1] // tf.WIN_B * tf.REGION_W)
        return streams, lens, 2, cap
    if name == "wrap":
        # 66 windows, so the double buffer wraps 33 times; a bank reset
        # every 4 windows, each on a byte >= 64
        lens = np.array([66 * tf.WIN_B, 65 * tf.WIN_B + 300,
                         64 * tf.WIN_B, 40 * tf.WIN_B + 1])
        streams = _streams(6, lens.tolist())
        streams[0, 4 * tf.WIN_B - 1::4 * tf.WIN_B] = 200
        return streams, lens, 4, 66 * tf.REGION_W
    if name == "ns64":
        # one container batch: NS streams, ragged
        lens = rng.integers(1, 1537, tf.NS)
        streams = _streams(8, lens.tolist())
        return streams, lens, 2, 3 * tf.REGION_W
    n = 4 * tf.WIN_B
    row = {"zeros": np.zeros(n, np.uint8),
           "random": rng.integers(0, 256, n, dtype=np.uint8),
           "one_symbol": np.full(n, 0xA7, np.uint8)}[name]
    return row[None], np.array([n]), 2, 4 * tf.REGION_W


@pytest.mark.needs_cuda
@pytest.mark.parametrize("case", ["ragged", "cap3", "wrap", "ns64",
                                  "zeros", "random", "one_symbol"])
def test_kernel_matches_plain_on_cuda(cuda_device, case):
    """Kernel G on the card against its plain version on the host's CPU
    (the same function; a call of small ops is faster there): ragged
    streams with the first launch's region and with a region of 3 words
    (the words past it dropped, all of them counted); 66 windows with a
    bank reset every 4 (the producer's double buffer wrapped); 64
    streams, one container batch; an all-zero, a random and a one-symbol
    stream."""
    rows, lens, chunk_win, cap = _kernel_case(case)
    streams = np.zeros((len(rows), -(-rows.shape[1] // tf.WIN_B) * tf.WIN_B),
                       np.uint8)
    streams[:, :rows.shape[1]] = rows
    streams = torch.from_numpy(streams)
    lens = torch.from_numpy(lens.astype(np.int64))
    got = tf.fpaq_encode(streams.to(cuda_device), lens.to(cuda_device),
                         chunk_win, cap)
    ref = tf.fpaq_encode_plain(streams, lens, chunk_win, cap)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


# ---------------------------------------------------------------------------
# H. decode
# ---------------------------------------------------------------------------

def _decode_data():
    """Ragged streams, one of them over 3 chunks of CH: text-like,
    random, all zero, skewed, one byte."""
    rng = np.random.default_rng(12)
    return [rng.integers(97, 123, 2 * CH + 700).astype(np.uint8),
            rng.integers(0, 256, CH + 1).astype(np.uint8),
            np.zeros(1500, np.uint8),
            np.minimum(rng.geometric(0.1, 2 * CH), 255).astype(np.uint8),
            np.array([0xC3], np.uint8)]


def _frames(datas):
    """Each stream through the host coder (chunks of fq.DEFAULT_CHUNK_SIZE)
    and its framing read back by the host decoder into a sink, as the
    level-6 mesh decode reads it: a chunk's (primed current, payload
    bytes after the 7 priming bytes)."""
    from kanzi_tpu_torch.bitstream import BitReader
    from kanzi_tpu_torch.core.context import Context
    out = []
    for d in datas:
        w = BitWriter()
        enc = fq.FPAQEncoder(w)
        enc.encode(d)
        enc.dispose()
        sink = []
        fq.FPAQDecoder(BitReader(w.getvalue()),
                       Context({"_fpaqDecodeSink": sink})).decode(len(d))
        (_, chunks), = sink
        assert len(chunks) == -(-len(d) // fq.DEFAULT_CHUNK_SIZE)
        out.append(chunks)
    return out


def _rows(frames) -> tuple:
    """Streams' FPAQ chunks as the decoder reads them, frames[s] =
    [(primed current, the payload bytes after the 7 priming bytes)] a
    chunk, in decode_batch_jnp's layout: per chunk index k, [b, W_k] u32
    payload words and [b] u64 currents. A row holds its chunk's whole
    big-endian words, zeros after them: the host decoder reads zero
    words once fewer than 4 payload bytes are left, never a payload's
    last size % 4 bytes."""
    pays, curs = [], []
    for k in range(max((len(f) for f in frames), default=0)):
        chunks = [f[k] if k < len(f) else (0, b"") for f in frames]
        pay = np.zeros((len(frames), max(1, max(len(x) // 4
                                                for _, x in chunks))),
                       np.uint32)
        for j, (_, x) in enumerate(chunks):
            pay[j, :len(x) // 4] = np.frombuffer(x, ">u4", len(x) // 4)
        pays.append(pay)
        curs.append(np.array([c for c, _ in chunks], np.uint64))
    return pays, curs


def _one_chunk(pay, cur, lens_k, state):
    """fpaq_decode of one chunk a stream (chunk_bytes past every length)
    from ``state``: row s is chunk s."""
    b, w = pay.shape
    return tf.fpaq_decode(
        torch.from_numpy(pay.view(np.int32).reshape(-1).copy()),
        torch.arange(b, dtype=torch.int64) * w,
        torch.full((b,), w, dtype=torch.int64),
        torch.from_numpy(cur.astype(np.int64)),
        torch.arange(b, dtype=torch.int64),
        torch.from_numpy(lens_k.astype(np.int64)), CH, state)


@pytest.mark.timeout(300)
def test_decode_matches_jax_model_chunk_by_chunk(jf, monkeypatch):
    """fpaq_decode_batch (the plain version, one call for all chunks of
    all streams) returns the input of 5 ragged streams (1 byte to 3
    chunks of 2 KiB; random, zero, skewed). Chunk by chunk, the plain
    version started from kanzi_tpu's state (fpaq_state_from_limbs)
    gives kanzi_tpu.ops.fpaq.decode_streams_np's bytes, words consumed
    and state after the chunk."""
    monkeypatch.setattr(fq, "DEFAULT_CHUNK_SIZE", CH)
    datas = _decode_data()
    lens = np.array([len(d) for d in datas])
    frames = _frames(datas)
    pays, curs = _rows(frames)
    tops.reset_counters()
    out = tf.fpaq_decode_batch(pays, curs, lens, CH, "cpu")
    assert tops.COUNTERS == {"fpaq_decode_plain": 1}
    assert out.shape == (5, lens.max())
    for j, d in enumerate(datas):
        assert np.array_equal(out[j, :len(d)], d), j
        assert not out[j, len(d):].any()
    state = jf.init_state(len(datas))
    for k in range(3):
        lens_k = np.clip(lens - k * CH, 0, CH)
        got, consumed, got_state = _one_chunk(
            pays[k], curs[k], lens_k, tf.fpaq_state_from_limbs(state))
        want, widx, state = jf.decode_streams_np(
            pays[k], curs[k], lens_k, tuple(np.copy(x) for x in state[:5]))
        assert np.array_equal(got.numpy(), want[:, :got.shape[1]])
        live = lens_k > 0
        assert np.array_equal(consumed.numpy()[live], widx[live])
        for g, w in zip(got_state, tf.fpaq_state_from_limbs(state)):
            assert torch.equal(g, w)


@pytest.mark.timeout(300)
def test_decode_records_match_padded_rows(monkeypatch):
    """fpaq_decode_records (the chunk records flat, flat_records, as the
    level-6 mesh decode passes them) and fpaq_decode_batch (the same
    chunks in decode_batch_jnp's padded rows) both return the ragged
    streams' input."""
    monkeypatch.setattr(fq, "DEFAULT_CHUNK_SIZE", CH)
    datas = _decode_data()
    lens = np.array([len(d) for d in datas])
    frames = _frames(datas)
    got = tf.fpaq_decode_records(frames, lens, CH, "cpu")
    pays, curs = _rows(frames)
    assert np.array_equal(got, tf.fpaq_decode_batch(pays, curs, lens, CH,
                                                    "cpu"))
    for j, d in enumerate(datas):
        assert np.array_equal(got[j, :len(d)], d), j


@pytest.mark.timeout(300)
def test_decode_matches_decode_batch_jnp(jf, monkeypatch):
    """One small case against kanzi_tpu.ops.fpaq_jnp.decode_batch_jnp
    (JAX on the CPU): 2 streams, one over 2 chunks of 1 KiB, one of 1
    byte."""
    from kanzi_tpu.ops import fpaq_jnp as fj
    monkeypatch.setattr(fq, "DEFAULT_CHUNK_SIZE", 1024)
    datas = [np.minimum(np.random.default_rng(3).geometric(0.2, 1500), 255)
             .astype(np.uint8), np.array([7], np.uint8)]
    lens = np.array([1500, 1])
    pays, curs = _rows(_frames(datas))
    got = tf.fpaq_decode_batch(pays, curs, lens, 1024, "cpu")
    assert np.array_equal(got, fj.decode_batch_jnp(pays, curs, lens, 1024))
    assert np.array_equal(got[0], datas[0]) and got[1, 0] == 7


@pytest.mark.timeout(300)
@pytest.mark.parametrize("cut", [0, 4, 5, 9])
def test_decode_through_the_last_payload_words(jf, monkeypatch, cut):
    """A chunk whose payload is cut short by ``cut`` bytes (0: the whole
    payload, whose last 7 bytes are the dispose's low): the decoder
    reads its whole big-endian words, then zero words, as the host
    decoder (FPAQDecoder, the reference) does; the plain version's
    bytes and consumed words equal the host decoder's, and
    decode_streams_np's on the same words."""
    from kanzi_tpu_torch.bitstream import BitReader
    from kanzi_tpu_torch.entropy import utils as eu
    monkeypatch.setattr(fq, "DEFAULT_CHUNK_SIZE", CH)
    data = np.random.default_rng(4).integers(0, 256, 1800).astype(np.uint8)
    (prime, buf), = _frames([data])[0]
    buf = buf[:len(buf) - cut]
    w = BitWriter()
    eu.write_varint(w, len(buf))
    w.write_bits(prime, 56)
    w.write_bytes(buf)
    w.write_bits(0, 64)
    host = fq.FPAQDecoder(BitReader(w.getvalue())).decode(len(data))
    if cut == 0:
        assert np.array_equal(host, data)
    pays, curs = _rows([[(prime, buf)]])
    got, consumed, _ = _one_chunk(pays[0], curs[0], np.array([len(data)]),
                                  None)
    assert np.array_equal(got[0].numpy(), host)
    want, widx, _ = jf.decode_streams_np(pays[0], curs[0],
                                         np.array([len(data)]),
                                         jf.init_state(1))
    assert np.array_equal(want[0], host)
    assert int(consumed[0]) == int(widx[0])
    assert int(consumed[0]) >= len(buf) // 4        # every word read


@pytest.mark.timeout(300)
def test_round_trip_plain_encode_decode(monkeypatch):
    """G's plain encode (fpaq_encode_batch, 3 streams over up to 3 chunks
    of 2 KiB) framed as the container frames it (_stash_fpaq), then
    H's plain decode (fpaq_decode_batch): the input back."""
    monkeypatch.setattr(cs, "FPAQ_CHUNK", CH)
    datas = _decode_data()[:3]
    lens = np.array([len(d) for d in datas])
    streams = np.zeros((3, lens.max()), np.uint8)
    for j, d in enumerate(datas):
        streams[j, :len(d)] = d
    states = [{} for _ in datas]
    cs._stash_fpaq(states, lens, tf.fpaq_encode_batch(streams, lens, CH,
                                                      "cpu"))
    frames = []
    for st in states:
        bufs, bound_lows, final = st["prepared_entropy"]
        lows = bound_lows + [final]
        chunks = []
        for words, low in zip(bufs, lows):
            tail = words + low.to_bytes(7, "big")
            chunks.append((int.from_bytes(tail[:7], "big"),
                           tail[7:7 + len(words)]))
        frames.append(chunks)
    pays, curs = _rows(frames)
    out = tf.fpaq_decode_batch(pays, curs, lens, CH, "cpu")
    for j, d in enumerate(datas):
        assert np.array_equal(out[j, :len(d)], d), j


@pytest.mark.timeout(60)
def test_decode_wrapper_checks_its_inputs():
    i64 = torch.zeros(2, dtype=torch.int64)
    pay = torch.zeros(8, dtype=torch.int32)
    lens = torch.tensor([3, 0])
    first = torch.tensor([0, 1])
    args = (pay, i64, i64 + 4, i64, first, lens)
    out, consumed, _ = tf.fpaq_decode(*args, CH)
    assert out.shape == (2, 3) and consumed.shape == (2,)
    with pytest.raises(ValueError, match="pay"):
        tf.fpaq_decode(pay.long(), *args[1:], CH)
    with pytest.raises(ValueError, match="chunk_nw"):
        tf.fpaq_decode(pay, i64, i64[:1], *args[3:], CH)
    with pytest.raises(ValueError, match="chunk_bytes"):
        tf.fpaq_decode(*args, 0)
    with pytest.raises(ValueError, match="outside"):
        tf.fpaq_decode(pay, i64 + 5, i64 + 4, *args[3:], CH)
    with pytest.raises(ValueError, match="outside"):
        tf.fpaq_decode(*args[:4], first + 2, lens, CH)
    with pytest.raises(ValueError, match="probs"):
        tf.fpaq_decode(*args, CH, tf.fpaq_init_state(2)[:2]
                       + (torch.zeros((2, 1024), dtype=torch.int64),))
    with pytest.raises(ValueError, match="no kernel"):
        tf.fpaq_decode(*(a.to("meta") for a in args), CH)


def _decode_case(case):
    """H's flat arguments (decode_layout, CH chunks), start state (None
    for the block start's) and input bytes of one decode case; the
    caller sets fq.DEFAULT_CHUNK_SIZE to CH."""
    rng = np.random.default_rng(5)
    datas = _decode_data()
    if case == "zeros":
        datas = [np.zeros(3 * CH, np.uint8)]
    if case in ("bank", "flushes"):
        datas = [_bank_data(3 * CH), _bank_data(2 * CH + 300)[::-1].copy()]
        datas[1][[CH - 1, 2 * CH - 1]] = [0x7F, 0xC5]
    if case == "flushes":
        datas = [rng.integers(0, 256, len(d), dtype=np.uint8)
                 for d in datas]
    if case == "runs":
        datas = [np.repeat(rng.integers(0, 256, 24).astype(np.uint8), 256),
                 np.tile(np.array([0x41, 0xC2], np.uint8), 2 * CH)]
    frames = _frames(datas)
    if case == "cut":
        frames = [[(c, x[:len(x) - 9]) for c, x in f] for f in frames]
    lens = np.array([len(d) for d in datas])
    pays, curs = _rows(frames)
    state = None
    if case == "from_state":
        low, high, probs = tf.fpaq_init_state(len(datas))
        state = (low, high, torch.from_numpy(
            rng.integers(1, 65472, probs.shape).astype(np.int32)))
    args = [torch.from_numpy(a)
            for a in tf.decode_layout(pays, curs, lens, CH)]
    return args, state, datas


def _upd(p, bit):
    """A probability's update (FPAQPredictor::update)."""
    return p - (p >> 6) + (1023 if bit else 0)


def _model_decode(args, state, j):
    """Stream j of fpaq_decode in kernel H's order of table reads, plain
    Python: a step reads its four grandchildren (the next step's
    children) before its own store, and after the byte's second bit the
    next byte's root and the root's children, in the bank of the byte's
    top two bits or, at a chunk's last byte, in bank 0; the values read
    stand in where the plain version reads the table afresh. Returns
    (bytes, each chunk's words consumed, low, high, table)."""
    pay, c_off, c_nw, c_cur, first, lens = (a.tolist() for a in args)
    low, high, probs = state if state is not None else tf.fpaq_init_state(
        len(lens))
    low, high, tbl = int(low[j]), int(high[j]), probs[j].tolist()
    out, used = [], []
    base, pv, kids = 0, tbl[1], (tbl[2], tbl[3])
    for c in range(first[j], first[j] + -(-lens[j] // CH)):
        words = [x & tf.MASK_0_32
                 for x in pay[c_off[c]:c_off[c] + c_nw[c]]]
        cur, widx = c_cur[c], 0
        n = min(CH, lens[j] - len(out))
        for i in range(n):
            ctx = 1
            for k in range(8):
                if k < 6:
                    g = tbl[base + 4 * ctx:base + 4 * ctx + 4]
                split = low + ((((high - low) >> 8) * pv) >> 8)
                bit = int(split >= cur)
                high, low = (split, low) if bit else (high, split + 1)
                tbl[base + ctx] = _upd(pv, bit)
                pv = kids[bit] if k < 7 else npv
                if k < 6:
                    kids = g[2 * bit:2 * bit + 2]
                ctx = 2 * ctx + bit
                if k == 1:
                    nbase = ((ctx & 3) if i + 1 < n else 0) << 8
                    npv, nkids = tbl[nbase + 1], tbl[nbase + 2:nbase + 4]
                if ((low ^ high) >> 24) == 0:
                    low = (low & tf.MASK_0_24) << 32
                    high = ((high & tf.MASK_0_24) << 32) | tf.MASK_0_32
                    nxt = words[widx] if widx < len(words) else 0
                    cur = ((cur & tf.MASK_0_24) << 32) | nxt
                    widx += 1
            out.append(ctx & 0xFF)
            base, kids = nbase, nkids
        used.append(widx)
    return out, used, low, high, tbl


@pytest.mark.timeout(300)
@pytest.mark.parametrize("case", ["from_state", "runs", "bank"])
def test_decode_read_order_model_matches_plain(case, monkeypatch):
    """Kernel H's argument that a step may read its grandchildren before
    its own store, and the next byte's root after the byte's second bit:
    a model that reads the table in that order (bank 0 after a chunk's
    last byte) decodes byte for byte as fpaq_decode_plain, with the same
    words consumed a chunk and end state, from a random table, on runs
    and two symbols in turns, and over 3 chunks whose chunk-final bytes
    are >= 0x40."""
    monkeypatch.setattr(fq, "DEFAULT_CHUNK_SIZE", CH)
    args, state, datas = _decode_case(case)
    ref, consumed, low, high, probs = tf.fpaq_decode_plain(
        *args, CH, *(state or tf.fpaq_init_state(len(datas))))
    first = args[4].tolist()
    for j, d in enumerate(datas):
        out, used, *end = _model_decode(args, state, j)
        assert out == ref[j, :len(d)].tolist(), j
        assert used == consumed[first[j]:first[j] + len(used)].tolist(), j
        assert end == [int(low[j]), int(high[j]), probs[j].tolist()], j
        if case != "from_state":
            assert out == d.tolist(), j


@pytest.mark.timeout(300)
@pytest.mark.needs_cuda
@pytest.mark.parametrize("case", ["ragged", "cut", "zeros", "from_state",
                                  "bank", "flushes"])
def test_decode_kernel_matches_plain_on_cuda(cuda_device, case,
                                             monkeypatch):
    """Kernel H on the card against its plain version on the host's CPU,
    bytes, consumed words and end state: the ragged streams of
    _decode_data over up to 3 chunks; one whose payload is cut 9 bytes
    short (zero words read past it); an all-zero stream; the same ragged
    streams from a state that is not the start's; streams over 3 chunks
    whose chunk-final bytes are >= 0x40 (the next chunk's first byte
    takes bank 0, not that byte's); and random streams over 3 chunks,
    incompressible from the block's start state: a flush every ~32 bit
    steps."""
    monkeypatch.setattr(fq, "DEFAULT_CHUNK_SIZE", CH)
    args, state, _ = _decode_case(case)
    ref = tf.fpaq_decode(*args, CH, state)
    got = tf.fpaq_decode(*(a.to(cuda_device) for a in args), CH,
                         None if state is None
                         else tuple(t.to(cuda_device) for t in state))
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu(), ref[1])
    for g, r in zip(got[2], ref[2]):
        assert torch.equal(g.cpu(), r)
