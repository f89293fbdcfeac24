"""PyTorch port of the order-1 ANS encode (kanzi_tpu_torch.ops.ans1 and
the order-1 device path of kanzi_tpu_torch.entropy.ans) against the JAX
package, bit for bit: the format is integer-only, so every tolerance
here is exact equality.

The JAX package's order-1 kernels run only on a TPU, so the reference
is what kanzi_tpu's own tests hold them against: its tables
(kanzi_tpu.ops.ans1 INV_LUT, planes_from_freqs_np, build_sym_idx on the
CPU backend) and its host lane model (ANSRangeEncoder._run_lanes with
_sym_encode_tables). On the CPU the port's kernel wrapper runs its plain
PyTorch version; the kernel itself is held against that version by the
needs_cuda test at the end, which skips without a card. JAX comes in
through the ``j1`` fixture, so that test also runs on a machine without
JAX:

    KANZI_TEST_TPU=1 python -m pytest -m needs_cuda tests/test_torch_ans1.py

No test here runs a plain scan over a full 4 MiB chunk (about two
minutes on the CPU): the order-1 chunks are 64 and 256 KiB.
"""

import numpy as np
import pytest
import torch

from kanzi_tpu.bitstream import BitWriter as RefBitWriter
from kanzi_tpu.core.context import Context as RefContext
from kanzi_tpu.entropy.ans import ANSRangeEncoder as RefANSRangeEncoder
from kanzi_tpu.entropy.ans import _sym_encode_tables

import kanzi_tpu.entropy.ans as ref_ans
import kanzi_tpu.ops as kops
from kanzi_tpu.io.compressed_stream import compress_bytes as ref_compress

import kanzi_tpu_torch.entropy.ans as tans
import kanzi_tpu_torch.io.compressed_stream as tcs
import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.bitstream import BitReader, BitWriter
from kanzi_tpu_torch.core.context import Context
from kanzi_tpu_torch.entropy.ans import ANSRangeDecoder, ANSRangeEncoder
from kanzi_tpu_torch.ops import ans1 as t1
from kanzi_tpu_torch.utils import native

KIB = 1024
Q = 16384                       # steps of a 64 KiB order-1 chunk


@pytest.fixture(scope="module")
def j1():
    """kanzi_tpu.ops.ans1, the JAX reference (on the CPU backend)."""
    from kanzi_tpu.ops import ans1
    return ans1


def _text(rng, n):
    words = [b"the", b"order", b"one", b"context", b"range", b"coder",
             b"lane", b"state", b"renorm", b"chunk", b"table", b"(", b")",
             b"\n", b"kanzi", b"entropy"]
    return np.frombuffer(b" ".join(words[i] for i in rng.integers(
        0, len(words), n // 3))[:n], np.uint8)


def _chunks(n):
    """Text, random bytes and a 6-symbol alphabet, n bytes each (the
    classes of tests/test_ops_ans1.py, with generated text)."""
    rng = np.random.default_rng(5)
    return np.stack([_text(rng, n),
                     rng.integers(0, 256, n).astype(np.uint8),
                     rng.choice(np.arange(6, dtype=np.uint8), n)])


def _freqs(chunks):
    return np.stack([native.ans1_norm(native.ans1_hist(ch)) for ch in chunks])


def _host_lanes(chunk, freqs):
    """kanzi_tpu's host lane model of one order-1 chunk: (states,
    payload bytes), as tests/test_ops_ans1.py builds it."""
    q = len(chunk) // 4
    sym_idx = np.zeros((q, 4), np.int64)
    base = np.arange(4) * q
    iv = np.arange(q - 2, -1, -1)[:, None]
    sym_idx[:q - 1] = ((chunk[base[None, :] + iv].astype(np.int64) << 8)
                       | chunk[base[None, :] + iv + 1])
    sym_idx[q - 1] = chunk[base]
    enc = RefANSRangeEncoder(RefBitWriter(), RefContext({}), order=1)
    return enc._run_lanes(sym_idx, _sym_encode_tables(freqs, 11))


def test_inv_lut_and_table_match_jax(j1):
    """INV_LUT == kanzi_tpu's (without its 17 x 128 padding), and the
    packed f | cum << 12 table == the value planes_from_freqs_np splits
    into bf16 byte planes."""
    assert np.array_equal(t1.INV_LUT.numpy().view(np.uint32),
                          j1.INV_LUT.reshape(-1)[:t1.SCALE1 + 1])
    freqs = _freqs(_chunks(4 * KIB))
    planes = j1.planes_from_freqs_np(freqs).astype(np.int64)
    v = planes[:, :256] + 256 * planes[:, 256:512] + 65536 * planes[:, 512:]
    ref = v.transpose(0, 2, 1).reshape(len(freqs), -1)     # [C, prev*256+cur]
    got = t1.encode_table(torch.from_numpy(freqs))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)


def test_build_sym_idx_matches_jax(j1):
    import jax.numpy as jnp
    chunks = _chunks(8 * KIB)
    ref = np.asarray(j1.build_sym_idx(jnp.asarray(chunks)))
    got = t1.build_sym_idx(torch.from_numpy(chunks))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)


def test_encode_batch_matches_host_lanes():
    """ans1_encode_batch (plain versions of F and B) at 3 chunks of 64
    KiB: each chunk's states and payload == kanzi_tpu's host lane
    model."""
    chunks = _chunks(4 * Q)
    freqs = _freqs(chunks)
    tops.reset_counters()
    states, flat, plen = t1.ans1_encode_batch(torch.from_numpy(chunks), freqs)
    assert tops.COUNTERS == {"ans1_gather_plain": 1, "ans1_chain_plain": 1,
                             "ans0_compact_plain": 1}
    states = states.numpy().view(np.uint32)
    flat, plen = flat.numpy(), plen.numpy()
    offs = np.cumsum(plen) - plen
    assert len(flat) == plen.sum()
    for ci, ch in enumerate(chunks):
        gst, gpay = _host_lanes(ch, freqs[ci])
        assert np.array_equal(states[ci], np.asarray(gst, np.uint32))
        assert flat[offs[ci]:offs[ci] + plen[ci]].tobytes() == gpay


def test_encode_device1_matches_kanzi_tpu():
    """_encode_device1 on the CPU with chunk_size=1024 (256 KiB order-1
    chunks; two of them, then a tail for the host path) writes
    kanzi_tpu's bits for the same block, which decode back."""
    rng = np.random.default_rng(11)
    block = np.concatenate([_text(rng, 300 * KIB),
                            rng.integers(0, 256, 212 * KIB + 4321,
                                         dtype=np.uint8)])
    ref = RefBitWriter()
    RefANSRangeEncoder(ref, RefContext({}), order=1,
                       chunk_size=1024).encode(block)
    ctx = Context({"device": "cpu"})
    w = BitWriter()
    enc = ANSRangeEncoder(w, ctx, order=1, chunk_size=1024)
    tops.reset_counters()
    start = enc._encode_device1(block, len(block))
    assert start == 2 * (1024 << 8)
    assert tops.COUNTERS == {"ans1_gather_plain": 1, "ans1_chain_plain": 1,
                             "ans0_compact_plain": 1}
    enc.encode(block[start:])
    assert w.getvalue() == ref.getvalue()
    dec = ANSRangeDecoder(BitReader(w.getvalue()), ctx, order=1,
                          chunk_size=1024)
    out = np.concatenate([dec.decode(start), dec.decode(len(block) - start)])
    assert np.array_equal(out, block)


def _order1_chunk_size(cls, chunk_size):
    """cls (one of kanzi_tpu's ANSRange coder classes) cutting order-1
    chunks of chunk_size << 8 bytes unless told otherwise."""
    class Coder(cls):
        def __init__(self, *args, order=0, **kw):
            if order == 1:
                kw.setdefault("chunk_size", chunk_size)
            super().__init__(*args, order=order, **kw)
    return Coder


def test_writer_batch_takes_one_launch(monkeypatch):
    """A writer batch of three -e ANS1 blocks (two full order-1 chunks and
    a tail each) runs its six full chunks through ONE call of the order-1
    encode (plain F1, F2 and B here, the coder's CUDA gate opened by
    monkeypatching it): the container is byte-identical with kanzi_tpu's
    and with the port's host path, and decodes back. Both packages cut
    256 KiB order-1 chunks (chunk_size=1024), so that the plain F runs
    in seconds."""
    for name in ("ANSRangeEncoder", "ANSRangeDecoder"):
        monkeypatch.setattr(getattr(tans, name), "default_chunk_size", 1024)
        monkeypatch.setattr(ref_ans, name, _order1_chunk_size(
            getattr(ref_ans, name), 1024))
    rng = np.random.default_rng(7)
    block = 2 * (256 * KIB) + 40 * KIB
    data = np.concatenate([_text(rng, block),
                           rng.integers(0, 256, block, dtype=np.uint8),
                           rng.choice(np.arange(6, dtype=np.uint8), block)]
                          ).tobytes()
    kops.disable()
    try:
        ref = ref_compress(data, "NONE", "ANS1", block_size=block)
    finally:
        kops.enable()
    tops.disable()
    try:
        host = tcs.compress_bytes(data, "NONE", "ANS1", block_size=block,
                                  device="cpu")
    finally:
        tops.enable()
    monkeypatch.setattr(tans, "ans1_on_device", lambda dev: True)
    tops.reset_counters()
    got = tcs.compress_bytes(data, "NONE", "ANS1", block_size=block,
                             device="cpu")
    assert tops.COUNTERS == {"ans1_gather_plain": 1, "ans1_chain_plain": 1,
                             "ans0_compact_plain": 1}
    assert got == ref
    assert got == host
    assert tcs.decompress_bytes(got, device="cpu") == data


def test_device_gate_is_the_full_chunk():
    """Blocks below one 4 MiB order-1 chunk, and chunk sizes other than
    the format's default, never reach the device path; nor does a full
    chunk whose coding device is the CPU (the native host coder takes
    it, not the plain version's million-step loop)."""
    block = _chunks(64 * KIB)[0]
    tops.reset_counters()
    for cs in (16384, 1024):
        ANSRangeEncoder(BitWriter(), Context({"device": "cpu"}), order=1,
                        chunk_size=cs).encode(block)
    full = np.tile(block, t1.CHUNK1 // len(block))
    ANSRangeEncoder(BitWriter(), Context({"device": "cpu"}),
                    order=1).encode(full)
    assert tops.COUNTERS == {}


def test_wrapper_checks_its_inputs():
    chunks = torch.zeros((2, 4 * Q), dtype=torch.uint8)
    table = torch.zeros((2, t1.TABLE1), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        t1.ans1_encode_scan(chunks[:, :1000], table, t1.INV_LUT)
    with pytest.raises(ValueError, match="table"):
        t1.ans1_encode_scan(chunks, table[:1], t1.INV_LUT)
    with pytest.raises(ValueError, match="lut"):
        t1.ans1_encode_scan(chunks, table, t1.INV_LUT[:2048])
    with pytest.raises(ValueError, match="no kernel"):
        t1.ans1_encode_scan(chunks.to("meta"), table.to("meta"),
                            t1.INV_LUT.to("meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("n_chunks", [8, 16])
def test_kernel_matches_plain_on_cuda(cuda_device, n_chunks):
    """Kernels F1 and F2, each and together, against their plain versions
    on the card, at n_chunks chunks of 16 KiB: the three classes above,
    a chunk whose context 'a' has a frequency-1 successor (the small
    branch, f < 2), a chunk of one repeated byte, and skewed random
    bytes."""
    rng = np.random.default_rng(n_chunks)
    n = 4 * 4096
    host = rng.geometric(0.05, (n_chunks, n)).astype(np.uint8)
    host[:3] = _chunks(n)
    host[3] = np.tile(np.frombuffer(b"ab", np.uint8), n // 2)
    host[3, 5001] = ord("c")
    host[4] = 0x41
    chunks = torch.from_numpy(host).to(cuda_device)
    freqs = _freqs(host)
    assert freqs[3, ord("a"), ord("c")] == 1
    table = t1.encode_table(torch.from_numpy(freqs).to(cuda_device))
    lut = t1.INV_LUT.to(cuda_device)
    consts = t1.ans1_gather(chunks, table, lut)
    ref_consts = t1.ans1_gather_plain(chunks, table, lut)
    got = t1.ans1_chain(ref_consts)
    ref = t1.ans1_chain_plain(ref_consts)
    both = t1.ans1_encode_scan(chunks, table, lut)
    torch.cuda.synchronize()
    assert torch.equal(consts, ref_consts)
    for g, b, r in zip(got, both, ref):
        assert torch.equal(g, r)
        assert torch.equal(b, r)
