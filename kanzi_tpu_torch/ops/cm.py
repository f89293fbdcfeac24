"""CM (context-mixing) binary arithmetic encode and decode on a CUDA
device, one stream a block.

The PyTorch counterpart of kanzi_tpu/ops/cm_jnp.py, bit-exact with it and
with the host coder (entropy/binary.py's 56-bit shell around
entropy/cm.py's CMPredictor; src/entropy/CMPredictor.{hpp,cpp} and
BinaryEntropy{Encoder,Decoder}.cpp of the reference): counter1[256][257]
(bit-tree context x previous byte, rates 2 and 4), counter2[512][17] (SSE
on the quantized p with the run mask, rate 6), the split
``low + (((high - low) >> 4) * p12 >> 8)`` and a 32-bit flush whenever
the top 32 of the 56-bit bounds agree. A stream is one block of fewer
than 2^26 bytes, one chunk of the shell (binary._chunk_length), which
covers every level-7 block.

Kept from kanzi_tpu: the batch contracts, cm_encode_batch's (bufs, low56,
overflow) with CAP = L + 64 words a stream and cm_decode_batch's padded
[b, W] payload rows. Not kept: the 28-bit limbs and _split_t12's 14-bit
sub-limbs, which work around the TPU's 32-bit integers. The kernels hold
low, high and current in 64-bit registers: ``((high - low) >> 4) * p12``
reaches 2^64 - 2^12 (p12 can be 4096), inside uint64 but not int64, so
the plain versions take it as ``(range >> 12) * p12 + ((((range >> 4) &
0xFF) * p12) >> 8)``.

Two hand-written CUDA kernels (csrc/cm.cu), each with its plain version
beside it: I behind ``cm_encode`` (``cm_encode_plain``) and J behind
``cm_decode`` (``cm_decode_plain``), the functions kanzi_tpu computes in
XLA with no Pallas kernel. Both take the state their streams start from
and return the state they end in (``cm_init_state``; kanzi_tpu's start
state through ``cm_state_from_limbs``). The level-7 mesh chain
(parallel.pipeline) encodes through ``cm_encode_batch`` and decodes
through ``cm_decode_records``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kanzi_tpu_torch.ops.ans import (_check, _launch, _on_cpu, _to_device,
                                     _to_numpy, _u32_bits)

C1W = 257 * 256              # counter1, row-major [ctx][0..256]
C2W = 512 * 17               # counter2, [ctx | run mask][0..16]
PSCALE = 65536
C1_MAX = PSCALE - 16         # where a bit-1 update stops: counter1 fits u16
MAX_STREAM = 1 << 26         # one chunk of the shell
MASK_0_24 = (1 << 24) - 1
MASK_0_32 = (1 << 32) - 1
MASK_0_56 = (1 << 56) - 1
_SH = (7, 6, 5, 4, 3, 2, 1, 0)


class CMState(NamedTuple):
    """The coder's state for b streams: the 56-bit bounds, the predictor's
    tables and its context registers (the previous byte c1, the one
    before it c2, and run_mask = 0x100 where they are equal)."""
    low: torch.Tensor           # [b] int64
    high: torch.Tensor          # [b] int64
    counter1: torch.Tensor      # [b, C1W] int32
    counter2: torch.Tensor      # [b, C2W] int32
    c1: torch.Tensor            # [b] int32
    c2: torch.Tensor            # [b] int32
    run_mask: torch.Tensor      # [b] int32


def cm_init_state(b: int, bs_version: int, device="cpu") -> CMState:
    """The state at a block's start (CMPredictor's constructor, the
    shell's low 0 and high 2^56 - 1): counter1 all 32768, every row of
    counter2 j << 12, its entry 16 65536 before bsVersion 7 and 65535
    from it."""
    base = torch.arange(17, dtype=torch.int32) << 12
    if bs_version >= 7:
        base[16] = PSCALE - 1
    z = torch.zeros(b, dtype=torch.int32, device=device)
    return CMState(
        torch.zeros(b, dtype=torch.int64, device=device),
        torch.full((b,), MASK_0_56, dtype=torch.int64, device=device),
        torch.full((b, C1W), PSCALE >> 1, dtype=torch.int32, device=device),
        base.repeat(512).to(device).expand(b, C2W).contiguous(),
        z, z.clone(), z.clone())


def cm_state_from_limbs(l_h, l_l, h_h, h_l, c1t, c2t, c1=None, c2=None,
                        run_mask=None, device="cpu") -> CMState:
    """kanzi_tpu's lockstep state as this module's, all numpy in: the
    28-bit limbs of low and high [b], the u32 tables [b, C1W] and [b, C2W]
    (kanzi_tpu/ops/cm_jnp.py _init_cm_state's layout) and the context
    registers [b] (zero, as its coders start them, when None)."""
    def join(h, lo):
        return torch.from_numpy((np.asarray(h).astype(np.int64) << 28)
                                | np.asarray(lo).astype(np.int64))

    def i32(x, n):
        x = np.zeros(n, np.int32) if x is None else np.asarray(x)
        return torch.from_numpy(x.astype(np.int32))

    b = np.asarray(l_h).shape[0]
    return CMState(*(t.to(device) for t in (
        join(l_h, l_l), join(h_h, h_l), i32(c1t, (b, C1W)),
        i32(c2t, (b, C2W)), i32(c1, b), i32(c2, b), i32(run_mask, b))))


def _check_state(state: CMState, b: int, dev) -> None:
    if len(state) != len(CMState._fields):
        raise ValueError(f"state: expected the {len(CMState._fields)} "
                         f"tensors of CMState, got {len(state)}")
    shapes = {"low": (b,), "high": (b,), "counter1": (b, C1W),
              "counter2": (b, C2W)}
    for name, t in zip(CMState._fields, state):
        _check(f"state.{name}", t, torch.int64 if name in ("low", "high")
               else torch.int32, shapes.get(name, (b,)), dev)


# ---------------------------------------------------------------------------
# the plain versions' lockstep bit step
# ---------------------------------------------------------------------------

class _Lockstep:
    """The predictor and the shell's split of b streams as [b] tensors,
    the tables widened to int64 with a scratch copy beside each: a stream
    past its end codes on there, and the caller puts its registers back
    after each byte."""

    def __init__(self, state: CMState):
        b, dev = state.low.shape[0], state.low.device
        self.t1 = torch.cat([state.counter1.long(),
                             torch.zeros((b, C1W), dtype=torch.int64,
                                         device=dev)], 1)
        self.t2 = torch.cat([state.counter2.long(),
                             torch.zeros((b, C2W), dtype=torch.int64,
                                         device=dev)], 1)
        self.low, self.high = state.low.clone(), state.high.clone()
        self.c1, self.c2, self.rm = (x.long() for x in state[4:])
        self.rates = torch.tensor([[2, 4]], device=dev)
        self.pair = torch.arange(2, device=dev)
        self.o1 = self.o2 = torch.zeros(b, dtype=torch.int64, device=dev)

    def begin_byte(self, alive) -> None:
        """A byte's columns of counter1 (256, c1, c2); the streams that
        are not alive (where alive is not None) go to the scratch
        tables."""
        if alive is not None:
            self.o1 = torch.where(alive, 0, C1W)
            self.o2 = torch.where(alive, 0, C2W)
        self.cols = torch.stack((torch.full_like(self.c1, 256), self.c1,
                                 self.c2), 1) + self.o1[:, None]

    def predict(self, ctx):
        """CMPredictor.get(): (mid, the counter1 and counter2 indexes the
        update takes and their values)."""
        i1 = (ctx * 257)[:, None] + self.cols
        g1 = self.t1.gather(1, i1)
        p = (13 * (g1[:, 0] + g1[:, 1]) + 6 * g1[:, 2]) >> 5
        i2 = ((ctx | self.rm) * 17 + (p >> 12) + self.o2)[:, None] + self.pair
        g2 = self.t2.gather(1, i2)
        p12 = (2 * p + 3 * g2.sum(1) + 64) >> 7
        r = self.high - self.low
        mid = self.low + (r >> 12) * p12 + ((((r >> 4) & 0xFF) * p12) >> 8)
        return mid, i1[:, :2], g1[:, :2], i2, g2

    def update(self, bit, mid, i1, g1, i2, g2) -> None:
        """The bound the bit keeps, CMPredictor.update's four counters."""
        self.high = torch.where(bit == 1, mid, self.high)
        self.low = torch.where(bit == 1, self.low, mid + 1)
        sub = (C1_MAX * bit)[:, None]
        self.t1.scatter_(1, i1, g1 - ((g1 - sub) >> self.rates))
        self.t2.scatter_(1, i2, g2 - ((g2 - sub) >> 6))

    def flush(self, alive):
        """The streams whose top 32 bits of low and high agree (and are
        alive, where that is not None), and the word each emits (high's
        top 32 bits; None where no stream flushes); low and high
        shifted."""
        f = ((self.low ^ self.high) >> 24) == 0
        if alive is not None:
            f &= alive
        if not bool(f.any()):
            return f, None
        word = self.high >> 24
        self.low = torch.where(f, (self.low & MASK_0_24) << 32, self.low)
        self.high = torch.where(
            f, ((self.high & MASK_0_24) << 32) | MASK_0_32, self.high)
        return f, word

    def end_byte(self, ctx) -> None:
        self.c2 = self.c1
        self.c1 = ctx & 0xFF
        self.rm = torch.where(self.c1 == self.c2, 0x100, 0)

    def state(self) -> CMState:
        c1t, c2t = self.t1[:, :C1W], self.t2[:, :C2W]
        if not (0 <= int(c1t.min()) and int(c1t.max()) <= C1_MAX
                and 0 <= int(c2t.min()) and int(c2t.max()) <= PSCALE):
            raise RuntimeError("cm: a counter left its range (counter1 "
                               "[0, 65520], counter2 [0, 65536])")
        return CMState(self.low, self.high, c1t.to(torch.int32),
                       c2t.to(torch.int32),
                       *(x.to(torch.int32) for x in (self.c1, self.c2,
                                                     self.rm)))


def _keep(alive, new: tuple, old: tuple) -> tuple:
    return tuple(torch.where(alive, n, o) for n, o in zip(new, old))


# ---------------------------------------------------------------------------
# I. encode
# ---------------------------------------------------------------------------

def cm_encode_plain(streams, lens, cap: int, state: CMState):
    """Plain version of the cm_encode kernel: the streams in lockstep, a
    Python loop over the bytes and their 8 bits on [b] tensors."""
    b, dev = streams.shape[0], streams.device
    lens_h = lens.tolist()
    n_len, n_all = max(lens_h, default=0), min(lens_h, default=0)
    st = _Lockstep(state)
    data = streams.long()
    sh = torch.tensor(_SH, device=dev)
    # column cap takes the words of streams that do not flush or are full
    words = torch.zeros((b, cap + 1), dtype=torch.int64, device=dev)
    cnt = torch.zeros(b, dtype=torch.int64, device=dev)
    alive = None
    for i in range(n_len):
        bits = (data[:, i, None] >> sh) & 1
        if i >= n_all:              # some stream has ended
            alive = i < lens
            kept = st.low, st.high, st.c1, st.c2, st.rm
        st.begin_byte(alive)
        ctx = torch.ones(b, dtype=torch.int64, device=dev)
        for k in range(8):
            bit = bits[:, k]
            mid, *touched = st.predict(ctx)
            st.update(bit, mid, *touched)
            ctx = 2 * ctx + bit
            f, word = st.flush(alive)
            if word is not None:
                slot = torch.where(f, cnt, cap).clamp_(max=cap)
                words.scatter_(1, slot[:, None], word[:, None])
                cnt += f
        st.end_byte(ctx)
        if alive is not None:
            st.low, st.high, st.c1, st.c2, st.rm = _keep(
                alive, (st.low, st.high, st.c1, st.c2, st.rm), kept)
    return _u32_bits(words[:, :cap]), cnt, st.state()


def cm_encode(streams, lens, cap: int, state: CMState):
    """CM-encode b streams, one kernel block a stream, from ``state`` (not
    modified). streams [b, L] uint8 (rows past their length unread), lens
    [b] int64 stream lengths, each below 2^26; cap = the words each
    stream's output row holds.

    Returns (words [b, cap] int32: each stream's flush words (u32 bits)
    from its start, zero after its last, those past cap dropped; cnt [b]
    int64 its flushes, dropped ones included; the state each stream ends
    in)."""
    b, n = streams.shape
    dev = streams.device
    if cap < 0:
        raise ValueError(f"cap {cap} < 0")
    _check("streams", streams, torch.uint8, (b, n), dev)
    _check("lens", lens, torch.int64, (b,), dev)
    _check_state(state, b, dev)
    plain = _on_cpu("cm_encode", dev)
    if b and not 0 <= int(lens.min()) <= int(lens.max()) <= min(
            n, MAX_STREAM - 1):
        raise ValueError(f"lens: a stream length outside [0, "
                         f"{min(n, MAX_STREAM - 1)}]")
    if plain:
        return cm_encode_plain(streams, lens, cap, state)
    words = torch.zeros((b, cap), dtype=torch.int32, device=dev)
    cnt = torch.zeros(b, dtype=torch.int64, device=dev)
    out = CMState(*(t.clone() for t in state))
    _launch("cm_encode", dev, streams, lens, b, n, cap, words, cnt, *out)
    return words, cnt, out


def cm_encode_batch(streams: np.ndarray, lens: np.ndarray, bs_version: int,
                    device):
    """Encode b single-chunk streams on ``device`` in one cm_encode call.
    kanzi_tpu.ops.cm_jnp.cm_encode_batch's contract: streams [b, L] u8
    (rows padded past lens[b]); returns (bufs, low56, overflow): bufs[i]
    the stream's flush bytes (the host encoder's chunk buffer), low56[i]
    its final low | MASK_0_24 (the dispose value), overflow[i] whether it
    needed more than CAP = L + 64 words (then b"" and 0, and the caller
    codes it on the host). Only the words each stream wrote come back."""
    b, n = streams.shape
    cap = n + 64
    dev = torch.device(device)
    words, cnt, state = cm_encode(
        _to_device(streams, np.uint8, dev), _to_device(lens, np.int64, dev),
        cap, cm_init_state(b, bs_version, dev))
    cnt_h, low_h = _to_numpy(dev, cnt, state.low)
    nw = np.minimum(cnt_h, cap)
    used = words[:, :int(nw.max(initial=0))]
    wrote = torch.arange(used.shape[1], device=dev) < torch.from_numpy(
        nw).to(dev)[:, None]
    flat = _to_numpy(dev, used[wrote])[0].view(np.uint32).astype(">u4")
    ends = np.cumsum(nw)
    overflow = [bool(c > cap) for c in cnt_h]
    bufs = [b"" if ov else flat[e - k:e].tobytes()
            for ov, e, k in zip(overflow, ends, nw)]
    low56 = [0 if ov else int(lo) | MASK_0_24
             for ov, lo in zip(overflow, low_h)]
    return bufs, low56, overflow


# ---------------------------------------------------------------------------
# J. decode
# ---------------------------------------------------------------------------

def cm_decode_plain(pay, off, nw, cur, lens, state: CMState):
    """Plain version of the cm_decode kernel: the streams in lockstep, a
    Python loop over the output bytes and their 8 bits on [b] tensors.
    Returns (out [b, max(lens)] uint8, consumed [b] int64, state')."""
    b, dev = lens.shape[0], lens.device
    lens_h = lens.tolist()
    n_len, n_all = max(lens_h, default=0), min(lens_h, default=0)
    n_pay = pay.numel()
    payz = torch.cat([pay.long() & MASK_0_32,
                      torch.zeros(1, dtype=torch.int64, device=dev)])
    st = _Lockstep(state)
    out = torch.zeros((b, n_len), dtype=torch.uint8, device=dev)
    cur = cur.clone()
    widx = torch.zeros(b, dtype=torch.int64, device=dev)

    def word(widx):                 # the stream's word widx, 0 past its end
        return payz[torch.where(widx < nw, off + widx, n_pay)]

    nxt = word(widx)
    alive = None
    for i in range(n_len):
        if i >= n_all:              # some stream has ended
            alive = i < lens
            kept = st.low, st.high, st.c1, st.c2, st.rm, cur, widx, nxt
        st.begin_byte(alive)
        ctx = torch.ones(b, dtype=torch.int64, device=dev)
        for _ in range(8):
            mid, *touched = st.predict(ctx)
            bit = (mid >= cur).long()
            st.update(bit, mid, *touched)
            ctx = 2 * ctx + bit
            f, w = st.flush(alive)
            if w is not None:
                cur = torch.where(f, ((cur & MASK_0_24) << 32) | nxt, cur)
                widx = widx + f
                nxt = torch.where(f, word(widx), nxt)
        sym = ctx & 0xFF
        st.end_byte(ctx)
        if alive is not None:
            (st.low, st.high, st.c1, st.c2, st.rm, cur, widx, nxt) = _keep(
                alive, (st.low, st.high, st.c1, st.c2, st.rm, cur, widx,
                        nxt), kept)
            sym = torch.where(alive, sym, 0)
        out[:, i] = sym.to(torch.uint8)
    return out, widx, st.state()


def cm_decode(pay, off, nw, cur, lens, state: CMState):
    """Decode b single-chunk CM streams, one kernel block a stream, from
    ``state`` (not modified). pay [N] int32: u32 payload words, the
    big-endian words of each stream's payload bytes after its 7 priming
    bytes, its last partial word zero-padded on the right; stream s's
    are pay[off[s] : off[s] + nw[s]], and a read at or past nw[s] yields
    0, as the host decoder reads zero bytes past its payload; off, nw
    [b] int64; cur [b] int64, the 56-bit current primed from the 7
    bytes; lens [b] int64 output bytes, each below 2^26.

    Returns (out [b, max(lens)] uint8, zero past each stream's length;
    consumed [b] int64, the words each stream shifted in; the state each
    stream ends in)."""
    b, dev = lens.shape[0], lens.device
    _check("pay", pay, torch.int32, (pay.numel(),), dev)
    for name, t in (("off", off), ("nw", nw), ("cur", cur), ("lens", lens)):
        _check(name, t, torch.int64, (b,), dev)
    _check_state(state, b, dev)
    plain = _on_cpu("cm_decode", dev)
    if not bool(((lens >= 0) & (lens < MAX_STREAM) & (off >= 0) & (nw >= 0)
                 & (off + nw <= pay.numel())).all()):
        raise ValueError("cm_decode: a stream length outside [0, 2^26), or "
                         "a stream's words outside pay")
    if plain:
        return cm_decode_plain(pay, off, nw, cur, lens, state)
    n_len = int(lens.max()) if b else 0
    out = torch.zeros((b, n_len), dtype=torch.uint8, device=dev)
    consumed = torch.zeros(b, dtype=torch.int64, device=dev)
    end = CMState(*(t.clone() for t in state))
    _launch("cm_decode", dev, pay, off, nw, cur, lens, b, n_len, out,
            consumed, *end)
    return out, consumed, end


def flat_records(records) -> tuple:
    """Streams' CM chunks as the decoder reads them, records[s] =
    (primed current, the payload bytes after the 7 priming bytes), as
    cm_decode's flat arrays, numpy: (pay int32, off, nw, cur int64). A
    payload's last 1-3 bytes make a word zero-padded on the right, as the
    host decoder reads them."""
    nw = np.array([-(-len(x) // 4) for _, x in records], np.int64)
    pay = np.frombuffer(b"".join(x + bytes(-len(x) % 4)
                                 for _, x in records), ">u4")
    return (pay.astype(np.uint32).view(np.int32), np.cumsum(nw) - nw, nw,
            np.array([c for c, _ in records], np.int64))


def _decode_flat(flat, lens, bs_version: int, device) -> np.ndarray:
    """cm_decode on ``device`` over numpy flat arrays (flat_records'
    layout) and lens [b]: out [b, max(lens)] uint8 numpy."""
    dev = torch.device(device)
    pay, *rest = flat
    lens = np.asarray(lens, np.int64)
    out, _, _ = cm_decode(_to_device(pay, np.int32, dev),
                          *(_to_device(a, np.int64, dev)
                            for a in (*rest, lens)),
                          cm_init_state(len(lens), bs_version, dev))
    return _to_numpy(dev, out)[0]


def cm_decode_records(records, lens: np.ndarray, bs_version: int,
                      device) -> np.ndarray:
    """Decode b streams on ``device`` in one cm_decode call from their
    chunk records as the host parse reads them (flat_records' records),
    lens [b] the output bytes a stream. Returns out [b, max(lens)] uint8
    numpy, zero past each stream's length."""
    return _decode_flat(flat_records(records), lens, bs_version, device)


def cm_decode_batch(payload: np.ndarray, currents: np.ndarray,
                    lens: np.ndarray, bs_version: int,
                    device) -> np.ndarray:
    """Decode b streams on ``device`` in one cm_decode call.
    kanzi_tpu.ops.cm_jnp.cm_decode_batch's contract: payload [b, W] u32
    words after the 7 priming bytes (a read past W yields 0), currents
    [b] u64, lens [b]. Returns out [b, max(lens)] uint8 numpy."""
    b, w = payload.shape
    flat = (np.ascontiguousarray(payload, np.uint32).reshape(-1).view(
        np.int32), np.arange(b, dtype=np.int64) * w,
        np.full(b, w, np.int64), np.asarray(currents).astype(np.int64))
    return _decode_flat(flat, lens, bs_version, device)
