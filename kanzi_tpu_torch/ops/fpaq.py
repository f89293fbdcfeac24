"""Batched FPAQ binary arithmetic encode on a CUDA device.

The PyTorch counterpart of kanzi_tpu/ops/fpaq.py, bit-exact with it and
with the host coder (src/entropy/FPAQEncoder.{cpp,hpp}: 56-bit low/high,
probs[4][256] 16-bit P(bit = 1), a 32-bit flush whenever the top 32 bits
of low and high agree). The per-bit loop is sequential per stream, so
the batch axis is the streams: one per block of the writer's batch,
each coded from its first byte to its last.

Kept from kanzi_tpu: the framing of the encode batch. Each stream is
cut into windows of WIN_B input bytes; per window it reports its flush
word count and its ``low | MASK_0_24`` at the window's end, which is
what the container's chunk framing needs (the inter-chunk 56-bit
flushes fall on window ends). The bank context (previous byte >> 6)
resets to probs[0] at every ``chunk_bytes`` boundary; the probabilities
and low/high carry across (FPAQEncoder.cpp's per-chunk
``p = _probs[0]``). Both probability updates are the single form
``p - (p >> 6) + 1023 * bit``.

Not kept: the 28-bit limbs. ``((high - low) >> 8) * p`` is below
2^48 * 2^16 = 2^64, exact in the kernel's uint64; the plain version
splits it in two products below 2^56 to stay inside int64. Nor the
per-window cap on flush words (kanzi_tpu's CAPW, set by the TPU's
per-window compaction, past which the host re-encoded the block): each
stream here writes its flushes in order into its own region of the
output, sized REGION_W words a window; a stream that needs more is
launched again with a region of MAX_REGION_W words a window, which no
stream can outgrow (at most one flush per coded bit).

One hand-written CUDA kernel (csrc/fpaq.cu) behind ``fpaq_encode``,
with ``fpaq_encode_plain`` beside it (Pallas ``_fpaq_encode_kernel``).

The decode of many streams at once is the second kernel, H
(csrc/fpaq_dec.cu) behind ``fpaq_decode``, with ``fpaq_decode_plain``
beside it: the function kanzi_tpu computes in XLA with no Pallas kernel
(kanzi_tpu/ops/fpaq_jnp.py decode_batch_jnp), here every chunk of every
stream in one launch: from the host parse's chunk records
(``fpaq_decode_records``, which the level-6 mesh decode,
parallel.pipeline.decompress_l6_mesh, runs) or from decode_batch_jnp's
padded rows (``fpaq_decode_batch``). The container's FPAQ decode stays
on the host's native coder, as in kanzi_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from kanzi_tpu_torch.ops.ans import (_check, _host_tensor, _launch, _on_cpu,
                                     _to_device, _to_numpy, _u32_bits)

WIN_B = 512                  # input bytes per stream per window
REGION_W = WIN_B // 2        # flush words a window a stream's region holds
                             # on the first launch (16 bits per input
                             # byte; incompressible data needs ~8)
MAX_REGION_W = 8 * WIN_B     # the same on a second launch: one flush per
                             # coded bit at most
CHUNK_B = 4 * 1024 * 1024    # FPAQ chunk (FPAQEncoder.cpp DEFAULT_CHUNK_
                             # SIZE): the bank context resets here
NS = 64                      # streams per launch of the container's batch
MASK_0_24 = (1 << 24) - 1
MASK_0_32 = (1 << 32) - 1
MASK_0_56 = (1 << 56) - 1
PSCALE_HALF = 1 << 15
TABLE = 4 * 256              # probs[4][256], one row a stream


# ---------------------------------------------------------------------------
# G. encode
# ---------------------------------------------------------------------------

def fpaq_encode_plain(streams, lens, chunk_win: int, cap: int):
    """Plain version of the fpaq_encode kernel: the streams in lockstep,
    a Python loop over the bytes and their 8 bits on [S] tensors."""
    s, lp = streams.shape
    dev = streams.device
    n_win = lp // WIN_B
    chunk_bytes = chunk_win * WIN_B
    data = streams.long()
    lens = lens.long()
    sh = torch.arange(7, -1, -1, device=dev)           # bit k of a byte
    probs = torch.full((s, 1024), PSCALE_HALF, dtype=torch.int64, device=dev)
    low = torch.zeros(s, dtype=torch.int64, device=dev)
    high = torch.full((s,), MASK_0_56, dtype=torch.int64, device=dev)
    cnt = torch.zeros(s, dtype=torch.int64, device=dev)
    # column cap takes the words of streams that do not flush or are full
    words = torch.zeros((s, cap + 1), dtype=torch.int64, device=dev)
    win_cnt = torch.empty((s, n_win), dtype=torch.int64, device=dev)
    win_low = torch.empty((s, n_win), dtype=torch.int64, device=dev)
    max_len = int(lens.max()) if s else 0
    prev_cnt = cnt.clone()
    for i in range(lp):
        if i < max_len:
            # everything of byte i that does not depend on low/high
            alive = i < lens
            val = data[:, i]
            bank = (torch.zeros_like(val) if i % chunk_bytes == 0
                    else data[:, i - 1] >> 6)
            idx8 = (bank << 8)[:, None] | ((val | 256)[:, None] >> (sh + 1))
            bit8 = (val[:, None] >> sh) & 1
            one8 = alive[:, None] & (bit8 == 1)
            zero8 = alive[:, None] & (bit8 == 0)
            add8 = 1023 * bit8
            for k in range(8):
                idx = idx8[:, k:k + 1]
                p = probs.gather(1, idx)[:, 0]
                r8 = (high - low) >> 8
                t = (((r8 >> 24) * p) << 16) + (((r8 & MASK_0_24) * p) >> 8)
                high = torch.where(one8[:, k], low + t, high)
                low = torch.where(zero8[:, k], low + t + 1, low)
                probs.scatter_(1, idx, torch.where(
                    alive, p - (p >> 6) + add8[:, k], p)[:, None])
                flush = alive & (((low ^ high) >> 24) == 0)
                slot = torch.where(flush, cnt, cap).clamp_(max=cap)
                words.scatter_(1, slot[:, None], (high >> 24)[:, None])
                cnt += flush
                low = torch.where(flush, (low & MASK_0_24) << 32, low)
                high = torch.where(flush,
                                   ((high & MASK_0_24) << 32) | MASK_0_32,
                                   high)
        if (i + 1) % WIN_B == 0:
            w = i // WIN_B
            win_cnt[:, w] = cnt - prev_cnt
            win_low[:, w] = low | MASK_0_24
            prev_cnt = cnt.clone()
    return _u32_bits(words[:, :cap]), win_cnt.to(torch.int32), win_low


def fpaq_encode(streams, lens, chunk_win: int, cap: int):
    """streams [S, Lp] uint8 (Lp a multiple of WIN_B, rows zero past
    their length; 16-byte aligned on the card); lens [S] int64 stream
    lengths; chunk_win = FPAQ chunk bytes / WIN_B; cap = the words each
    stream's output region holds.

    Returns (words [S, cap] int32: each stream's flush words (u32 bits)
    from its start, zero after its last, those past cap dropped; win_cnt
    [S, Lp / WIN_B] int32 words per window, dropped ones included;
    win_low [S, Lp / WIN_B] int64 low | MASK_0_24 at each window's
    end)."""
    s, lp = streams.shape
    dev = streams.device
    if lp % WIN_B or chunk_win < 1 or cap < 0:
        raise ValueError(f"streams: length {lp} is not a multiple of "
                         f"{WIN_B}, or chunk_win {chunk_win} < 1, or cap "
                         f"{cap} < 0")
    _check("streams", streams, torch.uint8, (s, lp), dev)
    _check("lens", lens, torch.int64, (s,), dev)
    if _on_cpu("fpaq_encode", dev):
        return fpaq_encode_plain(streams, lens, chunk_win, cap)
    if s and not 0 <= int(lens.min()) <= int(lens.max()) <= lp:
        raise ValueError(f"lens: a stream length outside [0, {lp}]")
    if streams.data_ptr() % 16:
        raise ValueError("streams: the kernel reads 16-byte words; the "
                         "tensor must start on a 16-byte boundary")
    n_win = lp // WIN_B
    words = torch.zeros((s, cap), dtype=torch.int32, device=dev)
    win_cnt = torch.empty((s, n_win), dtype=torch.int32, device=dev)
    win_low = torch.empty((s, n_win), dtype=torch.int64, device=dev)
    _launch("fpaq_encode", dev, streams, lens, s, lp, chunk_win, cap, words,
            win_cnt, win_low)
    return words, win_cnt, win_low


# ---------------------------------------------------------------------------
# batch entry point
# ---------------------------------------------------------------------------

def fpaq_encode_batch(streams: np.ndarray, lens: np.ndarray,
                      chunk_bytes: int, device):
    """Encode b streams on ``device``. streams [b, L] u8 (rows padded
    past lens[b]). Returns (bufs, low56, win_words [b, n_win], win_low56
    [b, n_win]): bufs[i] = the stream's flush bytes (the reference
    encoder's _buf), low56[i] = its final low | MASK_0_24 (the dispose
    value). kanzi_tpu.ops.fpaq.fpaq_encode_batch's contract without its
    overflow list: every stream is coded on the device (those that
    outgrow a REGION_W region in a second launch). chunk_bytes = FPAQ
    chunk size (CHUNK_B on the wire; tests take smaller ones)."""
    if chunk_bytes % WIN_B:
        raise ValueError(f"chunk_bytes {chunk_bytes} is not a multiple of "
                         f"{WIN_B}")
    b, L = streams.shape
    lp = -(-max(L, 1) // WIN_B) * WIN_B
    n_win = lp // WIN_B
    sp = np.zeros((b, lp), np.uint8)
    sp[:, :L] = streams
    dev = torch.device(device)
    data = torch.from_numpy(sp).to(dev)
    lens_d = _host_tensor(lens, np.int64).to(dev)
    cw = chunk_bytes // WIN_B
    words, win_cnt, win_low = fpaq_encode(data, lens_d, cw, n_win * REGION_W)
    win_words = win_cnt.cpu().numpy().astype(np.int64)
    win_low = win_low.cpu().numpy().astype(np.uint64)
    total = win_words.sum(axis=1)
    fits = total <= n_win * REGION_W
    head = words[:, :int(total[fits].max(initial=0))].cpu().numpy()
    bufs = [head[i, :total[i]].view(np.uint32).astype(">u4").tobytes()
            if fits[i] else None for i in range(b)]
    over = np.nonzero(~fits)[0]
    if len(over):
        sel = torch.from_numpy(over).to(dev)
        words, _, _ = fpaq_encode(data[sel], lens_d[sel], cw,
                                  n_win * MAX_REGION_W)
        words = words[:, :int(total[over].max())].cpu().numpy()
        for j, i in enumerate(over):
            bufs[i] = words[j, :total[i]].view(np.uint32).astype(
                ">u4").tobytes()
    low56 = [int(x) for x in win_low[:, -1]]
    return bufs, low56, win_words, win_low


# ---------------------------------------------------------------------------
# H. decode
# ---------------------------------------------------------------------------

def fpaq_init_state(b: int, device="cpu") -> tuple:
    """The decoder's state at a block's start, for b streams: (low [b]
    int64 0, high [b] int64 MASK_0_56, probs [b, TABLE] int32
    PSCALE_HALF)."""
    return (torch.zeros(b, dtype=torch.int64, device=device),
            torch.full((b,), MASK_0_56, dtype=torch.int64, device=device),
            torch.full((b, TABLE), PSCALE_HALF, dtype=torch.int32,
                       device=device))


def fpaq_state_from_limbs(state, device="cpu") -> tuple:
    """kanzi_tpu's lockstep state (l_h, l_l, h_h, h_l, probs: 28-bit
    limbs [b] and probs [b, TABLE] as numpy, kanzi_tpu/ops/fpaq_jnp.py
    _init_state_jnp's layout; a sixth entry, decode_streams_np's
    current, is ignored) as this module's (low, high, probs) on
    ``device``."""
    l_h, l_l, h_h, h_l, probs = (np.asarray(x) for x in state[:5])

    def join(h, lo):
        v = (h.astype(np.int64) << 28) | lo.astype(np.int64)
        return torch.from_numpy(v).to(device)

    return (join(l_h, l_l), join(h_h, h_l),
            torch.from_numpy(probs.astype(np.int32)).to(device))


def fpaq_decode_plain(pay, chunk_off, chunk_nw, chunk_cur, first, lens,
                      chunk_bytes: int, low, high, probs):
    """Plain version of the fpaq_decode kernel: the streams in lockstep,
    a Python loop over the output bytes and their 8 bits on [b] tensors.
    A stream past its end codes on against a scratch table, and its
    state is put back after each byte. Returns (out [b, max(lens)]
    uint8, consumed [C] int64, low', high', probs')."""
    b, dev = lens.shape[0], lens.device
    lens_h = lens.tolist()
    n_len, n_all = max(lens_h, default=0), min(lens_h, default=0)
    n_pay, n_chunks = pay.numel(), chunk_off.numel()
    payz = torch.cat([pay.long() & MASK_0_32,
                      torch.zeros(1, dtype=torch.int64, device=dev)])
    # the table, and a scratch bank that the streams past their end use
    tbl = torch.cat([probs.long(), torch.zeros((b, 256), dtype=torch.int64,
                                               device=dev)], 1)
    out = torch.zeros((b, n_len), dtype=torch.uint8, device=dev)
    consumed = torch.zeros(n_chunks, dtype=torch.int64, device=dev)
    zero = torch.zeros(b, dtype=torch.int64, device=dev)
    nch = (lens + chunk_bytes - 1) // chunk_bytes

    def word(c, widx):              # the chunk's word widx, 0 past its end
        return payz[torch.where(widx < chunk_nw[c], chunk_off[c] + widx,
                                n_pay)]

    for i in range(n_len):
        k, at = divmod(i, chunk_bytes)
        c = (first + k).clamp(0, max(n_chunks - 1, 0))
        if at == 0:                 # a chunk starts: bank 0, its current
            cur, widx, bank = chunk_cur[c], zero, zero
            nxt = word(c, widx)
        base = bank << 8
        if i >= n_all:              # some stream has ended
            alive = i < lens
            base = torch.where(alive, base, TABLE)
            kept = low, high, cur, widx, nxt
        ctx = torch.ones_like(zero)
        for _ in range(8):
            idx = (base + ctx)[:, None]
            p = tbl.gather(1, idx)[:, 0]
            r8 = (high - low) >> 8
            split = low + (((r8 >> 24) * p) << 16) + (
                ((r8 & MASK_0_24) * p) >> 8)
            bit = split >= cur
            high = torch.where(bit, split, high)
            low = torch.where(bit, low, split + 1)
            bit = bit.long()
            tbl.scatter_(1, idx, (p - (p >> 6) + 1023 * bit)[:, None])
            ctx = 2 * ctx + bit
            flush = ((low ^ high) >> 24) == 0
            if bool(flush.any()):
                low = torch.where(flush, (low & MASK_0_24) << 32, low)
                high = torch.where(flush, ((high & MASK_0_24) << 32)
                                   | MASK_0_32, high)
                cur = torch.where(flush, ((cur & MASK_0_24) << 32) | nxt,
                                  cur)
                widx = widx + flush
                nxt = torch.where(flush, word(c, widx), nxt)
        sym = ctx & 0xFF
        bank = sym >> 6
        if i >= n_all:
            low, high, cur, widx, nxt = (
                torch.where(alive, new, old) for new, old in zip(
                    (low, high, cur, widx, nxt), kept))
            sym = torch.where(alive, sym, 0)
        out[:, i] = sym.to(torch.uint8)
        if at == chunk_bytes - 1 or i == n_len - 1:   # a chunk ends
            mine = k < nch
            consumed[c[mine]] = widx[mine]
    return out, consumed, low, high, tbl[:, :TABLE].to(torch.int32)


def fpaq_decode(pay, chunk_off, chunk_nw, chunk_cur, first, lens,
                chunk_bytes: int, state=None):
    """Decode b FPAQ streams, every chunk of every stream in one launch.
    pay [N] int32: u32 payload words (each chunk's bytes after its 7
    priming bytes as big-endian words; chunk c's are
    pay[chunk_off[c] : chunk_off[c] + chunk_nw[c]], and a read at or
    past chunk_nw[c] yields 0, as the host decoder shifts in a zero word
    once fewer than 4 payload bytes are left); chunk_off, chunk_nw
    [C] int64; chunk_cur [C] int64, each chunk's 56-bit current primed
    from its first 7 bytes; stream s has ceil(lens[s] / chunk_bytes)
    chunks, first[s], first[s] + 1, ... ([b] int64 each); state: the
    (low, high, probs) the streams start from (fpaq_init_state when
    None; not modified).

    Returns (out [b, max(lens)] uint8, zero past each stream's length;
    consumed [C] int64, the words each chunk shifted in; (low, high,
    probs), the state each stream ends in). The host decoders' payload
    overrun test (their byte index past size + 1) cannot fire, since the
    index stops at size + 1 once the words run out, so no caller tests
    consumed against it."""
    b, dev = lens.shape[0], lens.device
    n_chunks = chunk_off.shape[0]
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes {chunk_bytes} < 1")
    _check("pay", pay, torch.int32, (pay.numel(),), dev)
    for name, t in (("chunk_off", chunk_off), ("chunk_nw", chunk_nw),
                    ("chunk_cur", chunk_cur)):
        _check(name, t, torch.int64, (n_chunks,), dev)
    for name, t in (("first", first), ("lens", lens)):
        _check(name, t, torch.int64, (b,), dev)
    if state is None:
        state = fpaq_init_state(b, dev)
    low, high, probs = state
    _check("low", low, torch.int64, (b,), dev)
    _check("high", high, torch.int64, (b,), dev)
    _check("probs", probs, torch.int32, (b, TABLE), dev)
    plain = _on_cpu("fpaq_decode", dev)
    nch = (lens + chunk_bytes - 1) // chunk_bytes
    if not bool(((lens >= 0) & (first >= 0) & (first + nch <= n_chunks))
                .all() & ((chunk_off >= 0) & (chunk_nw >= 0)
                          & (chunk_off + chunk_nw <= pay.numel())).all()):
        raise ValueError("fpaq_decode: a stream's chunks or a chunk's words "
                         "outside their arrays")
    if plain:
        out, consumed, *state = fpaq_decode_plain(
            pay, chunk_off, chunk_nw, chunk_cur, first, lens, chunk_bytes,
            low, high, probs)
        return out, consumed, tuple(state)
    n_len = int(lens.max()) if b else 0
    out = torch.zeros((b, n_len), dtype=torch.uint8, device=dev)
    consumed = torch.zeros(n_chunks, dtype=torch.int64, device=dev)
    low, high, probs = low.clone(), high.clone(), probs.clone()
    _launch("fpaq_decode", dev, pay, chunk_off, chunk_nw, chunk_cur, first,
            lens, b, chunk_bytes, n_len, out, consumed, low, high, probs)
    return out, consumed, (low, high, probs)


def decode_layout(chunk_payloads, chunk_currents, lens,
                  chunk_bytes: int) -> tuple:
    """kanzi_tpu.ops.fpaq_jnp.decode_batch_jnp's inputs (see
    fpaq_decode_batch) as fpaq_decode's flat arrays, numpy: (pay int32,
    chunk_off, chunk_nw, chunk_cur, first, lens int64), the chunk
    records stream by stream, each chunk's words its row of
    chunk_payloads[k]."""
    lens = np.asarray(lens, np.int64)
    b = len(lens)
    nch = -(-lens // chunk_bytes)
    if b and int(nch.max()) > len(chunk_payloads):
        raise ValueError(f"a stream of {int(nch.max())} chunks, "
                         f"{len(chunk_payloads)} chunk payloads")
    widths = np.array([p.shape[1] for p in chunk_payloads], np.int64)
    base = np.cumsum(b * widths) - b * widths
    first = np.cumsum(nch) - nch
    s_idx = np.repeat(np.arange(b), nch)
    k_idx = np.arange(int(nch.sum())) - np.repeat(first, nch)
    chunk_cur = (np.stack(chunk_currents)[k_idx, s_idx].astype(np.int64)
                 if len(k_idx) else np.zeros(0, np.int64))
    pay = (np.concatenate([np.asarray(p, np.uint32).reshape(-1)
                           for p in chunk_payloads])
           if chunk_payloads else np.zeros(0, np.uint32))
    return (pay.view(np.int32), base[k_idx] + s_idx * widths[k_idx],
            widths[k_idx], chunk_cur, first, lens)


def flat_records(frames) -> tuple:
    """Streams' FPAQ chunks as the decoder reads them, frames[s] =
    [(primed current, the payload bytes after the 7 priming bytes)] a
    chunk, as fpaq_decode's flat arrays, numpy: (pay int32, chunk_off,
    chunk_nw, chunk_cur, first int64), the chunks stream by stream. A
    chunk holds its payload's whole big-endian words: the host decoder
    reads zero words once fewer than 4 payload bytes are left, never a
    payload's last size % 4 bytes."""
    recs = [rc for f in frames for rc in f]
    nw = np.array([len(x) // 4 for _, x in recs], np.int64)
    pay = np.frombuffer(b"".join(x[:4 * (len(x) // 4)] for _, x in recs),
                        ">u4").astype(np.uint32)
    nch = np.array([len(f) for f in frames], np.int64)
    return (pay.view(np.int32), np.cumsum(nw) - nw, nw,
            np.array([c for c, _ in recs], np.int64), np.cumsum(nch) - nch)


def _decode_flat(flat, lens, chunk_bytes: int, device) -> np.ndarray:
    """fpaq_decode on ``device`` over numpy flat arrays (flat_records'
    or decode_layout's) and lens [b]: out [b, max(lens)] uint8 numpy."""
    dev = torch.device(device)
    pay, *rest = flat
    out, _, _ = fpaq_decode(_to_device(pay, np.int32, dev),
                            *(_to_device(a, np.int64, dev)
                              for a in (*rest, np.asarray(lens, np.int64))),
                            chunk_bytes)
    return _to_numpy(dev, out)[0]


def fpaq_decode_records(frames, lens: np.ndarray, chunk_bytes: int,
                        device) -> np.ndarray:
    """Decode b streams on ``device`` in one launch of fpaq_decode from
    their chunk records as the host parse reads them (flat_records'
    frames), lens [b] the output bytes a stream. Returns out [b,
    max(lens)] uint8 numpy, zero past each stream's length."""
    return _decode_flat(flat_records(frames), lens, chunk_bytes, device)


def fpaq_decode_batch(chunk_payloads, chunk_currents, lens: np.ndarray,
                      chunk_bytes: int, device) -> np.ndarray:
    """Decode b streams on ``device`` in one launch of fpaq_decode.
    kanzi_tpu.ops.fpaq_jnp.decode_batch_jnp's contract:
    chunk_payloads[k] = [b, W_k] u32 payload words of chunk k (rows of
    streams with fewer than k + 1 chunks are unused, every row zero past
    its words), chunk_currents[k] = [b] u64 primed currents, lens [b]
    the output bytes a stream. Returns out [b, max(lens)] uint8 numpy,
    zero past each stream's length."""
    flat = decode_layout(chunk_payloads, chunk_currents, lens, chunk_bytes)
    return _decode_flat(flat[:5], flat[5], chunk_bytes, device)
