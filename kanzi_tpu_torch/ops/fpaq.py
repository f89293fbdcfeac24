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
Decode stays on the host's native coder, as in kanzi_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from kanzi_tpu_torch.ops.ans import (_check, _host_tensor, _launch, _on_cpu,
                                     _u32_bits)

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
