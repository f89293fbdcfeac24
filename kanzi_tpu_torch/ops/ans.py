"""Batched 4-lane interleaved range-ANS (order 0) on a CUDA device.

The PyTorch counterpart of kanzi_tpu/ops/ans.py, bit-exact with it and
with the reference coder (src/entropy/ANSRange{Encoder,Decoder}.cpp) for
full 16 KiB chunks. See that module's docstring for why the arithmetic
stays in 32 bits and how the lanes interleave.

Plain PyTorch does what the JAX package left to XLA: the per-chunk
histogram, frequency normalization, the per-symbol encode constants,
the header bit packing and the decode tables. Three hand-written CUDA
kernels (csrc/ans0.cu) do the rest, each behind a wrapper with a plain
PyTorch version beside it:

- ``ans0_encode_scan``: the 4-lane backward encode scan, tables gathered
  from shared memory (Pallas ``_gather_kernel`` + the ``lax.scan``).
- ``compact_rows``: each row's flagged renorm slots scattered into one
  flat payload stream (Pallas ``_compact_kernel``).
- ``ans0_decode``: the 4-lane forward decode (Pallas
  ``_ans0_decode_kernel``).

A wrapper launches its kernel for CUDA tensors and runs the plain
version only for CPU tensors. u32 quantities travel as int32 tensors
holding the same bits (torch has no general uint32 arithmetic); the
plain versions widen them to int64.
"""

from __future__ import annotations

import numpy as np
import torch

import kanzi_tpu_torch.ops as _ops
from kanzi_tpu_torch.ops import _build

LOG_RANGE = 12                    # order-0 default (ANSRangeEncoder.cpp:29)
SCALE = 1 << LOG_RANGE
MASK = SCALE - 1
ANS_TOP = 1 << 15
CHUNK = 16384                     # full order-0 chunk size
STEPS = CHUNK // 4
PAYLOAD_MAX = 2 * CHUNK           # <= 2 renorm bytes per symbol
TOTAL = CHUNK                     # histogram total for a full chunk
HDR_MAX_BITS = 4096               # worst case ~3.6 kbit per chunk header
_U32 = 0xFFFFFFFF


def from_numpy(arrays, device) -> tuple:
    """kanzi_tpu's numpy results (e.g. of ``encode_chunks_np`` or
    ``ans0_encode_chunks_padded`` here, of ``compute_code_tables`` or
    ``encode_chunks_np`` in kanzi_tpu.ops.huffman) as tensors on
    ``device``; uint32 arrays widen to int64."""
    return tuple(_host_tensor(a, np.int64 if a.dtype == np.uint32
                              else a.dtype).to(device)
                 for a in map(np.asarray, arrays))


def _host_tensor(a, dtype) -> torch.Tensor:
    """numpy -> CPU tensor, copying only a read-only or strided array."""
    a = np.ascontiguousarray(a, dtype=dtype)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _to_device(a, dtype, device: torch.device) -> torch.Tensor:
    """numpy -> tensor on ``device``; to a card through a pinned host
    buffer (the host's one copy of ``a``), without blocking."""
    if device.type != "cuda":
        return _host_tensor(a, dtype).to(device)
    a = np.asarray(a)
    staged = torch.empty(a.shape, pin_memory=True,
                         dtype=torch.from_numpy(np.empty(0, dtype)).dtype)
    np.copyto(staged.numpy(), a, casting="unsafe")
    return staged.to(device, non_blocking=True)


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """x on the card -> a pinned host tensor, copied without blocking:
    valid after the stream's next synchronisation."""
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return out.copy_(x, non_blocking=True)


def _to_numpy(device: torch.device, *ts) -> tuple:
    """Tensors on ``device`` -> numpy arrays; from a card through pinned
    host buffers and one wait."""
    if device.type != "cuda":
        return tuple(t.cpu().numpy() for t in ts)
    host = [_to_host(t) for t in ts]
    torch.cuda.current_stream(device).synchronize()
    return tuple(h.numpy() for h in host)


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Exact integer bit_length for 0 <= x < 2^13."""
    acc = torch.zeros_like(x)
    for i in range(13):
        acc += (x >= (1 << i)).long()
    return acc


# ---------------------------------------------------------------------------
# encode: histogram, normalization, per-symbol constants (plain torch)
# ---------------------------------------------------------------------------

def histogram(chunks: torch.Tensor) -> torch.Tensor:
    """[C, CHUNK] uint8 -> [C, 256] int64 per-chunk byte counts."""
    c = chunks.shape[0]
    rows = torch.arange(c, device=chunks.device)[:, None] * 256
    return torch.bincount((chunks.long() + rows).view(-1),
                          minlength=256 * c).view(c, 256)


def normalize(hist: torch.Tensor) -> torch.Tensor:
    """[C, 256] counts summing to TOTAL -> frequencies summing to SCALE.
    Batched port of kanzi_tpu.ops.ans._normalize_one (the reference's
    EntropyUtils::normalizeFrequencies error spreading)."""
    f = hist.long()
    present = f > 0
    sf = f * SCALE
    scaled = torch.where(sf <= TOTAL, 1, (sf + TOTAL // 2) // TOTAL) * present
    size = present.sum(1, keepdim=True)
    idx_max = scaled.argmax(1, keepdim=True)      # first max (lowest symbol)
    at_max = torch.zeros_like(present).scatter_(1, idx_max, True)
    sum_scaled = scaled.sum(1, keepdim=True)

    delta = sum_scaled - SCALE
    err_thr = scaled.gather(1, idx_max) >> 4
    easy = delta.abs() <= err_thr
    easy_freqs = scaled - delta * at_max

    # hard path: push err_thr onto idx_max, then spread the rest in up to
    # 5 rounds over the alphabet in symbol order
    neg = delta < 0
    d = torch.where(neg, delta + err_thr, delta - err_thr).abs()
    hard = scaled + torch.where(neg, err_thr, -err_thr) * at_max
    inc = torch.where(neg, 1, -1)
    for _ in range(5):
        elig = ((hard > 2) & present).long()
        adj = elig * ((elig.cumsum(1) - elig) < d)
        hard = hard + inc * adj
        d = d - adj.sum(1, keepdim=True)
    hard = torch.where(at_max, (hard.gather(1, idx_max) - d).clamp(min=1),
                       hard)

    out = torch.where(easy, easy_freqs, hard)
    out = torch.where(sum_scaled == SCALE, scaled, out)
    return torch.where(size == 1, SCALE * present, out)


def encode_tables(freqs: torch.Tensor):
    """Per-symbol encode constants (ANSEncSymbol::reset,
    ANSRangeEncoder.hpp:92-131) from [C, 256] normalized freqs.

    Returns (packed, inv), both [C, 256] int32 holding u32 bits:
    packed = bias<<16 | cmplFreq<<4 | (invShift - 31), inv = invFreq."""
    f = freqs.long()
    cum = f.cumsum(1) - f
    small = f < 2
    fx = f.clamp(min=2)
    shift = _bit_length(fx - 1)                     # ceil(log2 f), f >= 2
    inv = torch.where(small, _U32,
                      ((1 << (shift + 31)) + fx - 1) // fx)
    bias = torch.where(small, cum + SCALE - 1, cum)
    sprime = torch.where(small, 1, shift)
    packed = (bias << 16) | ((SCALE - f) << 4) | sprime
    return _u32_bits(packed), _u32_bits(inv)


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_cpu(kernel: str, device: torch.device) -> bool:
    """True for a CPU tensor (plain version); False for a CUDA tensor
    (kernel); raises for any other device."""
    if device.type == "cpu":
        _ops.count(kernel + "_plain")
        return True
    if device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {device}")
    return False


def _launch(kernel: str, device: torch.device, *args) -> None:
    """Call the kernel's C launcher on the current stream; raise on any
    launch error."""
    fn, lib = _build.kernel(kernel)
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*conv, device.index, stream)
    if rc != 0:
        msg = lib.kanzi_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: {msg} ({rc})")
    _ops.count(kernel)


# ---------------------------------------------------------------------------
# A. encode scan
# ---------------------------------------------------------------------------

def ans0_encode_scan_plain(chunks, packed, inv):
    """Plain version of the ans0_encode_scan kernel: the 4-lane backward
    scan as a Python loop over the 4096 steps on [C, 4] tensors."""
    c = chunks.shape[0]
    # step t, lane l encodes chunk[CHUNK-1 - 4t - l]
    sym = chunks.view(c, STEPS, 4).flip(1, 2).reshape(c, CHUNK).long()
    pk = packed.long().gather(1, sym).view(c, STEPS, 4)
    iv = (inv.long() & _U32).gather(1, sym).view(c, STEPS, 4)
    bias, cmpl, sp = pk >> 16, (pk >> 4) & 0xFFF, pk & 0xF
    xmax = (SCALE - cmpl) << (31 - LOG_RANGE)
    st = torch.full((c, 4), ANS_TOP, dtype=torch.int64, device=chunks.device)
    slots = torch.empty((c, STEPS, 4), dtype=torch.int64,
                        device=chunks.device)
    for t in range(STEPS):
        flag = st >= xmax[:, t]
        slots[:, t] = ((flag.long() << 16) | ((st & 0xFF) << 8)
                       | ((st >> 8) & 0xFF))
        st = torch.where(flag, st >> 16, st)
        st = st + bias[:, t] + (((st * iv[:, t]) >> 32) >> (sp[:, t] - 1)
                                ) * cmpl[:, t]
    # emission order: reversed steps x reversed lanes
    vm = slots.flip(1, 2).reshape(c, CHUNK)
    nren = (slots >> 16).sum(1)
    return st.to(torch.int32), vm.to(torch.int32), nren.to(torch.int32)


def ans0_encode_scan(chunks, packed, inv):
    """chunks [C, CHUNK] uint8; packed, inv [C, 256] int32 (encode_tables).

    Returns (states [C, 4] int32 final lane states, vm [C, CHUNK] int32
    renorm slots flag<<16 | lo<<8 | hi in emission order, nren [C, 4]
    int32 renorm count per lane)."""
    c, dev = chunks.shape[0], chunks.device
    _check("chunks", chunks, torch.uint8, (c, CHUNK), dev)
    _check("packed", packed, torch.int32, (c, 256), dev)
    _check("inv", inv, torch.int32, (c, 256), dev)
    if _on_cpu("ans0_encode_scan", dev):
        return ans0_encode_scan_plain(chunks, packed, inv)
    for name, t in (("chunks", chunks), ("packed", packed), ("inv", inv)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
    states = torch.empty((c, 4), dtype=torch.int32, device=dev)
    vm = torch.empty((c, CHUNK), dtype=torch.int32, device=dev)
    nren = torch.empty((c, 4), dtype=torch.int32, device=dev)
    _launch("ans0_encode_scan", dev, chunks, packed, inv, c, states, vm,
            nren)
    return states, vm, nren


# ---------------------------------------------------------------------------
# B. row compaction
# ---------------------------------------------------------------------------

def compact_rows_plain(vm, off16, total16: int):
    """Plain version of the ans0_compact kernel: cumsum ranks and
    one index assignment."""
    flag = ((vm >> 16) & 1).bool()
    fi = flag.long()
    dst = (off16[:, None] + fi.cumsum(1) - fi)[flag]
    w = (vm & 0xFFFF)[flag].long()
    keep = (dst >= 0) & (dst < total16)
    dst, w = dst[keep], w[keep]
    out = torch.empty(2 * total16, dtype=torch.uint8, device=vm.device)
    out[2 * dst] = (w & 0xFF).to(torch.uint8)
    out[2 * dst + 1] = (w >> 8).to(torch.uint8)
    return out


def compact_rows(vm, off16, total16: int):
    """vm [C, CHUNK] int32 (flag<<16 | u16); off16 [C] int64 destination
    offsets in u16 units, the exclusive cumsum of the rows' flag counts;
    total16 the sum of those counts. Returns the flat payload
    [2 * total16] uint8: row r's flagged u16s, little-endian, at
    off16[r] in order; a u16 whose place falls outside [0, total16) is
    dropped. The kernel needs vm 16-byte aligned, as a fresh allocation
    is."""
    c, dev = vm.shape[0], vm.device
    _check("vm", vm, torch.int32, (c, CHUNK), dev)
    _check("off16", off16, torch.int64, (c,), dev)
    if _on_cpu("ans0_compact", dev):
        return compact_rows_plain(vm, off16, total16)
    if vm.data_ptr() % 16:
        raise ValueError("vm: must be 16-byte aligned")
    out = torch.empty(2 * total16, dtype=torch.uint8, device=dev)
    _launch("ans0_compact", dev, vm, off16, c, total16, out)
    return out


# ---------------------------------------------------------------------------
# header packing (plain torch port of _pack_headers_device)
# ---------------------------------------------------------------------------

def pack_slots(vals: torch.Tensor, nbits: torch.Tensor):
    """Per-row bitstrings from (value, nbits <= 32) slot tables [C, S].
    Each slot lands in at most two 32-bit words; disjoint bits make OR ==
    ADD, so two scatter-adds assemble the rows. Returns (bytes
    [C, HDR_MAX_BITS/8] uint8, bitlen [C] int64)."""
    c = vals.shape[0]
    nw = HDR_MAX_BITS // 32
    starts = nbits.cumsum(1) - nbits
    w, b = starts >> 5, starts & 31
    over = (b + nbits - 32).clamp(min=0)
    v = vals & torch.where(nbits >= 32, _U32, (1 << nbits) - 1)
    c0 = torch.where(nbits > 0, torch.where(over > 0, v >> over,
                                            v << (32 - b - nbits)), 0)
    c1 = torch.where(over > 0, (v << (32 - over)) & _U32, 0)
    words = torch.zeros((c, nw + 1), dtype=torch.int64, device=vals.device)
    words.scatter_add_(1, torch.where(nbits > 0, w, nw), c0)
    words.scatter_add_(1, torch.where(over > 0, w + 1, nw), c1)
    sh = 24 - 8 * torch.arange(4, device=vals.device)
    hdr = ((words[:, :nw, None] >> sh) & 0xFF).to(torch.uint8)
    return hdr.view(c, HDR_MAX_BITS // 8), nbits.sum(1)


def pack_headers(freqs, states, plen, lr: int = LOG_RANGE):
    """Per-chunk ANS0 headers: 3b (lr-8) | encodeAlphabet | grouped
    log-packed freqs-1 | varint payload length | 4x32b states
    (ANSRangeEncoder.cpp:83-155 + the encodeChunk prologue); chunks whose
    alphabet has <= 1 symbol stop after the alphabet. Same wire layout as
    kanzi_tpu.ops.ans.pack_ans0_headers. Returns (hdr [C, 512] uint8,
    bitlen [C] int64, alphabet size m [C] int64)."""
    c, dev = freqs.shape[0], freqs.device
    f = freqs.long()
    present = f > 0
    pi = present.long()
    m = pi.sum(1)
    rank = pi.cumsum(1) - pi
    fbr = torch.zeros((c, 257), dtype=torch.int64, device=dev).scatter_(
        1, torch.where(present, rank, 256), f)[:, :256]    # freqs by rank
    last_sym = 255 - pi.flip(1).argmax(1)

    full = m == 256
    partial = ~full
    last_mask = last_sym >> 3
    mask_bytes = (pi.view(c, 32, 8)
                  << torch.arange(8, device=dev)).sum(2)

    ng, mk = 43, 8                                  # max groups / members
    chk = torch.where(m >= 64, 8, 6)[:, None, None]
    g = torch.arange(ng, device=dev)[None, :, None]
    k = torch.arange(mk, device=dev)[None, None, :]
    j = 1 + g * chk + k
    valid_mem = (k < chk) & (j < m[:, None, None])
    mem = fbr.gather(1, j.clamp(max=255).view(c, -1)).view(c, ng, mk)
    vals_mem = torch.where(valid_mem, mem - 1, 0)
    group_valid = (1 + g[:, :, 0] * chk[:, :, 0]) < m[:, None]
    logmax = _bit_length(vals_mem.amax(2)) * group_valid
    llr = int(lr).bit_length()

    multi = m > 1
    v = plen.long()
    var_n = torch.where(v < 128, 1, torch.where(v < 16384, 2, 3))
    var = torch.stack([
        torch.where(var_n == 1, v, 0x80 | (v & 0x7F)),
        torch.where(var_n == 2, v >> 7,
                    torch.where(var_n == 3, 0x80 | ((v >> 7) & 0x7F), 0)),
        torch.where(var_n == 3, v >> 14, 0)], 1)

    one = torch.ones_like(m)
    slot = torch.arange(32, device=dev)[None, :]
    vals = torch.cat([
        ((lr - 8) * one)[:, None], partial.long()[:, None],
        torch.zeros_like(m)[:, None], last_mask[:, None], mask_bytes,
        torch.cat([logmax[:, :, None], vals_mem], 2).view(c, -1),
        var, states.long() & _U32], 1)
    nbits = torch.cat([
        (3 * one)[:, None], one[:, None], full.long()[:, None],
        (5 * partial.long())[:, None],
        8 * (partial[:, None] & (slot <= last_mask[:, None])).long(),
        torch.cat([(llr * (group_valid & multi[:, None]).long())[:, :, None],
                   torch.where(valid_mem & (logmax[:, :, None] > 0)
                               & multi[:, None, None], logmax[:, :, None],
                               0)], 2).view(c, -1),
        8 * ((torch.arange(3, device=dev)[None, :] < var_n[:, None])
             & multi[:, None]).long(),
        (32 * multi.long())[:, None].expand(c, 4)], 1)
    hdr, bitlen = pack_slots(vals, nbits)
    return hdr, bitlen, m


# ---------------------------------------------------------------------------
# encode entry points
# ---------------------------------------------------------------------------

def encode_chunks(chunks: torch.Tensor):
    """Encode full 16 KiB chunks, 4 interleaved lanes each.

    chunks: [C, CHUNK] uint8 on the coding device. Returns (hdr [C, 512]
    uint8, bitlen [C], m [C], flat [total] uint8, plen [C]) where chunk
    c's payload is flat[off[c] : off[c] + plen[c]] with off the exclusive
    cumsum of plen; chunks whose alphabet has <= 1 symbol are header-only
    (plen 0). The contract of kanzi_tpu.ops.ans.encode_chunks_np."""
    freqs = normalize(histogram(chunks))
    packed, inv = encode_tables(freqs)
    states, vm, nren = ans0_encode_scan(chunks, packed, inv)
    plen16 = nren.long().sum(1)
    off16 = plen16.cumsum(0) - plen16
    flat = compact_rows(vm, off16, int(plen16.sum()))
    plen = 2 * plen16
    hdr, bitlen, m = pack_headers(freqs, states, plen)
    return hdr, bitlen, m, flat, plen


def encode_chunks_np(chunks: np.ndarray, device):
    """numpy-facing encode_chunks: chunks [C, CHUNK] uint8 go to
    ``device`` and only the headers and the compact payload come back,
    on a card both ways through pinned host buffers."""
    device = torch.device(device)
    return _to_numpy(device, *encode_chunks(
        _to_device(chunks, np.uint8, device)))


# ---------------------------------------------------------------------------
# C. decode
# ---------------------------------------------------------------------------

def decode_tables(freqs: torch.Tensor):
    """[C, 256] normalized freqs -> (f2s [C, SCALE] uint8 residue ->
    symbol, fc [C, 256] int32 = f | cumExc<<12), f clamped to SCALE-1 as
    the reference decoder does."""
    c = freqs.shape[0]
    f = freqs.long().clamp(max=SCALE - 1)
    cum_inc = f.cumsum(1)
    q = torch.arange(SCALE, device=freqs.device).expand(c, SCALE)
    f2s = torch.searchsorted(cum_inc, q.contiguous(), right=True)
    fc = f | ((cum_inc - f) << 12)
    return f2s.clamp_(max=255).to(torch.uint8), fc.to(torch.int32)


def ans0_decode_plain(f2s, fc, states, pay, off_bytes):
    """Plain version of the ans0_decode kernel: a Python loop over the
    4096 steps on [C, 4] tensors, same u32 wrap-around and the same
    zero read past the end of the payload."""
    c, dev = f2s.shape[0], f2s.device
    n_pay = pay.numel()
    payz = torch.cat([pay.long(), torch.zeros(1, dtype=torch.int64,
                                              device=dev)])
    f2s_l = f2s.long()
    fcl = fc.long() & _U32
    st = states.long() & _U32
    cur = torch.zeros(c, dtype=torch.int64, device=dev)
    out = torch.empty((c, STEPS, 4), dtype=torch.uint8, device=dev)
    for t in range(STEPS):
        v = st & MASK
        sym = f2s_l.gather(1, v)
        e = fcl.gather(1, sym)
        st = ((e & 0xFFF) * (st >> LOG_RANGE) + v - (e >> 12)) & _U32
        fi = (st < ANS_TOP).long()
        # lanes consume pairs in order 3,2,1,0: offset = count above
        above = fi.flip(1).cumsum(1).flip(1) - fi
        p = off_bytes[:, None] + cur[:, None] + 2 * above
        b0 = payz[torch.where((p >= 0) & (p < n_pay), p, n_pay)]
        b1 = payz[torch.where((p >= 0) & (p + 1 < n_pay), p + 1, n_pay)]
        st = torch.where(fi.bool(), ((st << 16) | (b0 << 8) | b1) & _U32, st)
        cur += 2 * fi.sum(1)
        out[:, t] = sym.flip(1).to(torch.uint8)   # position 4t+j: lane 3-j
    return out.view(c, CHUNK), cur.to(torch.int32)


def ans0_decode(f2s, fc, states, pay, off_bytes):
    """f2s [C, SCALE] uint8, fc [C, 256] int32 (decode_tables); states
    [C, 4] int32 (u32 bits); pay [N] uint8, every chunk's payload back to
    back; off_bytes [C] int64 start of each chunk's payload in pay.
    Returns (symbols [C, CHUNK] uint8, consumed payload bytes [C]
    int32). A byte of pay before 0 or at or past its end reads 0. The
    kernel needs f2s and fc 16-byte aligned, as a fresh allocation is;
    pay may start anywhere."""
    c, dev = f2s.shape[0], f2s.device
    _check("f2s", f2s, torch.uint8, (c, SCALE), dev)
    _check("fc", fc, torch.int32, (c, 256), dev)
    _check("states", states, torch.int32, (c, 4), dev)
    _check("pay", pay, torch.uint8, (pay.numel(),), dev)
    _check("off_bytes", off_bytes, torch.int64, (c,), dev)
    if _on_cpu("ans0_decode", dev):
        return ans0_decode_plain(f2s, fc, states, pay, off_bytes)
    for name, t in (("f2s", f2s), ("fc", fc)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
    out = torch.empty((c, CHUNK), dtype=torch.uint8, device=dev)
    consumed = torch.empty(c, dtype=torch.int32, device=dev)
    _launch("ans0_decode", dev, f2s, fc, states, pay, pay.numel(),
            off_bytes, c, out, consumed)
    return out, consumed


def ans0_decode_flat(freqs: np.ndarray, states: np.ndarray,
                     flat_pay: np.ndarray, off_bytes: np.ndarray, device):
    """freqs [C, 256]; states [C, 4] uint32; flat_pay [total] uint8 (all
    chunks' payloads back to back); off_bytes [C] byte offsets. Returns
    (chunks [C, CHUNK] uint8, consumed bytes [C]) as numpy arrays. The
    contract of kanzi_tpu.ops.ans.ans0_decode_flat. On a card the inputs
    go up and the outputs come down through pinned host buffers."""
    device = torch.device(device)
    f2s, fc = decode_tables(_to_device(freqs, np.int64, device))
    st = _to_device(np.asarray(states, np.uint32).view(np.int32), np.int32,
                    device)
    return _to_numpy(device, *ans0_decode(
        f2s, fc, st, _to_device(flat_pay, np.uint8, device),
        _to_device(off_bytes, np.int64, device)))
