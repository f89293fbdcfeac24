"""Batched canonical-Huffman chunk encode/decode on a CUDA device.

The PyTorch counterpart of kanzi_tpu/ops/huffman.py, bit-exact with it
and with the host coder (src/entropy/Huffman{Common,Encoder,Decoder}.cpp)
for full 16 KiB chunks. A chunk splits into 4 fragments of 4096 symbols
(HuffmanEncoder.cpp:348-421), each its own MSB-first bitstream; the 4
fragments are the 4 lanes of every scan here.

Plain PyTorch does what the JAX package left to XLA: the header bit
packing and the decode tables, and, as the plain half of kernel D, the
code tables (the reference's in-place Moffat-Katajainen construction,
HuffmanEncoder.cpp:246-300, batched over chunks, its length limit as a
Python loop over the chunks that need it, and the canonical codes).
Three hand-written CUDA kernels (csrc/huffman.cu) do the rest, each
behind a wrapper with a plain PyTorch version beside it:

- ``huff_encode_scan`` (D): ``huff_code_tables``, the code tables of
  each chunk from its histogram, its code lengths limited to 12 bits,
  and each fragment's bit count (the prologue), then ``huff_pack``,
  every fragment's codes straight into the flat pair stream at offsets
  cumsummed from those counts, one warp a fragment (Pallas
  ``_gather_kernel1`` + the ``lax.scan`` + the compaction).
- ``huff_decode``: the 4-fragment decode, one thread a fragment, its
  bits in a 64-bit buffer refilled through selects from a ring of its
  stream's words in shared memory, the direct 12-bit prefix table split
  into a length table and a symbol table there (Pallas
  ``_huff_decode_kernel``).

The Huffman encode launches no compaction (kernel B). A chunk whose
Moffat-Katajainen code runs past MAX_SYMBOL_SIZE bits has its lengths
limited here, by the reference's bit-debt repayment (HuffmanEncoder.cpp:
129-215) and its slow path, as the host coder does, so every chunk of
more than one symbol is coded here (ok); a chunk of one symbol has only
its header.
"""

from __future__ import annotations

import numpy as np
import torch

from kanzi_tpu_torch.ops.ans import (_U32, _bit_length, _check, _launch,
                                     _on_cpu, _to_device, _to_host,
                                     _to_numpy, _u32_bits, histogram,
                                     pack_slots)

CHUNK = 16384
FRAG = CHUNK // 4
MAX_SYMBOL_SIZE = 12
TABLE = 1 << MAX_SYMBOL_SIZE
FRAG_MAX_BYTES = MAX_SYMBOL_SIZE * FRAG // 8   # 4096 codes of <= 12 bits
LIMIT_SCALE = CHUNK >> 3    # the length limit's slow path renormalises to it


# ---------------------------------------------------------------------------
# code tables (plain torch)
# ---------------------------------------------------------------------------

def _code_lengths(fbr: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Moffat-Katajainen code lengths batched over chunks: the port of
    kanzi_tpu.ops.huffman._code_lengths_one. fbr [C, 256] frequencies by
    rank, ascending (entries >= n arbitrary); n [C] alphabet sizes.
    Returns lengths by rank [C, 256] (valid for ranks < n, n >= 2)."""
    c, dev = fbr.shape[0], fbr.device
    data = fbr.clone()
    s = torch.zeros(c, dtype=torch.int64, device=dev)
    r = torch.zeros_like(s)
    # phase 1: in-place tree build; step t is live while t < n - 1
    for t in range(max(int(n.max()) - 1, 0) if c else 0):
        d, ss, rr = data, s, r
        total = torch.zeros_like(s)
        for _ in range(2):
            dr = d.gather(1, rr.clamp(max=255)[:, None])[:, 0]
            ds = d.gather(1, ss.clamp(max=255)[:, None])[:, 0]
            use_r = (ss >= n) | ((rr < t) & (dr < ds))
            total = total + torch.where(use_r, dr, ds)
            idx = torch.where(use_r, rr, ss).clamp(max=255)[:, None]
            cur = d.gather(1, idx)[:, 0]
            new = torch.where(use_r, t, torch.where(ss > t, 0, cur))
            d = d.scatter(1, idx, new[:, None])
            rr = rr + use_r.long()
            ss = ss + (~use_r).long()
        d = d.clone()
        d[:, t] = total
        live = t < n - 1
        data = torch.where(live[:, None], d, data)
        s = torch.where(live, ss, s)
        r = torch.where(live, rr, r)

    # phase 2: internal-node depths -> leaf code lengths (in reverse)
    idx = torch.arange(256, device=dev)[None, :]
    nn, top = n.clone(), n - 2
    depth = torch.ones_like(s)
    nal = torch.full_like(s, 2)
    for _ in range(64):
        active = nn > 0
        if not bool(active.any()):
            break
        mask = (idx < top[:, None]) & (data < top[:, None])
        k = torch.where(mask, idx + 1, 0).amax(1)
        internal = top - k
        newn = nn - torch.where(active, nal - internal, 0)
        fill = active[:, None] & (idx >= newn[:, None]) & (idx < nn[:, None])
        data = torch.where(fill, depth[:, None], data)
        nn = newn
        top = torch.where(active, k, top)
        depth = depth + active.long()
        nal = torch.where(active, 2 * internal, nal)
    return data


def _repay_debt(ln: list) -> int:
    """The bit-debt repayment (HuffmanEncoder.cpp:129-215) on one
    chunk's lengths by rank ln (non-increasing, the first over
    MAX_SYMBOL_SIZE), in place. The ranks at 12 bits or more are clamped
    to 12 and their excess is the debt; the ranks that follow, while the
    debt covers 2^idx with idx = 11 - length <= 5, are the reference's six
    lists, one run of consecutive ranks each (lengths fall with the
    rank), kept as [head, end). Each repayment lengthens a code by one
    bit, from the top list down, then from the bottom list up. Returns
    the debt left: > 0 sends the chunk to the slow path."""
    n, debt = 0, 0
    while ln[n] >= MAX_SYMBOL_SIZE:
        debt += ln[n] - MAX_SYMBOL_SIZE
        ln[n] = MAX_SYMBOL_SIZE
        n += 1
    head, end = [n] * 6, [n] * 6
    while n < len(ln):
        idx = MAX_SYMBOL_SIZE - 1 - ln[n]
        if idx > 5 or debt < 1 << idx:
            break
        if head[idx] == end[idx]:
            head[idx] = n
        end[idx] = n + 1
        n += 1
    for idx in range(5, -1, -1):
        while debt >= 1 << idx and head[idx] < end[idx]:
            ln[head[idx]] += 1
            debt -= 1 << idx
            head[idx] += 1
    for idx in range(6):
        while debt > 0 and head[idx] < end[idx]:
            ln[head[idx]] += 1
            debt -= 1 << idx
            head[idx] += 1
    return debt


def _slow_path_lengths(h: torch.Tensor):
    """The slow path of the limit (HuffmanEncoder.cpp:193-213): one
    chunk's counts h [256] renormalised to LIMIT_SCALE
    (EntropyUtils::normalizeFrequencies), ranked again and given new
    Moffat-Katajainen lengths, 8 bits each if those still run past
    MAX_SYMBOL_SIZE. Returns (lengths by rank, symbols by rank) as lists
    of the m present symbols."""
    from kanzi_tpu_torch.entropy.utils import normalize_frequencies
    f = h.long().cpu().numpy().copy()
    normalize_frequencies(f, 256, int(f.sum()), LIMIT_SCALE)
    keys = sorted((int(f[s]) << 8) | s for s in np.nonzero(f)[0].tolist())
    fbr = torch.tensor([k >> 8 for k in keys] + [0] * (256 - len(keys)))
    ln = _code_lengths(fbr[None], torch.tensor([len(keys)]))[0]
    ln = ln[:len(keys)].tolist()
    if max(ln) > MAX_SYMBOL_SIZE:
        ln = [8] * len(keys)
    return ln, [k & 0xFF for k in keys]


def limit_code_lengths(lens, sbr, m, hist):
    """The length limit of every chunk whose code runs past
    MAX_SYMBOL_SIZE bits, as the host coder applies it
    (entropy.huffman._limit_code_lengths): lens [C, 256] lengths by rank
    (_code_lengths), sbr [C, 256] symbols by rank, m [C] alphabet sizes,
    hist [C, 256] counts. A Python loop over those chunks only. Returns
    (lens, sbr, slow [C] bool): the limited lengths by rank, the symbols
    by rank (new ranks for a chunk of the slow path), and the chunks
    whose debt was left after both repayment passes."""
    slow = torch.zeros(m.shape, dtype=torch.bool)
    over = ((m > 1) & (lens[:, 0] > MAX_SYMBOL_SIZE)).cpu()
    if not bool(over.any()):
        return lens, sbr, slow.to(m.device)
    lens, sbr = lens.clone(), sbr.clone()
    for c in over.nonzero()[:, 0].tolist():
        n = int(m[c])
        ln = lens[c, :n].tolist()
        if _repay_debt(ln) > 0:
            slow[c] = True
            ln, syms = _slow_path_lengths(hist[c])
            sbr[c, :n] = torch.tensor(syms, device=sbr.device)
        lens[c, :n] = torch.tensor(ln, device=lens.device)
    return lens, sbr, slow.to(m.device)


def code_lengths_by_rank(hist: torch.Tensor):
    """hist [C, 256] -> (lens, sbr, m): each chunk's Moffat-Katajainen
    code lengths by rank (before the limit), its symbols by rank
    (ascending freq << 8 | sym), [C, 256] int64 each, valid for ranks
    < m, and m [C] its alphabet size."""
    f = hist.long()
    present = f > 0
    m = present.sum(1)
    syms = torch.arange(256, device=f.device)[None, :]
    key = torch.where(present, (f << 8) | syms, 2 ** 31 - 1).sort(1).values
    return _code_lengths(key >> 8, m), key & 0xFF, m


def compute_code_tables(hist: torch.Tensor):
    """hist [C, 256] -> (codes [C, 256] int64 packed len<<12 | code,
    sizes [C, 256], maxlen [C], m [C]), all int64; the contract of
    kanzi_tpu.ops.huffman.compute_code_tables, with the lengths of a
    chunk past MAX_SYMBOL_SIZE bits limited (limit_code_lengths), so
    maxlen <= 12 and the tables are the host coder's for every chunk of
    more than one symbol. (kanzi_tpu's leave such a chunk unlimited, not
    ok, for its host coder.)

    The canonical codes come from the per-length counting construction,
    which matches the reference's (size, symbol)-sorted walk
    (HuffmanCommon.cpp:29-70)."""
    c, dev = hist.shape[0], hist.device
    f = hist.long()
    present = f > 0
    lens, sbr, m = code_lengths_by_rank(f)
    lens, sbr, _ = limit_code_lengths(lens, sbr, m, f)
    syms = torch.arange(256, device=dev)[None, :]
    valid_rank = syms < m[:, None]
    maxlen = torch.where(valid_rank, lens, 0).amax(1)
    sizes = torch.zeros((c, 257), dtype=torch.int64, device=dev).scatter_(
        1, torch.where(valid_rank, sbr, 256), lens)[:, :256]

    ln = sizes.clamp(max=MAX_SYMBOL_SIZE + 1)
    counts = torch.zeros((c, MAX_SYMBOL_SIZE + 2), dtype=torch.int64,
                         device=dev).scatter_add_(
        1, torch.where(present, ln, MAX_SYMBOL_SIZE + 1),
        torch.ones_like(ln))
    # first_code[l] = (first_code[l-1] + counts[l-1]) << 1
    first = [torch.zeros_like(m)]
    for lv in range(MAX_SYMBOL_SIZE + 1):
        first.append((first[-1] + counts[:, lv]) << 1)
    first_code = torch.stack(first, 1)
    # rank among the symbols of the same length, in symbol order
    same_len_rank = torch.zeros_like(sizes)
    for lv in range(1, MAX_SYMBOL_SIZE + 1):
        is_l = (present & (ln == lv)).long()
        same_len_rank = torch.where(is_l.bool(), is_l.cumsum(1) - is_l,
                                    same_len_rank)
    codes = first_code.gather(1, ln) + same_len_rank
    packed = torch.where(present, ((ln << 12) | codes) & _U32, 0)
    return packed, sizes, maxlen, m


# ---------------------------------------------------------------------------
# D. encode scan
# ---------------------------------------------------------------------------

def _scan_plain(chunks, codes, ok):
    """The 4-fragment scan as a Python loop over the 4096 steps on [C, 4]
    tensors. Shifts by 32 bits or more give 0, as XLA's do (only codes of
    not-ok chunks reach such lengths)."""
    c = chunks.shape[0]
    x = codes.long().gather(1, chunks.long()).view(c, 4, FRAG)
    code = (x & 0xFFF).unbind(2)
    ln = (x >> 12).unbind(2)
    acc = torch.zeros((c, 4), dtype=torch.int64, device=chunks.device)
    nb = torch.zeros_like(acc)
    npairs = torch.zeros_like(acc)
    slots = torch.empty((c, 4, FRAG), dtype=torch.int64,
                        device=chunks.device)
    for t in range(FRAG):
        acc = ((acc << ln[t].clamp(max=32)) & _U32) | code[t]
        nb = nb + ln[t]
        flag = nb >= 16
        sh = (nb - 16).clamp(min=0, max=32)
        out16 = (acc >> sh) & 0xFFFF
        keep = torch.where(sh >= 32, _U32, (1 << sh.clamp(max=31)) - 1)
        acc = torch.where(flag, acc & keep, acc)
        nb = torch.where(flag, nb - 16, nb)
        npairs += flag.long()
        slots[:, :, t] = ((flag.long() << 16) | ((out16 & 0xFF) << 8)
                          | (out16 >> 8))
    vm = torch.where(ok[:, None, None], slots, 0).view(c, CHUNK)
    npairs = torch.where(ok[:, None], npairs, 0)
    return (vm.to(torch.int32), _u32_bits(acc), nb.to(torch.int32),
            npairs.to(torch.int32))


def huff_code_tables_plain(chunks, hist):
    """Plain version of D's prologue kernel: compute_code_tables, ok, and
    each fragment's bit count (the sum of its symbols' code lengths,
    code >> 12 as the scan reads them)."""
    codes, sizes, maxlen, m = compute_code_tables(hist)
    ok = (m > 1) & (maxlen <= MAX_SYMBOL_SIZE)
    ln = (codes >> 12).gather(1, chunks.long())
    bits = ln.view(-1, 4, FRAG).sum(2)
    return (codes.to(torch.int32), sizes.to(torch.int32),
            maxlen.to(torch.int32), m.to(torch.int32), ok,
            bits.to(torch.int32))


def huff_pack_plain(chunks, codes, ok, off16):
    """Plain version of D's pack kernel: the scan (_scan_plain), then
    each fragment's flagged slots' pairs, in order, into a zeroed flat
    buffer at its offset off16."""
    c, dev = chunks.shape[0], chunks.device
    vm, acc, nb, npairs = _scan_plain(chunks, codes, ok)
    flags = ((vm >> 16) & 1).view(c, 4, FRAG).long()
    dest = (off16[:, :, None] + flags.cumsum(2) - flags).view(c, CHUNK)
    sel = flags.view(c, CHUNK).bool()
    slots = torch.zeros(2 * FRAG_MAX_BYTES * c, dtype=torch.int64,
                        device=dev)
    slots[dest[sel]] = (vm & 0xFFFF)[sel].long()        # lo << 8 | hi
    flat = torch.stack([slots & 0xFF, slots >> 8], 1).view(-1)
    return flat.to(torch.uint8), acc, nb, npairs


def huff_code_tables(chunks, hist):
    """D's prologue. chunks [C, CHUNK] uint8; hist [C, 256] int64 their
    byte counts (histogram). Returns (codes [C, 256] int32 packed
    len<<12 | code, sizes [C, 256], maxlen [C] and m [C] int32:
    compute_code_tables's; ok [C] bool, the chunks coded here (m > 1,
    maxlen <= 12); bits [C, 4] int32 each fragment's bit count)."""
    c, dev = chunks.shape[0], chunks.device
    _check("chunks", chunks, torch.uint8, (c, CHUNK), dev)
    _check("hist", hist, torch.int64, (c, 256), dev)
    if _on_cpu("huff_code_tables", dev):
        return huff_code_tables_plain(chunks, hist)
    if chunks.data_ptr() % 16:
        raise ValueError("chunks: must be 16-byte aligned")
    codes, sizes = (torch.empty((c, 256), dtype=torch.int32, device=dev)
                    for _ in range(2))
    maxlen, m = (torch.empty(c, dtype=torch.int32, device=dev)
                 for _ in range(2))
    ok = torch.empty(c, dtype=torch.bool, device=dev)
    bits = torch.empty((c, 4), dtype=torch.int32, device=dev)
    _launch("huff_code_tables", dev, chunks, hist, c, codes, sizes, maxlen,
            m, ok, bits)
    return codes, sizes, maxlen, m, ok, bits


def pair_offsets(ok, bits):
    """ok [C] bool and bits [C, 4] int32 (huff_code_tables) -> off16
    [C, 4] int64, where each fragment's pairs start in the flat stream:
    the exclusive cumsum, fragment-minor, of its pair count (bits >> 4 on
    ok rows, else 0)."""
    n = torch.where(ok[:, None], bits >> 4, 0).long().view(-1)
    return (n.cumsum(0) - n).view(bits.shape)


def huff_pack(chunks, codes, ok, off16):
    """D's pack. chunks [C, CHUNK] uint8; codes [C, 256] int32 and ok [C]
    bool (huff_code_tables); off16 [C, 4] int64 (pair_offsets; the pack
    writes where it says, so it must be that cumsum). Returns (flat
    [C * 4 * FRAG_MAX_BYTES] uint8, the pair stream: fragment f of ok
    chunk c has its npairs[c, f] 16-bit pairs, bytes (hi, lo), at byte
    2 * off16[c, f]; the bytes past the last pair are unspecified, the
    buffer being allocated at its upper bound, 12 bits a symbol, so that
    no host sync sizes it; acc [C, 4] int32 (u32 bits) and nb [C, 4]
    int32, the nb < 16 bits left in each fragment's accumulator, for
    every row; npairs [C, 4] int32 pairs per fragment, bits >> 4 for ok
    rows, else 0)."""
    c, dev = chunks.shape[0], chunks.device
    _check("chunks", chunks, torch.uint8, (c, CHUNK), dev)
    _check("codes", codes, torch.int32, (c, 256), dev)
    _check("ok", ok, torch.bool, (c,), dev)
    _check("off16", off16, torch.int64, (c, 4), dev)
    if _on_cpu("huff_pack", dev):
        return huff_pack_plain(chunks, codes, ok, off16)
    if chunks.data_ptr() % 16:
        raise ValueError("chunks: must be 16-byte aligned")
    flat = torch.empty(4 * FRAG_MAX_BYTES * c, dtype=torch.uint8, device=dev)
    acc, nb, npairs = (torch.empty((c, 4), dtype=torch.int32, device=dev)
                       for _ in range(3))
    _launch("huff_pack", dev, chunks, codes, ok, off16, c, flat, acc, nb,
            npairs)
    return flat, acc, nb, npairs


def huff_encode_scan(chunks, hist):
    """Kernel D: chunks [C, CHUNK] uint8; hist [C, 256] int64 their byte
    counts (histogram). Returns (codes, sizes, maxlen, m, ok) of
    huff_code_tables, off16 of pair_offsets, then (flat, acc, nb,
    npairs) of huff_pack, as (codes, sizes, maxlen, m, ok, flat, off16,
    acc, nb, npairs): the prologue, a cumsum, the pack."""
    codes, sizes, maxlen, m, ok, bits = huff_code_tables(chunks, hist)
    off16 = pair_offsets(ok, bits)
    flat, acc, nb, npairs = huff_pack(chunks, codes, ok, off16)
    return codes, sizes, maxlen, m, ok, flat, off16, acc, nb, npairs


# ---------------------------------------------------------------------------
# headers (plain torch port of _pack_huff_headers)
# ---------------------------------------------------------------------------

def pack_huff_headers(sizes, m, ok, frag_bits):
    """Per-chunk Huffman headers: alphabet (encodeAlphabet), code
    lengths as signed exp-Golomb deltas from 2 (HuffmanEncoder.cpp:
    112-126) and, for ok chunks, the 4 fragment bit counts as varints.
    Returns (hdr [C, 512] uint8, bitlen [C] int64)."""
    c, dev = sizes.shape[0], sizes.device
    present = sizes > 0
    pi = present.long()
    rank = pi.cumsum(1) - pi
    szr = torch.zeros((c, 257), dtype=torch.int64, device=dev).scatter_(
        1, torch.where(present, rank, 256), sizes.long())[:, :256]
    prev = torch.cat([torch.full((c, 1), 2, dtype=torch.int64, device=dev),
                      szr[:, :-1]], 1)
    delta = (szr - prev) & 0xFF
    v = torch.where(delta < 128, delta, 256 - delta)
    sgn = (delta >= 128).long()
    log2 = _bit_length(v + 1) - 1
    eg_bits = torch.where(delta == 0, 1, ((v + 1) << 1) | sgn)
    in_alpha = torch.arange(256, device=dev)[None, :] < m[:, None]
    eg_len = torch.where(in_alpha, torch.where(delta == 0, 1, 2 * log2 + 2),
                         0)

    full = m == 256
    partial = ~full
    last_mask = (255 - pi.flip(1).argmax(1)) >> 3
    mask_bytes = (pi.view(c, 32, 8) << torch.arange(8, device=dev)).sum(2)

    x = frag_bits.long()
    n3 = torch.where(x < 128, 1, torch.where(x < 16384, 2, 3))
    vb = torch.stack([
        torch.where(n3 == 1, x, 0x80 | (x & 0x7F)),
        torch.where(n3 == 2, x >> 7,
                    torch.where(n3 == 3, 0x80 | ((x >> 7) & 0x7F), 0)),
        torch.where(n3 == 3, x >> 14, 0)], 2).view(c, 12)
    vn = 8 * ((torch.arange(3, device=dev) < n3[:, :, None])
              & ok[:, None, None]).long().view(c, 12)

    zero = torch.zeros_like(m)
    vals = torch.cat([torch.stack([partial.long(), zero, last_mask], 1),
                      mask_bytes, eg_bits, vb], 1)
    nbits = torch.cat([
        torch.stack([torch.ones_like(m), full.long(), 5 * partial.long()],
                    1),
        8 * (partial[:, None] & (torch.arange(32, device=dev)[None, :]
                                 <= last_mask[:, None])).long(),
        eg_len, vn], 1)
    return pack_slots(vals, nbits)


# ---------------------------------------------------------------------------
# encode entry points
# ---------------------------------------------------------------------------

def encode_chunks(chunks: torch.Tensor):
    """Encode full 16 KiB chunks, 4 fragments each. chunks [C, CHUNK]
    uint8 on the coding device. Returns the nine outputs of
    kanzi_tpu.ops.huffman.encode_chunks_np as tensors, with no host
    sync: (hdr [C, 512], hdr_bits [C], ok [C], m [C], flat, npairs
    [C, 4], acc [C, 4], nb [C, 4], frag_bits [C, 4]); flat is huff_pack's
    buffer, the pair stream in its first 2 * sum(npairs) bytes."""
    _, sizes, _, m, ok, flat, _, acc, nb, npairs = huff_encode_scan(
        chunks, histogram(chunks))
    frag_bits = 16 * npairs + nb * ok[:, None]
    hdr, hdr_bits = pack_huff_headers(sizes, m.long(), ok, frag_bits)
    return hdr, hdr_bits, ok, m, flat, npairs, acc, nb, frag_bits


def encode_chunks_np(chunks: np.ndarray, device):
    """numpy-facing encode_chunks: chunks [C, CHUNK] uint8 go to
    ``device``; the outputs come back with kanzi_tpu's dtypes, flat cut
    to the pair stream. On a card both ways go through pinned host
    buffers: the chunks up without blocking, every output but flat down
    before the one wait that sizes flat from npairs, then flat."""
    device = torch.device(device)
    out = encode_chunks(_to_device(chunks, np.uint8, device))
    if device.type != "cuda":
        n = 2 * int(out[5].long().sum())
        out = [x.cpu() for x in out[:4] + (out[4][:n],) + out[5:]]
    else:
        small = [_to_host(x) for x in out[:4] + out[5:]]
        torch.cuda.current_stream(device).synchronize()
        n = 2 * int(small[4].long().sum())
        flat = _to_host(out[4][:n])
        torch.cuda.current_stream(device).synchronize()
        out = small[:4] + [flat] + small[4:]
    dtypes = (np.uint8, np.int32, bool, np.int32, np.uint8, np.int32,
              np.uint32, np.int32, np.int32)
    return tuple(a.numpy().astype(d, copy=False) if d != np.uint32
                 else a.numpy().view(np.uint32) for a, d in zip(out, dtypes))


# ---------------------------------------------------------------------------
# E. decode
# ---------------------------------------------------------------------------

def decode_table(codes: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """Direct 12-bit prefix table of each chunk: [C, 4096] int16 holding
    sym | len<<8 (HuffmanDecoder.cpp buildDecodingTable). A prefix past
    the last code keeps the entry before it, one before the first code
    reads 0, as kanzi_tpu.ops.huffman._build_vt does. codes [C, 256] are
    the canonical code values, sizes [C, 256] their lengths (0: absent).

    The parse does not check that the lengths fit a prefix code, so a
    corrupt chunk's canonical codes can run past their lengths: a code
    whose prefix falls past the table is dropped (as kanzi_tpu's scatter
    drops it), and of codes that share a prefix the longest, then the
    highest symbol, takes it, on every device alike (a plain scatter
    lets a card pick any)."""
    c, dev = codes.shape[0], codes.device
    ln = sizes.long()
    present = ln > 0
    start = torch.where(present, (codes.long() & 0xFFF)
                        << (MAX_SYMBOL_SIZE - ln).clamp(min=0), TABLE)
    syms = torch.arange(256, device=dev)[None, :]
    entry = (start << 16) | (ln << 8) | syms
    vt = torch.zeros((c, TABLE + 1), dtype=torch.int64,
                     device=dev).scatter_reduce_(
        1, start.clamp(max=TABLE), torch.where(present, entry, 0), "amax")
    return (vt[:, :TABLE].cummax(1).values & 0xFFFF).to(torch.int16)


def huff_decode_plain(tbl, pay, bounds):
    """Plain version of the huff_decode kernel: a Python loop over the
    4096 steps on [C, 4] tensors. Each step reads the 12 bits at the
    fragment's bit cursor (MSB first, 0 past the fragment's end)."""
    c, dev = tbl.shape[0], tbl.device
    n_pay = pay.numel()
    payz = torch.cat([pay.long(), torch.zeros(1, dtype=torch.int64,
                                              device=dev)])
    start, end = bounds[:-1].view(c, 4), bounds[1:].view(c, 4)
    tl = tbl.long()
    bp = torch.zeros((c, 4), dtype=torch.int64, device=dev)
    out = torch.empty((c, 4, FRAG), dtype=torch.uint8, device=dev)
    for t in range(FRAG):
        o = start + (bp >> 3)
        w = torch.zeros_like(bp)
        for k in range(3):
            i = o + k
            ok = (i >= 0) & (i < end) & (i < n_pay)
            w = (w << 8) | payz[torch.where(ok, i, n_pay)]
        e = tl.gather(1, (w >> (12 - (bp & 7))) & 0xFFF)
        out[:, :, t] = (e & 0xFF).to(torch.uint8)
        bp = bp + (e >> 8)
    return out.view(c, CHUNK)


def huff_decode(tbl, pay, bounds):
    """tbl [C, 4096] int16 (decode_table); pay [N] uint8, every
    fragment's bytes back to back; bounds [4C + 1] int64, fragment f of
    chunk c is pay[bounds[4c + f] : bounds[4c + f + 1]]. Returns the
    decoded chunks [C, CHUNK] uint8, fragment-major. A byte at or past
    a fragment's end, past N or before 0 reads 0. The kernel takes each
    entry's length mod 16 (decode_table's are at most 12: the parses
    refuse longer codes) and needs tbl and pay 16-byte aligned, as a
    fresh allocation is."""
    c, dev = tbl.shape[0], tbl.device
    _check("tbl", tbl, torch.int16, (c, TABLE), dev)
    _check("pay", pay, torch.uint8, (pay.numel(),), dev)
    _check("bounds", bounds, torch.int64, (4 * c + 1,), dev)
    if dev.type != "cpu":
        for name, t in (("tbl", tbl), ("pay", pay)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: must be 16-byte aligned")
    if _on_cpu("huff_decode", dev):
        return huff_decode_plain(tbl, pay, bounds)
    out = torch.empty((c, CHUNK), dtype=torch.uint8, device=dev)
    _launch("huff_decode", dev, tbl, pay, pay.numel(), bounds, c, out)
    return out


def huffman_decode_chunks(codes: np.ndarray, sizes: np.ndarray,
                          pay: np.ndarray, bounds: np.ndarray, device):
    """codes [C, 256] canonical code values, sizes [C, 256] lengths;
    pay [N] uint8 the byte-aligned fragments back to back, bounds
    [4C + 1] their offsets. Returns [C, CHUNK] uint8 decoded chunks as
    numpy. The contract of kanzi_tpu.ops.huffman.huffman_decode_chunks
    with the fragments as one flat stream. On a card the inputs go up and
    the chunks come down through pinned host buffers."""
    device = torch.device(device)
    tbl = decode_table(_to_device(codes, np.int64, device),
                       _to_device(sizes, np.int64, device))
    return _to_numpy(device, huff_decode(
        tbl, _to_device(pay, np.uint8, device),
        _to_device(bounds, np.int64, device)))[0]


def flat_fragments(frag_pay: np.ndarray, frag_bytes: np.ndarray):
    """kanzi_tpu's padded fragment rows [C, 4, row] uint8 with the byte
    count of each fragment [C, 4] as this module's (pay, bounds)."""
    n = np.asarray(frag_bytes, np.int64).reshape(-1)
    rows = np.asarray(frag_pay, np.uint8).reshape(n.size, -1)
    pay = np.concatenate([rows[i, :k] for i, k in enumerate(n)]) \
        if n.size else np.zeros(0, np.uint8)
    return pay, np.concatenate([[0], np.cumsum(n)])
