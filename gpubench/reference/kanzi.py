"""A plain decoder of the kanzi bitstream, format 6, for the chains the
benchmark's configurations run: the container (header, block framing),
the CM and ANS0 entropy stages, and the LZP, TEXT, UTF, BWT, RANK and
ZRLT inverse transforms.

Plain Python and NumPy: a trimmed copy of the host decode paths of
kanzi_tpu (the JAX package's byte-exact host code, held to the upstream
kanzi binary by its tests) with every native, device and batching path
taken out. It imports nothing of either package and takes nothing but a
compressed file.

A block decodes whole (decode_block). The CM coder here runs some 13 us
a byte of its stage, so a 16 MiB level-7 block (an entropy stage of ~8 MB)
takes about 100 s on the card's host: the benchmark decodes one a run.
"""

from __future__ import annotations

import numpy as np

from gpubench.reference.text_dict import DICT_EN_1024

MAGIC = 0x4B414E5A
COPY_BLOCK_MASK = 0x80
TRANSFORMS_MASK = 0x10
ENTROPY = {0: "NONE", 1: "HUFFMAN", 2: "FPAQ", 4: "RANGE", 5: "ANS0", 6: "CM",
           7: "TPAQ", 8: "ANS1", 9: "TPAQX"}
TRANSFORM = {1: "BWT", 6: "ZRLT", 8: "RANK", 10: "TEXT", 14: "LZP",
             17: "UTF"}


class Malformed(ValueError):
    """The stream is not what the format allows."""


# ---------------------------------------------------------------------------
# bits
# ---------------------------------------------------------------------------

class Bits:
    """MSB-first bit reader over bytes."""

    def __init__(self, data: bytes):
        self.data = bytes(data)
        self.nbits = 8 * len(self.data)
        self.pos = 0

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        pos = self.pos
        if pos + n > self.nbits:
            raise Malformed("read past the end of the stream")
        self.pos = pos + n
        first, last = pos >> 3, (pos + n - 1) >> 3
        chunk = int.from_bytes(self.data[first:last + 1], "big")
        return (chunk >> (8 * (last + 1) - (pos + n))) & ((1 << n) - 1)

    def bytes(self, count: int) -> bytes:
        if (self.pos & 7) == 0:
            i = self.pos >> 3
            if self.pos + 8 * count > self.nbits:
                raise Malformed("read past the end of the stream")
            self.pos += 8 * count
            return self.data[i:i + count]
        return bytes(self.bits(8) for _ in range(count)) if count < 64 else \
            self.bits(8 * count).to_bytes(count, "big")

    def varint(self) -> int:
        value = self.bits(8)
        res, shift = value & 0x7F, 7
        while value >= 128:
            value = self.bits(8)
            if shift == 28:
                if value >= 128 or (value & 0x70):
                    raise Malformed("bad varint")
                return res | ((value & 0x0F) << shift)
            res |= (value & 0x7F) << shift
            shift += 7
        return res


# ---------------------------------------------------------------------------
# the container
# ---------------------------------------------------------------------------

def _header_checksum(version, ck_size, entropy, transform, block_size,
                     sz_mask, input_size):
    m, h = 0xFFFFFFFF, 0x1E35A7BD
    ck = (h * ((0x01030507 * version) & m)) & m
    ck ^= (h * ((~ck_size) & m)) & m
    ck ^= (h * ((~entropy) & m)) & m
    ck ^= (h * (((~transform) >> 32) & m)) & m
    ck ^= (h * ((~transform) & m)) & m
    ck ^= (h * ((~block_size) & m)) & m
    if sz_mask:
        ck ^= (h * (((~input_size) >> 32) & m)) & m
        ck ^= (h * ((~input_size) & m)) & m
    return (((ck >> 23) ^ (ck >> 3)) & m) & 0xFFFFFF


def transform_names(ttype: int) -> list:
    names = []
    for i in range(8):
        tid = (ttype >> (42 - 6 * i)) & 63
        if tid:
            if tid not in TRANSFORM:
                raise Malformed(f"transform id {tid} not in this decoder")
            names.append(TRANSFORM[tid])
    return names


def parse(blob: bytes) -> dict:
    """The header and every block's frame: {"version", "checksum_bits",
    "entropy", "transforms", "block_size", "size", "frames": [(payload
    bytes, bits)]}. Raises Malformed."""
    b = Bits(blob)
    if b.bits(32) != MAGIC:
        raise Malformed("not a kanzi stream")
    version = b.bits(4)
    if version != 6:
        raise Malformed(f"bitstream version {version}, this decoder reads 6")
    ck_size = b.bits(2)
    if ck_size == 3:
        raise Malformed("bad checksum size")
    etype = b.bits(5)
    ttype = b.bits(48)
    block_size = b.bits(28) << 4
    sz_mask = b.bits(2)
    size = b.bits(16 * sz_mask) if sz_mask else 0
    b.bits(15)
    if b.bits(24) != _header_checksum(version, ck_size, etype, ttype,
                                      block_size, sz_mask, size):
        raise Malformed("header checksum")
    if etype not in ENTROPY:
        raise Malformed(f"entropy id {etype}")
    frames = []
    while True:
        lr = 3 + b.bits(5)
        nbits = b.bits(lr)
        if nbits == 0:
            break
        start = b.pos
        b.pos += nbits
        if b.pos > b.nbits:
            raise Malformed("block past the end of the stream")
        sub = Bits(blob)
        sub.pos = start
        nbytes = (nbits + 7) >> 3
        payload = sub.bits(8 * nbytes) if nbits & 7 == 0 else \
            sub.bits(nbits) << (8 * nbytes - nbits)
        frames.append((payload.to_bytes(nbytes, "big"), nbits))
    return {"version": version, "checksum_bits": (0, 32, 64)[ck_size],
            "entropy": ENTROPY[etype], "transforms": transform_names(ttype),
            "block_size": block_size, "size": size, "frames": frames}


def block_header(payload: bytes, checksum_bits: int) -> tuple:
    """(Bits positioned at the entropy stage, mode, skip_flags, pre_len)."""
    b = Bits(payload)
    mode = b.bits(8)
    skip = 0xFF
    if not mode & COPY_BLOCK_MASK:
        skip = b.bits(8) if mode & TRANSFORMS_MASK else ((mode << 4) | 0x0F) & 0xFF
    pre_len = b.bits(8 * (1 + ((mode >> 5) & 3)))
    if checksum_bits:
        b.bits(checksum_bits)
    return b, mode, skip, pre_len


# ---------------------------------------------------------------------------
# entropy: CM (the 56-bit binary shell around the CM predictor) and ANS0
# ---------------------------------------------------------------------------

M56 = (1 << 56) - 1
M32 = (1 << 32) - 1


def cm_decode(b: Bits, count: int) -> bytes:
    """A CM stage of count bytes, bitstream version 6 (counter2's last
    entry 65536). One chunk for count < 2^26."""
    if count >= 1 << 26:
        raise Malformed("CM block of more than one chunk")
    size = b.varint()
    if size > min(max(count, 64) << 5, (1 << 32) >> 3):
        raise Malformed("CM chunk size")
    cur = b.bits(56)
    buf = b.bytes(size) + bytes(8)
    fb = int.from_bytes
    c1t = [[32768] * 257 for _ in range(256)]
    c2t = [[j << 12 for j in range(17)] for _ in range(512)]
    low, high, c1, c2, run, idx = 0, M56, 0, 0, 0, 0
    out = bytearray(count)
    for i in range(count):
        ctx = 1
        for _ in range(8):
            pc1 = c1t[ctx]
            p = (13 * (pc1[256] + pc1[c1]) + 6 * pc1[c2]) >> 5
            pc2 = c2t[ctx | run]
            off = p >> 12
            a, d = pc2[off], pc2[off + 1]
            p = (p + p + 3 * (a + d) + 64) >> 7
            mid = low + ((((high - low) >> 4) * p) >> 8)
            if mid >= cur:
                high = mid
                pc1[256] -= (pc1[256] - 65520) >> 2
                pc1[c1] -= (pc1[c1] - 65520) >> 4
                pc2[off] = a - ((a - 65520) >> 6)
                pc2[off + 1] = d - ((d - 65520) >> 6)
                ctx += ctx + 1
            else:
                low = mid + 1
                pc1[256] -= pc1[256] >> 2
                pc1[c1] -= pc1[c1] >> 4
                pc2[off] = a - (a >> 6)
                pc2[off + 1] = d - (d >> 6)
                ctx += ctx
            if ((low ^ high) >> 24) == 0:
                low = (low << 32) & M56
                high = ((high << 32) | M32) & M56
                cur = ((cur << 32) | fb(buf[idx:idx + 4], "big")) & M56
                idx += 4
        c = ctx & 0xFF
        out[i] = c
        c2, c1 = c1, c
        run = 0x100 if c1 == c2 else 0
    if idx > size + 4:
        raise Malformed("CM stage read past its chunk")
    return bytes(out)


def _alphabet(b: Bits) -> list:
    if b.bits(1) == 0:                               # full alphabet
        return list(range(256)) if b.bits(1) == 0 else []
    last = b.bits(5)
    masks = np.frombuffer(b.bytes(last + 1), np.uint8)
    return np.nonzero(np.unpackbits(masks, bitorder="little"))[0].tolist()


def _ans0_header(b: Bits):
    lr = 8 + b.bits(3)
    if lr > 15:
        raise Malformed("ANS range")
    scale, llr = 1 << lr, lr.bit_length()
    freqs = [0] * 256
    alphabet = _alphabet(b)
    count = len(alphabet)
    if count:
        chk = 8 if count >= 64 else 6
        s, i = 0, 1
        while i < count:
            log_max = b.bits(llr)
            if log_max > lr:
                raise Malformed("ANS frequency size")
            for j in range(i, min(i + chk, count)):
                f = 1 if log_max == 0 else b.bits(log_max) + 1
                if f >= scale:
                    raise Malformed("ANS frequency")
                freqs[alphabet[j]] = f
                s += f
            i += chk
        if scale <= s:
            raise Malformed("ANS frequencies")
        freqs[alphabet[0]] = scale - s
    return freqs, alphabet, lr


def ans0_decode(b: Bits, count: int) -> bytes:
    """An ANS0 stage of count bytes (16 KiB chunks, four interleaved
    32-bit states)."""
    if count <= 32:
        return b.bytes(count)
    out = bytearray()
    start = 0
    while start < count:
        size = min(16384, count - start)
        freqs, alphabet, lr = _ans0_header(b)
        if not alphabet:
            break
        if len(alphabet) == 1:
            out += bytes([alphabet[0]]) * size
            start += size
            continue
        sz = b.varint()
        st = [b.bits(32) for _ in range(4)]
        pay = b.bytes(sz) + b"\0\0"
        mask = (1 << lr) - 1
        f = [min(x, mask) for x in freqs]
        cum = [0] * 256
        acc = 0
        for s in range(256):
            cum[s] = acc
            acc += f[s]
        f2s = bytearray(1 << lr)
        pos = 0
        for s in range(256):
            f2s[pos:pos + f[s]] = bytes([s]) * f[s]
            pos += f[s]
        count4 = size & -4
        chunk = bytearray(size)
        cursor = 0
        for t in range(0, count4, 4):
            for lane in (3, 2, 1, 0):
                s = st[lane]
                c = f2s[s & mask]
                chunk[t + 3 - lane] = c
                s = f[c] * (s >> lr) + (s & mask) - cum[c]
                if s < 1 << 15:
                    s = (s << 16) | (pay[cursor] << 8) | pay[cursor + 1]
                    cursor += 2
                st[lane] = s
        for i in range(count4, size):
            chunk[i] = pay[cursor]
            cursor += 1
        if cursor != sz:
            raise Malformed("ANS chunk payload size")
        out += chunk
        start += size
    if start < count:
        raise Malformed("ANS stage ended early")
    return bytes(out)


def entropy_stage(hdr: dict, payload: bytes) -> tuple:
    """A block's entropy stage: (bytes, pre_len, skip_flags, mode)."""
    b, mode, skip, pre_len = block_header(payload, hdr["checksum_bits"])
    if pre_len <= 0 or pre_len > max(hdr["block_size"] * 3 // 2, 2048):
        raise Malformed(f"block length {pre_len}")
    ent = "NONE" if mode & COPY_BLOCK_MASK else hdr["entropy"]
    if ent == "CM":
        data = cm_decode(b, pre_len)
    elif ent == "ANS0":
        data = ans0_decode(b, pre_len)
    elif ent == "NONE":
        data = b.bytes(pre_len)
    else:
        raise Malformed(f"entropy {ent} not in this decoder")
    return data, pre_len, skip, mode


# ---------------------------------------------------------------------------
# inverse transforms
# ---------------------------------------------------------------------------

def _chain_walk(nxt: np.ndarray, start: int, count: int) -> np.ndarray:
    """The positions visited following pos -> nxt[pos] count times from
    start (start included), by pointer doubling."""
    n = len(nxt)
    pos = np.empty(count, np.int64)
    if count == 0:
        return pos
    pos[0] = start
    filled = 1
    jump = np.minimum(np.asarray(nxt, np.int64), n - 1)
    while filled < count:
        m = min(filled, count - filled)
        pos[filled:filled + m] = jump[pos[:m]]
        filled += m
        if filled < count:
            jump = jump[np.minimum(jump, n - 1)]
    return pos


def inv_bwt(src: bytes, ctx: dict) -> bytes:
    """BWTBlockCodec: mode byte, 8 (or 1) primary indexes, the BWT."""
    n_all = len(src)
    if n_all <= 1:
        raise Malformed("BWT block")
    mode = src[0]
    chunks = 1 << ((mode >> 2) & 7)
    pis = (mode & 3) + 1
    hdr = 1 + chunks * pis
    n = n_all - hdr
    if n < 0 or chunks != (1 if n < 256 else 8):
        raise Malformed("BWT header")
    p_idx = int.from_bytes(src[1:1 + pis], "big") + 1
    if not 0 < p_idx <= n:
        raise Malformed("BWT primary index")
    bwt = np.frombuffer(src, np.uint8, n, hdr)
    order = np.argsort(bwt, kind="stable")
    adj = np.arange(n, dtype=np.int64)
    adj[1:p_idx] -= 1
    adj[0] = 0
    pos = _chain_walk(adj[order], p_idx - 1, n)
    return bwt[order][pos].tobytes()


def inv_rank(src: bytes, ctx: dict) -> bytes:
    """SBRT in RANK mode (alpha 1/2)."""
    p = [0] * 256
    q = [0] * 256
    r2s = list(range(256))
    out = bytearray(len(src))
    for i, r in enumerate(src):
        c = r2s[r]
        out[i] = c
        qc = (i + p[c]) >> 1
        p[c] = i
        q[c] = qc
        while r > 0 and q[r2s[r - 1]] <= qc:
            r2s[r] = r2s[r - 1]
            r -= 1
        r2s[r] = c
    return bytes(out)


def inv_zrlt(src: bytes, ctx: dict) -> bytes:
    n = len(src)
    if n == 0:
        return b""
    limit = max(4 * ctx["block_size"], 1 << 20)
    out = bytearray()
    i = 0
    run = 0
    while True:
        val = src[i]
        if val <= 1:
            run = 1
            while val <= 1:
                run += run + val
                i += 1
                if i >= n:
                    break
                val = src[i]
            if i >= n:
                break
            run -= 1
            if run > 0:
                if len(out) + run > limit:
                    raise Malformed("ZRLT run past the block")
                out += bytes(run)
                run = 0
                continue
        if val == 0xFF:
            i += 1
            if i >= n:
                raise Malformed("ZRLT escape at the end")
            out.append((0xFE + src[i]) & 0xFF)
        else:
            out.append(val - 1)
        i += 1
        if i >= n:
            run = 0
            break
    if run > 1:
        out += bytes(run - 1)
    return bytes(out)


def inv_lzp(src: bytes, ctx: dict) -> bytes:
    """LZP: 16-bit context hash of the last 4 bytes, min match 64, flag
    0xFC."""
    count = len(src)
    if count < 4:
        raise Malformed("LZP block")
    table = [0] * (1 << 16)
    dst = bytearray(src[:4])
    c = int.from_bytes(src[0:4], "little")
    i = 4
    while i < count:
        h = ((0x7FEB352D * c) & M32) >> 16
        ref = table[h]
        table[h] = len(dst)
        v = src[i]
        if v != 0xFC or ref == 0:
            c = ((c << 8) | v) & M32
            dst.append(v)
            i += 1
            continue
        i += 1
        if i >= count:
            raise Malformed("LZP truncated")
        if src[i] == 0xFF:
            c = ((c << 8) | 0xFC) & M32
            dst.append(0xFC)
            i += 1
            continue
        mlen = 64
        while i < count and src[i] == 0xFE:
            i += 1
            mlen += 254
        if i >= count:
            raise Malformed("LZP truncated match")
        mlen += src[i]
        i += 1
        if ref + mlen <= len(dst):
            dst += dst[ref:ref + mlen]
        else:                                          # overlapping copy
            for k in range(mlen):
                dst.append(dst[ref + k])
        c = int.from_bytes(dst[-4:], "little")
    return bytes(dst)


def inv_utf(src: bytes, ctx: dict) -> bytes:
    s = np.frombuffer(src, np.uint8)
    count = len(s)
    if count < 4:
        raise Malformed("UTF block")
    start, adjust = s[0] & 3, s[1] & 3
    n = (int(s[2]) << 8) | int(s[3])
    if n == 0 or n >= 32768 or 3 * n > count - 4:
        raise Malformed("UTF map size")
    keys = s[4:4 + 3 * n].reshape(n, 3).astype(np.int64)
    vals = (keys[:, 0] << 16) | (keys[:, 1] << 8) | keys[:, 2]
    tag = vals >> 19
    sym = np.zeros((n, 4), np.uint8)
    slen = np.zeros(n, np.int64)
    m = tag == 0
    sym[m, 0], slen[m] = vals[m] & 0xFF, 1
    m = tag == 1
    sym[m, 0], sym[m, 1], slen[m] = (vals[m] >> 8) & 0xFF, vals[m] & 0xFF, 2
    m = tag == 2
    sym[m, 0] = ((vals[m] >> 12) & 0x0F) | 0xE0
    sym[m, 1] = ((vals[m] >> 6) & 0x3F) | 0x80
    sym[m, 2] = (vals[m] & 0x3F) | 0x80
    slen[m] = 3
    m = tag >= 4
    sym[m, 0] = ((vals[m] >> 18) & 0x07) | 0xF0
    sym[m, 1] = ((vals[m] >> 12) & 0x3F) | 0x80
    sym[m, 2] = ((vals[m] >> 6) & 0x3F) | 0x80
    sym[m, 3] = (vals[m] & 0x3F) | 0x80
    slen[m] = 4
    if np.any(slen == 0) or np.any(tag == 3):
        raise Malformed("UTF map entry")
    i0 = 4 + 3 * n
    end = count - 4 + adjust
    head = s[i0:i0 + start].tobytes()
    stream = s[i0 + start:end].astype(np.int64)
    step = np.where(stream >= 128, 2, 1)
    pos = _chain_walk(np.arange(len(stream)) + step, 0, max(len(stream), 1))
    cut = np.nonzero(pos >= len(stream))[0]
    nsym = int(cut[0]) if len(cut) else len(stream)
    pos = pos[:nsym]
    if len(stream) and (nsym == 0 or int(pos[-1] + step[pos[-1]]) != len(stream)):
        raise Malformed("UTF alias stream")
    a0 = stream[pos]
    two = a0 >= 128
    hi = np.zeros(nsym, np.int64)
    hi[two] = stream[np.minimum(pos[two] + 1, len(stream) - 1)]
    alias = np.where(two, (hi << 7) + (a0 & 0x7F), a0)
    if np.any(alias >= n):
        raise Malformed("UTF alias")
    lens = slen[alias]
    offs = np.cumsum(lens) - lens
    res = np.empty(int(lens.sum()), np.uint8)
    for k in range(4):
        mm = lens > k
        res[offs[mm] + k] = sym[alias[mm], k]
    return head + res.tobytes() + s[end:count].tobytes()


# TEXT (TextCodec, bsVersion 6): variant 1 for CM, 2 for ANS0
_HASH1, _HASH2 = 0x7FEB352D, 0x846CA68B


def _char_types():
    t = [-1] * 256
    for i in range(256):
        if 0x20 <= i <= 0x2F or 0x3A <= i <= 0x3F or i in b"\n\r\t_|{}[]":
            t[i] = 1
        elif 65 <= i <= 90 or 97 <= i <= 122:
            t[i] = 0
    return t


_CT = _char_types()


def _whash(w: bytes) -> int:
    h = _HASH1
    for c in w:
        h = ((h * _HASH1) ^ (c * _HASH2)) & M32
    return h


def _log2(x: int) -> int:
    return x.bit_length() - 1


def inv_text(src: bytes, ctx: dict) -> bytes:
    count = len(src)
    if count < 2:
        raise Malformed("TEXT block")
    v1 = ctx["entropy"] not in ("NONE", "ANS0", "HUFFMAN", "RANGE")
    bs = ctx["block_size"]
    log_hash = (max(min(_log2(bs // 8), 26), 13) if v1 else
                max(min(_log2(bs // 32), 24), 13))
    cap = max(ctx["capacity"], count)
    log_d = 13 if cap < 1024 else max(min(_log2(cap // 128), 18), 13)
    static = [bytes(w) for w in DICT_EN_1024]
    if v1:
        static += [b"\x0e", b"\x0f"]
    dict_size = max(len(static), 1 << log_d)
    mask = (1 << log_hash) - 1
    # entries: [buf, start, hash, length]; the map: hash slot -> index
    ent = [[w, 0, _whash(w) if k < 1024 else 0, len(w)]
           for k, w in enumerate(static)]
    n_static = len(ent)
    ent += [[None, 0, 0, 0] for _ in range(n_static, dict_size)]
    dmap = {}
    for k in range(n_static):
        dmap[ent[k][2] & mask] = k
    words = n_static
    data = src
    is_crlf = bool(data[0] & 0x40)
    i = 1
    dst = bytearray()
    anchor = 0 if (i < count and _CT[data[i]] == 0) else 1
    word_run = False
    while i < count:
        cur = data[i]
        ct = _CT[cur]
        if ct == 0:
            dst.append(cur)
            i += 1
            continue
        if i > anchor + 3 and ct > 0:
            length = i - anchor - 1
            if length <= 31:
                h1 = _HASH1
                for k in range(anchor + 1, i):
                    h1 = ((h1 * _HASH1) ^ (data[k] * _HASH2)) & M32
                k1 = dmap.get(h1 & mask)
                e1 = ent[k1] if k1 is not None else None
                same = (e1 is not None and e1[2] == h1 and e1[3] == length
                        and e1[0][e1[1] + 1:e1[1] + length]
                        == data[anchor + 2:anchor + 1 + length])
                if not same and e1 is None and (length > 3 or words < 16384):
                    e = ent[words]
                    if words >= n_static:              # reuse: its slot cleared
                        dmap[e[2] & mask] = None
                        e[0], e[1], e[2], e[3] = data, anchor + 1, h1, length
                    dmap[h1 & mask] = words
                    words += 1
                    if words >= dict_size:
                        if dict_size >= 1 << 19:
                            words = n_static
                        else:
                            ent += [[None, 0, 0, 0] for _ in range(dict_size)]
                            dmap = {}
                            for k in range(dict_size):
                                dmap[ent[k][2] & mask] = k
                            dict_size <<= 1
        i += 1
        if v1 and cur in (0x0F, 0x0E):
            idx = data[i]
            i += 1
            if idx >= 128:
                idx2 = data[i]
                i += 1
                if idx2 >= 128:
                    idx = ((idx & 0x1F) << 14) | ((idx2 & 0x7F) << 7) | data[i]
                    i += 1
                else:
                    idx = ((idx & 0x7F) << 7) | idx2
                if idx >= dict_size:
                    raise Malformed("TEXT word index")
            flip = 0x20 if cur == 0x0E else 0
        elif not v1 and cur >= 0x80:
            flip = 0
            if cur == 0x80:
                flip = 0x20
                cur = data[i]
                i += 1
            idx = cur & 0x7F
            if idx >= 64:
                if idx >= 112:
                    idx = ((idx & 0x0F) << 16) | (data[i] << 8) | data[i + 1]
                    i += 2
                else:
                    idx = ((idx & 0x1F) << 8) | data[i]
                    i += 1
                if idx > dict_size:
                    raise Malformed("TEXT word index")
            elif idx == 0:
                raise Malformed("TEXT word index 0")
            idx -= 1
        else:
            if not v1 and cur == 0x0F:
                dst.append(data[i])
                i += 1
            else:
                if is_crlf and cur == 0x0A:
                    dst.append(0x0D)
                dst.append(cur)
            word_run = False
            anchor = i - 1
            continue
        e = ent[idx]
        length = e[3] & 0xFF
        if length > 1:
            if word_run:
                dst.append(0x20)
            word_run = True
            anchor = i
        else:
            if length == 0:
                raise Malformed("TEXT empty word")
            word_run = False
            anchor = i - 1
        pos = len(dst)
        dst += e[0][e[1]:e[1] + length]
        dst[pos] ^= flip
    if i != count:
        raise Malformed("TEXT stream")
    return bytes(dst)


INVERSE = {"BWT": inv_bwt, "RANK": inv_rank, "ZRLT": inv_zrlt,
           "LZP": inv_lzp, "UTF": inv_utf, "TEXT": inv_text}


def inverse_chain(hdr: dict, data: bytes, skip: int, mode: int,
                  payload_bytes: int) -> bytes:
    """Every transform the block's skip flags mark as run, last first."""
    if mode & COPY_BLOCK_MASK or skip == 0xFF:
        return data
    ctx = {"entropy": hdr["entropy"], "block_size": hdr["block_size"],
           "capacity": max(hdr["block_size"], payload_bytes)}
    names = hdr["transforms"]
    for i in range(len(names) - 1, -1, -1):
        if not skip & (1 << (7 - i)):
            data = INVERSE[names[i]](data, ctx)
    return data


def decode_block(hdr: dict, k: int) -> bytes:
    """Block k (0-based) of a parsed stream, whole. Raises Malformed."""
    payload, nbits = hdr["frames"][k]
    try:
        data, pre_len, skip, mode = entropy_stage(hdr, payload)
        if len(data) != pre_len:
            raise Malformed("entropy stage short")
        return inverse_chain(hdr, data, skip, mode, (nbits + 7) >> 3)
    except IndexError as e:              # a read past a buffer's end
        raise Malformed(f"stream ends early: {e}") from e
