"""A plain decoder of the kanzi bitstream, format 6, for level 6:
TEXT+UTF+BWT+SRT+ZRLT & FPAQ. The container and the TEXT, UTF, BWT and
ZRLT inverses are gpubench/reference/kanzi.py's, imported; this module
adds what that one lacks: the SRT transform (id 13) in the header's
transform table and its inverse, and the FPAQ entropy stage.

Plain Python and NumPy, written from kanzi-cpp's format
(src/entropy/FPAQDecoder.cpp, src/transform/SRT.cpp); it imports nothing
of kanzi_tpu or kanzi_tpu_torch and takes nothing but a compressed file.

FPAQ, bitstream version 6: a block's bytes in chunks of 4 MiB, each
framed as a varint byte count, the 56-bit current, then that many payload
bytes; the 56-bit low and high and the probabilities carry from chunk to
chunk, the bank of probabilities restarts at probs[0] at each chunk.
probs[4][256] are 16-bit P(bit = 1), the bank the previous byte's top two
bits, the row the bit-tree path; the split is low + (((high - low) >> 8)
* p >> 8), each update p - (p >> 6) + 1023 * bit, and a 32-bit word is
shifted in whenever the top 32 bits of low and high agree. A valid chunk
ends with every payload word read and its current equal to the coder's
low | 0xFFFFFF (the encoder's closing 56 bits): a chunk that does not is
Malformed.

SRT: 256 frequencies as LSB-first 7-bit varints, then the ranks grouped
in one bucket a symbol, the buckets in order of frequency (descending)
then symbol; each run of a symbol starts with its move-to-front rank,
its other bytes are 0.

A block decodes whole (decode_block), some 5.7-6.7 us a byte of its
FPAQ stage all told: on the card's host an 8 MiB block of silesia.tar's
mozilla, a 4.72 MB stage, took 31.6 s, and the block of x-ray and xml, a
4.15 MB stage, 23.7 s (PERF.md). The benchmark decodes one a run.
"""

from __future__ import annotations

import numpy as np

from gpubench.reference.kanzi import (COPY_BLOCK_MASK, ENTROPY, M32, M56,
                                      MAGIC, Bits, Malformed,
                                      _header_checksum, block_header,
                                      inv_bwt, inv_text, inv_utf, inv_zrlt)

TRANSFORM = {1: "BWT", 6: "ZRLT", 10: "TEXT", 13: "SRT", 17: "UTF"}
M24 = (1 << 24) - 1
FPAQ_CHUNK = 4 * 1024 * 1024


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
        nbits = b.bits(3 + b.bits(5))
        if nbits == 0:
            break
        start = b.pos
        b.pos += nbits
        if b.pos > b.nbits:
            raise Malformed("block past the end of the stream")
        sub = Bits(blob)
        sub.pos = start
        nbytes = (nbits + 7) >> 3
        payload = sub.bits(nbits) << (8 * nbytes - nbits)
        frames.append((payload.to_bytes(nbytes, "big"), nbits))
    return {"version": version, "checksum_bits": (0, 32, 64)[ck_size],
            "entropy": ENTROPY[etype], "transforms": transform_names(ttype),
            "block_size": block_size, "size": size, "frames": frames}


# ---------------------------------------------------------------------------
# entropy: FPAQ
# ---------------------------------------------------------------------------

def fpaq_decode(b: Bits, count: int) -> bytes:
    """An FPAQ stage of count bytes."""
    probs = [[1 << 15] * 256 for _ in range(4)]
    low, high = 0, M56
    out = bytearray(count)
    start = 0
    while start < count:
        end = min(start + FPAQ_CHUNK, count)
        size = b.varint()
        if size % 4 or size > 2 * (end - start) + 64:
            raise Malformed(f"FPAQ chunk size {size}")
        cur = b.bits(56)
        words = np.frombuffer(b.bytes(size), ">u4").tolist()
        words.reverse()                      # popped from the end
        p = probs[0]
        for i in range(start, end):
            ctx = 1
            for _ in range(8):
                q = p[ctx]
                split = ((((high - low) >> 8) * q) >> 8) + low
                if split >= cur:
                    high = split
                    p[ctx] = q - (q >> 6) + 1023
                    ctx += ctx + 1
                else:
                    low = split + 1
                    p[ctx] = q - (q >> 6)
                    ctx += ctx
                if (low ^ high) >> 24 == 0:
                    if not words:
                        raise Malformed("FPAQ stage read past its chunk")
                    low = (low << 32) & M56
                    high = ((high << 32) | M32) & M56
                    cur = ((cur << 32) | words.pop()) & M56
            c = ctx & 0xFF
            out[i] = c
            p = probs[c >> 6]
        if words or cur != low | M24:
            raise Malformed("FPAQ chunk does not end where its coder does")
        start = end
    return bytes(out)


def entropy_stage(hdr: dict, payload: bytes) -> tuple:
    """A block's entropy stage: (bytes, pre_len, skip_flags, mode)."""
    b, mode, skip, pre_len = block_header(payload, hdr["checksum_bits"])
    if pre_len <= 0 or pre_len > max(hdr["block_size"] * 3 // 2, 2048):
        raise Malformed(f"block length {pre_len}")
    ent = "NONE" if mode & COPY_BLOCK_MASK else hdr["entropy"]
    if ent == "FPAQ":
        data = fpaq_decode(b, pre_len)
    elif ent == "NONE":
        data = b.bytes(pre_len)
    else:
        raise Malformed(f"entropy {ent} not in this decoder")
    return data, pre_len, skip, mode


# ---------------------------------------------------------------------------
# SRT
# ---------------------------------------------------------------------------

def _srt_header(src: bytes) -> tuple:
    """(256 frequencies, header bytes)."""
    freqs, i = [], 0
    for _ in range(256):
        res, shift = 0, 0
        while True:
            if i >= len(src):
                raise Malformed("SRT header truncated")
            v = src[i]
            i += 1
            res |= (v & 0x7F) << shift
            if v < 128:
                break
            shift += 7
            if shift > 28:
                raise Malformed("SRT header varint")
        freqs.append(res)
    return freqs, i


def inv_srt(src: bytes, ctx: dict) -> bytes:
    """SRT: the ranks bucket by bucket back into symbols, each run of a
    symbol read from its bucket, the symbols' order kept move-to-front."""
    freqs, hsz = _srt_header(src)
    ranks = src[hsz:]
    n = len(ranks)
    if sum(freqs) != n:
        raise Malformed("SRT frequencies do not add up to the block")
    order = sorted((s for s in range(256) if freqs[s]),
                   key=lambda s: (-freqs[s], s))
    pos, end = [0] * 256, [0] * 256
    r2s = [0] * 256
    at = 0
    for s in order:
        r2s[ranks[at]] = s        # a symbol's first rank: its first place
        pos[s] = at + 1
        at += freqs[s]
        end[s] = at
    live = len(order)
    out = bytearray(n)
    c = r2s[0]
    for i in range(n):
        out[i] = c
        j = pos[c]
        if j < end[c]:
            r = ranks[j]
            pos[c] = j + 1
            if r:
                r2s[0:r] = r2s[1:r + 1]
                r2s[r] = c
                c = r2s[0]
        elif live > 1:              # c's bucket is spent: c leaves the list
            live -= 1
            r2s[0:live] = r2s[1:live + 1]
            c = r2s[0]
    return bytes(out)


INVERSE = {"BWT": inv_bwt, "SRT": inv_srt, "ZRLT": inv_zrlt,
           "UTF": inv_utf, "TEXT": inv_text}


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
