"""Corrupt streams that pass the container's header parse and reach the
port's decode kernels: C (the ANS0 sink), E (the Huffman decode),
sbrt_inv (the level-5 mesh decode), H and J (the level-6 and level-7
mesh decodes). chip_smoke.py (phase 9d) and tests/test_torch_corrupt.py
build them here and hold each outcome on a card to its base path's.

A case is (name, path, blob, patch, base): path "container"
(kanzi_tpu_torch.decompress_bytes) or "l2", "l3", "l5", "l6", "l7" (the
mesh decodes of parallel.pipeline); patch None or (module, attribute,
function of the original) replaced during the decode, on every device
alike; base "cpu" (the same decode with device cpu: the kernels' plain
versions) or "host" (the container's host path, ops disabled).
"""

import contextlib

import numpy as np
import torch

import kanzi_tpu_torch as k
import kanzi_tpu_torch.entropy.huffman as eh
import kanzi_tpu_torch.io.compressed_stream as cs
from kanzi_tpu_torch import ops
from kanzi_tpu_torch.parallel import pipeline as pp
from kanzi_tpu_torch.utils import native

# the error classes a decode of a corrupt stream may raise; any other
# (a CUDA error among them) is a fault
CORRUPT_FAILS = ("KanziError", "ValueError", "BitStreamError")

# the decode kernels the corrupt streams reach: C, E, sbrt_inv, H, J
CORRUPT_KERNELS = ("ans0_decode", "huff_decode", "sbrt_inv", "fpaq_decode",
                   "cm_decode")


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def flipped(blob: bytes, offsets, mask: int = 0xA5) -> bytes:
    b = bytearray(blob)
    for off in offsets:
        b[off] ^= mask
    return bytes(b)


def spread(blob: bytes, n: int, lo: float = 0.05) -> list:
    """n offsets spread over blob's payload, past its first bytes (the
    stream header)."""
    size = len(blob)
    return [int(size * (lo + (1 - lo) * (i + 0.5) / n)) for i in range(n)]


def ans0_cut(which: int, keep_size: bool, cut: int = 3):
    """A flush of the ANS0 sink with record `which` of the queued chunks
    (0 the first, -1 the last) cut `cut` bytes short: its size kept (the
    chunks after it read shifted bytes; the last reads past the payload's
    end) or cut too (the chunk cannot end where its size says)."""
    def mutate(entries):
        flat = [(e, j) for e, (_, q) in enumerate(entries)
                for j in range(len(q))]
        e, j = flat[which]
        out, queued = entries[e]
        start, freqs, states, pay, sz = queued[j]
        queued = list(queued)
        queued[j] = (start, freqs, states, pay[:len(pay) - cut],
                     sz if keep_size else sz - cut)
        return entries[:e] + [(out, queued)] + entries[e + 1:]
    return mutate


def huff_cut(which: int, cut: int = 3):
    """A flush of the Huffman sink with fragment `which` of the queued
    fragments (0 the first, -1 the last) `cut` bytes short, the code
    lengths kept: its bits run out."""
    def mutate(entries):
        e = 0 if which == 0 else len(entries) - 1
        out, idx, codes, sizes, pay, bounds = entries[e]
        f = 0 if which == 0 else len(bounds) - 2
        lo, hi = int(bounds[f]), int(bounds[f + 1])
        cut_at = max(lo, hi - cut)
        pay = np.concatenate([pay[:cut_at], pay[hi:]])
        bounds = np.array(bounds, np.int64)
        bounds[f + 1:] -= hi - cut_at
        return entries[:e] + [(out, idx, codes, sizes, pay, bounds)] + \
            entries[e + 1:]
    return mutate


def cut_stream(data: bytes, chain: str, entropy: str, n: int,
               cut: int) -> bytes:
    """A container whose FPAQ or CM chunks' payloads end `cut` bytes
    early, the framing written for the shorter payloads: the host writer
    with the native binary coder's output cut."""
    enc = native.bincoder_enc_chunk

    def short(h, block):
        buf, n_out = enc(h, block)
        return buf, max(0, n_out - cut)
    ops.disable()
    try:
        with patched(native, "bincoder_enc_chunk", short):
            return k.compress_bytes(data, chain, entropy, block_size=n)
    finally:
        ops.enable()


def l5_zrlt_stream(data: bytes, n: int, mesh, edit) -> bytes:
    """A level-5 container whose ANS0 stage is intact but whose ZRLT
    output (the device chain's) went through edit(zo [B, cap] uint8) in
    place before the entropy stage: its inverse transforms (ZRLT, RANK
    through sbrt_inv, BWT) get bytes that no input makes."""
    fwd = pp._device_l5

    def bad(x, zcap):
        rk, zo, zt = fwd(x, zcap)
        zo = zo.clone()
        edit(zo)
        return rk, zo, zt
    with patched(pp, "_device_l5", bad):
        return pp.compress_l5_mesh(data, n, mesh)


def l5_bad_stream(data: bytes, n: int, mesh, pos: int) -> bytes:
    """l5_zrlt_stream with byte `pos` of each block's ZRLT output
    flipped."""
    def edit(zo):
        zo[:, pos] ^= 0x33
    return l5_zrlt_stream(data, n, mesh, edit)


def l5_long_run_stream(data: bytes, n: int, mesh, pos: int,
                       digits: int) -> bytes:
    """l5_zrlt_stream with a zero run of `digits` digits (bytes 1) from
    byte `pos` of each block's ZRLT output, a literal after it: a run of
    about 2^digits zeros, far past any block."""
    def edit(zo):
        zo[:, pos:pos + digits] = 1
        zo[:, pos + digits] = 2
    return l5_zrlt_stream(data, n, mesh, edit)


def malformed_streams(dev) -> list:
    """tests/test_torch_malformed.py's corrupt streams: bit flips in the
    header and the payload, truncations, a deferred ANS0 sink's flips and
    the fuzz at levels 1-7 (6 single-byte flips each)."""
    from kanzi_tpu_torch.app.cli import LEVEL_TABLE
    out = []
    rng = np.random.default_rng(4)
    data = (b"malformed stream handling " * 3000
            + rng.integers(0, 256, 30000, dtype=np.uint8).tobytes())
    b = k.compress_bytes(data, "LZX", "HUFFMAN", checksum_bits=32,
                         device=dev)
    n = len(b)
    out += [("magic", flipped(b, [0], 0xFF)), ("version", flipped(b, [4], 0xF0)),
            ("header checksum", flipped(b, [9], 0x01)),
            ("truncated half", b[:n // 2]), ("truncated 16", b[:16])]
    out += [(f"payload {p}", flipped(b, [p]))
            for p in (32, n // 4, n // 2, 3 * n // 4, n - 8)]
    rnd = np.random.default_rng(5).integers(0, 256, 120000, dtype=np.uint8)
    b = k.compress_bytes(rnd.tobytes(), "NONE", "ANS0", checksum_bits=32,
                         device=dev)
    out.append(("ans0 checksum", flipped(b, [len(b) // 2], 0x10)))
    rng = np.random.default_rng(9)
    data = (b"deferred sink corruption probe " * 20000
            + rng.integers(0, 256, 100000, dtype=np.uint8).tobytes())
    b = k.compress_bytes(data, "NONE", "ANS0", block_size=128 * 1024,
                         device=dev)
    out.append(("ans0 sink", flipped(
        b, range(len(b) // 3, 2 * len(b) // 3, 997), 0xFF)))
    for level in range(1, 8):
        rng = np.random.default_rng(100 + level)
        data = (b"all-level corruption fuzz " * 4000
                + rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()
                + bytes(20000))
        b = k.compress_bytes(data, *LEVEL_TABLE[level], block_size=64 << 10,
                             device=dev)
        for i in range(6):
            off = int(rng.integers(0, len(b)))
            out.append((f"fuzz l{level} #{i}",
                        flipped(b, [off], int(rng.integers(1, 256)))))
    return out


def corrupt_cases(data: bytes, n: int, enc_mesh, malformed: bool = True,
                  paths=("ANS0", "HUFFMAN", "l2", "l3", "l5", "l6",
                         "l7")) -> tuple:
    """The corrupt streams over `data` at block size n (a multiple of 16
    KiB), and the good streams beside them: (cases, good). good: {path:
    (blob, data)}, "ANS0" and "HUFFMAN" the containers'. paths: those to
    build ("ANS0" and "HUFFMAN" the containers' own cases)."""
    cases = [(name, "container", blob, None, "cpu")
             for name, blob in (malformed_streams(enc_mesh[0])
                                if malformed else [])]
    good = {}
    # the containers' kernels C and E: payload bytes flipped past the
    # headers (no checksum, so the bytes come out), chunks cut short
    for entropy in [p for p in ("ANS0", "HUFFMAN") if p in paths]:
        blob = k.compress_bytes(data, "NONE", entropy, block_size=n,
                                device=enc_mesh[0])
        good[entropy] = (blob, data)
        cases += [(f"{entropy} payload flip {off}", "container",
                   flipped(blob, [off]), None, "cpu")
                  for off in spread(blob, 6)]
    for which, keep in ((0, True), (0, False), (-1, True))[
            :3 * ("ANS0" in good)]:
        blob = good["ANS0"][0]
        mut = ans0_cut(which, keep)
        cases.append((f"ANS0 chunk {which} cut, size {'kept' if keep else 'cut'}",
                      "container", blob,
                      (cs, "ans0_flush_sink",
                       lambda f, mut=mut: lambda e, ctx: f(mut(e), ctx)),
                      "cpu"))
    for which in (0, -1)[:2 * ("HUFFMAN" in good)]:
        blob = good["HUFFMAN"][0]
        mut = huff_cut(which)
        cases.append((f"HUFFMAN fragment {which} cut", "container", blob,
                      (eh, "huffman_flush_sink",
                       lambda f, mut=mut: lambda e, dec: f(mut(e), dec)),
                      "cpu"))
    # the mesh decodes: l2 and l3 (E), l5 (C, sbrt_inv), l6 (H), l7 (J)
    for path, chain, entropy, comp in (
            ("l2", pp.CHAIN_L2, pp.ENTROPY_L2, pp.compress_l2_mesh),
            ("l3", pp.CHAIN_L3, pp.ENTROPY_L3, pp.compress_l3_mesh),
            ("l5", pp.CHAIN, pp.ENTROPY, pp.compress_l5_mesh),
            ("l6", pp.CHAIN_L6, pp.ENTROPY_L6, pp.compress_l6_mesh),
            ("l7", pp.CHAIN_L7, pp.ENTROPY_L7, pp.compress_l7_mesh)):
        if path not in paths:
            continue
        blob = comp(data, n, enc_mesh)
        good[path] = (blob, data)
        base = "cpu" if path in ("l2", "l3") else "host"
        cases += [(f"{path} payload flip {off}", path, flipped(blob, [off]),
                   None, base) for off in spread(blob, 4)]
        if path in ("l2", "l3"):
            for which in (0, -1):
                mut = huff_cut(which)
                cases.append((f"{path} fragment {which} cut", path, blob,
                              (pp, "huffman_flush_sink",
                               lambda f, mut=mut: lambda e, dec: f(mut(e),
                                                                   dec)),
                              "cpu"))
        elif path == "l5":
            cases += [(f"l5 transform byte {pos}", path,
                       l5_bad_stream(data, n, enc_mesh, pos), None,
                       "host") for pos in (1, 40, n // 2)]
            # a run of 2^34 zeros: both ZRLT inverses reject it, the
            # card's by its scan's bound, the host's by its output limit
            cases.append(("l5 zero run of 34 digits", path,
                          l5_long_run_stream(data, n, enc_mesh, 40, 34),
                          None, "host"))
        else:
            cases += [(f"{path} payload cut {cut}", path,
                       cut_stream(data, chain, entropy, n, cut),
                       None, "host") for cut in (1, 2, 3)]
    return cases, good


def corrupt_outcome(path: str, blob: bytes, patch, dev) -> tuple:
    """("ok", bytes) or ("err", the exception's class name) of blob
    through `path` on dev, dev None for the host path (ops disabled)."""
    def decode():
        if dev is None or path == "container":
            return k.decompress_bytes(blob, device=dev)
        return getattr(pp, f"decompress_{path}_mesh")(blob, (dev,))
    if dev is None:
        ops.disable()
    try:
        if patch is None:
            return "ok", decode()
        mod, name, wrap = patch
        with patched(mod, name, wrap(getattr(mod, name))):
            return "ok", decode()
    except RecursionError:
        raise
    except Exception as e:                  # compared by class
        return "err", type(e).__name__
    finally:
        ops.enable()


def _said(outcome) -> str:
    return f"{outcome[0]} " + (outcome[1] if outcome[0] == "err"
                               else f"{len(outcome[1])} bytes")


def check_corrupt(cases, good, dev) -> tuple:
    """Each corrupt case through its decode on dev and on its base: the
    same outcome, a typed failure or the same bytes, and no CUDA error;
    after each, the good stream of its path decodes on dev in the same
    process. Raises AssertionError on the first case that breaks one of
    these. Returns (the launches on dev over the corrupt cases, the
    wrappers' counters; {"ok": decodes, "err": typed failures})."""
    cpu = torch.device("cpu")
    launches = {}
    outcomes = {"ok": 0, "err": 0}
    for name, path, blob, patch, base in cases:
        ops.reset_counters()
        got = corrupt_outcome(path, blob, patch, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        for key, v in ops.COUNTERS.items():
            launches[key] = launches.get(key, 0) + v
        want = corrupt_outcome(path, blob, patch,
                               cpu if base == "cpu" else None)
        if got != want:
            raise AssertionError(
                f"corrupt stream {name!r} ({path}): {_said(got)} on {dev}, "
                f"{_said(want)} on the {base} path")
        if got[0] == "err" and got[1] not in CORRUPT_FAILS:
            raise AssertionError(
                f"corrupt stream {name!r} ({path}) raised {got[1]}")
        outcomes[got[0]] += 1
        key = path if path != "container" else (
            "ANS0" if "ANS0" in name else "HUFFMAN")
        g_blob, g_data = good[key]
        if corrupt_outcome(path, g_blob, None, dev) != ("ok", g_data):
            raise AssertionError(
                f"after corrupt stream {name!r} a good {path} stream does "
                f"not decode on {dev}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return launches, outcomes
