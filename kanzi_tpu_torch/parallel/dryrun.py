"""The block mesh's dry run: every mesh chain over a mesh and over its
1-device submesh, each container held to the host writer's bytes.

The PyTorch counterpart of kanzi_tpu's dryrun_multichip
(__graft_entry__.py): the level-5 (TEXT+UTF+BWT+RANK+ZRLT & ANS0),
level-2 (DNA+LZ & HUFFMAN), level-3 (TEXT+UTF+PACK+MM+LZX & HUFFMAN) and
level-6 (TEXT+UTF+BWT+SRT+ZRLT & FPAQ) chains of parallel.pipeline at
the 1-device submesh and at the full mesh, the level-7 chain (& CM) at
the full mesh, each container byte-identical with the port's host writer
(ops disabled) and decoded back; then the sharded ANS0 entropy stage's
round trip, and its rates over the submeshes of 1, 2, 4, ... devices
(the MESH_SCALING line). A mesh that names one device k times (block_mesh
((cpu,) * k), (cuda:0,) * k) stands in for k cards: every shard runs on
that device in turn. Each stage's batch holds at least one item a
device, so that every shard of every chain runs.

    python3 -c "import torch; from kanzi_tpu_torch.parallel import dryrun; \\
        dryrun.dryrun_multichip((torch.device('cuda', 0),) * 3)"
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

import kanzi_tpu_torch.ops as ops
from kanzi_tpu_torch.bitstream import BitReader
from kanzi_tpu_torch.io.compressed_stream import (compress_bytes,
                                                  decompress_bytes)
from kanzi_tpu_torch.ops import ans as dans
from kanzi_tpu_torch.parallel import pipeline as pp
from kanzi_tpu_torch.parallel.mesh import (block_mesh, shard_ans0_decode,
                                           shard_ans0_encode)

# block sizes at scale 1, kanzi_tpu's: l5 blocks of 3 full 16 KiB ANS0
# chunks (the multi-chunk decode batch), l2 blocks of 4, l3/l6 of one,
# l7 of 4 KiB; l2 and l3 keep at least one chunk a block at any scale
L5_BLOCK, L2_BLOCK, L36_BLOCK, L7_BLOCK = 49152, 65536, 16384, 4096


def _size(base: int, scale: float) -> int:
    """A block size: base * scale, a multiple of 16, at least the
    container's 1024."""
    return max(1024, int(base * scale) // 16 * 16)


def _inputs(n_devices: int, scale: float, rng) -> dict:
    """kanzi_tpu's dryrun data at this mesh size, with l2 and l3 made so
    that each device's shard has a full Huffman chunk: {chain: (data,
    block size)}."""
    n = _size(L5_BLOCK, scale)
    parts = []
    for i in range(2 * n_devices):              # sparse / random / runs
        k = i % 3
        if k == 0:
            parts.append(np.repeat(
                rng.integers(0, 4, n // 4, dtype=np.uint8), 4)[:n])
        elif k == 1:
            parts.append(rng.integers(0, 256, n, dtype=np.uint8))
        else:
            parts.append(np.repeat(
                rng.integers(0, 2, n // 8, dtype=np.uint8), 8)[:n])
    l5 = np.concatenate(parts).tobytes() + b"tail" * 9

    # DNA, random and text blocks, n_devices of each; a random block
    # holds at least one full 16 KiB Huffman chunk whatever the scale (its
    # transforms gain nothing), so that every shard of D and E has one
    n2 = max(_size(L2_BLOCK, scale), dans.CHUNK)
    parts = []
    for i in range(3 * n_devices):
        k = i % 3
        if k == 0:
            parts.append(rng.choice(np.frombuffer(b"ACGT", np.uint8), n2))
        elif k == 1:
            parts.append(rng.integers(0, 256, n2, dtype=np.uint8))
        else:
            parts.append(np.frombuffer(
                (b"entropy block stream " * (n2 // 21 + 1))[:n2], np.uint8))
    l2 = np.concatenate(parts).tobytes()

    n36 = _size(L36_BLOCK, scale)
    m_parts = []
    for i in range(n_devices):                  # text / random / runs / 0
        k = i % 4
        if k == 0:
            m_parts.append(np.frombuffer(
                (b"the quick brown fox jumps over the lazy dog "
                 * (n36 // 44 + 1))[:n36], np.uint8))
        elif k == 1:
            m_parts.append(rng.integers(0, 256, n36, dtype=np.uint8))
        elif k == 2:
            m_parts.append(np.repeat(
                rng.integers(0, 4, n36 // 4, dtype=np.uint8), 4)[:n36])
        else:
            m_parts.append(np.zeros(n36, np.uint8))
    l36 = np.concatenate(m_parts).tobytes() + b"tail" * 11

    # l3 (Huffman) at blocks of at least one chunk: text and random in
    # turn, one random block (a full chunk) a device
    n3 = max(n36, dans.CHUNK)
    l3 = np.concatenate([
        np.frombuffer((b"the quick brown fox jumps over the lazy dog "
                       * (n3 // 44 + 1))[:n3], np.uint8) if i % 2 == 0
        else rng.integers(0, 256, n3, dtype=np.uint8)
        for i in range(2 * n_devices)]).tobytes() + b"tail" * 11

    n7 = min(_size(L7_BLOCK, scale), n36)
    l7 = np.concatenate([m_parts[i % len(m_parts)][:n7]
                         for i in range(n_devices)]).tobytes()
    return {"l5": (l5, n), "l2": (l2, n2), "l3": (l3, n3),
            "l6": (l36, n36), "l7": (l7, n7)}


CHAINS = {
    # name: (transform, entropy, compress, decompress)
    "l5": (pp.CHAIN, pp.ENTROPY, pp.compress_l5_mesh, pp.decompress_l5_mesh),
    "l2": (pp.CHAIN_L2, pp.ENTROPY_L2, pp.compress_l2_mesh,
           pp.decompress_l2_mesh),
    "l3": (pp.CHAIN_L3, pp.ENTROPY_L3, pp.compress_l3_mesh,
           pp.decompress_l3_mesh),
    "l6": (pp.CHAIN_L6, pp.ENTROPY_L6, pp.compress_l6_mesh,
           pp.decompress_l6_mesh),
    "l7": (pp.CHAIN_L7, pp.ENTROPY_L7, pp.compress_l7_mesh,
           pp.decompress_l7_mesh),
}


def _chunk_states(hdr: np.ndarray, bitlen: np.ndarray,
                  m: np.ndarray) -> np.ndarray:
    """The 4 lane states of each chunk of more than one symbol (m > 1):
    the last 128 bits of its ANS0 header (ops.ans.pack_headers); zeros
    for a header-only chunk."""
    states = np.zeros((len(bitlen), 4), np.uint32)
    for i, (h, bits) in enumerate(zip(hdr, bitlen)):
        if m[i] <= 1:
            continue
        r = BitReader(h.tobytes())
        r.read_bits(int(bits) - 128)
        states[i] = [r.read_bits(32) for _ in range(4)]
    return states


def _ans0_round_trip(chunks: np.ndarray, mesh) -> tuple:
    """shard_ans0_encode then shard_ans0_decode of [C, 16384] chunks that
    each hold more than one symbol. Returns (encode s, decode s)."""
    t0 = time.perf_counter()
    hdr, bitlen, m, flat, plen = shard_ans0_encode(chunks, mesh)
    te = time.perf_counter() - t0
    if not (m > 1).all():
        raise AssertionError("a round-trip chunk of one symbol")
    freqs = dans.normalize(dans.histogram(torch.from_numpy(chunks))).numpy()
    pay = np.zeros((len(chunks), dans.PAYLOAD_MAX + 2), np.uint8)
    off = np.cumsum(plen) - plen
    for i, (o, k) in enumerate(zip(off, plen)):
        pay[i, :k] = flat[o:o + k]
    t0 = time.perf_counter()
    out, cur = shard_ans0_decode(freqs, _chunk_states(hdr, bitlen, m), pay,
                                 mesh)
    td = time.perf_counter() - t0
    if not np.array_equal(out, chunks):
        raise AssertionError(f"sharded ANS0 round trip differs at "
                             f"{len(mesh)} device(s)")
    if not np.array_equal(cur, plen):
        raise AssertionError("sharded ANS0 decode consumed other payload "
                             "lengths")
    return te, td


def dryrun_multichip(mesh, scale: float = 1) -> dict:
    """Drive every mesh chain over ``mesh`` (block_mesh's devices; a
    device may repeat) and its 1-device submesh; raise on any difference.
    scale multiplies kanzi_tpu's block sizes (each at least 1024 bytes):
    the CPU tests cut them. Returns {"launches": {(chain, devices,
    "encode" | "decode"): the ops counters of that one call, reset just
    before it}, "scaling": the MESH_SCALING points}; prints the
    MESH_SCALING line."""
    mesh = block_mesh(mesh)
    k = len(mesh)
    rng = np.random.default_rng(1)
    inputs = _inputs(k, scale, rng)

    goldens = {}
    ops.disable()
    try:
        for name, (data, bs) in inputs.items():
            chain, entropy = CHAINS[name][:2]
            goldens[name] = compress_bytes(data, chain, entropy,
                                           block_size=bs)
    finally:
        ops.enable()

    launches = {}
    for name, (data, bs) in inputs.items():
        _, _, cm, dm = CHAINS[name]
        # l7, the slowest lockstep coder, at the full mesh only
        for sub in ((mesh,) if name == "l7" or k == 1
                    else (mesh[:1], mesh)):
            ops.reset_counters()
            ours = cm(data, bs, sub)
            launches[(name, len(sub), "encode")] = dict(ops.COUNTERS)
            if ours != goldens[name]:
                raise AssertionError(f"mesh {name} container differs from "
                                     f"the host writer's at {len(sub)} "
                                     "device(s)")
            ops.reset_counters()
            back = dm(ours, sub)
            launches[(name, len(sub), "decode")] = dict(ops.COUNTERS)
            if back != data:
                raise AssertionError(f"mesh {name} decode differs from the "
                                     f"input at {len(sub)} device(s)")
    if decompress_bytes(goldens["l5"], device=mesh[0]) != inputs["l5"][0]:
        raise AssertionError("the reader does not decode the l5 container")

    chunks = rng.integers(0, 64, (2 * k, dans.CHUNK), dtype=np.uint8)
    chunks[0] = np.frombuffer(
        (b"sharded entropy coding " * 800)[:dans.CHUNK], np.uint8)
    _ans0_round_trip(chunks, mesh)

    scaling = []
    sc_chunks = rng.integers(0, 48, (2 * k, dans.CHUNK), dtype=np.uint8)
    d = 1
    while d <= k:
        sub = mesh[:d]
        if sub[0].type == "cuda":      # the first call builds the kernels
            _ans0_round_trip(sc_chunks, sub)
        te, td = _ans0_round_trip(sc_chunks, sub)
        mb = sc_chunks.size / 1e6
        scaling.append({"devices": d, "ans0_enc_MBps": round(mb / te, 3),
                        "ans0_dec_MBps": round(mb / td, 3)})
        d *= 2
    print("MESH_SCALING " + json.dumps(
        {"mesh": [str(x) for x in mesh], "note":
         "host wall time of shard_ans0_encode / shard_ans0_decode (copies "
         "included) over the first d devices of the mesh; a device named "
         "more than once runs its shards in turn",
         "points": scaling}), flush=True)
    return {"launches": launches, "scaling": scaling}
