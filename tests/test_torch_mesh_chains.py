"""PyTorch port of the level-2, 3, 6 and 7 mesh chains
(kanzi_tpu_torch.parallel.pipeline) against the host writers of both
packages, byte for byte: the format is exact, so every tolerance here is
exact equality.

tests/test_mesh_chains.py holds kanzi_tpu's host writer equal to
kanzi_tpu's mesh chains; here the port's chains on the CPU (the kernels'
plain versions: Huffman's D and E, FPAQ's G and H, CM's I and J) are
held equal to the port's host writer and to kanzi_tpu's, on that file's
mixed data.
"""

import numpy as np
import pytest
import torch

import kanzi_tpu.ops as kops
from kanzi_tpu.io.compressed_stream import compress_bytes as ref_compress

import kanzi_tpu_torch
import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.ops import huffman as thuff
from kanzi_tpu_torch.parallel import mesh as tmesh
from kanzi_tpu_torch.parallel import pipeline as tpp

CPU = torch.device("cpu")
MESH = (CPU,)


def _mixed(rng, n, blocks):
    """tests/test_mesh_chains.py's data: text, random, runs of a 4-symbol
    alphabet and zeros in turn, then a 44-byte tail."""
    parts = []
    for i in range(blocks):
        k = i % 4
        if k == 0:
            parts.append(np.frombuffer(
                (b"the quick brown fox jumps over the lazy dog " * 800)
                [:n], np.uint8))
        elif k == 1:
            parts.append(rng.integers(0, 256, n, dtype=np.uint8))
        elif k == 2:
            parts.append(np.repeat(
                rng.integers(0, 4, n // 4, dtype=np.uint8), 4)[:n])
        else:
            parts.append(np.zeros(n, np.uint8))
    return np.concatenate(parts).tobytes() + b"tail" * 11


def _host_writers(data, chain, entropy, n):
    """The port's and kanzi_tpu's host writers (their ops disabled)."""
    tops.disable()
    kops.disable()
    try:
        return (kanzi_tpu_torch.compress_bytes(data, chain, entropy,
                                               block_size=n),
                ref_compress(data, chain, entropy, block_size=n))
    finally:
        tops.enable()
        kops.enable()


LEVELS = {
    # level: (compress, decompress, chain, entropy, block size, blocks,
    #         the plain versions' launches each way; on compress, the
    #         BWT stage's input bytes, on the host from a CPU mesh)
    "l2": (tpp.compress_l2_mesh, tpp.decompress_l2_mesh, tpp.CHAIN_L2,
           tpp.ENTROPY_L2, 16384, 5,
           {"huff_code_tables_plain": 1, "huff_pack_plain": 1},
           {"huff_decode_plain": 1}),
    "l3": (tpp.compress_l3_mesh, tpp.decompress_l3_mesh, tpp.CHAIN_L3,
           tpp.ENTROPY_L3, 16384, 5,
           {"huff_code_tables_plain": 1, "huff_pack_plain": 1},
           {"huff_decode_plain": 1}),
    "l6": (tpp.compress_l6_mesh, tpp.decompress_l6_mesh, tpp.CHAIN_L6,
           tpp.ENTROPY_L6, 8192, 4,
           {"fpaq_encode_plain": 1, "bwt_forward_host_bytes": 30586},
           {"fpaq_decode_plain": 1, "l6_decode_device_blocks": 5}),
    # 4 KiB blocks, 3 of them, as tests/test_mesh_chains.py has for l7
    "l7": (tpp.compress_l7_mesh, tpp.decompress_l7_mesh, tpp.CHAIN_L7,
           tpp.ENTROPY_L7, 4096, 3,
           {"cm_encode_plain": 1, "bwt_forward_host_bytes": 8309},
           {"cm_decode_plain": 1, "l7_decode_device_blocks": 4}),
}


@pytest.mark.timeout(600)
@pytest.mark.parametrize("level", sorted(LEVELS))
def test_mesh_chain_matches_host_writers(level):
    """compress_lN_mesh on the CPU == the port's host writer ==
    kanzi_tpu's host writer; decompress_lN_mesh returns the input from
    it (so from kanzi_tpu's bytes too), with every block's entropy stage
    in one launch of each plain version: D (code tables, pack) and E for
    Huffman; G and H, and all 5 blocks (the 44-byte tail among them) on
    the decode's stream batch, for FPAQ; I and J, all 4 blocks, the same
    way for CM."""
    cm, dm, chain, entropy, n, blocks, enc_counts, dec_counts = LEVELS[level]
    data = _mixed(np.random.default_rng(31), n, blocks)
    ours_host, theirs_host = _host_writers(data, chain, entropy, n)
    tops.reset_counters()
    blob = cm(data, n, MESH)
    assert tops.COUNTERS == enc_counts
    assert blob == ours_host
    assert blob == theirs_host
    tops.reset_counters()
    assert dm(blob, MESH) == data
    assert tops.COUNTERS == dec_counts


@pytest.mark.timeout(300)
def test_checksums_and_short_blocks():
    """A container with block checksums decodes through the same sink
    (the reader checks each block's checksum after its inverse
    transforms): every full chunk in one launch of E. A block of at most
    32 bytes (stored raw) takes the host decode alone. Both return the
    input. The same for level 7: the checksummed container in one launch
    of J, all 3 blocks; a last block of 20 bytes is CM-coded and goes to
    J with the first."""
    data = _mixed(np.random.default_rng(5), 16384, 2)
    tops.disable()
    try:
        blob = kanzi_tpu_torch.compress_bytes(
            data, tpp.CHAIN_L2, tpp.ENTROPY_L2, block_size=16384,
            checksum_bits=32)
    finally:
        tops.enable()
    tops.reset_counters()
    assert tpp.decompress_l2_mesh(blob, MESH) == data
    assert tops.COUNTERS == {"huff_decode_plain": 1}
    blob = tpp.compress_l2_mesh(data[:16384 + 20], 16384, MESH)
    tops.reset_counters()
    assert tpp.decompress_l2_mesh(blob, MESH) == data[:16384 + 20]
    assert tops.COUNTERS == {}     # LZ leaves the text block < 16 KiB

    data = _mixed(np.random.default_rng(5), 4096, 2)
    tops.disable()
    try:
        blob = kanzi_tpu_torch.compress_bytes(
            data, tpp.CHAIN_L7, tpp.ENTROPY_L7, block_size=4096,
            checksum_bits=32)
    finally:
        tops.enable()
    tops.reset_counters()
    assert tpp.decompress_l7_mesh(blob, MESH) == data
    assert tops.COUNTERS == {"cm_decode_plain": 1,
                             "l7_decode_device_blocks": 3}
    blob = tpp.compress_l7_mesh(data[:4096 + 20], 4096, MESH)
    tops.reset_counters()
    assert tpp.decompress_l7_mesh(blob, MESH) == data[:4096 + 20]
    assert tops.COUNTERS == {"cm_decode_plain": 1,
                             "l7_decode_device_blocks": 2}


def _queued_huffman(blob):
    """decompress_l2_mesh's reader, keeping a copy of every entry that
    HuffmanDecoder queues in the sink: (its block's length, chunk
    indexes, codes, sizes, fragments, bounds)."""
    seen = []

    def flush(entries):
        seen.extend([(len(e[0]),) + tuple(np.asarray(x, np.int64)
                                           for x in e[1:]) for e in entries])
        tpp._flush_huffman(entries, MESH)

    r = tpp.CompressedReader(blob, device=CPU,
                             decode_sinks={"_huffDecodeSink": flush},
                             sink_window=tpp.MAX_BLOCK_ID)
    return r.read_all(), seen


@pytest.mark.timeout(300)
def test_huffman_parse_without_native(monkeypatch):
    """Without the native header parse, HuffmanDecoder reads the chunk
    headers in Python as kanzi_tpu does and queues the same card chunks,
    codes, sizes and fragments in the level-2 decode's sink as the
    native parse; the decode returns the input either way."""
    from kanzi_tpu_torch.utils import native
    data = _mixed(np.random.default_rng(31), 16384, 5)
    blob = tpp.compress_l2_mesh(data, 16384, MESH)
    out, fast = _queued_huffman(blob)
    assert out == data
    monkeypatch.setattr(native, "huff_parse_available", lambda: False)
    out, slow = _queued_huffman(blob)
    assert out == data
    assert len(fast) == len(slow) >= 1
    for f, s in zip(fast, slow):
        assert f[0] == s[0]
        for a, b in zip(f[1:], s[1:]):
            assert np.array_equal(a, b)


@pytest.mark.timeout(300)
def test_shard_huffman_and_fpaq():
    """shard_huffman_encode's chunks decode back through
    shard_huffman_decode, with kanzi_tpu's [C, 4, row] fragment rows
    made flat (flat_fragments); a chunk of one symbol has a header and
    no pairs. shard_fpaq_encode, framed as the container frames it,
    decodes back through shard_fpaq_decode from the chunk records."""
    rng = np.random.default_rng(9)
    chunks = rng.integers(0, 30, (2, thuff.CHUNK), dtype=np.uint8)
    chunks[1] = 5
    hdr, hdr_bits, ok, m, flat, npairs, acc, nb, frag_bits = (
        tmesh.shard_huffman_encode(chunks, MESH))
    assert list(ok) == [True, False] and not npairs[1].any()
    codes, sizes = thuff.compute_code_tables(
        torch.from_numpy(np.bincount(chunks[0], minlength=256)[None]))[:2]
    # kanzi_tpu's layout: each fragment's bytes in a padded row, its
    # 16-bit pairs and then its last nb bits (acc's low bits, MSB first)
    frag_bytes = (frag_bits[:1] + 7) // 8
    rows = np.zeros((1, 4, thuff.FRAG_MAX_BYTES + 2), np.uint8)
    base = 0
    for f in range(4):
        k, n_bits = int(npairs[0, f]), int(nb[0, f])
        tail = [(int(acc[0, f]) >> (n_bits - 1 - j)) & 1
                for j in range(n_bits)]
        frag = np.concatenate([flat[2 * base:2 * (base + k)],
                               np.packbits(np.array(tail, np.uint8))])
        rows[0, f, :len(frag)] = frag
        base += k
    pay, bounds = thuff.flat_fragments(rows, frag_bytes)
    dec = tmesh.shard_huffman_decode(codes.numpy(), sizes.numpy(), pay,
                                     bounds, MESH)
    assert np.array_equal(dec[0], chunks[0])

    lens = np.array([3000, 700])
    streams = rng.integers(0, 9, (2, 3000), dtype=np.uint8)
    bufs, low56, _, _ = tmesh.shard_fpaq_encode(streams, lens, MESH, 4096)
    frames = []
    for w, low in zip(bufs, low56):
        tail = w + low.to_bytes(7, "big")
        frames.append([(int.from_bytes(tail[:7], "big"), tail[7:7 + len(w)])])
    out = tmesh.shard_fpaq_decode(frames, lens, MESH, 4096)
    assert np.array_equal(out[0], streams[0])
    assert np.array_equal(out[1, :700], streams[1, :700])
