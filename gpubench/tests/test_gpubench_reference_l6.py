"""The level-6 reference decoder (gpubench/reference/kanzi_l6.py)
against streams the port's level-6 mesh chain makes on the CPU (the
kernels' plain versions), on broken streams, and in tiny traced runs of
the cells it adds beside."""

import json
import math
import os

import pytest
import torch

from gpubench import check, corpus
from gpubench.reference import kanzi_l6 as ref
from gpubench.run import ROOT
from gpubench.tests import tiny

BS = 16384
CFG = json.load(open(os.path.join(ROOT, "gpubench", "configs",
                                  "kanzi-l6.json")))


def sample(cls, n, seed=3):
    return corpus.CLASSES[cls](corpus.member_rng(seed, 0), n).tobytes()


def l6_stream(data, bs=BS):
    from kanzi_tpu_torch.parallel import pipeline
    return pipeline.compress_l6_mesh(data, bs, (torch.device("cpu"),))


@pytest.mark.parametrize("cls", ["prose", "exe", "image16", "xml"])
def test_reference_decodes_the_mesh_chains_stream(cls):
    """Two 16 KiB blocks and a tail of 999 bytes, block for block, and
    the header as the harness's check reads it."""
    data = sample(cls, 2 * BS + 999)
    blob = l6_stream(data)
    cfg = dict(CFG, block_size=BS)
    faults, hdr = check.container_faults(cfg, blob, len(data))
    assert faults == 0
    assert hdr["transforms"] == ["TEXT", "UTF", "BWT", "SRT", "ZRLT"]
    assert hdr["entropy"] == "FPAQ" and len(hdr["frames"]) == 3
    for k in range(3):
        assert ref.decode_block(hdr, k) == data[k * BS:(k + 1) * BS], k


@pytest.fixture(scope="module")
def prose_stream():
    data = sample("prose", BS + 5000)
    return data, l6_stream(data)


def test_truncated_stream_is_malformed(prose_stream):
    _, blob = prose_stream
    with pytest.raises(ref.Malformed):
        ref.parse(blob[:len(blob) - 40])


def test_flipped_fpaq_payload_byte_is_malformed(prose_stream):
    """A byte in the middle of block 0's FPAQ payload flipped: the chunk
    no longer ends where its coder does."""
    data, blob = prose_stream
    hdr = ref.parse(blob)
    payload, nbits = hdr["frames"][0]
    bad = bytearray(payload)
    bad[len(bad) // 2] ^= 0x5A
    hdr["frames"][0] = (bytes(bad), nbits)
    with pytest.raises(ref.Malformed):
        ref.decode_block(hdr, 0)
    assert ref.decode_block(hdr, 1) == data[BS:]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """tiny's root, with the level-6 configuration's blocks cut to 8 KiB
    too (its plain G and H step every stream in lockstep, ~1 ms a
    byte), and enwik8 at 40,000 bytes, so that a level-5 block has a
    full 16 KiB chunk for the ANS0 shards."""
    r = tiny.make_root(str(tmp_path_factory.mktemp("tiny_l6")))
    p = os.path.join(r, "gpubench", "configs", "kanzi-l6.json")
    json.dump(dict(CFG, block_size=8192), open(p, "w"))
    p = os.path.join(r, "gpubench", "traffic", "enwik8.json")
    tr = json.load(open(p))
    tr["members"][0]["size"] = 40000
    json.dump(tr, open(p, "w"))
    return r


def listed(root, cell):
    """The per-layer metrics that list the cell and that a CPU run can
    read: the device-trace ones read the card's kernels."""
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    return [m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", ()) and m["source"] != "device_trace"]


def test_tiny_traced_l6_silesia(root):
    rc, res = tiny.run(root, "l6.silesia", seed=2**31 + 61, trace=1)
    assert rc == 0 and res["correct"] is True
    got = res["metrics"]
    want = listed(root, "l6.silesia")
    assert len(want) == 18
    for name in want:
        assert math.isfinite(got[name]["value"]), name
    assert got["fpaq_relaunch_share.compress"]["value"] == 0.0
    assert got["card_bwt_share.compress"]["value"] == 0.0
    for name in ("entropy_stage_s_per_GB.compress",
                 "card_block_share.compress", "host_lzp_s_per_GB.compress"):
        assert name not in got, name


def test_tiny_traced_l5_enwik8(root):
    """Every block a text block: no block on the card's level-5 pass."""
    rc, res = tiny.run(root, "l5.enwik8", seed=2**31 + 62, trace=1)
    assert rc == 0 and res["correct"] is True
    got = res["metrics"]
    want = listed(root, "l5.enwik8")
    assert len(want) == 17
    for name in want:
        assert math.isfinite(got[name]["value"]), name
    assert got["card_block_share.compress"]["value"] == 0.0
    assert got["card_block_share.decompress"]["value"] == 0.0
    assert "bwt_stage_s_per_GB.compress" not in got


def test_tiny_l6_silesia_fault_is_not_correct(root):
    """The control: with the BWT stage the identity, every round trip
    still returns its input, but the reference's decode does not."""
    rc, res = tiny.run(root, "l6.silesia", seed=2**31 + 63,
                       fault="bwt_identity")
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["roundtrip_wrong_bytes"]["value"] == 0
    assert res["checks"]["ref_wrong_bytes"]["value"] > 0
