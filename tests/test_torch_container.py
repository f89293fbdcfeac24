"""The port's container (kanzi_tpu_torch) against kanzi_tpu's, byte for
byte, on the CPU: the port's kernel wrappers run their plain PyTorch
versions there, kanzi_tpu its JAX path on the CPU backend. Each output
also decodes through the other package."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kanzi_tpu
import kanzi_tpu.api
from kanzi_tpu.app.cli import LEVEL_TABLE

import kanzi_tpu_torch
import kanzi_tpu_torch.ops as tops
from kanzi_tpu_torch.api import Compressor, Decompressor
from kanzi_tpu_torch.app.cli import main as cli_main
from kanzi_tpu_torch.entropy.ans import ans0_flush_sink
from kanzi_tpu_torch.ops import ans as tans

ROOT = Path(__file__).resolve().parent.parent
KIB = 1024
CHUNK = tans.CHUNK
L5 = LEVEL_TABLE[5]
# (the Huffman encode packs its own pair stream: no compaction B)
HUFF = ("huff_code_tables_plain", "huff_pack_plain", "huff_decode_plain")
ANS0 = ("ans0_encode_scan_plain", "ans0_compact_plain", "ans0_decode_plain")
# the kernels (plain versions here) each level's entropy stage runs; level
# 4's ROLZ codes its literal sub-stream with ANS0
LEVEL_KERNELS = {2: HUFF, 3: HUFF, 4: ANS0, 5: ANS0}


def _text(rng, n):
    words = [b"the", b"quick", b"brown", b"fox", b"entropy", b"kanzi",
             b"block", b"stream", b"device", b"kernel", b"suffix"]
    out = b" ".join(words[i] for i in rng.integers(0, len(words), n // 4))
    return out[:n]


def _mixed(seed, n):
    """Text, random bytes, zeros and a small alphabet: every chunk class
    (normal, incompressible, single-symbol) and a ragged tail."""
    rng = np.random.default_rng(seed)
    q = n // 4
    return (_text(rng, q) + rng.integers(0, 256, q, dtype=np.uint8).tobytes()
            + bytes(q) + rng.choice(np.arange(5, dtype=np.uint8),
                                    n - 3 * q).tobytes())


def _l5_data(seed):
    """Two 64 KiB blocks whose transform output stays above 16 KiB at
    every level, so the ANS0 and Huffman stages have full chunks."""
    rng = np.random.default_rng(seed)
    return (_text(rng, 40 * KIB)
            + rng.integers(0, 256, 88 * KIB, dtype=np.uint8).tobytes())


@pytest.fixture(autouse=True)
def _device_path_enabled():
    tops.enable()
    tops.reset_counters()
    yield
    tops.enable()


def test_none_ans0_matches_kanzi_tpu():
    data = _mixed(1, 3 * 64 * KIB + 5000)       # 3 blocks + a tail
    ours = kanzi_tpu_torch.compress_bytes(data, "NONE", "ANS0",
                                          block_size=64 * KIB, device="cpu")
    assert tops.COUNTERS.get("ans0_encode_scan_plain") == 1
    assert tops.COUNTERS.get("ans0_compact_plain") == 1
    ref = kanzi_tpu.compress_bytes(data, "NONE", "ANS0", block_size=64 * KIB)
    assert ours == ref
    assert kanzi_tpu_torch.decompress_bytes(ref, device="cpu") == data
    assert tops.COUNTERS.get("ans0_decode_plain") == 1
    assert kanzi_tpu.decompress_bytes(ours) == data


@pytest.mark.parametrize("transform,entropy", [
    *(LEVEL_TABLE[lv] for lv in range(10)),
    ("NONE", "HUFFMAN"), ("LZX", "NONE"), ("LZ", "ANS0")],
    ids=[*(f"level{lv}" for lv in range(10)), "NONE-HUFFMAN", "LZX-NONE",
         "LZ-ANS0"])
def test_chain_matches_kanzi_tpu(transform, entropy):
    """Every level 0-9 and the chains the port once refused: the port's
    output == kanzi_tpu's, and each decodes through the other package."""
    data = _l5_data(2)
    ours = kanzi_tpu_torch.compress_bytes(data, transform, entropy,
                                          block_size=64 * KIB, device="cpu")
    level = {te: lv for lv, te in LEVEL_TABLE.items()}.get(
        (transform, entropy))
    kernels = LEVEL_KERNELS.get(level, ())
    assert all(tops.COUNTERS.get(k, 0) >= 1 for k in kernels
               if "decode" not in k), tops.COUNTERS
    assert ours == kanzi_tpu.compress_bytes(data, transform, entropy,
                                            block_size=64 * KIB)
    assert kanzi_tpu_torch.decompress_bytes(ours, device="cpu") == data
    assert all(tops.COUNTERS.get(k, 0) >= 1 for k in kernels), tops.COUNTERS
    assert kanzi_tpu.decompress_bytes(ours) == data


def test_none_huffman_matches_kanzi_tpu():
    """-t NONE -e HUFFMAN over 3 blocks and a tail: one batched encode
    for every block's full chunks (no compaction B), one decode per
    block."""
    data = _mixed(9, 3 * 64 * KIB + 5000)
    ours = kanzi_tpu_torch.compress_bytes(data, "NONE", "HUFFMAN",
                                          block_size=64 * KIB, device="cpu")
    assert tops.COUNTERS.get("huff_code_tables_plain") == 1
    assert tops.COUNTERS.get("huff_pack_plain") == 1
    assert "ans0_compact_plain" not in tops.COUNTERS
    ref = kanzi_tpu.compress_bytes(data, "NONE", "HUFFMAN",
                                   block_size=64 * KIB)
    assert ours == ref
    assert kanzi_tpu_torch.decompress_bytes(ref, device="cpu") == data
    assert tops.COUNTERS.get("huff_decode_plain") == 3
    assert kanzi_tpu.decompress_bytes(ours) == data


def test_checksums_and_parallel_decode():
    """-x64 block checksums; -j 2 decodes blocks on worker threads, each
    with its own device call."""
    data = _mixed(3, 4 * 32 * KIB)
    blob = kanzi_tpu_torch.compress_bytes(data, "NONE", "ANS0",
                                          block_size=32 * KIB,
                                          checksum_bits=64, device="cpu")
    assert blob == kanzi_tpu.compress_bytes(data, "NONE", "ANS0",
                                            block_size=32 * KIB,
                                            checksum_bits=64)
    assert kanzi_tpu_torch.decompress_bytes(blob, jobs=2,
                                            device="cpu") == data
    assert tops.COUNTERS.get("ans0_decode_plain", 0) >= 2


def test_disabled_runs_the_host_path():
    data = _mixed(4, 64 * KIB)
    dev = kanzi_tpu_torch.compress_bytes(data, "NONE", "ANS0",
                                         block_size=64 * KIB, device="cpu")
    tops.reset_counters()
    tops.disable()
    host = kanzi_tpu_torch.compress_bytes(data, "NONE", "ANS0",
                                          block_size=64 * KIB)
    assert kanzi_tpu_torch.decompress_bytes(host) == data
    assert host == dev
    assert tops.COUNTERS == {}


def test_decode_sink_rejects_a_wrong_payload_size():
    """A chunk whose decode consumes another byte count than its header
    announced raises (the check that catches corrupt payloads)."""
    chunk = torch.from_numpy(
        np.frombuffer(_mixed(5, CHUNK), np.uint8).reshape(1, CHUNK).copy())
    freqs = tans.normalize(tans.histogram(chunk))
    states, vm, nren = tans.ans0_encode_scan(chunk,
                                             *tans.encode_tables(freqs))
    n16 = int(nren.sum())
    pay = tans.compact_rows(vm, torch.zeros(1, dtype=torch.int64),
                            n16).numpy().tobytes()
    good = (0, freqs[0].numpy(), states[0].numpy().astype(np.uint32), pay,
            2 * n16)
    out = np.zeros(CHUNK, np.uint8)
    ans0_flush_sink([(out, [good])], {"device": "cpu"})
    assert np.array_equal(out, chunk[0].numpy())
    bad = good[:3] + (pay + b"\0\0", 2 * n16 + 2)
    with pytest.raises(ValueError, match="size mismatch"):
        ans0_flush_sink([(out, [bad])], {"device": "cpu"})


def test_api_roundtrip(tmp_path):
    """kanzi_tpu_torch.api over a file with both packages' defaults (LZ
    and HUFFMAN), byte-identical with kanzi_tpu.api fed the same
    calls."""
    data = _mixed(6, 100 * KIB)
    ours, ref = tmp_path / "a.knz", tmp_path / "b.knz"
    for cls, path, kw in ((Compressor, ours, {"device": "cpu"}),
                          (kanzi_tpu.api.Compressor, ref, {})):
        with cls(str(path), block_size=64 * KIB, **kw) as c:
            c.compress(data[:64 * KIB])
            c.compress(data[64 * KIB:])
    assert ours.read_bytes() == ref.read_bytes()
    with Decompressor(str(ours), device="cpu") as d:
        assert d.decompress() == data
    assert tops.COUNTERS.get("huff_pack_plain", 0) >= 1


def test_cli_roundtrip(tmp_path):
    """python -m kanzi_tpu_torch -c -l 5 / -d, output equal to
    kanzi_tpu's."""
    data = _l5_data(7)
    src, knz, out = tmp_path / "in.bin", tmp_path / "in.knz", tmp_path / "o"
    src.write_bytes(data)
    for args in (["-c", "-l", "5", "-b", "64k", "-i", str(src), "-o",
                  str(knz)], ["-d", "-i", str(knz), "-o", str(out)]):
        r = subprocess.run([sys.executable, "-m", "kanzi_tpu_torch", "-f",
                            "--device", "cpu", *args], cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
    assert out.read_bytes() == data
    assert knz.read_bytes() == kanzi_tpu.compress_bytes(
        data, *L5, block_size=64 * KIB)


@pytest.mark.parametrize("transform,entropy", [("NONE", "ANS1")])
def test_not_yet_ported_raises(transform, entropy):
    """The coders the port once refused: none is left, so each writes
    kanzi_tpu's bytes and reads kanzi_tpu's back (ANS1 blocks below one
    4 MiB order-1 chunk take the host coder, as in kanzi_tpu)."""
    data = _mixed(12, 100 * KIB)
    ours = kanzi_tpu_torch.compress_bytes(data, transform, entropy,
                                          block_size=64 * KIB, device="cpu")
    blob = kanzi_tpu.compress_bytes(data, transform, entropy,
                                    block_size=64 * KIB)
    assert ours == blob
    assert kanzi_tpu_torch.decompress_bytes(blob, device="cpu") == data
    assert tops.COUNTERS == {}


def test_cli_default_level_roundtrip(tmp_path):
    """python -m kanzi_tpu_torch -c with no -l/-t/-e runs level 3
    (TEXT+UTF+PACK+MM+LZX and HUFFMAN), output equal to kanzi_tpu's."""
    data = _l5_data(10)
    src, knz, out = tmp_path / "in.bin", tmp_path / "in.knz", tmp_path / "o"
    src.write_bytes(data)
    assert cli_main(["-c", "-b", "64k", "-f", "--device", "cpu", "-i",
                     str(src), "-o", str(knz)]) == 0
    assert tops.COUNTERS.get("huff_pack_plain", 0) >= 1
    assert knz.read_bytes() == kanzi_tpu.compress_bytes(
        data, *LEVEL_TABLE[3], block_size=64 * KIB)
    assert cli_main(["-d", "-f", "--device", "cpu", "-i", str(knz), "-o",
                     str(out)]) == 0
    assert tops.COUNTERS.get("huff_decode_plain", 0) >= 1
    assert out.read_bytes() == data


def test_cli_file_workers_and_info(tmp_path, capsys):
    """-j 2 on a directory compresses its files on a pool of file
    workers, each output equal to kanzi_tpu's; -y prints each header."""
    files = {tmp_path / "d" / f"{k}.bin": _l5_data(11 + k) for k in range(2)}
    for path, data in files.items():
        path.parent.mkdir(exist_ok=True)
        path.write_bytes(data)
    assert cli_main(["-c", "-l", "2", "-b", "64k", "-j", "2", "-f", "-v",
                     "0", "--device", "cpu", "-i", str(tmp_path / "d")]) == 0
    for path, data in files.items():
        knz = path.with_name(path.name + ".knz")
        assert knz.read_bytes() == kanzi_tpu.compress_bytes(
            data, *LEVEL_TABLE[2], block_size=64 * KIB)
    capsys.readouterr()
    assert cli_main(["-y", "--device", "cpu", "-i",
                     str(tmp_path / "d" / "0.bin.knz")]) == 0
    out = capsys.readouterr().out
    assert "0.bin.knz" in out and str(len(files[tmp_path / "d" / "0.bin"])) \
        in out


def test_host_path_without_native_libraries(monkeypatch):
    """With the device path off and no native C++ library, the coder's
    numpy fallback still writes kanzi_tpu's bytes and reads them back."""
    from kanzi_tpu_torch.utils import native
    data = _mixed(8, 40 * KIB)
    ref = kanzi_tpu.compress_bytes(data, "NONE", "ANS0", block_size=64 * KIB)
    monkeypatch.setattr(native, "transforms_available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    tops.disable()
    blob = kanzi_tpu_torch.compress_bytes(data, "NONE", "ANS0",
                                          block_size=64 * KIB)
    assert blob == ref
    assert kanzi_tpu_torch.decompress_bytes(blob) == data
