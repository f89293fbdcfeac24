"""The plain reference decoder against streams the port's host writer
makes (the kernels' plain versions, on the CPU), and on broken streams."""

import pytest

from gpubench import corpus
from gpubench.reference import kanzi as ref


def stream(chain, entropy, data, bs):
    import kanzi_tpu_torch.ops as kops
    from kanzi_tpu_torch.io.compressed_stream import compress_bytes
    kops.disable()
    try:
        return compress_bytes(data, transform=chain, entropy=entropy,
                              block_size=bs)
    finally:
        kops.enable()


def sample(cls, n, seed=3):
    return corpus.CLASSES[cls](corpus.member_rng(seed, 0), n).tobytes()


@pytest.mark.parametrize("chain,entropy,cls,bs", [
    ("LZP+TEXT+UTF+BWT+LZP", "CM", "wiki", 16384),
    ("LZP+TEXT+UTF+BWT+LZP", "CM", "polish", 16384),
    ("TEXT+UTF+BWT+RANK+ZRLT", "ANS0", "prose", 32768),
    ("TEXT+UTF+BWT+RANK+ZRLT", "ANS0", "exe", 32768),
    ("TEXT+UTF+BWT+RANK+ZRLT", "ANS0", "image16", 32768),
])
def test_reference_decodes_the_writers_stream(chain, entropy, cls, bs):
    data = sample(cls, 2 * bs + 999)
    blob = stream(chain, entropy, data, bs)
    hdr = ref.parse(blob)
    assert hdr["entropy"] == entropy
    assert hdr["transforms"] == chain.split("+")
    assert hdr["block_size"] == bs and hdr["size"] == len(data)
    got = b"".join(ref.decode_block(hdr, k) for k in range(len(hdr["frames"])))
    assert got == data


def test_broken_streams_are_caught():
    data = sample("prose", 40000)
    blob = bytearray(stream("TEXT+UTF+BWT+RANK+ZRLT", "ANS0", data, 32768))
    with pytest.raises(ref.Malformed):
        ref.parse(b"XXXX" + bytes(blob[4:]))
    bad = bytearray(blob)
    bad[12] ^= 0x10                          # the header's checksum breaks
    with pytest.raises(ref.Malformed):
        ref.parse(bytes(bad))
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x5A               # a byte of block 0's payload
    hdr = ref.parse(bytes(bad))
    try:
        got = ref.decode_block(hdr, 0)
    except ref.Malformed:
        return
    assert got != data[:32768]
