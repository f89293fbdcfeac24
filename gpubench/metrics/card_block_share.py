"""card_block_share.<phase>: the blocks whose device stage ran on the
card over the blocks of the phase's calls, in %, from the program's
counters (kanzi_tpu_torch.ops.COUNTERS): l5_encode_device_blocks and
l5_decode_device_blocks for ANS0 files, l7_decode_device_blocks and the
blocks less cm_host_blocks for CM files."""

SPANS = {}


def read(t, phase):
    calls = t.calls_of(phase)
    blocks = sum(c["blocks"] for c in calls)
    if not blocks:
        return None
    delta = {}
    for c in calls:
        for k, v in c["counters"].items():
            delta[k] = delta.get(k, 0) + v
    ent = t.config["entropy"]
    if ent == "ANS0":
        key = "l5_encode_device_blocks" if phase == "compress" else \
            "l5_decode_device_blocks"
        card = delta.get(key, 0)
    elif ent == "CM":
        card = (blocks - delta.get("cm_host_blocks", 0)
                if phase == "compress" and delta.get("cm_encode", 0)
                else delta.get("l7_decode_device_blocks", 0))
    else:
        return None
    return 100.0 * card / blocks
