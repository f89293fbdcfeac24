"""card_bwt_share.<phase>: the input bytes of the phase's BWT forwards
(kanzi_tpu_torch/transform/bwt.py bwt_forward: every chain's BWT stage
but the level-5 chain's batched pass) that ran on the card, over those of
every such forward, in %, from the program's counters
(kanzi_tpu_torch.ops.COUNTERS): bwt_forward_device_bytes over it plus
bwt_forward_host_bytes. None where no such forward ran, or where the
program has neither counter."""

SPANS = {}


def read(t, phase):
    card = host = 0
    for c in t.calls_of(phase):
        counters = c.get("counters", {})
        card += counters.get("bwt_forward_device_bytes", 0)
        host += counters.get("bwt_forward_host_bytes", 0)
    if not card + host:
        return None
    return 100.0 * card / (card + host)
