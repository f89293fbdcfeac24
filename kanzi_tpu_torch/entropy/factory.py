"""Entropy registry: 5-bit ids (src/entropy/EntropyEncoderFactory.hpp:37-98)."""

from __future__ import annotations

import enum

from kanzi_tpu_torch.bitstream import BitReader, BitWriter
from kanzi_tpu_torch.core.context import Context
from kanzi_tpu_torch.entropy.base import EntropyDecoder, EntropyEncoder


class EntropyType(enum.IntEnum):
    NONE = 0
    HUFFMAN = 1
    FPAQ = 2
    PAQ = 3      # obsolete
    RANGE = 4
    ANS0 = 5
    CM = 6
    TPAQ = 7
    ANS1 = 8
    TPAQX = 9


_NAME_TO_ID = {e.name: e for e in EntropyType if e != EntropyType.PAQ}


def entropy_name_to_type(name: str) -> int:
    key = name.strip().upper()
    if key not in _NAME_TO_ID:
        raise ValueError(f"Unknown entropy codec type: '{name}'")
    return int(_NAME_TO_ID[key])


def entropy_type_to_name(etype: int) -> str:
    t = EntropyType(etype)
    if t == EntropyType.PAQ:
        raise ValueError("obsolete entropy id 3")
    return t.name


_NATIVE_KIND = {}


def _native_kinds():
    if not _NATIVE_KIND:
        from kanzi_tpu_torch.entropy import native_bin as nb
        _NATIVE_KIND.update({
            EntropyType.FPAQ: nb.KIND_FPAQ,
            EntropyType.CM: nb.KIND_CM,
            EntropyType.TPAQ: nb.KIND_TPAQ,
            EntropyType.TPAQX: nb.KIND_TPAQX,
        })
    return _NATIVE_KIND


def new_encoder(obs: BitWriter, ctx: Context, etype: int) -> EntropyEncoder:
    t = EntropyType(etype)
    if t in (EntropyType.FPAQ, EntropyType.CM, EntropyType.TPAQ,
             EntropyType.TPAQX):
        from kanzi_tpu_torch.entropy import native_bin as nb
        if nb.native_bin_enabled():
            return nb.NativeBinEncoder(obs, ctx, _native_kinds()[t])
    if t == EntropyType.NONE:
        from kanzi_tpu_torch.entropy.null import NullEntropyEncoder
        return NullEntropyEncoder(obs, ctx)
    if t == EntropyType.HUFFMAN:
        from kanzi_tpu_torch.entropy.huffman import HuffmanEncoder
        return HuffmanEncoder(obs, ctx)
    if t == EntropyType.ANS0:
        from kanzi_tpu_torch.entropy.ans import ANSRangeEncoder
        return ANSRangeEncoder(obs, ctx, order=0)
    if t == EntropyType.ANS1:
        from kanzi_tpu_torch.entropy.ans import ANSRangeEncoder
        return ANSRangeEncoder(obs, ctx, order=1)
    if t == EntropyType.RANGE:
        from kanzi_tpu_torch.entropy.range_coder import RangeEncoder
        return RangeEncoder(obs, ctx)
    if t == EntropyType.FPAQ:
        from kanzi_tpu_torch.entropy.fpaq import FPAQEncoder
        return FPAQEncoder(obs, ctx)
    if t == EntropyType.CM:
        from kanzi_tpu_torch.entropy.binary import BinaryEntropyEncoder
        from kanzi_tpu_torch.entropy.cm import CMPredictor
        return BinaryEntropyEncoder(obs, ctx, CMPredictor(ctx))
    if t == EntropyType.TPAQ:
        from kanzi_tpu_torch.entropy.binary import BinaryEntropyEncoder
        from kanzi_tpu_torch.entropy.tpaq import TPAQPredictor
        return BinaryEntropyEncoder(obs, ctx, TPAQPredictor(ctx, extra=False))
    if t == EntropyType.TPAQX:
        from kanzi_tpu_torch.entropy.binary import BinaryEntropyEncoder
        from kanzi_tpu_torch.entropy.tpaq import TPAQPredictor
        return BinaryEntropyEncoder(obs, ctx, TPAQPredictor(ctx, extra=True))
    raise ValueError(f"Unknown entropy codec type: {etype}")


def new_decoder(ibs: BitReader, ctx: Context, etype: int) -> EntropyDecoder:
    t = EntropyType(etype)
    # FPAQDecoder queues its chunks in the level-6 mesh decode's sink, the
    # CM shell its payloads in the level-7 one's
    sink_key = {EntropyType.FPAQ: "_fpaqDecodeSink",
                EntropyType.CM: "_cmDecodeSink"}.get(t)
    to_sink = (sink_key is not None and ctx is not None
               and ctx.get(sink_key) is not None)
    if t in (EntropyType.FPAQ, EntropyType.CM, EntropyType.TPAQ,
             EntropyType.TPAQX) and not to_sink:
        from kanzi_tpu_torch.entropy import native_bin as nb
        if nb.native_bin_enabled():
            return nb.NativeBinDecoder(ibs, ctx, _native_kinds()[t])
    if t == EntropyType.NONE:
        from kanzi_tpu_torch.entropy.null import NullEntropyDecoder
        return NullEntropyDecoder(ibs, ctx)
    if t == EntropyType.HUFFMAN:
        from kanzi_tpu_torch.entropy.huffman import HuffmanDecoder
        return HuffmanDecoder(ibs, ctx)
    if t == EntropyType.ANS0:
        from kanzi_tpu_torch.entropy.ans import ANSRangeDecoder
        return ANSRangeDecoder(ibs, ctx, order=0)
    if t == EntropyType.ANS1:
        from kanzi_tpu_torch.entropy.ans import ANSRangeDecoder
        return ANSRangeDecoder(ibs, ctx, order=1)
    if t == EntropyType.RANGE:
        from kanzi_tpu_torch.entropy.range_coder import RangeDecoder
        return RangeDecoder(ibs, ctx)
    if t == EntropyType.FPAQ:
        from kanzi_tpu_torch.entropy.fpaq import FPAQDecoder
        return FPAQDecoder(ibs, ctx)
    if t == EntropyType.CM:
        from kanzi_tpu_torch.entropy.binary import BinaryEntropyDecoder
        from kanzi_tpu_torch.entropy.cm import CMPredictor
        return BinaryEntropyDecoder(ibs, ctx, CMPredictor(ctx))
    if t == EntropyType.TPAQ:
        from kanzi_tpu_torch.entropy.binary import BinaryEntropyDecoder
        from kanzi_tpu_torch.entropy.tpaq import TPAQPredictor
        return BinaryEntropyDecoder(ibs, ctx, TPAQPredictor(ctx, extra=False))
    if t == EntropyType.TPAQX:
        from kanzi_tpu_torch.entropy.binary import BinaryEntropyDecoder
        from kanzi_tpu_torch.entropy.tpaq import TPAQPredictor
        return BinaryEntropyDecoder(ibs, ctx, TPAQPredictor(ctx, extra=True))
    raise ValueError(f"Unknown entropy codec type: {etype}")
