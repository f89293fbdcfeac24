"""Transform registry: 6-bit ids, 48-bit packed chains, name parsing.

Mirrors TransformFactory<T> (src/transform/TransformFactory.hpp:49-308):
8 x 6-bit transform ids packed MSB-first into 48 bits; "A+B+C" names;
NONE tokens are elided during packing. TEXT picks its codec variant from
the entropy backend (:228-243); DNA is PACK with packOnlyDNA=1 (:293-295).
"""

from __future__ import annotations

import enum

from kanzi_tpu_torch.core.context import Context
from kanzi_tpu_torch.transform.sequence import TransformSequence

ONE_SHIFT = 6
MAX_SHIFT = 7 * ONE_SHIFT
MASK = (1 << ONE_SHIFT) - 1


class TransformType(enum.IntEnum):
    NONE = 0
    BWT = 1
    BWTS = 2
    LZ = 3
    SNAPPY = 4   # obsolete
    RLT = 5
    ZRLT = 6
    MTFT = 7
    RANK = 8
    EXE = 9
    DICT = 10    # TEXT
    ROLZ = 11
    ROLZX = 12
    SRT = 13
    LZP = 14
    MM = 15
    LZX = 16
    UTF = 17
    PACK = 18
    DNA = 19


_NAME_TO_ID = {
    "TEXT": TransformType.DICT, "BWT": TransformType.BWT,
    "BWTS": TransformType.BWTS, "ROLZ": TransformType.ROLZ,
    "ROLZX": TransformType.ROLZX, "MTFT": TransformType.MTFT,
    "ZRLT": TransformType.ZRLT, "RLT": TransformType.RLT,
    "SRT": TransformType.SRT, "RANK": TransformType.RANK,
    "LZ": TransformType.LZ, "LZX": TransformType.LZX,
    "LZP": TransformType.LZP, "EXE": TransformType.EXE,
    "UTF": TransformType.UTF, "PACK": TransformType.PACK,
    "DNA": TransformType.DNA, "MM": TransformType.MM,
    "NONE": TransformType.NONE,
}

_ID_TO_NAME = {v: k for k, v in _NAME_TO_ID.items()}
_ID_TO_NAME[TransformType.DICT] = "TEXT"

NONE_TYPE = 0


def transform_name_to_type(name: str) -> int:
    """Pack an 'A+B+C' chain name into the 48-bit descriptor."""
    tokens = [t for t in name.strip().split("+") if t]
    if len(tokens) > 8:
        raise ValueError(f"Only 8 transforms allowed: {name}")
    res = 0
    shift = MAX_SHIFT
    for tok in tokens:
        key = tok.upper()
        if key not in _NAME_TO_ID:
            raise ValueError(f"Unknown transform type: '{tok}'")
        tid = int(_NAME_TO_ID[key])
        if tid != NONE_TYPE:
            res |= tid << shift
            shift -= ONE_SHIFT
    return res


def transform_type_to_name(ttype: int) -> str:
    """Unpack the 48-bit descriptor into an 'A+B+C' name."""
    names = []
    for i in range(8):
        tid = (ttype >> (MAX_SHIFT - ONE_SHIFT * i)) & MASK
        if tid == NONE_TYPE:
            continue
        if tid not in _ID_TO_NAME:
            raise ValueError(f"Unknown transform id: {tid}")
        names.append(_ID_TO_NAME[TransformType(tid)])
    return "+".join(names) if names else "NONE"


def _new_token(ctx: Context, tid: int):
    from kanzi_tpu_torch.transform.null import NullTransform

    t = TransformType(tid)
    if t == TransformType.NONE:
        return NullTransform(ctx)
    if t == TransformType.BWT:
        from kanzi_tpu_torch.transform.bwt import BWTBlockCodec
        return BWTBlockCodec(ctx)
    if t == TransformType.BWTS:
        from kanzi_tpu_torch.transform.bwts import BWTS
        return BWTS(ctx)
    if t == TransformType.LZ:
        from kanzi_tpu_torch.transform.lz import LZCodec
        return LZCodec(ctx, extra=False)
    if t == TransformType.LZX:
        from kanzi_tpu_torch.transform.lz import LZCodec
        return LZCodec(ctx, extra=True)
    if t == TransformType.LZP:
        from kanzi_tpu_torch.transform.lz import LZPCodec
        return LZPCodec(ctx)
    if t == TransformType.RLT:
        from kanzi_tpu_torch.transform.rlt import RLT
        return RLT(ctx)
    if t == TransformType.ZRLT:
        from kanzi_tpu_torch.transform.zrlt import ZRLT
        return ZRLT(ctx)
    if t == TransformType.MTFT:
        from kanzi_tpu_torch.transform.sbrt import SBRT, MODE_MTF
        return SBRT(ctx, MODE_MTF)
    if t == TransformType.RANK:
        from kanzi_tpu_torch.transform.sbrt import SBRT, MODE_RANK
        return SBRT(ctx, MODE_RANK)
    if t == TransformType.SRT:
        from kanzi_tpu_torch.transform.srt import SRT
        return SRT(ctx)
    if t == TransformType.EXE:
        from kanzi_tpu_torch.transform.exe import EXECodec
        return EXECodec(ctx)
    if t == TransformType.DICT:
        from kanzi_tpu_torch.transform.text import TextCodec
        # variant by entropy backend, reference TransformFactory.hpp:228-243
        variant = 1
        ent = ctx.get_str("entropy", "").upper()
        if ent in ("NONE", "ANS0", "HUFFMAN", "RANGE"):
            variant = 2
        ctx.put("textcodec", variant)
        return TextCodec(ctx, variant)
    if t == TransformType.ROLZ:
        from kanzi_tpu_torch.transform.rolz import ROLZCodec
        return ROLZCodec(ctx, extra=False)
    if t == TransformType.ROLZX:
        from kanzi_tpu_torch.transform.rolz import ROLZCodec
        return ROLZCodec(ctx, extra=True)
    if t == TransformType.MM:
        from kanzi_tpu_torch.transform.fsd import FSDCodec
        return FSDCodec(ctx)
    if t == TransformType.UTF:
        from kanzi_tpu_torch.transform.utf import UTFCodec
        return UTFCodec(ctx)
    if t == TransformType.PACK:
        from kanzi_tpu_torch.transform.alias import AliasCodec
        return AliasCodec(ctx, only_dna=False)
    if t == TransformType.DNA:
        from kanzi_tpu_torch.transform.alias import AliasCodec
        ctx.put("packOnlyDNA", 1)
        return AliasCodec(ctx, only_dna=True)
    raise ValueError(f"Unknown transform id: {tid}")


def new_transform(ctx: Context, ttype: int) -> TransformSequence:
    """Build the stage sequence from a 48-bit packed descriptor
    (reference TransformFactory::newTransform, :207-222)."""
    transforms, names = [], []
    for i in range(8):
        tid = (ttype >> (MAX_SHIFT - ONE_SHIFT * i)) & MASK
        if tid != NONE_TYPE or i == 0:
            transforms.append(_new_token(ctx, tid))
            names.append(_ID_TO_NAME[TransformType(tid)].lower())
    return TransformSequence(transforms, names)
