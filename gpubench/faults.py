"""Faults planted under the timed path, for the controls that show the
check of `correct` failing (gpubench/tests/test_gpubench_faults.py on the
CPU; `run.py --fault NAME` at a cell's own size on the card). The
benchmark's own runs plant none.

- bwt_identity: the BWT stage returns its input unchanged (its header
  still written), both ways: every round trip still returns its input,
  but the stream is no longer kanzi's (a step that returns its state
  unchanged; the lossless guarantee kept, the format's broken);
- half_batch: the entropy decode leaves out the second half of its
  batch of streams or chunks (their bytes zero);
- answer_altered: one byte of each decompressed output flipped;
- stream_altered: one byte in the middle of each compressed stream
  flipped.
"""

from __future__ import annotations

import importlib

import numpy as np

PIPE = "kanzi_tpu_torch.parallel.pipeline"


def _set(undo: list, obj, attr: str, value) -> None:
    undo.append((obj, attr, getattr(obj, attr)))
    setattr(obj, attr, value)


def _patch(undo: list, module: str, attr: str, make):
    mod = importlib.import_module(module)
    _set(undo, mod, attr, make(getattr(mod, attr)))


def _bwt_identity(undo: list):
    import torch
    from kanzi_tpu_torch.transform import bwt as hb
    pipe = importlib.import_module(PIPE)

    def fwd(self, src):
        src = np.asarray(src, np.uint8)
        n = len(src)
        pis = pipe._p_index_size(max(n, 2))
        chunks = 1 if n < 256 else 8
        hdr = bytes([((chunks.bit_length() - 1) << 2) | (pis - 1)]) + \
            bytes(chunks * pis)
        return np.frombuffer(hdr + src.tobytes(), np.uint8)

    def inv(self, src):
        src = np.asarray(src, np.uint8)
        mode = int(src[0])
        return src[1 + (1 << ((mode >> 2) & 7)) * ((mode & 3) + 1):].copy()

    _set(undo, hb.BWTBlockCodec, "forward", fwd)
    _set(undo, hb.BWTBlockCodec, "inverse", inv)
    _set(undo, hb.BWTBlockCodec, "inverse_into", lambda self, src, out: None)

    def codec(blocks):
        b, n = blocks.shape
        pis = pipe._p_index_size(n)
        mode = torch.full((b, 1), (3 << 2) | (pis - 1), dtype=torch.uint8,
                          device=blocks.device)
        zeros = torch.zeros((b, 8 * pis), dtype=torch.uint8,
                            device=blocks.device)
        return torch.cat([mode, zeros, blocks], 1)

    def inverse(payload, n, pis):
        hdr = 1 + 8 * pis
        ok = torch.ones(payload.shape[0], dtype=torch.bool,
                        device=payload.device)
        return payload[:, hdr:hdr + n].contiguous(), ok

    _set(undo, pipe, "_bwt_codec", codec)
    _set(undo, pipe, "_bwt_inverse", inverse)


def _half_batch(undo: list):
    def zero_tail(rows):
        rows = np.array(rows, copy=True)
        rows[rows.shape[0] // 2:] = 0
        return rows

    _patch(undo, PIPE, "shard_cm_decode",
           lambda fn: lambda *a, **k: zero_tail(fn(*a, **k)))

    def ans0(fn):
        def run(*a, **k):
            dec, cur = fn(*a, **k)
            return zero_tail(dec), cur
        return run
    _patch(undo, PIPE, "shard_ans0_decode", ans0)


def _flip(data: bytes) -> bytes:
    b = bytearray(data)
    if b:
        b[len(b) // 2] ^= 0x5A
    return bytes(b)


def plant(name: str, cfg: dict):
    """Plant fault `name` for a cell of configuration cfg. Returns a
    function that takes it out again."""
    undo = []
    if name == "bwt_identity":
        _bwt_identity(undo)
    elif name == "half_batch":
        _half_batch(undo)
    elif name in ("answer_altered", "stream_altered"):
        spec = cfg["decompress" if name == "answer_altered" else "compress"]
        module, attr = spec.split(":")
        _patch(undo, module, attr,
               lambda fn: lambda *a, **k: _flip(fn(*a, **k)))
    else:
        raise ValueError(f"no fault {name!r}")

    def restore():
        for obj, attr, old in reversed(undo):
            setattr(obj, attr, old)
    return restore


NAMES = ("bwt_identity", "half_batch", "answer_altered", "stream_altered")
