"""Spans that the per-layer metrics share: the program's functions that
the harness wraps in a traced run, found by module and name where their
callers look them up, each with a sizer of the stage's work."""

from __future__ import annotations

import numpy as np

PIPE = "kanzi_tpu_torch.parallel.pipeline"
STREAM = "kanzi_tpu_torch.io.compressed_stream"


def _nbytes(x) -> int:
    return int(sum(np.asarray(a).nbytes for a in x))


def _cm_encode(args, kwargs, res):
    # (streams [b, L], lens) -> (bufs, low56, overflow)
    return {"coder": "cm_encode", "symbols": int(np.asarray(args[1]).sum()),
            "coded": _nbytes(res[0])}


def _cm_decode(args, kwargs, res):
    # (records [(current, payload)], lens) -> out [b, max(lens)]
    return {"coder": "cm_decode", "symbols": int(np.asarray(args[1]).sum()),
            "coded": int(sum(len(p) + 7 for _, p in args[0]))}


def _ans0_encode(args, kwargs, res):
    # (chunks [C, 16384]) -> (hdr, bitlen, m, flat, plen)
    return {"coder": "ans0_encode_scan", "symbols": int(args[0].size),
            "coded": int(np.asarray(res[3]).size)}


def _ans0_decode(args, kwargs, res):
    # (freqs, states, payload rows) -> (out [C, 16384], consumed [C])
    return {"coder": "ans0_decode", "symbols": int(np.asarray(res[0]).size),
            "coded": int(np.asarray(res[1]).sum())}


ENTROPY = {
    "entropy.cm_encode": (PIPE, "shard_cm_encode", _cm_encode),
    "entropy.cm_decode": (PIPE, "shard_cm_decode", _cm_decode),
    "entropy.ans0_encode": (PIPE, "shard_ans0_encode", _ans0_encode),
    "entropy.ans0_decode": (PIPE, "shard_ans0_decode", _ans0_decode),
}
BWT = {
    "bwt.forward": (PIPE, "_device_l5", None),
    "bwt.inverse": (PIPE, "_device_l5_inv", None),
}
HOST = {
    # the per-block forward transforms, looked up in the mesh chains'
    # module; the per-block inverse, looked up by the container's reader
    "host.transform": (PIPE, "_encode_block_phase1", None),
    "host.inverse": (STREAM, "_decode_block_finish", None),
}
