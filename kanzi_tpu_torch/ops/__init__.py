"""Device kernels for the PyTorch/CUDA port: hand-written CUDA C++ for
Hopper (csrc/*.cu, built by ops/_build.py) behind wrappers that check
their inputs, plus a plain PyTorch version of each kernel beside it.

A wrapper launches its kernel for a CUDA tensor and takes the plain
version only for a CPU tensor; there is no fallback from one to the
other. The host layers (kanzi_tpu_torch.io, .entropy) pick the device
and hand tensors down.

Layout:
- ops.ans      interleaved 4-lane rANS order-0 chunk encode/decode
- ops.huffman  4-fragment canonical Huffman chunk encode/decode
- ops.ans1     interleaved 4-lane rANS order-1 chunk encode
- ops.fpaq     FPAQ binary arithmetic encode and decode, one stream per
               block
- ops.cm       CM (context-mixing) binary arithmetic encode and decode,
               one stream per block
- ops.sbrt     SBRT (MTF / RANK / TIMESTAMP) rank automaton, one per block
- ops.lz       LZ match pass: each position's previous occurrence in its
               hash bucket and their common prefix, which the LZ
               transform's native parse reads on a card
- ops.bwt      suffix array, BWT forward and inverse (torch ops, no kernel)
- ops._build   nvcc build + ctypes binding of csrc/*.cu
"""

import os as _os
from typing import Optional

import torch

# the launch counters, kept with the spans in core/trace.py (where their
# keys are listed): the same objects
from kanzi_tpu_torch.core.trace import COUNTERS, count, reset_counters  # noqa: F401

# KANZI_TPU_DISABLE=1 forces the pure host (native C++/numpy) path, as
# it does for kanzi_tpu.
ENABLED = not _os.environ.get("KANZI_TPU_DISABLE")


def disable():
    global ENABLED
    ENABLED = False


def enable():
    global ENABLED
    ENABLED = True


def device() -> torch.device:
    """The CUDA device the entropy kernels run on. Raises when there is
    none: the port never moves a device path onto the CPU by itself."""
    if not torch.cuda.is_available():
        raise RuntimeError("kanzi_tpu_torch: no CUDA device available "
                           "(pass device='cpu' explicitly to run the "
                           "plain PyTorch versions)")
    return torch.device("cuda", torch.cuda.current_device())


def block_device(ctx) -> Optional[torch.device]:
    """The device of a block a transform codes: the context's "device",
    else the CUDA device where there is one, else None (the host)."""
    dev = ctx.get("device")
    if dev is not None:
        return torch.device(dev)
    return device() if torch.cuda.is_available() else None
