"""kanzi_tpu_torch — the PyTorch/CUDA port of kanzi_tpu for NVIDIA Hopper.

Writes and reads the same Kanzi bitstream (format 6) as kanzi_tpu and the
reference kanzi binary, byte for byte. The host side (framing, headers,
transforms, host entropy coders, the native C++ runtime loader) is this
package's own copy of kanzi_tpu's, under the same module paths; what ran
on the TPU runs here as hand-written CUDA kernels (kanzi_tpu_torch/csrc)
behind PyTorch. This package imports neither JAX nor kanzi_tpu.

Ported so far: the ANS0 and HUFFMAN entropy stages, the ANS1 encode and
the FPAQ encode (on the card where a writer batch has enough FPAQ
blocks), so every level 0-9 and every entropy name runs (see
ROADMAP.md).
"""

__version__ = "0.1.0"

BITSTREAM_FORMAT_VERSION = 6  # reference: src/io/CompressedOutputStream.cpp:32
MAGIC = 0x4B414E5A            # "KANZ", reference: src/io/CompressedOutputStream.cpp:31

from kanzi_tpu_torch.io.compressed_stream import (  # noqa: E402,F401
    CompressedReader,
    CompressedWriter,
    compress_bytes,
    decompress_bytes,
)
