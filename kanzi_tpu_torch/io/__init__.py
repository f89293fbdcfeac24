from kanzi_tpu_torch.io.compressed_stream import (
    CompressedWriter,
    CompressedReader,
    compress_bytes,
    decompress_bytes,
)

__all__ = ["CompressedWriter", "CompressedReader", "compress_bytes", "decompress_bytes"]
