from kanzi_tpu_torch.bitstream.writer import BitWriter
from kanzi_tpu_torch.bitstream.reader import BitReader, BitStreamError

__all__ = ["BitWriter", "BitReader", "BitStreamError"]
