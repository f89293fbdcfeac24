"""Block parallelism over one card or several.

The reference's parallel model is pure block data-parallelism:
independent blocks fan out to worker threads and commit to the shared
bitstream in block order (src/io/CompressedOutputStream.cpp:476-546,
835-868). Here a batch of blocks runs as one pass on the card and the
host commits the container in block order: the level-5 chain's
transforms and entropy stage, and the entropy stage of the level-2, 3,
6 and 7 chains (parallel.pipeline). Their FPAQ and CM decodes run
kernels H and J on the card, where the container's stay on the host's
native coders, as in kanzi_tpu. The "block" mesh is a tuple of devices,
every visible card by default; each stage cuts its batch into one shard
a device (parallel.mesh). parallel.dryrun drives every chain over a mesh
and its 1-device submesh.
"""

from kanzi_tpu_torch.parallel.mesh import (block_mesh, shard_ans0_decode,
                                           shard_ans0_encode,
                                           shard_cm_decode, shard_cm_encode,
                                           shard_fpaq_decode,
                                           shard_fpaq_encode,
                                           shard_huffman_decode,
                                           shard_huffman_encode)

__all__ = ["block_mesh", "shard_ans0_encode", "shard_ans0_decode",
           "shard_huffman_encode", "shard_huffman_decode",
           "shard_fpaq_encode", "shard_fpaq_decode", "shard_cm_encode",
           "shard_cm_decode"]
