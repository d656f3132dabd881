"""Host-native components (JAX counterpart: ``deepfluoro_tpu/native/``).

``chunkzip``: a multithreaded zlib chunk codec (``csrc/chunkzip.cpp``, built
with g++) that bypasses h5py's serial filter pipeline in both directions:
parallel deflate feeding direct-chunk writes of the gzip-9 inference
outputs, and direct-chunk reads feeding parallel inflate for the CLIs that
read them back. A failed build raises.
"""

from deepfluoro_tpu_torch.native.chunkzip import (
    compress_chunks,
    compress_chunks_plain,
    decompress_chunks,
    decompress_chunks_plain,
    native_available,
    read_dataset_direct,
    write_dataset_direct,
)

__all__ = [
    "compress_chunks",
    "compress_chunks_plain",
    "decompress_chunks",
    "decompress_chunks_plain",
    "native_available",
    "read_dataset_direct",
    "write_dataset_direct",
]
