"""ctypes binding of the multithreaded zlib chunk codec
(``csrc/chunkzip.cpp``; JAX counterpart: ``deepfluoro_tpu/native/
chunkzip.py``).

HDF5's gzip filter (filter id 1) stores each chunk as a plain zlib deflate
stream, so chunks deflated here go to ``h5py``'s ``write_direct_chunk``
unchanged, and chunks that ``read_direct_chunk`` hands back inflate here:
h5py's serial filter pipeline is bypassed in both directions and the file
is the one the gzip filter writes.

The library is built with g++ at first use (``ops/_build.py``). Unlike the
JAX package, which carries on with serial zlib when g++ or ``dlopen``
fails, a failed build or load raises with the compiler's output here.
``compress_chunks_plain`` and ``decompress_chunks_plain`` are the serial
zlib loops, the plain versions the tests and ``chip_smoke.py`` hold the
library against. h5py is never imported here: the dataset functions take
the caller's open datasets.
"""

from __future__ import annotations

import ctypes
import os
import zlib

import numpy as np

from deepfluoro_tpu_torch.ops._build import load_library

_U64P = ctypes.POINTER(ctypes.c_uint64)


class InflateError(RuntimeError):
    """A stream is not a zlib stream of the expected chunk size."""


def _lib() -> ctypes.CDLL:
    """The built library with its functions' signatures declared; raises
    RuntimeError when g++ is missing or fails."""
    lib = load_library("chunkzip")
    lib.dft_compress_bound.restype = ctypes.c_size_t
    lib.dft_compress_bound.argtypes = [ctypes.c_size_t]
    lib.dft_compress_chunks.restype = ctypes.c_int
    lib.dft_compress_chunks.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_size_t, _U64P,
    ]
    lib.dft_decompress_chunks.restype = ctypes.c_int
    lib.dft_decompress_chunks.argtypes = [
        ctypes.c_void_p, _U64P, _U64P, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def native_available() -> bool:
    """Whether the library builds and loads here. Nothing in the package
    chooses a path by it: the codec's functions raise where it does not."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def default_threads(n_chunks: int) -> int:
    """The JAX package's thread count: one per CPU, at most one per chunk
    and 16."""
    return max(1, min(os.cpu_count() or 1, n_chunks, 16))


def _as_chunks(data: np.ndarray) -> np.ndarray:
    """``data`` as C-contiguous (n_chunks, chunk_bytes) bytes: its first
    axis is the chunk axis."""
    if np.ndim(data) == 0:
        raise ValueError("data needs a leading chunk axis")
    arr = np.ascontiguousarray(data)
    n = arr.shape[0]
    return arr.reshape(-1).view(np.uint8).reshape(n, arr.nbytes // max(n, 1))


def compress_chunks(data: np.ndarray, level: int = 9, n_threads: int | None = None) -> list[bytes]:
    """Deflate each row-chunk of ``data`` (any C-contiguous array whose
    first axis is the chunk axis) into a zlib stream, ``n_threads`` chunks
    at a time (default ``default_threads``)."""
    raw = _as_chunks(data)
    n_chunks, chunk_bytes = raw.shape
    if n_chunks == 0:
        return []
    lib = _lib()
    bound = lib.dft_compress_bound(chunk_bytes)
    dst = np.empty((n_chunks, bound), np.uint8)
    sizes = np.zeros(n_chunks, np.uint64)
    rc = lib.dft_compress_chunks(
        raw.ctypes.data_as(ctypes.c_void_p), n_chunks, chunk_bytes, level,
        default_threads(n_chunks) if n_threads is None else n_threads,
        dst.ctypes.data_as(ctypes.c_void_p), bound, sizes.ctypes.data_as(_U64P),
    )
    if rc != 0:
        raise RuntimeError("native compression failed with zlib code {}".format(rc))
    return [dst[i, : sizes[i]].tobytes() for i in range(n_chunks)]


def decompress_chunks(blobs: list[bytes], chunk_bytes: int, n_threads: int | None = None) -> np.ndarray:
    """Inflate zlib streams in parallel into a (n_chunks, chunk_bytes) u8
    array. Raises InflateError when a stream is corrupt or inflates to
    another size."""
    n_chunks = len(blobs)
    out = np.empty((n_chunks, chunk_bytes), np.uint8)
    if n_chunks == 0:
        return out
    lib = _lib()
    src = np.frombuffer(b"".join(blobs), np.uint8)
    sizes = np.asarray([len(b) for b in blobs], np.uint64)
    offsets = np.zeros(n_chunks, np.uint64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    rc = lib.dft_decompress_chunks(
        src.ctypes.data_as(ctypes.c_void_p), offsets.ctypes.data_as(_U64P), sizes.ctypes.data_as(_U64P),
        n_chunks, chunk_bytes, default_threads(n_chunks) if n_threads is None else n_threads,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise InflateError("native decompression failed with zlib code {}".format(rc))
    return out


def compress_chunks_plain(data: np.ndarray, level: int = 9) -> list[bytes]:
    """``compress_chunks`` by serial zlib: the plain version."""
    raw = _as_chunks(data)
    return [zlib.compress(raw[i].tobytes(), level) for i in range(raw.shape[0])]


def decompress_chunks_plain(blobs: list[bytes], chunk_bytes: int) -> np.ndarray:
    """``decompress_chunks`` by serial zlib: the plain version."""
    out = np.empty((len(blobs), chunk_bytes), np.uint8)
    for i, blob in enumerate(blobs):
        raw = zlib.decompress(blob)
        if len(raw) != chunk_bytes:
            raise InflateError("chunk {} inflated to {} bytes, expected {}".format(i, len(raw), chunk_bytes))
        out[i] = np.frombuffer(raw, np.uint8)
    return out


def _gzip_only(dset) -> bool:
    """True when the dataset's filter pipeline is exactly the gzip filter
    (no shuffle, fletcher32 or scale-offset), so raw chunks are plain
    zlib."""
    return (
        dset.chunks is not None
        and dset.compression == "gzip"
        and not dset.shuffle
        and not dset.fletcher32
        and dset.scaleoffset is None
    )


def _chunk_coords(shape) -> list[tuple]:
    if len(shape) == 3:
        return [(i, 0, 0) for i in range(shape[0])]
    return [(i, j, 0, 0) for i in range(shape[0]) for j in range(shape[1])]


def read_dataset_direct(dset, force_direct: bool = False) -> np.ndarray:
    """Read a whole per-image-chunked gzip dataset (the inference output
    contract: ``nn-segs`` (N, R, C) in chunks (1, R, C); ``nn-heats`` (N, L,
    R, C) in chunks (1, 1, R, C)) by direct chunk reads and the parallel
    inflate. As in the JAX package, a dataset of another layout (other
    chunks, other filters, chunks never written, streams that are not
    plain zlib of the chunk's size) is read by ``dset[:]``, and so is any
    dataset on a host of one CPU (h5py's own pipeline is as fast there)
    unless ``force_direct``. A missing or failing codec library raises."""
    shape = dset.shape
    expected = (1,) + shape[1:] if len(shape) == 3 else (1, 1) + shape[2:]
    if (
        len(shape) not in (3, 4)
        or not _gzip_only(dset)
        or dset.chunks != expected
        or any(s == 0 for s in shape)
        or ((os.cpu_count() or 1) <= 1 and not force_direct)
    ):
        return dset[:]
    _lib()  # a build failure raises here, outside the format's dispatch below
    try:
        pairs = [dset.id.read_direct_chunk(c) for c in _chunk_coords(shape)]
    except (RuntimeError, OSError):  # h5py: a chunk was never written
        return dset[:]
    if any(mask != 0 for mask, _ in pairs):  # a filter was skipped at write
        return dset[:]
    chunk_bytes = int(np.prod(expected)) * dset.dtype.itemsize
    try:
        flat = decompress_chunks([b for _, b in pairs], chunk_bytes)
    except InflateError:  # a filter h5py shows no property for
        return dset[:]
    return flat.view(dset.dtype).reshape(shape)


def write_dataset_direct(dset, start_index: int, data: np.ndarray, level: int = 9) -> None:
    """Write ``data`` into an h5py gzip dataset from leading index
    ``start_index`` by the parallel deflate and direct chunk writes.
    Layouts (the inference output contract, reference util.py:300-310):
    chunks (1, R, C) with data (B, R, C) (``nn-segs``), chunks (1, 1, R, C)
    with data (B, L, R, C) (``nn-heats``)."""
    rank = len(dset.shape)
    if rank not in (3, 4):
        raise ValueError("unsupported dataset rank {}".format(rank))
    if dset.chunks != (1,) * (rank - 2) + tuple(dset.shape[-2:]) or not _gzip_only(dset):
        raise ValueError("dataset chunks {} / compression {} are not the per-image gzip layout".format(
            dset.chunks, dset.compression))
    data = np.ascontiguousarray(data, dtype=dset.dtype)
    if data.shape[1:] != dset.shape[1:] or not 0 <= start_index <= dset.shape[0] - data.shape[0]:
        raise ValueError("data {} at index {} does not fit dataset {}".format(data.shape, start_index, dset.shape))
    streams = compress_chunks(data.reshape(-1, *dset.shape[-2:]), level=level)
    coords = _chunk_coords(data.shape)
    for (i, *rest), blob in zip(coords, streams):
        dset.id.write_direct_chunk((start_index + i, *rest), blob)
