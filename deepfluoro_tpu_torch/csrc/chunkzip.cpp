// Multithreaded zlib chunk compressor for HDF5 direct-chunk writes (the
// port's copy of deepfluoro_tpu/native/chunkzip.cpp, same C ABI). Host C++,
// built with g++ by ops/_build.py::load_host_library and bound in
// native/chunkzip.py.
//
// The inference output contract (reference util.py:300-310) stores nn-segs /
// nn-heats with per-image chunks under gzip-9. h5py's built-in filter
// pipeline compresses serially inside the writer thread; for the heatmap
// tensor (N x L x R x C float32) that dominates wall-clock of the output
// stage. This library deflates many chunks in parallel with std::thread and
// returns raw zlib streams, which the Python side feeds to
// h5py's write_direct_chunk (HDF5 filter id 1 == plain zlib deflate of the
// chunk payload, so the streams are bit-compatible with the gzip filter).
//
// C ABI (ctypes):
//   int dft_compress_chunks(const uint8_t* src, size_t n_chunks,
//                           size_t chunk_bytes, int level, int n_threads,
//                           uint8_t* dst, size_t dst_stride,
//                           uint64_t* out_sizes);
//     dst must hold n_chunks * dst_stride bytes with
//     dst_stride >= dft_compress_bound(chunk_bytes).
//     Returns 0 on success, a zlib error code otherwise.
//   size_t dft_compress_bound(size_t chunk_bytes);
//   int dft_decompress_chunks(const uint8_t* src, const uint64_t* offsets,
//                             const uint64_t* sizes, size_t n_chunks,
//                             size_t chunk_bytes, int n_threads, uint8_t* dst);
//     Inflates n_chunks zlib streams (chunk i at src+offsets[i], sizes[i]
//     bytes) into dst, chunk i at dst + i * chunk_bytes; each stream must
//     inflate to exactly chunk_bytes. The read-side mirror of the writer:
//     HDF5's gzip filter stores plain zlib streams, so blobs handed back by
//     h5py's read_direct_chunk decompress here without any reformatting.
//     Returns 0 on success, a zlib error code (or Z_DATA_ERROR on a chunk
//     size mismatch) otherwise.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

size_t dft_compress_bound(size_t chunk_bytes) {
  return compressBound(static_cast<uLong>(chunk_bytes));
}

int dft_compress_chunks(const uint8_t* src, size_t n_chunks, size_t chunk_bytes,
                        int level, int n_threads, uint8_t* dst,
                        size_t dst_stride, uint64_t* out_sizes) {
  if (n_threads < 1) n_threads = 1;
  if (static_cast<size_t>(n_threads) > n_chunks) n_threads = static_cast<int>(n_chunks);

  std::atomic<size_t> next{0};
  std::atomic<int> status{Z_OK};

  auto worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= n_chunks || status.load() != Z_OK) return;
      uLongf dlen = static_cast<uLongf>(dst_stride);
      int rc = compress2(dst + i * dst_stride, &dlen, src + i * chunk_bytes,
                         static_cast<uLong>(chunk_bytes), level);
      if (rc != Z_OK) {
        status.store(rc);
        return;
      }
      out_sizes[i] = static_cast<uint64_t>(dlen);
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return status.load();
}

int dft_decompress_chunks(const uint8_t* src, const uint64_t* offsets,
                          const uint64_t* sizes, size_t n_chunks,
                          size_t chunk_bytes, int n_threads, uint8_t* dst) {
  if (n_threads < 1) n_threads = 1;
  if (static_cast<size_t>(n_threads) > n_chunks) n_threads = static_cast<int>(n_chunks);

  std::atomic<size_t> next{0};
  std::atomic<int> status{Z_OK};

  auto worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= n_chunks || status.load() != Z_OK) return;
      uLongf dlen = static_cast<uLongf>(chunk_bytes);
      int rc = uncompress(dst + i * chunk_bytes, &dlen, src + offsets[i],
                          static_cast<uLong>(sizes[i]));
      if (rc == Z_OK && dlen != chunk_bytes) rc = Z_DATA_ERROR;
      if (rc != Z_OK) {
        status.store(rc);
        return;
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return status.load();
}

}  // extern "C"
