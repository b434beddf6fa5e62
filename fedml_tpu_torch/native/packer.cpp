// Native host-side data packer: threaded row gather.
//
// The per-round host hot path of the framework is packing sampled
// clients' shards into the fixed-shape [K, steps, B, ...] block that
// the round consumes (core/types.py pack_clients — the
// replacement for the reference's per-client torch DataLoaders,
// SURVEY.md §7 "torch DataLoader dicts per client").  numpy fancy
// indexing does this single-threaded with an extra stack copy; this
// gather writes each row straight into the preallocated output block
// from multiple threads.
//
// Dtype-agnostic by treating rows as raw bytes.  Out-of-range indices
// are clamped defensively (callers validate; clamping turns a logic
// error into a visible wrong-sample, not a segfault).
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread packer.cpp

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// Copy rows src[idx[i]] -> dst[i] for i in [0, n_rows).
// src: [src_rows, row_bytes] C-contiguous; dst: [n_rows, row_bytes].
void gather_rows(const char* src, int64_t src_rows, const int64_t* idx,
                 char* dst, int64_t n_rows, int64_t row_bytes,
                 int32_t n_threads) {
  if (n_rows <= 0 || row_bytes <= 0 || src_rows <= 0) return;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  int threads = n_threads > 0 ? n_threads : hw;
  // don't spawn threads for tiny copies (< ~4 MiB total)
  int64_t total_bytes = n_rows * row_bytes;
  if (threads > 1 && total_bytes < (int64_t)4 << 20) threads = 1;
  threads = std::min<int64_t>(threads, n_rows);

  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t j = idx[i];
      if (j < 0) j = 0;
      if (j >= src_rows) j = src_rows - 1;
      std::memcpy(dst + i * row_bytes, src + j * row_bytes,
                  static_cast<size_t>(row_bytes));
    }
  };

  if (threads == 1) {
    worker(0, n_rows);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  int64_t chunk = (n_rows + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n_rows);
    if (lo >= hi) break;
    pool.emplace_back(worker, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
