// Native batch assembly for the port's host data pipeline (the port's own
// copy of medvae_tpu/native/feeder.cpp; the port imports nothing of the JAX
// package).
//
// The hot host op of a streamed train step is a scattered-row gather out of
// the materialized uint8 image store into a fresh batch buffer; a
// memcpy-per-row loop, sharded across threads by row blocks with no
// synchronization inside the loop, does it.
//
// mv_assemble_batch fuses the whole DeviceFeeder._gather body (image
// gather, label/modality_idx gather, one-hot build, per-sample channel
// lookup) into one pass so the small fields pay no numpy dispatch per step.

#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// Gather rows [idx[lo:hi]] of `src` into dst[lo:hi].
void gather_block(const uint8_t* src, const int64_t* idx, int64_t lo,
                  int64_t hi, int64_t row_bytes, uint8_t* dst) {
  for (int64_t i = lo; i < hi; ++i) {
    std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                static_cast<size_t>(row_bytes));
  }
}

void run_sharded(int64_t n, int n_threads,
                 const std::function<void(int64_t, int64_t)>& body) {
  if (n_threads <= 1 || n < 2 * n_threads) {
    body(0, n);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  int64_t per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    pool.emplace_back(body, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// dst[i, :] = src[idx[i], :] for n rows of row_bytes each.
void mv_gather_rows_u8(const uint8_t* src, const int64_t* idx, int64_t n,
                       int64_t row_bytes, uint8_t* dst, int n_threads) {
  run_sharded(n, n_threads, [&](int64_t lo, int64_t hi) {
    gather_block(src, idx, lo, hi, row_bytes, dst);
  });
}

// Fused DeviceFeeder._gather: one pass over the batch indices producing
//   out_images[i]   = images[idx[i]]            (row_bytes each)
//   out_labels[i]   = labels[idx[i]]
//   out_midx[i]     = modality_idx[idx[i]]
//   out_onehot[i]   = one_hot(modality_idx[idx[i]], n_mod)   (float32)
//   out_channels[i] = channels_by_mod[modality_idx[idx[i]]]
// out_onehot must be zero-initialized by the caller (calloc/np.zeros).
void mv_assemble_batch(const uint8_t* images, int64_t row_bytes,
                       const int32_t* labels, const int32_t* modality_idx,
                       const int64_t* idx, int64_t n, int32_t n_mod,
                       const int32_t* channels_by_mod, uint8_t* out_images,
                       int32_t* out_labels, int32_t* out_midx,
                       float* out_onehot, int32_t* out_channels,
                       int n_threads) {
  run_sharded(n, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t j = idx[i];
      std::memcpy(out_images + i * row_bytes, images + j * row_bytes,
                  static_cast<size_t>(row_bytes));
      out_labels[i] = labels[j];
      const int32_t m = modality_idx[j];
      out_midx[i] = m;
      if (m >= 0 && m < n_mod) {
        out_onehot[i * n_mod + m] = 1.0f;
        out_channels[i] = channels_by_mod[m];
      } else {
        out_channels[i] = 0;
      }
    }
  });
}

}  // extern "C"
