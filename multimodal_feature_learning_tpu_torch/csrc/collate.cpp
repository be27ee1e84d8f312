// The host side of the data path: batch assembly of feature tensors and
// their masks (zero-pad to the batch's longest, then nearest-resize to the
// model's length), as a C++ library bound with ctypes. The port's
// copy of the JAX package's native/collate.cpp, built with the host compiler
// by ops/build.py (g++, no CUDA) and bound by native.py; its plain version is
// data/anet.py's numpy collate, which it equals bit for bit (copies only).
//
// All functions operate on caller-allocated contiguous buffers.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

// Output bytes below which a call copies on the calling thread. The copies
// are memory-bound, and starting a thread costs tens of microseconds: a
// loader's batch (16 x 300 x 1024 f32, 20 MB, or its mask) copies faster on
// one thread than on eight started for it.
constexpr int64_t kParallelBytes = int64_t(64) << 20;

// run fn(b) for b in [0, n): on this thread when the call writes fewer than
// kParallelBytes, else across hardware threads
template <typename F>
void parallel_for(int64_t n, int64_t bytes, F fn) {
  // before hardware_concurrency(), which reads the CPU list from sysfs (tens
  // of microseconds, more than a small call's copies)
  if (bytes < kParallelBytes || n < 2) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  const int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
  const int64_t workers = std::max<int64_t>(1, std::min<int64_t>(hw, n));
  if (workers == 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(workers);
  for (int64_t w = 0; w < workers; ++w) {
    threads.emplace_back([=]() {
      for (int64_t i = w; i < n; i += workers) fn(i);
    });
  }
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// Nearest-neighbor temporal resize, torch F.interpolate semantics:
// out[b, i, :] = in[b, (i * t_in) / t_out, :].
// in:  (batch, t_in, dim) float32; out: (batch, t_out, dim) float32.
void resize_nearest_f32(const float* in, float* out, int64_t batch,
                        int64_t t_in, int64_t t_out, int64_t dim) {
  parallel_for(batch, batch * t_out * dim * int64_t(sizeof(float)), [=](int64_t b) {
    const float* src = in + b * t_in * dim;
    float* dst = out + b * t_out * dim;
    for (int64_t i = 0; i < t_out; ++i) {
      const int64_t j = (i * t_in) / t_out;
      std::memcpy(dst + i * dim, src + j * dim, sizeof(float) * dim);
    }
  });
}

// Same for boolean masks. in: (batch, t_in) uint8; out: (batch, t_out) uint8.
// The source index of each output step is computed once, not once a row: a
// 64-bit division costs more than the byte it places.
void resize_nearest_u8(const uint8_t* in, uint8_t* out, int64_t batch,
                       int64_t t_in, int64_t t_out) {
  std::vector<int64_t> src_of(t_out);
  for (int64_t i = 0; i < t_out; ++i) src_of[i] = (i * t_in) / t_out;
  const int64_t* idx = src_of.data();
  parallel_for(batch, batch * t_out, [=](int64_t b) {
    const uint8_t* src = in + b * t_in;
    uint8_t* dst = out + b * t_out;
    for (int64_t i = 0; i < t_out; ++i) dst[i] = src[idx[i]];
  });
}

// Fused pad-and-resize: per sample, copy length[b] valid rows of a ragged
// feature list (concatenated in `in`, offsets in `offsets`), zero-pad to
// max_len, then nearest-resize to t_out. Emits resized features AND the
// resized pad mask (1 = padding) in one pass — the whole collate hot loop.
// in: (sum_len, dim); offsets: (batch+1,); out: (batch, t_out, dim);
// out_mask: (batch, t_out).
void pad_resize_batch_f32(const float* in, const int64_t* offsets,
                          float* out, uint8_t* out_mask, int64_t batch,
                          int64_t max_len, int64_t t_out, int64_t dim) {
  parallel_for(batch, batch * t_out * (dim * int64_t(sizeof(float)) + 1), [=](int64_t b) {
    const int64_t start = offsets[b];
    const int64_t len = offsets[b + 1] - start;
    const float* src = in + start * dim;
    float* dst = out + b * t_out * dim;
    uint8_t* m = out_mask + b * t_out;
    for (int64_t i = 0; i < t_out; ++i) {
      const int64_t j = (i * max_len) / t_out;  // index into padded axis
      if (j < len) {
        std::memcpy(dst + i * dim, src + j * dim, sizeof(float) * dim);
        m[i] = 0;
      } else {
        std::memset(dst + i * dim, 0, sizeof(float) * dim);
        m[i] = 1;
      }
    }
  });
}

}  // extern "C"
