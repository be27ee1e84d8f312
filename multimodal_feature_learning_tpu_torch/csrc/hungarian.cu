// K6: the batched Hungarian matcher, exact linear-sum assignment of many
// small problems at once, one launch for all of them.
//
// It replaces no Pallas kernel. It replaces the `lax` loops of the JAX
// package's ops/hungarian.py (`hungarian`, two data-dependent while_loops
// inside a fori_loop, vmapped over the problems by `batched_hungarian`),
// which keep the matcher inside the jitted train step. In eager PyTorch
// those loops would either stop the host on every loop test or unroll to
// the worst case as hundreds of masked launches; a `scan` on the hot path
// becomes a kernel. The training and evaluation forwards call it once each,
// on the (decoder layers x batch) problems of (queries x GT slots).
//
// What it computes is what ops/hungarian.py::batched_hungarian computes, in
// the same way: the e-maxx potentials and shortest-augmenting-path method in
// f32, solved transposed (the n GT slots are the rows, the m queries the
// columns), an invalid GT slot a row of zero cost, then the matched query
// of each GT slot. The arithmetic is numpy's, operation for operation:
// cur = (cost - u[i0]) - v[j], u[p[j]] += delta, v[j] -= delta and
// minv[j] -= delta, each one f32 add rounded to nearest (no products, so
// no contraction can part them); the argmin keeps the first minimal index,
// numpy's and jnp.argmin's rule, and takes the used columns in at 1e18 as
// numpy does. So the indices equal the plain version's bit for bit, ties
// included. It is built without --use_fast_math.
//
// One warp per problem (a block of 32 threads), a lane owning the columns
// j = lane, lane + 32, ...; u, v, p, minv, used and way live in shared
// memory, (n + 1 + 5 (m + 1)) x 4 bytes, under 48 KB for m <= 1024. A search
// step is one pass over the lane's columns and a warp-shuffle argmin; the
// augmenting walk back along `way` is lane 0's.
//
// What bounds it: not bytes (the flagship's 96 problems of 20 x 10 read
// 77 KB of cost, 0.02 us at 3.35 TB/s) nor operations, but a chain of about
// n (n + 1) / 2 dependent search steps a problem (55 at n = 10), each a
// pass over shared memory and a five-level shuffle reduction, and the
// problems run side by side on separate SMs. The launcher takes the
// caller's stream and neither synchronises nor allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 1024;
constexpr float kInf = 1e18f;  // numpy's np.float32(1e18)

// (value, index) of the smaller value, the lower index on a tie
__device__ __forceinline__ void argmin_step(float& best, int& idx, float ov, int oi) {
  if (ov < best || (ov == best && oi < idx)) {
    best = ov;
    idx = oi;
  }
}

__global__ void __launch_bounds__(32)
hungarian_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ valid,
                 int64_t* __restrict__ out, int Q, int G) {
  extern __shared__ float smem[];
  const int n = G, m = Q;
  const int b = blockIdx.x, lane = threadIdx.x;
  float* u = smem;              // n + 1
  float* v = u + (n + 1);       // m + 1
  float* minv = v + (m + 1);    // m + 1
  int* p = reinterpret_cast<int*>(minv + (m + 1));  // m + 1
  int* way = p + (m + 1);       // m + 1
  int* used = way + (m + 1);    // m + 1
  const float* c = cost + (size_t)b * Q * G;  // c[q * G + g]: query q, GT slot g
  const uint8_t* ok = valid + (size_t)b * G;

  for (int i = lane; i <= n; i += 32) u[i] = 0.0f;
  for (int j = lane; j <= m; j += 32) {
    v[j] = 0.0f;
    p[j] = 0;
  }
  __syncwarp();

  for (int i = 1; i <= n; ++i) {
    for (int j = lane; j <= m; j += 32) {
      minv[j] = kInf;
      used[j] = 0;
      way[j] = 0;
    }
    if (lane == 0) p[0] = i;
    __syncwarp();
    int j0 = 0;
    while (true) {
      const int i0 = p[j0];
      if (i0 == 0) break;
      const float ui0 = u[i0];
      const bool row_ok = ok[i0 - 1] != 0;
      float best = __int_as_float(0x7f800000);  // +inf: any column beats it
      int best_j = 0x7fffffff;
      for (int j = lane; j <= m; j += 32) {
        if (j == j0) used[j] = 1;
        if (j == 0) continue;
        const bool uj = used[j] != 0;
        if (!uj) {
          const float cij = row_ok ? c[(size_t)(j - 1) * G + (i0 - 1)] : 0.0f;
          const float cur = __fsub_rn(__fsub_rn(cij, ui0), v[j]);
          if (cur < minv[j]) {
            minv[j] = cur;
            way[j] = j0;
          }
        }
        const float masked = uj ? kInf : minv[j];
        if (masked < best) {  // ascending j: the lane's first minimum
          best = masked;
          best_j = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_j, off);
        argmin_step(best, best_j, ov, oi);
      }
      const float delta = best;
      for (int j = lane; j <= m; j += 32) {
        if (used[j]) {
          // the rows p[j] of the used columns are distinct: no two lanes
          // add to one u
          u[p[j]] = __fadd_rn(u[p[j]], delta);
          v[j] = __fsub_rn(v[j], delta);
        } else {
          minv[j] = __fsub_rn(minv[j], delta);
        }
      }
      __syncwarp();
      j0 = best_j;
    }
    // augment: walk `way` back to the dummy column
    if (lane == 0) {
      int j = j0;
      while (j != 0) {
        const int jn = way[j];
        p[j] = p[jn];
        j = jn;
      }
    }
    __syncwarp();
  }
  // every row is matched to one column: GT slot p[j] - 1 takes query j - 1
  for (int j = lane + 1; j <= m; j += 32)
    if (p[j] != 0) out[(size_t)b * G + (p[j] - 1)] = j - 1;
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. cost (P, Q, G) f32,
// valid (P, G) bool as bytes, out (P, G) int64, all contiguous on the card;
// 1 <= G <= Q <= 1024. Returns the CUDA error code of the launch (0 =
// success).
extern "C" int hungarian_launch(const void* cost, const void* valid, void* out, int P, int Q,
                                int G, void* stream) {
  if (P <= 0 || G <= 0 || G > Q || Q > kMaxCols) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(G + 1) * sizeof(float) + (size_t)(Q + 1) * 5 * sizeof(float);
  hungarian_kernel<<<P, 32, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(cost), static_cast<const uint8_t*>(valid),
      static_cast<int64_t*>(out), Q, G);
  return (int)cudaGetLastError();
}
