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
// What bounds it: not bytes (the flagship's 96 problems of 20 x 10 read
// 77 KB of cost, 0.02 us at 3.35 TB/s) nor operations, but a chain of about
// n (n + 1) / 2 dependent search steps a problem (55 at n = 10), each of
// which needs the last one's chosen column. The problems run side by side,
// a warp each. So the design shortens the chain of one step:
// - route "warp" (Q + 1 <= 32, every family's default), a warp and a block
//   a problem: the cost is staged once into shared memory, transposed (a
//   GT slot's row of queries contiguous, an invalid slot's row zero, as
//   numpy's np.where makes it) with 16-byte loads, so a step reads no device
//   memory and its lanes read neighbouring words. Lane j owns column j, its
//   v, minv, used, way and p in registers, and lane r row r's potential
//   u[r], read by the others with a shuffle. The rows of the used columns
//   are the rows this search has visited, so u[p[j]] += delta is "each
//   visited row adds delta" on the row's own lane. Every lane computes cur
//   and keeps it by a select: no divergent branch inside a step. The argmin
//   is three warp instructions: __reduce_min_sync over an order-preserving
//   32-bit key of the masked minv, a ballot of the lanes at the minimum and
//   __ffs for the lowest of them (numpy's first index), so a step's chain is
//   the shuffles, one shared-memory load, the subtractions, the key and
//   these three. The augmenting path is found with a shuffle a hop along
//   `way`, and its columns take their new rows with one more. Nothing is
//   written to shared memory and no __syncwarp is needed after the staging;
// - route "global" (Q + 1 > 32, up to 1024 queries; no configuration runs
//   it): the first design's schedule, one warp a problem, its state in
//   shared memory, a lane owning the columns j = lane, lane + 32, ..., the
//   cost read from device memory; each lane reduces its columns' keys
//   first, then two __reduce_min_sync give the key and the lowest column
//   at it.
// Which route and how many bytes of shared memory come from
// ops/hungarian.py::hungarian_plan; the launcher computes the same plan and
// refuses a launch that differs from it. The launcher takes the caller's
// stream and neither synchronises nor allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 1024;
constexpr float kInf = 1e18f;                // numpy's np.float32(1e18)
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kIdleKey = 0xffffffffu;   // above every float's key
enum Route { kWarp = 0, kGlobal = 1 };

// A 32-bit key that orders as the floats do: -0.0 and +0.0 give one key
// (adding +0.0 turns -0.0 into +0.0), every NaN the smallest, as np.argmin
// takes a NaN first. The smallest key at the lowest index is np.argmin.
__device__ __forceinline__ unsigned order_key(float x) {
  const float z = __fadd_rn(x, 0.0f);
  const unsigned b = __float_as_uint(z);
  const unsigned k = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (z != z) ? 0u : k;
}

// element e of a problem's query-major cost, at its place cs[g * Q + q];
// GT slot g is valid where bit g of `ok` is set
__device__ __forceinline__ void put(float* __restrict__ cs, int Q, int G, int e, float x,
                                    unsigned ok) {
  const int q = e / G, g = e - q * G;
  cs[g * Q + q] = ((ok >> g) & 1u) ? x : 0.0f;
}

// One problem's cost (Q queries x G slots, query-major in device memory)
// into shared memory as cs[g * Q + q], an invalid slot's row zero; the
// warp's lanes share the copy, 16 bytes a load where the address allows.
__device__ __forceinline__ void stage_problem(float* __restrict__ cs,
                                              const float* __restrict__ src, int Q, int G,
                                              int lane, unsigned ok) {
  const int n = Q * G;
  int head = (int)(((16u - ((uintptr_t)src & 15u)) & 15u) >> 2);
  head = head < n ? head : n;
  for (int e = lane; e < head; e += 32) put(cs, Q, G, e, __ldg(src + e), ok);
  const float4* src4 = reinterpret_cast<const float4*>(src + head);
  const int n4 = (n - head) >> 2;
  for (int k = lane; k < n4; k += 32) {
    const float4 x = __ldg(src4 + k);
    const int e = head + 4 * k;
    put(cs, Q, G, e, x.x, ok);
    put(cs, Q, G, e + 1, x.y, ok);
    put(cs, Q, G, e + 2, x.z, ok);
    put(cs, Q, G, e + 3, x.w, ok);
  }
  for (int e = head + 4 * n4 + lane; e < n; e += 32) put(cs, Q, G, e, __ldg(src + e), ok);
}

// Route "warp": Q + 1 <= 32, one warp a block, block b solves problem b.
__global__ void __launch_bounds__(32)
hungarian_warp_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ valid,
                      int64_t* __restrict__ out, int Q, int G) {
  extern __shared__ float cs[];  // Q * G
  const int b = blockIdx.x, lane = threadIdx.x;
  const bool slot_ok = lane < G && valid[(size_t)b * G + lane] != 0;
  stage_problem(cs, cost + (size_t)b * Q * G, Q, G, lane, __ballot_sync(kFull, slot_ok));
  __syncwarp();

  const int n = G, m = Q;
  const bool col = lane >= 1 && lane <= m;  // lane j: column j (query j - 1)
  const float* mine = cs + (col ? lane - 1 : 0);  // row r: mine[(r - 1) * Q]
  float u = 0.0f, v = 0.0f;                 // u: row `lane`'s potential
  int p = 0;                                // the row matched to column `lane`
  for (int i = 1; i <= n; ++i) {
    float minv = kInf;
    bool used = false, visited = false;
    int way = 0;
    if (lane == 0) p = i;
    int j0 = 0, i0 = i;
    while (true) {
      used |= lane == j0;
      visited |= lane == i0;
      const float ui0 = __shfl_sync(kFull, u, i0);
      const float cur = __fsub_rn(__fsub_rn(mine[(i0 - 1) * Q], ui0), v);
      const bool upd = col && !used && cur < minv;
      minv = upd ? cur : minv;
      way = upd ? j0 : way;
      const float masked = used ? kInf : minv;
      const unsigned key = col ? order_key(masked) : kIdleKey;
      const unsigned kmin = __reduce_min_sync(kFull, key);
      const int j1 = __ffs(__ballot_sync(kFull, key == kmin)) - 1;
      const float delta = __shfl_sync(kFull, masked, j1);
      if (visited) u = __fadd_rn(u, delta);
      if (used) {
        v = __fsub_rn(v, delta);
      } else {
        minv = __fsub_rn(minv, delta);
      }
      j0 = j1;
      i0 = __shfl_sync(kFull, p, j1);
      if (i0 == 0) break;
    }
    // augment: each column on the path back along `way` from j0 to the
    // dummy column takes the row of the column before it, all at once (the
    // sequential walk reads each p before it writes it): a shuffle a hop to
    // find the path, then one for p
    bool on_path = false;
    for (int j = j0; j != 0; j = __shfl_sync(kFull, way, j)) on_path |= lane == j;
    const int p_before = __shfl_sync(kFull, p, way);
    if (on_path) p = p_before;
  }
  // every row is matched to one column: GT slot p - 1 takes query lane - 1
  if (col && p != 0) out[(size_t)b * G + (p - 1)] = lane - 1;
}

// Route "global": one warp a problem, any Q up to 1024, the cost read from
// device memory.
__global__ void __launch_bounds__(32)
hungarian_global_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ valid,
                        int64_t* __restrict__ out, int Q, int G) {
  extern __shared__ float smem[];
  const int n = G, m = Q;
  const int b = blockIdx.x, lane = threadIdx.x;
  float* u = smem;                                     // n + 1
  float* v = u + (n + 1);                              // m + 1
  float* minv = v + (m + 1);                           // m + 1
  int* p = reinterpret_cast<int*>(minv + (m + 1));     // m + 1
  int* way = p + (m + 1);                              // m + 1
  int* used = way + (m + 1);                           // m + 1
  int* ok = used + (m + 1);                            // n + 1: row r's slot is valid
  const float* c = cost + (size_t)b * Q * G;           // c[q * G + g]
  const uint8_t* okg = valid + (size_t)b * G;

  for (int i = lane; i <= n; i += 32) {
    u[i] = 0.0f;
    ok[i] = i > 0 ? okg[i - 1] : 0;
  }
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
      const bool row_ok = ok[i0] != 0;
      unsigned best = kIdleKey;
      int best_j = 0x7fffffff;
      float best_v = 0.0f;
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
        const unsigned key = order_key(masked);
        if (key < best) {  // ascending j: the lane's first minimum
          best = key;
          best_j = j;
          best_v = masked;
        }
      }
      const unsigned kmin = __reduce_min_sync(kFull, best);
      const int j1 = (int)__reduce_min_sync(kFull, best == kmin ? (unsigned)best_j : 0x7fffffffu);
      const float delta = __shfl_sync(kFull, best_v, j1 & 31);
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
      j0 = j1;
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
  for (int j = lane + 1; j <= m; j += 32)
    if (p[j] != 0) out[(size_t)b * G + (p[j] - 1)] = j - 1;
}

// The plan of ops/hungarian.py::hungarian_plan: route and dynamic shared
// bytes a block (under 48 KB on both routes up to 1024 queries).
int plan_route(int Q, int G, size_t* smem) {
  if (Q + 1 <= 32) {
    *smem = (size_t)Q * G * sizeof(float);
    return kWarp;
  }
  *smem = (size_t)(G + 1) * 2 * 4 + (size_t)(Q + 1) * 5 * 4;
  return kGlobal;
}

// A dependent chain of `steps` search steps of route "warp" with nothing
// else around it: a column's shuffle, a row's shuffle, the staged cost's
// load, the two subtractions, the compare, the key and the three-
// instruction argmin, the delta's shuffle and its subtraction. Its time
// over `steps` is the latency of one step's chain on this card.
__global__ void __launch_bounds__(32)
hungarian_chain_kernel(float* __restrict__ sink, int steps) {
  __shared__ float cs[32 * 32];
  const int lane = threadIdx.x;
  for (int k = lane; k < 32 * 32; k += 32) cs[k] = (float)((k * 7919) % 61) - 30.0f;
  __syncwarp();
  float u = (float)lane, v = 0.5f * lane, minv = kInf;
  int p = (lane * 5 + 3) & 31, j1 = 1;
  for (int s = 0; s < steps; ++s) {
    const int i0 = __shfl_sync(kFull, p, j1);
    const float ui0 = __shfl_sync(kFull, u, i0);
    const float cur = __fsub_rn(__fsub_rn(cs[i0 * 32 + lane], ui0), v);
    if (cur < minv) minv = cur;
    const unsigned key = order_key(minv);
    const unsigned kmin = __reduce_min_sync(kFull, key);
    j1 = __ffs(__ballot_sync(kFull, key == kmin)) - 1;
    const float delta = __shfl_sync(kFull, minv, j1);
    minv = __fsub_rn(minv, delta);
  }
  sink[lane] = minv + (float)j1;
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. cost (P, Q, G) f32,
// valid (P, G) bool as bytes, out (P, G) int64, all contiguous on the card;
// 1 <= G <= Q <= 1024; `route` as hungarian_plan gives it. Returns the CUDA
// error code of the launch (0 = success); cudaErrorInvalidValue, with
// nothing launched, for a shape outside the contract or a route other than
// the plan's.
extern "C" int hungarian_launch(const void* cost, const void* valid, void* out, int P, int Q,
                                int G, int route, void* stream) {
  if (P <= 0 || G <= 0 || G > Q || Q > kMaxCols) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  if (plan_route(Q, G, &smem) != route) return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(cost);
  const uint8_t* ok = static_cast<const uint8_t*>(valid);
  int64_t* o = static_cast<int64_t*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (route == kWarp) {
    hungarian_warp_kernel<<<P, 32, smem, s>>>(c, ok, o, Q, G);
  } else {
    hungarian_global_kernel<<<P, 32, smem, s>>>(c, ok, o, Q, G);
  }
  return (int)cudaGetLastError();
}

// The chain probe: one warp, `steps` dependent steps of route "warp"'s
// chain, `sink` 32 floats on the card. For measurement only; the matcher
// never launches it.
extern "C" int hungarian_chain_launch(void* sink, int steps, void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  hungarian_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(static_cast<float*>(sink), steps);
  return (int)cudaGetLastError();
}
