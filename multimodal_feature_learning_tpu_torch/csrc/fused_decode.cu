// One greedy decode step through every caption-decoder layer, in one launch.
//
// Replaces the TPU kernels of multimodal_feature_learning_tpu/ops/fused_decode.py:
// _decode_step_kernel (:202, grid (depth, B), one program per (layer, video))
// and _decode_step_kernel_batch (:376, grid (depth, B/Bt), Bt videos a
// program). The math is theirs, f32: per layer, self-attention over the
// position-major KV cache with the commit write at rows step*G + e, then
// shared-KV cross-attention over the memory K/V (f32, or int8 with per-token
// scales) with the pad|zeroed mask and the bias column, then the exact-GELU
// MLP; three one-pass LayerNorms (eps 1e-6); masking with -1e20 before the
// scale. The hidden state carries across layers.
//
// What bounds it on an H100: at the flagship's shapes (B=16, G=10, D=512,
// depth 6, Sp=640, MLP 2048) a step is 15.6 GFLOP of f32 products on the
// CUDA cores (tensor cores are off: the port's f32 contract keeps TF32 off)
// against 0.39 GB of weights, memory K/V and caches, so it is bound by
// operations: 0.233 ms at 67 TFLOP/s.
//
// Design. On the TPU the depth axis of the grid runs in order on one core
// and the hidden state waits in VMEM. Here one persistent cooperative
// launch covers every SM, and the layer loop runs inside it: each layer is
// eleven stages separated by grid-wide barriers (cooperative groups):
//   1  q = x Wq + bq (all 2G rows); k, v of the G commit rows, written
//      straight into the caches at position `step`
//   2  self-attention, one block per (videos of a unit, head): the q rows
//      and the cache rows of positions < valid_len in shared memory; each
//      row reads its own event's keys only
//   3  attn Wo, the reduction split in two (partial sums in scratch)
//   4  x = LN1(x + (sum of partials + bo)), one warp per row
//   5  qc = x Wq' + bq'
//   6  cross-attention, one block per (videos of a unit, head): all Sp
//      logits of the video in shared memory, one-pass max / exp / sum, then
//      the weighted sum of V
//   7, 8  as 3, 4 with the cross-attention's Wo' and LN2
//   9  h = gelu(x W1 + b1)
//   10 h W2, the reduction split in four
//   11 x = LN3(x + (sum + b2))
// The dense products are 32x64 tiles of a plain SIMT f32 GEMM, two tiles a
// block (one per half, 4x4 outputs a thread), with A and W streamed through
// a two-stage cp.async ring in shared memory; the cross-attention streams
// K and V through a three-stage ring. Every work item's sums run in a fixed
// order, so the result does not depend on the grid size. The two TPU grids
// map onto the attention stages' work unit: "video" takes one video per unit
// (videos_per_unit 1), "batch" takes Bt videos per unit; the numbers are
// the same. The self-attention never forms the logits of other events' or
// future keys: they would contribute exp(-1e20*scale - m) = 0 exactly. The
// cross-attention forms all Sp, so a row whose every memory position is
// blocked averages V over all Sp columns, as the TPU kernel does.
//
// The LayerNorms stay stages of their own: run by the last work item of a
// row block (an atomic count) instead, they serialised 32 rows on 4 warps,
// and the three projections with their LayerNorms took 233 us a layer on an
// H100 against 124 us as separate stages.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface (ops/build.py); bound with ctypes
// (ops/fused_decode.py). The launcher allocates nothing: the wrapper passes
// every output and scratch buffer.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace cg = cooperative_groups;

#ifdef FD_STAGE_TIMING
// Build with -DFD_STAGE_TIMING to record the device clock after every grid
// barrier (block 0); fused_decode_stage_ns copies the record to the host.
__device__ unsigned long long g_stage_ns[2 + 11 * 16];  // [1 + 11 * 16]: the start
__device__ unsigned long long g_barrier_ns[5];  // four grid barriers with no work between
__device__ unsigned long long g_sub_ns[8];  // phases of block 0's first cross-attention
#define SUB_MARK(i)                                                     \
  do {                                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0 && li == 0 && b == 0 && h == 0) { \
      unsigned long long ns;                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));            \
      g_sub_ns[(i)] = ns;                                               \
    }                                                                   \
  } while (0)
#define STAGE_MARK(i)                                                   \
  do {                                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0 && (i) < 2 + 11 * 16) {     \
      unsigned long long ns;                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));            \
      g_stage_ns[(i)] = ns;                                             \
    }                                                                   \
  } while (0)
#else
#define STAGE_MARK(i) do {} while (0)
#define SUB_MARK(i) do {} while (0)
#endif

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int HALF = THREADS / 2;         // a GEMM tile takes half a block
constexpr int BM = 32, BN = 64, BK = 32;  // GEMM tile
constexpr int AS_STRIDE = BK + 4;         // A tile row in shared memory
constexpr int GEMM_STAGE = BM * AS_STRIDE + BK * BN;  // floats of one ring stage
constexpr int A4 = BM * BK / 4 / HALF;    // float4 of the A tile per thread
constexpr int W4 = BK * BN / 4 / HALF;    // float4 of the W tile per thread
constexpr int KV_CHUNK = 64;              // memory rows per shared-memory chunk
constexpr int KV_STAGES = 3;              // chunks in the cross-attention's cp.async ring
constexpr int SPLIT_K_MAX = 4;
constexpr int MAX_R = 32;                 // rows per video (2G)
constexpr int AV_ROWS = 8;                // rows per thread in the weighted sum of V
constexpr int LN_PER = 32;                // row elements per lane in a LayerNorm (D <= 1024)
constexpr float NEG_MASK = -1e20f;
constexpr float LN_EPS = 1e-6f;

enum {
  SA_WQ, SA_BQ, SA_WK, SA_BK, SA_WV, SA_BV, SA_WO, SA_BO,
  CA_WQ, CA_BQ, CA_WK, CA_BK, CA_WV, CA_BV, CA_WO, CA_BO,
  MLP_W1, MLP_B1, MLP_W2, MLP_B2,
  LN1_S, LN1_B, LN2_S, LN2_B, LN3_S, LN3_B,
  N_WEIGHTS
};

struct Params {
  const float* x_in;
  float* x;  // hidden state, also the output
  float* kc;
  float* vc;
  const void* mem_k;
  const void* mem_v;
  const float* k_scales;
  const float* v_scales;
  const int8_t* mask;
  const float* log_m;
  const float* w[N_WEIGHTS];
  float* q_buf;
  float* attn_buf;
  float* part;
  float* h_buf;
  int B, G, R, D, H, Dh, depth, C, Sp, F;
  int step, valid_len, has_bias, kv_int8, vt;
  int split_o, split_2;
  float scale;
};

struct GemmJob {
  const float* A;     // rows of lda floats
  const float* W;     // K x N, row-major
  const float* bias;  // N, or null when split
  float* out;
  int M, N, K, lda;
  int splits;    // > 1: out[ks] holds the partial sum over the ks-th K slice
  int a_commit;  // A row m is x row (m / G) * R + m % G
  int o_cache;   // out row m is cache row (m / G) * C + step * G + m % G
  int gelu;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// erfc by Abramowitz & Stegun 7.1.26 and 0.5 x erfc(-x sqrt(1/2)), the JAX
// kernel's _erfc_f32 / _gelu_exact, each operation rounded on its own.
__device__ __forceinline__ float gelu_exact(float x) {
  const float z = __fmul_rn(-x, 0.70710677f);
  const float a = fabsf(z);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(0.3275911f, a)));
  float poly = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  poly = __fadd_rn(1.421413741f, __fmul_rn(t, poly));
  poly = __fadd_rn(-0.284496736f, __fmul_rn(t, poly));
  poly = __fadd_rn(0.254829592f, __fmul_rn(t, poly));
  poly = __fmul_rn(t, poly);
  const float erfc_a = __fmul_rn(poly, expf(__fmul_rn(-a, a)));
  const float e = z >= 0.0f ? erfc_a : __fsub_rn(2.0f, erfc_a);
  return __fmul_rn(__fmul_rn(0.5f, x), e);
}

// Activations are written inside the launch, so they are read with plain
// loads; only the weights and the memory K/V go through the read-only path.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Barrier of the 128 threads of one half of the block (named barrier 1 or 2).
__device__ __forceinline__ void half_sync(int half) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + half), "r"(HALF));
}

// One BM x BN output tile (or its ks-th K slice) by the 128 threads of one
// half of the block, 4 x 4 outputs a thread. A and W stream through a
// two-stage cp.async ring in this half's shared memory, so the next chunk
// is in flight while this one is summed; each output sums over k in order.
__device__ void gemm_item(const GemmJob& j, const Params& p, int tm, int tn, int ks,
                          float* smem, int half) {
  const int t = threadIdx.x % HALF;
  const int tx = t % 16, ty = t / 16;  // outputs: rows 4ty..4ty+3, cols 4tx..4tx+3
  const int m0 = tm * BM, n0 = tn * BN;
  const int kc = j.K / j.splits, kb = ks * kc, chunks = kc / BK;
  const float* arow[A4];
  int abytes[A4];
#pragma unroll
  for (int i = 0; i < A4; ++i) {
    const int m = m0 + (t + i * HALF) / (BK / 4);
    const int src = m < j.M ? (j.a_commit ? (m / p.G) * p.R + m % p.G : m) : 0;
    arow[i] = j.A + (size_t)src * j.lda + ((t + i * HALF) % (BK / 4)) * 4;
    abytes[i] = m < j.M ? 16 : 0;  // rows past M are zero-filled
  }
  auto issue = [&](int stage, int k0) {
    float* As = smem + stage * GEMM_STAGE;
    float* Ws = As + BM * AS_STRIDE;
#pragma unroll
    for (int i = 0; i < A4; ++i) {
      const int idx = t + i * HALF;
      cp_async16(As + (idx / (BK / 4)) * AS_STRIDE + (idx % (BK / 4)) * 4, arow[i] + k0,
                 abytes[i]);
    }
#pragma unroll
    for (int i = 0; i < W4; ++i) {
      const int idx = t + i * HALF;
      cp_async16(Ws + (idx / (BN / 4)) * BN + (idx % (BN / 4)) * 4,
                 j.W + (size_t)(k0 + idx / (BN / 4)) * j.N + n0 + (idx % (BN / 4)) * 4, 16);
    }
  };
  float acc[4][4] = {};
  issue(0, kb);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) issue((c + 1) & 1, kb + (c + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest has landed: chunk c is here
    half_sync(half);
    const float* As = smem + (c & 1) * GEMM_STAGE;
    const float* Ws = As + BM * AS_STRIDE;
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      float4 a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(As + (4 * ty + i) * AS_STRIDE + k);
        w[i] = *reinterpret_cast<const float4*>(Ws + (k + i) * BN + 4 * tx);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ak[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][0] = fmaf(ak[q], w[q].x, acc[i][0]);
          acc[i][1] = fmaf(ak[q], w[q].y, acc[i][1]);
          acc[i][2] = fmaf(ak[q], w[q].z, acc[i][2]);
          acc[i][3] = fmaf(ak[q], w[q].w, acc[i][3]);
        }
      }
    }
    half_sync(half);  // the next issue overwrites this stage
  }
  const int n = n0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= j.M) continue;
    float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    float* dst;
    if (j.splits > 1) {
      dst = j.out + ((size_t)ks * j.M + m) * j.N + n;
    } else {
      const float4 b = ldg4(j.bias + n);
      v.x += b.x; v.y += b.y; v.z += b.z; v.w += b.w;
      if (j.gelu) {
        v.x = gelu_exact(v.x); v.y = gelu_exact(v.y);
        v.z = gelu_exact(v.z); v.w = gelu_exact(v.w);
      }
      const int row = j.o_cache ? (m / p.G) * p.C + p.step * p.G + m % p.G : m;
      dst = j.out + (size_t)row * j.N + n;
    }
    *reinterpret_cast<float4*>(dst) = v;
  }
}

__device__ int gemm_items(const GemmJob& j) {
  return ((j.M + BM - 1) / BM) * (j.N / BN) * j.splits;
}

// The work items of every job, spread over the blocks first, then over the
// second half of each block.
__device__ void gemm_stage(const GemmJob* jobs, int njobs, const Params& p, float* smem) {
  const int half = threadIdx.x / HALF;
  float* hsmem = smem + half * 2 * GEMM_STAGE;
  int total = 0;
  for (int i = 0; i < njobs; ++i) total += gemm_items(jobs[i]);
  for (int item = half * gridDim.x + blockIdx.x; item < total; item += gridDim.x * 2) {
    int local = item, ji = 0;
    while (local >= gemm_items(jobs[ji])) local -= gemm_items(jobs[ji++]);
    const GemmJob& j = jobs[ji];
    const int ks = local % j.splits;
    const int tile = local / j.splits;
    gemm_item(j, p, tile / (j.N / BN), tile % (j.N / BN), ks, hsmem, half);
  }
}

// x = LN(x + (sum of `splits` partials + bias)), one warp per row; every
// load of the row is issued before the first sum.
__device__ void ln_stage(const Params& p, const float* bias, int splits, const float* s,
                         const float* b) {
  const int lane = threadIdx.x % 32;
  const int M = p.B * p.R, D = p.D, per = p.D / 32;
  const int nw = gridDim.x * NWARPS;
  for (int row = blockIdx.x * NWARPS + threadIdx.x / 32; row < M; row += nw) {
    float* xr = p.x + (size_t)row * D;
    float y[LN_PER];
#pragma unroll
    for (int i = 0; i < LN_PER; ++i)
      if (i < per) y[i] = p.part[(size_t)row * D + lane + 32 * i];
    for (int k = 1; k < splits; ++k) {
      const float* part = p.part + ((size_t)k * M + row) * D + lane;
#pragma unroll
      for (int i = 0; i < LN_PER; ++i)
        if (i < per) y[i] += part[32 * i];
    }
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < LN_PER; ++i) {
      if (i < per) {
        const int d = lane + 32 * i;
        y[i] = xr[d] + (y[i] + __ldg(bias + d));
        sum += y[i];
        sq += y[i] * y[i];
      }
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mean = sum / D;
    const float var = fmaxf(sq / D - mean * mean, 0.0f);
    const float inv = 1.0f / sqrtf(var + LN_EPS);
#pragma unroll
    for (int i = 0; i < LN_PER; ++i) {
      if (i < per) {
        const int d = lane + 32 * i;
        xr[d] = (y[i] - mean) * (inv * __ldg(s + d)) + __ldg(b + d);
      }
    }
  }
}

// Self-attention of one video and one head: the q rows and the cache rows of
// positions < valid_len (every event's) in shared memory; row r attends its
// own event's keys only, its own commit among them.
__device__ void self_attention_video(const Params& p, int li, int b, int h, float* smem) {
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int R = p.R, G = p.G, Dh = p.Dh, qs = Dh + 4, Tc = p.C / G, vl = p.valid_len;
  const int rows = vl * G;       // cache rows pos * G + e, pos < valid_len
  float* q = smem;               // R x qs
  float* kv = q + R * qs;        // rows x qs: keys, then values
  float* lg = kv + p.C * qs;     // R x Tc: logits, then weights
  const size_t cache = (size_t)(li * p.B + b) * p.C * p.D + h * Dh;
  const int d4s = Dh / 4;
  for (int idx = t; idx < R * d4s; idx += THREADS) {
    const int r = idx / d4s, d = (idx % d4s) * 4;
    *reinterpret_cast<float4*>(q + r * qs + d) =
        ld4(p.q_buf + (size_t)(b * R + r) * p.D + h * Dh + d);
  }
  for (int idx = t; idx < rows * d4s; idx += THREADS) {
    const int r = idx / d4s, d = (idx % d4s) * 4;
    *reinterpret_cast<float4*>(kv + r * qs + d) = ld4(p.kc + cache + (size_t)r * p.D + d);
  }
  __syncthreads();
  for (int idx = t; idx < R * vl; idx += THREADS) {
    const int r = idx / vl, pos = idx % vl;
    const float* qr = q + r * qs;
    const float* kr = kv + (pos * G + r % G) * qs;
    float acc = 0.f;
    for (int d = 0; d < Dh; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(qr + d);
      const float4 k = *reinterpret_cast<const float4*>(kr + d);
      acc = fmaf(a.x, k.x, acc);
      acc = fmaf(a.y, k.y, acc);
      acc = fmaf(a.z, k.z, acc);
      acc = fmaf(a.w, k.w, acc);
    }
    lg[r * Tc + pos] = acc * p.scale;
  }
  __syncthreads();
  for (int r = warp; r < R; r += NWARPS) {
    float* lr = lg + r * Tc;
    float m = -INFINITY;
    for (int pos = lane; pos < vl; pos += 32) m = fmaxf(m, lr[pos]);
    m = warp_max(m);
    float sum = 0.f;
    for (int pos = lane; pos < vl; pos += 32) {
      const float e = expf(lr[pos] - m);
      lr[pos] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int pos = lane; pos < vl; pos += 32) lr[pos] = lr[pos] / sum;
  }
  for (int idx = t; idx < rows * d4s; idx += THREADS) {  // the values over the keys
    const int r = idx / d4s, d = (idx % d4s) * 4;
    *reinterpret_cast<float4*>(kv + r * qs + d) = ld4(p.vc + cache + (size_t)r * p.D + d);
  }
  __syncthreads();
  for (int idx = t; idx < R * Dh; idx += THREADS) {
    const int r = idx / Dh, d = idx % Dh;
    const float* lr = lg + r * Tc;
    float out = 0.f;
    for (int pos = 0; pos < vl; ++pos) out = fmaf(lr[pos], kv[(pos * G + r % G) * qs + d], out);
    p.attn_buf[(size_t)(b * R + r) * p.D + h * Dh + d] = out;
  }
  __syncthreads();  // the next video reuses the shared buffers
}

__device__ void self_attention_stage(const Params& p, int li, float* smem) {
  const int units = (p.B / p.vt) * p.H;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int g = unit / p.H, h = unit % p.H;
    for (int v = 0; v < p.vt; ++v) self_attention_video(p, li, g * p.vt + v, h, smem);
  }
}

// Cross-attention of one video and one head over its Sp memory columns. The
// K (then V) rows of the head stream through a three-stage cp.async ring of
// KV_CHUNK rows (f32, or the int8 bytes, widened exactly when read).
template <bool INT8>
__device__ void cross_attention_video(const Params& p, int li, int b, int h, float* smem) {
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int R = p.R, Sp = p.Sp, Dh = p.Dh, qs = Dh + 4, nch = Sp / KV_CHUNK;
  float* q = smem;                 // R x qs
  float* L = q + R * qs;           // R x Sp: logits, then attention weights
  float* ab = L + R * Sp;          // R (+ pad to 4): bias-column weights
  float* ring = ab + (R + 3) / 4 * 4;  // KV_STAGES x KV_CHUNK x qs
  const size_t lb = (size_t)(li * p.B + b) * Sp;  // (layer, video) row of the scales
  const size_t base = lb * p.D + h * Dh;          // element offset of row 0, head h
  const int qb = Dh + 16;                         // int8 row stride in bytes
  SUB_MARK(0);

  auto issue = [&](const void* mem, int c) {
    float* dst = ring + (c % KV_STAGES) * KV_CHUNK * qs;
    const size_t off = base + (size_t)c * KV_CHUNK * p.D;
    if (INT8) {
      const int n16 = Dh / 16;
      for (int idx = t; idx < KV_CHUNK * n16; idx += THREADS) {
        const int row = idx / n16, d = (idx % n16) * 16;
        cp_async16(reinterpret_cast<int8_t*>(dst) + row * qb + d,
                   static_cast<const int8_t*>(mem) + off + (size_t)row * p.D + d, 16);
      }
    } else {
      const int n4 = Dh / 4;
      for (int idx = t; idx < KV_CHUNK * n4; idx += THREADS) {
        const int row = idx / n4, d = (idx % n4) * 4;
        cp_async16(dst + row * qs + d,
                   static_cast<const float*>(mem) + off + (size_t)row * p.D + d, 16);
      }
    }
  };
  auto start = [&](const void* mem) {  // the first KV_STAGES - 1 chunks in flight
    for (int c = 0; c < KV_STAGES - 1; ++c) {
      if (c < nch) issue(mem, c);
      cp_async_commit();
    }
  };
  auto arrive = [&](const void* mem, int c) {  // chunk c landed; chunk c + 2 in flight
    if (c + KV_STAGES - 1 < nch) issue(mem, c + KV_STAGES - 1);
    cp_async_commit();
    cp_async_wait<KV_STAGES - 1>();
    __syncthreads();
    return ring + (c % KV_STAGES) * KV_CHUNK * qs;
  };
  auto kv4 = [&](const float* buf, int row, int d) {
    if (INT8) {
      const char4 c = *reinterpret_cast<const char4*>(
          reinterpret_cast<const int8_t*>(buf) + row * qb + d);
      return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
    }
    return *reinterpret_cast<const float4*>(buf + row * qs + d);
  };
  auto kv1 = [&](const float* buf, int row, int d) {
    if (INT8) return (float)reinterpret_cast<const int8_t*>(buf)[row * qb + d];
    return buf[row * qs + d];
  };

  start(p.mem_k);
  for (int idx = t; idx < R * Dh; idx += THREADS) {
    const int r = idx / Dh, d = idx % Dh;
    q[r * qs + d] = p.q_buf[(size_t)(b * R + r) * p.D + h * Dh + d];
  }
  SUB_MARK(1);

  // logits: thread (column s_loc of the chunk, rows rg, rg + 4, ...)
  {
    const int s_loc = t % KV_CHUNK, rg = t / KV_CHUNK;
    for (int c = 0; c < nch; ++c) {
      const int s = c * KV_CHUNK + s_loc;
      const float ksc = INT8 ? __ldg(p.k_scales + lb + s) : 1.0f;
      int8_t blocked[MAX_R / 4];  // loaded now, read after the sums
#pragma unroll
      for (int i = 0; i < MAX_R / 4; ++i) {
        const int r = rg + 4 * i;
        blocked[i] = r < R ? __ldg(p.mask + (size_t)(b * R + r) * Sp + s) : 0;
      }
      const float* kv = arrive(p.mem_k, c);
      float acc[MAX_R / 4] = {};
      for (int d = 0; d < Dh; d += 4) {
        const float4 k4 = kv4(kv, s_loc, d);
#pragma unroll
        for (int i = 0; i < MAX_R / 4; ++i) {
          const int r = rg + 4 * i;
          if (r < R) {
            const float4 q4 = *reinterpret_cast<const float4*>(q + r * qs + d);
            acc[i] = fmaf(q4.x, k4.x, acc[i]);
            acc[i] = fmaf(q4.y, k4.y, acc[i]);
            acc[i] = fmaf(q4.z, k4.z, acc[i]);
            acc[i] = fmaf(q4.w, k4.w, acc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MAX_R / 4; ++i) {
        const int r = rg + 4 * i;
        if (r < R) {
          float lg = acc[i];
          if (INT8) lg *= ksc;
          L[r * Sp + s] = (blocked[i] ? NEG_MASK : lg) * p.scale;
        }
      }
      __syncthreads();  // the ring stage is issued again two chunks on
    }
  }
  start(p.mem_v);  // the first V chunks load during the softmax
  SUB_MARK(2);

  // softmax over the Sp columns and the bias column, one warp per row
  const float* kb = p.w[CA_BK] + (size_t)li * p.D + h * Dh;
  for (int r = warp; r < R; r += NWARPS) {
    float* Lr = L + r * Sp;
    float m = -INFINITY;
    for (int s = lane; s < Sp; s += 32) m = fmaxf(m, Lr[s]);
    m = warp_max(m);
    float bias_logit = 0.f;
    if (p.has_bias) {
      float l_bias = 0.f;
      for (int d = lane; d < Dh; d += 32) l_bias = fmaf(q[r * qs + d], __ldg(kb + d), l_bias);
      bias_logit = warp_sum(l_bias) * p.scale + p.log_m[b * R + r];
      m = fmaxf(m, bias_logit);
    }
    float sum = 0.f;
    for (int s = lane; s < Sp; s += 32) {
      const float ev = expf(Lr[s] - m);
      Lr[s] = ev;
      sum += ev;
    }
    sum = warp_sum(sum);
    const float e_bias = p.has_bias ? expf(bias_logit - m) : 0.f;
    const float denom = sum + e_bias;
    for (int s = lane; s < Sp; s += 32) {
      float a = Lr[s] / denom;
      if (INT8) a *= __ldg(p.v_scales + lb + s);
      Lr[s] = a;
    }
    if (lane == 0) ab[r] = e_bias / denom;
  }
  SUB_MARK(3);

  // out = attn V (+ attn_bias v_bias): thread (channel dl, rows rg, rg + ng, ...)
  {
    const int dl = t % Dh, rg = t / Dh, ng = THREADS / Dh;
    float acc[AV_ROWS] = {};
    for (int c = 0; c < nch; ++c) {
      const float* kv = arrive(p.mem_v, c);  // its barrier also orders the softmax
      const int c0 = c * KV_CHUNK;
      for (int s = 0; s < KV_CHUNK; s += 4) {
        const float v0 = kv1(kv, s, dl), v1 = kv1(kv, s + 1, dl);
        const float v2 = kv1(kv, s + 2, dl), v3 = kv1(kv, s + 3, dl);
#pragma unroll
        for (int i = 0; i < AV_ROWS; ++i) {
          const int r = rg + ng * i;
          if (r < R) {
            const float4 a = *reinterpret_cast<const float4*>(L + r * Sp + c0 + s);
            acc[i] = fmaf(a.x, v0, acc[i]);
            acc[i] = fmaf(a.y, v1, acc[i]);
            acc[i] = fmaf(a.z, v2, acc[i]);
            acc[i] = fmaf(a.w, v3, acc[i]);
          }
        }
      }
      __syncthreads();
    }
    const float vb = p.has_bias ? __ldg(p.w[CA_BV] + (size_t)li * p.D + h * Dh + dl) : 0.f;
#pragma unroll
    for (int i = 0; i < AV_ROWS; ++i) {
      const int r = rg + ng * i;
      if (r < R) {
        float out = acc[i];
        if (p.has_bias) out = out + ab[r] * vb;
        p.attn_buf[(size_t)(b * R + r) * p.D + h * Dh + dl] = out;
      }
    }
  }
  SUB_MARK(4);
  __syncthreads();  // the next video reuses the shared buffers
}

__device__ void cross_attention_stage(const Params& p, int li, float* smem) {
  const int units = (p.B / p.vt) * p.H;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int g = unit / p.H, h = unit % p.H;
    for (int v = 0; v < p.vt; ++v) {
      if (p.kv_int8)
        cross_attention_video<true>(p, li, g * p.vt + v, h, smem);
      else
        cross_attention_video<false>(p, li, g * p.vt + v, h, smem);
    }
  }
}

// One block per SM (255 registers a thread): with two, the 128 registers a
// thread spilled and most stages ran slower on an H100.
__global__ void __launch_bounds__(THREADS, 1)
fused_decode_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int M = p.B * p.R, D = p.D;
  STAGE_MARK(1 + 11 * 16);

  const size_t n = (size_t)M * D;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS)
    p.x[i] = p.x_in[i];
  grid.sync();
  STAGE_MARK(0);

  for (int li = 0; li < p.depth; ++li) {
    const size_t dd = (size_t)li * D * D, df = (size_t)li * D * p.F;
    const float* const* w = p.w;
    const size_t cache = (size_t)li * p.B * p.C * D;

    // 1: q for every row; k and v of the commit rows into the caches
    {
      const GemmJob jobs[3] = {
          {p.x, w[SA_WQ] + dd, w[SA_BQ] + li * D, p.q_buf, M, D, D, D, 1, 0, 0, 0},
          {p.x, w[SA_WK] + dd, w[SA_BK] + li * D, p.kc + cache, p.B * p.G, D, D, D, 1, 1, 1, 0},
          {p.x, w[SA_WV] + dd, w[SA_BV] + li * D, p.vc + cache, p.B * p.G, D, D, D, 1, 1, 1, 0},
      };
      gemm_stage(jobs, 3, p, smem);
    }
    grid.sync();
    STAGE_MARK(1 + li * 11 + 0);
    self_attention_stage(p, li, smem);  // 2
    grid.sync();
    STAGE_MARK(1 + li * 11 + 1);
    {
      const GemmJob job = {p.attn_buf, w[SA_WO] + dd, nullptr, p.part, M, D, D, D,
                           p.split_o, 0, 0, 0};
      gemm_stage(&job, 1, p, smem);  // 3
    }
    grid.sync();
    STAGE_MARK(1 + li * 11 + 2);
    ln_stage(p, w[SA_BO] + li * D, p.split_o, w[LN1_S] + li * D, w[LN1_B] + li * D);  // 4
    grid.sync();
    STAGE_MARK(1 + li * 11 + 3);
    {
      const GemmJob job = {p.x, w[CA_WQ] + dd, w[CA_BQ] + li * D, p.q_buf, M, D, D, D,
                           1, 0, 0, 0};
      gemm_stage(&job, 1, p, smem);  // 5
    }
    grid.sync();
    STAGE_MARK(1 + li * 11 + 4);
    cross_attention_stage(p, li, smem);  // 6
    grid.sync();
    STAGE_MARK(1 + li * 11 + 5);
    {
      const GemmJob job = {p.attn_buf, w[CA_WO] + dd, nullptr, p.part, M, D, D, D,
                           p.split_o, 0, 0, 0};
      gemm_stage(&job, 1, p, smem);  // 7
    }
    grid.sync();
    STAGE_MARK(1 + li * 11 + 6);
    ln_stage(p, w[CA_BO] + li * D, p.split_o, w[LN2_S] + li * D, w[LN2_B] + li * D);  // 8
    grid.sync();
    STAGE_MARK(1 + li * 11 + 7);
    {
      const GemmJob job = {p.x, w[MLP_W1] + df, w[MLP_B1] + (size_t)li * p.F, p.h_buf, M,
                           p.F, D, D, 1, 0, 0, 1};
      gemm_stage(&job, 1, p, smem);  // 9
    }
    grid.sync();
    STAGE_MARK(1 + li * 11 + 8);
    {
      const GemmJob job = {p.h_buf, w[MLP_W2] + df, nullptr, p.part, M, D, p.F, p.F,
                           p.split_2, 0, 0, 0};
      gemm_stage(&job, 1, p, smem);  // 10
    }
    grid.sync();
    STAGE_MARK(1 + li * 11 + 9);
    ln_stage(p, w[MLP_B2] + li * D, p.split_2, w[LN3_S] + li * D, w[LN3_B] + li * D);  // 11
    grid.sync();
    STAGE_MARK(1 + li * 11 + 10);
  }
#ifdef FD_STAGE_TIMING
  for (int i = 0; i < 5; ++i) {
    if (i) grid.sync();
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      unsigned long long ns;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
      g_barrier_ns[i] = ns;
    }
  }
#endif
}

int pick_split(int K, int most) {
  for (int s = most; s > 1; s /= 2)
    if (K % (s * BK) == 0) return s;
  return 1;
}

}  // namespace

extern "C" int fused_decode_launch(
    const float* x, float* x_out, float* k_cache, float* v_cache, const void* mem_k,
    const void* mem_v, const float* k_scales, const float* v_scales, const int8_t* mask,
    const float* log_m, void* const* weights, float* q_buf, float* attn_buf, float* part_buf,
    float* h_buf, int B, int G, int D, int H, int depth, int C, int Sp, int F, int step,
    int valid_len, int has_bias, int kv_int8, int videos_per_unit, cudaStream_t stream) {
  Params p;
  p.x_in = x;
  p.x = x_out;
  p.kc = k_cache;
  p.vc = v_cache;
  p.mem_k = mem_k;
  p.mem_v = mem_v;
  p.k_scales = k_scales;
  p.v_scales = v_scales;
  p.mask = mask;
  p.log_m = log_m;
  for (int i = 0; i < N_WEIGHTS; ++i) p.w[i] = static_cast<const float*>(weights[i]);
  p.q_buf = q_buf;
  p.attn_buf = attn_buf;
  p.part = part_buf;
  p.h_buf = h_buf;
  p.B = B; p.G = G; p.R = 2 * G; p.D = D; p.H = H; p.Dh = D / H; p.depth = depth;
  p.C = C; p.Sp = Sp; p.F = F; p.step = step; p.valid_len = valid_len;
  p.has_bias = has_bias; p.kv_int8 = kv_int8; p.vt = videos_per_unit;
  p.split_o = pick_split(D, 2);
  p.split_2 = pick_split(F, SPLIT_K_MAX);
  p.scale = (float)(1.0 / std::sqrt((double)p.Dh));

  if (p.R > MAX_R || p.R > AV_ROWS * (THREADS / p.Dh) || p.Dh % 32 || p.Dh > 128 || D % BN
      || D > 32 * LN_PER || F % BN || Sp % KV_CHUNK
      || B % videos_per_unit || videos_per_unit < 1)
    return (int)cudaErrorInvalidValue;

  const int qs = p.Dh + 4;
  const size_t gemm_smem = (size_t)4 * GEMM_STAGE * sizeof(float);  // 2 halves x 2 stages
  const size_t self_smem = (size_t)(p.R * qs + C * qs + p.R * (C / G)) * sizeof(float);
  const size_t cross_smem =
      (size_t)(p.R * qs + p.R * Sp + (p.R + 3) / 4 * 4 + KV_STAGES * KV_CHUNK * qs) *
      sizeof(float);
  size_t smem = gemm_smem > self_smem ? gemm_smem : self_smem;
  if (cross_smem > smem) smem = cross_smem;

  static size_t smem_set = 0;
  cudaError_t err;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(fused_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  void* args[] = {&p};
  // every block must be resident for the grid barriers; a launch that cannot
  // place one block on each SM is refused with an error, not run
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_decode_kernel), dim3(sms),
                                    dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef FD_STAGE_TIMING
extern "C" int fused_decode_stage_ns(unsigned long long* out, int n) {
  if (n != 2 + 11 * 16) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, g_stage_ns, n * sizeof(unsigned long long));
}

extern "C" int fused_decode_sub_ns(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_sub_ns, sizeof(g_sub_ns));
}

extern "C" int fused_decode_barrier_ns(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_barrier_ns, sizeof(g_barrier_ns));
}
#endif
