// Forward of 1-D multi-scale deformable attention (MSDA) for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas_msda.py::_msda_fwd_kernel of the JAX
// package (driven by _fwd_pallas, exported as ms_deform_attn_pallas):
//
//   out[b,q,h,:] = sum_l sum_p aw[b,q,h,l,p] *
//                  lerp(value[b, start_l : start_l+T_l, h, :],
//                       clip(loc[b,q,h,l,p] * T_l - 0.5, 0, T_l - 1))
//
// The TPU kernel holds the (b, h) value slab in VMEM and multiplies it by a
// dense (Q, S) interpolation-times-weight "splat" on the MXU, padding Q to
// 8, S and Dh to 128: artefacts of the TPU's matrix unit. Here the gather
// is done directly, in one of two schedules that the wrapper's plan picks:
//
// - "staged" (many taps a value row): a block holds the value rows of one
//   (b, h) in shared memory, copied once with 16-byte cp.async, and a group
//   of lanes takes a query at a time: each lane holds a 16-byte vector of
//   channels (4 in f32, 8 in bf16), walks the query's L*P taps, reads the
//   two rows of each from shared memory and sums in f32 registers; the
//   output is written once with 16-byte stores. Every value byte then leaves
//   L2 once per block instead of once per tap (about 16 times a row at the
//   encoder's shapes). Where the rows do not fit ("staged_chunked"), the
//   block walks the token axis in chunks and keeps the partial sums of its
//   queries in shared memory between chunks; a Dh wider than one group's
//   vectors is cut into channel slices, a block each.
// - "gather" (few taps a row, such as the decoder's 20 queries): one lane
//   group a query, each lane reading its two 16-byte vectors of each tap
//   straight from global memory (L2); staging rows that few taps read would
//   cost more than it saves.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): memory. At the serving
// shapes (B=16, S=563, H=8, Dh=64, L=P=4, f32) the encoder call (Q=282)
// touches nearly every value row (18.4 MB), reads 4.62 MB of loc and aw and
// writes 9.24 MB of output, 32.3 MB or about 9.6 us. The decoder call (Q=20)
// touches at most 2*Q*P = 160 rows per (b, h, level), about half of value
// on random locations, so about 9.8 MB or 2.9 us. Its arithmetic, 5
// operations per tap and channel plus 8 per tap, is 0.19 GFLOP for the
// encoder call, about 2.8 us at the f32 rate. The staged schedule reads
// each tap's two rows from shared memory, 2 * 256 bytes a tap in f32: 2.3 MB
// per (b, h) at the encoder's shapes, about 10 us at 128 bytes a clock per
// SM, which is what it has to beat the bound with.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 16
#define MSDA_SMEM_LIMIT 232448  // shared memory a block may have on sm_90

struct MsdaLevels {
  int T[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

// VEC consecutive channels as floats, from f32 or bf16, one load when the
// vector is 16 bytes
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);             // low half: the first channel
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_vec(const float* p, float (&v)[1]) { v[0] = *p; }
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}

// the same, rounded once to the output's type
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 t;
  uint32_t* w = reinterpret_cast<uint32_t*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h2);
  }
  *reinterpret_cast<uint4*>(p) = t;
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[1]) { *p = v[0]; }
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16(v[0]);
}

struct MsdaTap {
  int i0, i1;  // level-local rows
  float w0, w1;
};

__device__ __forceinline__ MsdaTap msda_tap(float loc, int T) {
  // rounded product, then rounded difference, as the plain version computes
  // it: a fused multiply-add would move x by up to one ulp of T (3e-5 tokens
  // at T = 300) and the interpolation weights with it
  float x = __fadd_rn(__fmul_rn(loc, (float)T), -0.5f);
  x = fminf(fmaxf(x, 0.f), (float)(T - 1));
  const float x0 = floorf(x);
  MsdaTap t;
  t.w1 = x - x0;
  t.w0 = 1.f - t.w1;
  t.i0 = (int)x0;
  t.i1 = min(t.i0 + 1, T - 1);
  return t;
}

// One tap as a lane group reads it: the two value rows (-1: not in the rows
// at hand) and their weights times the attention weight.
struct __align__(16) MsdaTapRows {
  int s0, s1;
  float c0, c1;
};

// The lane group's taps t0 .. t0 + lpq - 1 of query row `tap0`: lane gl
// computes tap t0 + gl into stage[gl]; rows are taken relative to r0 and
// kept where they fall in [0, nr). The group syncs before (the last batch's
// reads) and after.
__device__ __forceinline__ void stage_taps(MsdaTapRows* stage, const float* __restrict__ loc,
                                           const float* __restrict__ aw, size_t tap0, int t0,
                                           int LP, int P, const int* lT, const int* lstart,
                                           int r0, int nr, int gl, unsigned gmask) {
  const int t = t0 + gl;
  MsdaTapRows tr = {-1, -1, 0.f, 0.f};
  if (t < LP) {
    const int l = t / P;
    const MsdaTap m = msda_tap(__ldg(loc + tap0 + t), lT[l]);
    const float a = __ldg(aw + tap0 + t);
    const int s0 = lstart[l] - r0 + m.i0, s1 = lstart[l] - r0 + m.i1;
    if ((unsigned)s0 < (unsigned)nr) { tr.s0 = s0; tr.c0 = a * m.w0; }
    if ((unsigned)s1 < (unsigned)nr) { tr.s1 = s1; tr.c1 = a * m.w1; }
  }
  __syncwarp(gmask);
  stage[gl] = tr;
  __syncwarp(gmask);
}

// The level lengths and starts in shared memory, where a tap's level can
// index them (a kernel parameter indexed at run time is copied to local
// memory by every thread). Callers sync before reading them.
__device__ __forceinline__ void levels_to_shared(const MsdaLevels& lv, int L, int* lT,
                                                 int* lstart) {
  if (threadIdx.x < L) {
#pragma unroll
    for (int i = 0; i < MSDA_MAX_LEVELS; ++i)
      if (i == (int)threadIdx.x) {
        lT[i] = lv.T[i];
        lstart[i] = lv.start[i];
      }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Block (b, h, channel slice, query tile) of the staged schedule: grid
// (B * H * slices * tiles), any block size that is a multiple of lpq. lpq
// lanes take a query, each one VEC-channel vector of the slice (DC = lpq *
// VEC channels). Shared memory: rows x DC of T (the slab), then, when the
// token axis takes more than one chunk, q_tile x DC floats (partial sums),
// then one MsdaTapRows a thread (each group's taps at hand).
template <typename T, int VEC>
__global__ void __launch_bounds__(512)
msda_fwd_staged_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                       const float* __restrict__ aw, T* __restrict__ out, int S, int H,
                       int Dh, int Q, int L, int P, MsdaLevels lv, int lpq, int rows,
                       int q_tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int lT[MSDA_MAX_LEVELS], lstart[MSDA_MAX_LEVELS];
  levels_to_shared(lv, L, lT, lstart);  // read after the slab's barrier
  const int DC = lpq * VEC;
  const int slices = (Dh + DC - 1) / DC;
  const int tiles = (Q + q_tile - 1) / q_tile;
  int blk = blockIdx.x;
  const int tile = blk % tiles;
  blk /= tiles;
  const int slice = blk % slices;
  blk /= slices;
  const int h = blk % H;
  const int b = blk / H;

  T* slab = reinterpret_cast<T*>(smem);
  const size_t slab_bytes = ((size_t)rows * DC * sizeof(T) + 15) & ~(size_t)15;
  const int chunks = (S + rows - 1) / rows;
  float* part = reinterpret_cast<float*>(smem + slab_bytes);
  MsdaTapRows* stage = reinterpret_cast<MsdaTapRows*>(
      smem + slab_bytes + (chunks > 1 ? (((size_t)q_tile * DC * 4 + 15) & ~(size_t)15) : 0));

  const int gl = threadIdx.x % lpq;
  const int group = threadIdx.x / lpq;
  const int groups = blockDim.x / lpq;
  const int c = slice * DC + gl * VEC;  // first channel of this lane
  const bool active = c < Dh;           // VEC divides Dh, so all VEC or none
  const unsigned gmask = (lpq == 32 ? 0xffffffffu : ((1u << lpq) - 1u))
                         << ((threadIdx.x & 31) & ~(lpq - 1));
  stage += group * lpq;
  const int q0 = tile * q_tile, q1 = min(Q, q0 + q_tile);
  const int LP = L * P;
  const size_t row = (size_t)H * Dh;  // stride between tokens
  const T* vb = value + (size_t)b * S * row + (size_t)h * Dh + (size_t)slice * DC;
  const int nvec = min(DC, Dh - slice * DC) / VEC;  // vectors of the slice in a row

  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int r0 = chunk * rows, nr = min(rows, S - r0);
    if (chunk > 0) __syncthreads();  // every group is done with the last chunk
    for (int i = threadIdx.x; i < nr * nvec; i += blockDim.x) {
      const int r = i / nvec, j = i - r * nvec;
      T* dst = slab + (size_t)r * DC + j * VEC;
      const T* src = vb + (size_t)(r0 + r) * row + j * VEC;
      if (VEC * sizeof(T) == 16)
        cp_async16(dst, src);
      else
        *dst = *src;
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    for (int q = q0 + group; q < q1; q += groups) {
      float acc[VEC];
      float* pq = part + (size_t)(q - q0) * DC + gl * VEC;
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = (chunk > 0 && active) ? pq[k] : 0.f;
      const size_t tap0 = (((size_t)b * Q + q) * H + h) * LP;
      for (int t0 = 0; t0 < LP; t0 += lpq) {
        stage_taps(stage, loc, aw, tap0, t0, LP, P, lT, lstart, r0, nr, gl, gmask);
        const int n = min(lpq, LP - t0);
        if (!active) continue;
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
          const MsdaTapRows tr = stage[j];
          float v[VEC];
          if (tr.s0 >= 0) {
            load_vec(slab + (size_t)tr.s0 * DC + gl * VEC, v);
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] += tr.c0 * v[k];
          }
          if (tr.s1 >= 0) {
            load_vec(slab + (size_t)tr.s1 * DC + gl * VEC, v);
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] += tr.c1 * v[k];
          }
        }
      }
      if (!active) continue;
      if (chunk + 1 < chunks) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) pq[k] = acc[k];
      } else {
        store_vec(out + (((size_t)b * Q + q) * H + h) * Dh + c, acc);
      }
    }
  }
}

// Block of the gather schedule: grid (B * H * slices * ceil(Q / (blockDim /
// lpq))); lpq lanes a query, each lane one VEC-channel vector, read from
// global memory; the group's taps staged as in the staged schedule.
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
msda_fwd_gather_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                       const float* __restrict__ aw, T* __restrict__ out, int S, int H,
                       int Dh, int Q, int L, int P, MsdaLevels lv, int lpq) {
  __shared__ MsdaTapRows stage_all[256];
  __shared__ int lT[MSDA_MAX_LEVELS], lstart[MSDA_MAX_LEVELS];
  levels_to_shared(lv, L, lT, lstart);
  __syncthreads();
  const int DC = lpq * VEC;
  const int slices = (Dh + DC - 1) / DC;
  const int groups = blockDim.x / lpq;
  const int tiles = (Q + groups - 1) / groups;
  int blk = blockIdx.x;
  const int tile = blk % tiles;
  blk /= tiles;
  const int slice = blk % slices;
  blk /= slices;
  const int h = blk % H;
  const int b = blk / H;
  const int gl = threadIdx.x % lpq, group = threadIdx.x / lpq;
  const int q = tile * groups + group;
  const int c = slice * DC + gl * VEC;
  if (q >= Q) return;  // whole groups
  const unsigned gmask = (lpq == 32 ? 0xffffffffu : ((1u << lpq) - 1u))
                         << ((threadIdx.x & 31) & ~(lpq - 1));
  MsdaTapRows* stage = stage_all + group * lpq;

  const int LP = L * P;
  const size_t row = (size_t)H * Dh;
  const T* vb = value + (size_t)b * S * row + (size_t)h * Dh + c;
  const size_t tap0 = (((size_t)b * Q + q) * H + h) * LP;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int t0 = 0; t0 < LP; t0 += lpq) {
    stage_taps(stage, loc, aw, tap0, t0, LP, P, lT, lstart, 0, S, gl, gmask);
    const int n = min(lpq, LP - t0);
    if (c >= Dh) continue;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const MsdaTapRows tr = stage[j];
      float v0[VEC], v1[VEC];
      load_vec(vb + (size_t)tr.s0 * row, v0);
      load_vec(vb + (size_t)tr.s1 * row, v1);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += tr.c0 * v0[k] + tr.c1 * v1[k];
    }
  }
  if (c < Dh) store_vec(out + (((size_t)b * Q + q) * H + h) * Dh + c, acc);
}

template <typename T, int VEC>
static int msda_fwd_run(const void* value, const void* loc, const void* aw, void* out, int B,
                        int S, int H, int Dh, int Q, int L, int P, const MsdaLevels& lv,
                        int lpq, int rows, int q_tile, int threads, cudaStream_t st) {
  const int DC = lpq * VEC;
  const long long slices = (Dh + DC - 1) / DC;
  if (rows == 0) {  // gather
    const long long tiles = (Q + threads / lpq - 1) / (threads / lpq);
    const long long blocks = (long long)B * H * slices * tiles;
    if (blocks > 0x7fffffffLL || threads > 256) return (int)cudaErrorInvalidValue;
    msda_fwd_gather_kernel<T, VEC><<<(unsigned)blocks, threads, 0, st>>>(
        (const T*)value, (const float*)loc, (const float*)aw, (T*)out, S, H, Dh, Q, L, P, lv,
        lpq);
    return (int)cudaGetLastError();
  }
  const int chunks = (S + rows - 1) / rows;
  const size_t slab = ((size_t)rows * DC * sizeof(T) + 15) & ~(size_t)15;
  const size_t part = chunks > 1 ? (((size_t)q_tile * DC * 4 + 15) & ~(size_t)15) : 0;
  const size_t smem = slab + part + (size_t)threads * sizeof(MsdaTapRows);
  if (smem > MSDA_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(msda_fwd_staged_kernel<T, VEC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const long long blocks = (long long)B * H * slices * ((Q + q_tile - 1) / q_tile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  msda_fwd_staged_kernel<T, VEC><<<(unsigned)blocks, threads, smem, st>>>(
      (const T*)value, (const float*)loc, (const float*)aw, (T*)out, S, H, Dh, Q, L, P, lv, lpq,
      rows, q_tile);
  return (int)cudaGetLastError();
}

// Plain C entry point, bound from Python with ctypes. The schedule comes
// from the wrapper's plan: `vec` channels a lane (4 or 1 for f32 value, 8
// or 1 for bf16; vec > 1 needs Dh % vec == 0 and 16-byte aligned value and
// out), `lpq` lanes a query (a power of two <= 16), `rows` value rows a
// chunk (0: the gather schedule), `q_tile` queries a block of the staged
// schedule, `threads` a block. level_T is a host array of L ints. Returns
// the CUDA error code of the launch (0 = success).
extern "C" int msda_fwd_launch(const void* value, const void* loc,
                               const void* aw, void* out, int B, int S, int H,
                               int Dh, int Q, int L, int P, const int* level_T,
                               int value_is_bf16, int vec, int lpq, int rows, int q_tile,
                               int threads, void* stream) {
  if (B <= 0 || Q <= 0 || H <= 0 || L <= 0 || P <= 0 || Dh <= 0 ||
      L > MSDA_MAX_LEVELS || Dh > 1024 || lpq <= 0 || lpq > 16 || (lpq & (lpq - 1)) ||
      rows < 0 || (rows > 0 && q_tile <= 0) || threads <= 0 || threads > 512 ||
      threads % 32 != 0 || Dh % vec != 0)
    return (int)cudaErrorInvalidValue;
  MsdaLevels lv;
  int s = 0;
  for (int l = 0; l < L; ++l) {
    if (level_T[l] <= 0) return (int)cudaErrorInvalidValue;
    lv.T[l] = level_T[l];
    lv.start[l] = s;
    s += level_T[l];
  }
  if (s != S) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (value_is_bf16) {
    if (vec == 8)
      return msda_fwd_run<__nv_bfloat16, 8>(value, loc, aw, out, B, S, H, Dh, Q, L, P, lv, lpq,
                                            rows, q_tile, threads, st);
    if (vec == 1)
      return msda_fwd_run<__nv_bfloat16, 1>(value, loc, aw, out, B, S, H, Dh, Q, L, P, lv, lpq,
                                            rows, q_tile, threads, st);
  } else {
    if (vec == 4)
      return msda_fwd_run<float, 4>(value, loc, aw, out, B, S, H, Dh, Q, L, P, lv, lpq, rows,
                                    q_tile, threads, st);
    if (vec == 1)
      return msda_fwd_run<float, 1>(value, loc, aw, out, B, S, H, Dh, Q, L, P, lv, lpq, rows,
                                    q_tile, threads, st);
  }
  return (int)cudaErrorInvalidValue;
}
