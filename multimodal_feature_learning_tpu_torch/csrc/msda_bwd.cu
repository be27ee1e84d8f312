// Backward of 1-D multi-scale deformable attention (MSDA) for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas_msda.py::_msda_bwd_kernel of the JAX
// package (driven by _bwd_pallas, the backward of the custom VJP of
// ms_deform_attn_pallas). For each tap (l, p) of each (b, q, h), with
//
//   x  = clip(loc * T_l - 0.5, 0, T_l - 1), i0 = floor(x),
//   i1 = min(i0 + 1, T_l - 1), w1 = x - i0, w0 = 1 - w1,
//   g0 = sum_c g[b,q,h,c] * value[b, start_l + i0, h, c]   (g1 likewise at i1):
//
//   daw[b,q,h,l,p]  = g0 * w0 + g1 * w1
//   dloc[b,q,h,l,p] = (g1 - g0) * aw * T_l  where 0 < loc * T_l - 0.5 < T_l - 1,
//                     else 0 (the clamp passes no gradient)
//   dvalue[b, start_l + i0, h, :] += aw * w0 * g[b,q,h,:]
//   dvalue[b, start_l + i1, h, :] += aw * w1 * g[b,q,h,:]
//
// The TPU kernel rebuilds the dense (Q, S) interpolation-times-weight
// "splat" and its cotangent in VMEM and runs two MXU products per (b, h).
// Here the same work is a gather plus a scatter-add: one warp per (b, q, h).
// Lane t < L*P reads tap t's loc and aw and computes its coordinate; the
// taps are then walked one by one, broadcast from their lane with shuffles.
// Each lane holds Dh/32 channels of g (2 at Dh = 64), reads the two value
// rows of the tap on those channels (a warp reads 128 contiguous bytes of a
// row), reduces g0 and g1 across the warp with xor shuffles, and adds its
// share of dvalue with atomicAdd into a zeroed f32 buffer. daw and dloc of a
// (b, q, h, l, p) belong to one warp, so they need no atomics: the tap's
// lane keeps them and the warp writes them together at the end.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): memory. At the training
// shapes (B=16, S=563, H=8, Dh=64, L=P=4, f32) the encoder call (Q=282)
// reads the value rows its taps touch (nearly all of value, 18.4 MB), g
// (9.2 MB), loc and aw (4.6 MB), and writes dvalue (18.4 MB), dloc and daw
// (4.6 MB): about 55 MB, 16 us. Its arithmetic, about 8 operations per tap
// and channel, is 0.3 GFLOP, 4.4 us at the f32 rate. The atomics land in
// L2, where value and dvalue both fit (2 x 18.4 MB of 50 MB).

#include <cuda_runtime.h>

#define MSDA_MAX_LEVELS 16
#define MSDA_MAX_CH_PER_LANE 8  // Dh <= 256

struct MsdaLevels {
  int T[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// grid (ceil(B*Q*H / warps_per_block)), block (32 * warps_per_block). Warp w
// of the grid handles (b, q, h) = unravel(w, (B, Q, H)).
__global__ void msda_bwd_kernel(const float* __restrict__ value,
                                const float* __restrict__ loc,
                                const float* __restrict__ aw,
                                const float* __restrict__ g,
                                float* __restrict__ dvalue,
                                float* __restrict__ dloc,
                                float* __restrict__ daw, int B, int S, int H,
                                int Dh, int Q, int L, int P, MsdaLevels lv) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp >= (long long)B * Q * H) return;  // whole warps exit together
  const int h = (int)(warp % H);
  const int b = (int)(warp / ((long long)H * Q));
  const int LP = L * P;
  const int nch = (Dh + 31) >> 5;

  const size_t row = (size_t)H * Dh;  // stride between tokens
  const size_t vbase = (size_t)b * S * row + (size_t)h * Dh;
  const size_t tap0 = (size_t)warp * LP;  // (b, q, h) is row-major in loc/aw
  const float* gq = g + (size_t)warp * Dh;

  float gr[MSDA_MAX_CH_PER_LANE];
#pragma unroll
  for (int k = 0; k < MSDA_MAX_CH_PER_LANE; ++k) {
    const int c = lane + 32 * k;
    gr[k] = (k < nch && c < Dh) ? gq[c] : 0.f;
  }

  for (int base = 0; base < LP; base += 32) {
    const int t = base + lane;
    // this lane's tap: level, coordinate, taps and weights
    float a = 0.f, w0 = 0.f, w1 = 0.f, Tf = 0.f;
    int r0 = 0, r1 = 0, inside = 0;
    if (t < LP) {
      const int l = t / P;
      const int T = lv.T[l];
      Tf = (float)T;
      // rounded product, then rounded difference, as the plain version and
      // the forward kernel compute it (no fused multiply-add)
      const float xr = __fadd_rn(__fmul_rn(loc[tap0 + t], Tf), -0.5f);
      inside = (xr > 0.f) && (xr < (float)(T - 1));
      const float x = fminf(fmaxf(xr, 0.f), (float)(T - 1));
      const float x0 = floorf(x);
      w1 = x - x0;
      w0 = 1.f - w1;
      const int i0 = (int)x0;
      r0 = lv.start[l] + i0;
      r1 = lv.start[l] + min(i0 + 1, T - 1);
      a = aw[tap0 + t];
    }
    float my_daw = 0.f, my_dloc = 0.f;
    const int ntap = min(32, LP - base);
    for (int j = 0; j < ntap; ++j) {
      const int s0 = __shfl_sync(0xffffffffu, r0, j);
      const int s1 = __shfl_sync(0xffffffffu, r1, j);
      const float aj = __shfl_sync(0xffffffffu, a, j);
      const float w0j = __shfl_sync(0xffffffffu, w0, j);
      const float w1j = __shfl_sync(0xffffffffu, w1, j);
      const float* v0 = value + vbase + (size_t)s0 * row;
      const float* v1 = value + vbase + (size_t)s1 * row;
      float* d0 = dvalue + vbase + (size_t)s0 * row;
      float* d1 = dvalue + vbase + (size_t)s1 * row;
      const float c0 = aj * w0j, c1 = aj * w1j;
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int k = 0; k < MSDA_MAX_CH_PER_LANE; ++k) {
        const int c = lane + 32 * k;
        if (k < nch && c < Dh) {
          p0 += gr[k] * __ldg(v0 + c);
          p1 += gr[k] * __ldg(v1 + c);
          atomicAdd(d0 + c, c0 * gr[k]);
          atomicAdd(d1 + c, c1 * gr[k]);
        }
      }
      const float g0 = warp_sum(p0);
      const float g1 = warp_sum(p1);
      if (lane == j) {
        my_daw = g0 * w0 + g1 * w1;
        my_dloc = inside ? (g1 - g0) * a * Tf : 0.f;
      }
    }
    if (t < LP) {
      daw[tap0 + t] = my_daw;
      dloc[tap0 + t] = my_dloc;
    }
  }
}

// Plain C entry point, bound from Python with ctypes. value, loc, aw and g
// are f32 and contiguous; dvalue must be zeroed by the caller. level_T is a
// host array of L ints. Returns the CUDA error code of the launch (0 =
// success).
extern "C" int msda_bwd_launch(const void* value, const void* loc,
                               const void* aw, const void* g, void* dvalue,
                               void* dloc, void* daw, int B, int S, int H,
                               int Dh, int Q, int L, int P, const int* level_T,
                               void* stream) {
  if (B <= 0 || Q <= 0 || H <= 0 || L <= 0 || P <= 0 || Dh <= 0 ||
      L > MSDA_MAX_LEVELS || Dh > 32 * MSDA_MAX_CH_PER_LANE)
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

  const int warps_per_block = 8;
  const long long warps = (long long)B * Q * H;
  const long long blocks = (warps + warps_per_block - 1) / warps_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  msda_bwd_kernel<<<(unsigned)blocks, 32 * warps_per_block, 0, (cudaStream_t)stream>>>(
      (const float*)value, (const float*)loc, (const float*)aw, (const float*)g,
      (float*)dvalue, (float*)dloc, (float*)daw, B, S, H, Dh, Q, L, P, lv);
  return (int)cudaGetLastError();
}
