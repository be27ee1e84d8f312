// Forward of 1-D multi-scale deformable attention (MSDA) for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas_msda.py::_msda_fwd_kernel of the JAX
// package (driven by _fwd_pallas, exported as ms_deform_attn_pallas):
//
//   out[b,q,h,:] = sum_l sum_p aw[b,q,h,l,p] *
//                  lerp(value[b, start_l : start_l+T_l, h, :],
//                       clip(loc[b,q,h,l,p] * T_l - 0.5, 0, T_l - 1))
//
// The TPU kernel builds a dense (Q, S) interpolation-times-weight "splat" in
// VMEM and multiplies it with the value slab on the MXU, padding Q to 8, S
// and Dh to 128. Those are artefacts of the TPU's matrix unit. Here the
// gather is done directly: one block per (b, h, tile of queries), one thread
// per (query, channel); each thread walks the L*P taps, reads the two
// neighbouring value rows and accumulates in f32. The output is written in
// value's dtype (f32 or bf16).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): memory. At the serving
// shapes (B=16, S=563, H=8, Dh=64, L=P=4, f32) the encoder call (Q=282)
// touches nearly every value row (18.4 MB), reads 4.62 MB of loc and aw and
// writes 9.24 MB of output, 32.3 MB or about 9.6 us. The decoder call (Q=20)
// touches at most 2*Q*P = 160 rows per (b, h, level), about half of value
// on random locations, so about 9.8 MB or 2.9 us. Its arithmetic, 5
// operations per tap and channel plus 8 per tap, is 0.19 GFLOP for the
// encoder call, about 2.8 us at the f32 rate. Neighbouring
// threads read neighbouring channels, so each warp reads 128 contiguous
// bytes of a value row, and the value tensor (18.45 MB) stays in the 50 MB
// L2 across the blocks that share it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MSDA_MAX_LEVELS 16

struct MsdaLevels {
  int T[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

__device__ __forceinline__ float msda_load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float msda_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void msda_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void msda_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// grid (ceil(Q / qt), H, B); block (Dh, qt); dynamic shared memory holds the
// tile's loc and aw, 2 * qt * L * P floats.
template <typename scalar_t>
__global__ void msda_fwd_kernel(const scalar_t* __restrict__ value,
                                const float* __restrict__ loc,
                                const float* __restrict__ aw,
                                scalar_t* __restrict__ out, int S, int H,
                                int Dh, int Q, int L, int P, MsdaLevels lv) {
  extern __shared__ float smem[];
  const int LP = L * P;
  const int qt = blockDim.y;
  const int q0 = blockIdx.x * qt;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  float* s_loc = smem;
  float* s_aw = smem + qt * LP;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < qt * LP; i += nthreads) {
    const int q = q0 + i / LP;
    float lo = 0.f, a = 0.f;
    if (q < Q) {
      const size_t off = (((size_t)b * Q + q) * H + h) * LP + (i % LP);
      lo = loc[off];
      a = aw[off];
    }
    s_loc[i] = lo;
    s_aw[i] = a;
  }
  __syncthreads();

  const int q = q0 + threadIdx.y;
  const int c = threadIdx.x;
  if (q >= Q || c >= Dh) return;

  const size_t row = (size_t)H * Dh;  // stride between tokens
  const scalar_t* vb = value + (size_t)b * S * row + (size_t)h * Dh + c;
  const float* ql = s_loc + threadIdx.y * LP;
  const float* qa = s_aw + threadIdx.y * LP;

  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    const int T = lv.T[l];
    const scalar_t* vl = vb + (size_t)lv.start[l] * row;
    float lacc = 0.f;
    for (int p = 0; p < P; ++p) {
      // rounded product, then rounded difference, as the plain version
      // computes it: a fused multiply-add would move x by up to one ulp of
      // T (3e-5 tokens at T = 300) and the interpolation weights with it
      float x = __fadd_rn(__fmul_rn(ql[l * P + p], (float)T), -0.5f);
      x = fminf(fmaxf(x, 0.f), (float)(T - 1));
      const float x0 = floorf(x);
      const float w1 = x - x0;
      const float w0 = 1.f - w1;
      const int i0 = (int)x0;
      const int i1 = min(i0 + 1, T - 1);
      const float v0 = msda_load(vl + (size_t)i0 * row);
      const float v1 = msda_load(vl + (size_t)i1 * row);
      lacc += (v0 * w0 + v1 * w1) * qa[l * P + p];
    }
    acc += lacc;
  }
  msda_store(out + (((size_t)b * Q + q) * H + h) * Dh + c, acc);
}

// Plain C entry point, bound from Python with ctypes. level_T is a host
// array of L ints. Returns the CUDA error code of the launch (0 = success).
extern "C" int msda_fwd_launch(const void* value, const void* loc,
                               const void* aw, void* out, int B, int S, int H,
                               int Dh, int Q, int L, int P, const int* level_T,
                               int value_is_bf16, void* stream) {
  if (B <= 0 || Q <= 0 || H <= 0 || L <= 0 || P <= 0 || Dh <= 0 ||
      L > MSDA_MAX_LEVELS || Dh > 1024)
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

  int qt = 256 / Dh;
  if (qt < 1) qt = 1;
  if (qt > Q) qt = Q;
  const size_t smem = 2 * (size_t)qt * L * P * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;

  const dim3 grid((Q + qt - 1) / qt, H, B);
  const dim3 block(Dh, qt);
  cudaStream_t st = (cudaStream_t)stream;
  if (value_is_bf16) {
    msda_fwd_kernel<__nv_bfloat16><<<grid, block, smem, st>>>(
        (const __nv_bfloat16*)value, (const float*)loc, (const float*)aw,
        (__nv_bfloat16*)out, S, H, Dh, Q, L, P, lv);
  } else {
    msda_fwd_kernel<float><<<grid, block, smem, st>>>(
        (const float*)value, (const float*)loc, (const float*)aw,
        (float*)out, S, H, Dh, Q, L, P, lv);
  }
  return (int)cudaGetLastError();
}
