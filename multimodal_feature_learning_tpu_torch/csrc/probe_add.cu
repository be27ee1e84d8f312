// K5: out = x + 1, elementwise, for float32 and bfloat16 arrays of any shape.
//
// Replaces the Pallas kernel `add_kernel` of tools/probe_op_overhead.py
// (driven by `pallas_add`), which maps the whole array to one block and
// writes an output of x's shape and dtype. It exists as a probe of what one
// kernel launch costs, not for its arithmetic: at the probe's (160, 64) bf16
// it moves 40,960 bytes (1.2e-5 ms at 3.35 TB/s), so launch latency, not
// bytes, sets its time. Larger arrays are bound by bytes: each element is
// read once and written once. So each thread moves two 16-byte vectors a
// turn (float4, or 8 bf16 as one uint4; both loads issued before the
// stores), a grid of 256-thread blocks covering the array up to 32 blocks
// an SM (the SM count read from the device), then striding; 32-bit indices
// below 2^30 elements. A scalar head brings x and out to a 16-byte boundary
// and a scalar tail covers the ragged end. Where x and out differ in their
// offset mod 16, every element takes the scalar path.
//
// bf16 adds in f32 and rounds to nearest even (__float2bfloat16_rn), as
// torch's `x + 1` and XLA's do, so the results are bitwise equal.
//
// The launcher takes the caller's stream and neither synchronises nor
// allocates, so a CUDA graph can capture it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVpt = 2;           // 16-byte vectors a thread takes a turn, loads before stores
constexpr int kBlocksPerSm = 32;  // four turns of the 8 blocks an SM holds at once

__device__ __forceinline__ float add1(float v) { return v + 1.0f; }

__device__ __forceinline__ __nv_bfloat16 add1(__nv_bfloat16 v) {
  return __float2bfloat16_rn(__bfloat162float(v) + 1.0f);
}

// 16 bytes: four f32 or eight bf16.
__device__ __forceinline__ uint4 add1_vec(uint4 v, float) {
  float4 f = *reinterpret_cast<float4*>(&v);
  f.x = add1(f.x); f.y = add1(f.y); f.z = add1(f.z); f.w = add1(f.w);
  return *reinterpret_cast<uint4*>(&f);
}

__device__ __forceinline__ uint4 add1_vec(uint4 v, __nv_bfloat16) {
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = add1(h[i]);
  return v;
}

// kVpt 16-byte vectors a thread and turn over the nvec vectors between
// elements [0, head) and [head + nvec * per, n); the first threads of the
// grid also take those head and tail elements one at a time. I is the index
// type: 32-bit where the array allows it.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
probe_add_kernel(const T* __restrict__ x, T* __restrict__ out, I n, I head, I nvec) {
  constexpr int per = 16 / sizeof(T);
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4* ov = reinterpret_cast<uint4*>(out + head);
  const I tile = (I)kThreads * kVpt;
  for (I base = (I)blockIdx.x * tile + threadIdx.x; base < nvec; base += (I)gridDim.x * tile) {
    uint4 v[kVpt];
#pragma unroll
    for (int u = 0; u < kVpt; ++u)
      if (base + u * kThreads < nvec) v[u] = __ldg(xv + base + u * kThreads);
#pragma unroll
    for (int u = 0; u < kVpt; ++u)
      if (base + u * kThreads < nvec) ov[base + u * kThreads] = add1_vec(v[u], T());
  }
  const I stride = (I)gridDim.x * kThreads;
  const I tail = head + nvec * per, scalars = head + (n - tail);
  for (I i = (I)blockIdx.x * kThreads + threadIdx.x; i < scalars; i += stride) {
    const I j = i < head ? i : tail + (i - head);
    out[j] = add1(x[j]);
  }
}

template <typename T, typename I>
int launch_as(const void* x, void* out, I n, int max_blocks, cudaStream_t stream) {
  constexpr I per = 16 / sizeof(T);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), oa = reinterpret_cast<uintptr_t>(out);
  I head = n, nvec = 0;  // x and out differ mod 16: every element scalar
  if (xa % 16 == oa % 16 && xa % sizeof(T) == 0) {
    head = (I)((16 - xa % 16) % 16 / sizeof(T));
    if (head > n) head = n;
    nvec = (n - head) / per;
  }
  const I scalars = head + (n - head - nvec * per);
  long long blocks = ((long long)nvec + kThreads * kVpt - 1) / (kThreads * kVpt);
  if (blocks < ((long long)scalars + kThreads - 1) / kThreads)
    blocks = ((long long)scalars + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  probe_add_kernel<T, I><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, head, nvec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* out, long long n, cudaStream_t stream) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int max_blocks = sms * kBlocksPerSm;
  if (n < (1LL << 30)) return launch_as<T, int>(x, out, (int)n, max_blocks, stream);
  return launch_as<T, long long>(x, out, n, max_blocks, stream);
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. Returns the CUDA error
// code of the launch (0 = success).
extern "C" int probe_add_launch(const void* x, void* out, long long n, int is_bf16,
                                void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(x, out, n, st) : launch<float>(x, out, n, st);
}
