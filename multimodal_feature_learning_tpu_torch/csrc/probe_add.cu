// K5: out = x + 1, elementwise, for float32 and bfloat16 arrays of any shape.
//
// Replaces the Pallas kernel `add_kernel` of tools/probe_op_overhead.py
// (driven by `pallas_add`), which maps the whole array to one block and
// writes an output of x's shape and dtype. It exists as a probe of what one
// kernel launch costs, not for its arithmetic: at the probe's (160, 64) bf16
// it moves 40,960 bytes (1.2e-5 ms at 3.35 TB/s), so launch latency, not
// bytes, sets its time. Larger arrays are bound by bytes; the kernel then
// streams the array once with a grid-stride loop, one element a thread and
// step, the blocks capped at a few per SM.
//
// bf16 adds in f32 and rounds to nearest even (__float2bfloat16_rn), as
// torch's `x + 1` and XLA's do, so the results are bitwise equal.
//
// The launcher takes the caller's stream and neither synchronises nor
// allocates, so a CUDA graph can capture it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;

__global__ void probe_add_f32(const float* __restrict__ x, float* __restrict__ out,
                              long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = x[i] + 1.0f;
}

__global__ void probe_add_bf16(const __nv_bfloat16* __restrict__ x,
                               __nv_bfloat16* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = __float2bfloat16_rn(__bfloat162float(x[i]) + 1.0f);
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. Returns the CUDA error
// code of the launch (0 = success).
extern "C" int probe_add_launch(const void* x, void* out, long long n, int is_bf16,
                                void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    probe_add_bf16<<<(unsigned)blocks, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, n);
  } else {
    probe_add_f32<<<(unsigned)blocks, kThreads, 0, st>>>((const float*)x, (float*)out, n);
  }
  return (int)cudaGetLastError();
}
