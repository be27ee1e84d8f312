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
// depth 6, Sp=640, MLP 2048) a step is 15.6 GFLOP and 0.39 GB of weights,
// memory K/V and caches (0.21 GB with int8 K/V). The products run on the
// tensor cores in 3xTF32 (three TF32 passes, 0.0945 ms at 495 TFLOP/s), so
// the step is bound by bytes: 0.116 ms at 3.35 TB/s dense, 0.063 ms int8.
// The 88 MB of weights come from HBM on every step; the memory K/V (42 MB a
// layer dense) are the largest single read.
//
// Design. One persistent cooperative launch, one block of 512 threads on
// each SM (16 warps; at most 128 registers a thread), runs the layer loop;
// each layer is eight stages separated by grid-wide barriers:
//   1  q = LN3(x + sum of W2 partials + b2) Wq + bq (all 2G rows; layer 0
//      takes x as it is); k, v of the G commit rows, written straight into
//      the caches at position `step`
//   2  self-attention, one block per (video, head): the q rows and the keys
//      and values of positions < valid_len land in shared memory together;
//      each row reads its own event's keys only
//   3  y = x + (attn Wo + bo)
//   4  x = LN1(y); qc = x Wq' + bq'
//   5  cross-attention, one block per (video, head, chunk of 128 memory
//      columns), flash-decoding style: each unit keeps its chunk's max, sum
//      and unnormalised weighted sum of V
//   6  y = x + (combine(chunks) Wo' + bo')
//   7  x = LN2(y); h = gelu(x W1 + b1)
//   8  h W2, the reduction split in ceil(F / D) partial sums (four at F = 4D)
// and after the last layer x_out = LN3(x + sum + b2), one warp a row.
//
// What each choice does about the bound:
// - Every product is on the tensor cores (mma.sync m16n8k8 TF32, f32
//   accumulators) in 3xTF32: each operand is split into hi = rna_tf32(a) and
//   lo = rna_tf32(a - hi) as it is read, and each output sums lo*hi + hi*lo
//   + hi*hi, which keeps about f32 accuracy (the port's decode contract is
//   f32; one TF32 pass keeps 3 digits). A GEMM tile is 32 rows x 64 columns
//   over K = D = 512 at once: the whole weight slab is in flight by cp.async
//   while the tile's A rows are prepared, so a tile waits for memory once,
//   not once a K chunk. Each of the 16 warps sums one k slice; the slices
//   are added in a fixed order through shared memory.
// - A LayerNorm is no stage of its own: the tile that consumes it reads its
//   rows' whole width anyway (K = D), so it normalises them into its A
//   operand (from y, or from x and the W2 partials), and the tiles of column
//   block 0 write the new x. LN1 and LN2 rewrite x in place (nothing else
//   reads it in their stages); LN3, whose tiles read x as its residual,
//   writes the other half of a ping-pong buffer. The q/k/v tiles take two
//   column blocks each, so LN3 runs once a row block and the stage is one
//   round of tiles. The cross-attention's combine folds into the A operand
//   of Wo' the same way.
// - The cross-attention is split over Sp: B*H*Sp/128 = 640 units for 132
//   SMs instead of 128. Everything a unit reads (its K and V chunks, q rows,
//   mask columns, scales) lands by cp.async in one of two buffers while the
//   block's previous unit is summed; the logits and the weighted sum are
//   tensor-core products too (int8 K/V are exact in TF32: two passes). The
//   combine weighs the chunks in order c = 0, 1, ... by exp(m_c - max) and
//   adds the bias column once, so the result does not depend on the grid
//   size. A row whose every column is blocked has every logit at -1e20 *
//   scale, so after the combine its weights are uniform: it averages V over
//   all Sp columns, as the TPU "video" kernel does.
// - D and Dh are template parameters, so no LayerNorm or head loop runs
//   under a runtime bound; int8 K/V are widened exactly when read, the
//   k-scale goes on the logit and the v-scale on the weight.
// The two TPU grids are one decomposition here: grouping videos into a work
// unit only cut the card's parallelism, so "batch" runs the "video" schedule.
//
// Other widths (the TPU kernel takes any). A library is built for one
// (D, Dh) pair, -DFD_D=... -DFD_DH=... (default 512, 64: the flagship); the
// rest is taken at run time, and each shape's shared-memory plan is made at
// launch (plan_smem): B, depth, the events G (rows R = 2G), the caption
// length Tc, Sp = round_up(S, 128), F (the MLP's width) and the heads.
// - A GEMM tile keeps its BM x D A rows in shared memory (the LayerNorm
//   needs the whole row) and reads W in K chunks of KC rows: KC = D (the
//   whole slab at once, the flagship's schedule) where the slab fits beside
//   the A rows, else chunks double-buffered by cp.async (f32 D = 1024: KC =
//   128). A warp sums its k steps in order, chunk after chunk, and the k
//   slices are added in order, so a result does not depend on KC. The
//   W2 product is split in ceil(F / D) partials (four at F = 4D); the
//   LayerNorm that reads them adds them in order. A column block past N is
//   masked (N = D or F, a multiple of 16).
// - The cross-attention takes R rows in row tiles of 32, the K and V
//   chunk loaded once a unit; the weighted sum's (row, channel) tiles are
//   spread over the warps for any Dh. The unit's buffer is double-buffered
//   where two fit, else single; where one with the q rows does not fit
//   either (f32, Dh 128, R 64), q is read from L2. The combine weighs the
//   chunks in order c = 0, 1, ... in groups of at most five (their loads in
//   flight together), the weighted sum kept in the A rows between groups.
// - The self-attention unit is (video, head, group of events): the largest
//   group whose keys of every position fit; past one event it tiles the
//   positions, keeps every logit of its rows (two passes: exact softmax)
//   and the weighted sums between tiles, so the result is the same.
// - A shape whose plan exceeds the block's 227 KB of shared memory is
//   refused before the launch (FD_ERR_SMEM); the wrapper states the limits.
// - Two instantiations of the kernel: the general one (GEN true) above, and
//   the flagship's schedule (GEN false: Dh 64, at most 32 rows and five
//   chunks, F = 4D, the whole slab), every loop and layout fixed at compile
//   time, chosen at launch where it fits. The general code at the
//   flagship's shape spilled more and ran 12-15% slower on an H100.
//
// bf16 (the TPU kernels' ct = x.dtype = bf16, the JAX package's bf16
// decode). The kernel is a template on the element type T of x, x_out, the
// caches, the weights and dense memory K/V; the scratch buffers stay f32
// and hold values rounded to bf16 where the TPU kernel's .astype(ct)
// rounds: each product (f32 accumulators) before its bias, the bias sum,
// each residual sum, the LayerNorms' outputs (f32 statistics), GELU step by
// step, the attention logits before their f32 softmax, the self-attention
// weights and weighted sums. The GEMM tiles run one bf16 mma.sync.m16n8k16
// in place of the three TF32 passes, on a bf16 weight slab (half the bytes,
// 64 KB a column block; the room it frees is not used yet: same tiles, same
// schedule); the cross-attention's K and V chunks are bf16 (int8 widened to
// bf16 exactly) and both of its products bf16 too. One departure from the
// TPU kernel's rounding: the cross-attention's weights are rounded to bf16
// per chunk, exp(logit - m_c), before the combine divides by the row's sum
// (the TPU kernel rounds the weights after it divides); the combined sum is
// rounded before the bias column's term is added, and after, as there. The
// bf16 step moves half the bytes: about 0.19 GB, 0.058 ms at 3.35 TB/s;
// its 15.6 GFLOP at 989 TFLOP/s take 0.016 ms.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface (ops/build.py); bound with ctypes
// (ops/fused_decode.py). The launcher allocates nothing: the wrapper passes
// every output and scratch buffer, the chunk partials included.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int LAYER_STAGES = 8;   // grid barriers a layer
constexpr int MAX_TIMED_DEPTH = 16;  // layers whose stage times the timing build records
constexpr int BM = 32, BN = 64;   // GEMM tile
constexpr int RS = BN + 8;        // row stride of the warps' partial tiles
constexpr int RT = 32;            // rows of a cross-attention row tile
constexpr int CHUNK = 128;        // memory columns per cross-attention unit
constexpr int MAX_CG = 5;         // chunks the combine keeps in flight a group
constexpr int PS = CHUNK + 4;     // row stride of a unit's logits
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use (H100)
constexpr float NEG_MASK = -1e20f;
constexpr float LN_EPS = 1e-6f;

// errors of fused_decode_launch besides CUDA's own
constexpr int FD_ERR_WIDTHS = 1001;  // D, Dh differ from the library's build
constexpr int FD_ERR_SMEM = 1002;    // the shape's shared-memory plan exceeds SMEM_MAX
constexpr int FD_ERR_SHAPE = 1003;   // an argument out of its range

static_assert(BM * BN / 4 == THREADS, "the epilogue takes one float4 a thread");

}  // namespace

#ifdef FD_STAGE_TIMING
// Build with -DFD_STAGE_TIMING to record the device clock after every grid
// barrier (block 0) of the first MAX_TIMED_DEPTH layers; fused_decode_stage_ns
// copies the record to the host.
__device__ unsigned long long g_stage_ns[2 + LAYER_STAGES * MAX_TIMED_DEPTH];
__device__ unsigned long long g_barrier_ns[5];  // four grid barriers with no work between
__device__ unsigned long long g_sub_ns[8];  // phases of block 0's first cross-attention unit
// phases of block 0's first tile of four GEMM stages of a layer (GemmJob::tag)
__device__ unsigned long long g_gemm_ns[4][5];
#define GEMM_MARK(i)                                                    \
  do {                                                                  \
    if (timed && threadIdx.x == 0) {                                    \
      unsigned long long ns;                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));            \
      g_gemm_ns[j.tag - 1][(i)] = ns;                                   \
    }                                                                   \
  } while (0)
#define SUB_MARK(i)                                                     \
  do {                                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0 && li == 0 && it == 0) {    \
      unsigned long long ns;                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));            \
      g_sub_ns[(i)] = ns;                                               \
    }                                                                   \
  } while (0)
#define STAGE_MARK(i)                                                   \
  do {                                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0 && (i) < 2 + LAYER_STAGES * MAX_TIMED_DEPTH) { \
      unsigned long long ns;                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));            \
      g_stage_ns[(i)] = ns;                                             \
    }                                                                   \
  } while (0)
#else
#define STAGE_MARK(i) do {} while (0)
#define SUB_MARK(i) do {} while (0)
#define GEMM_MARK(i) do {} while (0)
#endif

namespace {

enum {
  SA_WQ, SA_BQ, SA_WK, SA_BK, SA_WV, SA_BV, SA_WO, SA_BO,
  CA_WQ, CA_BQ, CA_WK, CA_BK, CA_WV, CA_BV, CA_WO, CA_BO,
  MLP_W1, MLP_B1, MLP_W2, MLP_B2,
  LN1_S, LN1_B, LN2_S, LN2_B, LN3_S, LN3_B,
  N_WEIGHTS
};

// The buffers of type T (float, or __nv_bfloat16 in the bf16 build of the
// kernel) are held as void pointers: x_in, x_out, the caches, the weights
// and the dense memory K/V. The scratch buffers are f32 in both; in bf16
// they hold values rounded to bf16 where the TPU kernel rounds to ct.
struct Params {
  const void* x_in;
  void* x_out;
  float* xs;    // 2 x M x D: the hidden state after layer 0's first LayerNorm
  float* ybuf;  // M x D: x + (Wo or Wo' projection + bias), the input of LN1 and LN2
  float* part;  // nsplit2 x M x D: the split sums of the W2 projection
  void* kc;
  void* vc;
  const void* mem_k;
  const void* mem_v;
  const float* k_scales;
  const float* v_scales;
  const int8_t* mask;
  const float* log_m;
  const void* w[N_WEIGHTS];
  float* q_buf;
  float* attn_buf;
  float* h_buf;
  float* ca_o;   // (B, H, NC, R, Dh): each chunk's unnormalised weighted sum of V
  float* ca_ml;  // (B, H, NC, R, 2): each chunk's max logit and sum of exponentials
  float* ca_bl;  // (B, H, R): the bias column's logit of each row and head
  int B, G, R, C, Sp, F, NC, depth;
  int step, valid_len, has_bias, kv_int8;
  int nsplit2;  // partials of the W2 product: ceil(F / D)
  int cg;       // chunks a group of the combine (<= MAX_CG)
  int sa_eg, sa_pt;  // self-attention: events a unit, positions a tile
  int ca_nbuf, ca_q_ring;  // cross-attention: buffers (1 or 2); q rows in the buffer
  int ca_mask_off, ca_scale_off, ca_bytes;  // offsets and size of a buffer (bytes)
  float scale;
};

// How a GEMM tile prepares its A operand (BM rows x D columns).
enum AMode {
  A_PLAIN,    // rows of A (lda floats), columns [ks D, (ks + 1) D)
  A_LN,       // LN(rows of p.ybuf)
  A_LN4,      // LN(rows of A + (p.part[0] + ... + p.part[nsplit2 - 1] + ln_bias)), A the residual x
  A_COMBINE,  // the cross-attention's chunks combined, head h in columns [h Dh, (h + 1) Dh)
};

struct GemmJob {
  const void* A;       // f32, or T where a_t is set (x_in of layer 0)
  const void* W;       // K x N, row-major, T
  const void* bias;    // N, T
  const void* resid;   // M x N, or null: out = resid + (A W + bias); T where resid_t
  void* out;           // f32, or T where o_cache (or, with splits > 1, p.part[ks] gets the raw sums)
  int M, N, K, lda, amode;
  int splits;    // K in pieces of D: ceil(K / D)
  int nsub;      // column blocks of BN a tile takes in turn, its A prepared once
  int a_commit;  // A row m is x row (m / G) * R + m % G
  int o_cache;   // out row m is cache row (m / G) * C + step * G + m % G
  int gelu;
  int a_t, resid_t;  // A, resid of type T (x_in; only in the bf16 build)
  const void* ln_bias;
  const void* ln_s;
  const void* ln_b;
  float* x_next;  // the new x, written by the tiles of column block 0; or null
  int li;
  int tag;  // > 0: the timing build records block 0's first tile (g_gemm_ns[tag - 1])
};

template <typename T>
constexpr bool IS_BF16 = sizeof(T) == 2;

template <typename T>
__device__ __forceinline__ const T* wt(const void* p) {
  return static_cast<const T*>(p);
}

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

// v rounded to T and back: the TPU kernel's .astype(ct) (the identity in f32)
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (IS_BF16<T>)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

template <typename T>
__device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd<T>(v.x), rnd<T>(v.y), rnd<T>(v.z), rnd<T>(v.w));
}

__device__ __forceinline__ float4 bf4_to_f4(uint2 u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ uint2 f4_to_bf4(float4 v) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v.z, v.w);
  return u;
}

// two f32 values (bf16-exact where the kernel feeds them to the tensor
// cores) as a bf16x2 register: lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_raw(unsigned short lo, unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// an int8 as the bits of its bf16 value (exact: |v| <= 127)
__device__ __forceinline__ unsigned short i8_bf16(int8_t v) {
  const __nv_bfloat16 h = __float2bfloat16_rn((float)v);
  return *reinterpret_cast<const unsigned short*>(&h);
}

// erfc by Abramowitz & Stegun 7.1.26, the JAX kernel's _erfc_f32, each
// operation rounded on its own.
__device__ __forceinline__ float erfc_f32(float z) {
  const float a = fabsf(z);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(0.3275911f, a)));
  float poly = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  poly = __fadd_rn(1.421413741f, __fmul_rn(t, poly));
  poly = __fadd_rn(-0.284496736f, __fmul_rn(t, poly));
  poly = __fadd_rn(0.254829592f, __fmul_rn(t, poly));
  poly = __fmul_rn(t, poly);
  const float erfc_a = __fmul_rn(poly, expf(__fmul_rn(-a, a)));
  return z >= 0.0f ? erfc_a : __fsub_rn(2.0f, erfc_a);
}

// 0.5 x erfc(-x sqrt(1/2)), the JAX kernel's _gelu_exact: in f32 each
// operation rounded on its own; in bf16 each step rounded to bf16 as there
// (sqrt(1/2) in bf16, the erfc in f32 then rounded).
template <typename T>
__device__ __forceinline__ float gelu_exact(float x) {
  if constexpr (IS_BF16<T>) {
    const float z = rnd<T>(-x * 0.70703125f);
    return rnd<T>((0.5f * x) * rnd<T>(erfc_f32(z)));
  } else {
    return __fmul_rn(__fmul_rn(0.5f, x), erfc_f32(__fmul_rn(-x, 0.70710677f)));
  }
}

// Activations are written inside the launch by other blocks, so they are
// read through L2 (ld.global.cg), never from a stale L1 line; the weights
// and the memory K/V go through the read-only path.
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void sts4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// four T activations written in the launch (through L2), as f32
template <typename T>
__device__ __forceinline__ float4 ldc4(const T* p) {
  if constexpr (IS_BF16<T>)
    return bf4_to_f4(__ldcg(reinterpret_cast<const uint2*>(p)));
  else
    return ld4(p);
}

// four T weights (read-only path), as f32
template <typename T>
__device__ __forceinline__ float4 ldw4(const T* p) {
  if constexpr (IS_BF16<T>)
    return bf4_to_f4(__ldg(reinterpret_cast<const uint2*>(p)));
  else
    return ldg4(p);
}

template <typename T>
__device__ __forceinline__ float ldw(const T* p) {
  if constexpr (IS_BF16<T>)
    return __bfloat162float(*p);
  else
    return __ldg(p);
}

// four values stored as T (rounded to nearest even in bf16)
template <typename T>
__device__ __forceinline__ void stt4(T* p, float4 v) {
  if constexpr (IS_BF16<T>)
    *reinterpret_cast<uint2*>(p) = f4_to_bf4(v);
  else
    *reinterpret_cast<float4*>(p) = v;
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

// a rounded to TF32: 10 mantissa bits, to nearest, ties away from zero.
// For a finite a this is the bit pattern cvt.rna.tf32.f32 gives, in two
// integer operations instead of a conversion (ops/fused_decode.py's
// split_tf32 is its plain counterpart).
__device__ __forceinline__ uint32_t rna_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

// a = hi + lo, each rounded to TF32; the rest after hi is exact in f32.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(a);
  lo = rna_tf32(a - __uint_as_float(hi));
}

// c += a b for a 16x8 (rows) by 8x8 (columns) TF32 fragment pair.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b for a 16x16 (rows) by 16x8 (columns) bf16 fragment pair, f32
// accumulators. a0: row gid, k 2tig, 2tig+1; a1: row gid+8; a2: k + 8;
// a3: both. b0: k 2tig, 2tig+1 of column gid; b1: k + 8. c as in mma_tf32.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int a_row(const GemmJob& j, const Params& p, int m) {
  return j.a_commit ? (m / p.G) * p.R + m % p.G : m;
}

// A row's mean and 1 / sqrt(var + eps) from its lanes' partial sums, with
// the one-pass variance max(E[y^2] - mean^2, 0).
template <int D>
__device__ __forceinline__ void ln_stats(float sum, float sq, float& mean, float& inv) {
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  mean = sum / D;
  const float var = fmaxf(sq / D - mean * mean, 0.0f);
  inv = 1.0f / sqrtf(var + LN_EPS);
}

// y -> (y - mean) (inv s) + b, the LayerNorm of four columns.
__device__ __forceinline__ float4 ln_apply(float4 y, float mean, float inv, float4 s, float4 b) {
  return make_float4((y.x - mean) * (inv * s.x) + b.x, (y.y - mean) * (inv * s.y) + b.y,
                     (y.z - mean) * (inv * s.z) + b.z, (y.w - mean) * (inv * s.w) + b.w);
}

// Lane `lane` holds columns lane * 4 + 128 i, i < LN_PER(D), of a row; the
// last ones past D (where D is no multiple of 128) hold zeros.
template <int D>
constexpr int LN_PER = (D + 127) / 128;

template <int D>
__device__ __forceinline__ bool ln_col(int c) {
  return D % 128 == 0 || c < D;
}

// One warp: out1 (and out2, if set) = LN(y) of row `row` of y, rounded to T.
template <int D, typename T>
__device__ __forceinline__ void ln_row(const float* y, int row, const T* s, const T* b,
                                       float* out1, float* out2) {
  constexpr int PER = LN_PER<D>;  // float4 per lane
  const int lane = threadIdx.x % 32;
  float4 v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane * 4 + 128 * i;
    v[i] = ln_col<D>(c) ? ld4(y + (size_t)row * D + c) : make_float4(0, 0, 0, 0);
  }
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    sum += v[i].x + v[i].y + v[i].z + v[i].w;
    sq += v[i].x * v[i].x + v[i].y * v[i].y + v[i].z * v[i].z + v[i].w * v[i].w;
  }
  float mean, inv;
  ln_stats<D>(sum, sq, mean, inv);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane * 4 + 128 * i;
    if (!ln_col<D>(c)) continue;
    const float4 o = rnd4<T>(ln_apply(v[i], mean, inv, ldw4<T>(s + c), ldw4<T>(b + c)));
    sts4(out1 + c, o);  // shared or global: a generic store
    if (out2) *reinterpret_cast<float4*>(out2 + c) = o;
  }
}

// One warp: LN(x + (p.part[0] + ... + p.part[n - 1] + bias)) of row `row`,
// n = SPLITS (or p.nsplit2 where SPLITS is 0), the parts added in order,
// rounded to T, into out1 (and out2, if set) as f32, or into out_t as T;
// with SPLITS fixed every load of the row is issued before the first sum.
// In bf16 the sum of the parts is the product, rounded before its bias is
// added, and the residual sum is rounded too.
template <int D, int SPLITS, typename T>
__device__ __forceinline__ void ln_row_parts(const Params& p, const float* x, int row,
                                             const T* bias, const T* s, const T* b,
                                             float* out1, float* out2, T* out_t) {
  constexpr int PER = LN_PER<D>;
  const int lane = threadIdx.x % 32;
  const size_t M = (size_t)p.B * p.R;
  const int splits = SPLITS ? SPLITS : p.nsplit2;
  float4 y[PER], xv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane * 4 + 128 * i;
    const bool in = ln_col<D>(c);
    xv[i] = in ? ld4(x + (size_t)row * D + c) : make_float4(0, 0, 0, 0);
    y[i] = in ? ld4(p.part + (size_t)row * D + c) : make_float4(0, 0, 0, 0);
  }
#pragma unroll
  for (int k = 1; k < splits; ++k) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane * 4 + 128 * i;
      if (!ln_col<D>(c)) continue;
      const float4 v = ld4(p.part + ((size_t)k * M + row) * D + c);
      y[i].x += v.x; y[i].y += v.y; y[i].z += v.z; y[i].w += v.w;
    }
  }
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (!ln_col<D>(lane * 4 + 128 * i)) continue;
    const float4 bv = ldw4<T>(bias + lane * 4 + 128 * i);
    y[i].x = rnd<T>(xv[i].x + rnd<T>(rnd<T>(y[i].x) + bv.x));
    y[i].y = rnd<T>(xv[i].y + rnd<T>(rnd<T>(y[i].y) + bv.y));
    y[i].z = rnd<T>(xv[i].z + rnd<T>(rnd<T>(y[i].z) + bv.z));
    y[i].w = rnd<T>(xv[i].w + rnd<T>(rnd<T>(y[i].w) + bv.w));
    sum += y[i].x + y[i].y + y[i].z + y[i].w;
    sq += y[i].x * y[i].x + y[i].y * y[i].y + y[i].z * y[i].z + y[i].w * y[i].w;
  }
  float mean, inv;
  ln_stats<D>(sum, sq, mean, inv);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane * 4 + 128 * i;
    if (!ln_col<D>(c)) continue;
    const float4 o = rnd4<T>(ln_apply(y[i], mean, inv, ldw4<T>(s + c), ldw4<T>(b + c)));
    if (out_t) {
      stt4<T>(out_t + c, o);
      continue;
    }
    sts4(out1 + c, o);  // shared or global: a generic store
    if (out2) *reinterpret_cast<float4*>(out2 + c) = o;
  }
}

// ln_row_parts with the parts' count fixed where it is the flagship's (F =
// 4D; always in the flagship's schedule, GEN false)
template <int D, typename T, bool GEN>
__device__ __forceinline__ void ln_parts(const Params& p, const float* x, int row,
                                         const T* bias, const T* s, const T* b,
                                         float* out1, float* out2, T* out_t) {
  if (!GEN || p.nsplit2 == 4)
    ln_row_parts<D, 4, T>(p, x, row, bias, s, b, out1, out2, out_t);
  else
    ln_row_parts<D, 0, T>(p, x, row, bias, s, b, out1, out2, out_t);
}

constexpr int WS = BN + 8;           // W row stride: conflict-free fragments
constexpr int RED_BYTES = (NWARPS / 2) * BM * RS * 4;  // the warps' partial tiles (f32)

// bytes of the W region: nb chunks of kc rows of BN columns of T, and after
// the products the warps' partial tiles
template <typename T>
constexpr int w_region_bytes(int kc, int nb) {
  return nb * kc * WS * (int)sizeof(T) > RED_BYTES ? nb * kc * WS * (int)sizeof(T) : RED_BYTES;
}

// rows of a W chunk: D (the whole slab at once) where it fits beside the A
// rows (a_bytes) and the combine's least table (coef), else the most rows,
// a multiple of 64, of which two chunks fit
template <int D, typename T>
constexpr int gemm_chunk_rows(int a_bytes, int coef) {
  if (a_bytes + w_region_bytes<T>(D, 1) + coef <= SMEM_MAX) return D;
  int kc = 64;
  while (kc + 64 < D && a_bytes + w_region_bytes<T>(kc + 64, 2) + coef <= SMEM_MAX) kc += 64;
  return kc;
}

// A GEMM tile's shared memory at widths (D, DH) and element type T: the A
// rows (BM x AS floats), the W region (NB chunks of KC rows in flight;
// after the products, the warps' partial tiles), then the combine's table
// (at least COEF_MIN bytes: p.cg + 2 floats a (row, head)).
template <int D, int DH, typename T>
struct GemmShape {
  static constexpr int AS = D + 4;  // A row stride (floats)
  static constexpr int KSTEP = IS_BF16<T> ? 16 : 8;  // k of one tensor-core product
  static constexpr int A_BYTES = BM * AS * 4;
  static constexpr int COEF_MIN = BM * (D / DH) * 3 * 4;
  static constexpr int KC = gemm_chunk_rows<D, T>(A_BYTES, COEF_MIN);
  static constexpr int NB = KC == D ? 1 : 2;
  static constexpr int W_BYTES = w_region_bytes<T>(KC, NB);
  static constexpr int BASE_BYTES = A_BYTES + W_BYTES;  // the combine's table follows
  static_assert(A_BYTES + w_region_bytes<T>(64, 2) + COEF_MIN <= SMEM_MAX,
                "D too wide for a GEMM tile");
  static_assert(KC % 16 == 0, "whole k steps in a chunk");
};

// The combine of more chunks than fit one group (p.cg < p.NC): each (row,
// head)'s max and denominator first, then in groups of p.cg chunks their
// weights and the weighted sums with the group's loads in flight, carried
// in the A rows from group to group; the same sums in the same order as one
// group.
template <int D, int DH, typename T>
__device__ __noinline__ void combine_groups(const GemmJob& j, const Params& p, int m0, float* As,
                                            float* coef) {
  constexpr int H = D / DH, N4 = D / 4, AS = GemmShape<D, DH, T>::AS;
  const int t = threadIdx.x;
  const int NC = p.NC, R = p.R, CS = p.cg + 2;  // a (row, head): max, denominator, weights
  for (int idx = t; idx < BM * H; idx += THREADS) {
    const int r = idx / H, h = idx % H, m = m0 + r;
    if (m >= j.M) continue;
    const int b = m / R, rr = m % R;
    const float2* ml =
        reinterpret_cast<const float2*>(p.ca_ml) + (size_t)(b * H + h) * NC * R + rr;
    const float bias_logit = p.has_bias ? __ldcg(p.ca_bl + (b * H + h) * R + rr) : -INFINITY;
    float mx = bias_logit, denom = 0.f;
    for (int c = 0; c < NC; ++c) mx = fmaxf(mx, __ldcg(ml + c * R).x);
    for (int c = 0; c < NC; ++c) {
      const float2 st = __ldcg(ml + c * R);
      const float w = expf(st.x - mx);
      denom += w * st.y;
    }
    denom += p.has_bias ? expf(bias_logit - mx) : 0.f;
    coef[idx * CS] = mx;
    coef[idx * CS + 1] = denom;
  }
  constexpr int N_ELEM = BM * N4;
  constexpr int PAIR = (N_ELEM + 2 * THREADS - 1) / (2 * THREADS);  // two float4 a thread
  for (int c0 = 0; c0 < NC; c0 += p.cg) {
    const int cg = NC - c0 < p.cg ? NC - c0 : p.cg;
    const bool last = c0 + cg == NC;
    __syncthreads();  // the table's max and denominator, or the last group's weights, read
    for (int idx = t; idx < BM * H; idx += THREADS) {  // this group's weights
      const int r = idx / H, h = idx % H, m = m0 + r;
      if (m >= j.M) continue;
      const float2* ml = reinterpret_cast<const float2*>(p.ca_ml) +
                         (size_t)((m / R) * H + h) * NC * R + m % R;
      float* cf = coef + idx * CS;
      for (int c = 0; c < cg; ++c) cf[2 + c] = expf(__ldcg(ml + (c0 + c) * R).x - cf[0]) / cf[1];
    }
    __syncthreads();
#pragma unroll 1
    for (int pass = 0; pass < PAIR; ++pass) {
      float4 o[2][MAX_CG];  // every chunk's load of the group, of both, in flight
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int idx = t + (2 * pass + u) * THREADS;
        const int r = idx / N4, c = (idx % N4) * 4, m = m0 + r, h = c / DH;
        if (idx >= N_ELEM || m >= j.M) continue;
        const float* src =
            p.ca_o + ((size_t)((m / R) * H + h) * NC * R + m % R) * DH + c % DH;
#pragma unroll
        for (int cc = 0; cc < MAX_CG; ++cc)
          if (cc < cg) o[u][cc] = ld4(src + (size_t)(c0 + cc) * R * DH);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int idx = t + (2 * pass + u) * THREADS;
        if (idx >= N_ELEM) continue;
        const int r = idx / N4, c = (idx % N4) * 4, m = m0 + r, h = c / DH;
        float4 v = make_float4(0, 0, 0, 0);
        if (m < j.M) {
          const float* cf = coef + (r * H + h) * CS;
          if (c0) v = lds4(As + r * AS + c);  // the earlier groups' sum
#pragma unroll
          for (int cc = 0; cc < MAX_CG; ++cc) {
            if (cc < cg) {
              v.x = fmaf(cf[2 + cc], o[u][cc].x, v.x);
              v.y = fmaf(cf[2 + cc], o[u][cc].y, v.y);
              v.z = fmaf(cf[2 + cc], o[u][cc].z, v.z);
              v.w = fmaf(cf[2 + cc], o[u][cc].w, v.w);
            }
          }
          if (last) {  // as the one-group combine of gemm_a
            v = rnd4<T>(v);
            if (p.has_bias) {
              const float4 vb = ldw4<T>(wt<T>(p.w[CA_BV]) + (size_t)j.li * D + c);
              const int b = m / R, rr = m % R;
              const float wb = expf(__ldcg(p.ca_bl + (b * H + h) * R + rr) - cf[0]) / cf[1];
              v.x = fmaf(wb, vb.x, v.x);
              v.y = fmaf(wb, vb.y, v.y);
              v.z = fmaf(wb, vb.z, v.z);
              v.w = fmaf(wb, vb.w, v.w);
            }
            v = rnd4<T>(v);
          }
        }
        sts4(As + r * AS + c, v);
      }
    }
  }
}

// A GEMM tile's A operand into shared memory: one warp a row for the
// LayerNorms; the combine in a first pass (each (row, head)'s max and
// denominator), then in groups of p.cg chunks the chunk weights of every
// (row, head) and the weighted sums with every chunk's load of the group
// in flight, carried in the A rows from group to group.
template <int D, int DH, typename T, bool GEN>
__device__ void gemm_a(const GemmJob& j, const Params& p, int m0, int tn, int kb, int kl,
                       float* As, float* coef) {
  constexpr int H = D / DH, N4 = D / 4, AS = GemmShape<D, DH, T>::AS;
  const int t = threadIdx.x, lane = t % 32;
  if (j.amode == A_PLAIN && IS_BF16<T> && j.a_t) {  // x_in (T), widened as it is read
    for (int idx = t; idx < BM * N4; idx += THREADS) {
      const int r = idx / N4, c = (idx % N4) * 4, m = m0 + r;
      const float4 v = m < j.M ? ldc4<T>(wt<T>(j.A) + (size_t)a_row(j, p, m) * j.lda + kb + c)
                               : make_float4(0, 0, 0, 0);
      sts4(As + r * AS + c, v);
    }
  } else if (j.amode == A_PLAIN) {  // columns [kb, kb + kl) of A; the rest zero
    const float* A = static_cast<const float*>(j.A);
    for (int idx = t; idx < BM * N4; idx += THREADS) {
      const int r = idx / N4, c = (idx % N4) * 4, m = m0 + r;
      const bool in = m < j.M && (!GEN || c < kl);
      const int src = in ? a_row(j, p, m) : 0;
      cp_async16(As + r * AS + c, A + (size_t)src * j.lda + (in ? kb + c : 0), in ? 16 : 0);
    }
  } else if (j.amode == A_LN || j.amode == A_LN4) {
    const bool write_x = tn == 0 && j.x_next;
    for (int r = t / 32; r < BM; r += NWARPS) {
      const int m = m0 + r;
      if (m >= j.M) {  // rows past M are zero
        for (int c = lane * 4; c < D; c += 128) sts4(As + r * AS + c, make_float4(0, 0, 0, 0));
        continue;
      }
      const int row = a_row(j, p, m);
      float* x_out = write_x ? j.x_next + (size_t)row * D : nullptr;
      if (j.amode == A_LN)
        ln_row<D, T>(p.ybuf, row, wt<T>(j.ln_s), wt<T>(j.ln_b), As + r * AS, x_out);
      else
        ln_parts<D, T, GEN>(p, static_cast<const float*>(j.A), row, wt<T>(j.ln_bias),
                       wt<T>(j.ln_s), wt<T>(j.ln_b), As + r * AS, x_out, nullptr);
    }
  } else if (!GEN || p.cg >= p.NC) {  // every chunk in one group: their loads in flight together
    // a (row, head): the chunks' weights, the bias's
    const int NC = p.NC, R = p.R, CS = GEN ? NC + 1 : MAX_CG + 1;
    for (int idx = t; idx < BM * H; idx += THREADS) {
      const int r = idx / H, h = idx % H, m = m0 + r;
      if (m >= j.M) continue;
      const int b = m / R, rr = m % R;
      const float2* ml =
          reinterpret_cast<const float2*>(p.ca_ml) + (size_t)(b * H + h) * NC * R + rr;
      float2 st[MAX_CG];
#pragma unroll
      for (int c = 0; c < MAX_CG; ++c)
        st[c] = c < NC ? __ldcg(ml + c * R) : make_float2(-INFINITY, 0.f);
      const float bias_logit = p.has_bias ? __ldcg(p.ca_bl + (b * H + h) * R + rr) : -INFINITY;
      float mx = bias_logit;
#pragma unroll
      for (int c = 0; c < MAX_CG; ++c) mx = fmaxf(mx, st[c].x);
      float w[MAX_CG];
      float denom = 0.f;
#pragma unroll
      for (int c = 0; c < MAX_CG; ++c) {
        w[c] = c < NC ? expf(st[c].x - mx) : 0.f;
        if (c < NC) denom += w[c] * st[c].y;
      }
      const float e_bias = p.has_bias ? expf(bias_logit - mx) : 0.f;
      denom += e_bias;
      float* cf = coef + idx * CS;
#pragma unroll
      for (int c = 0; c < MAX_CG; ++c)
        if (c < NC) cf[c] = w[c] / denom;
      cf[NC] = e_bias / denom;
    }
    __syncthreads();
    constexpr int N_ELEM = BM * N4;
    constexpr int PAIR = (N_ELEM + 2 * THREADS - 1) / (2 * THREADS);  // two float4 a thread
#pragma unroll 1
    for (int pass = 0; pass < PAIR; ++pass) {
      float4 o[2][MAX_CG];  // every chunk's load of both in flight
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int idx = t + (2 * pass + u) * THREADS;
        const int r = idx / N4, c = (idx % N4) * 4, m = m0 + r, h = c / DH;
        if (idx >= N_ELEM || m >= j.M) continue;
        const float* src =
            p.ca_o + ((size_t)((m / R) * H + h) * NC * R + m % R) * DH + c % DH;
#pragma unroll
        for (int cc = 0; cc < MAX_CG; ++cc)
          if (cc < NC) o[u][cc] = ld4(src + (size_t)cc * R * DH);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int idx = t + (2 * pass + u) * THREADS;
        if (idx >= N_ELEM) continue;
        const int r = idx / N4, c = (idx % N4) * 4, m = m0 + r, h = c / DH;
        float4 v = make_float4(0, 0, 0, 0);
        if (m < j.M) {
          const float* cf = coef + (r * H + h) * CS;
#pragma unroll
          for (int cc = 0; cc < MAX_CG; ++cc) {
            if (cc < NC) {
              v.x = fmaf(cf[cc], o[u][cc].x, v.x);
              v.y = fmaf(cf[cc], o[u][cc].y, v.y);
              v.z = fmaf(cf[cc], o[u][cc].z, v.z);
              v.w = fmaf(cf[cc], o[u][cc].w, v.w);
            }
          }
          // bf16: the weighted sum is rounded before the bias column's f32
          // term is added, and the sum rounded again (the TPU kernel's out_h)
          v = rnd4<T>(v);
          if (p.has_bias) {
            const float4 vb = ldw4<T>(wt<T>(p.w[CA_BV]) + (size_t)j.li * D + c);
            const float wb = cf[NC];
            v.x = fmaf(wb, vb.x, v.x);
            v.y = fmaf(wb, vb.y, v.y);
            v.z = fmaf(wb, vb.z, v.z);
            v.w = fmaf(wb, vb.w, v.w);
          }
          v = rnd4<T>(v);
        }
        sts4(As + r * AS + c, v);
      }
    }
  } else if constexpr (GEN) {
    combine_groups<D, DH, T>(j, p, m0, As, coef);
  }
}

// Warp (nh = warp % 2, ksl)'s products over k steps [s0, s0 + n) of a W
// chunk Wc whose row 0 is A's column k0, summed into acc in step order; n
// is N where N > 0 (a loop the compiler sees whole).
template <int D, int DH, typename T, int N>
__device__ __forceinline__ void gemm_mma(const float* As, const T* Wc, int k0, int s0, int n,
                                         float (&acc)[2][4][4]) {
  using S = GemmShape<D, DH, T>;
  constexpr int AS = S::AS, KSTEP = S::KSTEP;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane >> 2, tig = lane & 3;
  const int nh = warp & 1;
  const int count = N ? N : n;
  if constexpr (IS_BF16<T>) {
    const unsigned short* Wb = reinterpret_cast<const unsigned short*>(Wc) + 32 * nh;
#pragma unroll 2
    for (int i = 0; i < count; ++i) {
      const int k = (s0 + i) * KSTEP;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ar = As + (16 * mt + gid) * AS + k0 + k + 2 * tig;
        a[mt][0] = pack_bf16(ar[0], ar[1]);
        a[mt][1] = pack_bf16(ar[8 * AS], ar[8 * AS + 1]);
        a[mt][2] = pack_bf16(ar[8], ar[9]);
        a[mt][3] = pack_bf16(ar[8 * AS + 8], ar[8 * AS + 9]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const unsigned short* wc = Wb + (k + 2 * tig) * WS + nt * 8 + gid;
        const uint32_t b[2] = {pack_raw(wc[0], wc[WS]), pack_raw(wc[8 * WS], wc[9 * WS])};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b);
      }
    }
  } else {
    const float* Ww = reinterpret_cast<const float*>(Wc) + 32 * nh;
#pragma unroll 2
    for (int i = 0; i < count; ++i) {
      const int k = (s0 + i) * KSTEP;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* a = As + (16 * mt + gid) * AS + k0 + k + tig;
        split_tf32(a[0], ah[mt][0], al[mt][0]);
        split_tf32(a[8 * AS], ah[mt][1], al[mt][1]);
        split_tf32(a[4], ah[mt][2], al[mt][2]);
        split_tf32(a[8 * AS + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t bh[2], bl[2];
        split_tf32(Ww[(k + tig) * WS + nt * 8 + gid], bh[0], bl[0]);
        split_tf32(Ww[(k + tig + 4) * WS + nt * 8 + gid], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(acc[mt][nt], al[mt], bh);
          mma_tf32(acc[mt][nt], ah[mt], bl);
          mma_tf32(acc[mt][nt], ah[mt], bh);
        }
      }
    }
  }
}

// One BM x (nsub BN) output tile over K columns [ks D, ks D + kl) of A
// (kl = min(D, K - ks D)), by the whole block on the tensor cores, one BN
// column block at a time (a block past N is not computed; columns past N
// are masked): the weight rows are in flight by cp.async while the A rows
// are prepared (once for the nsub blocks), the whole kl x BN slab at once
// where it fits (KC = D: a block waits for memory once), else in chunks of
// KC rows, two in flight. Warp (nh, ksl) sums columns 32 nh .. + 32 of all
// BM rows over its share of each chunk's k steps (the steps split in eight
// contiguous shares, in order); the k slices are added in order through
// shared memory. f32: 3xTF32, each operand split into TF32 hi and lo as it
// is read. bf16: the slab is bf16 (half the bytes), A holds bf16 values in
// f32 and is packed into bf16 pairs as it is read, one bf16 product
// (m16n8k16, f32 accumulators); the epilogue rounds the product to bf16
// before its bias, and each later sum, as the TPU kernel's dense().
template <int D, int DH, typename T, bool GEN>
__device__ __noinline__ void gemm_tile(const GemmJob& j, const Params& p, int tm, int tg, int ks,
                                       float* smem, bool timed) {
  using S = GemmShape<D, DH, T>;
  constexpr int AS = S::AS, KC = S::KC, NB = S::NB, KSTEP = S::KSTEP;
  constexpr int WE = 16 / (int)sizeof(T);  // elements of a 16-byte copy
  float* As = smem;            // BM x AS
  float* Ws = As + BM * AS;    // NB x KC x WS of T, then the warps' partial tiles
  float* coef = Ws + S::W_BYTES / 4;  // the combine's table
  T* Wt = reinterpret_cast<T*>(Ws);
  const T* W = wt<T>(j.W);
  const int t = threadIdx.x, m0 = tm * BM, kb = ks * D;
  const int kl = GEN && j.K - kb < D ? j.K - kb : D;
  for (int sb = 0; sb < j.nsub; ++sb) {
    const int n0 = (tg * j.nsub + sb) * BN;
    if (GEN && n0 >= j.N) break;  // the same for every thread of the block
    const int warp = t / 32, lane = t % 32, gid = lane >> 2, tig = lane & 3;
    const int nh = warp & 1, ksl = warp >> 1;
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    if constexpr (NB == 1) {
      // the whole D x BN slab at once; rows past kl (the W2 product's last
      // part, where D does not divide F) and columns past N are zero, as are
      // A's columns past kl, so every warp takes its fixed share of D
      GEMM_MARK(0);
      for (int idx = t; idx < D * (BN / WE); idx += THREADS) {
        const int k = idx / (BN / WE), n = (idx % (BN / WE)) * WE;
        const bool in = !GEN || (k < kl && n0 + n < j.N);
        cp_async16(Wt + k * WS + n, W + (in ? (size_t)(kb + k) * j.N + n0 + n : 0), in ? 16 : 0);
      }
      cp_async_commit();
      if (sb == 0) gemm_a<D, DH, T, GEN>(j, p, m0, tg, kb, kl, As, coef);
      cp_async_commit();
      GEMM_MARK(1);
      cp_async_wait<0>();
      __syncthreads();
      GEMM_MARK(2);
      constexpr int STEPS = D / KSTEP, EVEN = STEPS % (NWARPS / 2) == 0;
      if constexpr (EVEN)
        gemm_mma<D, DH, T, STEPS / (NWARPS / 2)>(As, Wt, 0, ksl * (STEPS / (NWARPS / 2)), 0, acc);
      else
        gemm_mma<D, DH, T, 0>(As, Wt, 0, ksl * STEPS / (NWARPS / 2),
                              (ksl + 1) * STEPS / (NWARPS / 2) - ksl * STEPS / (NWARPS / 2), acc);
      __syncthreads();  // every warp is done with the W slab: its space takes the partial tiles
    } else {
      // chunk ch of the slab's kl rows into buffer ch % 2, two in flight
      const int nch = (kl + KC - 1) / KC;
      auto issue = [&](int ch) {
        const int k0 = ch * KC, rows = kl - k0 < KC ? kl - k0 : KC;
        T* dst = Wt + (ch % NB) * KC * WS;
        for (int idx = t; idx < rows * (BN / WE); idx += THREADS) {
          const int k = idx / (BN / WE), n = (idx % (BN / WE)) * WE;
          const bool in = n0 + n < j.N;
          cp_async16(dst + k * WS + n, W + (in ? (size_t)(kb + k0 + k) * j.N + n0 + n : 0),
                     in ? 16 : 0);
        }
        cp_async_commit();
      };
      GEMM_MARK(0);
      issue(0);
      if (sb == 0) gemm_a<D, DH, T, GEN>(j, p, m0, tg, kb, kl, As, coef);
      cp_async_commit();
      GEMM_MARK(1);
      for (int ch = 0; ch < nch; ++ch) {
        if (ch + 1 < nch) {
          issue(ch + 1);
          cp_async_wait<1>();  // every group but the newest has landed: this chunk's, and A
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (ch == 0) GEMM_MARK(2);
        const int k0 = ch * KC, rows = kl - k0 < KC ? kl - k0 : KC;
        const int steps = rows / KSTEP;
        const int s0 = ksl * steps / (NWARPS / 2), s1 = (ksl + 1) * steps / (NWARPS / 2);
        gemm_mma<D, DH, T, 0>(As, Wt + (ch % NB) * KC * WS, k0, s0, s1 - s0, acc);
        __syncthreads();  // every warp is done with this chunk's buffer
      }
    }
    GEMM_MARK(3);
    float* red = Ws;  // (NWARPS / 2) k slices x BM x RS
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float* r0 = red + (ksl * BM + 16 * mt + gid) * RS + 32 * nh + nt * 8 + 2 * tig;
        *reinterpret_cast<float2*>(r0) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(r0 + 8 * RS) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
    __syncthreads();
    const int r = t / (BN / 4), c = (t % (BN / 4)) * 4, m = m0 + r, n = n0 + c;
    if (m < j.M && (!GEN || n < j.N)) {
      float4 v = lds4(red + r * RS + c);
#pragma unroll
      for (int sl = 1; sl < NWARPS / 2; ++sl) {  // the k slices in order
        const float4 u = lds4(red + (sl * BM + r) * RS + c);
        v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
      }
      if (j.splits > 1) {
        *reinterpret_cast<float4*>(p.part + ((size_t)ks * j.M + m) * j.N + n) = v;
      } else {
        const float4 bv = ldw4<T>(wt<T>(j.bias) + n);
        v = rnd4<T>(v);
        v.x = rnd<T>(v.x + bv.x); v.y = rnd<T>(v.y + bv.y);
        v.z = rnd<T>(v.z + bv.z); v.w = rnd<T>(v.w + bv.w);
        if (j.gelu) {
          v.x = gelu_exact<T>(v.x); v.y = gelu_exact<T>(v.y);
          v.z = gelu_exact<T>(v.z); v.w = gelu_exact<T>(v.w);
        }
        if (j.resid) {
          const float4 x = IS_BF16<T> && j.resid_t
                               ? ldc4<T>(wt<T>(j.resid) + (size_t)m * j.N + n)
                               : ld4(static_cast<const float*>(j.resid) + (size_t)m * j.N + n);
          v.x = rnd<T>(x.x + v.x); v.y = rnd<T>(x.y + v.y);
          v.z = rnd<T>(x.z + v.z); v.w = rnd<T>(x.w + v.w);
        }
        const int row = j.o_cache ? (m / p.G) * p.C + p.step * p.G + m % p.G : m;
        if (j.o_cache)  // the caches are T
          stt4<T>(static_cast<T*>(j.out) + (size_t)row * j.N + n, v);
        else
          *reinterpret_cast<float4*>(static_cast<float*>(j.out) + (size_t)row * j.N + n) = v;
      }
    }
    __syncthreads();  // the next column block, or tile, reuses the shared buffers
    GEMM_MARK(4);
  }
}

__device__ __forceinline__ int gemm_tiles(const GemmJob& j) {
  return ((j.M + BM - 1) / BM) * ((j.N + BN * j.nsub - 1) / (BN * j.nsub)) * j.splits;
}

// The tiles of every job, one block each, spread over the blocks.
template <int D, int DH, typename T, bool GEN>
__device__ void gemm_stage(const GemmJob* jobs, int njobs, const Params& p, float* smem) {
  int total = 0;
  for (int i = 0; i < njobs; ++i) total += gemm_tiles(jobs[i]);
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    int local = item, ji = 0;
    while (local >= gemm_tiles(jobs[ji])) local -= gemm_tiles(jobs[ji++]);
    const GemmJob& j = jobs[ji];
    const int ks = local % j.splits, tile = local / j.splits;
    const int tn_groups = (j.N + BN * j.nsub - 1) / (BN * j.nsub);
    gemm_tile<D, DH, T, GEN>(j, p, tile / tn_groups, tile % tn_groups, ks, smem,
                        j.tag && blockIdx.x == 0 && item == (int)blockIdx.x);
  }
}

// A W over the whole width of A's rows (K = lda)
__device__ GemmJob plain_job(const void* A, int lda, const void* W, const void* bias, void* out,
                             int M, int N) {
  GemmJob j = {};
  j.A = A; j.lda = lda; j.W = W; j.bias = bias; j.out = out;
  j.M = M; j.N = N; j.K = lda; j.splits = 1; j.nsub = 1; j.amode = A_PLAIN;
  return j;
}

template <int D>
__device__ GemmJob ln_job(int amode, const void* s, const void* b, float* x_next,
                          const void* W, const void* bias, void* out, int M, int N) {
  GemmJob j = {};
  j.ln_s = s; j.ln_b = b; j.x_next = x_next;
  j.W = W; j.bias = bias; j.out = out; j.M = M; j.N = N; j.K = D; j.splits = 1; j.nsub = 1;
  j.amode = amode;
  return j;
}

// Self-attention of one video, one head and a group of p.sa_eg events a
// unit: the unit's q rows (its events' commit and predict rows) and the
// cache rows of positions < valid_len of its events land in shared memory,
// p.sa_pt positions a tile (the flagship: every event and every position at
// once, keys and values together); row r attends its own event's keys
// only, its own commit among them. Every logit of the unit's rows stays in
// shared memory, so the softmax is exact over all positions; with more
// than one tile the keys come tile by tile, then the values, and each
// weighted sum is carried in shared memory from tile to tile in the order
// of the positions. In bf16 the cache rows are widened as they are read,
// the logits rounded to bf16 before the f32 softmax, the weights rounded to
// bf16 and the weighted sum rounded (the TPU kernel's mxu_dot rounds).
// In the flagship's schedule (GEN false) one unit takes every event and
// one tile every position, so those loops are gone at compile time.
template <int D, int DH, typename T, bool GEN>
__device__ __noinline__ void self_attention_stage(const Params& p, int li, float* smem) {
  constexpr int H = D / DH, QS = DH + 4, D4 = DH / 4;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int G = p.G, Tc = p.C / G, vl = p.valid_len;
  const int EG = GEN ? p.sa_eg : G, PT = GEN ? p.sa_pt : Tc;
  const int groups = GEN ? (G + EG - 1) / EG : 1, tiles = GEN ? (vl + PT - 1) / PT : 1;
  float* q = smem;                // 2 EG x QS
  float* ks = q + 2 * EG * QS;    // PT EG x QS
  float* vs = ks + PT * EG * QS;  // PT EG x QS
  float* lg = vs + PT * EG * QS;  // 2 EG x Tc: logits, then weights
  float* acc = lg + 2 * EG * Tc;  // 2 EG x DH: the weighted sums between tiles
  const T* kcache = static_cast<const T*>(p.kc);
  const T* vcache = static_cast<const T*>(p.vc);
  for (int unit = blockIdx.x; unit < p.B * H * groups; unit += gridDim.x) {
    const int b = unit / (H * groups), h = (unit / groups) % H;
    const int e0 = GEN ? (unit % groups) * EG : 0;
    const int ne = GEN && G - e0 < EG ? G - e0 : EG, rows = 2 * ne;
    // local row lr: event e0 + lr % ne, the commit row below ne, the predict row from ne
    auto grow = [&](int lr) { return (lr < ne ? 0 : G) + e0 + lr % ne; };
    const size_t cache = (size_t)(li * p.B + b) * p.C * D + h * DH;
    // positions [p0, p0 + np) of the unit's events, into kbuf (and vbuf)
    auto load = [&](int p0, int np, float* kbuf, float* vbuf) {
      for (int idx = t; idx < np * ne * D4; idx += THREADS) {
        const int r = idx / D4, d = (idx % D4) * 4;
        const size_t src = cache + (size_t)((p0 + r / ne) * G + e0 + r % ne) * D + d;
        if constexpr (IS_BF16<T>) {
          if (kbuf) sts4(kbuf + r * QS + d, ldc4<T>(kcache + src));
          if (vbuf) sts4(vbuf + r * QS + d, ldc4<T>(vcache + src));
        } else {
          if (kbuf) cp_async16(kbuf + r * QS + d, kcache + src, 16);
          if (vbuf) cp_async16(vbuf + r * QS + d, vcache + src, 16);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    };
    for (int idx = t; idx < rows * D4; idx += THREADS) {
      const int r = idx / D4, d = (idx % D4) * 4;
      cp_async16(q + r * QS + d, p.q_buf + (size_t)(b * p.R + grow(r)) * D + h * DH + d, 16);
    }
    for (int tile = 0; tile < tiles; ++tile) {
      const int p0 = tile * PT, np = vl - p0 < PT ? vl - p0 : PT;
      load(p0, np, ks, tiles == 1 ? vs : nullptr);
      for (int idx = t; idx < rows * np; idx += THREADS) {
        const int r = idx / np, pos = idx % np;
        const float* qr = q + r * QS;
        const float* kr = ks + (pos * ne + r % ne) * QS;
        float a = 0.f;
#pragma unroll
        for (int d = 0; d < DH; d += 4) {
          const float4 x = lds4(qr + d), k = lds4(kr + d);
          a = fmaf(x.x, k.x, a);
          a = fmaf(x.y, k.y, a);
          a = fmaf(x.z, k.z, a);
          a = fmaf(x.w, k.w, a);
        }
        lg[r * Tc + p0 + pos] = rnd<T>(a) * p.scale;
      }
      __syncthreads();
    }
    for (int r = warp; r < rows; r += NWARPS) {
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
      for (int pos = lane; pos < vl; pos += 32) lr[pos] = rnd<T>(lr[pos] / sum);
    }
    __syncthreads();
    for (int tile = 0; tile < tiles; ++tile) {
      const int p0 = tile * PT, np = vl - p0 < PT ? vl - p0 : PT;
      if (tiles > 1) load(p0, np, nullptr, vs);
      for (int idx = t; idx < rows * DH; idx += THREADS) {
        const int r = idx / DH, d = idx % DH;
        const float* lr = lg + r * Tc + p0;
        float out = tile ? acc[r * DH + d] : 0.f;
        for (int pos = 0; pos < np; ++pos)
          out = fmaf(lr[pos], vs[(pos * ne + r % ne) * QS + d], out);
        if (tile + 1 < tiles)
          acc[r * DH + d] = out;
        else
          p.attn_buf[(size_t)(b * p.R + grow(r)) * D + h * DH + d] = rnd<T>(out);
      }
      __syncthreads();  // the next tile, or unit, reuses the shared buffers
    }
  }
}

// Cross-attention, one unit per (video, head, chunk of CHUNK memory
// columns): the chunk's logits, its max m_c, the sum l_c of exp(logit -
// m_c) and the weighted sum of V by those exponentials (times the v-scale
// for int8), for the R rows in row tiles of RT. Everything a unit reads
// (its K and V chunks, mask columns, scales and, where the plan keeps them
// there, its q rows) lands by cp.async in a buffer: with two buffers the
// next unit's while this one is summed, with one at the unit's start.
// The K and V rows sit at fixed offsets of a buffer; the q rows, the mask
// and the scales follow at the plan's offsets (p.ca_mask_off, ...).
template <int DH, bool INT8>
struct CrossBuffer {
  static constexpr int QS = DH + 4;
  // bytes of one K row and of one V row (f32 strides Dh + 4 and Dh + 8
  // floats: conflict-free fragment loads)
  static constexpr int KROW = INT8 ? DH + 16 : QS * 4;
  static constexpr int VROW = INT8 ? DH + 16 : (DH + 8) * 4;
  static constexpr int V_OFF = CHUNK * KROW;
  static constexpr int Q_OFF = V_OFF + CHUNK * VROW;  // R x QS floats, if in the buffer
  // before the buffers: the logits and the weights' lo parts (RT x PS), q
  // split into TF32 hi and lo (RT x QS)
  static constexpr int FIXED = (2 * RT * PS + 2 * RT * QS) * 4;
};

template <int D, int DH, bool INT8, bool GEN>
__device__ __noinline__ void cross_attention_stage(const Params& p, int li, float* smem) {
  using Buf = CrossBuffer<DH, INT8>;
  static_assert(CHUNK == 8 * NWARPS && RT == 32, "a warp's share of the logits");
  constexpr int H = D / DH, QS = Buf::QS, D4 = DH / 4, KROW = Buf::KROW, VROW = Buf::VROW;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  // the flagship's schedule (GEN false): one row tile, two buffers of fixed
  // layout (RT rows of q and mask), the row-tile loop and the branches gone
  const int R = p.R, NC = p.NC, Sp = p.Sp, NBUF = GEN ? p.ca_nbuf : 2;
  const bool q_ring = GEN ? p.ca_q_ring != 0 : true;
  const int mask_off = GEN ? p.ca_mask_off : Buf::Q_OFF + RT * Buf::QS * 4;
  const int scale_off = GEN ? p.ca_scale_off : mask_off + RT * CHUNK;
  const int BYTES = GEN ? p.ca_bytes : scale_off + (INT8 ? 2 * CHUNK * 4 : 0);
  // the logits, then the TF32 hi parts of the weights (in place); the lo
  // parts; q split into TF32 hi and lo; then the buffers
  float* P = smem;                                    // RT x PS
  uint32_t* Plo = reinterpret_cast<uint32_t*>(P + RT * PS);
  uint32_t* Qhi = Plo + RT * PS;                      // RT x QS
  uint32_t* Qlo = Qhi + RT * QS;
  char* ring = reinterpret_cast<char*>(Qlo + RT * QS);
  const int units = p.B * H * NC;

  auto issue = [&](int unit, int buf) {
    const int b = unit / (H * NC), h = (unit / NC) % H, c = unit % NC;
    const size_t base = ((size_t)(li * p.B + b) * Sp + (size_t)c * CHUNK) * D + h * DH;
    char* dst = ring + buf * BYTES;
    if (INT8) {
      constexpr int N16 = DH / 16;
      for (int idx = t; idx < CHUNK * N16; idx += THREADS) {
        const int row = idx / N16, d = (idx % N16) * 16;
        const size_t off = base + (size_t)row * D + d;
        cp_async16(dst + row * KROW + d, static_cast<const int8_t*>(p.mem_k) + off, 16);
        cp_async16(dst + Buf::V_OFF + row * VROW + d, static_cast<const int8_t*>(p.mem_v) + off,
                   16);
      }
      const size_t sc = (size_t)(li * p.B + b) * Sp + c * CHUNK;
      for (int idx = t; idx < 2 * CHUNK / 4; idx += THREADS) {
        const float* src =
            (idx < CHUNK / 4 ? p.k_scales : p.v_scales) + sc + (idx % (CHUNK / 4)) * 4;
        cp_async16(dst + scale_off + idx * 16, src, 16);
      }
    } else {
      for (int idx = t; idx < CHUNK * D4; idx += THREADS) {
        const int row = idx / D4, d = (idx % D4) * 4;
        const size_t off = base + (size_t)row * D + d;
        cp_async16(dst + row * KROW + d * 4, static_cast<const float*>(p.mem_k) + off, 16);
        cp_async16(dst + Buf::V_OFF + row * VROW + d * 4,
                   static_cast<const float*>(p.mem_v) + off, 16);
      }
    }
    if (q_ring) {
      for (int idx = t; idx < R * D4; idx += THREADS) {
        const int r = idx / D4, d = (idx % D4) * 4;
        cp_async16(dst + Buf::Q_OFF + (r * QS + d) * 4,
                   p.q_buf + (size_t)(b * R + r) * D + h * DH + d, 16);
      }
    }
    for (int idx = t; idx < R * (CHUNK / 16); idx += THREADS) {
      const int r = idx / (CHUNK / 16), s = (idx % (CHUNK / 16)) * 16;
      cp_async16(dst + mask_off + r * CHUNK + s,
                 p.mask + (size_t)(b * R + r) * Sp + c * CHUNK + s, 16);
    }
  };

  int unit = blockIdx.x;
  if (NBUF == 2 && unit < units) issue(unit, 0);
  cp_async_commit();
  for (int it = 0; unit < units; ++it, unit += gridDim.x) {
    SUB_MARK(0);
    if (NBUF == 1)
      issue(unit, 0);
    else if (unit + (int)gridDim.x < units)
      issue(unit + gridDim.x, (it + 1) & 1);
    cp_async_commit();
    const int b = unit / (H * NC), h = (unit / NC) % H;
    const char* buf = ring + (NBUF == 2 ? it & 1 : 0) * BYTES;
    const char* kbuf = buf;
    const char* vbuf = buf + Buf::V_OFF;
    const int8_t* blocked = reinterpret_cast<const int8_t*>(buf + mask_off);
    const float* ksc = reinterpret_cast<const float*>(buf + scale_off);
    const float* vsc = ksc + CHUNK;
    // q[r][d] of this unit's head: from the buffer, or from L2
    const float* qg = p.q_buf + (size_t)(b * R) * D + h * DH;
    const float* qr = reinterpret_cast<const float*>(buf + Buf::Q_OFF);
    auto qv = [&](int r, int d) { return q_ring ? qr[r * QS + d] : __ldcg(qg + (size_t)r * D + d); };
    if (NBUF == 2)
      cp_async_wait<1>();  // every group but the newest has landed: this unit's
    else
      cp_async_wait<0>();
    __syncthreads();
    for (int r0 = 0; r0 < (GEN ? R : 1); r0 += RT) {
      for (int idx = t; idx < RT * DH; idx += THREADS) {  // q split once for every warp
        const int r = idx / DH, d = idx % DH;
        split_tf32(!GEN || r0 + r < R ? qv(r0 + r, d) : 0.f, Qhi[r * QS + d], Qlo[r * QS + d]);
      }
      __syncthreads();
      SUB_MARK(1);

      // logits on the tensor cores in 3xTF32 (int8 K is exact in TF32: two
      // passes): warp w takes columns 8 w .. + 8 of both 16-row tiles
      {
        const int gid = lane >> 2, tig = lane & 3, s0 = 8 * warp;
        float acc[2][4] = {};
#pragma unroll 2
        for (int k = 0; k < DH; k += 8) {
          uint32_t ah[2][4], al[2][4], bh[2], bl[2] = {0u, 0u};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int o = (16 * mt + gid) * QS + k + tig;  // a0..a3: rows +8, k +4
            ah[mt][0] = Qhi[o]; ah[mt][1] = Qhi[o + 8 * QS];
            ah[mt][2] = Qhi[o + 4]; ah[mt][3] = Qhi[o + 8 * QS + 4];
            al[mt][0] = Qlo[o]; al[mt][1] = Qlo[o + 8 * QS];
            al[mt][2] = Qlo[o + 4]; al[mt][3] = Qlo[o + 8 * QS + 4];
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int d = k + tig + 4 * u;
            if (INT8) {
              bh[u] = __float_as_uint((float)reinterpret_cast<const int8_t*>(
                  kbuf)[(s0 + gid) * KROW + d]);
            } else {
              split_tf32(reinterpret_cast<const float*>(kbuf + (s0 + gid) * KROW)[d], bh[u],
                         bl[u]);
            }
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_tf32(acc[mt], al[mt], bh);
            if (!INT8) mma_tf32(acc[mt], ah[mt], bl);
            mma_tf32(acc[mt], ah[mt], bh);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // c0, c1: row gid; c2, c3: row gid + 8
            const int r = 16 * mt + gid + 8 * (e >> 1), sc = s0 + 2 * tig + (e & 1);
            if (r0 + r < R) {
              float lg = acc[mt][e];
              if (INT8) lg *= ksc[sc];
              P[r * PS + sc] = (blocked[(r0 + r) * CHUNK + sc] ? NEG_MASK : lg) * p.scale;
            }
          }
        }
      }
      __syncthreads();
      SUB_MARK(2);

      // the chunk's max and sum of exponentials, one warp a row
      for (int r = warp; r < RT && r0 + r < R; r += NWARPS) {
        float* Pr = P + r * PS;
        float v[CHUNK / 32];
        float m = -INFINITY;
#pragma unroll
        for (int i = 0; i < CHUNK / 32; ++i) {
          v[i] = Pr[lane + 32 * i];
          m = fmaxf(m, v[i]);
        }
        m = warp_max(m);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < CHUNK / 32; ++i) {  // the weights, split for the weighted sum
          const float e = expf(v[i] - m);
          sum += e;
          uint32_t hi, lo;
          split_tf32(INT8 ? e * vsc[lane + 32 * i] : e, hi, lo);
          reinterpret_cast<uint32_t*>(Pr)[lane + 32 * i] = hi;
          Plo[r * PS + lane + 32 * i] = lo;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          float* ml = p.ca_ml + ((size_t)unit * R + r0 + r) * 2;
          ml[0] = m;
          ml[1] = sum;
        }
        if (p.has_bias && unit % NC == 0) {  // the bias column's logit, once a row
          const float* kb = wt<float>(p.w[CA_BK]) + (size_t)li * D + h * DH;
          float l = 0.f;
          for (int d = lane; d < DH; d += 32) l = fmaf(qv(r0 + r, d), __ldg(kb + d), l);
          l = warp_sum(l);
          if (lane == 0)
            p.ca_bl[(b * H + h) * R + r0 + r] = l * p.scale + __ldg(p.log_m + b * R + r0 + r);
        }
      }
      __syncthreads();
      SUB_MARK(3);

      // the weighted sum of V on the tensor cores in 3xTF32 (int8 V
      // exact): the (16-row, 8-channel) tiles over the warps, tile i = 2
      // (d0 / 8) + mt to warp i % NWARPS
      for (int pair = warp; pair < 2 * (DH / 8); pair += NWARPS) {
        const int gid = lane >> 2, tig = lane & 3, mt = pair & 1, d0 = 8 * (pair >> 1);
        float acc[4] = {};
#pragma unroll 4
        for (int k = 0; k < CHUNK; k += 8) {
          uint32_t ah[4], al[4], bh[2], bl[2] = {0u, 0u};
          const int o = (16 * mt + gid) * PS + k + tig;  // a0..a3: rows +8, k +4
          const uint32_t* Phi = reinterpret_cast<const uint32_t*>(P);
          ah[0] = Phi[o]; ah[1] = Phi[o + 8 * PS]; ah[2] = Phi[o + 4]; ah[3] = Phi[o + 8 * PS + 4];
          al[0] = Plo[o]; al[1] = Plo[o + 8 * PS]; al[2] = Plo[o + 4]; al[3] = Plo[o + 8 * PS + 4];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int sv = k + tig + 4 * u;
            if (INT8) {
              bh[u] = __float_as_uint(
                  (float)reinterpret_cast<const int8_t*>(vbuf)[sv * VROW + d0 + gid]);
            } else {
              split_tf32(reinterpret_cast<const float*>(vbuf + sv * VROW)[d0 + gid], bh[u],
                         bl[u]);
            }
          }
          mma_tf32(acc, al, bh);
          if (!INT8) mma_tf32(acc, ah, bl);
          mma_tf32(acc, ah, bh);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + 16 * mt + gid + 8 * (e >> 1), d = d0 + 2 * tig + (e & 1);
          if (r < R) p.ca_o[((size_t)unit * R + r) * DH + d] = acc[e];
        }
      }
      SUB_MARK(4);
      if (r0 + RT < R) __syncthreads();  // the next row tile rewrites P and the split q
    }

    __syncthreads();  // the next issue overwrites this unit's buffer
  }
  cp_async_wait<0>();
}


// The bf16 build's cross-attention: the same units, chunks, row tiles and
// combine as cross_attention_stage, with the chunk's K and V bf16 in shared
// memory (int8 widened to bf16 exactly as they are read), q packed into
// bf16 pairs, both products bf16 on the tensor cores (m16n8k16, f32
// accumulators), the logits rounded to bf16 before the f32 softmax (the TPU
// kernel's mxu_dot), and the chunk's weights exp(logit - m_c) (times the
// v-scale for int8) rounded to bf16 for the weighted sum. The TPU kernel
// rounds the weights after the softmax's division by the whole row's sum;
// a chunk knows its own sum only, so here the division comes after, in the
// combine, in f32.
constexpr int PSB = CHUNK + 8;  // row stride (bf16) of a unit's weights

template <int DH, bool INT8>
struct CrossBufferB {
  static constexpr int QS = DH + 4;
  static constexpr int QSB = DH / 2 + 4;  // row stride (bf16 pairs) of the packed q
  static constexpr int KROW = INT8 ? DH + 16 : (DH + 8) * 2;  // bytes of a K or V row
  static constexpr int V_OFF = CHUNK * KROW;
  static constexpr int Q_OFF = V_OFF + CHUNK * KROW;  // R x QS floats, if in the buffer
  // before the buffers: the logits (RT x PS f32), the weights (RT x PSB
  // bf16), q packed (RT x QSB)
  static constexpr int FIXED = RT * PS * 4 + RT * PSB * 2 + RT * QSB * 4;
};

template <int D, int DH, bool INT8, bool GEN>
__device__ __noinline__ void cross_attention_stage_bf16(const Params& p, int li, float* smem) {
  using Buf = CrossBufferB<DH, INT8>;
  static_assert(CHUNK == 8 * NWARPS && RT == 32, "a warp's share of the logits");
  constexpr int H = D / DH, QS = Buf::QS, QSB = Buf::QSB, KROW = Buf::KROW;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  // the flagship's schedule (GEN false): one row tile, two buffers of fixed
  // layout (RT rows of q and mask), the row-tile loop and the branches gone
  const int R = p.R, NC = p.NC, Sp = p.Sp, NBUF = GEN ? p.ca_nbuf : 2;
  const bool q_ring = GEN ? p.ca_q_ring != 0 : true;
  const int mask_off = GEN ? p.ca_mask_off : Buf::Q_OFF + RT * Buf::QS * 4;
  const int scale_off = GEN ? p.ca_scale_off : mask_off + RT * CHUNK;
  const int BYTES = GEN ? p.ca_bytes : scale_off + (INT8 ? 2 * CHUNK * 4 : 0);
  // the logits (f32); the weights (bf16); q packed in bf16 pairs; the buffers
  float* P = smem;                                                     // RT x PS
  unsigned short* Pb = reinterpret_cast<unsigned short*>(P + RT * PS);  // RT x PSB
  uint32_t* Qb = reinterpret_cast<uint32_t*>(Pb + RT * PSB);           // RT x QSB
  char* ring = reinterpret_cast<char*>(Qb + RT * QSB);
  const int units = p.B * H * NC;
  const __nv_bfloat16* kb_w = wt<__nv_bfloat16>(p.w[CA_BK]) + (size_t)li * D;

  auto issue = [&](int unit, int buf) {
    const int b = unit / (H * NC), h = (unit / NC) % H, c = unit % NC;
    const size_t base = ((size_t)(li * p.B + b) * Sp + (size_t)c * CHUNK) * D + h * DH;
    char* dst = ring + buf * BYTES;
    if (INT8) {
      constexpr int N16 = DH / 16;
      for (int idx = t; idx < CHUNK * N16; idx += THREADS) {
        const int row = idx / N16, d = (idx % N16) * 16;
        const size_t off = base + (size_t)row * D + d;
        cp_async16(dst + row * KROW + d, static_cast<const int8_t*>(p.mem_k) + off, 16);
        cp_async16(dst + Buf::V_OFF + row * KROW + d, static_cast<const int8_t*>(p.mem_v) + off,
                   16);
      }
      const size_t sc = (size_t)(li * p.B + b) * Sp + c * CHUNK;
      for (int idx = t; idx < 2 * CHUNK / 4; idx += THREADS) {
        const float* src =
            (idx < CHUNK / 4 ? p.k_scales : p.v_scales) + sc + (idx % (CHUNK / 4)) * 4;
        cp_async16(dst + scale_off + idx * 16, src, 16);
      }
    } else {
      constexpr int N8 = DH / 8;  // 16-byte pieces of a bf16 row
      for (int idx = t; idx < CHUNK * N8; idx += THREADS) {
        const int row = idx / N8, d = (idx % N8) * 8;
        const size_t off = base + (size_t)row * D + d;
        cp_async16(dst + row * KROW + d * 2, static_cast<const __nv_bfloat16*>(p.mem_k) + off,
                   16);
        cp_async16(dst + Buf::V_OFF + row * KROW + d * 2,
                   static_cast<const __nv_bfloat16*>(p.mem_v) + off, 16);
      }
    }
    if (q_ring) {
      for (int idx = t; idx < R * (DH / 4); idx += THREADS) {
        const int r = idx / (DH / 4), d = (idx % (DH / 4)) * 4;
        cp_async16(dst + Buf::Q_OFF + (r * QS + d) * 4,
                   p.q_buf + (size_t)(b * R + r) * D + h * DH + d, 16);
      }
    }
    for (int idx = t; idx < R * (CHUNK / 16); idx += THREADS) {
      const int r = idx / (CHUNK / 16), s = (idx % (CHUNK / 16)) * 16;
      cp_async16(dst + mask_off + r * CHUNK + s,
                 p.mask + (size_t)(b * R + r) * Sp + c * CHUNK + s, 16);
    }
  };

  // element e of row s of a K or V chunk, as bf16 bits
  auto kv = [&](const char* rows, int s, int e) -> unsigned short {
    if (INT8) return i8_bf16(reinterpret_cast<const int8_t*>(rows)[s * KROW + e]);
    return reinterpret_cast<const unsigned short*>(rows + s * KROW)[e];
  };

  int unit = blockIdx.x;
  if (NBUF == 2 && unit < units) issue(unit, 0);
  cp_async_commit();
  for (int it = 0; unit < units; ++it, unit += gridDim.x) {
    SUB_MARK(0);
    if (NBUF == 1)
      issue(unit, 0);
    else if (unit + (int)gridDim.x < units)
      issue(unit + gridDim.x, (it + 1) & 1);
    cp_async_commit();
    const int b = unit / (H * NC), h = (unit / NC) % H;
    const char* buf = ring + (NBUF == 2 ? it & 1 : 0) * BYTES;
    const char* kbuf = buf;
    const char* vbuf = buf + Buf::V_OFF;
    const int8_t* blocked = reinterpret_cast<const int8_t*>(buf + mask_off);
    const float* ksc = reinterpret_cast<const float*>(buf + scale_off);
    const float* vsc = ksc + CHUNK;
    const float* qg = p.q_buf + (size_t)(b * R) * D + h * DH;
    const float* qr = reinterpret_cast<const float*>(buf + Buf::Q_OFF);
    auto qv = [&](int r, int d) { return q_ring ? qr[r * QS + d] : __ldcg(qg + (size_t)r * D + d); };
    if (NBUF == 2)
      cp_async_wait<1>();  // every group but the newest has landed: this unit's
    else
      cp_async_wait<0>();
    __syncthreads();
    for (int r0 = 0; r0 < (GEN ? R : 1); r0 += RT) {
      for (int idx = t; idx < RT * (DH / 2); idx += THREADS) {  // q packed once for every warp
        const int r = idx / (DH / 2), k2 = idx % (DH / 2);
        Qb[r * QSB + k2] =
            !GEN || r0 + r < R ? pack_bf16(qv(r0 + r, 2 * k2), qv(r0 + r, 2 * k2 + 1)) : 0u;
      }
      __syncthreads();
      SUB_MARK(1);

      // logits: warp w takes columns 8 w .. + 8 of both 16-row tiles
      {
        const int gid = lane >> 2, tig = lane & 3, s0 = 8 * warp;
        float acc[2][4] = {};
#pragma unroll
        for (int k = 0; k < DH; k += 16) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int o = (16 * mt + gid) * QSB + k / 2 + tig;
            a[mt][0] = Qb[o];
            a[mt][1] = Qb[o + 8 * QSB];
            a[mt][2] = Qb[o + 4];
            a[mt][3] = Qb[o + 8 * QSB + 4];
          }
          const int s = s0 + gid, e = k + 2 * tig;
          const uint32_t bb[2] = {pack_raw(kv(kbuf, s, e), kv(kbuf, s, e + 1)),
                                  pack_raw(kv(kbuf, s, e + 8), kv(kbuf, s, e + 9))};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt], a[mt], bb);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // c0, c1: row gid; c2, c3: row gid + 8
            const int r = 16 * mt + gid + 8 * (e >> 1), sc = s0 + 2 * tig + (e & 1);
            if (r0 + r < R) {
              float lg = rnd<__nv_bfloat16>(acc[mt][e]);
              if (INT8) lg *= ksc[sc];
              P[r * PS + sc] = (blocked[(r0 + r) * CHUNK + sc] ? NEG_MASK : lg) * p.scale;
            }
          }
        }
      }
      __syncthreads();
      SUB_MARK(2);

      // the chunk's max and sum of exponentials, one warp a row; the weights
      // in bf16 for the weighted sum (rows past R are zero)
      for (int r = warp; r < RT; r += NWARPS) {
        unsigned short* Pr = Pb + r * PSB;
        if (r0 + r >= R) {
          for (int i = lane; i < CHUNK; i += 32) Pr[i] = 0;
          continue;
        }
        float v[CHUNK / 32];
        float m = -INFINITY;
#pragma unroll
        for (int i = 0; i < CHUNK / 32; ++i) {
          v[i] = P[r * PS + lane + 32 * i];
          m = fmaxf(m, v[i]);
        }
        m = warp_max(m);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < CHUNK / 32; ++i) {
          const float e = expf(v[i] - m);
          sum += e;
          const __nv_bfloat16 w = __float2bfloat16_rn(INT8 ? e * vsc[lane + 32 * i] : e);
          Pr[lane + 32 * i] = *reinterpret_cast<const unsigned short*>(&w);
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          float* ml = p.ca_ml + ((size_t)unit * R + r0 + r) * 2;
          ml[0] = m;
          ml[1] = sum;
        }
        if (p.has_bias && unit % NC == 0) {  // the bias column's logit, once a row
          const __nv_bfloat16* kb = kb_w + h * DH;
          float l = 0.f;
          for (int d = lane; d < DH; d += 32)
            l = fmaf(qv(r0 + r, d), __bfloat162float(kb[d]), l);
          l = warp_sum(l);
          if (lane == 0)
            p.ca_bl[(b * H + h) * R + r0 + r] =
                rnd<__nv_bfloat16>(l) * p.scale + __ldg(p.log_m + b * R + r0 + r);
        }
      }
      __syncthreads();
      SUB_MARK(3);

      // the weighted sum of V: the (16-row, 8-channel) tiles over the warps,
      // tile i = 2 (d0 / 8) + mt to warp i % NWARPS
      for (int pair = warp; pair < 2 * (DH / 8); pair += NWARPS) {
        const int gid = lane >> 2, tig = lane & 3, mt = pair & 1, d0 = 8 * (pair >> 1);
        float acc[4] = {};
#pragma unroll 4
        for (int k = 0; k < CHUNK; k += 16) {
          const uint32_t* Pw = reinterpret_cast<const uint32_t*>(Pb);
          const int o = ((16 * mt + gid) * PSB + k + 2 * tig) / 2;
          const uint32_t a[4] = {Pw[o], Pw[o + 8 * PSB / 2], Pw[o + 4], Pw[o + 8 * PSB / 2 + 4]};
          const int sv = k + 2 * tig, d = d0 + gid;
          const uint32_t bb[2] = {pack_raw(kv(vbuf, sv, d), kv(vbuf, sv + 1, d)),
                                  pack_raw(kv(vbuf, sv + 8, d), kv(vbuf, sv + 9, d))};
          mma_bf16(acc, a, bb);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + 16 * mt + gid + 8 * (e >> 1), d = d0 + 2 * tig + (e & 1);
          if (r < R) p.ca_o[((size_t)unit * R + r) * DH + d] = acc[e];
        }
      }
      SUB_MARK(4);
      if (r0 + RT < R) __syncthreads();  // the next row tile rewrites the weights and q
    }

    __syncthreads();  // the next issue overwrites this unit's buffer
  }
  cp_async_wait<0>();
}

// The cross-attention stage of p's type of K/V.
template <int D, int DH, typename T, bool GEN>
__device__ __forceinline__ void cross_stage(const Params& p, int li, float* smem) {
  if constexpr (IS_BF16<T>) {
    if (p.kv_int8)
      cross_attention_stage_bf16<D, DH, true, GEN>(p, li, smem);
    else
      cross_attention_stage_bf16<D, DH, false, GEN>(p, li, smem);
  } else {
    if (p.kv_int8)
      cross_attention_stage<D, DH, true, GEN>(p, li, smem);
    else
      cross_attention_stage<D, DH, false, GEN>(p, li, smem);
  }
}

// x_out = LN3(x + (the W2 partial sums + b2)) of the last layer, one warp a row.
template <int D, typename T, bool GEN>
__device__ void final_ln_stage(const Params& p, const float* x, int li) {
  const int M = p.B * p.R;
  const T* const* w = reinterpret_cast<const T* const*>(p.w);
  for (int row = blockIdx.x * NWARPS + threadIdx.x / 32; row < M; row += gridDim.x * NWARPS) {
    T* out = static_cast<T*>(p.x_out) + (size_t)row * D;
    ln_parts<D, T, GEN>(p, x, row, w[MLP_B2] + (size_t)li * D, w[LN3_S] + (size_t)li * D,
                   w[LN3_B] + (size_t)li * D, reinterpret_cast<float*>(out), nullptr,
                   IS_BF16<T> ? out : nullptr);
  }
}

// GEN false: the flagship's schedule (fused_plan_fits), every stage's
// loops and layouts fixed at compile time; GEN true: any shape (plan_smem).
template <int D, int DH, typename T, bool GEN>
__global__ void __launch_bounds__(THREADS, 1)
fused_decode_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int M = p.B * p.R, MC = p.B * p.G;
  const void* const* w = p.w;
  constexpr int ES = (int)sizeof(T);
  auto wl = [&](int i, size_t off) -> const void* {  // weight i at element offset off
    return static_cast<const char*>(w[i]) + off * ES;
  };
  T* const kc = static_cast<T*>(p.kc);
  T* const vc = static_cast<T*>(p.vc);
  STAGE_MARK(0);

  // the residual stream x: x_in (T) until layer 0's first LayerNorm, then
  // one half of p.xs (f32). LN1 and LN2 rewrite it in place (their stages
  // read it nowhere else); LN3, whose tiles read x as its residual, writes
  // the other half.
  const void* x = p.x_in;
  bool x_in = true;  // x is p.x_in
  float* xw = p.xs;  // the half the LayerNorms write
  for (int li = 0; li < p.depth; ++li) {
    const size_t dd = (size_t)li * D * D, df = (size_t)li * D * p.F;
    const size_t cache = (size_t)li * p.B * p.C * D;
    const int mark = 1 + li * LAYER_STAGES;

    // 1: q of every row; k and v of the commit rows into the caches. From
    // layer 1 on, the A rows are LN3 of the previous layer.
    {
      GemmJob jobs[3];
      const void* Wq = wl(SA_WQ, dd);
      const void* Wk = wl(SA_WK, dd);
      const void* Wv = wl(SA_WV, dd);
      const void* bq = wl(SA_BQ, li * D);
      const void* bk = wl(SA_BK, li * D);
      const void* bv = wl(SA_BV, li * D);
      if (li == 0) {
        jobs[0] = plain_job(x, D, Wq, bq, p.q_buf, M, D);
        jobs[1] = plain_job(x, D, Wk, bk, kc + cache, MC, D);
        jobs[2] = plain_job(x, D, Wv, bv, vc + cache, MC, D);
        for (int i = 0; i < 3; ++i) jobs[i].a_t = 1;
      } else {
        xw = x == p.xs ? p.xs + (size_t)M * D : p.xs;
        const size_t pl = (size_t)(li - 1) * D;
        const void *s3 = wl(LN3_S, pl), *c3 = wl(LN3_B, pl);
        jobs[0] = ln_job<D>(A_LN4, s3, c3, xw, Wq, bq, p.q_buf, M, D);
        jobs[1] = ln_job<D>(A_LN4, s3, c3, nullptr, Wk, bk, kc + cache, MC, D);
        jobs[2] = ln_job<D>(A_LN4, s3, c3, nullptr, Wv, bv, vc + cache, MC, D);
        for (int i = 0; i < 3; ++i) {
          jobs[i].A = x;
          jobs[i].ln_bias = wl(MLP_B2, pl);
        }
      }
      for (int i = 0; i < 3; ++i) jobs[i].nsub = 2;  // one round of tiles, LN3 once a row block
      for (int i = 1; i < 3; ++i) jobs[i].a_commit = jobs[i].o_cache = 1;
      jobs[0].tag = li == 1 ? 2 : 0;
      gemm_stage<D, DH, T, GEN>(jobs, 3, p, smem);
    }
    grid.sync();
    if (li) x = xw;
    STAGE_MARK(mark + 0);

    self_attention_stage<D, DH, T, GEN>(p, li, smem);  // 2
    grid.sync();
    STAGE_MARK(mark + 1);

    {
      GemmJob job = plain_job(p.attn_buf, D, wl(SA_WO, dd), wl(SA_BO, li * D), p.ybuf, M, D);
      job.resid = x;  // 3: y = x + (attn Wo + bo)
      job.resid_t = x_in;
      job.tag = li == 0 ? 1 : 0;
      gemm_stage<D, DH, T, GEN>(&job, 1, p, smem);
    }
    grid.sync();
    STAGE_MARK(mark + 2);

    {
      const GemmJob job = ln_job<D>(A_LN, wl(LN1_S, li * D), wl(LN1_B, li * D), xw,
                                 wl(CA_WQ, dd), wl(CA_BQ, li * D), p.q_buf, M, D);
      gemm_stage<D, DH, T, GEN>(&job, 1, p, smem);  // 4: x = LN1(y); qc = x Wq' + bq'
    }
    grid.sync();
    x = xw;
    x_in = false;
    STAGE_MARK(mark + 3);

    cross_stage<D, DH, T, GEN>(p, li, smem);  // 5
    grid.sync();
    STAGE_MARK(mark + 4);

    {
      GemmJob job = plain_job(nullptr, D, wl(CA_WO, dd), wl(CA_BO, li * D), p.ybuf, M, D);
      job.amode = A_COMBINE;  // 6: y = x + (combine(chunks) Wo' + bo')
      job.li = li;
      job.resid = x;
      job.tag = li == 0 ? 4 : 0;
      gemm_stage<D, DH, T, GEN>(&job, 1, p, smem);
    }
    grid.sync();
    STAGE_MARK(mark + 5);

    {
      GemmJob job = ln_job<D>(A_LN, wl(LN2_S, li * D), wl(LN2_B, li * D), xw, wl(MLP_W1, df),
                           wl(MLP_B1, (size_t)li * p.F), p.h_buf, M, p.F);
      job.gelu = 1;  // 7: x = LN2(y); h = gelu(x W1 + b1)
      job.tag = li == 0 ? 3 : 0;
      gemm_stage<D, DH, T, GEN>(&job, 1, p, smem);
    }
    grid.sync();
    STAGE_MARK(mark + 6);

    {
      GemmJob job = plain_job(p.h_buf, p.F, wl(MLP_W2, df), nullptr, nullptr, M, D);
      job.splits = p.nsplit2;  // 8: h W2, the reduction split in ceil(F / D) partial sums
      gemm_stage<D, DH, T, GEN>(&job, 1, p, smem);
    }
    grid.sync();
    STAGE_MARK(mark + 7);
  }
  final_ln_stage<D, T, GEN>(p, static_cast<const float*>(x), p.depth - 1);
#ifdef FD_STAGE_TIMING
  grid.sync();
  STAGE_MARK(1 + LAYER_STAGES * p.depth);
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

#ifndef FD_D
#define FD_D 512
#endif
#ifndef FD_DH
#define FD_DH 64
#endif
static_assert(FD_DH % 16 == 0 && FD_DH >= 16 && FD_DH <= 128 && FD_D % FD_DH == 0,
              "Dh a multiple of 16 up to 128, D a multiple of Dh");

// The shared-memory plan of one launch at widths (D, DH) and type T (the
// layout each stage reads from p): the combine's chunks a group, the
// cross-attention's buffers, the self-attention's events a unit and
// positions a tile. Returns the bytes the block needs (the largest stage's),
// more than SMEM_MAX where the shape does not fit. ops/fused_decode.py's
// smem_plan is its Python mirror, which the wrapper checks before a launch.
template <int D, int DH, typename T>
size_t plan_smem(Params& p) {
  using S = GemmShape<D, DH, T>;
  constexpr int H = D / DH, QS = DH + 4;
  // GEMM: the A rows, the W region, the combine's table of cg + 2 floats a
  // (row, head), cg as large as fits (at most MAX_CG, at most NC)
  int cg = p.NC < MAX_CG ? p.NC : MAX_CG;
  while (cg > 1 && S::BASE_BYTES + (size_t)BM * H * (cg + 2) * 4 > SMEM_MAX) --cg;
  p.cg = cg;
  const size_t gemm = S::BASE_BYTES + (size_t)BM * H * (cg + 2) * 4;
  // cross-attention: the fixed part and the buffers, two where they fit,
  // else one, else one without the q rows
  size_t fixed, kv;
  if constexpr (IS_BF16<T>) {
    fixed = p.kv_int8 ? CrossBufferB<DH, true>::FIXED : CrossBufferB<DH, false>::FIXED;
    kv = p.kv_int8 ? CrossBufferB<DH, true>::Q_OFF : CrossBufferB<DH, false>::Q_OFF;
  } else {
    fixed = p.kv_int8 ? CrossBuffer<DH, true>::FIXED : CrossBuffer<DH, false>::FIXED;
    kv = p.kv_int8 ? CrossBuffer<DH, true>::Q_OFF : CrossBuffer<DH, false>::Q_OFF;
  }
  const size_t tail = (size_t)p.R * CHUNK + (p.kv_int8 ? 2 * CHUNK * 4 : 0);  // mask, scales
  const size_t qrows = (size_t)p.R * QS * 4;
  size_t cross = 0;
  const int ways[3][2] = {{2, 1}, {1, 1}, {1, 0}};  // (buffers, q rows in them)
  for (const auto& w : ways) {
    const size_t bytes = kv + (w[1] ? qrows : 0) + tail;
    cross = fixed + w[0] * bytes;
    p.ca_nbuf = w[0];
    p.ca_q_ring = w[1];
    p.ca_mask_off = (int)(kv + (w[1] ? qrows : 0));
    p.ca_scale_off = p.ca_mask_off + p.R * CHUNK;
    p.ca_bytes = (int)bytes;
    if (cross <= SMEM_MAX) break;
  }
  size_t smem = gemm > cross ? gemm : cross;
  // self-attention: the most events a unit whose keys and values of every
  // position fit; else one event, the most positions a tile
  const int Tc = p.C / p.G;
  auto self_bytes = [&](int eg, int pt) {
    return (size_t)(2 * eg * QS + 2 * pt * eg * QS + 2 * eg * Tc + (pt < Tc ? 2 * eg * DH : 0)) * 4;
  };
  int eg = p.G, pt = Tc;
  while (eg > 1 && self_bytes(eg, Tc) > smem) --eg;
  while (pt > 1 && self_bytes(eg, pt) > smem) --pt;
  p.sa_eg = eg;
  p.sa_pt = pt;
  const size_t self_att = self_bytes(eg, pt);
  return self_att > smem ? self_att : smem;
}

// The flagship's schedule (GEN false) at these widths: Dh 64 (the
// cross-attention's warp tiles), D a multiple of 128 (whole LayerNorm
// lanes, whole column blocks), the whole W slab in one piece
template <int D, int DH, typename T>
constexpr bool fixed_widths() {
  return DH == 64 && D % 128 == 0 && GemmShape<D, DH, T>::NB == 1 &&
         (D / GemmShape<D, DH, T>::KSTEP) % (NWARPS / 2) == 0;
}

// Its plan, where the shape allows it (R <= RT, NC <= MAX_CG, F = 4D):
// the bytes the block needs, or more than SMEM_MAX.
template <int D, int DH, typename T>
size_t plan_fixed(Params& p) {
  constexpr int H = D / DH, QS = DH + 4;
  if (p.R > RT || p.NC > MAX_CG || p.F != 4 * D) return (size_t)SMEM_MAX + 1;
  const size_t gemm = GemmShape<D, DH, T>::BASE_BYTES + (size_t)BM * H * (MAX_CG + 1) * 4;
  size_t fixed, kv;
  if constexpr (IS_BF16<T>) {
    fixed = p.kv_int8 ? CrossBufferB<DH, true>::FIXED : CrossBufferB<DH, false>::FIXED;
    kv = p.kv_int8 ? CrossBufferB<DH, true>::Q_OFF : CrossBufferB<DH, false>::Q_OFF;
  } else {
    fixed = p.kv_int8 ? CrossBuffer<DH, true>::FIXED : CrossBuffer<DH, false>::FIXED;
    kv = p.kv_int8 ? CrossBuffer<DH, true>::Q_OFF : CrossBuffer<DH, false>::Q_OFF;
  }
  const size_t cross =
      fixed + 2 * (kv + (size_t)RT * QS * 4 + RT * CHUNK + (p.kv_int8 ? 2 * CHUNK * 4 : 0));
  const int Tc = p.C / p.G;
  const size_t self_att = (size_t)(2 * p.G * QS + 2 * Tc * p.G * QS + 2 * p.G * Tc) * 4;
  p.cg = p.NC;
  p.sa_eg = p.G;
  p.sa_pt = Tc;
  p.ca_nbuf = 2;
  p.ca_q_ring = 1;
  size_t smem = gemm > cross ? gemm : cross;
  return self_att > smem ? self_att : smem;
}

template <typename T, bool GEN>
int run(const Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = fused_decode_kernel<FD_D, FD_DH, T, GEN>;
  static size_t smem_set = 0;
  cudaError_t err;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  Params q = p;
  void* args[] = {&q};
  // every block must be resident for the grid barriers; a launch that cannot
  // place one block on each SM is refused with an error, not run
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(sms), dim3(THREADS),
                                    args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The schedule and plan of a launch: the flagship's where it fits, else the
// general one. Returns the block's bytes; *general says which.
template <typename T>
size_t plan(Params& p, int* general) {
  if constexpr (fixed_widths<FD_D, FD_DH, T>()) {
    Params q = p;
    const size_t smem = plan_fixed<FD_D, FD_DH, T>(q);
    if (smem <= SMEM_MAX) {
      p = q;
      *general = 0;
      return smem;
    }
  }
  *general = 1;
  return plan_smem<FD_D, FD_DH, T>(p);
}

template <typename T>
int launch(Params& p, cudaStream_t stream) {
  int general = 1;
  const size_t smem = plan<T>(p, &general);
  if (smem > SMEM_MAX) return FD_ERR_SMEM;
  return general ? run<T, true>(p, smem, stream) : run<T, false>(p, smem, stream);
}

}  // namespace

// x, x_out, the caches, the weights and dense memory K/V are f32
// (is_bf16 = 0) or bf16 (1); the scratch buffers are f32. The library takes
// D = FD_D and D / H = FD_DH only (FD_ERR_WIDTHS otherwise).
extern "C" int fused_decode_launch(
    const void* x, void* x_out, float* x_scratch, float* y_buf, void* k_cache,
    void* v_cache, const void* mem_k, const void* mem_v, const float* k_scales,
    const float* v_scales, const int8_t* mask, const float* log_m, void* const* weights,
    float* q_buf, float* attn_buf, float* part_buf, float* h_buf, float* ca_o, float* ca_ml,
    float* ca_bl, int B, int G, int D, int H, int depth, int C, int Sp, int F, int step,
    int valid_len, int has_bias, int kv_int8, int is_bf16, cudaStream_t stream) {
  if (D != FD_D || H < 1 || H * FD_DH != D) return FD_ERR_WIDTHS;
  Params p;
  p.x_in = x;
  p.x_out = x_out;
  p.xs = x_scratch;
  p.ybuf = y_buf;
  p.part = part_buf;
  p.kc = k_cache;
  p.vc = v_cache;
  p.mem_k = mem_k;
  p.mem_v = mem_v;
  p.k_scales = k_scales;
  p.v_scales = v_scales;
  p.mask = mask;
  p.log_m = log_m;
  for (int i = 0; i < N_WEIGHTS; ++i) p.w[i] = weights[i];
  p.q_buf = q_buf;
  p.attn_buf = attn_buf;
  p.h_buf = h_buf;
  p.ca_o = ca_o;
  p.ca_ml = ca_ml;
  p.ca_bl = ca_bl;
  p.B = B; p.G = G; p.R = 2 * G; p.C = C; p.Sp = Sp; p.F = F; p.NC = Sp / CHUNK;
  p.depth = depth; p.step = step; p.valid_len = valid_len;
  p.has_bias = has_bias; p.kv_int8 = kv_int8;
  p.nsplit2 = (F + D - 1) / D;
  p.scale = (float)(1.0 / std::sqrt((double)(D / H)));

  if (B < 1 || G < 1 || F < 16 || F % 16 || Sp % CHUNK || p.NC < 1 || C % G || depth < 1
      || step < 0 || valid_len <= step || valid_len * G > C || (is_bf16 != 0 && is_bf16 != 1))
    return FD_ERR_SHAPE;
  if (is_bf16) return launch<__nv_bfloat16>(p, stream);
  return launch<float>(p, stream);
}

// The bytes of shared memory a launch at these arguments would ask for
// (more than 232,448 where it does not fit), or -1 for widths this library
// does not take; *general is 0 where it runs the flagship's schedule.
extern "C" long long fused_decode_plan(int B, int G, int D, int H, int C, int Sp, int F,
                                       int kv_int8, int is_bf16, int* general) {
  if (D != FD_D || H < 1 || H * FD_DH != D || G < 1 || C % G || Sp % CHUNK || Sp < CHUNK)
    return -1;
  Params p = {};
  p.B = B; p.G = G; p.R = 2 * G; p.C = C; p.Sp = Sp; p.NC = Sp / CHUNK; p.F = F;
  p.kv_int8 = kv_int8;
  return (long long)(is_bf16 ? plan<__nv_bfloat16>(p, general) : plan<float>(p, general));
}

#ifdef FD_STAGE_TIMING
extern "C" int fused_decode_stage_ns(unsigned long long* out, int n) {
  if (n != 2 + LAYER_STAGES * MAX_TIMED_DEPTH) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, g_stage_ns, n * sizeof(unsigned long long));
}

extern "C" int fused_decode_sub_ns(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_sub_ns, sizeof(g_sub_ns));
}

extern "C" int fused_decode_gemm_ns(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_gemm_ns, sizeof(g_gemm_ns));
}

extern "C" int fused_decode_barrier_ns(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_barrier_ns, sizeof(g_barrier_ns));
}
#endif
