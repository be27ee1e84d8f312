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
// The TPU kernel keeps the (b, h) dvalue block resident in VMEM across its
// query tiles and writes it once, filling it with a dense (Q, S) splat on
// the MXU. Here each block owns a range of rows of one level of one (b, h)
// and writes each of its dvalue rows exactly once: no other block writes
// them, so the caller allocates dvalue uninitialised and nothing is summed
// through global atomics. For each round of queries (all of them at the
// encoder's shapes) the block
//   1. copies the round's g rows of its (b, h) into shared memory (16-byte
//      cp.async) and computes each tap's rows and weights (four taps a
//      thread, their loads together);
//   2. sorts the entries (tap, side) by row, and within a row by their key
//      2 * tap + side: a stable counting sort in shared memory. Warp w
//      takes a contiguous range of taps, sixteen a turn with lane 2i + side
//      holding entry side of the turn's tap i, so the lanes of a turn are
//      in key order; __match_any_sync groups the lanes of one row, and the
//      first of them adds the group's size to the (row, warp) count. A
//      scan over the rows, then over the warps of each row, gives every
//      (row, warp) its first slot, and the warps place their entries in the
//      same turns, each at its slot plus the lanes of its row below it.
//      So every row is summed in the same order on every launch;
//   3. gives each row to a group of 8 lanes (four rows a warp, in step; a
//      row of more than 16 entries to the whole warp), which holds the
//      value row in registers (16-byte loads), walks the row's entries up to
//      eight at a time, reads each entry's g row from shared memory, sums
//      coef * g into the row's dvalue in registers and forms the entry's
//      dot product g . v (eight entries reduced in one transposed butterfly
//      of seven shuffles), and writes the dvalue row once (a later round
//      adds to it);
//   4. writes daw and dloc of the taps whose left row it owns.
// A tap whose left row is the block's last and whose right row is the next
// block's first needs g1 from a row the block does not own: the block adds
// that row (the halo) to its row pass for the dot product only.
//
// Why not a dvalue slab in shared memory summed with float atomicAdd: on
// sm_90a a shared-memory f32 atomicAdd compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN), for 2 * 64 adds per tap. The counting sort needs no
// float atomics, and its per-row sums are registers. Why g in shared
// memory: a row's entries come from any query, so without it each entry
// would read a 256-byte g row from L2 (296 MB in all at the encoder's
// shapes, for 9.2 MB of g), and that traffic would set the pace. Why a
// stable sort: with integer atomicAdd on the row cursors a row's entries
// would land in the order the threads reach its cursor, so the f32 sums of
// dvalue would change from launch to launch, and training runs would part. The counts
// take the round's dot-product slots as scratch (two bytes a (row, warp);
// step 3 writes the dot products after the sort).
//
// bf16. The JAX package's bf16 train step hands the kernel a bf16 value and
// a bf16 output gradient; the Pallas kernel widens both to f32, sums in f32
// and returns dvalue in value's dtype (pallas_msda.py:259-261). Here the
// kernel is templated on the element type E of value, g and dvalue: it
// reads E through the conversion intrinsics, keeps the round's g rows in
// shared memory as E (half the slab of f32, so a round takes twice the
// queries), sums every dvalue row in f32 registers and rounds it to E once,
// at its store. Where the queries take more than one round, the running
// sums between rounds go to an f32 accumulator (dacc) and only the last
// round writes E; in f32, dacc is dvalue itself. dloc and daw stay f32
// (loc and aw are f32 at the kernel).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): memory. At the training
// shapes (B=16, S=563, H=8, Dh=64, L=P=4, f32) the encoder call (Q=282)
// reads the value rows its taps touch (nearly all of value, 18.4 MB), g
// (9.2 MB), loc and aw (4.6 MB), and writes dvalue (18.4 MB), dloc and daw
// (4.6 MB): about 55 MB, 16 us. Its arithmetic, about 8 operations per tap
// and channel, is 0.3 GFLOP, 4.4 us at the f32 rate. Beyond that the
// design reads each level's g rows into shared memory (4 x 9.2 MB from L2)
// and one g row from shared memory per entry (2.3 MB a (b, h), about 10 us
// at 128 bytes a clock per SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MSDA_MAX_LEVELS 16
#define MSDA_LANES 8            // lanes of a row group
#define MSDA_SMEM_LIMIT 232448  // shared memory a block may have on sm_90
#define MSDA_NO_DOT 0xffff      // an entry whose dot product no tap of the block needs
#define MSDA_LIGHT_BATCHES 2    // batches of eight entries a row group walks alone

struct MsdaLevels {
  int T[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

// One tap of a round: its left row (level-local) with the strict-inside flag
// of dloc in bit 31, its right weight and its attention weight.
struct TapRec {
  int i0_inside;
  float w1;
  float a;
};

// One entry (tap, side) of a row: the tap's query in the round (high 16
// bits) and where its dot product goes, 2 * tap + side (low 16 bits, or
// MSDA_NO_DOT), and its coefficient aw * w_side.
struct __align__(8) Entry {
  int q_slot;
  float coef;
};

// The row (block-local) of entry `side` (0 left, 1 right) of a tap, or -1
// where the block keeps no such entry: the left one where the block owns
// the tap's left row; the right one where it owns the right row, or where
// that row is the halo of an own tap; never the right one of a clamped tap
// (w1 = 0 and not strictly inside), which adds nothing to dvalue and whose
// g1 neither daw nor dloc reads.
__device__ __forceinline__ int entry_row(const TapRec& r, int side, int T, int c0, int nr) {
  const int i0 = r.i0_inside & 0x7fffffff;
  const bool own = i0 >= c0 && i0 < c0 + nr;
  if (side == 0) return own ? i0 - c0 : -1;
  const int i1 = min(i0 + 1, T - 1);
  const bool keep = (r.w1 != 0.f || r.i0_inside < 0) &&
                    ((i1 >= c0 && i1 < c0 + nr) || (own && i1 == c0 + nr));
  return keep ? i1 - c0 : -1;
}

// Entry `side` of tap t (a row kept by entry_row): the right one of a tap
// whose left row the block does not own carries no dot-product slot.
__device__ __forceinline__ Entry make_entry(const TapRec& r, int t, int side, int P, int c0,
                                            int nr) {
  const int q16 = (t / P) << 16;
  if (side == 0) return Entry{q16 | (2 * t), r.a * (1.f - r.w1)};
  const int i0 = r.i0_inside & 0x7fffffff;
  const bool own = i0 >= c0 && i0 < c0 + nr;
  return Entry{q16 | (own ? 2 * t + 1 : MSDA_NO_DOT), r.a * r.w1};
}

// Row counts cur[0 .. n) to their inclusive running sums (each row's end),
// by the first warp.
__device__ __forceinline__ void scan_rows(int* cur, int n) {
  if (threadIdx.x >= 32) return;
  const int per = (n + 31) / 32;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int s = 0;
  for (int k = lo; k < hi; ++k) s += cur[k];
  int x = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (threadIdx.x >= off) x += y;
  }
  int run = x - s;
  for (int k = lo; k < hi; ++k) {
    run += cur[k];
    cur[k] = run;
  }
}

// VEC elements at p as f32 (one 16-byte access when VEC == 4 of f32, one
// 8-byte access of bf16), or zeros where !pred
__device__ __forceinline__ void load_f(const float* p, float (&v)[4], bool pred) {
  const float4 t = pred ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load_f(const float* p, float (&v)[1], bool pred) {
  v[0] = pred ? *p : 0.f;
}
__device__ __forceinline__ void load_f(const __nv_bfloat16* p, float (&v)[4], bool pred) {
  uint2 t = make_uint2(0u, 0u);
  if (pred) t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void load_f(const __nv_bfloat16* p, float (&v)[1], bool pred) {
  v[0] = pred ? __bfloat162float(*p) : 0.f;
}
__device__ __forceinline__ void store_f(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_f(float* p, const float (&v)[1]) { *p = v[0]; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = t;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}

// A row's channels of this lane (VEC * (gl + MSDA_LANES * j) .. + VEC - 1,
// j < nv), or zeros where !pred; and the store of the same.
// FULL: Dh is exactly VEC * MSDA_LANES * MAXNV, so no channel is out of range.
template <int VEC, int MAXNV, bool FULL, typename E>
__device__ __forceinline__ void load_row(const E* r, float (&v)[MAXNV][VEC], int gl, int Dh,
                                         int nv, bool pred) {
#pragma unroll
  for (int j = 0; j < MAXNV; ++j) {
    const int c = VEC * (gl + MSDA_LANES * j);
    load_f(r + c, v[j], pred && (FULL || (j < nv && c < Dh)));
  }
}
template <int VEC, int MAXNV, bool FULL, typename E>
__device__ __forceinline__ void store_row(E* r, const float (&v)[MAXNV][VEC], int gl, int Dh,
                                          int nv) {
#pragma unroll
  for (int j = 0; j < MAXNV; ++j) {
    const int c = VEC * (gl + MSDA_LANES * j);
    if (FULL || (j < nv && c < Dh)) store_f(r + c, v[j]);
  }
}

// Entries e .. e + n - 1 of one row (n <= U; none where n <= 0), by a group
// holding the row's value v: each lane adds coef * g to dv and keeps its
// part of the n dot products g . v, which one transposed butterfly over the
// group's 8 lanes turns into whole sums (U - 1 shuffles that halve the
// values held, then plain sums): lane gl ends with entry
// gl >> (3 - log2 U)'s, and the first lane of each entry stores it where the
// entry says. No branches: the U entries' loads are issued together (an
// entry past n reads g row 0 with coefficient 0). Called by every lane of
// the warp together, with U the same for all.
template <int VEC, int MAXNV, bool FULL, int U, typename E>
__device__ __forceinline__ void row_batch(const Entry* ent, int e, int n, const E* gs, int Dh,
                                          int nv, int gl, const float (&v)[MAXNV][VEC],
                                          float (&dv)[MAXNV][VEC], float2* dots) {
  int qoff[U];
  float cf[U], part[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool ok = u < n;
    const Entry en = ent[ok ? e + u : 0];
    qoff[u] = ok ? (int)((unsigned)en.q_slot >> 16) * Dh : 0;
    cf[u] = ok ? en.coef : 0.f;
    part[u] = 0.f;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int j = 0; j < MAXNV; ++j) {
      const int c = VEC * (gl + MSDA_LANES * j);
      if (FULL || (j < nv && c < Dh)) {
        float x[VEC];
        load_f(gs + qoff[u] + c, x, true);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          part[u] += x[i] * v[j][i];
          dv[j][i] += cf[u] * x[i];
        }
      }
    }
  }
  int held = U;
#pragma unroll
  for (int off = MSDA_LANES / 2; off > 0; off >>= 1) {
    const bool hi = gl & off;
    if (held > 1) {
      held >>= 1;
#pragma unroll
      for (int i = 0; i < U / 2; ++i)
        if (i < held)
          part[i] = (hi ? part[i + held] : part[i]) +
                    __shfl_xor_sync(0xffffffffu, hi ? part[i] : part[i + held], off, MSDA_LANES);
    } else {
      part[0] += __shfl_xor_sync(0xffffffffu, part[0], off, MSDA_LANES);
    }
  }
  constexpr int shift = U == 8 ? 0 : U == 4 ? 1 : U == 2 ? 2 : 3;
  const int u = gl >> shift;
  if ((gl & ((1 << shift) - 1)) == 0 && u < n) {
    const int slot = ent[e + u].q_slot & 0xffff;
    if (slot != MSDA_NO_DOT) reinterpret_cast<float*>(dots)[slot] = part[0];
  }
}

// row_batch at the width the warp's fullest batch needs (n is this group's).
template <int VEC, int MAXNV, bool FULL, typename E>
__device__ __forceinline__ void row_batch_any(const Entry* ent, int e, int n, const E* gs,
                                              int Dh, int nv, int gl,
                                              const float (&v)[MAXNV][VEC],
                                              float (&dv)[MAXNV][VEC], float2* dots) {
  const int most = __reduce_max_sync(0xffffffffu, max(n, 0));
  if (most > 4)
    row_batch<VEC, MAXNV, FULL, 8>(ent, e, n, gs, Dh, nv, gl, v, dv, dots);
  else if (most > 2)
    row_batch<VEC, MAXNV, FULL, 4>(ent, e, n, gs, Dh, nv, gl, v, dv, dots);
  else if (most > 1)
    row_batch<VEC, MAXNV, FULL, 2>(ent, e, n, gs, Dh, nv, gl, v, dv, dots);
  else
    row_batch<VEC, MAXNV, FULL, 1>(ent, e, n, gs, Dh, nv, gl, v, dv, dots);
}

// grid (B * H * L * chunks): block (b, h, l, chunk). Level l is cut into
// `chunks` ranges of ceil(T_l / chunks) rows; a range past the level's end is
// empty and its block exits. Lane gl of a row group holds channels
// VEC * (gl + MSDA_LANES * j) .. + VEC - 1 for j < nv. Shared memory a round
// of q_round queries: their g rows (f32), then `scratch` bytes (a float2 a
// tap, the dot products g0, g1; the sort's counts before them), two Entry
// and a TapRec a tap, then the row cursors. E is the element type of value,
// g (and its rows in shared memory) and dvalue; dacc holds a row's f32 sums
// between rounds (dvalue itself when E is f32).
template <typename E, int VEC, int MAXNV, bool FULL>
__global__ void __launch_bounds__(512, 2)
msda_bwd_kernel(const E* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, const E* __restrict__ g,
                E* dvalue, float* dacc, float* __restrict__ dloc,
                float* __restrict__ daw, int S, int H, int Dh, int Q, int L, int P,
                MsdaLevels lv, int chunks, int q_round, int scratch) {
  extern __shared__ __align__(16) unsigned char smem[];

  int blk = blockIdx.x;
  const int chunk = blk % chunks;
  blk /= chunks;
  const int l = blk % L;
  blk /= L;
  const int h = blk % H;
  const int b = blk / H;
  int T = 0, lstart = 0;  // this level's (a constant index keeps lv out of local memory)
#pragma unroll
  for (int i = 0; i < MSDA_MAX_LEVELS; ++i)
    if (i == l) {
      T = lv.T[i];
      lstart = lv.start[i];
    }
  const int R = (T + chunks - 1) / chunks;
  const int c0 = chunk * R;
  const int nr = min(R, T - c0);  // rows whose dvalue this block writes
  if (nr <= 0) return;
  const int halo = (c0 + nr < T) ? 1 : 0;  // the next row, for g1 of the last row's taps
  const int nrows = nr + halo;

  const int cap = q_round * P;
  E* gs = reinterpret_cast<E*>(smem);
  unsigned char* scr = smem + (((size_t)q_round * Dh * sizeof(E) + 15) & ~(size_t)15);
  float2* dots = reinterpret_cast<float2*>(scr);
  Entry* ent = reinterpret_cast<Entry*>(scr + scratch);
  TapRec* rec = reinterpret_cast<TapRec*>(ent + 2 * cap);
  int* cur = reinterpret_cast<int*>(rec + cap);  // nrows row cursors

  const size_t row = (size_t)H * Dh;  // stride between tokens
  const E* vl = value + ((size_t)b * S + lstart) * row + (size_t)h * Dh;
  E* dvl = dvalue + ((size_t)b * S + lstart) * row + (size_t)h * Dh;
  float* dal = dacc + ((size_t)b * S + lstart) * row + (size_t)h * Dh;
  const int LP = L * P;
  const float Tf = (float)T;
  const int gl = threadIdx.x % MSDA_LANES;
  const int lane = threadIdx.x & 31;
  const int wgroup = lane / MSDA_LANES;  // the row group in its warp
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int nv = (Dh + VEC * MSDA_LANES - 1) / (VEC * MSDA_LANES);
  constexpr int LINE = 128 / sizeof(E);  // elements of a 128-byte line
  const int vlines = (Dh + LINE - 1) / LINE;  // 128-byte lines of a value row
  // the sort: `segs` warps, each over a contiguous range of taps, and a
  // two-byte count (then first slot) of each (row, warp) in the scratch
  const int segs = min(nwarps, scratch / (2 * nrows));
  unsigned short* cnt = reinterpret_cast<unsigned short*>(scr);

  for (int qa = 0; qa < Q; qa += q_round) {
    const int nq = min(q_round, Q - qa), ntap = nq * P;
    const bool last = qa + q_round >= Q;  // the round that writes dvalue in E
    __syncthreads();  // the last round is done with shared memory
    // 1. the round's g rows, and the taps
    const int gvec = Dh / VEC;
    for (int i = threadIdx.x; i < nq * gvec; i += blockDim.x) {
      const int q = i / gvec, j = i - q * gvec;
      const E* src = g + (((size_t)b * Q + qa + q) * H + h) * Dh + j * VEC;
      E* dst = gs + (size_t)q * Dh + j * VEC;
      if (VEC == 4 && sizeof(E) == 4) {
        const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
      } else if (VEC == 4) {  // four bf16
        const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
      } else {
        *dst = __ldg(src);
      }
    }
    for (int k = threadIdx.x; k < nrows * segs; k += blockDim.x) cnt[k] = 0;
    __syncthreads();
    // four taps a thread at a time, their loc and aw loads issued together
    for (int t0 = threadIdx.x; t0 < ntap; t0 += 4 * blockDim.x) {
      float lo[4], av[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = t0 + k * blockDim.x, q = t / P;
        const size_t off = (((size_t)b * Q + qa + q) * H + h) * LP + l * P + (t - q * P);
        lo[k] = t < ntap ? __ldg(loc + off) : 0.f;
        av[k] = t < ntap ? __ldg(aw + off) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = t0 + k * blockDim.x;
        if (t >= ntap) break;
        // rounded product, then rounded difference, as the plain version and
        // the forward kernel compute it (no fused multiply-add)
        const float xr = __fadd_rn(__fmul_rn(lo[k], Tf), -0.5f);
        const int inside = (xr > 0.f) && (xr < (float)(T - 1));
        const float x = fminf(fmaxf(xr, 0.f), (float)(T - 1));
        const float x0 = floorf(x);
        const int i0 = (int)x0;
        const TapRec r{inside ? (i0 | (int)0x80000000u) : i0, x - x0, av[k]};
        rec[t] = r;
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // 2. stable counting sort of the entries by row; after it cur[k] is the
    // end of row k (the start of row k + 1). First the counts of each
    // (row, warp): a turn's sixteen taps, lane 2i + side
    const int seg = (ntap + segs - 1) / segs;
    const int tlo = warp * seg, thi = min(ntap, tlo + seg);
    const unsigned below = (1u << lane) - 1;
    if (warp < segs) {
      for (int tb = tlo; tb < thi; tb += 16) {
        const int t = tb + (lane >> 1);
        const int k = t < thi ? entry_row(rec[t], lane & 1, T, c0, nr) : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, k >= 0 ? k : -1 - lane);
        if (k >= 0 && (peers & below) == 0) cnt[k * segs + warp] += __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();
    // each row's count, its warps' first slots within it, and its value row
    // towards L2 (the row pass reads each once, and would otherwise wait for
    // device memory row after row)
    for (int k = threadIdx.x; k < nrows; k += blockDim.x) {
      int run = 0;
      for (int w = 0; w < segs; ++w) {
        const int c = cnt[k * segs + w];
        cnt[k * segs + w] = (unsigned short)run;
        run += c;
      }
      cur[k] = run;
      for (int i = 0; run > 0 && i < vlines; ++i)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(vl + (size_t)(c0 + k) * row + i * LINE));
    }
    __syncthreads();
    scan_rows(cur, nrows);
    __syncthreads();
    // the entries, each at its (row, warp) slot plus its row's lanes below it
    if (warp < segs) {
      for (int tb = tlo; tb < thi; tb += 16) {
        const int t = tb + (lane >> 1), side = lane & 1;
        const TapRec r = rec[min(t, thi - 1)];
        const int k = t < thi ? entry_row(r, side, T, c0, nr) : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, k >= 0 ? k : -1 - lane);
        int pos = 0;
        if (k >= 0) pos = (k > 0 ? cur[k - 1] : 0) + cnt[k * segs + warp] + __popc(peers & below);
        __syncwarp();
        if (k >= 0) {
          ent[pos] = make_entry(r, t, side, P, c0, nr);
          if ((peers & below) == 0) cnt[k * segs + warp] += __popc(peers);
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // 3. rows: dvalue sums and the dot products of their entries. The four
    // groups of a warp take four neighbouring rows. Light rows (at most
    // MSDA_LIGHT_BATCHES batches of eight entries) are walked by their own
    // group, the four in step; a heavier row (a clamped end of a level, where
    // many taps land) is then walked by the whole warp, its groups taking
    // every fourth batch, and their sums added with shuffles.
    for (int kb = 4 * warp; kb < nrows; kb += 4 * nwarps) {
      const int k = kb + wgroup;
      const bool valid = k < nrows;
      const int e0 = (valid && k > 0) ? cur[k - 1] : 0, e1 = valid ? cur[k] : 0;
      const int nb = (e1 - e0 + 7) >> 3;
      const bool light = valid && nb <= MSDA_LIGHT_BATCHES;
      {
        const bool own_row = light && k < nr;
        const bool any = light && e0 < e1;
        // a bf16 row the last round leaves alone still goes from dacc to dvalue
        const bool finish = sizeof(E) != sizeof(float) && last && qa > 0;
        const E* vr = vl + (size_t)(c0 + (valid ? k : 0)) * row;
        E* dr = dvl + (size_t)(c0 + (valid ? k : 0)) * row;
        float* ar = dal + (size_t)(c0 + (valid ? k : 0)) * row;
        float v[MAXNV][VEC], dv[MAXNV][VEC];
        load_row<VEC, MAXNV, FULL>(vr, v, gl, Dh, nv, any);
        load_row<VEC, MAXNV, FULL>(ar, dv, gl, Dh, nv, (any || finish) && qa > 0 && own_row);
        const int batches = __reduce_max_sync(0xffffffffu, light ? nb : 0);
        for (int bi = 0; bi < batches; ++bi)
          row_batch_any<VEC, MAXNV, FULL>(ent, e0 + 8 * bi, light ? min(8, e1 - e0 - 8 * bi) : 0,
                                      gs, Dh, nv, gl, v, dv, dots);
        if (own_row && (qa == 0 || any || finish)) {
          if (last)
            store_row<VEC, MAXNV, FULL>(dr, dv, gl, Dh, nv);
          else
            store_row<VEC, MAXNV, FULL>(ar, dv, gl, Dh, nv);
        }
      }
      unsigned heavy = __ballot_sync(0xffffffffu, valid && !light && gl == 0);
      while (heavy) {
        const int kh = kb + (__ffs(heavy) - 1) / MSDA_LANES;
        heavy &= heavy - 1;
        const int h0 = kh > 0 ? cur[kh - 1] : 0, h1 = cur[kh];
        const bool own_row = kh < nr;
        const E* vr = vl + (size_t)(c0 + kh) * row;
        E* dr = dvl + (size_t)(c0 + kh) * row;
        float* ar = dal + (size_t)(c0 + kh) * row;
        float v[MAXNV][VEC], dv[MAXNV][VEC];
        load_row<VEC, MAXNV, FULL>(vr, v, gl, Dh, nv, true);
        load_row<VEC, MAXNV, FULL>(ar, dv, gl, Dh, nv, wgroup == 0 && qa > 0 && own_row);
        const int steps = ((h1 - h0 + 7) / 8 + 3) / 4;
        for (int st = 0; st < steps; ++st) {
          const int e = h0 + 8 * (4 * st + wgroup);
          row_batch_any<VEC, MAXNV, FULL>(ent, e, min(8, h1 - e), gs, Dh, nv, gl, v, dv, dots);
        }
#pragma unroll
        for (int j = 0; j < MAXNV; ++j)
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            dv[j][i] += __shfl_xor_sync(0xffffffffu, dv[j][i], 8);
            dv[j][i] += __shfl_xor_sync(0xffffffffu, dv[j][i], 16);
          }
        if (own_row && wgroup == 0) {
          if (last)
            store_row<VEC, MAXNV, FULL>(dr, dv, gl, Dh, nv);
          else
            store_row<VEC, MAXNV, FULL>(ar, dv, gl, Dh, nv);
        }
      }
    }
    __syncthreads();

    // 4. daw and dloc of the round's taps whose left row this block owns
    for (int t = threadIdx.x; t < ntap; t += blockDim.x) {
      const TapRec r = rec[t];
      const int i0 = r.i0_inside & 0x7fffffff;
      if (i0 < c0 || i0 >= c0 + nr) continue;
      const float2 d = dots[t];
      // a clamped tap has no right entry, and no g1 in its slot
      const float g1 = (r.w1 == 0.f && r.i0_inside >= 0) ? 0.f : d.y;
      const int q = t / P;
      const size_t off = (((size_t)b * Q + qa + q) * H + h) * LP + l * P + (t - q * P);
      daw[off] = d.x * (1.f - r.w1) + g1 * r.w1;
      dloc[off] = (r.i0_inside < 0) ? (g1 - d.x) * r.a * Tf : 0.f;
    }
  }
}

// The scratch of a round: its taps' dot products (a float2 each), and at
// least the sort's two-byte count of each of `rows` rows for one warp.
static int msda_bwd_scratch(int q_round, int P, int rows) {
  const int dots = q_round * P * (int)sizeof(float2);
  const int counts = (2 * rows + 7) & ~7;
  return dots > counts ? dots : counts;
}

// Shared memory of a block: a round of q_round queries (g rows of `esize`
// bytes an element), and at most `rows` rows a block with the halo row; the
// wrapper's plan computes the same.
static size_t msda_bwd_smem(int Dh, int esize, int q_round, int P, int rows) {
  return (((size_t)q_round * Dh * esize + 15) & ~(size_t)15) +
         (size_t)msda_bwd_scratch(q_round, P, rows) +
         (size_t)q_round * P * (2 * sizeof(Entry) + sizeof(TapRec)) +
         (size_t)rows * sizeof(int);
}

template <typename E, int VEC, int MAXNV, bool FULL>
static int msda_bwd_run(const void* value, const void* loc, const void* aw, const void* g,
                        void* dvalue, void* dacc, void* dloc, void* daw, int B, int S, int H,
                        int Dh, int Q, int L, int P, const MsdaLevels& lv, int chunks,
                        int q_round, int scratch, int threads, size_t smem, cudaStream_t st) {
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(msda_bwd_kernel<E, VEC, MAXNV, FULL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const long long blocks = (long long)B * H * L * chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  msda_bwd_kernel<E, VEC, MAXNV, FULL><<<(unsigned)blocks, threads, smem, st>>>(
      (const E*)value, (const float*)loc, (const float*)aw, (const E*)g, (E*)dvalue,
      (float*)dacc, (float*)dloc, (float*)daw, S, H, Dh, Q, L, P, lv, chunks, q_round, scratch);
  return (int)cudaGetLastError();
}

template <typename E>
static int msda_bwd_dispatch(const void* value, const void* loc, const void* aw, const void* g,
                             void* dvalue, void* dacc, void* dloc, void* daw, int B, int S,
                             int H, int Dh, int Q, int L, int P, const MsdaLevels& lv,
                             int vec, int chunks, int q_round, int scratch, int threads,
                             size_t smem, cudaStream_t st) {
  if (vec == 4 && Dh == 8 * MSDA_LANES)  // Dh = 64, every configuration of the model
    return msda_bwd_run<E, 4, 2, true>(value, loc, aw, g, dvalue, dacc, dloc, daw, B, S, H, Dh,
                                       Q, L, P, lv, chunks, q_round, scratch, threads, smem, st);
  if (vec == 4 && Dh <= 8 * MSDA_LANES)
    return msda_bwd_run<E, 4, 2, false>(value, loc, aw, g, dvalue, dacc, dloc, daw, B, S, H, Dh,
                                        Q, L, P, lv, chunks, q_round, scratch, threads, smem, st);
  if (vec == 4)
    return msda_bwd_run<E, 4, 8, false>(value, loc, aw, g, dvalue, dacc, dloc, daw, B, S, H, Dh,
                                        Q, L, P, lv, chunks, q_round, scratch, threads, smem, st);
  return msda_bwd_run<E, 1, 32, false>(value, loc, aw, g, dvalue, dacc, dloc, daw, B, S, H, Dh,
                                       Q, L, P, lv, chunks, q_round, scratch, threads, smem, st);
}

// Plain C entry point, bound from Python with ctypes. value, g and dvalue
// are f32 (value_is_bf16 = 0) or bf16 (1); loc and aw f32; all contiguous.
// dvalue, dloc and daw need no initial values. dacc is an f32 (B, S, H, Dh)
// buffer for the running sums between rounds: dvalue itself in f32, and
// only read when a bf16 call takes more than one round (else it may be
// null). The schedule comes from the wrapper's plan: `vec` channels a lane
// load (4: Dh % 4 == 0 and value, g and dvalue 16-byte aligned; or 1), each
// level cut into `chunks` row ranges, `q_round` queries a round, `threads`
// a block. level_T is a host array of L ints. Returns the CUDA error code of
// the launch (0 = success).
extern "C" int msda_bwd_launch(const void* value, const void* loc,
                               const void* aw, const void* g, void* dvalue, void* dacc,
                               void* dloc, void* daw, int B, int S, int H,
                               int Dh, int Q, int L, int P, const int* level_T,
                               int value_is_bf16, int vec, int chunks, int q_round, int threads,
                               void* stream) {
  if (B <= 0 || Q <= 0 || H <= 0 || L <= 0 || P <= 0 || Dh <= 0 ||
      L > MSDA_MAX_LEVELS || Dh > 256 || chunks <= 0 || q_round <= 0 || q_round > 0xffff ||
      threads <= 0 || threads > 512 || threads % 32 != 0 || (vec != 1 && vec != 4) ||
      Dh % vec != 0 || 2LL * q_round * P >= MSDA_NO_DOT ||
      (value_is_bf16 && q_round < Q && dacc == nullptr))
    return (int)cudaErrorInvalidValue;
  MsdaLevels lv;
  int s = 0, max_rows = 0;
  for (int l = 0; l < L; ++l) {
    if (level_T[l] <= 0) return (int)cudaErrorInvalidValue;
    lv.T[l] = level_T[l];
    lv.start[l] = s;
    s += level_T[l];
    const int rows = (level_T[l] + chunks - 1) / chunks;
    if (rows > max_rows) max_rows = rows;
  }
  if (s != S) return (int)cudaErrorInvalidValue;
  const int esize = value_is_bf16 ? 2 : 4;
  const size_t smem = msda_bwd_smem(Dh, esize, q_round, P, max_rows + 1);  // the halo row
  if (smem > MSDA_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int scratch = msda_bwd_scratch(q_round, P, max_rows + 1);
  cudaStream_t st = (cudaStream_t)stream;
  if (value_is_bf16)
    return msda_bwd_dispatch<__nv_bfloat16>(value, loc, aw, g, dvalue, dacc, dloc, daw, B, S, H,
                                            Dh, Q, L, P, lv, vec, chunks, q_round, scratch,
                                            threads, smem, st);
  return msda_bwd_dispatch<float>(value, loc, aw, g, dvalue, dvalue, dloc, daw, B, S, H, Dh, Q,
                                  L, P, lv, vec, chunks, q_round, scratch, threads, smem, st);
}
