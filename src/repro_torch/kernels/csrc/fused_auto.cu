// fused_auto.cu: the tiled brute-force AUTO scorer.
//
// Replaces the TPU kernel src/repro/kernels/fused_auto/fused_auto.py:
// fused_auto_scores (Pallas body l.44-81), and on the main path its jnp
// twin auto.brute_fused_sqdist: the brute backend, the exact oracle, the
// graph-quality psi sample of the build, the planner's timing probe and the
// recsys retrieval head.
//
// For query b and database row n:
//   sv2 = max((|q_b|^2 + |x_n|^2) - 2 * (q_b . x_n), 0)     over the full M
//   l2 mode:    out = sv2
//   auto mode:  sa  = sum_l mask[b, l] * max(qlo[b, l] - a_l, a_l - qhi[b, l], 0)
//               out = (sv2 * (1 + sa * inv_alpha)) * (1 + sa * inv_alpha)
// This is brute_fused_sqdist's formula (core/auto.py l.354-364); the
// Pallas body accumulates qsq + xsq - 2 dot per 512-wide M slab, which is
// the same for M <= 512.
// The penalty multiplies by inv_alpha = f32(1) / f32(alpha), computed by
// the wrapper: the jnp source divides (core/auto.py l.292), but the
// reference's main path runs under jax.jit with alpha static and XLA folds
// the division into this reciprocal multiply, so (sv2 * p) * p with
// p = 1 + sa * inv_alpha, each step rounded on its own (__fmul_rn /
// __fadd_rn, never contracted into an fma), reproduces its scores bit for
// bit. (The Pallas body multiplies by a reciprocal taken in double.)
//
// What bounds it on this card, at the three shapes the port runs:
// - brute oracle, B = 128, N = 1M, M = 128: 2 * B * N * M = 34 GFLOP
//   against ~1 GB of traffic, so float32 arithmetic bounds it (67 TFLOP/s
//   outside the tensor cores on the H100 SXM data sheet). It stays in
//   CUDA-core FFMA on purpose: TF32 keeps about three digits and would
//   break parity with the oracle.
// - recsys retrieval, M = 10, L = 4: bytes bound it. At B = 512 the 2 GB
//   of (B, N) scores written; at B = 1 the 56 MB of rows and attributes
//   read. At these widths the penalty (2 operations per attribute per
//   output for point targets, 5 for intervals) costs as much as the 10
//   FFMA of the dot product.
//
// Design: one template, three tiles, picked by the launcher from B alone:
//   B <= 48:      16 x 256 outputs a block, a 4 x 4 register tile a thread
//                 (narrow: one block covers 256 rows, so a block's loads,
//                 rows and attributes together, are issued at once and one
//                 DRAM latency is exposed per block, not one per phase;
//                 capped at 64 registers, so four blocks an SM);
//   B <= 64:      64 x 64, 4 x 4 a thread;
//   otherwise:    128 x 128, 8 x 8 a thread (64 FFMA per 4 shared float4
//                 loads), two blocks an SM.
// The bounds 48 and 64 come from kernels/fused_auto/tile_sweep.py, which
// times every tile at B = 1 .. 128, N = 1M, M = 10 and 128: 16 x 256 is the
// fastest up to B = 32 at both widths, and at B = 48, with three query
// tiles, it ties 64 x 64 at M = 128 and wins at M = 10; 64 x 64 is the
// fastest at B = 64; 128 x 128 from B = 65 on, where 64 x 64 would need
// two query tiles.
// Each has 256 threads.
// - Feature tiles go through shared memory k-major, in chunks of 16 along
//   M, with two buffers when M > 16: the next chunk's copies are in flight
//   while this chunk's FFMAs run, with one barrier a chunk. The copies are
//   4-byte cp.async written straight to their k-major slot, so the tile is
//   transposed on the way in and no thread holds the data in registers.
//   (A 16-byte copy would land four k of one row side by side and need a
//   transpose pass through registers; the 4-byte copies take fewer
//   instructions than that pass, and need no alignment, so there is one
//   path for every M.) A full chunk is copied in 64-byte row pieces, 16
//   threads a row. When a chunk holds whole rows (M <= 16, e.g. M = 10)
//   the block's tile is one contiguous span of rows * M floats: a thread
//   copies its own row, and the span's bytes leave DRAM once, through L1.
// - The attribute operands of the tile (xa's BN x L, and BM x L each of
//   qlo, qhi and mask) are read once, coalesced, converted to float once
//   and kept l-major in dynamic shared memory sized by L, while the first
//   chunk's copies are in flight. They take L * (BN + 3 * BM) floats, so
//   they are staged for at most kMaxAttrs = 96 attributes, what the
//   128 x 128 tile fits beside two feature buffers in 227 KB. The epilogue's
//   l loop then reads shared memory: per row of its tile a thread reads its
//   TN row values as float4 and one query value each of lo, hi and mask,
//   and does TN gaps in registers. Ints below 2^24 convert to float
//   exactly, so converting once per tile changes no value. Point targets
//   take the gap as |a - q| (see penalty_sums), the same bits in fewer
//   operations. Above kMaxAttrs the same template stages no attributes
//   (kStaged = false) and the epilogue reads xa, qlo, qhi and mask through
//   __ldg, in the same l order with the same gap (penalty_sums_ldg), so
//   auto mode takes any L and every output keeps its bits; l2 mode stages
//   none.
// - The squared norms come from the same staged tiles, one thread a row,
//   in a loop of their own before each chunk's FFMA loop (kept out of the
//   unrolled product loop, whose schedule they disturbed).
// - Blocks walk the query tiles fastest, so the query tiles of one row
//   tile run side by side and read its rows from L2. Scores are written as
//   float4 streaming stores.
//
// Every output keeps its bits whatever the tile: every dot product, |q|^2
// and |x|^2 is an fmaf chain over k = 0 .. M-1 in order (no padding enters
// a chain), the epilogue is (qs + xs) - 2 * dot clamped at 0, and the
// penalty sums l = 0 .. L-1 in order. So each output depends only on M and
// its own row pair, never on B, N or the tile it lands in: the kernel is
// batch-invariant bit for bit, and on integer-valued inputs it equals the
// plain version bit for bit.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBK = 16;     // M chunk staged per step
constexpr int kPad = 4;     // k-major row padding (keeps float4 alignment)
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB, what one block may use
constexpr int kMaxAttrs = 96;        // L staged in auto mode (kernels/fused_auto/ops.py MAX_ATTRS)

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int BM, int BN, int TM, int TN>
struct Tile {
  static_assert(TM % 4 == 0 && TN % 4 == 0, "register tiles are float4 groups");
  static_assert((BM / TM) * (BN / TN) == kThreads, "one output tile per thread");
  static constexpr int kLdA = BM + kPad, kLdB = BN + kPad;
  static constexpr int kStage = kBK * (kLdA + kLdB);  // floats a buffer
  static constexpr int kNorms = (BM + BN + kThreads - 1) / kThreads;  // norms a thread
  static constexpr int kRowStep = BM * 4 / TM;  // between a thread's float4 groups
  static constexpr int kColStep = BN * 4 / TN;

  static constexpr size_t smem_bytes(int stages, int L, int mode) {
    return sizeof(float) * ((size_t)stages * kStage + BM + BN +
                            (mode == 1 ? (size_t)L * (BN + 3 * BM) : 0));
  }
};

// dst[k * ld + r] <- src[(r0 + r) * M + k0 + k] for k < kc and the rows
// that exist. A full chunk: thread tid copies k = tid % 16 of every 16th
// row, so a warp reads two 64-byte row pieces. A short chunk (whole rows
// when M < 16, or the ragged last chunk): a thread copies its own rows k
// by k; a warp's first copy brings its rows' sectors into L1 (cp.async.ca)
// and the next ones read them there, so each byte leaves DRAM once.
template <int R>
__device__ __forceinline__ void stage_chunk(float* dst, int ld, const float* __restrict__ src,
                                            int rows, int M, int r0, int k0, int kc, int tid) {
  const int nr = min(R, rows - r0);
  const float* base = src + (size_t)r0 * M + k0;
  if (kc == kBK) {
    constexpr int kStep = kThreads / kBK;  // rows a pass
    const int k = tid % kBK;
    for (int r = tid / kBK; r < nr; r += kStep) {
      cp_async4(dst + k * ld + r, base + (size_t)r * M + k);
    }
  } else {
    for (int r = tid; r < nr; r += kThreads) {
      const float* row = base + (size_t)r * M;
      for (int k = 0; k < kc; ++k) cp_async4(dst + k * ld + r, row + k);
    }
  }
}

// dst[l * R + r] <- float(src[(r0 + r) * L + l]) for the rows that exist,
// a thread a row (the row's bytes come through L1 once); 1 where src is
// null (no mask).
template <int R>
__device__ __forceinline__ void stage_attrs(float* dst, const int* __restrict__ src, int rows,
                                            int L, int r0, int tid) {
  const int nr = min(R, rows - r0);
  for (int r = tid; r < nr; r += kThreads) {
    const int* row = src ? src + (size_t)(r0 + r) * L : nullptr;
    for (int l = 0; l < L; ++l) dst[l * R + r] = row ? (float)__ldg(row + l) : 1.f;
  }
}

// One k of the chunk: the thread's TM x TN products.
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void fma_step(const float* As, const float* Bs, int k, int tx, int ty,
                                         float (&acc)[TM][TN]) {
  using T = Tile<BM, BN, TM, TN>;
  const float* a_row = As + k * T::kLdA;
  const float* b_row = Bs + k * T::kLdB;
  float a[TM], b[TN];
#pragma unroll
  for (int g = 0; g < TM / 4; ++g) {
    const float4 v = *reinterpret_cast<const float4*>(a_row + g * T::kRowStep + ty * 4);
    a[4 * g] = v.x; a[4 * g + 1] = v.y; a[4 * g + 2] = v.z; a[4 * g + 3] = v.w;
  }
#pragma unroll
  for (int g = 0; g < TN / 4; ++g) {
    const float4 v = *reinterpret_cast<const float4*>(b_row + g * T::kColStep + tx * 4);
    b[4 * g] = v.x; b[4 * g + 1] = v.y; b[4 * g + 2] = v.z; b[4 * g + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// sa[j] += mask * gap over l = 0 .. L-1 in order, for row r of the tile
// and the thread's TN columns, from the staged attributes. Point targets
// come as qlo == qhi (the wrapper passes one buffer twice); their gap
// max(q - a, a - q, 0) is |a - q| bit for bit, 2 operations instead of 5.
template <bool kPoint, int BM, int BN, int TN>
__device__ __forceinline__ void penalty_sums(const float* xa_s, const float* lo_s,
                                             const float* hi_s, const float* mk_s, int L, int r,
                                             int tx, float (&sa)[TN]) {
  constexpr int kColStep = BN * 4 / TN;
  for (int l = 0; l < L; ++l) {
    const float lo = lo_s[l * BM + r], hi = hi_s[l * BM + r], mk = mk_s[l * BM + r];
    const float* arow = xa_s + l * BN;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(arow + g * kColStep + tx * 4);
      const float av[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float gap = kPoint ? fabsf(av[t] - lo) : fmaxf(fmaxf(lo - av[t], av[t] - hi), 0.f);
        sa[4 * g + t] += gap * mk;
      }
    }
  }
}

// penalty_sums for a tile whose attributes are not staged (L > kMaxAttrs):
// the same sums over l = 0 .. L-1 in order with the same gaps, from xa,
// qlo, qhi and mask read through __ldg for query b and the thread's TN
// columns (a column past N reads row N - 1; its output is not written).
template <bool kPoint, int BN, int TN>
__device__ __forceinline__ void penalty_sums_ldg(const int* __restrict__ xa,
                                                 const int* __restrict__ qlo,
                                                 const int* __restrict__ qhi,
                                                 const int* __restrict__ mask, int L, int N, int b,
                                                 int n0, int tx, float (&sa)[TN]) {
  constexpr int kColStep = BN * 4 / TN;
  for (int l = 0; l < L; ++l) {
    const size_t qo = (size_t)b * L + l;
    const float lo = (float)__ldg(qlo + qo), hi = (float)__ldg(qhi + qo);
    const float mk = mask ? (float)__ldg(mask + qo) : 1.f;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int n = min(n0 + g * kColStep + tx * 4 + t, N - 1);
        const float a = (float)__ldg(xa + (size_t)n * L + l);
        const float gap = kPoint ? fabsf(a - lo) : fmaxf(fmaxf(lo - a, a - hi), 0.f);
        sa[4 * g + t] += gap * mk;
      }
    }
  }
}

template <int BM, int BN, int TM, int TN, bool kStaged>
__global__ void __launch_bounds__(kThreads, BM <= 16 ? 4 : 2) fused_auto_kernel(
    const float* __restrict__ qv, const float* __restrict__ xv,
    const int* __restrict__ qlo, const int* __restrict__ qhi,
    const int* __restrict__ mask, const int* __restrict__ xa,
    float* __restrict__ out, int B, int N, int M, int L, float inv_alpha,
    int mode, int vec_out, int n_qtiles) {
  using T = Tile<BM, BN, TM, TN>;
  extern __shared__ __align__(16) float smem[];
  const int stages = M > kBK ? 2 : 1;
  float* qsq_s = smem + stages * T::kStage;
  float* xsq_s = qsq_s + BM;
  float* xa_s = xsq_s + BN;        // [L][BN]
  float* lo_s = xa_s + L * BN;     // [L][BM]
  float* hi_s = lo_s + L * BM;
  float* mk_s = hi_s + L * BM;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int b0 = (blockIdx.x % n_qtiles) * BM;
  const int n0 = (blockIdx.x / n_qtiles) * BN;
  const int n_chunks = (M + kBK - 1) / kBK;

  // Each operand starts at another thread, so the row-a-thread copies of
  // short chunks and attributes spread over the block.
  const int tid_x = (tid + BM) % kThreads;
  stage_chunk<BM>(smem, T::kLdA, qv, B, M, b0, 0, min(kBK, M), tid);
  stage_chunk<BN>(smem + kBK * T::kLdA, T::kLdB, xv, N, M, n0, 0, min(kBK, M), tid_x);
  cp_async_commit();
  if (kStaged && mode == 1) {  // while chunk 0 is in flight
    stage_attrs<BM>(lo_s, qlo, B, L, b0, tid);
    stage_attrs<BM>(hi_s, qhi, B, L, b0, tid_x);
    stage_attrs<BM>(mk_s, mask, B, L, b0, (tid + 2 * BM) % kThreads);
    stage_attrs<BN>(xa_s, xa, N, L, n0, (tid + 3 * BM) % kThreads);
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float sq[T::kNorms];
#pragma unroll
  for (int s = 0; s < T::kNorms; ++s) sq[s] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed; chunk c - 1's buffer is free
    const int k0 = c * kBK, kc = min(kBK, M - k0);
    if (c + 1 < n_chunks) {
      float* nxt = smem + ((c + 1) & 1) * T::kStage;
      const int kn = min(kBK, M - k0 - kBK);
      stage_chunk<BM>(nxt, T::kLdA, qv, B, M, b0, k0 + kBK, kn, tid);
      stage_chunk<BN>(nxt + kBK * T::kLdA, T::kLdB, xv, N, M, n0, k0 + kBK, kn, tid_x);
      cp_async_commit();
    }
    const float* As = smem + (c & 1) * T::kStage;
    const float* Bs = As + kBK * T::kLdA;
#pragma unroll
    for (int s = 0; s < T::kNorms; ++s) {
      const int r = tid + s * kThreads;
      if (r < BM) {
        for (int k = 0; k < kc; ++k) sq[s] = fmaf(As[k * T::kLdA + r], As[k * T::kLdA + r], sq[s]);
      } else if (r < BM + BN) {
        const int rx = r - BM;
        for (int k = 0; k < kc; ++k) sq[s] = fmaf(Bs[k * T::kLdB + rx], Bs[k * T::kLdB + rx], sq[s]);
      }
    }
    if (kc == kBK) {
#pragma unroll
      for (int k = 0; k < kBK; ++k) fma_step<BM, BN, TM, TN>(As, Bs, k, tx, ty, acc);
    } else {
      for (int k = 0; k < kc; ++k) fma_step<BM, BN, TM, TN>(As, Bs, k, tx, ty, acc);
    }
  }
#pragma unroll
  for (int s = 0; s < T::kNorms; ++s) {
    const int r = tid + s * kThreads;
    if (r < BM) {
      qsq_s[r] = sq[s];
    } else if (r < BM + BN) {
      xsq_s[r - BM] = sq[s];
    }
  }
  __syncthreads();

  float xs[TN];
#pragma unroll
  for (int g = 0; g < TN / 4; ++g) {
    const float4 v = *reinterpret_cast<const float4*>(xsq_s + g * T::kColStep + tx * 4);
    xs[4 * g] = v.x; xs[4 * g + 1] = v.y; xs[4 * g + 2] = v.z; xs[4 * g + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = (i >> 2) * T::kRowStep + ty * 4 + (i & 3);
    const int b = b0 + r;
    if (b >= B) continue;
    const float qs = qsq_s[r];
    float res[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) res[j] = fmaxf((qs + xs[j]) - 2.f * acc[i][j], 0.f);
    if (mode == 1) {
      float sa[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) sa[j] = 0.f;
      if (!kStaged) {
        if (qlo == qhi) {
          penalty_sums_ldg<true, BN, TN>(xa, qlo, qhi, mask, L, N, b, n0, tx, sa);
        } else {
          penalty_sums_ldg<false, BN, TN>(xa, qlo, qhi, mask, L, N, b, n0, tx, sa);
        }
      } else if (qlo == qhi) {
        penalty_sums<true, BM, BN, TN>(xa_s, lo_s, hi_s, mk_s, L, r, tx, sa);
      } else {
        penalty_sums<false, BM, BN, TN>(xa_s, lo_s, hi_s, mk_s, L, r, tx, sa);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float pen = __fadd_rn(1.f, __fmul_rn(sa[j], inv_alpha));
        res[j] = __fmul_rn(__fmul_rn(res[j], pen), pen);
      }
    }
    float* row = out + (size_t)b * N;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int n = n0 + g * T::kColStep + tx * 4;
      if (vec_out && n + 3 < N) {
        __stcs(reinterpret_cast<float4*>(row + n),
               make_float4(res[4 * g], res[4 * g + 1], res[4 * g + 2], res[4 * g + 3]));
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (n + t < N) __stcs(row + n + t, res[4 * g + t]);
      }
    }
  }
}

template <int BM, int BN, int TM, int TN>
int launch_tile(const float* qv, const float* xv, const int* qlo, const int* qhi,
                const int* mask, const int* xa, float* out, int B, int N, int M, int L,
                float inv_alpha, int mode, int vec_out, cudaStream_t stream) {
  using T = Tile<BM, BN, TM, TN>;
  const int n_qtiles = (B + BM - 1) / BM;
  const long long blocks = (long long)n_qtiles * ((N + BN - 1) / BN);
  const bool staged = mode != 1 || L <= kMaxAttrs;
  const size_t smem = T::smem_bytes(M > kBK ? 2 : 1, staged ? L : 0, mode);
  if (blocks > INT_MAX || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = staged ? fused_auto_kernel<BM, BN, TM, TN, true>
                       : fused_auto_kernel<BM, BN, TM, TN, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      qv, xv, qlo, qhi, mask, xa, out, B, N, M, L, inv_alpha, mode, vec_out, n_qtiles);
  return (int)cudaGetLastError();
}

static_assert(Tile<16, 256, 4, 4>::smem_bytes(2, kMaxAttrs, 1) <= kMaxSmem,
              "16 x 256 at kMaxAttrs");
static_assert(Tile<64, 64, 4, 4>::smem_bytes(2, kMaxAttrs, 1) <= kMaxSmem, "64 x 64 at kMaxAttrs");
static_assert(Tile<128, 128, 8, 8>::smem_bytes(2, kMaxAttrs, 1) <= kMaxSmem,
              "128 x 128 at kMaxAttrs");

}  // namespace

extern "C" int fused_auto_launch(const void* qv, const void* xv,
                                 const void* qlo, const void* qhi,
                                 const void* mask, const void* xa, void* out,
                                 int B, int N, int M, int L, float inv_alpha,
                                 int mode, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int vec_out = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const auto s = (cudaStream_t)stream;
  const auto q = (const float*)qv;
  const auto x = (const float*)xv;
  const auto lo = (const int*)qlo;
  const auto hi = (const int*)qhi;
  const auto mk = (const int*)mask;
  const auto a = (const int*)xa;
  const auto o = (float*)out;
  if (B <= 48)
    return launch_tile<16, 256, 4, 4>(q, x, lo, hi, mk, a, o, B, N, M, L, inv_alpha, mode,
                                      vec_out, s);
  if (B <= 64)
    return launch_tile<64, 64, 4, 4>(q, x, lo, hi, mk, a, o, B, N, M, L, inv_alpha, mode,
                                     vec_out, s);
  return launch_tile<128, 128, 8, 8>(q, x, lo, hi, mk, a, o, B, N, M, L, inv_alpha, mode,
                                     vec_out, s);
}
