// fused_auto.cu: the tiled brute-force AUTO scorer.
//
// Replaces the TPU kernel src/repro/kernels/fused_auto/fused_auto.py:
// fused_auto_scores (Pallas body l.44-81), and on the main path its jnp
// twin auto.brute_fused_sqdist: the brute backend, the exact oracle, the
// graph-quality psi sample of the build and the planner's timing probe.
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
// What bounds it on this card: at B = 128, N = 1M, M = 128 it does
// 2 * B * N * M = 34 GFLOP against ~1 GB of traffic (the rows read once,
// the (B, N) scores written once), so float32 arithmetic bounds it (67
// TFLOP/s outside the tensor cores on the H100 SXM data sheet) once B is
// past ~64 queries. It stays in CUDA-core FFMA on purpose: TF32 keeps about
// three digits and would break parity with the oracle.
//
// Design: a 64 x 64 output tile per block of 256 threads, each thread a
// 4 x 4 register micro-tile. M is staged through shared memory in 16-wide
// chunks (float4 loads along M, stored k-major so the inner loop reads two
// float4 per 16 FFMA). The squared norms come from the same staged tiles:
// threads 0..63 sum the query rows, threads 64..127 the database rows. The
// epilogue clamps at 0, applies the penalty from xa, qlo, qhi and mask, and
// writes float4 rows of the tile.
//
// Batch invariance: every dot product, |q|^2 and |x|^2 is an fmaf chain
// over k = 0 .. M-1 in order (zero padding past M depends on M alone), and
// the penalty sums l = 0 .. L-1 in order, so each output depends only on M
// and its own row pair, never on B, N or the tile it lands in.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;  // queries per tile
constexpr int kBN = 64;  // database rows per tile
constexpr int kBK = 16;  // M chunk staged per step
constexpr int kThreads = 256;

__device__ __forceinline__ void load4(const float* __restrict__ src, int rows,
                                      int M, int r, int k, int vec, float v[4]) {
  if (r < rows && vec && k < M) {  // M % 4 == 0 here, so k + 3 < M
    const float4 t = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * M + k));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    return;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    v[t] = (r < rows && k + t < M) ? __ldg(src + (size_t)r * M + k + t) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads) fused_auto_kernel(
    const float* __restrict__ qv, const float* __restrict__ xv,
    const int* __restrict__ qlo, const int* __restrict__ qhi,
    const int* __restrict__ mask, const int* __restrict__ xa,
    float* __restrict__ out, int B, int N, int M, int L, float inv_alpha,
    int mode, int vec, int vec_out) {
  __shared__ __align__(16) float As[kBK][kBM];  // query tile, k-major
  __shared__ __align__(16) float Bs[kBK][kBN];  // database tile, k-major
  __shared__ float qsq_s[kBM];
  __shared__ float xsq_s[kBN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int lrow = tid >> 2, lk = (tid & 3) << 2;  // loader: row, k offset

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float sq = 0.f;  // tid < 64: |q|^2 of tile row tid; 64 <= tid < 128: |x|^2

  for (int k0 = 0; k0 < M; k0 += kBK) {
    float a[4], x[4];
    load4(qv, B, M, b0 + lrow, k0 + lk, vec, a);
    load4(xv, N, M, n0 + lrow, k0 + lk, vec, x);
    __syncthreads();  // the previous chunk has been consumed
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      As[lk + t][lrow] = a[t];
      Bs[lk + t][lrow] = x[t];
    }
    __syncthreads();
    if (tid < kBM) {
#pragma unroll
      for (int k = 0; k < kBK; ++k) sq = fmaf(As[k][tid], As[k][tid], sq);
    } else if (tid < kBM + kBN) {
#pragma unroll
      for (int k = 0; k < kBK; ++k) sq = fmaf(Bs[k][tid - kBM], Bs[k][tid - kBM], sq);
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
  if (tid < kBM) {
    qsq_s[tid] = sq;
  } else if (tid < kBM + kBN) {
    xsq_s[tid - kBM] = sq;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty * 4 + i;
    if (b >= B) continue;
    const float qs = qsq_s[ty * 4 + i];
    const size_t qo = (size_t)b * L;
    float res[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      float sv2 = fmaxf((qs + xsq_s[tx * 4 + j]) - 2.f * acc[i][j], 0.f);
      if (mode == 1 && n < N) {
        const int* arow = xa + (size_t)n * L;
        float sa = 0.f;
        for (int l = 0; l < L; ++l) {
          const float af = (float)__ldg(arow + l);
          const float gap =
              fmaxf(fmaxf((float)__ldg(qlo + qo + l) - af, af - (float)__ldg(qhi + qo + l)), 0.f);
          sa += gap * (mask ? (float)__ldg(mask + qo + l) : 1.f);
        }
        const float pen = __fadd_rn(1.f, __fmul_rn(sa, inv_alpha));
        sv2 = __fmul_rn(__fmul_rn(sv2, pen), pen);
      }
      res[j] = sv2;
    }
    const int n = n0 + tx * 4;
    float* dst = out + (size_t)b * N + n;
    if (vec_out && n + 3 < N) {
      *reinterpret_cast<float4*>(dst) = make_float4(res[0], res[1], res[2], res[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) dst[j] = res[j];
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int fused_auto_launch(const void* qv, const void* xv,
                                 const void* qlo, const void* qhi,
                                 const void* mask, const void* xa, void* out,
                                 int B, int N, int M, int L, float inv_alpha,
                                 int mode, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int vec = (M % 4 == 0) && aligned16(qv) && aligned16(xv);
  const int vec_out = (N % 4 == 0) && aligned16(out);
  fused_auto_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)qv, (const float*)xv, (const int*)qlo, (const int*)qhi,
      (const int*)mask, (const int*)xa, (float*)out, B, N, M, L, inv_alpha, mode,
      vec, vec_out);
  return (int)cudaGetLastError();
}
