// gather_auto.cu: the AUTO scorer over each query's own candidate ids.
//
// Replaces the TPU kernel src/repro/kernels/gather_auto/gather_auto.py:
// gather_auto_scores (Pallas body _kernel, l.36-57), and on the main path
// its jnp twins routing._score_candidates (quant_mode "none") and
// help_graph._score_candidates: every traversal hop and every NN-descent
// candidate block.
//
// For query b and candidate slot c with id = cand[b, c]:
//   out[b, c] = INF (3e38)                  if id < 0 (or id >= N)
//   sv2       = max(sum_m (db_v[id, m] - qv[b, m])^2, 0)
//   l2 mode:    out = sv2
//   auto mode:  sa  = sum_l mask[b, l] * max(qlo[b, l] - a_l, a_l - qhi[b, l], 0)
//               out = (sv2 * (1 + sa * inv_alpha)) * (1 + sa * inv_alpha)
// The penalty multiplies by inv_alpha = f32(1) / f32(alpha), computed by
// the wrapper: the jnp source divides (core/auto.py l.292), but the
// reference's main path runs under jax.jit with alpha static and XLA folds
// the division into this reciprocal multiply, so (sv2 * p) * p with
// p = 1 + sa * inv_alpha, each step rounded on its own (__fmul_rn /
// __fadd_rn, never contracted into an fma), reproduces its scores bit for
// bit. (The Pallas body multiplies by a reciprocal taken in double.)
//
// What bounds it on this card: device-memory bytes. Each (query,
// candidate) pair reads one gathered row of M floats (512 B at M = 128)
// and L attribute ints and writes one float, about 3 flops per byte-word
// read. The gather is fused: the (B, C, M) candidate block the JAX path
// materialises never exists in device memory, so each row is read once,
// straight from the table.
//
// Design: one warp per (query, candidate) pair, 8 warps per block, one
// query per block row of the grid. The query row is staged in shared
// memory once per block. Lanes read the candidate row as coalesced float4
// (scalar loads when M % 4 != 0 or the table is not 16-B aligned), so a
// 512-B row is one 32-lane x 16-B request; many independent rows in flight
// per SM hide the random-gather latency.
//
// Batch invariance: lane j accumulates elements j, j + 32, ... (float4
// groups in component order) with fmaf, then a fixed __shfl_xor tree sums
// the lanes, and lane 0 adds the penalty terms in order l = 0 .. L-1. A
// pair's result depends only on M and its own operands, never on B, C or
// the block it lands in.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr float kInf = 3.0e38f;

__device__ __forceinline__ float sq_acc(float x, float q, float acc) {
  const float d = x - q;
  return fmaf(d, d, acc);
}

__global__ void __launch_bounds__(kWarps * 32) gather_auto_kernel(
    const float* __restrict__ qv, const int* __restrict__ qlo,
    const int* __restrict__ qhi, const int* __restrict__ mask,
    const float* __restrict__ db_v, const int* __restrict__ db_a,
    const int* __restrict__ cand, float* __restrict__ out, int B, int C,
    int M, int L, int N, float inv_alpha, int mode, int vec) {
  extern __shared__ __align__(16) float q_s[];  // one query row, M floats
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + warp;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    __syncthreads();  // the previous query row is no longer read
    const float* q = qv + (size_t)b * M;
    for (int m = threadIdx.x; m < M; m += blockDim.x) q_s[m] = q[m];
    __syncthreads();
    if (c >= C) continue;
    const int id = cand[(size_t)b * C + c];
    float result = kInf;
    if (id >= 0 && id < N) {  // warp-uniform branch
      const float* row = db_v + (size_t)id * M;
      float acc = 0.f;
      if (vec) {
        const float4* row4 = reinterpret_cast<const float4*>(row);
        const float4* q4 = reinterpret_cast<const float4*>(q_s);
        for (int j = lane; j < (M >> 2); j += 32) {
          const float4 x = __ldg(row4 + j);
          const float4 y = q4[j];
          acc = sq_acc(x.x, y.x, acc);
          acc = sq_acc(x.y, y.y, acc);
          acc = sq_acc(x.z, y.z, acc);
          acc = sq_acc(x.w, y.w, acc);
        }
      } else {
        for (int j = lane; j < M; j += 32) acc = sq_acc(__ldg(row + j), q_s[j], acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      float sv2 = fmaxf(acc, 0.f);
      if (mode == 1 && lane == 0) {
        const int* a = db_a + (size_t)id * L;
        const size_t qo = (size_t)b * L;
        float sa = 0.f;
        for (int l = 0; l < L; ++l) {
          const float af = (float)a[l];
          const float gap =
              fmaxf(fmaxf((float)qlo[qo + l] - af, af - (float)qhi[qo + l]), 0.f);
          sa += gap * (mask ? (float)mask[qo + l] : 1.f);
        }
        const float pen = __fadd_rn(1.f, __fmul_rn(sa, inv_alpha));
        sv2 = __fmul_rn(__fmul_rn(sv2, pen), pen);
      }
      result = sv2;
    }
    if (lane == 0) out[(size_t)b * C + c] = result;
  }
}

}  // namespace

extern "C" int gather_auto_launch(const void* qv, const void* qlo,
                                  const void* qhi, const void* mask,
                                  const void* db_v, const void* db_a,
                                  const void* cand, void* out, int B, int C,
                                  int M, int L, int N, float inv_alpha, int mode,
                                  void* stream) {
  if (B <= 0 || C <= 0) return 0;
  const size_t smem = (size_t)M * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int vec = (M % 4 == 0) && ((reinterpret_cast<uintptr_t>(db_v) & 15) == 0);
  const dim3 grid((C + kWarps - 1) / kWarps, B < 65535 ? B : 65535);
  gather_auto_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)qv, (const int*)qlo, (const int*)qhi, (const int*)mask,
      (const float*)db_v, (const int*)db_a, (const int*)cand, (float*)out, B,
      C, M, L, N, inv_alpha, mode, vec);
  return (int)cudaGetLastError();
}
