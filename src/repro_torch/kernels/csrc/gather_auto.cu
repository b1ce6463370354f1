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
// straight from the table. The bound chip_smoke.py states counts each
// distinct row once; a row repeated across pairs comes from L2 only while
// it is still there, so at an NN-descent block, whose pairs read most rows
// of a 512 MB table at random, nearly every pair's row leaves device
// memory, and the attributes of each pair cost one more random 32-B
// sector.
//
// Design: a warp scores one (query, span of up to 32 candidates) work unit,
// and keeps the loads of R gathered rows in flight at once:
// - The span's ids are read coalesced, one a lane, and handed out with
//   __shfl_sync. Warps walk the spans of a query side by side, so a block
//   of 8 warps shares its queries' rows in L1. The launcher takes R = 8 and
//   a span of 32: of R in {4, 8, 16} and spans of 8, 16 and 32, that was
//   the fastest at all three main-path shapes in both modes, or within 1%
//   (kernels/gather_auto/variant_sweep.py, PERF.md). Neither enters any
//   result.
// - Lane j keeps its stripe of the query row (float4 groups j, j + 32, ...)
//   in registers, loaded once per warp; groups past kQRegs (M > 256) are
//   read through __ldg, from L1. The query needs no shared memory, so any M
//   runs.
// - For each group of R candidates every lane issues R float4 loads (lane j
//   reads group j of each row: a 512-B row is one coalesced request), and in
//   auto mode the L attribute ints of its own row of the group, before it
//   reduces anything: R rows, 4 KB at R = 8, are in flight a warp.
// - The query's lo, hi and mask are converted to float once per warp and
//   kept in registers (the first kAttrRegs; beyond them, read through
//   __ldg), so each lane sums its row's penalty from registers while the
//   reduction is still ahead of it: no second, dependent round trip.
// - The R partial sums are reduced by a transposing butterfly: at each
//   __shfl_xor step a lane keeps half its rows and sends the other half,
//   so R rows take about R shuffles instead of 5 R, and then the 32 / R
//   lanes of each row finish with plain xor steps.
// - The span's scores are gathered to lane k = candidate k with one
//   __shfl_sync a group and written as one coalesced store.
// The scalar path (M % 4 != 0, or a table that is not 16-B aligned) is
// the same template with one float in place of a float4.
//
// Batch invariance and the old bits: lane j accumulates elements j, j + 32,
// ... (float4 groups in component order) with fmaf, and the butterfly adds,
// at each of the offsets 16, 8, 4, 2, 1 in turn, the partial sums of two
// lane sets that differ in that bit: the xor tree every lane of the first
// kernel ran, since a + b and b + a round alike. The penalty sums l = 0 ..
// L-1 in order. So a pair's result depends only on M and its own operands,
// never on B, C, the span, R or the block it lands in, and equals what the
// one-warp-a-pair kernel it replaces wrote, bit for bit.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // warps a block
constexpr int kQRegs = 2;        // query groups a lane keeps in registers (M <= 256 at float4)
constexpr int kAttrRegs = 8;     // attributes loaded beside the features
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = 3.0e38f;

template <bool kVec>
struct Group {
  using T = float;
};
template <>
struct Group<true> {
  using T = float4;
};

__device__ __forceinline__ float sq_acc(float x, float q, float acc) {
  const float d = x - q;
  return fmaf(d, d, acc);
}

__device__ __forceinline__ float sq_acc(float4 x, float4 q, float acc) {
  acc = sq_acc(x.x, q.x, acc);
  acc = sq_acc(x.y, q.y, acc);
  acc = sq_acc(x.z, q.z, acc);
  return sq_acc(x.w, q.w, acc);
}

template <bool kVec>
__device__ __forceinline__ typename Group<kVec>::T zero() {
  if constexpr (kVec) {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    return 0.f;
  }
}

// Group j of a table row (16-B aligned when kVec).
template <bool kVec>
__device__ __forceinline__ typename Group<kVec>::T load_row(const float* row, int j) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const float4*>(row) + j);
  } else {
    return __ldg(row + j);
  }
}

// Group j of the query row, by scalar loads: the query may sit at any
// 4-byte offset.
template <bool kVec>
__device__ __forceinline__ typename Group<kVec>::T load_query(const float* q, int j) {
  if constexpr (kVec) {
    return make_float4(__ldg(q + 4 * j), __ldg(q + 4 * j + 1), __ldg(q + 4 * j + 2),
                       __ldg(q + 4 * j + 3));
  } else {
    return __ldg(q + j);
  }
}

// One step of the transposing butterfly over the first N of v's R values:
// at offset 16 * N / R a lane keeps the half of them its bit selects and
// adds the partner's; then the next step over the kept half.
template <int R, int N>
__device__ __forceinline__ void halve(float (&v)[R], int lane) {
  if constexpr (N > 1) {
    constexpr int kOff = 16 * N / R;
    const bool upper = lane & kOff;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float keep = upper ? v[i + N / 2] : v[i];
      const float send = upper ? v[i] : v[i + N / 2];
      v[i] = keep + __shfl_xor_sync(kFull, send, kOff);
    }
    halve<R, N / 2>(v, lane);
  }
}

// Sum of R rows' lane partials: lane l returns row l / (32 / R)'s total.
template <int R>
__device__ __forceinline__ float reduce_rows(float (&v)[R], int lane) {
  halve<R, R>(v, lane);
  float s = v[0];
#pragma unroll
  for (int off = 16 / R; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

template <bool kVec, int R>
__global__ void __launch_bounds__(kWarps * 32, R <= 8 ? 2 : 1) gather_auto_kernel(
    const float* __restrict__ qv, const int* __restrict__ qlo,
    const int* __restrict__ qhi, const int* __restrict__ mask,
    const float* __restrict__ db_v, const int* __restrict__ db_a,
    const int* __restrict__ cand, float* __restrict__ out, int B, int C,
    int M, int L, int N, float inv_alpha, int mode, int span, int n_spans) {
  using V = typename Group<kVec>::T;
  constexpr int kLanesPerRow = 32 / R;
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (long long)B * n_spans) return;  // the whole warp
  const int b = (int)(w / n_spans);
  const int c0 = (int)(w % n_spans) * span;
  const int width = kVec ? M / 4 : M;  // groups a row
  const int n_t = (width + 31) / 32;   // groups a lane
  const float* q = qv + (size_t)b * M;
  const bool auto_mode = mode == 1;

  V qr[kQRegs];
#pragma unroll
  for (int t = 0; t < kQRegs; ++t) {
    const int j = lane + 32 * t;
    qr[t] = j < width ? load_query<kVec>(q, j) : zero<kVec>();
  }
  const size_t qo = (size_t)b * L;
  float lo_r[kAttrRegs], hi_r[kAttrRegs], mk_r[kAttrRegs];
#pragma unroll
  for (int l = 0; l < kAttrRegs; ++l) {
    const bool on = auto_mode && l < L;
    lo_r[l] = on ? (float)__ldg(qlo + qo + l) : 0.f;
    hi_r[l] = on ? (float)__ldg(qhi + qo + l) : 0.f;
    mk_r[l] = on && mask ? (float)__ldg(mask + qo + l) : 1.f;
  }

  const int n_here = min(span, C - c0);
  const int my_id = lane < n_here ? __ldg(cand + (size_t)b * C + c0 + lane) : -1;
  const int my_row = lane / kLanesPerRow;
  const int n_groups = (n_here + R - 1) / R;
  float out_k = kInf;  // lane k's candidate's score
  for (int g = 0; g < n_groups; ++g) {
    int id[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      id[r] = __shfl_sync(kFull, my_id, g * R + r);
      if (id[r] >= N) id[r] = -1;
    }
    int rid = __shfl_sync(kFull, my_id, g * R + my_row);
    const bool rok = rid >= 0 && rid < N;
    const int* arow = db_a + (size_t)(rok ? rid : 0) * L;
    int av[kAttrRegs];
#pragma unroll
    for (int l = 0; l < kAttrRegs; ++l) av[l] = auto_mode && rok && l < L ? __ldg(arow + l) : 0;

    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kQRegs; ++t) {
      if (t < n_t) {
        const int j = lane + 32 * t;
        V x[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          x[r] = id[r] >= 0 && j < width ? load_row<kVec>(db_v + (size_t)id[r] * M, j)
                                         : zero<kVec>();
        }
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = sq_acc(x[r], qr[t], acc[r]);
      }
    }
    for (int t = kQRegs; t < n_t; ++t) {
      const int j = lane + 32 * t;
      const V qj = j < width ? load_query<kVec>(q, j) : zero<kVec>();
      V x[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        x[r] = id[r] >= 0 && j < width ? load_row<kVec>(db_v + (size_t)id[r] * M, j)
                                       : zero<kVec>();
      }
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = sq_acc(x[r], qj, acc[r]);
    }

    // the penalty of the lane's row, l = 0 .. L-1 in order
    float sa = 0.f;
    if (auto_mode) {
#pragma unroll
      for (int l = 0; l < kAttrRegs; ++l) {
        if (l < L) {
          const float a = (float)av[l];
          sa += fmaxf(fmaxf(lo_r[l] - a, a - hi_r[l]), 0.f) * mk_r[l];
        }
      }
      for (int l = kAttrRegs; l < L; ++l) {
        const float a = rok ? (float)__ldg(arow + l) : 0.f;
        const float lo = (float)__ldg(qlo + qo + l), hi = (float)__ldg(qhi + qo + l);
        sa += fmaxf(fmaxf(lo - a, a - hi), 0.f) * (mask ? (float)__ldg(mask + qo + l) : 1.f);
      }
    }
    const float sum = reduce_rows<R>(acc, lane);
    float res = kInf;
    if (rok) {
      res = fmaxf(sum, 0.f);
      if (auto_mode) {
        const float pen = __fadd_rn(1.f, __fmul_rn(sa, inv_alpha));
        res = __fmul_rn(__fmul_rn(res, pen), pen);
      }
    }
    const float got = __shfl_sync(kFull, res, (lane % R) * kLanesPerRow);
    if (lane / R == g) out_k = got;
  }
  if (lane < n_here) out[(size_t)b * C + c0 + lane] = out_k;
}

template <int R>
int launch_rows(const float* qv, const int* qlo, const int* qhi, const int* mask,
                const float* db_v, const int* db_a, const int* cand, float* out, int B, int C,
                int M, int L, int N, float inv_alpha, int mode, int vec, int span,
                cudaStream_t stream) {
  if (span < R || span > 32 || span % R != 0) return (int)cudaErrorInvalidValue;
  const int n_spans = (C + span - 1) / span;
  const long long blocks = ((long long)B * n_spans + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (vec) {
    gather_auto_kernel<true, R><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
        qv, qlo, qhi, mask, db_v, db_a, cand, out, B, C, M, L, N, inv_alpha, mode, span, n_spans);
  } else {
    gather_auto_kernel<false, R><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
        qv, qlo, qhi, mask, db_v, db_a, cand, out, B, C, M, L, N, inv_alpha, mode, span, n_spans);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gather_auto_launch(const void* qv, const void* qlo,
                                  const void* qhi, const void* mask,
                                  const void* db_v, const void* db_a,
                                  const void* cand, void* out, int B, int C,
                                  int M, int L, int N, float inv_alpha, int mode,
                                  void* stream) {
  if (B <= 0 || C <= 0) return 0;
  const int vec = (M % 4 == 0) && ((reinterpret_cast<uintptr_t>(db_v) & 15) == 0);
  return launch_rows<8>((const float*)qv, (const int*)qlo, (const int*)qhi, (const int*)mask,
                        (const float*)db_v, (const int*)db_a, (const int*)cand, (float*)out, B,
                        C, M, L, N, inv_alpha, mode, vec, 32, (cudaStream_t)stream);
}
