// adc_scan.cu: the ADC scanners over product-quantized codes, with the
// AUTO attribute penalty fused. One kernel template, two launchers:
//   adc_scan_launch   8-bit codes (N, S), tables (B, S, K), K <= 256
//   adc_scan4_launch  4-bit codes packed two per byte (N, ceil(S/2)), K = 16
//
// Replaces the TPU kernels src/repro/kernels/adc_scan/adc_scan.py:
// adc_scan_scores (l.102, Pallas body _kernel l.50-85) and adc_scan4_scores
// (l.160). On the main path the brute backend's two-stage code scan calls
// them (api/engine.py, BruteForceSearcher._adc_two_stage, mode "l2").
//
// For query b and row n:
//   sv2 = max(sum_{s = 0 .. S-1} lut[b, s, code(n, s)], 0)
//   l2 mode:    out[b, n] = sv2
//   auto mode:  sa = sum_l mask[b, l] * max(qlo[b, l] - a_l, a_l - qhi[b, l], 0)
//               out[b, n] = (sv2 * p) * p,   p = 1 + sa * inv_alpha
// The sum runs over s in ascending order, one __fadd_rn per subspace, and
// the penalty is __fmul_rn / __fadd_rn (never an fma), as the plain version
// (kernels/adc_scan/ref.py) computes it: the two agree bit for bit. For the
// 4-bit launcher code(n, s) is the low nibble of byte s / 2 for even s and
// the high nibble for odd s. Odd S stops at S, so the pad nibble is never
// read; the TPU wrapper adds a zero table instead, and since table entries
// are >= 0 both give the same bits. Given the same codes unpacked, both
// launchers run the same adds in the same order: adc_scan4 on packed codes
// equals adc_scan on the unpacked codes bit for bit.
//
// The TPU kernel turns the S lookups into a one-hot (rows, S*K) tile and a
// matrix product, because gathers suit the TPU poorly. Here a lookup from
// shared memory is cheap, and the one-hot product would spend S*K
// multiply-adds on each score instead of S adds, so this kernel looks the
// codes up directly.
//
// What bounds it on this card: at B = 128, N = 1M, S = 64 the bytes bound is
// about 0.17 ms (64 MB of codes read, 512 MB of scores written) and the
// 8.2e9 adds take 0.12 ms at the f32 peak. The real limit of this design is
// the 8.2e9 shared-memory lookups. With K = 256 the 32 lanes of a warp look
// up 32 random entries of a 256-entry table, which fall unevenly into the 32
// banks (a few-way bank conflict per lookup); with K = 16 the table row
// spans 16 banks, so a warp's lookup is one conflict-free access (equal
// codes broadcast).
//
// Design: a block stages the tables of bq queries in dynamic shared memory
// (bq * S * K floats, up to the card's opt-in limit, bq <= 8: 3 queries at
// K = 256, S = 64; 8 at K = 16). grid.x runs over query groups and grid.y
// over row slices, so blocks with neighbouring ids scan the same rows and
// the codes come from L2 after the first read. Each thread owns one row at a
// time (grid-stride over rows), reads its code bytes as 32-bit words (the
// codes stay uint8 in device memory, never widened), and for each subspace
// adds that subspace's entry of every staged table to the query's own
// accumulator. Consecutive threads own consecutive rows, so the score writes
// coalesce.
//
// Threads per block follow the shared memory a block takes. At K = 256 one
// block fills an SM's shared memory, so it runs 1024 threads: with 256 the
// SM would hold 8 warps, too few to hide the lookups' latency. Where
// several blocks fit (K = 16) a block runs 256 threads, which need fewer
// registers, and the SM holds several.
//
// Batch invariance: out[b, n] depends only on lut[b], codes[n], the targets
// of b and the attributes of n, never on B, the query group or the slice.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxQueries = 8;
// blocks aimed for per SM, over all query groups and row slices.
constexpr int kBlocksPerSm = 16;

__device__ __forceinline__ void add_entry(float (&acc)[kMaxQueries],
                                          const float* __restrict__ lut_s, int s,
                                          uint32_t code, int K, int stride, int nq) {
  const float* e = lut_s + (size_t)s * K + code;
#pragma unroll
  for (int j = 0; j < kMaxQueries; ++j) {
    if (j < nq) acc[j] = __fadd_rn(acc[j], e[j * stride]);
  }
}

template <bool kPacked, int kThreads>
__global__ void __launch_bounds__(kThreads) adc_scan_kernel(
    const float* __restrict__ lut, const uint8_t* __restrict__ codes,
    const int* __restrict__ qlo, const int* __restrict__ qhi,
    const int* __restrict__ mask, const int* __restrict__ xa,
    float* __restrict__ out, int B, int N, int S, int K, int W, int L, int bq,
    float inv_alpha, int mode, int vec_lut, int vec_codes) {
  extern __shared__ __align__(16) float smem[];
  const int stride = S * K;  // floats between two queries' tables
  float* lut_s = smem;
  int* lo_s = reinterpret_cast<int*>(smem + (size_t)bq * stride);
  int* hi_s = lo_s + bq * L;
  int* m_s = hi_s + bq * L;
  const int b0 = blockIdx.x * bq;
  const int nq = min(bq, B - b0);

  // ---- stage the group's tables and targets
  const size_t n_lut = (size_t)nq * stride;
  const float* src = lut + (size_t)b0 * stride;
  if (vec_lut) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(lut_s);
    for (size_t i = threadIdx.x; i < n_lut / 4; i += kThreads) d4[i] = __ldg(s4 + i);
  } else {
    for (size_t i = threadIdx.x; i < n_lut; i += kThreads) lut_s[i] = __ldg(src + i);
  }
  for (int i = threadIdx.x; i < nq * L; i += kThreads) {
    const size_t g = (size_t)b0 * L + i;
    lo_s[i] = qlo[g];
    hi_s[i] = qhi[g];
    m_s[i] = mask ? mask[g] : 1;
  }
  __syncthreads();

  // ---- one row per thread, grid-stride over the rows
  for (int n = blockIdx.y * kThreads + threadIdx.x; n < N; n += gridDim.y * kThreads) {
    float acc[kMaxQueries];
#pragma unroll
    for (int j = 0; j < kMaxQueries; ++j) acc[j] = 0.f;
    const uint8_t* row = codes + (size_t)n * W;
    for (int w = 0; w < W; w += 4) {
      uint32_t word = 0;
      if (vec_codes) {
        word = __ldg(reinterpret_cast<const unsigned int*>(row + w));
      } else {
        for (int t = 0; t < 4 && w + t < W; ++t) {
          word |= (uint32_t)__ldg(row + w + t) << (8 * t);
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint32_t byte = (word >> (8 * t)) & 0xFFu;
        if (kPacked) {
          const int s = 2 * (w + t);
          if (s < S) add_entry(acc, lut_s, s, byte & 0xFu, K, stride, nq);
          if (s + 1 < S) add_entry(acc, lut_s, s + 1, byte >> 4, K, stride, nq);
        } else {
          const int s = w + t;
          if (s < S) add_entry(acc, lut_s, s, byte, K, stride, nq);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxQueries; ++j) {
      if (j >= nq) continue;
      float sv2 = fmaxf(acc[j], 0.f);
      if (mode == 1) {
        const int* a = xa + (size_t)n * L;
        float sa = 0.f;
        for (int l = 0; l < L; ++l) {
          const float af = (float)__ldg(a + l);
          const int q = j * L + l;
          const float gap = fmaxf(fmaxf((float)lo_s[q] - af, af - (float)hi_s[q]), 0.f);
          sa = __fadd_rn(sa, __fmul_rn(gap, (float)m_s[q]));
        }
        const float pen = __fadd_rn(1.f, __fmul_rn(sa, inv_alpha));
        sv2 = __fmul_rn(__fmul_rn(sv2, pen), pen);
      }
      out[(size_t)(b0 + j) * N + n] = sv2;
    }
  }
}

template <bool kPacked, int kThreads>
cudaError_t start(const void* lut, const void* codes, const void* qlo, const void* qhi,
                  const void* mask, const void* xa, void* out, int B, int N, int S, int K,
                  int W, int L, int bq, size_t smem, int n_sm, float inv_alpha, int mode,
                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(adc_scan_kernel<kPacked, kThreads>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int groups = (B + bq - 1) / bq;
  const int tiles = (N + kThreads - 1) / kThreads;
  int slices = (kBlocksPerSm * n_sm + groups - 1) / groups;
  slices = slices < tiles ? slices : tiles;
  slices = slices < 65535 ? slices : 65535;
  const int vec_lut = ((S * K) % 4 == 0) && ((reinterpret_cast<uintptr_t>(lut) & 15) == 0);
  const int vec_codes = (W % 4 == 0) && ((reinterpret_cast<uintptr_t>(codes) & 3) == 0);
  adc_scan_kernel<kPacked, kThreads>
      <<<dim3(groups, slices), kThreads, smem, (cudaStream_t)stream>>>(
          (const float*)lut, (const uint8_t*)codes, (const int*)qlo, (const int*)qhi,
          (const int*)mask, (const int*)xa, (float*)out, B, N, S, K, W, L, bq, inv_alpha, mode,
          vec_lut, vec_codes);
  return cudaGetLastError();
}

template <bool kPacked>
int launch(const void* lut, const void* codes, const void* qlo, const void* qhi,
           const void* mask, const void* xa, void* out, int B, int N, int S, int K,
           int L, float inv_alpha, int mode, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (S <= 0 || K <= 0 || K > 256 || L < 0 || (kPacked && K != 16)) {
    return (int)cudaErrorInvalidValue;
  }
  const int W = kPacked ? (S + 1) / 2 : S;
  int dev = 0, smem_max = 0, smem_sm = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const size_t per_query = ((size_t)S * K + 3 * (size_t)L) * sizeof(float);
  int bq = (int)((size_t)smem_max / per_query);
  if (bq < 1) return (int)cudaErrorInvalidValue;  // one query's tables exceed shared memory
  bq = bq < kMaxQueries ? bq : kMaxQueries;
  bq = bq < B ? bq : B;
  const size_t smem = per_query * bq;
  // one block per SM by shared memory: give it the most threads a block can
  // have; otherwise several 256-thread blocks share the SM
  const bool alone = 2 * smem > (size_t)smem_sm;
  return (int)(alone ? start<kPacked, 1024>(lut, codes, qlo, qhi, mask, xa, out, B, N, S, K, W,
                                            L, bq, smem, n_sm, inv_alpha, mode, stream)
                     : start<kPacked, 256>(lut, codes, qlo, qhi, mask, xa, out, B, N, S, K, W,
                                           L, bq, smem, n_sm, inv_alpha, mode, stream));
}

}  // namespace

extern "C" int adc_scan_launch(const void* lut, const void* codes, const void* qlo,
                               const void* qhi, const void* mask, const void* xa, void* out,
                               int B, int N, int S, int K, int L, float inv_alpha, int mode,
                               void* stream) {
  return launch<false>(lut, codes, qlo, qhi, mask, xa, out, B, N, S, K, L, inv_alpha, mode,
                       stream);
}

extern "C" int adc_scan4_launch(const void* lut, const void* codes, const void* qlo,
                                const void* qhi, const void* mask, const void* xa, void* out,
                                int B, int N, int S, int K, int L, float inv_alpha, int mode,
                                void* stream) {
  return launch<true>(lut, codes, qlo, qhi, mask, xa, out, B, N, S, K, L, inv_alpha, mode,
                      stream);
}
