// fm_interaction.cu: the FM second-order term (the sum-square trick).
//
// Replaces the TPU kernel src/repro/kernels/fm_interaction/fm_interaction.py:
// fm_interaction_pallas (body _kernel l.26-30, call l.41), and on the main
// path its jnp twin fm_interaction_ref, which models/recsys.py _fm_forward
// calls for every CTR score of the fm model.
//
// For example b with field embeddings e (F, D), contiguous as (B, F, D):
//   out[b] = 0.5 * sum_d [ (sum_f e_fd)^2 - sum_f e_fd^2 ]
// in the plain version's order (kernels/fm_interaction/ref.py):
//   s_d  = s_d + e_fd         and   sq_d = sq_d + (e_fd * e_fd)   for f = 0 .. F-1
//   t_d  = (s_d * s_d) - sq_d
//   acc  = acc + t_d                                              for d = 0 .. D-1
//   out  = 0.5 * acc
// Every step is rounded on its own (__fadd_rn, __fmul_rn, __fsub_rn, never
// contracted into an fma), so the result equals the plain version bit for
// bit and depends on nothing but the example's own F x D values: the kernel
// is batch-invariant.
//
// What bounds it on this card: bytes. At serve_bulk (B = 262,144, F = 39,
// D = 10) it reads B * F * D * 4 = 409 MB once and writes 1 MB, about
// 0.122 ms at 3.35 TB/s; its ~3 * F * D flops an example take under 5 us
// at 67 TFLOP/s. At serve_p99 (B = 512) the launch sets the time.
//
// Design: one block of 256 threads takes a run of E whole examples. Since
// examples are contiguous, the run is one contiguous span of E * F * D
// floats, staged into dynamic shared memory with coalesced loads (float4,
// four in flight per thread, where the span is 16-byte aligned). Then
// thread t reduces example t of the run from shared memory, one example a
// thread, in the order above. E is the largest multiple of 32 (at most 256)
// whose run fits kSmemBudget: E = 32 at F = 39, D = 10 (49,920 bytes), four
// blocks an SM, so one block's loads overlap another's reduction. Where 32
// examples do not fit, E is what fits; where one example does not fit, the
// threads read their examples straight from device memory (correct, slow).
// Offsets are 64-bit throughout; any F and D work, D need not be a power
// of two.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 64 * 1024;  // bytes of staged examples a block
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float fm_one(const float* e, int F, int D) {
  float acc = 0.f;
  for (int d = 0; d < D; ++d) {
    float s = 0.f, sq = 0.f;
    const float* p = e + d;
#pragma unroll 4
    for (int f = 0; f < F; ++f) {
      const float v = p[(int64_t)f * D];
      s = __fadd_rn(s, v);
      sq = __fadd_rn(sq, __fmul_rn(v, v));
    }
    acc = __fadd_rn(acc, __fsub_rn(__fmul_rn(s, s), sq));
  }
  return __fmul_rn(0.5f, acc);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) fm_interaction_kernel(
    const float* __restrict__ emb, float* __restrict__ out, int B, int F,
    int D, int E, int vec) {
  extern __shared__ __align__(16) float tile[];
  const int64_t fd = (int64_t)F * D;
  const int64_t b0 = (int64_t)blockIdx.x * E;
  const int nb = (int)(((int64_t)B - b0) < E ? ((int64_t)B - b0) : E);
  const float* src = emb + b0 * fd;
  if (kStaged) {
    const int n = (int)(nb * fd);  // <= kSmemBudget / 4
    int i = threadIdx.x;
    if (vec) {  // src 16-byte aligned: E * F * D % 4 == 0 and emb aligned
      const int n4 = n >> 2;
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* t4 = reinterpret_cast<float4*>(tile);
      for (; i + 3 * kThreads < n4; i += 4 * kThreads) {
        const float4 r0 = __ldg(s4 + i);
        const float4 r1 = __ldg(s4 + i + kThreads);
        const float4 r2 = __ldg(s4 + i + 2 * kThreads);
        const float4 r3 = __ldg(s4 + i + 3 * kThreads);
        t4[i] = r0;
        t4[i + kThreads] = r1;
        t4[i + 2 * kThreads] = r2;
        t4[i + 3 * kThreads] = r3;
      }
      for (; i < n4; i += kThreads) t4[i] = __ldg(s4 + i);
      i = (n4 << 2) + threadIdx.x;  // the tail past the last float4
    }
    for (; i < n; i += kThreads) tile[i] = __ldg(src + i);
    __syncthreads();
  }
  for (int t = threadIdx.x; t < nb; t += kThreads) {
    const float* e = kStaged ? tile + t * fd : src + t * fd;
    out[b0 + t] = fm_one(e, F, D);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int fm_interaction_launch(const void* emb, void* out, int B, int F,
                                     int D, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (F <= 0 || D <= 0) {  // an empty sum: every term is 0
    return (int)cudaMemsetAsync(out, 0, (size_t)B * sizeof(float), st);
  }
  const int64_t bytes = (int64_t)F * D * (int64_t)sizeof(float);
  int E = kThreads;
  bool staged = true;
  if (32 * bytes <= kSmemBudget) {
    const int64_t fit = kSmemBudget / bytes / 32 * 32;
    E = (int)(fit < kThreads ? fit : kThreads);
  } else if (bytes <= kSmemBudget) {
    E = (int)(kSmemBudget / bytes);
  } else {
    staged = false;
  }
  const int64_t grid = ((int64_t)B + E - 1) / E;
  if (staged) {
    const size_t smem = (size_t)(E * bytes);
    if (smem > 48 * 1024) {  // above 48 KB only after opting in, once a device
      static int opted[kMaxDevices];
      int dev = 0;
      cudaGetDevice(&dev);
      if (dev >= kMaxDevices || !opted[dev]) {
        const cudaError_t err = cudaFuncSetAttribute(
            fm_interaction_kernel<true>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
        if (err != cudaSuccess) return (int)err;
        if (dev < kMaxDevices) opted[dev] = 1;
      }
    }
    const int vec = aligned16(emb) && ((int64_t)E * F * D) % 4 == 0;
    fm_interaction_kernel<true><<<(unsigned)grid, kThreads, smem, st>>>(
        (const float*)emb, (float*)out, B, F, D, E, vec);
  } else {
    fm_interaction_kernel<false><<<(unsigned)grid, kThreads, 0, st>>>(
        (const float*)emb, (float*)out, B, F, D, E, 0);
  }
  return (int)cudaGetLastError();
}
