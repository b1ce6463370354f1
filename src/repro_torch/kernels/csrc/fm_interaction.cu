// fm_interaction.cu: the FM second-order term (the sum-square trick) and
// its gradient.
//
// Replaces the TPU kernel src/repro/kernels/fm_interaction/fm_interaction.py:
// fm_interaction_pallas (body _kernel l.26-30, call l.41), and on the main
// path its jnp twin fm_interaction_ref, which models/recsys.py _fm_forward
// calls for every CTR score of the fm model. The TPU kernel has no backward
// (the reference trains through XLA's autodiff of fm_interaction_ref); the
// backward here computes the same gradient in one pass.
//
// For example b with field embeddings e (F, D), contiguous as (B, F, D):
//   out[b] = 0.5 * sum_d [ (sum_f e_fd)^2 - sum_f e_fd^2 ]
// in the plain version's order (kernels/fm_interaction/ref.py):
//   s_d  = s_d + e_fd         and   sq_d = sq_d + (e_fd * e_fd)   for f = 0 .. F-1
//   t_d  = (s_d * s_d) - sq_d
//   acc  = acc + t_d                                              for d = 0 .. D-1
//   out  = 0.5 * acc
// and the gradient under an upstream g (B,), as the plain backward has it:
//   grad[b, f, d] = g_b * (s_d - e_fd)
// Every sum starts from +0 and every step is rounded on its own (__fadd_rn,
// __fmul_rn, __fsub_rn, never contracted into an fma), so both equal their
// plain versions bit for bit and depend on nothing but the example's own
// F x D values: the kernels are batch-invariant.
//
// What bounds them on this card: bytes. At serve_bulk (B = 262,144, F = 39,
// D = 10) the forward reads 409 MB once, about 0.122 ms at 3.35 TB/s; at
// train_batch (B = 65,536) the backward reads 102 MB and writes as much,
// 0.061 ms. Their ~3 * F * D flops an example take a few us at 67 TFLOP/s.
// At serve_p99 (B = 512, 0.8 MB) the launch sets the time.
//
// Design. D lanes an example: a warp splits into 32 / L groups of L lanes
// (the plan's; min(D, 32)), one example a group, and lane d keeps s_d and
// sq_d over the fields (a chain of 2F rounded adds instead of one thread's
// 2FD). The group then folds t_d over d = 0 .. D-1 in order, each lane
// taking the terms by __shfl_sync, so the fold order is the plain one.
// D > L loops the lanes over d in steps of L. Lane d of example x reads
// word x*F*D + f*D + d, so a group's loads are D consecutive words, issued
// 16 fields ahead of their adds (walk_column).
//
// Two paths, picked by the launch plan (kernels/fm_interaction/ops.py
// launch_plan, which the CPU tests check):
// - staged: a persistent grid of a few blocks an SM walks runs of E whole
//   examples (E * F * D contiguous floats, a multiple of 16 bytes) through
//   a ring of S shared-memory stages. Thread 0 fills a stage with one 1-D
//   bulk copy (cp.async.bulk ... mbarrier::complete_tx), completing on the
//   stage's mbarrier; every warp reduces from the stage while the next
//   S - 1 runs are in flight, then the block syncs and thread 0, after
//   fence.proxy.async, refills the stage. Only the batch's last run can
//   hold fewer than E examples; it reads device memory directly.
// - direct: blocks of a few warps read their examples straight from
//   device memory. It serves small batches (serve_p99: enough blocks to
//   cover the SMs, nothing to overlap), a base address off 16 bytes, and
//   an example larger than a stage.
// The backward runs the same paths: each lane sums its s_d, then reads its
// F values again to write the gradient. Staged, it writes over its own
// values in the stage and thread 0 stores the stage out with one bulk copy
// (cp.async.bulk ... bulk_group), refilling that stage one run later, once
// the store has read it; direct, it writes the rows of grad. Offsets are
// 64-bit throughout; any F and D work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kBarBytes = 128;        // the stages' mbarriers, ahead of the stages
constexpr int kSmemMax = 232448;      // 227 KB: a block's dynamic shared memory after opting in
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of `bar` with this parity to complete. A copy that
// never lands traps (a launch error) instead of spinning for ever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// One 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One 1-D bulk copy of `bytes` from shared memory out to device memory,
// in the thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until all but the newest kPending bulk groups have read their
// shared memory (kRead) or finished altogether.
template <int kPending, bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (kRead) {
    asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kPending) : "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group %0;" ::"n"(kPending) : "memory");
  }
}

// Order this thread's generic-proxy accesses of shared memory before the
// async proxy's (a bulk copy that refills or stores the stage).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <bool kShared>
__device__ __forceinline__ float load(const float* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// A lane walks its column of one example, values p[f * D] for f = 0 .. F-1,
// calling op(f, value) in order. Loads go out kChunk at a time ahead of
// their uses (a chunk past F re-reads the last row, so no load needs a
// predicate); loaded one by one beside its add, a column waits one memory
// latency a field.
constexpr int kChunk = 16;

template <bool kShared, typename Op>
__device__ __forceinline__ void walk_column(const float* p, int F, int D, Op op) {
  for (int f0 = 0; f0 < F; f0 += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int f = f0 + u < F ? f0 + u : F - 1;
      v[u] = load<kShared>(p + (int64_t)f * D);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (f0 + u < F) op(f0 + u, v[u]);
    }
  }
}

// Examples [0, nb) of a run at `src` (a stage, or device memory), the run's
// first example being example b0 of the batch. The forward writes out[b].
// The backward reads g[b] and writes the gradient: over its own values in
// the stage (kShared; the block then stores the stage out), else to the
// rows of grad at `out`.
template <bool kBwd, bool kShared>
__device__ __forceinline__ void fm_run(const float* src, int64_t b0, int nb, int F, int D, int L,
                                       const float* __restrict__ g, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = 32 / L;  // examples a warp of L lanes an example
  const int grp = lane / L, j = lane - grp * L;
  const int step = (int)(blockDim.x >> 5) * G;  // examples a pass of the block
  const int64_t fd = (int64_t)F * D;
  for (int base = warp * G; base < nb; base += step) {  // warp-uniform
    const int x = base + grp;
    const bool live = grp < G && x < nb;
    const float* e = src + (int64_t)x * fd;
    if constexpr (kBwd) {
      if (!live) continue;
      const float gx = __ldg(g + b0 + x);
      float* o = kShared ? const_cast<float*>(e) : out + (b0 + x) * fd;
      for (int d = j; d < D; d += L) {
        float s = 0.f;
        walk_column<kShared>(e + d, F, D, [&](int, float v) { s = __fadd_rn(s, v); });
        walk_column<kShared>(e + d, F, D, [&](int f, float v) {
          o[(int64_t)f * D + d] = __fmul_rn(gx, __fsub_rn(s, v));
        });
      }
    } else {
      float acc = 0.f;
      for (int d0 = 0; d0 < D; d0 += L) {  // one round unless D > L
        const int d = d0 + j;
        float s = 0.f, sq = 0.f;
        if (live && d < D) {
          walk_column<kShared>(e + d, F, D, [&](int, float v) {
            s = __fadd_rn(s, v);
            sq = __fadd_rn(sq, __fmul_rn(v, v));
          });
        }
        const float t = __fsub_rn(__fmul_rn(s, s), sq);
        // fold the group's terms in order, 8 shuffles out ahead of their adds
        const int n = D - d0 < L ? D - d0 : L;
        for (int k0 = 0; k0 < n; k0 += 8) {
          float w[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) w[u] = __shfl_sync(kFull, t, grp * L + min(k0 + u, n - 1));
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (k0 + u < n) acc = __fadd_rn(acc, w[u]);
          }
        }
      }
      if (live && j == 0) out[b0 + x] = __fmul_rn(0.5f, acc);
    }
  }
}

// Blocks take runs blockIdx.x, blockIdx.x + gridDim.x, ... of E examples
// and read them straight from device memory.
template <bool kBwd>
__device__ __forceinline__ void direct_body(const float* __restrict__ emb,
                                            const float* __restrict__ g, float* __restrict__ out,
                                            int B, int F, int D, int L, int E) {
  const int64_t fd = (int64_t)F * D;
  for (int64_t r = blockIdx.x; r * E < B; r += gridDim.x) {
    const int64_t b0 = r * E;
    const int nb = (int)((int64_t)B - b0 < E ? (int64_t)B - b0 : E);
    fm_run<kBwd, false>(emb + b0 * fd, b0, nb, F, D, L, g, out);
  }
}

// The persistent ring: the same runs, each full one staged by a bulk copy
// into stage i % S and reduced from there.
template <bool kBwd>
__device__ __forceinline__ void staged_body(const float* __restrict__ emb,
                                            const float* __restrict__ g, float* __restrict__ out,
                                            int B, int F, int D, int L, int E, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* stage = reinterpret_cast<float*>(smem + kBarBytes);
  const int64_t fd = (int64_t)F * D;
  const int64_t run = (int64_t)E * fd;  // floats a run
  const uint32_t bytes = (uint32_t)(run * (int64_t)sizeof(float));
  const int64_t full_runs = (int64_t)B / E;  // the runs that hold E examples
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // thread 0: start the copy of this block's i-th run into stage i % S
  auto fill = [&](int i) {
    const int64_t r = blockIdx.x + (int64_t)i * gridDim.x;
    if (r >= full_runs) return;  // absent, or the partial last run
    const int s = i % S;
    mbar_expect_tx(&bar[s], bytes);
    bulk_load(stage + s * run, emb + r * run, bytes, &bar[s]);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) fill(i);
  }
  for (int i = 0;; ++i) {
    const int64_t r = blockIdx.x + (int64_t)i * gridDim.x;
    const int64_t b0 = r * E;
    if (b0 >= B) break;
    if (r < full_runs) {
      const int s = i % S;
      mbar_wait(&bar[s], (uint32_t)((i / S) & 1));
      fm_run<kBwd, true>(stage + s * run, b0, E, F, D, L, g, out);
      if constexpr (kBwd) fence_proxy_async();  // the gradient written, before the store reads it
      __syncthreads();  // every warp is done with stage s
      if (threadIdx.x == 0) {
        if constexpr (kBwd) {
          // store the gradient out; refill the stage stored one run ago
          // once that store has read it
          bulk_store(out + r * run, stage + s * run, bytes);
          bulk_wait<1, true>();
          if (i > 0) fill(i - 1 + S);
        } else {
          fence_proxy_async();  // the threads' reads, before the refill
          fill(i + S);
        }
      }
    } else {  // the batch's last, partial run (a block's last run)
      fm_run<kBwd, false>(emb + b0 * fd, b0, (int)((int64_t)B - b0), F, D, L, g, out);
    }
  }
  if constexpr (kBwd) {
    if (threadIdx.x == 0) bulk_wait<0, false>();  // the stores, before the stages go
  }
}

// The forward and the backward, each on either path (the names the
// profiler reports).
template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
    fm_interaction_kernel(const float* __restrict__ emb, float* __restrict__ out, int B, int F,
                          int D, int L, int E, int S) {
  if constexpr (kStaged) {
    staged_body<false>(emb, nullptr, out, B, F, D, L, E, S);
  } else {
    direct_body<false>(emb, nullptr, out, B, F, D, L, E);
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
    fm_interaction_bwd_kernel(const float* __restrict__ emb, const float* __restrict__ g,
                              float* __restrict__ grad, int B, int F, int D, int L, int E,
                              int S) {
  if constexpr (kStaged) {
    staged_body<true>(emb, g, grad, B, F, D, L, E, S);
  } else {
    direct_body<true>(emb, g, grad, B, F, D, L, E);
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Opt a staged kernel in to more than 48 KB of dynamic shared memory, once
// a device. Not a stream operation: it may run inside a graph capture
// (tests/test_torch_cuda.py makes its first call there).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int* opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && opted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess && dev < kMaxDevices) opted[dev] = 1;
  return err;
}

// The plan (staged, E examples a run, grid, S stages, threads a block, L
// lanes an example, smem bytes of dynamic shared memory) comes from ops.py
// launch_plan; the kernels run it as given. A plan they cannot run (a
// staged block whose smem does not hold its barriers and S runs, say) is
// refused with cudaErrorInvalidValue and launches nothing.
template <bool kBwd>
int launch(const void* emb, const void* g, void* out, int B, int F, int D, int staged, int E,
           int grid, int S, int threads, int L, int smem, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (F <= 0 || D <= 0) {  // an empty sum: the forward's terms are 0, the gradient is empty
    return kBwd ? 0 : (int)cudaMemsetAsync(out, 0, (size_t)B * sizeof(float), st);
  }
  if (E <= 0 || grid <= 0 || threads < 32 || threads > kMaxThreads || threads % 32 || L < 1 ||
      L > 32)
    return (int)cudaErrorInvalidValue;
  const float* e = (const float*)emb;
  const float* gp = (const float*)g;
  float* o = (float*)out;
  if (staged) {
    const int64_t run_bytes = (int64_t)E * F * D * (int64_t)sizeof(float);
    if (S < (kBwd ? 2 : 1) || S > kBarBytes / 8 || run_bytes % 16 || !aligned16(emb) ||
        (kBwd && !aligned16(out)) || smem < kBarBytes + (int64_t)S * run_bytes || smem > kSmemMax)
      return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      static int opted[kMaxDevices];
      const cudaError_t err = kBwd ? opt_in(fm_interaction_bwd_kernel<true>, opted)
                                   : opt_in(fm_interaction_kernel<true>, opted);
      if (err != cudaSuccess) return (int)err;
    }
    if constexpr (kBwd) {
      fm_interaction_bwd_kernel<true><<<(unsigned)grid, threads, (size_t)smem, st>>>(
          e, gp, o, B, F, D, L, E, S);
    } else {
      fm_interaction_kernel<true><<<(unsigned)grid, threads, (size_t)smem, st>>>(e, o, B, F, D, L,
                                                                                E, S);
    }
  } else if (smem != 0) {
    return (int)cudaErrorInvalidValue;
  } else if constexpr (kBwd) {
    fm_interaction_bwd_kernel<false><<<(unsigned)grid, threads, 0, st>>>(e, gp, o, B, F, D, L, E,
                                                                          0);
  } else {
    fm_interaction_kernel<false><<<(unsigned)grid, threads, 0, st>>>(e, o, B, F, D, L, E, 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fm_interaction_launch(const void* emb, void* out, int B, int F, int D, int staged,
                                     int E, int grid, int stages, int threads, int lanes, int smem,
                                     void* stream) {
  return launch<false>(emb, nullptr, out, B, F, D, staged, E, grid, stages, threads, lanes, smem,
                       stream);
}

extern "C" int fm_interaction_bwd_launch(const void* emb, const void* g, void* grad, int B, int F,
                                         int D, int staged, int E, int grid, int stages,
                                         int threads, int lanes, int smem, void* stream) {
  return launch<true>(emb, g, grad, B, F, D, staged, E, grid, stages, threads, lanes, smem,
                      stream);
}
