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
// For query b and row n, with e_s = lut[b, s, code(n, s)], the sum order
// that defines the bits:
//   class sums  c[r] = e_r + e_{r+32} + e_{r+64} + ... over s < S, in
//               ascending s from +0.0, for r = 0 .. 31 (a class that holds
//               no subspace is +0.0)
//   tree        c[i] = c[i] + c[i + h] for i < h, h = 16, 8, 4, 2, 1
//   sv2 = max(c[0], 0)
//   l2 mode:    out[b, n] = sv2
//   auto mode:  sa = sum_l mask[b, l] * max(qlo[b, l] - a_l, a_l - qhi[b, l], 0)
//               out[b, n] = (sv2 * p) * p,   p = 1 + sa * inv_alpha
// Every add is one __fadd_rn and the penalty __fmul_rn / __fadd_rn (never
// an fma), as the plain version (kernels/adc_scan/ref.py) computes it: the
// two agree bit for bit. For the 4-bit launcher code(n, s) is the low nibble
// of byte s / 2 for even s and the high nibble for odd s; given the same
// codes unpacked, both launchers run the same adds in the same order, so
// adc_scan4 on packed codes equals adc_scan on the unpacked codes bit for
// bit. Subspaces s >= S read table entries staged as +0.0, whatever the code
// (the pad nibble of odd S included); adding +0.0 to a class sum, which is
// never -0.0, changes no bit, so they count as absent.
//
// What bounds it on this card. At B = 128, N = 1M, S = 64 the bytes bound is
// about 0.17 ms (64 MB of codes read once, 512 MB of scores written) and the
// 8.2e9 adds take 0.12 ms at the f32 peak. But every add needs one table
// entry from shared memory, and an SM serves at most 32 four-byte lookups a
// clock (one conflict-free warp access): 8.2e9 / (132 SMs * 32 * 1.98 GHz)
// = 0.98 ms at the H100's maximum SM clock. That lookup ceiling bounds any
// design that keeps the tables in shared memory; chip_smoke.py prints it
// from the card's own clock beside the bytes bound. The design spends one
// conflict-free shared-memory access on each lookup and few instructions
// around it:
//
// - Tables transposed. A block stages the tables of bq queries in passes of
//   kPass slots: a 32-float row (128 bytes) holds one chunk of 32
//   subspaces, one code and one slot, and the kPass slots of a code lie 128
//   bytes apart. Entry (s, c) lies in bank s mod 32 whatever the code c, and
//   one address serves all slots of a pass (the slot's offset folds into
//   the load). Entries past S are +0.0. The staging reads 32 consecutive
//   subspaces a warp, one a lane, so its stores hit 32 banks too.
// - One row per lane, subspaces in a lane-rotated order. At step t of a
//   chunk, lane l looks up subspace 32 * chunk + (t + l) mod 32: the 32
//   lanes of a warp hit 32 distinct banks, so every lookup is one
//   wavefront, whatever the codes. Step t of lane l sums class (t + l) mod 32.
// - The halving tree pairs i with i + h mod 2h at every level; a rotation of
//   the 32 class sums maps those pairs onto themselves, and f32 addition is
//   commutative bit for bit. So the tree over the lane's steps, with static
//   register indices and no shuffles, gives the canonical bits in whichever
//   lane owns the row. A score depends on lut[b], codes[n] and the
//   attributes only, not on the lane, block, slice, B or N: the scanner is
//   batch- and position-invariant.
// - Codes. A lane loads its row's chunks (32 bytes each, 16 packed) with
//   16-byte loads where the row width and base allow, one row (or chunk)
//   ahead of the one it scores, rotates them by l code positions in
//   registers (word selects, then one funnel shift a word) and takes each
//   code with a shift and a mask.
// - kPass queries share one pass over a row (3 for 8-bit codes, 4 for
//   packed ones): the code, its rotated subspace and its address are
//   computed once a step for all of them. Up to S = 64 (two chunks) the
//   row's codes stay in registers for all passes, each step sums its class
//   whole (chunk 0, then chunk 1) and the tree is evaluated depth first, so
//   the classes come in bit-reversed order and each node is added as soon
//   as its halves are done: at most six partial sums a query are live.
//   Beyond S = 64 a pass walks the chunks with 32 class sums a query, one
//   query a pass. With three tables at K = 256, S = 64 (192 KB) a block
//   fills an SM's shared memory; at K = 16 a block holds kMaxQueries.
// - Registers set the threads: 512 a block, up to 128 registers each; more
//   threads spill (variant_sweep.py times the others).
// - grid.x runs over query groups and grid.y over row slices, so blocks with
//   neighbouring ids scan the same rows and the codes come from L2 after the
//   first read; consecutive lanes own consecutive rows, so the score writes
//   coalesce. The auto epilogue reads the row's attributes once a pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
// tables a block stages at most (fewer where they do not fit): 4 passes of
// 4 at K = 16 (variant_sweep.py at S = 64: 16 in passes of 4 beat 12 in
// passes of 3)
constexpr int kMaxQueries = 16;
// blocks aimed for per SM, over all query groups and row slices (8 beat 16
// and 32 in variant_sweep.py: each block stages its tables once)
constexpr int kBlocksPerSm = 8;

template <bool kPacked>
struct Chunk {  // the codes of 32 consecutive subspaces of one row
  static constexpr int kBytes = kPacked ? 16 : 32;
  static constexpr int kWords = kBytes / 4;
  static constexpr int kBits = kPacked ? 4 : 8;  // bits a code
  static constexpr int kPerWord = 32 / kBits;    // codes a word
};

// Chunk ch of a row of W code bytes, as words; bytes past W read as 0.
template <bool kPacked>
__device__ __forceinline__ void load_chunk(uint32_t (&v)[Chunk<kPacked>::kWords],
                                           const uint8_t* __restrict__ row, int ch, int W,
                                           bool vec) {
  constexpr int kWords = Chunk<kPacked>::kWords;
  const int b0 = ch * Chunk<kPacked>::kBytes;
  if (vec) {  // W % 16 == 0 and a 16-byte aligned base: whole 16-byte pieces
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (b0 + 16 * i < W) q = __ldg(reinterpret_cast<const uint4*>(row + b0 + 16 * i));
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int b = b0 + 4 * w + t;
        if (b < W) word |= (uint32_t)__ldg(row + b) << (8 * t);
      }
      v[w] = word;
    }
  }
}

// v[w] <- v[(w + q) mod kWords]: a rotation by q words in log2(kWords)
// stages of selects, every register index static (the loops count up by
// one, so they unroll).
template <int kWords>
__device__ __forceinline__ void rotate_words(uint32_t (&v)[kWords], int q) {
  constexpr int kStages = kWords == 8 ? 3 : 2;
  static_assert(kWords == 4 || kWords == 8, "a chunk is 4 or 8 words");
#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    const int step = 1 << k;
    const bool on = (q & step) != 0;
    uint32_t t[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) t[w] = on ? v[(w + step) % kWords] : v[w];
#pragma unroll
    for (int w = 0; w < kWords; ++w) v[w] = t[w];
  }
}

// One level of the halving tree: a[i] = a[i] + a[i + H] for i < H. A level
// a template, so every index is static once the loop unrolls.
template <int H>
__device__ __forceinline__ void fold(float (&a)[kLanes]) {
#pragma unroll
  for (int i = 0; i < H; ++i) a[i] = __fadd_rn(a[i], a[i + H]);
}

// One shared-memory load at byte address addr + kOffset (kOffset folds
// into the instruction).
template <int kOffset>
__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1+%2];" : "=f"(v) : "r"(addr), "n"(kOffset));
  return v;
}

// val[J] += the entry of slot J at addr: a pass's slots lie 128 bytes apart.
template <int J, int kPass>
__device__ __forceinline__ void lookup(float (&val)[kPass], uint32_t addr) {
  if constexpr (J < kPass) {
    val[J] = __fadd_rn(val[J], lds<J * 128>(addr));
    lookup<J + 1, kPass>(val, addr);
  }
}

// Stage tables b0 .. b0 + nq - 1 of lut (B, S, K) in passes of kPass slots:
// entry (s, c) of the table in slot j of pass p lies at float
//   (((p * chunks + s / 32) * K + c) * kPass + j) * 32 + s % 32,
// +0.0 for s >= S and for the slots past nq. So a 32-float row (128 bytes)
// holds the entries of one chunk, one code and one slot, entry (s, c) lies
// in bank s mod 32, and a pass's slots lie 128 bytes apart. A warp stages 32
// consecutive s (one a lane) and four consecutive c, so its stores hit 32
// banks.
template <int kPass>
__device__ __forceinline__ void stage_tables(float* tab, const float* __restrict__ lut, int b0,
                                             int nq, int slots, int S, int K, int chunks,
                                             int vec, int n_threads) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int warps = n_threads / kLanes;
  const int cq = (K + 3) / 4;
  const int tasks = slots * chunks * cq;
  // kInFlight tasks a warp at once: their loads are in flight together
  constexpr int kInFlight = 4;
  for (int first = threadIdx.x / kLanes; first < tasks; first += kInFlight * warps) {
    float e[kInFlight][4];
#pragma unroll
    for (int f = 0; f < kInFlight; ++f) {
      const int task = first + f * warps;
      const int c0 = 4 * (task % cq);
      const int ch = (task / cq) % chunks;
      const int j = task / (cq * chunks);
      const int s = ch * kLanes + lane;
#pragma unroll
      for (int k = 0; k < 4; ++k) e[f][k] = 0.f;
      if (task < tasks && s < S && j < nq) {
        const float* src = lut + ((size_t)(b0 + j) * S + s) * K + c0;
        if (vec) {
          const float4 g = __ldg(reinterpret_cast<const float4*>(src));
          e[f][0] = g.x;
          e[f][1] = g.y;
          e[f][2] = g.z;
          e[f][3] = g.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (c0 + k < K) e[f][k] = __ldg(src + k);
          }
        }
      }
    }
#pragma unroll
    for (int f = 0; f < kInFlight; ++f) {
      const int task = first + f * warps;
      if (task >= tasks) break;
      const int c0 = 4 * (task % cq);
      const int ch = (task / cq) % chunks;
      const int j = task / (cq * chunks);
      float* dst = tab + ((((size_t)(j / kPass) * chunks + ch) * K + c0) * kPass + j % kPass) *
                             kLanes + lane;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c0 + k < K) dst[(size_t)k * kPass * kLanes] = e[f][k];
      }
    }
  }
}

// Shared memory of a block: 128 bytes to align the tables, the tables of
// bq queries rounded up to whole passes, and each query's targets.
size_t smem_bytes(int S, int K, int L, int bq, int pass) {
  const size_t sp = (size_t)(S + kLanes - 1) / kLanes * kLanes;
  const size_t slots = (size_t)(bq + pass - 1) / pass * pass;
  return 128 + slots * (size_t)K * sp * sizeof(float) + (size_t)bq * L * sizeof(float4);
}

// Clamp, penalty and store of the queries in slots j0 .. j0 + kPass - 1 of
// the block's group, at row n; sum[jj] is the tree's result. The penalty
// reads the row's attributes once for the pass.
template <int kPass>
__device__ __forceinline__ void finish(const float (&sum)[kPass], int n, int j0, int nq, int b0,
                                       int N, int L, const int* __restrict__ xa,
                                       const float4* tg, float inv_alpha, int mode,
                                       float* __restrict__ out) {
  float sa[kPass];
#pragma unroll
  for (int jj = 0; jj < kPass; ++jj) sa[jj] = 0.f;
  if (mode == 1) {
    const int* a = xa + (size_t)n * L;
    for (int l = 0; l < L; ++l) {
      const float af = (float)__ldg(a + l);
#pragma unroll
      for (int jj = 0; jj < kPass; ++jj) {
        const float4 g = tg[min(j0 + jj, nq - 1) * L + l];
        const float gap = fmaxf(fmaxf(g.x - af, af - g.y), 0.f);
        sa[jj] = __fadd_rn(sa[jj], __fmul_rn(gap, g.z));
      }
    }
  }
#pragma unroll
  for (int jj = 0; jj < kPass; ++jj) {
    if (j0 + jj >= nq) continue;
    float sv2 = fmaxf(sum[jj], 0.f);
    if (mode == 1) {
      const float pen = __fadd_rn(1.f, __fmul_rn(sa[jj], inv_alpha));
      sv2 = __fmul_rn(__fmul_rn(sv2, pen), pen);
    }
    out[(size_t)(b0 + j0 + jj) * N + n] = sv2;
  }
}

// A row of kChunks <= 2 chunks with its codes in registers: win[c][u] holds
// the codes of steps P*u .. P*u + P - 1 of chunk c (P codes a word), already
// rotated by the lane; base[c] is the shared address of chunk c of the
// pass's tables.
template <bool kPacked, int kChunks>
struct Row {
  uint32_t win[kChunks][Chunk<kPacked>::kWords];
  uint32_t base[kChunks];
  uint32_t lane4;
};

// Class T of the pass's kPass queries, whole: chunk 0, then chunk 1, from
// +0.0. Step T of the lane looks up subspace 32 * c + (T + lane) mod 32.
template <int T, bool kPacked, int kPass, int kChunks>
__device__ __forceinline__ void class_sum(float (&val)[kPass], const Row<kPacked, kChunks>& r) {
  using C = Chunk<kPacked>;
  const uint32_t rot = (r.lane4 + 4u * T) & 127u;
#pragma unroll
  for (int jj = 0; jj < kPass; ++jj) val[jj] = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const uint32_t word = r.win[c][T / C::kPerWord];
    const uint32_t code = kPacked ? (word >> (4 * (T % C::kPerWord))) & 0xFu
                                  : __byte_perm(word, 0u, 0x4440u + T % C::kPerWord);
    lookup<0, kPass>(val, code * (kPass * kLanes * 4u) + (rot | r.base[c]));
  }
}

// Node (H, I) of the halving tree, H = 32 .. 1: the class sum I at H = 32,
// else node (2H, I) + node (2H, I + H). Node (1, 0) is the score. Written
// depth first, the classes come in bit-reversed order and each node is
// added as soon as its halves are done, so at most six partial sums a query
// are live; every node adds the same two operands as the canonical tree.
template <int H, int I, bool kPacked, int kPass, int kChunks>
__device__ __forceinline__ void tree_node(float (&out)[kPass], const Row<kPacked, kChunks>& r) {
  if constexpr (H == kLanes) {
    class_sum<I, kPacked, kPass, kChunks>(out, r);
  } else {
    float hi[kPass];
    tree_node<2 * H, I, kPacked, kPass, kChunks>(out, r);
    tree_node<2 * H, I + H, kPacked, kPass, kChunks>(hi, r);
#pragma unroll
    for (int jj = 0; jj < kPass; ++jj) out[jj] = __fadd_rn(out[jj], hi[jj]);
  }
}

template <bool kPacked, int kThreads, int kPass, int kChunks>
__global__ void __launch_bounds__(kThreads) adc_scan_kernel(
    const float* __restrict__ lut, const uint8_t* __restrict__ codes,
    const int* __restrict__ qlo, const int* __restrict__ qhi,
    const int* __restrict__ mask, const int* __restrict__ xa,
    float* __restrict__ out, int B, int N, int S, int K, int W, int L, int bq,
    float inv_alpha, int mode, int vec_lut, int vec_codes) {
  using C = Chunk<kPacked>;
  extern __shared__ __align__(16) float smem[];
  const int chunks = (S + kLanes - 1) / kLanes;
  const int passes = (bq + kPass - 1) / kPass;
  // the tables start at a 128-byte boundary of the shared window, so a
  // chunk's base address has its low 7 bits clear
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t tab_s = (raw + 127u) & ~127u;
  float* tab = smem + (tab_s - raw) / sizeof(float);
  float4* tg = reinterpret_cast<float4*>(tab + (size_t)passes * kPass * K * chunks * kLanes);
  const int b0 = blockIdx.x * bq;
  const int nq = min(bq, B - b0);
  const int lane = threadIdx.x & (kLanes - 1);

  // ---- stage the group's tables and targets (lo, hi, mask as floats)
  stage_tables<kPass>(tab, lut, b0, nq, passes * kPass, S, K, chunks, vec_lut, kThreads);
  for (int i = threadIdx.x; i < nq * L; i += kThreads) {
    const size_t g = (size_t)b0 * L + i;
    tg[i] = make_float4((float)qlo[g], (float)qhi[g], mask ? (float)mask[g] : 1.f, 0.f);
  }
  __syncthreads();

  // the lane's rotation: whole words, then the code positions within one
  const int rot_words = lane / C::kPerWord;
  const int rot_bits = C::kBits * (lane % C::kPerWord);
  const uint32_t lane4 = 4u * lane;
  const uint32_t chunk_bytes = (uint32_t)K * kPass * kLanes * 4u;
  const bool vec = vec_codes != 0;
  const int step = gridDim.y * kThreads;
  int n = blockIdx.y * kThreads + threadIdx.x;

  if constexpr (kChunks > 0) {
    // ---- S <= 64: the row's codes all in registers, loaded a row ahead
    uint32_t v[kChunks][C::kWords];
    if (n < N) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) load_chunk<kPacked>(v[c], codes + (size_t)n * W, c, W, vec);
    }
    for (; n < N; n += step) {
      uint32_t nxt[kChunks][C::kWords];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (n + step < N) {
          load_chunk<kPacked>(nxt[c], codes + (size_t)(n + step) * W, c, W, vec);
        } else {
#pragma unroll
          for (int w = 0; w < C::kWords; ++w) nxt[c][w] = 0u;
        }
        rotate_words(v[c], rot_words);
      }
      Row<kPacked, kChunks> r;
      r.lane4 = lane4;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
#pragma unroll
        for (int u = 0; u < C::kWords; ++u) {
          r.win[c][u] = __funnelshift_r(v[c][u], v[c][(u + 1) % C::kWords], rot_bits);
        }
#pragma unroll
        for (int w = 0; w < C::kWords; ++w) v[c][w] = nxt[c][w];
      }
      for (int p = 0; p < passes; ++p) {
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          r.base[c] = tab_s + (uint32_t)(p * kChunks + c) * chunk_bytes;
        }
        float sum[kPass];
        tree_node<1, 0, kPacked, kPass, kChunks>(sum, r);
        finish<kPass>(sum, n, p * kPass, nq, b0, N, L, xa, tg, inv_alpha, mode, out);
      }
    }
  } else {
    // ---- any S: a pass walks the row's chunks, 32 class sums a query in
    // registers, and loads the next (row, pass, chunk) item's codes while it
    // scores the current one
    uint32_t v[C::kWords];
    if (n < N) load_chunk<kPacked>(v, codes + (size_t)n * W, 0, W, vec);
    for (; n < N; n += step) {
      for (int p = 0; p < passes; ++p) {
        float acc[kPass][kLanes];
#pragma unroll
        for (int jj = 0; jj < kPass; ++jj) {
#pragma unroll
          for (int t = 0; t < kLanes; ++t) acc[jj][t] = 0.f;
        }
        for (int ch = 0; ch < chunks; ++ch) {
          const bool last = ch + 1 == chunks;
          const int n_next = last && p + 1 == passes ? n + step : n;
          uint32_t nxt[C::kWords];
          if (n_next < N) {
            load_chunk<kPacked>(nxt, codes + (size_t)n_next * W, last ? 0 : ch + 1, W, vec);
          } else {
#pragma unroll
            for (int w = 0; w < C::kWords; ++w) nxt[w] = 0u;
          }
          rotate_words(v, rot_words);
          const uint32_t base = tab_s + (uint32_t)(p * chunks + ch) * chunk_bytes;
#pragma unroll
          for (int u = 0; u < C::kWords; ++u) {
            const uint32_t win = __funnelshift_r(v[u], v[(u + 1) % C::kWords], rot_bits);
#pragma unroll
            for (int i = 0; i < C::kPerWord; ++i) {
              const int t = u * C::kPerWord + i;
              const uint32_t code = (win >> (C::kBits * i)) & ((1u << C::kBits) - 1u);
              // subspace 32 * ch + (t + lane) mod 32 of the code's row
              const uint32_t at =
                  code * (kPass * kLanes * 4u) + (((lane4 + 4u * t) & 127u) | base);
              float e[kPass];
#pragma unroll
              for (int jj = 0; jj < kPass; ++jj) e[jj] = acc[jj][t];
              lookup<0, kPass>(e, at);
#pragma unroll
              for (int jj = 0; jj < kPass; ++jj) acc[jj][t] = e[jj];
            }
          }
#pragma unroll
          for (int w = 0; w < C::kWords; ++w) v[w] = nxt[w];
        }
        float sum[kPass];
#pragma unroll
        for (int jj = 0; jj < kPass; ++jj) {
          fold<16>(acc[jj]);
          fold<8>(acc[jj]);
          fold<4>(acc[jj]);
          fold<2>(acc[jj]);
          fold<1>(acc[jj]);
          sum[jj] = acc[jj][0];
        }
        finish<kPass>(sum, n, p * kPass, nq, b0, N, L, xa, tg, inv_alpha, mode, out);
      }
    }
  }
}

struct Args {
  const void *lut, *codes, *qlo, *qhi, *mask, *xa;
  void* out;
  int B, N, S, K, W, L;
  float inv_alpha;
  int mode;
  void* stream;
};

template <bool kPacked, int kThreads, int kPass, int kChunks>
cudaError_t start(const Args& a, int bq, int blocks_per_sm, int n_sm) {
  const size_t smem = smem_bytes(a.S, a.K, a.L, bq, kPass);
  cudaError_t err = cudaFuncSetAttribute(adc_scan_kernel<kPacked, kThreads, kPass, kChunks>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int groups = (a.B + bq - 1) / bq;
  const int tiles = (a.N + kThreads - 1) / kThreads;
  int slices = (blocks_per_sm * n_sm + groups - 1) / groups;
  slices = slices < tiles ? slices : tiles;
  slices = slices < 65535 ? slices : 65535;
  const int vec_lut = (a.K % 4 == 0) && ((reinterpret_cast<uintptr_t>(a.lut) & 15) == 0);
  const int vec_codes = (a.W % 16 == 0) && ((reinterpret_cast<uintptr_t>(a.codes) & 15) == 0);
  adc_scan_kernel<kPacked, kThreads, kPass, kChunks>
      <<<dim3(groups, slices), kThreads, smem, (cudaStream_t)a.stream>>>(
          (const float*)a.lut, (const uint8_t*)a.codes, (const int*)a.qlo, (const int*)a.qhi,
          (const int*)a.mask, (const int*)a.xa, (float*)a.out, a.B, a.N, a.S, a.K, a.W, a.L,
          bq, a.inv_alpha, a.mode, vec_lut, vec_codes);
  return cudaGetLastError();
}

// The whole-row kernel for S <= 64: one chunk or two.
template <bool kPacked, int kThreads, int kPass>
cudaError_t start_rows(const Args& a, int bq, int blocks_per_sm, int n_sm) {
  return a.S <= kLanes ? start<kPacked, kThreads, kPass, 1>(a, bq, blocks_per_sm, n_sm)
                       : start<kPacked, kThreads, kPass, 2>(a, bq, blocks_per_sm, n_sm);
}

// (shared memory a block may opt into, SMs), or an error.
cudaError_t device_limits(int* smem_max, int* n_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

bool valid(bool packed, const Args& a) {
  return a.S > 0 && a.K > 0 && a.K <= 256 && a.L >= 0 && (!packed || a.K == 16);
}

// The launchers' pick: as many tables as fit a block, up to kMaxQueries,
// scored 3 a pass (4 for packed codes, whose rows take half the registers)
// or fewer where fewer fit; past S = 64, one a pass.
template <bool kPacked>
int launch(const Args& a) {
  if (a.B <= 0 || a.N <= 0) return 0;
  if (!valid(kPacked, a)) return (int)cudaErrorInvalidValue;
  int smem_max = 0, n_sm = 0;
  cudaError_t err = device_limits(&smem_max, &n_sm);
  if (err != cudaSuccess) return (int)err;
  const int whole = a.S <= 2 * kLanes;
  const int most = !whole ? 1 : kPacked ? 4 : 3;
  int bq = kMaxQueries < a.B ? kMaxQueries : a.B;
  while (bq > 0 && smem_bytes(a.S, a.K, a.L, bq, bq < most ? bq : most) > (size_t)smem_max) --bq;
  if (bq < 1) return (int)cudaErrorInvalidValue;  // one query's tables exceed shared memory
  const int pass = bq < most ? bq : most;
  if (!whole) return (int)start<kPacked, 512, 1, 0>(a, bq, kBlocksPerSm, n_sm);
  if constexpr (kPacked) {
    if (pass == 4) return (int)start_rows<kPacked, 512, 4>(a, bq, kBlocksPerSm, n_sm);
  }
  if (pass >= 3) return (int)start_rows<kPacked, 512, 3>(a, bq, kBlocksPerSm, n_sm);
  if (pass == 2) return (int)start_rows<kPacked, 512, 2>(a, bq, kBlocksPerSm, n_sm);
  return (int)start_rows<kPacked, 512, 1>(a, bq, kBlocksPerSm, n_sm);
}

Args make_args(const void* lut, const void* codes, const void* qlo, const void* qhi,
               const void* mask, const void* xa, void* out, int B, int N, int S, int K, int L,
               float inv_alpha, int mode, void* stream, bool packed) {
  return Args{lut, codes, qlo, qhi, mask, xa, out, B, N, S, K, packed ? (S + 1) / 2 : S, L,
              inv_alpha, mode, stream};
}

}  // namespace

extern "C" int adc_scan_launch(const void* lut, const void* codes, const void* qlo,
                               const void* qhi, const void* mask, const void* xa, void* out,
                               int B, int N, int S, int K, int L, float inv_alpha, int mode,
                               void* stream) {
  return launch<false>(make_args(lut, codes, qlo, qhi, mask, xa, out, B, N, S, K, L, inv_alpha,
                                 mode, stream, false));
}

extern "C" int adc_scan4_launch(const void* lut, const void* codes, const void* qlo,
                                const void* qhi, const void* mask, const void* xa, void* out,
                                int B, int N, int S, int K, int L, float inv_alpha, int mode,
                                void* stream) {
  return launch<true>(make_args(lut, codes, qlo, qhi, mask, xa, out, B, N, S, K, L, inv_alpha,
                                mode, stream, true));
}
