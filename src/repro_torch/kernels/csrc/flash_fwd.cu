// Flash attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd_pallas through pl.pallas_call).  It computes the
// same function: blockwise online-softmax GQA attention with
// kv_head = h / (H / KV), difference-based causal and window masks, optional
// int32 kv_positions with q_offset, f32 accumulation, outputs o (q's dtype)
// and lse (f32).  The plain version is repro_torch/kernels/ref.py::
// flash_attention_ref.
//
// Layout is the JAX package's: q [B,S,H,D], k/v [B,T,KV,D], o [B,S,H,D],
// lse [B,S,H].  q/k/v are indexed through their batch, sequence and head
// strides (the last dim must be contiguous), so the caller makes no
// transposes; o and lse are written contiguous.
//
// What bounds it on an H100: at the serving prefill shape (B = 4,
// S = T = 2048, H = 32, KV = 8, D = 128, bf16, causal) attention does about
// 815 FLOP per byte it must move, above the card's ~295 FLOP/byte ridge, so
// the bound is arithmetic (0.139 ms at the bf16 tensor-core peak).  Two
// kernels, chosen by dtype in the C entry point:
//
// bf16 -> flash_fwd_kernel_tc, on the tensor cores (hopper.cuh):
//   * a block owns a 128-row q tile of one (head, batch): two consumer
//     warpgroups of 64 rows and a producer warpgroup, which gives its
//     registers to the consumers (setmaxnreg: 40 and 232 a thread) and
//     whose first warp issues every load;
//   * the producer loads the q tile once and K and V tiles of 128 rows into
//     a ring of 3 (D = 128) or 4 stages, each by TMA (128B/64B/32B swizzle
//     set by the head dim; D = 8 is padded to 16 by TMA's zero fill),
//     completing on per-stage mbarriers; consumers release a stage on
//     another;
//   * S = Q K^T is wgmma m64n128k16 with both operands K-major in shared
//     memory; O += P V is wgmma m64nDk16 with P from registers (the S
//     accumulator, rounded to bf16) and V MN-major (the transpose bit);
//   * each consumer issues tile j's S, then tile j-1's P V, and computes
//     tile j's softmax while P V runs on the tensor cores;
//   * the softmax scale is applied in f32 (p = exp2(s * scale * log2 e -
//     m) as one FFMA, never to bf16 q); row max and sum are f32, from the
//     f32 probabilities, the max reduced over the 4 lanes of a quad that
//     share a row, the sum kept per lane until the end;
//   * the producer decides which KV tiles a block visits: a tile no row can
//     see is skipped (block-uniform test on its position min/max), a tile
//     every row sees wholly is marked unmasked (its softmax then runs with
//     no per-element test), and a last marker ends the consumers' loop;
//     with kv_positions it stages the tile's positions in shared memory
//     beside the tile; heavy causal tiles are scheduled first.
//   At the prefill shape it takes 0.378 ms (364 TFLOP/s), at qwen1.5-0.5b's
//   training shape (H = KV = 16, D = 64) 0.169 ms (H100 80GB HBM3 at
//   700 W, chip_smoke.py).
// f32 -> flash_fwd_kernel, f32 FMAs on the CUDA cores (67 TFLOP/s peak),
// for the f32 checks (TF32 would break their tolerances).  Its inner
// loops are limited by shared-memory reads: each thread computes a 4 x 4
// tile of S = Q K^T from four q and four k values per step (8 loads for
// 16 FMAs) and a 4 x D/16 tile of O = P V.  One thread block per
// (q tile of 64 rows, head, batch), K/V tiles of 64 rows staged through
// shared memory, the same tile skipping, rows padded to an odd length
// against bank conflicts.
//
// Rows with no visible key (possible only with q_offset, kv_positions or a
// window) get o = 0 and lse <= -1e29: masked probabilities are exactly 0,
// so such a row accumulates nothing.  Ragged S and T (not a multiple of the
// tile) are masked here (the bf16 path reads zeros past the ends through
// TMA); the kernels have no fallback.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BKV = 64;           // key rows per tile
constexpr int TX = 16;            // threads across key columns / head dims
constexpr int TY = 16;            // threads across query rows
constexpr int NTHREADS = TX * TY;
constexpr int RPT = BQ / TY;      // query rows per thread (ty + i*TY)
constexpr int CPT = BKV / TX;     // key columns per thread (tx + j*TX)
constexpr int PSTRIDE = BKV + 1;  // padded row of the probability tile
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_pos;   // [T] or nullptr (then kv position = column index)
  void* o;
  float* lse;
  int S, T, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
  int causal, window, q_offset;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Reductions over the 16 threads (one half-warp) that share a query row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (D + 1) + size_t(BKV) * (D + 1) +
                          size_t(BKV) * D + size_t(BQ) * PSTRIDE) +
         sizeof(int) * BKV;
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const Args a) {
  constexpr int QS = D + 1;                  // padded q row
  constexpr int KS = D + 1;                  // padded k row
  constexpr int OPT = (D + TX - 1) / TX;     // head dims per thread in O
  extern __shared__ float smem[];
  float* Qs = smem;                          // [BQ][QS]  scaled q
  float* Ks = Qs + BQ * QS;                  // [BKV][KS]
  float* Vs = Ks + BKV * KS;                 // [BKV][D]
  float* Ps = Vs + BKV * D;                  // [BQ][PSTRIDE]
  int* Pos = reinterpret_cast<int*>(Ps + BQ * PSTRIDE);   // [BKV]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int iq = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int q0 = iq * BQ;
  const int nrows = min(BQ, a.S - q0);
  const int q_lo = a.q_offset + q0;
  const int q_hi = q_lo + nrows - 1;

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    Qs[r * QS + d] =
        r < nrows ? to_float(qg[(q0 + r) * a.q_ss + d]) * a.scale : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[i][j] = 0.f;
  }

  const int ntiles = (a.T + BKV - 1) / BKV;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BKV;
    const int ncols = min(BKV, a.T - k0);
    // every thread is done with the previous tile's Pos, Ks, Vs and Ps
    __syncthreads();
    int lo, hi;
    if (a.kv_pos != nullptr) {
      if (tid < BKV) Pos[tid] = tid < ncols ? a.kv_pos[k0 + tid] : 0;
      __syncthreads();
      lo = INT_MAX;
      hi = INT_MIN;
      for (int c = 0; c < ncols; ++c) {
        lo = min(lo, Pos[c]);
        hi = max(hi, Pos[c]);
      }
    } else {
      lo = k0;
      hi = k0 + ncols - 1;
    }
    // block-uniform skip of a tile no row of this block can see
    if (a.causal && lo > q_hi) continue;
    if (a.window > 0 && q_lo - hi >= a.window) continue;

    for (int i = tid; i < BKV * D; i += NTHREADS) {
      const int c = i / D, d = i % D;
      const bool in = c < ncols;
      Ks[c * KS + d] = in ? to_float(kg[(k0 + c) * a.k_ss + d]) : 0.f;
      Vs[c * D + d] = in ? to_float(vg[(k0 + c) * a.v_ss + d]) : 0.f;
    }
    __syncthreads();

    // S = (q * scale) K^T for rows ty + i*TY, columns tx + j*TX
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + i * TY) * QS + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + j * TX) * KS + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax, P tile to shared memory
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + i * TY;
      const int qp = q_lo + r;
      bool vis[CPT];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + j * TX;
        const int kp = a.kv_pos != nullptr ? Pos[c] : k0 + c;
        bool ok = c < ncols;
        if (a.causal) ok = ok && qp >= kp;
        if (a.window > 0) ok = ok && qp - kp < a.window;
        vis[j] = ok;
        if (ok) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        ps += p;
        Ps[r * PSTRIDE + tx + j * TX] = p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OPT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // O += P V for rows ty + i*TY, head dims tx + j*TX
#pragma unroll 4
    for (int c = 0; c < ncols; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + i * TY) * PSTRIDE + c];
#pragma unroll
      for (int j = 0; j < OPT; ++j) {
        const int d = tx + j * TX;
        if (D % TX == 0 || d < D) {
          const float vv = Vs[c * D + d];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  T* og = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + i * TY;
    if (r >= nrows) continue;
    const float ll = fmaxf(l[i], 1e-30f);
    const long long row = (static_cast<long long>(b) * a.S + q0 + r) * a.H + h;
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int d = tx + j * TX;
      if (D % TX == 0 || d < D) og[row * D + d] = from_float<T>(acc[i][j] / ll);
    }
    if (tx == 0) a.lse[row] = m[i] + logf(ll);
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(a, B, stream);
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------- bf16, tensor cores
namespace tc {

constexpr int BQ = 128;               // q rows per block: 2 warpgroups of 64
constexpr int BKV = 128;              // key rows per tile
constexpr int NCONS = 256;            // consumer threads
constexpr int NTHREADS = NCONS + 128; // and a producer warpgroup
constexpr int PROD_REGS = 40;         // 128 x 40 + 256 x 232 <= 65536
constexpr int CONS_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Args {
  hopper::TensorMap qmap, kmap, vmap;   // 4-d: (d, row, head, batch)
  const int* kv_pos;
  __nv_bfloat16* o;
  float* lse;
  int S, T, H, KV;
  float scale_log2;                     // softmax scale * log2(e)
  int causal, window, q_offset;
};

// Shared-memory geometry for head dim D.  A tile is CB column blocks of SW
// bytes a row; every block starts on a 1024-byte boundary.
template <int D>
struct Geo {
  static constexpr int DP = D < 16 ? 16 : D;              // padded head dim
  static constexpr int SW = 2 * DP < 128 ? 2 * DP : 128;  // swizzle bytes
  static constexpr int CB = 2 * DP / SW;                  // column blocks
  static constexpr int Q_BLOCK = BQ * SW;
  static constexpr int KV_BLOCK = BKV * SW;
  static constexpr int Q_BYTES = CB * Q_BLOCK;
  static constexpr int KV_BYTES = CB * KV_BLOCK;
  // K/V ring: as deep as shared memory allows, up to 4 (3 at D = 128)
  static constexpr int STAGES = D == 128 ? 3 : 4;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_POS = OFF_V + STAGES * KV_BYTES;    // [STAGES][BKV]
  static constexpr int OFF_INFO = OFF_POS + STAGES * BKV * 4;  // [STAGES][2]
  static constexpr int OFF_BAR = OFF_INFO + STAGES * 8;
  static constexpr int SMEM = 1024 + OFF_BAR + 8 * (1 + 3 * STAGES);
  static_assert(SMEM <= 232448, "K/V ring does not fit in shared memory");
};

template <int STAGES>
__device__ __forceinline__ void wait_v(uint64_t* v_full, int it) {
  hopper::mbar_wait(&v_full[it % STAGES], (it / STAGES) & 1);
}

template <int STAGES>
__device__ __forceinline__ void release(uint64_t* empty, int it) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&empty[it % STAGES]);
}

// Issues O += P V for the tile at ring counter `it` (P in registers, V
// MN-major) as a stage of its own, and commits it.  The caller has waited
// for V (wait_v) before issuing the S that precedes it: a wait loop
// between two products keeps ptxas from seeing which of them a later
// wgmma_wait<1> retires, and it then serialises them.
template <int D>
__device__ __forceinline__ void pv(float (&o)[Geo<D>::DP / 2],
                                   uint32_t (&pf)[BKV / 16][4], char* Vs,
                                   int it) {
  using namespace hopper;
  using G = Geo<D>;
  const int st = it % G::STAGES;
  fence_regs(o);
  fence_regs(pf);
  wgmma_fence();
  const uint32_t v_addr = smem_addr(Vs + st * G::KV_BYTES);
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    Wgmma<G::DP>::template rs<1>(
        o, pf[kk],
        smem_desc(v_addr + kk * 16 * G::SW, G::SW, G::KV_BLOCK, 8 * G::SW),
        1);
  wgmma_commit();
}

// P (f32, in S's accumulator layout) -> the A operand of P V, in bf16.
__device__ __forceinline__ void pack(const float (&p)[BKV / 2],
                                     uint32_t (&pf)[BKV / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pf[kk][j] = hopper::pack_bf16x2(p[8 * kk + 2 * j], p[8 * kk + 2 * j + 1]);
}

// One consumer thread's view of the K tiles: issues S = Q K^T for the tile
// at ring counter `it`, and turns its scores into probabilities.
template <int D>
struct Tile {
  using G = Geo<D>;
  const Args& a;
  char* Qs;
  char* Ks;
  const int* Pos;
  const int* Info;
  uint64_t* k_full;
  uint32_t q_addr;
  int row0, q_lo;

  // Waits for the tile; false at the end marker.  Otherwise issues and
  // commits S (its first k-step overwrites s, so nothing else writes s: a
  // write could land while the previous P V is in flight).
  __device__ __forceinline__ bool issue_s(float (&s)[BKV / 2], int it) {
    using namespace hopper;
    const int st = it % G::STAGES;
    mbar_wait(&k_full[st], (it / G::STAGES) & 1);
    if (Info[2 * st] < 0) return false;
    wgmma_fence();
    const uint32_t k_addr = smem_addr(Ks + st * G::KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < G::DP / 16; ++kk) {
      const int cb = kk * 32 / G::SW, in = kk * 32 % G::SW;
      Wgmma<BKV>::template ss<0>(
          s, smem_desc(q_addr + cb * G::Q_BLOCK + in, G::SW, 0, 8 * G::SW),
          smem_desc(k_addr + cb * G::KV_BLOCK + in, G::SW, 0, 8 * G::SW),
          kk > 0);
    }
    wgmma_commit();
    return true;
  }

  // Mask and online softmax in the log2 domain: the row max of the raw
  // scores, scaled once; p = exp2(s * scale - m) as one FFMA.  s is read,
  // never written.  Updates m and the per-lane sums, returns the factor
  // by which O must be rescaled.  A tile that every row sees wholly takes
  // the unmasked instance.
  __device__ __forceinline__ void probs(const float (&s)[BKV / 2],
                                        float (&p)[BKV / 2], float (&m)[2],
                                        float (&lsum)[2], float (&corr)[2],
                                        int it) const {
    if (Info[2 * (it % G::STAGES) + 1])
      probs<true>(s, p, m, lsum, corr, it);
    else
      probs<false>(s, p, m, lsum, corr, it);
  }

  template <bool MASKED>
  __device__ __forceinline__ void probs(const float (&s)[BKV / 2],
                                        float (&p)[BKV / 2], float (&m)[2],
                                        float (&lsum)[2], float (&corr)[2],
                                        int it) const {
    const int st = it % G::STAGES;
    const int l = threadIdx.x % 32;
    uint64_t vis = ~0ull;          // bit i: register i's key is visible
    if (MASKED) {
      const int k0 = Info[2 * st] * BKV;
      vis = 0;
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int c = 8 * (i / 4) + 2 * (l % 4) + i % 2;
        const int qp = q_lo + row0 + 8 * ((i / 2) % 2);
        const int kp = a.kv_pos != nullptr ? Pos[st * BKV + c] : k0 + c;
        bool ok = k0 + c < a.T;
        if (a.causal) ok = ok && qp >= kp;
        if (a.window > 0) ok = ok && qp - kp < a.window;
        vis |= uint64_t(ok) << i;
      }
    }
    float mx[2] = {NEG_INF, NEG_INF}, mneg[2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i)
      if (!MASKED || ((vis >> i) & 1))
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mnew =
          fmaxf(m[r], mx[r] == NEG_INF ? NEG_INF : mx[r] * a.scale_log2);
      corr[r] = exp2f(m[r] - mnew);
      m[r] = mnew;
      mneg[r] = -mnew;
      lsum[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int r = (i / 2) % 2;
      p[i] = (!MASKED || ((vis >> i) & 1))
                 ? exp2f(fmaf(s[i], a.scale_log2, mneg[r]))
                 : 0.f;
      lsum[r] += p[i];
    }
  }
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_kernel_tc(const __grid_constant__ Args a) {
  using namespace hopper;
  using G = Geo<D>;
  constexpr int DP = G::DP, SW = G::SW, STAGES = G::STAGES;
  extern __shared__ float smem[];
  const uint32_t s0 = smem_addr(smem);
  char* base = reinterpret_cast<char*>(smem) + ((1024 - (s0 & 1023)) & 1023);
  char* Qs = base;
  char* Ks = base + G::OFF_K;
  char* Vs = base + G::OFF_V;
  int* Pos = reinterpret_cast<int*>(base + G::OFF_POS);
  int* Info = reinterpret_cast<int*>(base + G::OFF_INFO);   // tile, masked
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + G::OFF_BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int tid = threadIdx.x;
  const int iq = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int q0 = iq * BQ;
  const int nrows = min(BQ, a.S - q0);
  const int q_lo = a.q_offset + q0;
  const int q_hi = q_lo + nrows - 1;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&empty[st], NCONS / 32);   // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NCONS) {
    // ---- producer warpgroup: its first warp loads q once, then the
    // visible K/V tiles, then an end marker; the other three leave
    setmaxnreg_dec<PROD_REGS>();
    if (tid >= NCONS + 32) return;
    const int lane = tid - NCONS;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, G::Q_BYTES);
      for (int c = 0; c < G::CB; ++c)
        tma_load_4d(Qs + c * G::Q_BLOCK, &a.qmap, q_full, c * (SW / 2), q0,
                    h, b);
    }
    const int ntiles = (a.T + BKV - 1) / BKV;
    int it = 0;
    for (int t = 0; t <= ntiles; ++t) {
      const bool end = t == ntiles;
      const int k0 = t * BKV;
      int ncols = 0, masked = 0;
      if (!end) {
        ncols = min(BKV, a.T - k0);
        int lo, hi;
        if (a.kv_pos != nullptr) {
          lo = INT_MAX;
          hi = INT_MIN;
          for (int c = lane; c < ncols; c += 32) {
            const int p = a.kv_pos[k0 + c];
            lo = min(lo, p);
            hi = max(hi, p);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
            hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
          }
        } else {
          lo = k0;
          hi = k0 + ncols - 1;
        }
        // block-uniform skip of a tile no row of this block can see
        if (a.causal && lo > q_hi) continue;
        if (a.window > 0 && q_lo - hi >= a.window) continue;
        masked = ncols < BKV || (a.causal && hi > q_lo) ||
                 (a.window > 0 && q_hi - lo >= a.window);
      }
      const int st = it % STAGES;
      mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
      if (!end && a.kv_pos != nullptr)
        for (int c = lane; c < BKV; c += 32)
          Pos[st * BKV + c] = c < ncols ? a.kv_pos[k0 + c] : 0;
      if (lane == 0) {
        Info[2 * st] = end ? -1 : t;
        Info[2 * st + 1] = masked;
      }
      __syncwarp();
      if (lane == 0) {
        if (end) {
          mbar_arrive(&k_full[st]);
        } else {
          mbar_arrive_expect_tx(&k_full[st], G::KV_BYTES);
          for (int c = 0; c < G::CB; ++c)
            tma_load_4d(Ks + st * G::KV_BYTES + c * G::KV_BLOCK, &a.kmap,
                        &k_full[st], c * (SW / 2), k0, kvh, b);
          mbar_arrive_expect_tx(&v_full[st], G::KV_BYTES);
          for (int c = 0; c < G::CB; ++c)
            tma_load_4d(Vs + st * G::KV_BYTES + c * G::KV_BLOCK, &a.vmap,
                        &v_full[st], c * (SW / 2), k0, kvh, b);
        }
      }
      ++it;
    }
  } else {
    // ---- consumer warpgroup g: q rows g*64 .. g*64 + 63 of the tile.
    // Tile j's S = Q K^T is issued, then tile j-1's O += P V; the softmax of
    // tile j runs while P V is on the tensor cores.  The first tile is
    // peeled off the loop, so the loop body has no branch on whether a
    // P V is pending (the compiler cannot correlate two such branches and
    // would serialise the products).
    setmaxnreg_inc<CONS_REGS>();
    const int g = tid / 128;
    const int l = tid % 32;
    const int row0 = g * 64 + 16 * ((tid % 128) / 32) + l / 4;
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, lsum[2] = {0.f, 0.f};
    uint32_t pf[BKV / 16][4];       // P of the tile whose P V is pending
    const uint32_t q_addr = smem_addr(Qs) + g * 64 * SW;
    Tile<D> tile{a, Qs, Ks, Pos, Info, k_full, q_addr, row0, q_lo};
    mbar_wait(q_full, 0);
    float s0[BKV / 2], p0[BKV / 2], corr[2];
    if (tile.issue_s(s0, 0)) {
      wgmma_wait<0>();
      fence_regs(s0);
      tile.probs(s0, p0, m, lsum, corr, 0);   // O is 0: corr is moot
      pack(p0, pf);
      fence_regs(pf);
      int prev = 0;
      for (int it = 1;; ++it) {
        float s[BKV / 2];           // per tile: no copy across iterations
        wait_v<STAGES>(v_full, prev);
        if (!tile.issue_s(s, it)) break;
        pv<D>(o, pf, Vs, prev);
        wgmma_wait<1>();            // S is done; P V may still run
        fence_regs(s);
        float p[BKV / 2];
        tile.probs(s, p, m, lsum, corr, it);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pf);
        release<STAGES>(empty, prev);
        // P V has retired: rescale O, write this tile's P as its A operand
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i / 2) % 2];
        pack(p, pf);
        fence_regs(o);
        fence_regs(pf);
        prev = it;
      }
      wait_v<STAGES>(v_full, prev);   // passed already: a phase stays done
      pv<D>(o, pf, Vs, prev);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pf);
      release<STAGES>(empty, prev);
    }

    // o / l and lse; the sum is reduced over the quad here
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = lsum[r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      lsum[r] = fmaxf(lt, 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int r = (i / 2) % 2;
      const int row = row0 + 8 * r;
      const int col = 8 * (i / 4) + 2 * (l % 4);
      if (row < nrows && col < D) {
        const long long orow =
            (static_cast<long long>(b) * a.S + q0 + row) * a.H + h;
        *reinterpret_cast<uint32_t*>(a.o + orow * D + col) =
            pack_bf16x2(o[i] / lsum[r], o[i + 1] / lsum[r]);
      }
    }
    if (l % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < nrows) {
          const long long orow =
              (static_cast<long long>(b) * a.S + q0 + row) * a.H + h;
          a.lse[orow] = m[r] * LN2 + logf(lsum[r]);
        }
      }
    }
  }
}

// Byte stride of a dimension for its tensor map: a dimension of size 1 is
// never stepped, so any legal stride does.
inline uint64_t map_stride(long long stride, int size) {
  return size > 1 ? static_cast<uint64_t>(stride) * 2 : 16;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_pos, void* o, float* lse, int B, int S,
                   int T, int H, int KV, long long q_sb, long long q_ss,
                   long long q_sh, long long k_sb, long long k_ss,
                   long long k_sh, long long v_sb, long long v_ss,
                   long long v_sh, float scale, int causal, int window,
                   int q_offset, cudaStream_t stream) {
  using G = Geo<D>;
  Args a;
  a.kv_pos = kv_pos;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = lse;
  a.S = S;
  a.T = T;
  a.H = H;
  a.KV = KV;
  a.scale_log2 = scale * LOG2E;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  const uint32_t qbox[4] = {G::SW / 2, BQ, 1, 1};
  const uint32_t kvbox[4] = {G::SW / 2, BKV, 1, 1};
  const uint64_t qdims[4] = {uint64_t(D), uint64_t(S), uint64_t(H),
                             uint64_t(B)};
  const uint64_t kvdims[4] = {uint64_t(D), uint64_t(T), uint64_t(KV),
                              uint64_t(B)};
  const uint64_t qstr[3] = {map_stride(q_ss, S), map_stride(q_sh, H),
                            map_stride(q_sb, B)};
  const uint64_t kstr[3] = {map_stride(k_ss, T), map_stride(k_sh, KV),
                            map_stride(k_sb, B)};
  const uint64_t vstr[3] = {map_stride(v_ss, T), map_stride(v_sh, KV),
                            map_stride(v_sb, B)};
  cudaError_t err;
  if ((err = hopper::make_tensor_map(&a.qmap, q, 4, qdims, qstr, qbox,
                                     G::SW)) != cudaSuccess ||
      (err = hopper::make_tensor_map(&a.kmap, k, 4, kvdims, kstr, kvbox,
                                     G::SW)) != cudaSuccess ||
      (err = hopper::make_tensor_map(&a.vmap, v, 4, kvdims, vstr, kvbox,
                                     G::SW)) != cudaSuccess)
    return err;
  auto kernel = flash_fwd_kernel_tc<D>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NTHREADS, G::SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32 (flash_fwd_kernel), 1 = bfloat16 (flash_fwd_kernel_tc,
// which reads q, k and v through TMA: 16-byte-aligned bases, strides in
// 16-byte multiples, checked by the Python wrapper).  Strides are in
// elements.  Returns the cudaError_t of the launch (0 on success); the
// launch does not synchronise.
int flash_fwd(const void* q, const void* k, const void* v, const int* kv_pos,
              void* o, float* lse, int B, int S, int T, int H, int KV, int D,
              long long q_sb, long long q_ss, long long q_sh, long long k_sb,
              long long k_ss, long long k_sh, long long v_sb, long long v_ss,
              long long v_sh, float scale, int causal, int window,
              int q_offset, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Args a{q,    k,    v,    kv_pos, o,    lse,  S,     T,      H,
           KV,   q_sb, q_ss, q_sh,   k_sb, k_ss, k_sh,  v_sb,   v_ss,
           v_sh, scale, causal, window, q_offset};
    return dispatch_d<float>(a, B, D, s);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
#define FLASH_TC(DIM)                                                       \
  case DIM:                                                                 \
    return tc::launch<DIM>(q, k, v, kv_pos, o, lse, B, S, T, H, KV, q_sb,   \
                           q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,  \
                           scale, causal, window, q_offset, s)
  switch (D) {
    FLASH_TC(8);
    FLASH_TC(16);
    FLASH_TC(32);
    FLASH_TC(64);
    FLASH_TC(128);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_TC
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
