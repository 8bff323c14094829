// Distillation-KL statistics for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/distill_kl_pallas.py::_kernel
// (launched by _stats_pallas through pl.pallas_call).  It computes the same
// function: for every token n, with z = h W / T for the student (h_s [N,Ds],
// W_s [Ds,V]) and the teacher (h_t [N,Dt], W_t [Dt,V]),
//   lse_s = log sum_v exp z_s,   lse_t = log sum_v exp z_t,
//   e_t   = sum_v p_t z_t,       e_s   = sum_v p_t z_s,
// streamed over the vocabulary with online (max, sum) accumulators, so that
// neither [N,V] logit matrix is ever formed.  Arithmetic is f32 on bf16 or
// f32 inputs, with the Pallas kernel's max(l, 1e-30) clamps.  The plain
// version is repro_torch/kernels/ref.py::distill_kl_stats_ref.
//
// What bounds it on an H100: at the main-path shape (N = 8192 tokens,
// Ds = Dt = 1024, V = 151936, bf16) the two products are 4 N D V =
// 5.10 TFLOP against 656 MB of inputs, about 7,800 FLOP per byte, far above
// the card's ~295 FLOP/byte ridge: the bound is arithmetic, 5.16 ms at the
// bf16 tensor-core peak.  It is, at heart, two [N,D] x [D,V] GEMMs with an
// online-softmax epilogue.  Common to both paths:
//   * the Pallas kernel carries its six accumulators across a sequential
//     vocabulary grid axis; Hopper runs blocks in no order, so each block
//     keeps them in registers over its own range of vocabulary tiles;
//   * the vocabulary is split across blocks as well (grid.y), so that
//     enough blocks are in flight; each block writes its partial (m_s, l_s,
//     m_t, l_t, u_t, u_s) to scratch and a second kernel merges the splits
//     exactly: l_s is rescaled by the student's exp(m_s - max m_s), and l_t,
//     u_t and u_s by the teacher's exp(m_t - max m_t), since u_s is weighted
//     by p_t;
//   * W is read through its strides, so a tied embedding passed as embed.T
//     ([D,V] with a V-stride of D) is never copied.
// bf16 -> distill_kl_partial_kernel_tc, on the tensor cores (hopper.cuh):
//   * a block owns 128 tokens (two consumer warpgroups of 64) and walks its
//     split in 128-column vocabulary tiles; per tile it runs a K-loop over D
//     in 64-deep slabs, the student's product and then the teacher's;
//   * one producer warp keeps a ring of four stages full: per slab, the h
//     slab [128 x 64] (K-major) and the W slab [64 x 128] by TMA, 128B
//     swizzle, completing on the stage's mbarrier; W [D,V] row-major is
//     MN-major (two 64-column boxes, the transpose bit), embed.T K-major;
//   * each slab is four wgmma m64n128k16 into an f32 accumulator, z_s and
//     z_t side by side (2 x 64 registers a thread); one slab's products stay
//     in flight while the next is issued, and a stage is released when its
//     products are done;
//   * the epilogue keeps the six accumulators per thread over the thread's
//     own columns, and merges the 4 lanes of a quad (which share a token)
//     with the same exact rule at the end; only the last, ragged tile's
//     epilogue tests columns against V.
//   At the main-path shape it takes 9.55 ms (534 TFLOP/s; H100 80GB HBM3
//   at 700 W, chip_smoke.py).
// f32 -> distill_kl_partial_kernel, f32 FMAs on the CUDA cores (67 TFLOP/s
// peak), for the f32 checks (TF32 would break their tolerances); it is
// limited by shared-memory reads (each thread computes a 4 x 4 tile of z
// from four h and four W values per step: 8 loads for 16 FMAs).  A block
// owns 64 tokens and 64-wide vocabulary tiles, staging 32-wide chunks of h
// and W through shared memory; row maxima and sums come from shuffles
// across the 16 threads that share a token.
// Ragged N, D and V (not multiples of the tiles) are masked here (the bf16
// path reads zeros past the ends through TMA and drops columns >= V from
// the softmax); the kernels have no fallback.  Padded vocabulary columns of
// a model are not masked: the JAX KL does not mask them either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int BT = 64;            // tokens per block
constexpr int BV = 64;            // vocabulary columns per tile
constexpr int KC = 32;            // hidden dims per staged chunk
constexpr int TX = 16;            // threads across vocabulary columns
constexpr int TY = 16;            // threads across tokens
constexpr int NTHREADS = TX * TY;
constexpr int RPT = BT / TY;      // tokens per thread (ty + i*TY)
constexpr int CPT = BV / TX;      // columns per thread (tx + j*TX)
constexpr int HSTRIDE = KC + 1;   // padded h row in shared memory
constexpr int WSTRIDE = BV + 1;   // padded W row in shared memory
constexpr int NSTAT = 6;          // m_s, l_s, m_t, l_t, u_t, u_s
constexpr int MERGE_THREADS = 256;
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* hs;
  const void* ws;
  const void* ht;
  const void* wt;
  float* part;                    // [NSTAT][nsplit][N]
  int N, Ds, Dt, V, nsplit, tiles_per_split;
  long long hs_sn, ws_sd, ws_sv;
  long long ht_sn, wt_sd, wt_sv;
  float inv_temp;
};

struct MergeArgs {
  const float* part;
  float* lse_s;
  float* lse_t;
  float* e_t;
  float* e_s;
  int N, nsplit;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Reductions over the 16 threads (one half-warp) that share a token.
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

// z[i][j] = sum_d h[t0 + ty + i*TY, d] W[d, v0 + tx + j*TX] over d < D, with
// h and W staged through shared memory KC dims at a time (zero outside N,
// D and V).
template <typename T>
__device__ __forceinline__ void tile_product(
    const T* h, long long h_sn, const T* w, long long w_sd, long long w_sv,
    int t0, int N, int D, int v0, int V, float* Hs, float* Ws,
    float (&z)[RPT][CPT]) {
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) z[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += KC) {
    __syncthreads();   // every thread is done with the previous chunk
    for (int i = tid; i < BT * KC; i += NTHREADS) {
      const int r = i / KC, d = i % KC;
      const int t = t0 + r, dd = d0 + d;
      Hs[r * HSTRIDE + d] = (t < N && dd < D) ? to_float(h[t * h_sn + dd]) : 0.f;
    }
    if (w_sv == 1) {   // [D, V] row-major: columns are contiguous
      for (int i = tid; i < KC * BV; i += NTHREADS) {
        const int d = i / BV, c = i % BV;
        const int dd = d0 + d, v = v0 + c;
        Ws[d * WSTRIDE + c] =
            (dd < D && v < V) ? to_float(w[dd * w_sd + v * w_sv]) : 0.f;
      }
    } else {           // e.g. embed.T: the hidden dims are contiguous
      for (int i = tid; i < KC * BV; i += NTHREADS) {
        const int c = i / KC, d = i % KC;
        const int dd = d0 + d, v = v0 + c;
        Ws[d * WSTRIDE + c] =
            (dd < D && v < V) ? to_float(w[dd * w_sd + v * w_sv]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < KC; ++d) {
      float hv[RPT], wv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) hv[i] = Hs[(ty + i * TY) * HSTRIDE + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) wv[j] = Ws[d * WSTRIDE + tx + j * TX];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) z[i][j] = fmaf(hv[i], wv[j], z[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    distill_kl_partial_kernel(const Args a) {
  extern __shared__ float smem[];
  float* Hs = smem;                       // [BT][HSTRIDE]
  float* Ws = smem + BT * HSTRIDE;        // [KC][WSTRIDE]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int t0 = blockIdx.x * BT;
  const int split = blockIdx.y;
  const int ntiles = (a.V + BV - 1) / BV;
  const int tile_lo = split * a.tiles_per_split;
  const int tile_hi = min(ntiles, tile_lo + a.tiles_per_split);
  const T* hs = static_cast<const T*>(a.hs);
  const T* ws = static_cast<const T*>(a.ws);
  const T* ht = static_cast<const T*>(a.ht);
  const T* wt = static_cast<const T*>(a.wt);

  float ms[RPT], ls[RPT], mt[RPT], lt[RPT], ut[RPT], us[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    ms[i] = NEG_INF;
    mt[i] = NEG_INF;
    ls[i] = lt[i] = ut[i] = us[i] = 0.f;
  }

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int v0 = tile * BV;
    const int ncols = min(BV, a.V - v0);
    float zs[RPT][CPT], zt[RPT][CPT];
    tile_product<T>(hs, a.hs_sn, ws, a.ws_sd, a.ws_sv, t0, a.N, a.Ds, v0,
                    a.V, Hs, Ws, zs);
    tile_product<T>(ht, a.ht_sn, wt, a.wt_sd, a.wt_sv, t0, a.N, a.Dt, v0,
                    a.V, Hs, Ws, zt);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mxs = NEG_INF, mxt = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        zs[i][j] *= a.inv_temp;
        zt[i][j] *= a.inv_temp;
        if (tx + j * TX < ncols) {
          mxs = fmaxf(mxs, zs[i][j]);
          mxt = fmaxf(mxt, zt[i][j]);
        }
      }
      const float ms_new = fmaxf(ms[i], row_max(mxs));
      const float mt_new = fmaxf(mt[i], row_max(mxt));
      float ss = 0.f, st = 0.f, sut = 0.f, sus = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        if (tx + j * TX < ncols) {
          ss += expf(zs[i][j] - ms_new);
          const float p = expf(zt[i][j] - mt_new);
          st += p;
          sut += p * zt[i][j];
          sus += p * zs[i][j];
        }
      }
      const float corr = expf(mt[i] - mt_new);
      ls[i] = ls[i] * expf(ms[i] - ms_new) + row_sum(ss);
      lt[i] = lt[i] * corr + row_sum(st);
      ut[i] = ut[i] * corr + row_sum(sut);
      us[i] = us[i] * corr + row_sum(sus);
      ms[i] = ms_new;
      mt[i] = mt_new;
    }
  }

  if (tx == 0) {
    const long long stride = static_cast<long long>(a.nsplit) * a.N;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = t0 + ty + i * TY;
      if (t >= a.N) continue;
      float* p = a.part + static_cast<long long>(split) * a.N + t;
      p[0 * stride] = ms[i];
      p[1 * stride] = ls[i];
      p[2 * stride] = mt[i];
      p[3 * stride] = lt[i];
      p[4 * stride] = ut[i];
      p[5 * stride] = us[i];
    }
  }
}

// One thread per token: merges the vocabulary splits and finalises.
__global__ void __launch_bounds__(MERGE_THREADS)
    distill_kl_merge_kernel(const MergeArgs a) {
  const int n = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (n >= a.N) return;
  const long long stride = static_cast<long long>(a.nsplit) * a.N;
  const float* p = a.part + n;
  float ms = NEG_INF, mt = NEG_INF;
  for (int k = 0; k < a.nsplit; ++k) {
    const long long o = static_cast<long long>(k) * a.N;
    ms = fmaxf(ms, p[0 * stride + o]);
    mt = fmaxf(mt, p[2 * stride + o]);
  }
  float ls = 0.f, lt = 0.f, ut = 0.f, us = 0.f;
  for (int k = 0; k < a.nsplit; ++k) {
    const long long o = static_cast<long long>(k) * a.N;
    ls += p[1 * stride + o] * expf(p[0 * stride + o] - ms);
    const float corr = expf(p[2 * stride + o] - mt);
    lt += p[3 * stride + o] * corr;
    ut += p[4 * stride + o] * corr;
    us += p[5 * stride + o] * corr;
  }
  lt = fmaxf(lt, 1e-30f);
  a.lse_s[n] = ms + logf(fmaxf(ls, 1e-30f));
  a.lse_t[n] = mt + logf(lt);
  a.e_t[n] = ut / lt;
  a.e_s[n] = us / lt;
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (BT * HSTRIDE + KC * WSTRIDE);
  auto kernel = distill_kl_partial_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BT - 1) / BT, a.nsplit);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_merge(const MergeArgs& m, cudaStream_t stream) {
  const dim3 mgrid((m.N + MERGE_THREADS - 1) / MERGE_THREADS);
  distill_kl_merge_kernel<<<mgrid, MERGE_THREADS, 0, stream>>>(m);
  return cudaGetLastError();
}

// ------------------------------------------------------- bf16, tensor cores
namespace tc {

constexpr int BT = 128;               // tokens per block: 2 warpgroups of 64
constexpr int BV = 128;               // vocabulary columns per tile
constexpr int BK = 64;                // hidden dims per slab
constexpr int STAGES = 4;
constexpr int NCONS = 256;            // consumer threads
constexpr int NTHREADS = NCONS + 32;  // and one producer warp
constexpr int H_BYTES = BT * BK * 2;  // [128 tokens][64 dims], 128B rows
constexpr int W_BYTES = BK * BV * 2;  // [128 v][64 d] or 2 x [64 d][64 v]
constexpr int STAGE_BYTES = H_BYTES + W_BYTES;
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  hopper::TensorMap hs_map, ws_map, ht_map, wt_map;
  float* part;                        // [NSTAT][nsplit][N]
  int N, Ds, Dt, V, nsplit, tiles_per_split;
  float inv_temp;
};

__device__ __forceinline__ float exp_(float x) { return exp2f(x * LOG2E); }

__device__ __forceinline__ void release(uint64_t* empty, int it) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&empty[it % STAGES]);
}

// z = h W over nk slabs of the ring, starting at slab counter `it`; the
// previous slab's products stay in flight while the next slab's are issued.
template <int TB>
__device__ __forceinline__ void product(float (&z)[BV / 2], int nk, int& it,
                                        char* base, uint64_t* full,
                                        uint64_t* empty, int g) {
  using namespace hopper;
#pragma unroll
  for (int i = 0; i < BV / 2; ++i) z[i] = 0.f;
  fence_regs(z);
  for (int j = 0; j < nk; ++j, ++it) {
    const int st = it % STAGES;
    mbar_wait(&full[st], (it / STAGES) & 1);
    const uint32_t h_addr = smem_addr(base + st * STAGE_BYTES) + g * 64 * 128;
    const uint32_t w_addr = smem_addr(base + st * STAGE_BYTES + H_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db =
          TB ? smem_desc(w_addr + kk * 16 * 128, 128, W_BYTES / 2, 1024)
             : smem_desc(w_addr + kk * 32, 128, 0, 1024);
      Wgmma<BV>::template ss<TB>(z, smem_desc(h_addr + kk * 32, 128, 0, 1024),
                                 db, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (j > 0) release(empty, it - 1);
  }
  wgmma_wait<0>();
  fence_regs(z);
  if (nk > 0) release(empty, it - 1);
}

// The six online accumulators of this thread's two tokens over its
// columns of one vocabulary tile; RAGGED drops columns >= V (ncols of the
// tile), which only the last tile has.
template <bool RAGGED>
__device__ __forceinline__ void update(float (&zs)[BV / 2],
                                       float (&zt)[BV / 2], int ncols,
                                       float inv_temp, float (&ms)[2],
                                       float (&ls)[2], float (&mt)[2],
                                       float (&lt)[2], float (&ut)[2],
                                       float (&us)[2]) {
  const int l = threadIdx.x % 32;
  float mxs[2] = {NEG_INF, NEG_INF}, mxt[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < BV / 2; ++i) {
    const int r = (i / 2) % 2;
    zs[i] *= inv_temp;
    zt[i] *= inv_temp;
    if (!RAGGED || 8 * (i / 4) + 2 * (l % 4) + i % 2 < ncols) {
      mxs[r] = fmaxf(mxs[r], zs[i]);
      mxt[r] = fmaxf(mxt[r], zt[i]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ms_new = fmaxf(ms[r], mxs[r]);
    const float mt_new = fmaxf(mt[r], mxt[r]);
    const float corr = exp_(mt[r] - mt_new);
    ls[r] *= exp_(ms[r] - ms_new);
    lt[r] *= corr;
    ut[r] *= corr;
    us[r] *= corr;
    ms[r] = ms_new;
    mt[r] = mt_new;
  }
#pragma unroll
  for (int i = 0; i < BV / 2; ++i) {
    const int r = (i / 2) % 2;
    if (!RAGGED || 8 * (i / 4) + 2 * (l % 4) + i % 2 < ncols) {
      ls[r] += exp_(zs[i] - ms[r]);
      const float p = exp_(zt[i] - mt[r]);
      lt[r] += p;
      ut[r] += p * zt[i];
      us[r] += p * zs[i];
    }
  }
}

// TBS, TBT: W_s, W_t MN-major ([D,V] row-major) = 1, K-major (embed.T) = 0.
template <int TBS, int TBT>
__global__ void __launch_bounds__(NTHREADS, 1)
    distill_kl_partial_kernel_tc(const __grid_constant__ Args a) {
  using namespace hopper;
  extern __shared__ float smem[];
  const uint32_t s0 = smem_addr(smem);
  char* base = reinterpret_cast<char*>(smem) + ((1024 - (s0 & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BT;
  const int split = blockIdx.y;
  const int ntiles = (a.V + BV - 1) / BV;
  const int tile_lo = split * a.tiles_per_split;
  const int tile_hi = min(ntiles, tile_lo + a.tiles_per_split);
  const int nks = (a.Ds + BK - 1) / BK;
  const int nkt = (a.Dt + BK - 1) / BK;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], NCONS / 32);   // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NCONS) {
    // ---- producer: one thread issues every slab's loads
    if (tid == NCONS) {
      int it = 0;
      for (int tile = tile_lo; tile < tile_hi; ++tile) {
        const int v0 = tile * BV;
        for (int p = 0; p < 2; ++p) {
          const TensorMap* hm = p ? &a.ht_map : &a.hs_map;
          const TensorMap* wm = p ? &a.wt_map : &a.ws_map;
          const int mn = p ? TBT : TBS;
          const int nk = p ? nkt : nks;
          for (int j = 0; j < nk; ++j, ++it) {
            const int st = it % STAGES;
            mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
            mbar_arrive_expect_tx(&full[st], STAGE_BYTES);
            char* sb = base + st * STAGE_BYTES;
            tma_load_2d(sb, hm, &full[st], j * BK, t0);
            if (mn) {
              tma_load_2d(sb + H_BYTES, wm, &full[st], v0, j * BK);
              tma_load_2d(sb + H_BYTES + W_BYTES / 2, wm, &full[st], v0 + 64,
                          j * BK);
            } else {
              tma_load_2d(sb + H_BYTES, wm, &full[st], j * BK, v0);
            }
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroup g: tokens t0 + g*64 .. t0 + g*64 + 63
    const int g = tid / 128;
    const int w = (tid % 128) / 32;
    const int l = tid % 32;
    float ms[2], ls[2], mt[2], lt[2], ut[2], us[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ms[r] = mt[r] = NEG_INF;
      ls[r] = lt[r] = ut[r] = us[r] = 0.f;
    }
    int it = 0;
    for (int tile = tile_lo; tile < tile_hi; ++tile) {
      const int ncols = min(BV, a.V - tile * BV);
      float zs[BV / 2], zt[BV / 2];
      product<TBS>(zs, nks, it, base, full, empty, g);
      product<TBT>(zt, nkt, it, base, full, empty, g);
      if (ncols == BV)
        update<false>(zs, zt, ncols, a.inv_temp, ms, ls, mt, lt, ut, us);
      else
        update<true>(zs, zt, ncols, a.inv_temp, ms, ls, mt, lt, ut, us);
    }
    // merge the 4 lanes of a quad (one token) as the merge kernel merges
    // splits, then lane 0 of the quad writes the token's partial
    const long long stride = static_cast<long long>(a.nsplit) * a.N;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float Ms = ms[r], Mt = mt[r];
      Ms = fmaxf(Ms, __shfl_xor_sync(0xffffffffu, Ms, 1));
      Ms = fmaxf(Ms, __shfl_xor_sync(0xffffffffu, Ms, 2));
      Mt = fmaxf(Mt, __shfl_xor_sync(0xffffffffu, Mt, 1));
      Mt = fmaxf(Mt, __shfl_xor_sync(0xffffffffu, Mt, 2));
      const float corr = exp_(mt[r] - Mt);
      float v[4] = {ls[r] * exp_(ms[r] - Ms), lt[r] * corr, ut[r] * corr,
                    us[r] * corr};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], 1);
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], 2);
      }
      const int t = t0 + g * 64 + 16 * w + l / 4 + 8 * r;
      if (l % 4 == 0 && t < a.N) {
        float* p = a.part + static_cast<long long>(split) * a.N + t;
        p[0 * stride] = Ms;
        p[1 * stride] = v[0];
        p[2 * stride] = Mt;
        p[3 * stride] = v[1];
        p[4 * stride] = v[2];
        p[5 * stride] = v[3];
      }
    }
  }
}

// Byte stride of a dimension for its tensor map: a dimension of size 1 is
// never stepped, so any legal stride does.
inline uint64_t map_stride(long long stride, int size) {
  return size > 1 ? static_cast<uint64_t>(stride) * 2 : 16;
}

inline cudaError_t h_map(hopper::TensorMap* m, const void* h, int N, int D,
                         long long h_sn) {
  const uint64_t dims[2] = {uint64_t(D), uint64_t(N)};
  const uint64_t str[1] = {map_stride(h_sn, N)};
  const uint32_t box[2] = {BK, BT};
  return hopper::make_tensor_map(m, h, 2, dims, str, box, 128);
}

// W [D,V] through its strides: MN-major (v contiguous) -> *mn = 1, two
// 64 x 64 boxes a slab; K-major (d contiguous, embed.T) -> *mn = 0, one
// 64 x 128 box.
inline cudaError_t w_map(hopper::TensorMap* m, int* mn, const void* w, int D,
                         int V, long long w_sd, long long w_sv) {
  if (w_sv == 1) {
    *mn = 1;
    const uint64_t dims[2] = {uint64_t(V), uint64_t(D)};
    const uint64_t str[1] = {map_stride(w_sd, D)};
    const uint32_t box[2] = {64, BK};
    return hopper::make_tensor_map(m, w, 2, dims, str, box, 128);
  }
  if (w_sd != 1) return cudaErrorInvalidValue;
  *mn = 0;
  const uint64_t dims[2] = {uint64_t(D), uint64_t(V)};
  const uint64_t str[1] = {map_stride(w_sv, V)};
  const uint32_t box[2] = {BK, BV};
  return hopper::make_tensor_map(m, w, 2, dims, str, box, 128);
}

template <int TBS, int TBT>
cudaError_t launch_partial(const Args& a, cudaStream_t stream) {
  auto kernel = distill_kl_partial_kernel_tc<TBS, TBT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BT - 1) / BT, a.nsplit);
  kernel<<<grid, NTHREADS, SMEM, stream>>>(a);
  return cudaGetLastError();
}

inline cudaError_t launch(const void* hs, const void* ws, const void* ht,
                          const void* wt, float* part, int N, int Ds, int Dt,
                          int V, int nsplit, int tiles_per_split,
                          long long hs_sn, long long ws_sd, long long ws_sv,
                          long long ht_sn, long long wt_sd, long long wt_sv,
                          float inv_temp, cudaStream_t stream) {
  Args a;
  a.part = part;
  a.N = N;
  a.Ds = Ds;
  a.Dt = Dt;
  a.V = V;
  a.nsplit = nsplit;
  a.tiles_per_split = tiles_per_split;
  a.inv_temp = inv_temp;
  int mn_s = 0, mn_t = 0;
  cudaError_t err;
  if ((err = h_map(&a.hs_map, hs, N, Ds, hs_sn)) != cudaSuccess ||
      (err = h_map(&a.ht_map, ht, N, Dt, ht_sn)) != cudaSuccess ||
      (err = w_map(&a.ws_map, &mn_s, ws, Ds, V, ws_sd, ws_sv)) !=
          cudaSuccess ||
      (err = w_map(&a.wt_map, &mn_t, wt, Dt, V, wt_sd, wt_sv)) != cudaSuccess)
    return err;
  if (mn_s && mn_t) return launch_partial<1, 1>(a, stream);
  if (mn_s) return launch_partial<1, 0>(a, stream);
  if (mn_t) return launch_partial<0, 1>(a, stream);
  return launch_partial<0, 0>(a, stream);
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32 (distill_kl_partial_kernel, 64-column vocabulary
// tiles), 1 = bfloat16 (distill_kl_partial_kernel_tc, 128-column tiles,
// inputs read through TMA: 16-byte-aligned bases, strides in 16-byte
// multiples, one of W's strides 1; checked by the Python wrapper).  Strides
// are in elements; h must be contiguous along its hidden dim.  part is f32
// scratch of NSTAT * nsplit * N; split k covers vocabulary tiles
// [k * tiles_per_split, (k + 1) * tiles_per_split).  Returns the
// cudaError_t of the launches (0 on success); nothing synchronises.
int distill_kl_fwd(const void* hs, const void* ws, const void* ht,
                   const void* wt, float* part, float* lse_s, float* lse_t,
                   float* e_t, float* e_s, int N, int Ds, int Dt, int V,
                   int nsplit, int tiles_per_split, long long hs_sn,
                   long long ws_sd, long long ws_sv, long long ht_sn,
                   long long wt_sd, long long wt_sv, float inv_temp,
                   int dtype, void* stream) {
  const int bv = dtype == 1 ? tc::BV : BV;
  if (N <= 0 || Ds <= 0 || Dt <= 0 || V <= 0 || nsplit <= 0 ||
      tiles_per_split <= 0 || (dtype != 0 && dtype != 1) ||
      static_cast<long long>(nsplit) * tiles_per_split * bv < V)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    Args a{hs,    ws,    ht,    wt,    part,  N,     Ds,    Dt,
           V,     nsplit, tiles_per_split,    hs_sn, ws_sd, ws_sv,
           ht_sn, wt_sd, wt_sv, inv_temp};
    err = launch<float>(a, s);
  } else {
    err = tc::launch(hs, ws, ht, wt, part, N, Ds, Dt, V, nsplit,
                     tiles_per_split, hs_sn, ws_sd, ws_sv, ht_sn, wt_sd,
                     wt_sv, inv_temp, s);
  }
  if (err != cudaSuccess) return err;
  MergeArgs m{part, lse_s, lse_t, e_t, e_s, N, nsplit};
  return launch_merge(m, s);
}

const char* distill_kl_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
