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
// bf16 tensor-core peak.  This first version does its arithmetic in f32 on
// the CUDA cores (67 TFLOP/s peak, so 76 ms at best) and is limited by
// shared-memory reads, as the flash kernel is: each thread computes a 4 x 4
// tile of z from four h and four W values per step (8 loads for 16 FMAs).
// What the design does about the bound:
//   * a block owns 64 tokens and walks over 64-wide vocabulary tiles; per
//     tile it stages 32-wide chunks of h and of W through shared memory
//     (bf16 -> f32), so each W value loaded serves 64 tokens and each h
//     value 64 vocabulary columns;
//   * the Pallas kernel carries its six accumulators across a sequential
//     vocabulary grid axis; Hopper runs blocks in no order, so each block
//     keeps them in registers over its own range of tiles;
//   * 8192 tokens in 64-token blocks are only 128 blocks for 132 SMs, so the
//     vocabulary is split across blocks as well (grid.y); each block writes
//     its partial (m_s, l_s, m_t, l_t, u_t, u_s) to scratch and a second
//     kernel merges the splits exactly: l_s is rescaled by the student's
//     exp(m_s - max m_s), and l_t, u_t and u_s by the teacher's
//     exp(m_t - max m_t), since u_s is weighted by p_t;
//   * W is read through its strides, so a tied embedding passed as
//     embed.T ([D,V] with a V-stride of D) is never copied; the staging loop
//     walks whichever index has unit stride fastest, so loads coalesce in
//     both layouts;
//   * row maxima and sums come from shuffles across the 16 threads that
//     share a token, in block-uniform control flow.
// Ragged N and V (not multiples of the tiles) are masked here; the kernel
// has no fallback.  Padded vocabulary columns are not masked: the JAX KL
// does not mask them either.  Moving the products onto the tensor cores
// (mma.sync / wgmma with bf16 operands), TMA loads and pipelining is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
cudaError_t launch(const Args& a, const MergeArgs& m, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (BT * HSTRIDE + KC * WSTRIDE);
  auto kernel = distill_kl_partial_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BT - 1) / BT, a.nsplit);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 mgrid((m.N + MERGE_THREADS - 1) / MERGE_THREADS);
  distill_kl_merge_kernel<<<mgrid, MERGE_THREADS, 0, stream>>>(m);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (all four inputs).  Strides are in
// elements; h must be contiguous along its hidden dim.  part is f32 scratch
// of NSTAT * nsplit * N; split k covers vocabulary tiles
// [k * tiles_per_split, (k + 1) * tiles_per_split) of 64 columns.  Returns the
// cudaError_t of the launches (0 on success); nothing synchronises.
int distill_kl_fwd(const void* hs, const void* ws, const void* ht,
                   const void* wt, float* part, float* lse_s, float* lse_t,
                   float* e_t, float* e_s, int N, int Ds, int Dt, int V,
                   int nsplit, int tiles_per_split, long long hs_sn,
                   long long ws_sd, long long ws_sv, long long ht_sn,
                   long long wt_sd, long long wt_sv, float inv_temp,
                   int dtype, void* stream) {
  if (N <= 0 || Ds <= 0 || Dt <= 0 || V <= 0 || nsplit <= 0 ||
      tiles_per_split <= 0 ||
      static_cast<long long>(nsplit) * tiles_per_split * BV < V)
    return cudaErrorInvalidValue;
  Args a{hs,    ws,    ht,    wt,    part,  N,     Ds,    Dt,
         V,     nsplit, tiles_per_split,    hs_sn, ws_sd, ws_sv,
         ht_sn, wt_sd, wt_sv, inv_temp};
  MergeArgs m{part, lse_s, lse_t, e_t, e_s, N, nsplit};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, m, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, m, s);
  return cudaErrorInvalidValue;
}

const char* distill_kl_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
