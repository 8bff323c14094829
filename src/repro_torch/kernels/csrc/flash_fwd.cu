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
// the bound is arithmetic (0.139 ms at the bf16 tensor-core peak).  This
// first version does its arithmetic in f32 on the CUDA cores (67 TFLOP/s
// peak), not on the tensor cores (989 TFLOP/s bf16), and reaches
// 13.9 TFLOP/s there (9.9 ms; H100 80GB HBM3 at 700 W, chip_smoke.py).
// Its inner loops are limited by shared-memory reads: each thread computes
// a 4 x 4 tile of S = Q K^T from four q and four k values per step (8
// loads for 16 FMAs) and a 4 x D/16 tile of O = P V.  What the design does
// about the bound:
//   * one thread block per (q tile of 64 rows, head, batch); heavy causal
//     tiles are scheduled first;
//   * K/V tiles of 64 rows are staged through shared memory once and read
//     by all 64 query rows; q is scaled once into shared memory;
//   * KV tiles that are wholly masked (causal future, outside the window)
//     are skipped by a block-uniform test on the tile's position min/max,
//     which halves the work of causal prefill;
//   * shared rows are padded to an odd length so that the 16 threads that
//     read different rows of one tile hit different banks.
// Moving the two products onto the tensor cores (mma.sync / wgmma with
// bf16 operands), TMA loads and warp specialisation is later work.
//
// Rows with no visible key (possible only with q_offset, kv_positions or a
// window) get o = 0 and lse = -1e30 + log(1e-30): masked probabilities are
// exactly 0, so such a row accumulates nothing.  Ragged S and T (not a
// multiple of the tile) are masked here; the kernel has no fallback.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns the
// cudaError_t of the launch (0 on success); the launch does not synchronise.
int flash_fwd(const void* q, const void* k, const void* v, const int* kv_pos,
              void* o, float* lse, int B, int S, int T, int H, int KV, int D,
              long long q_sb, long long q_ss, long long q_sh, long long k_sb,
              long long k_ss, long long k_sh, long long v_sb, long long v_ss,
              long long v_sh, float scale, int causal, int window,
              int q_offset, int dtype, void* stream) {
  Args a{q,    k,    v,    kv_pos, o,    lse,  S,     T,      H,
         KV,   q_sb, q_ss, q_sh,   k_sb, k_ss, k_sh,  v_sb,   v_ss,
         v_sh, scale, causal, window, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(a, B, D, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(a, B, D, s);
  return cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
