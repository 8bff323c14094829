// Flash attention backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the backward rule of the TPU flash kernel:
// repro/kernels/flash_attention.py::_bwd_vjp and _bwd_lse_vjp, the
// custom_vjp rules of _flash_pallas and _flash_pallas_lse, which both run
// the blockwise-recompute backward repro/kernels/ref.py::_flash_bwd_core.
// It computes the same function:
//   delta = sum_d do * o - dlse            (dlse: the lse cotangent, or 0)
//   p     = exp(s * scale - lse), 0 where the mask hides the pair
//   ds    = p (dp - delta),  dp = do v^T
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T do
// with dk and dv summed over the G = H / KV query heads of each KV head,
// the difference-based causal and window masks of the forward, optional
// int32 kv_positions with q_offset, and f32 accumulation.  The plain
// version is repro_torch/kernels/ref.py::flash_bwd_ref.
//
// Layout is the JAX package's: q, do, dq [B,S,H,D]; k, v, dk, dv
// [B,T,KV,D]; o [B,S,H,D]; lse, dlse, delta [B,S,H].  q/k/v are read
// through their batch, sequence and head strides (the last dim contiguous),
// as the forward reads them; o, do, lse and dlse are contiguous, and dq, dk,
// dv and the f32 delta scratch are written contiguous.
//
// What bounds it on an H100: 10 D FLOP a visible (query, key) pair and
// query head (the five products of the FlashAttention-2 backward).  At
// qwen1.5-0.5b's training shape (B = 4, S = T = 2048, H = KV = 16, D = 64,
// causal, bf16) that is 86 GFLOP against 134 MB that must move (q, k, v,
// o, do read, dq, dk, dv written once), about 640 FLOP a byte, above the
// card's ~295 FLOP/byte ridge: the bound is arithmetic, 0.087 ms at the
// bf16 tensor-core peak.  Three kernels, launched in order on one stream:
//
// (a) delta per (b, s, h) row in f32: flash_bwd_delta_kernel_x8 for bf16,
//     16-byte loads, D / 8 threads a row; flash_bwd_delta_kernel for
//     float32, one warp a row, four rows a warp.
// (b) dK/dV: one block per (b, KV head, 128-row KV tile).  The block loops
//     over the G query heads of its group and, for each, over the q tiles
//     that can see its KV tile; it recomputes S^T = K Q^T, P^T =
//     exp(S^T scale - lse) (masked before the exp), dP^T = V dO^T and dS^T
//     = P^T (dP^T - delta), and accumulates dV += P^T dO and dK += dS^T Q
//     in registers, written once.  The sum over G and the q tiles is taken
//     inside the block in one fixed order.
// (c) dQ: one block per (b, head, q tile), a loop over the KV tiles its
//     rows can see, dQ += dS K.  The recompute of P and dP is repeated here
//     (seven products a pair where FlashAttention-2 has five) so that dQ
//     needs no atomicAdd: the kernels use no atomics, and two calls give
//     the same bits.
//
// bf16 -> the tensor-core kernels (hopper.cuh), shaped like the forward's:
//   * two consumer warpgroups of 64 rows (KV rows in (b), q rows in (c))
//     and a producer warpgroup, which gives its registers to the consumers
//     (setmaxnreg 40 / 232) and whose first warp issues every load;
//   * the tile the block owns (K and V in (b), Q and dO in (c)) is loaded
//     once, and the streamed tiles (Q and dO of 64 rows in (b); K and V of
//     128 rows in (c) at D <= 64, of 64 at D = 128) come through a ring of
//     up to four stages, both tiles of a stage by TMA onto one mbarrier,
//     with the 128B/64B/32B swizzle set by the head dim (D = 8 is padded
//     to 16 by TMA's zero fill); consumers release a stage on another.
//     The producer also stages each q tile's lse (as -lse log2 e) and
//     delta beside it in (b), loaded before it waits for the stage, and
//     the KV tile's positions;
//   * S^T, dP^T (and S, dP) are wgmma m64nNk16 with both operands K-major
//     in shared memory (ss), issued back to back after one wait for the
//     stage; dV, dK (and dQ) take P^T, dS^T (dS) from registers, the f32
//     accumulator rounded to bf16, with the streamed or owned tile
//     MN-major (the transpose bit): the forward's P V pattern;
//   * p = 2^(s * scale log2 e - lse log2 e): one FFMA and ex2.approx.ftz
//     (exp2f adds a slow path for subnormal results to every element); a
//     tile that every pair sees wholly runs a loop with no mask, the
//     others one with it;
//   * the producer skips a tile no row can see and marks the tiles that
//     every pair sees wholly; an end marker closes the consumers' loop;
//     with a causal mask the grid starts the heaviest tiles (dK/dV's first
//     KV tiles, dQ's last q tiles) of every head and batch first.
//   A step issues S and dP, computes P while dP runs, then issues dV and dK
//   (or dQ) and waits for them before it releases the stage.  Measured on
//   an H100 and left out (PERF.md): the two warpgroups taking turns
//   through named barriers, 128-row q tiles in (b), the next tile's S and
//   dP issued before this tile's dV and dK, and P and dS through shared
//   memory as wgmma's A operand; each was slower than this schedule.
// f32 -> CUDA-core kernels (no TF32, the precision of the f32 checks):
//   64 x 64 tiles staged through shared memory as the forward's f32 path,
//   each thread a 4 x 4 block of S and dP and a 4 x D/16 block of the
//   accumulators, rows padded to an odd length against bank conflicts.
//
// Rows with no visible key (lse <= -1e29) have every pair masked, so p = 0
// and their gradient is exactly 0.  Ragged S and T are masked (the bf16
// kernels read zeros past the ends through TMA); the kernels have no
// fallback.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// Whether query position qp may attend key position kp.
__device__ __forceinline__ bool sees(int qp, int kp, int causal, int window) {
  return (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

// ------------------------------------------------------------- (a) delta
constexpr int DELTA_THREADS = 256;
constexpr int DELTA_ROWS_PER_WARP = 4;
constexpr int DELTA_ROWS_PER_BLOCK = DELTA_THREADS / 32 * DELTA_ROWS_PER_WARP;

struct DeltaArgs {
  const void* o;
  const void* dout;
  const float* dlse;     // [rows] or nullptr
  float* delta;
  long long rows;
  int D;
};

__global__ void __launch_bounds__(DELTA_THREADS)
    flash_bwd_delta_kernel(const DeltaArgs a) {
  const int lane = threadIdx.x % 32;
  const long long first =
      (static_cast<long long>(blockIdx.x) * (DELTA_THREADS / 32) +
       threadIdx.x / 32) * DELTA_ROWS_PER_WARP;
  for (int i = 0; i < DELTA_ROWS_PER_WARP; ++i) {
    const long long row = first + i;
    if (row >= a.rows) break;                 // warp-uniform
    const float* o = static_cast<const float*>(a.o) + row * a.D;
    const float* d = static_cast<const float*>(a.dout) + row * a.D;
    float s = 0.f;
    for (int j = lane; j < a.D; j += 32)
      s = fmaf(o[j], d[j], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) a.delta[row] = s - (a.dlse != nullptr ? a.dlse[row] : 0.f);
  }
}

// bf16 (o and do 16-byte aligned): a thread reads 8 elements (16 bytes)
// of each, the D / 8 threads of a row are neighbours in one warp and sum
// over shuffles.
__global__ void __launch_bounds__(DELTA_THREADS)
    flash_bwd_delta_kernel_x8(const DeltaArgs a) {
  const int per = a.D / 8;                      // threads a row: 1 .. 16
  const long long chunk =
      static_cast<long long>(blockIdx.x) * DELTA_THREADS + threadIdx.x;
  const long long row = chunk / per;
  float s = 0.f;
  if (row < a.rows) {
    const uint4 ov = static_cast<const uint4*>(a.o)[chunk];
    const uint4 dv = static_cast<const uint4*>(a.dout)[chunk];
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&ov);
    const __nv_bfloat16* y = reinterpret_cast<const __nv_bfloat16*>(&dv);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s = fmaf(__bfloat162float(x[i]), __bfloat162float(y[i]), s);
  }
  for (int off = per / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < a.rows && chunk % per == 0)
    a.delta[row] = s - (a.dlse != nullptr ? a.dlse[row] : 0.f);
}

// ------------------------------------------------------ f32, CUDA cores
namespace f32 {

constexpr int BT = 64;            // rows of a q tile and of a KV tile
constexpr int TX = 16;            // threads across columns
constexpr int TY = 16;            // threads across rows
constexpr int NTHREADS = TX * TY;
constexpr int PS = BT + 1;        // padded row of a probability tile

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int* kv_pos;
  const float* lse;
  const float* delta;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  int S, T, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale, scale_log2;
  int causal, window, q_offset;
};

// dst [BT][D + 1] <- rows 0 .. n-1 of src (row stride `stride`), zeros past.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int n) {
  for (int i = threadIdx.x; i < BT * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = r < n ? src[r * stride + d] : 0.f;
  }
}

// out[i][j] = sum_d A[ty + TY i][d] B[tx + TX j][d]; A, B [BT][D + 1].
template <int D>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm,
                                         float (&out)[4][4]) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = A[(ty + i * TY) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bm[(tx + j * TX) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(av[i], bv[j], out[i][j]);
  }
}

// acc[i][j] += sum_c P[ty + TY i][c] X[c][tx + TX j]; P [BT][PS],
// X [BT][D + 1].
template <int D>
__device__ __forceinline__ void acc_tile(const float* P, const float* X,
                                         float (&acc)[4][(D + TX - 1) / TX]) {
  constexpr int OPT = (D + TX - 1) / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll 4
  for (int c = 0; c < BT; ++c) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = P[(ty + i * TY) * PS + c];
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int d = tx + j * TX;
      if (D % TX == 0 || d < D) {
        const float xv = X[c * (D + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], xv, acc[i][j]);
      }
    }
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * size_t(BT) * (D + 1) + 2 * size_t(BT) * PS +
                          2 * BT) +
         sizeof(int) * BT;
}

// (b): one block per (KV tile, KV head, batch).
template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkdv_kernel(const Args a) {
  constexpr int LD = D + 1;
  constexpr int OPT = (D + TX - 1) / TX;
  extern __shared__ float smem[];
  float* Ks = smem;                 // [BT][LD]
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;         // the q tile
  float* Os = Qs + BT * LD;         // its dO
  float* Ps = Os + BT * LD;         // P^T [kv][q]
  float* Ds = Ps + BT * PS;         // dS^T [kv][q]
  float* Lse = Ds + BT * PS;        // -lse log2 e of the q tile's rows
  float* Dl = Lse + BT;             // their delta
  int* Pos = reinterpret_cast<int*>(Dl + BT);

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int k0 = blockIdx.x * BT;
  const int ncols = min(BT, a.T - k0);

  load_rows<D>(Ks, a.k + b * a.k_sb + kvh * a.k_sh + k0 * a.k_ss, a.k_ss,
               ncols);
  load_rows<D>(Vs, a.v + b * a.v_sb + kvh * a.v_sh + k0 * a.v_ss, a.v_ss,
               ncols);
  if (tid < BT)
    Pos[tid] = tid < ncols ? (a.kv_pos != nullptr ? a.kv_pos[k0 + tid]
                                                  : k0 + tid)
                           : 0;
  __syncthreads();
  int lo = INT_MAX, hi = INT_MIN;
  for (int c = 0; c < ncols; ++c) {
    lo = min(lo, Pos[c]);
    hi = max(hi, Pos[c]);
  }

  float dk[4][OPT], dv[4][OPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OPT; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int nq = (a.S + BT - 1) / BT;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int t = 0; t < nq; ++t) {
      const int q0 = t * BT;
      const int nrows = min(BT, a.S - q0);
      const int q_lo = a.q_offset + q0, q_hi = q_lo + nrows - 1;
      // block-uniform skip of a q tile that sees none of this KV tile
      if (a.causal && lo > q_hi) continue;
      if (a.window > 0 && q_lo - hi >= a.window) continue;
      __syncthreads();              // the previous tile is read
      load_rows<D>(Qs, a.q + b * a.q_sb + h * a.q_sh + q0 * a.q_ss, a.q_ss,
                   nrows);
      const long long row0 = (static_cast<long long>(b) * a.S + q0) * a.H + h;
      load_rows<D>(Os, a.dout + row0 * D, static_cast<long long>(a.H) * D,
                   nrows);
      if (tid < BT) {
        const bool in = tid < nrows;
        Lse[tid] = in ? -a.lse[row0 + tid * a.H] * LOG2E : 0.f;
        Dl[tid] = in ? a.delta[row0 + tid * a.H] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      dot_tile<D>(Ks, Qs, s);       // S^T [kv][q]
      dot_tile<D>(Vs, Os, dp);      // dP^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = ty + i * TY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + j * TX;
          const bool ok = c < ncols && r < nrows &&
                          sees(q_lo + r, Pos[c], a.causal, a.window);
          const float p = ok ? exp2f(fmaf(s[i][j], a.scale_log2, Lse[r])) : 0.f;
          Ps[c * PS + r] = p;
          Ds[c * PS + r] = p * (dp[i][j] - Dl[r]);
        }
      }
      __syncthreads();
      acc_tile<D>(Ps, Os, dv);
      acc_tile<D>(Ds, Qs, dk);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + i * TY;
    if (c >= ncols) continue;
    const long long row =
        ((static_cast<long long>(b) * a.T + k0 + c) * a.KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int d = tx + j * TX;
      if (D % TX == 0 || d < D) {
        a.dk[row + d] = dk[i][j] * a.scale;
        a.dv[row + d] = dv[i][j];
      }
    }
  }
}

// (c): one block per (q tile, head, batch).
template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(const Args a) {
  constexpr int LD = D + 1;
  constexpr int OPT = (D + TX - 1) / TX;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BT][LD]
  float* Os = Qs + BT * LD;         // dO
  float* Ks = Os + BT * LD;
  float* Vs = Ks + BT * LD;
  float* Ds = Vs + BT * LD;         // dS [q][kv]
  float* Lse = Ds + BT * PS;
  float* Dl = Lse + BT;
  int* Pos = reinterpret_cast<int*>(Dl + BT);

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int iq = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int q0 = iq * BT;
  const int nrows = min(BT, a.S - q0);
  const int q_lo = a.q_offset + q0, q_hi = q_lo + nrows - 1;

  load_rows<D>(Qs, a.q + b * a.q_sb + h * a.q_sh + q0 * a.q_ss, a.q_ss, nrows);
  const long long row0 = (static_cast<long long>(b) * a.S + q0) * a.H + h;
  load_rows<D>(Os, a.dout + row0 * D, static_cast<long long>(a.H) * D, nrows);
  if (tid < BT) {
    const bool in = tid < nrows;
    Lse[tid] = in ? -a.lse[row0 + tid * a.H] * LOG2E : 0.f;
    Dl[tid] = in ? a.delta[row0 + tid * a.H] : 0.f;
  }

  float dq[4][OPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OPT; ++j) dq[i][j] = 0.f;

  const int ntiles = (a.T + BT - 1) / BT;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BT;
    const int ncols = min(BT, a.T - k0);
    __syncthreads();                // the previous tile is read
    if (tid < BT)
      Pos[tid] = tid < ncols ? (a.kv_pos != nullptr ? a.kv_pos[k0 + tid]
                                                    : k0 + tid)
                             : 0;
    __syncthreads();
    int lo = INT_MAX, hi = INT_MIN;
    for (int c = 0; c < ncols; ++c) {
      lo = min(lo, Pos[c]);
      hi = max(hi, Pos[c]);
    }
    if (a.causal && lo > q_hi) continue;
    if (a.window > 0 && q_lo - hi >= a.window) continue;
    load_rows<D>(Ks, a.k + b * a.k_sb + kvh * a.k_sh + k0 * a.k_ss, a.k_ss,
                 ncols);
    load_rows<D>(Vs, a.v + b * a.v_sb + kvh * a.v_sh + k0 * a.v_ss, a.v_ss,
                 ncols);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(Qs, Ks, s);         // S [q][kv]
    dot_tile<D>(Os, Vs, dp);        // dP
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + i * TY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + j * TX;
        const bool ok = c < ncols && r < nrows &&
                        sees(q_lo + r, Pos[c], a.causal, a.window);
        const float p = ok ? exp2f(fmaf(s[i][j], a.scale_log2, Lse[r])) : 0.f;
        Ds[r * PS + c] = p * (dp[i][j] - Dl[r]);
      }
    }
    __syncthreads();
    acc_tile<D>(Ds, Ks, dq);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + i * TY;
    if (r >= nrows) continue;
    const long long row = (row0 + static_cast<long long>(r) * a.H) * D;
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int d = tx + j * TX;
      if (D % TX == 0 || d < D) a.dq[row + d] = dq[i][j] * a.scale;
    }
  }
}

template <int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto dkdv = flash_bwd_dkdv_kernel<D>;
  auto dqk = flash_bwd_dq_kernel<D>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(dkdv,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dqk,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  const dim3 grid_kv((a.T + BT - 1) / BT, a.KV, B);
  dkdv<<<grid_kv, NTHREADS, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_q((a.S + BT - 1) / BT, a.H, B);
  dqk<<<grid_q, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace f32

// ----------------------------------------------------- bf16, tensor cores
namespace tc {

constexpr int NCONS = 256;            // consumer threads: 2 warpgroups
constexpr int NTHREADS = NCONS + 128; // and a producer warpgroup
constexpr int PROD_REGS = 40;         // 128 x 40 + 256 x 232 <= 65536
constexpr int CONS_REGS = 232;
constexpr int OWN = 128;              // rows of the tile a block owns

// Rows of a streamed tile for head dim D, in the dK/dV kernel and in the
// dQ kernel.
template <int D>
struct Stream {
  static constexpr int DKDV = 64;
  static constexpr int DQ = D <= 64 ? 128 : 64;
};

struct Args {
  // (b): q/do boxes of streamed rows, k/v boxes of OWN rows; (c) the reverse
  hopper::TensorMap qmap, omap, kmap, vmap;   // 4-d: (d, row, head, batch)
  const int* kv_pos;
  const float* lse;
  const float* delta;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int S, T, H, KV;
  float scale, scale_log2;
  int causal, window, q_offset;
};

// Head-dim geometry: the padded head dim, its swizzle and column blocks.
template <int D>
struct Dim {
  static constexpr int DP = D < 16 ? 16 : D;              // padded head dim
  static constexpr int SW = 2 * DP < 128 ? 2 * DP : 128;  // swizzle bytes
  static constexpr int CB = 2 * DP / SW;                  // column blocks
};

// Shared-memory geometry for head dim D and streamed tiles of STR rows: an
// owned tile of OWN rows (two, K and V or Q and dO) and a ring of STAGES
// stages of two streamed tiles.  A tile is CB column blocks of SW bytes a
// row; every block starts on a 1024-byte boundary.
template <int D, int STR>
struct Geo : Dim<D> {
  using Dim<D>::SW;
  using Dim<D>::CB;
  static constexpr int OWN_BLOCK = OWN * SW;
  static constexpr int OWN_BYTES = CB * OWN_BLOCK;
  static constexpr int STR_BLOCK = STR * SW;
  static constexpr int STR_BYTES = CB * STR_BLOCK;
  static constexpr int STAGES = 4;
  static constexpr int OFF_OWN2 = OWN_BYTES;
  static constexpr int OFF_STR = 2 * OWN_BYTES;              // first stream
  static constexpr int OFF_STR2 = OFF_STR + STAGES * STR_BYTES;
  static constexpr int OFF_LSE = OFF_STR2 + STAGES * STR_BYTES;  // [ST][STR]
  static constexpr int OFF_DELTA = OFF_LSE + STAGES * STR * 4;
  static constexpr int OFF_POS = OFF_DELTA + STAGES * STR * 4;
  static constexpr int POS_INTS = STAGES * STR > OWN ? STAGES * STR : OWN;
  static constexpr int OFF_INFO = OFF_POS + POS_INTS * 4;       // [ST][4]
  static constexpr int OFF_BAR = OFF_INFO + STAGES * 16;
  // own_full, then full and empty for each stage
  static constexpr int SMEM = 1024 + OFF_BAR + 8 * (1 + 2 * STAGES);
  static_assert(SMEM <= 232448, "the ring does not fit in shared memory");
};

// P (f32, in an accumulator's layout) -> A operands of k16 steps, in bf16.
template <int N>
__device__ __forceinline__ void pack(const float (&p)[N / 2],
                                     uint32_t (&pf)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pf[kk][j] = hopper::pack_bf16x2(p[8 * kk + 2 * j], p[8 * kk + 2 * j + 1]);
}

// acc (m64 x N) = A B^T over the head dim: A is 64 rows of a K-major tile
// at a_addr (column blocks a_block bytes apart), B the N rows of a K-major
// tile at b_addr (column blocks b_block apart).  Issued and committed.
template <int D, int N>
__device__ __forceinline__ void issue_dot(float (&acc)[N / 2], uint32_t a_addr,
                                          int a_block, uint32_t b_addr,
                                          int b_block) {
  using namespace hopper;
  using G = Dim<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < G::DP / 16; ++kk) {
    const int cb = kk * 32 / G::SW, in = kk * 32 % G::SW;
    Wgmma<N>::template ss<0>(
        acc, smem_desc(a_addr + cb * a_block + in, G::SW, 0, 8 * G::SW),
        smem_desc(b_addr + cb * b_block + in, G::SW, 0, 8 * G::SW), kk > 0);
  }
  wgmma_commit();
}

// acc (m64 x DP) += P X over the N rows of X: P from registers (pf), X a
// tile at x_addr read MN-major (column blocks x_block bytes apart).
// Issued, not committed.
template <int D, int N>
__device__ __forceinline__ void issue_acc(float (&acc)[Dim<D>::DP / 2],
                                          const uint32_t (&pf)[N / 16][4],
                                          uint32_t x_addr, int x_block) {
  using namespace hopper;
  using G = Dim<D>;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    Wgmma<G::DP>::template rs<1>(
        acc, pf[kk],
        smem_desc(x_addr + kk * 16 * G::SW, G::SW, x_block, 8 * G::SW), 1);
}

__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(empty);
}

// Range of the positions of the n keys from k0 (kv_pos, or k0 + c), over
// the producer warp.
__device__ __forceinline__ void key_range(const Args& a, int k0, int n,
                                          int lane, int& lo, int& hi) {
  if (a.kv_pos == nullptr) {
    lo = k0;
    hi = k0 + n - 1;
    return;
  }
  lo = INT_MAX;
  hi = INT_MIN;
  for (int c = lane; c < n; c += 32) {
    lo = min(lo, a.kv_pos[k0 + c]);
    hi = max(hi, a.kv_pos[k0 + c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// (b): dK and dV of one 128-row KV tile of one KV head.
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dkdv_kernel_tc(const __grid_constant__ Args a) {
  using namespace hopper;
  constexpr int BM = Stream<D>::DKDV;
  using G = Geo<D, BM>;
  constexpr int DP = G::DP, SW = G::SW, STAGES = G::STAGES;
  extern __shared__ float smem[];
  const uint32_t s0 = smem_addr(smem);
  char* base = reinterpret_cast<char*>(smem) + ((1024 - (s0 & 1023)) & 1023);
  char* Ks = base;
  char* Vs = base + G::OFF_OWN2;
  char* Qs = base + G::OFF_STR;
  char* Os = base + G::OFF_STR2;
  float* Lse = reinterpret_cast<float*>(base + G::OFF_LSE);
  float* Dl = reinterpret_cast<float*>(base + G::OFF_DELTA);
  int* Pos = reinterpret_cast<int*>(base + G::OFF_POS);      // [OWN]
  int* Info = reinterpret_cast<int*>(base + G::OFF_INFO);    // tile, masked
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + G::OFF_BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  // causal: the grid's slowest index is the KV tile, so the first tiles
  // (which the most q tiles see) start first; else the tiles of one head
  // are neighbours and share its q tiles in L2
  const int kvh = a.causal ? blockIdx.x : blockIdx.y;
  const int b = a.causal ? blockIdx.y : blockIdx.z;
  const int Gq = a.H / a.KV;
  const int k0 = (a.causal ? blockIdx.z : blockIdx.x) * OWN;
  const int ncols = min(OWN, a.T - k0);

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], NCONS / 32);   // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NCONS) {
    // ---- producer warpgroup: its first warp loads K and V once, then the
    // q tiles (Q, dO, -lse log2 e, delta) of every query head of the group
    // that see the KV tile, then an end marker; the other three leave
    setmaxnreg_dec<PROD_REGS>();
    if (tid >= NCONS + 32) return;
    const int lane = tid - NCONS;
    int lo, hi;
    key_range(a, k0, ncols, lane, lo, hi);
    if (a.kv_pos != nullptr)
      for (int c = lane; c < OWN; c += 32)
        Pos[c] = c < ncols ? a.kv_pos[k0 + c] : 0;
    __syncwarp();
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * G::OWN_BYTES);
      for (int c = 0; c < G::CB; ++c) {
        tma_load_4d(Ks + c * G::OWN_BLOCK, &a.kmap, kv_full, c * (SW / 2), k0,
                    kvh, b);
        tma_load_4d(Vs + c * G::OWN_BLOCK, &a.vmap, kv_full, c * (SW / 2), k0,
                    kvh, b);
      }
    }
    const int nq = (a.S + BM - 1) / BM;
    int it = 0;
    for (int g = 0; g <= Gq; ++g) {
      const bool end = g == Gq;
      for (int t = 0; t < (end ? 1 : nq); ++t) {
        const int q0 = t * BM;
        int masked = 0;
        if (!end) {
          const int nrows = min(BM, a.S - q0);
          const int q_lo = a.q_offset + q0, q_hi = q_lo + nrows - 1;
          // block-uniform skip of a q tile that sees none of the KV tile
          if (a.causal && lo > q_hi) continue;
          if (a.window > 0 && q_lo - hi >= a.window) continue;
          masked = nrows < BM || ncols < OWN || (a.causal && hi > q_lo) ||
                   (a.window > 0 && q_hi - lo >= a.window);
        }
        // the tile's lse and delta rows (strided by H) are loaded before
        // the wait for its stage, so their latency runs under it
        const int h = kvh * Gq + g;
        float nl[BM / 32], dl[BM / 32];
#pragma unroll
        for (int j = 0; j < BM / 32; ++j) {
          const int r = lane + 32 * j;
          const bool in = !end && q0 + r < a.S;
          const long long row =
              (static_cast<long long>(b) * a.S + q0 + r) * a.H + h;
          nl[j] = in ? -a.lse[row] * LOG2E : 0.f;
          dl[j] = in ? a.delta[row] : 0.f;
        }
        const int st = it % STAGES;
        mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
#pragma unroll
        for (int j = 0; j < BM / 32; ++j) {
          Lse[st * BM + lane + 32 * j] = nl[j];
          Dl[st * BM + lane + 32 * j] = dl[j];
        }
        if (lane == 0) {
          Info[4 * st] = end ? -1 : t;
          Info[4 * st + 1] = masked;
        }
        __syncwarp();
        if (lane == 0) {
          if (end) {
            mbar_arrive(&full[st]);
          } else {
            mbar_arrive_expect_tx(&full[st], 2 * G::STR_BYTES);
            for (int c = 0; c < G::CB; ++c) {
              tma_load_4d(Qs + st * G::STR_BYTES + c * G::STR_BLOCK, &a.qmap,
                          &full[st], c * (SW / 2), q0, h, b);
              tma_load_4d(Os + st * G::STR_BYTES + c * G::STR_BLOCK, &a.omap,
                          &full[st], c * (SW / 2), q0, h, b);
            }
          }
        }
        ++it;
      }
    }
  } else {
    // ---- consumer warpgroup w: KV rows w*64 .. w*64 + 63 of the tile.
    setmaxnreg_inc<CONS_REGS>();
    const int w = tid / 128;
    const int l = tid % 32;
    const int row0 = w * 64 + 16 * ((tid % 128) / 32) + l / 4;
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t k_addr = smem_addr(Ks) + w * 64 * SW;
    const uint32_t v_addr = smem_addr(Vs) + w * 64 * SW;
    mbar_wait(kv_full, 0);
    for (int it = 0;; ++it) {
      const int st = it % STAGES;
      const uint32_t parity = (it / STAGES) & 1;
      // one wait for Q and dO: a wait loop between the two products
      // makes ptxas wait for the first inside it
      mbar_wait(&full[st], parity);
      const int t = Info[4 * st];
      if (t < 0) break;
      const bool masked = Info[4 * st + 1] != 0;
      const uint32_t q_addr = smem_addr(Qs + st * G::STR_BYTES);
      const uint32_t o_addr = smem_addr(Os + st * G::STR_BYTES);
      float s[BM / 2], dp[BM / 2];
      issue_dot<D, BM>(s, k_addr, G::OWN_BLOCK, q_addr, G::STR_BLOCK);
      issue_dot<D, BM>(dp, v_addr, G::OWN_BLOCK, o_addr, G::STR_BLOCK);
      wgmma_wait<1>();                 // S^T is done; dP^T may still run
      fence_regs(s);
      const float* nlse = Lse + st * BM;
      const float* delta = Dl + st * BM;
      const int q_lo = a.q_offset + t * BM;
      // a tile that every pair sees takes the loop without the mask: a
      // test inside one unrolled loop is kept for every element
      if (masked) {
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) {
          const int c = 8 * (i / 4) + 2 * (l % 4) + i % 2;   // q in the tile
          const int r = row0 + 8 * ((i / 2) % 2);            // KV row
          const int kp = a.kv_pos != nullptr ? Pos[r] : k0 + r;
          const bool ok = t * BM + c < a.S && r < ncols &&
                          sees(q_lo + c, kp, a.causal, a.window);
          s[i] = ok ? exp2_ftz(fmaf(s[i], a.scale_log2, nlse[c])) : 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) {
          const int c = 8 * (i / 4) + 2 * (l % 4) + i % 2;
          s[i] = exp2_ftz(fmaf(s[i], a.scale_log2, nlse[c]));
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) {
        const int c = 8 * (i / 4) + 2 * (l % 4) + i % 2;
        dp[i] = s[i] * (dp[i] - delta[c]);
      }
      uint32_t pf[BM / 16][4], df[BM / 16][4];
      pack<BM>(s, pf);
      pack<BM>(dp, df);
      fence_regs(pf);
      fence_regs(df);
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
      issue_acc<D, BM>(dv, pf, o_addr, G::STR_BLOCK);    // dV += P^T dO
      issue_acc<D, BM>(dk, df, q_addr, G::STR_BLOCK);    // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      release(&empty[st]);
    }

#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int r = row0 + 8 * ((i / 2) % 2);
      const int col = 8 * (i / 4) + 2 * (l % 4);
      if (r < ncols && col < D) {
        const long long off =
            ((static_cast<long long>(b) * a.T + k0 + r) * a.KV + kvh) * D +
            col;
        *reinterpret_cast<uint32_t*>(a.dk + off) =
            pack_bf16x2(dk[i] * a.scale, dk[i + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(a.dv + off) = pack_bf16x2(dv[i], dv[i + 1]);
      }
    }
  }
}

// (c): dQ of one 128-row q tile of one head.
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq_kernel_tc(const __grid_constant__ Args a) {
  using namespace hopper;
  constexpr int BN = Stream<D>::DQ;
  using G = Geo<D, BN>;
  constexpr int DP = G::DP, SW = G::SW, STAGES = G::STAGES;
  extern __shared__ float smem[];
  const uint32_t s0 = smem_addr(smem);
  char* base = reinterpret_cast<char*>(smem) + ((1024 - (s0 & 1023)) & 1023);
  char* Qs = base;
  char* Os = base + G::OFF_OWN2;
  char* Ks = base + G::OFF_STR;
  char* Vs = base + G::OFF_STR2;
  int* Pos = reinterpret_cast<int*>(base + G::OFF_POS);      // [ST][BN]
  int* Info = reinterpret_cast<int*>(base + G::OFF_INFO);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + G::OFF_BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  // heavy causal tiles (the last) first, over every head and batch as the
  // dK/dV kernel
  const int iq = a.causal ? gridDim.z - 1 - blockIdx.z
                          : gridDim.x - 1 - blockIdx.x;
  const int h = a.causal ? blockIdx.x : blockIdx.y;
  const int b = a.causal ? blockIdx.y : blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int q0 = iq * OWN;
  const int nrows = min(OWN, a.S - q0);
  const int q_lo = a.q_offset + q0;
  const int q_hi = q_lo + nrows - 1;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], NCONS / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NCONS) {
    // ---- producer: Q and dO once, then the visible K/V tiles, then an end
    // marker
    setmaxnreg_dec<PROD_REGS>();
    if (tid >= NCONS + 32) return;
    const int lane = tid - NCONS;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * G::OWN_BYTES);
      for (int c = 0; c < G::CB; ++c) {
        tma_load_4d(Qs + c * G::OWN_BLOCK, &a.qmap, q_full, c * (SW / 2), q0,
                    h, b);
        tma_load_4d(Os + c * G::OWN_BLOCK, &a.omap, q_full, c * (SW / 2), q0,
                    h, b);
      }
    }
    const int ntiles = (a.T + BN - 1) / BN;
    int it = 0;
    for (int t = 0; t <= ntiles; ++t) {
      const bool end = t == ntiles;
      const int k0 = t * BN;
      const int st = it % STAGES;
      int masked = 0;
      if (!end) {
        const int ncols = min(BN, a.T - k0);
        int lo, hi;
        key_range(a, k0, ncols, lane, lo, hi);
        if (a.causal && lo > q_hi) continue;
        if (a.window > 0 && q_lo - hi >= a.window) continue;
        masked = ncols < BN || (a.causal && hi > q_lo) ||
                 (a.window > 0 && q_hi - lo >= a.window);
        mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);   // then the stage's
        if (a.kv_pos != nullptr)                          // positions
          for (int c = lane; c < BN; c += 32)
            Pos[st * BN + c] = c < ncols ? a.kv_pos[k0 + c] : 0;
      } else {
        mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
      }
      if (lane == 0) {
        Info[4 * st] = end ? -1 : t;
        Info[4 * st + 1] = masked;
      }
      __syncwarp();
      if (lane == 0) {
        if (end) {
          mbar_arrive(&full[st]);
        } else {
          mbar_arrive_expect_tx(&full[st], 2 * G::STR_BYTES);
          for (int c = 0; c < G::CB; ++c) {
            tma_load_4d(Ks + st * G::STR_BYTES + c * G::STR_BLOCK, &a.kmap,
                        &full[st], c * (SW / 2), k0, kvh, b);
            tma_load_4d(Vs + st * G::STR_BYTES + c * G::STR_BLOCK, &a.vmap,
                        &full[st], c * (SW / 2), k0, kvh, b);
          }
        }
      }
      ++it;
    }
  } else {
    // ---- consumer warpgroup w: q rows w*64 .. w*64 + 63 of the tile
    setmaxnreg_inc<CONS_REGS>();
    const int w = tid / 128;
    const int l = tid % 32;
    const int row0 = w * 64 + 16 * ((tid % 128) / 32) + l / 4;
    float nlse[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + row0 + 8 * r;
      const long long row = (static_cast<long long>(b) * a.S + q) * a.H + h;
      nlse[r] = q < a.S ? -a.lse[row] * LOG2E : 0.f;
      delta[r] = q < a.S ? a.delta[row] : 0.f;
    }
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
    const uint32_t q_addr = smem_addr(Qs) + w * 64 * SW;
    const uint32_t o_addr = smem_addr(Os) + w * 64 * SW;
    mbar_wait(q_full, 0);
    for (int it = 0;; ++it) {
      const int st = it % STAGES;
      const uint32_t parity = (it / STAGES) & 1;
      mbar_wait(&full[st], parity);    // K and V, as the dK/dV kernel
      const int t = Info[4 * st];
      if (t < 0) break;
      const bool masked = Info[4 * st + 1] != 0;
      const int k0 = t * BN;
      const uint32_t k_addr = smem_addr(Ks + st * G::STR_BYTES);
      const uint32_t v_addr = smem_addr(Vs + st * G::STR_BYTES);
      float s[BN / 2], dp[BN / 2];
      issue_dot<D, BN>(s, q_addr, G::OWN_BLOCK, k_addr, G::STR_BLOCK);
      issue_dot<D, BN>(dp, o_addr, G::OWN_BLOCK, v_addr, G::STR_BLOCK);
      wgmma_wait<1>();                 // S is done; dP may still run
      fence_regs(s);
      if (masked) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int r = (i / 2) % 2;
          const int c = 8 * (i / 4) + 2 * (l % 4) + i % 2;   // key in the tile
          const int kp = a.kv_pos != nullptr ? Pos[st * BN + c] : k0 + c;
          const bool ok = k0 + c < a.T &&
                          sees(q_lo + row0 + 8 * r, kp, a.causal, a.window);
          s[i] = ok ? exp2_ftz(fmaf(s[i], a.scale_log2, nlse[r])) : 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          s[i] = exp2_ftz(fmaf(s[i], a.scale_log2, nlse[(i / 2) % 2]));
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) dp[i] = s[i] * (dp[i] - delta[(i / 2) % 2]);
      uint32_t df[BN / 16][4];
      pack<BN>(dp, df);
      fence_regs(df);
      fence_regs(dq);
      wgmma_fence();
      issue_acc<D, BN>(dq, df, k_addr, G::STR_BLOCK);    // dQ += dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      release(&empty[st]);
    }

#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int r = row0 + 8 * ((i / 2) % 2);
      const int col = 8 * (i / 4) + 2 * (l % 4);
      if (r < nrows && col < D) {
        const long long off =
            ((static_cast<long long>(b) * a.S + q0 + r) * a.H + h) * D + col;
        *reinterpret_cast<uint32_t*>(a.dq + off) =
            pack_bf16x2(dq[i] * a.scale, dq[i + 1] * a.scale);
      }
    }
  }
}

// Byte stride of a dimension for its tensor map: a dimension of size 1 is
// never stepped, so any legal stride does.
inline uint64_t map_stride(long long stride, int size) {
  return size > 1 ? static_cast<uint64_t>(stride) * 2 : 16;
}

// A map of a [B, rows, heads, D] bf16 tensor with boxes of box_rows rows.
template <int D>
cudaError_t make_map(hopper::TensorMap* map, const void* x, int B, int rows,
                     int heads, long long sb, long long ss, long long sh,
                     int box_rows) {
  using G = Dim<D>;
  const uint32_t box[4] = {G::SW / 2, uint32_t(box_rows), 1, 1};
  const uint64_t dims[4] = {uint64_t(D), uint64_t(rows), uint64_t(heads),
                            uint64_t(B)};
  const uint64_t str[3] = {map_stride(ss, rows), map_stride(sh, heads),
                           map_stride(sb, B)};
  return hopper::make_tensor_map(map, x, 4, dims, str, box, G::SW);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, Args a, int B, long long q_sb,
                   long long q_ss, long long q_sh, long long k_sb,
                   long long k_ss, long long k_sh, long long v_sb,
                   long long v_ss, long long v_sh, cudaStream_t stream) {
  constexpr int BM = Stream<D>::DKDV, BN = Stream<D>::DQ;
  constexpr int SMEM_KV = Geo<D, BM>::SMEM, SMEM_Q = Geo<D, BN>::SMEM;
  const int S = a.S, T = a.T, H = a.H, KV = a.KV;
  const long long o_ss = static_cast<long long>(H) * D;
  const long long o_sb = static_cast<long long>(S) * o_ss;
  cudaError_t err;
  // (b): Q and dO streamed, K and V owned
  Args kv = a;
  if ((err = make_map<D>(&kv.qmap, q, B, S, H, q_sb, q_ss, q_sh, BM)) !=
          cudaSuccess ||
      (err = make_map<D>(&kv.omap, dout, B, S, H, o_sb, o_ss, D, BM)) !=
          cudaSuccess ||
      (err = make_map<D>(&kv.kmap, k, B, T, KV, k_sb, k_ss, k_sh, OWN)) !=
          cudaSuccess ||
      (err = make_map<D>(&kv.vmap, v, B, T, KV, v_sb, v_ss, v_sh, OWN)) !=
          cudaSuccess)
    return err;
  // (c): K and V streamed, Q and dO owned
  Args qa = a;
  if ((err = make_map<D>(&qa.qmap, q, B, S, H, q_sb, q_ss, q_sh, OWN)) !=
          cudaSuccess ||
      (err = make_map<D>(&qa.omap, dout, B, S, H, o_sb, o_ss, D, OWN)) !=
          cudaSuccess ||
      (err = make_map<D>(&qa.kmap, k, B, T, KV, k_sb, k_ss, k_sh, BN)) !=
          cudaSuccess ||
      (err = make_map<D>(&qa.vmap, v, B, T, KV, v_sb, v_ss, v_sh, BN)) !=
          cudaSuccess)
    return err;
  auto dkdv = flash_bwd_dkdv_kernel_tc<D>;
  auto dqk = flash_bwd_dq_kernel_tc<D>;
  if ((err = cudaFuncSetAttribute(
           dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_KV)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(
           dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_Q)) !=
          cudaSuccess)
    return err;
  const unsigned nkv = (T + OWN - 1) / OWN, nq = (S + OWN - 1) / OWN;
  const dim3 grid_kv = a.causal ? dim3(KV, B, nkv) : dim3(nkv, KV, B);
  dkdv<<<grid_kv, NTHREADS, SMEM_KV, stream>>>(kv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_q = a.causal ? dim3(H, B, nq) : dim3(nq, H, B);
  dqk<<<grid_q, NTHREADS, SMEM_Q, stream>>>(qa);
  return cudaGetLastError();
}

}  // namespace tc

// bf16 takes the x8 kernel (o and do are 16-byte aligned, as the wrapper
// checks for TMA), float32 the scalar one.
cudaError_t launch_delta(const DeltaArgs& d, int dtype, cudaStream_t stream) {
  if (dtype == 1) {
    const long long chunks = d.rows * (d.D / 8);
    const dim3 grid(
        static_cast<unsigned>((chunks + DELTA_THREADS - 1) / DELTA_THREADS));
    flash_bwd_delta_kernel_x8<<<grid, DELTA_THREADS, 0, stream>>>(d);
    return cudaGetLastError();
  }
  const dim3 grid(
      static_cast<unsigned>((d.rows + DELTA_ROWS_PER_BLOCK - 1) /
                            DELTA_ROWS_PER_BLOCK));
  flash_bwd_delta_kernel<<<grid, DELTA_THREADS, 0, stream>>>(d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the CUDA-core kernels), 1 = bfloat16 (the
// tensor-core kernels, which read q, k, v and do through TMA, and the delta
// kernel's 16-byte loads of o and do: 16-byte-aligned bases, strides in
// 16-byte multiples, checked by the Python wrapper).
// q/k/v strides are in elements; o, do, lse, dlse (nullable) are
// contiguous; dq, dk, dv (q's dtype) and delta (f32 [B,S,H] scratch) are
// written contiguous.  B, S, T >= 1.  Launches the three kernels on the
// stream and returns the first cudaError_t of a launch (0 on success); it
// does not synchronise.
int flash_bwd(const void* q, const void* k, const void* v, const void* o,
              const float* lse, const void* dout, const float* dlse,
              const int* kv_pos, void* dq, void* dk, void* dv, float* delta,
              int B, int S, int T, int H, int KV, int D, long long q_sb,
              long long q_ss, long long q_sh, long long k_sb, long long k_ss,
              long long k_sh, long long v_sb, long long v_ss, long long v_sh,
              float scale, int causal, int window, int q_offset, int dtype,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (D != 8 && D != 16 && D != 32 && D != 64 && D != 128)
    return cudaErrorInvalidValue;
  const DeltaArgs d{o, dout, dlse, delta,
                    static_cast<long long>(B) * S * H, D};
  cudaError_t err = launch_delta(d, dtype, s);
  if (err != cudaSuccess) return err;
  if (dtype == 0) {
    f32::Args a{static_cast<const float*>(q),
                static_cast<const float*>(k),
                static_cast<const float*>(v),
                kv_pos,
                lse,
                delta,
                static_cast<const float*>(dout),
                static_cast<float*>(dq),
                static_cast<float*>(dk),
                static_cast<float*>(dv),
                S, T, H, KV,
                q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                scale, scale * LOG2E, causal, window, q_offset};
    switch (D) {
      case 8: return f32::launch<8>(a, B, s);
      case 16: return f32::launch<16>(a, B, s);
      case 32: return f32::launch<32>(a, B, s);
      case 64: return f32::launch<64>(a, B, s);
      default: return f32::launch<128>(a, B, s);
    }
  }
  tc::Args a;
  a.kv_pos = kv_pos;
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.S = S;
  a.T = T;
  a.H = H;
  a.KV = KV;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
#define FLASH_BWD_TC(DIM)                                                   \
  case DIM:                                                                 \
    return tc::launch<DIM>(q, k, v, dout, a, B, q_sb, q_ss, q_sh, k_sb,     \
                           k_ss, k_sh, v_sb, v_ss, v_sh, s)
  switch (D) {
    FLASH_BWD_TC(8);
    FLASH_BWD_TC(16);
    FLASH_BWD_TC(32);
    FLASH_BWD_TC(64);
    default: FLASH_BWD_TC(128);
  }
#undef FLASH_BWD_TC
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
