// Mamba-2 SSD chunked scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/ssd_pallas.py::_kernel (launched by
// _ssd_fwd_pallas through pl.pallas_call).  It computes the same function:
// for x [b,s,h,p], dt [b,s,h] (after softplus), A [h], B and C [b,s,n]
// shared by all heads (ngroups = 1) and D [h], split into chunks of Q
// tokens, with cum = cumsum(A dt) inside each chunk,
//   y     = (C B^T . tril(exp(cum_i - cum_j))) (dt . x)
//           + exp(cum) . (C H_prev^T) + D x
//   H_new = exp(cum_Q) H_prev + ((exp(cum_Q - cum) . dt) . x)^T B,
// and optionally the final state H [b,h,p,n] in f32.  Sums are f32 on bf16
// or f32 inputs.  The D x skip is added here in f32 before the one
// rounding of y, as repro/kernels/ssd_scan.py::ssd_chunked_jnp does (the
// Pallas wrapper rounds y first and adds the skip after).  The plain
// version is repro_torch/kernels/ref.py::ssd_scan_ref.
//
// What bounds it on an H100: at mamba2-130m's training and prefill shape
// (b=4, s=4096, h=24, p=64, n=128, bf16) the function's products are ~16
// GFLOP (C B^T once per (b, chunk); the intra-chunk, inter-chunk and state
// products) against ~111 MB that must move (x and y 50 MB each, dt, B,
// C): 0.017 ms at the bf16 tensor-core peak against 0.033 ms at 3.35 TB/s,
// so the bound is memory.
//
// Both paths split the chunk recurrence out (the chunk-parallel form of
// the Mamba-2 paper, section 6): the Pallas kernel runs its grid (b, h,
// chunk) with the chunk axis sequential and the [p,n] state carried in
// VMEM, but Hopper runs blocks in no order.  Common to both:
//   * exp(cum_i - cum_j) is computed only where i >= j: above the diagonal
//     the difference is a positive sum that overflows f32 at long chunks
//     (ROADMAP.md, C3);
//   * a fixed chunk of Q = 64 tokens (the reference halves its chunk until
//     it divides s, down to 2 for s = 4094); the ragged last chunk is
//     masked: its missing tokens count as dt = 0, x = B = C = 0, which
//     leave the state unchanged, and their y is not written;
//   * x, dt, B and C are read through their strides, so the model's slices
//     of the convolution output are never copied.
//
// bf16 -> two kernels on the tensor cores (hopper.cuh), a producer warp
// and one consumer warpgroup each, two blocks an SM:
//   1. ssd_state_kernel_tc, per (64 rows and 64 columns of the state,
//      head, batch): walks the chunks in order with the f32 state H in
//      registers.  Per chunk it issues S_c = (w . x)^T B into a wgmma
//      accumulator (m64n64k16, M = p, K = the chunk's tokens; w = exp(cum_Q
//      - cum) dt applied to x on its way into the register A operand, B
//      MN-major), writes H (the state entering the chunk, as bf16 hi + lo:
//      kernel 2's B operands) while the product runs, then sets H =
//      exp(cum_Q) H + S_c.  The writes go through a per-warp buffer in
//      shared memory as 16-byte pieces of rows.  x and B tiles come through
//      a ring of 4 stages, so the next chunks' loads overlap this chunk's
//      work; the producer warp computes cum by a warp scan, dt loaded a
//      chunk ahead;
//   2. ssd_output_kernel_tc, per (chunk, group of 24 heads, batch): C and B
//      come in once and C B^T (m64n64k16, both K-major) is computed once
//      for the group; per head, over a ring of 2 stages holding x and the
//      entering state: y = C H^T (m64npk16 from shared memory); while it
//      runs, P = C B^T . exp(cum_i - cum_j) dt_j (i >= j) is formed in
//      registers from the C B^T accumulator as a register A operand; then y
//      is scaled by exp(cum_i) in f32 and y += P x with x MN-major; the D x
//      skip and the one rounding of y in the epilogue.  dt of the group is
//      one [Q x 24] read, cum of each head a warp scan by the producer.
//   Precision: bf16 operands with f32 accumulators, but w . x, P and H are
//   f32 values; each is split into hi = bf16(v) and lo = bf16(v - hi) and
//   both parts go into the same accumulator (x, B and C are bf16 already).
//   One bf16 part alone puts y 0.1 off relative to 1 + |y| at the main
//   shape (C H^T cancels), the split leaves ~2^-17.
//   The f32 state traffic is one write and one read of the entering states
//   (b h nc p n x 4 bytes: 201.3 MB each way at the main shape, 402.7 MB in
//   all), beside the function's 111 MB.  Tiles are rows of 64 bf16 with the
//   128B swizzle, p and n padded to 64 or 128 (zeros past them).  x, B and
//   C come by TMA (4-d over x, 3-d over B and C, zero fill past s); where
//   the wrapper finds one of them outside TMA's preconditions
//   (kernels/tma.py) the producer loads all three by threads into the same
//   layout.  The entering states always come by TMA.
//   At the main shape it takes 0.268 ms (the state kernel 0.110, the output
//   kernel 0.151), 8.1x its bound, from 1.614 ms on the CUDA cores (H100
//   80GB HBM3 at 700 W, chip_smoke.py).
// f32 -> three kernels, f32 FMAs on the CUDA cores (67 TFLOP/s peak), for
// the f32 checks (TF32 would break their tolerances):
//   1. per (chunk, h, b): cum by one thread, written out for kernels 2 and
//      3, and the chunk's own state S_c to f32 scratch [b,h,nc,p,n];
//   2. per (b, h, 256 state elements): the sequential pass over the chunks
//      H_c = exp(cum_Q) H_{c-1} + S_c, overwriting each S_c with the state
//      entering its chunk, and the final state; each thread keeps 16 loads
//      of S_c in flight;
//   3. per (chunk, h, b): y from C B^T (recomputed per head), the masked
//      decay, x, the entering state and D.
//   Each stages its tiles in shared memory as f32 with rows padded to an
//   odd length; each thread computes a 4 x 4 tile from four A and four B
//   values per step, so shared-memory reads limit it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int Q = 64;              // tokens per chunk
constexpr int MAX_P = 128;
constexpr int MAX_N = 128;

// ------------------------------------------------------ f32, CUDA cores --
constexpr int TX = 16;             // threads across an output tile's columns
constexpr int TY = 16;             // threads across its rows
constexpr int NTHREADS = TX * TY;
constexpr int TILE = 64;           // output tile: 4 x 4 values per thread
constexpr int RPT = TILE / TY;
constexpr int CPT = TILE / TX;
constexpr int PASS_THREADS = 256;
constexpr int PASS_BATCH = 16;           // chunk-state loads in flight

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* D;
  float* y;
  float* cum;                      // [b][h][nc][Q]
  float* states;                   // [b][h][nc][p][n]
  float* final_state;              // [b][h][p][n] or null
  int b, s, h, p, n, nc;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, B_sb, B_ss, C_sb, C_ss;
};

// acc[i][j] += sum_{k < K} a[r_i * a_r + k * a_k] * b[c_j * b_c + k * b_k]
// with r_i = r0 + ty + i*TY and c_j = c0 + tx + j*TX, clamped to the rows
// and columns that exist (the caller writes only those back).
__device__ __forceinline__ void tile_product(
    const float* a, int a_r, int a_k, int rows, int r0, const float* b,
    int b_c, int b_k, int cols, int c0, int K, float (&acc)[RPT][CPT]) {
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  int ra[RPT], cb[CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) ra[i] = min(r0 + ty + i * TY, rows - 1) * a_r;
#pragma unroll
  for (int j = 0; j < CPT; ++j) cb[j] = min(c0 + tx + j * TX, cols - 1) * b_c;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RPT], bv[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) av[i] = a[ra[i] + k * a_k];
#pragma unroll
    for (int j = 0; j < CPT; ++j) bv[j] = b[cb[j] + k * b_k];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[RPT][CPT]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
}

// Kernel 1: grid (nc, h, b).  cum of the chunk, and its own state S_c.
__global__ void __launch_bounds__(NTHREADS) ssd_chunk_state_kernel(const Args a) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int p = a.p, n = a.n;
  const int t0 = c * Q;
  const int len = min(Q, a.s - t0);
  float* cum = smem;                       // [Q]
  float* wx = cum + Q;                     // [Q][p + 1]: w_t x_t
  float* Bs = wx + Q * (p + 1);            // [Q][n + 1]
  const float* x = a.x + bb * a.x_sb + t0 * a.x_ss + hh * a.x_sh;
  const float* B = a.B + bb * a.B_sb + t0 * a.B_ss;
  const float* dt = a.dt + bb * a.dt_sb + t0 * a.dt_ss + hh;

  for (int t = tid; t < Q; t += NTHREADS) cum[t] = t < len ? dt[t * a.dt_ss] : 0.f;
  __syncthreads();
  if (tid == 0) {                          // sequential, as cumsum
    const float A = a.A[hh];
    float run = 0.f;
    for (int t = 0; t < Q; ++t) {
      run += A * cum[t];
      cum[t] = run;
    }
  }
  __syncthreads();
  float* cum_out = a.cum + ((static_cast<long long>(bb) * a.h + hh) * a.nc + c) * Q;
  for (int t = tid; t < Q; t += NTHREADS) cum_out[t] = cum[t];
  const float cum_end = cum[Q - 1];
  for (int i = tid; i < Q * p; i += NTHREADS) {
    const int t = i / p, k = i % p;
    float v = 0.f;
    if (t < len) v = expf(cum_end - cum[t]) * dt[t * a.dt_ss] * x[t * a.x_ss + k];
    wx[t * (p + 1) + k] = v;
  }
  for (int i = tid; i < Q * n; i += NTHREADS) {
    const int t = i / n, k = i % n;
    Bs[t * (n + 1) + k] = t < len ? B[t * a.B_ss + k] : 0.f;
  }
  __syncthreads();

  const int tx = tid % TX, ty = tid / TX;
  float* out = a.states + ((static_cast<long long>(bb) * a.h + hh) * a.nc + c) * p * n;
  for (int p0 = 0; p0 < p; p0 += TILE)
    for (int n0 = 0; n0 < n; n0 += TILE) {
      float acc[RPT][CPT];
      zero(acc);
      // S_c[pi][nj] = sum_t wx[t][pi] Bs[t][nj]
      tile_product(wx, 1, p + 1, p, p0, Bs, 1, n + 1, n, n0, Q, acc);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int pi = p0 + ty + i * TY, nj = n0 + tx + j * TX;
          if (pi < p && nj < n) out[pi * n + nj] = acc[i][j];
        }
    }
}

// Kernel 2: grid (ceil(p n / PASS_THREADS), h, b).  One thread per state
// element walks the chunks in order.  The chain H -> H' is sequential, but
// the loads of S_c are not: each thread issues PASS_BATCH of them before it
// uses the first, so that many loads are in flight (with one at a time,
// each waiting on the last, this pass took most of the three kernels'
// time).  The chunk decays exp(cum_Q) are read once per block into shared
// memory.
__global__ void __launch_bounds__(PASS_THREADS) ssd_state_pass_kernel(const Args a) {
  extern __shared__ float smem[];
  float* decay = smem;                     // [nc]
  const int hh = blockIdx.y, bb = blockIdx.z;
  const long long bh = static_cast<long long>(bb) * a.h + hh;
  for (int c = threadIdx.x; c < a.nc; c += PASS_THREADS)
    decay[c] = expf(a.cum[(bh * a.nc + c) * Q + (Q - 1)]);
  __syncthreads();
  const int e = blockIdx.x * PASS_THREADS + threadIdx.x;
  const long long pn = static_cast<long long>(a.p) * a.n;
  if (e >= pn) return;
  float* __restrict__ st = a.states + bh * a.nc * pn + e;
  float H = 0.f;
  for (int c0 = 0; c0 < a.nc; c0 += PASS_BATCH) {
    float S[PASS_BATCH];
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k)
      S[k] = c0 + k < a.nc ? st[(c0 + k) * pn] : 0.f;
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k)
      if (c0 + k < a.nc) {
        st[(c0 + k) * pn] = H;
        H = fmaf(H, decay[c0 + k], S[k]);
      }
  }
  if (a.final_state != nullptr) a.final_state[bh * pn + e] = H;
}

// Kernel 3: grid (nc, h, b).  The chunk's output.
__global__ void __launch_bounds__(NTHREADS) ssd_chunk_output_kernel(const Args a) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int p = a.p, n = a.n;
  const int t0 = c * Q;
  const int len = min(Q, a.s - t0);
  float* cum = smem;                       // [Q]
  float* dts = cum + Q;                    // [Q]
  float* Cs = dts + Q;                     // [Q][n + 1]
  float* BH = Cs + Q * (n + 1);            // [max(Q, p)][n + 1]: B, then H
  float* Sm = BH + max(Q, p) * (n + 1);    // [Q][Q + 1]: masked scores
  float* xs = Sm + Q * (Q + 1);            // [Q][p + 1]
  const long long bh = static_cast<long long>(bb) * a.h + hh;
  const float* x = a.x + bb * a.x_sb + t0 * a.x_ss + hh * a.x_sh;
  const float* B = a.B + bb * a.B_sb + t0 * a.B_ss;
  const float* C = a.C + bb * a.C_sb + t0 * a.C_ss;
  const float* dt = a.dt + bb * a.dt_sb + t0 * a.dt_ss + hh;
  const float* cum_in = a.cum + (bh * a.nc + c) * Q;

  for (int t = tid; t < Q; t += NTHREADS) {
    cum[t] = cum_in[t];
    dts[t] = t < len ? dt[t * a.dt_ss] : 0.f;
  }
  for (int i = tid; i < Q * n; i += NTHREADS) {
    const int t = i / n, k = i % n;
    const bool in = t < len;
    Cs[t * (n + 1) + k] = in ? C[t * a.C_ss + k] : 0.f;
    BH[t * (n + 1) + k] = in ? B[t * a.B_ss + k] : 0.f;
  }
  for (int i = tid; i < Q * p; i += NTHREADS) {
    const int t = i / p, k = i % p;
    xs[t * (p + 1) + k] = t < len ? x[t * a.x_ss + k] : 0.f;
  }
  __syncthreads();

  {  // Sm[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
    float acc[RPT][CPT];
    zero(acc);
    tile_product(Cs, n + 1, 1, Q, 0, BH, n + 1, 1, Q, 0, n, acc);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = ty + i * TY, q = tx + j * TX;
        Sm[r * (Q + 1) + q] =
            q <= r ? acc[i][j] * expf(cum[r] - cum[q]) * dts[q] : 0.f;
      }
  }
  __syncthreads();                         // every thread is done with B
  const float* H = a.states + (bh * a.nc + c) * p * n;
  for (int i = tid; i < p * n; i += NTHREADS) {
    const int r = i / n, k = i % n;
    BH[r * (n + 1) + k] = H[i];
  }
  __syncthreads();

  const float Dh = a.D[hh];
  float* y = a.y + ((static_cast<long long>(bb) * a.s + t0) * a.h + hh) * p;
  const long long y_ss = static_cast<long long>(a.h) * p;
  for (int p0 = 0; p0 < p; p0 += TILE) {
    float intra[RPT][CPT], inter[RPT][CPT];
    zero(intra);
    zero(inter);
    tile_product(Sm, Q + 1, 1, Q, 0, xs, 1, p + 1, p, p0, Q, intra);
    tile_product(Cs, n + 1, 1, Q, 0, BH, n + 1, 1, p, p0, n, inter);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + i * TY;
      const float decay = expf(cum[r]);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int pc = p0 + tx + j * TX;
        if (r < len && pc < p)
          y[r * y_ss + pc] = intra[i][j] + decay * inter[i][j] +
                             Dh * xs[r * (p + 1) + pc];
      }
    }
  }
}

size_t state_smem(int p, int n) {
  return sizeof(float) * (Q + Q * (p + 1) + Q * (n + 1));
}

size_t output_smem(int p, int n) {
  const int rows = p > Q ? p : Q;
  return sizeof(float) * (2 * Q + Q * (n + 1) + rows * (n + 1) +
                          Q * (Q + 1) + Q * (p + 1));
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem1 = state_smem(a.p, a.n);
  const size_t smem2 = sizeof(float) * a.nc;
  const size_t smem3 = output_smem(a.p, a.n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_state_pass_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunk_output_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem3);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.nc, a.h, a.b);
  ssd_chunk_state_kernel<<<grid, NTHREADS, smem1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int pn = a.p * a.n;
  const dim3 pass_grid((pn + PASS_THREADS - 1) / PASS_THREADS, a.h, a.b);
  ssd_state_pass_kernel<<<pass_grid, PASS_THREADS, smem2, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_chunk_output_kernel<<<grid, NTHREADS, smem3, stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------------ bf16, tensor cores
namespace tc {

constexpr int SW = 128;            // every tile: rows of 64 bf16, 128B swizzle
constexpr int COLS = SW / 2;       // elements in a row of a column block
constexpr int NCONS = 128;         // one consumer warpgroup
constexpr int NTHREADS = NCONS + 32;   // and a producer warp
constexpr int GROUP = 24;          // heads per block of the output kernel

struct Args {
  hopper::TensorMap xmap, bmap, cmap;   // 4-d (p, s, h, b); 3-d (n, s, b)
  hopper::TensorMap hmap;               // 2-d over the entering states
  const __nv_bfloat16* x;               // the same, for the threads' route
  const __nv_bfloat16* B;
  const __nv_bfloat16* C;
  const float* dt;
  const float* A;
  const float* D;
  __nv_bfloat16* y;
  // entering states [b][h][nc][2][PP][NP]: hi then lo
  __nv_bfloat16* hs;
  float* final_state;                   // [b][h][p][n] or null
  int b, s, h, p, n, nc, tma;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, B_sb, B_ss, C_sb, C_ss;
};

// Byte offset of element (r, c) in a tile of `rows` rows stored as column
// blocks of [rows][COLS], 128B-swizzled (the tile starts 1024-aligned).
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  const uint32_t a = uint32_t((c / COLS) * rows * SW + r * SW + (c % COLS) * 2);
  return a ^ (((a >> 7) & 7u) << 4);
}

__device__ __forceinline__ float tile_at(const char* tile, int rows, int r,
                                         int c) {
  return __bfloat162float(
      *reinterpret_cast<const __nv_bfloat16*>(tile + swz(rows, r, c)));
}

// One warp copies rows x cols of a bf16 matrix (row stride ld elements)
// into a tile of `rows` rows and `cbs` column blocks, in the layout TMA
// writes; zeros past nr rows and nc columns.  Then the writes are made
// visible to wgmma (the async proxy).
__device__ void load_tile(char* tile, int rows, int cbs,
                          const __nv_bfloat16* g, long long ld, int nr,
                          int ncol) {
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = lane; i < rows * cbs * COLS; i += 32) {
    const int r = i / (cbs * COLS), c = i % (cbs * COLS);
    *reinterpret_cast<__nv_bfloat16*>(tile + swz(rows, r, c)) =
        r < nr && c < ncol ? g[r * ld + c] : zero;
  }
  hopper::fence_proxy_async();
}

// Inclusive prefix sums, in lane order, of the pairs (v0, v1) the lanes of
// a warp hold: lane l gets the sums through token 2l and 2l + 1.
__device__ __forceinline__ void warp_scan_pair(float v0, float v1, float& c0,
                                               float& c1) {
  const int lane = threadIdx.x % 32;
  float s = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += o;
  }
  float before = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) before = 0.f;
  c0 = before + v0;
  c1 = c0 + v1;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Two f32 values -> their bf16 parts hi = bf16(v) and lo = bf16(v - hi),
// each pair packed as an A operand register (the first in the low half).
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = hopper::pack_bf16x2(v0, v1);
  lo = hopper::pack_bf16x2(v0 - round_bf16(v0), v1 - round_bf16(v1));
}

// The state's rows that a consumer warp holds (16 rows of the m64n64
// accumulator) leave through shared memory, so that global memory sees
// whole 16-byte pieces of rows: fragment stores write 8 rows x 16 bytes an
// instruction, and cost the state kernel two thirds of its time.  Each
// warp stages its rows in its own buffer, rows padded by 16 bytes so that
// the fragment writes spread over the banks.
constexpr int STG_ROW = 2 * (COLS + 8);          // bytes
constexpr int STG_BYTES = 16 * STG_ROW;

__device__ __forceinline__ void stage_put(char* buf, int i, uint32_t v) {
  const int l = threadIdx.x % 32;
  const int r = l / 4 + 8 * ((i / 2) % 2), c = 8 * (i / 4) + 2 * (l % 4);
  *reinterpret_cast<uint32_t*>(buf + r * STG_ROW + 2 * c) = v;
}

// ---- kernel 1: the states entering each chunk
struct StateGeo {
  static constexpr int X_BYTES = Q * SW;        // x [Q][64 rows of the state]
  static constexpr int B_BYTES = Q * SW;        // B [Q][64 columns of n]
  static constexpr int STAGE = X_BYTES + B_BYTES;
  static constexpr int STAGES = 4;
  static constexpr int WROW = Q + 4;            // w [Q], then exp(cum_Q)
  static constexpr int OFF_W = STAGES * STAGE;
  static constexpr int OFF_STG = OFF_W + STAGES * WROW * 4;  // [warp][hi, lo]
  static constexpr int OFF_BAR = OFF_STG + 4 * 2 * STG_BYTES;
  static constexpr int SMEM = 1024 + OFF_BAR + 8 * 2 * STAGES;
};

// Grid (NP / 64 * PP / 64, h, b): a block carries the state's rows
// m0..m0+63 and columns n0..n0+63 of one (head, batch).
template <int PP, int NP>
__global__ void __launch_bounds__(NTHREADS)
    ssd_state_kernel_tc(const __grid_constant__ Args a) {
  using namespace hopper;
  using G = StateGeo;
  constexpr int STAGES = G::STAGES;
  extern __shared__ float smem[];
  const uint32_t s0 = smem_addr(smem);
  char* base = reinterpret_cast<char*>(smem) + ((1024 - (s0 & 1023)) & 1023);
  float* W = reinterpret_cast<float*>(base + G::OFF_W);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + G::OFF_BAR);
  uint64_t* empty = full + STAGES;
  const int n0 = blockIdx.x % (NP / COLS) * COLS;
  const int m0 = blockIdx.x / (NP / COLS) * COLS;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 32);            // every producer lane
      mbar_init(&empty[st], NCONS / 32);   // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NCONS) {
    // ---- producer warp: per chunk, w and exp(cum_Q), then x and B.  dt of
    // the next chunk is loaded a chunk ahead, so its latency overlaps.
    const int lane = tid - NCONS;
    const float Ah = a.A[hh];
    const float* dt = a.dt + bb * a.dt_sb + hh;
    const int t = 2 * lane;
    auto dt_at = [&](int c, int i) {
      return c * Q + i < a.s ? dt[(c * Q + i) * a.dt_ss] : 0.f;
    };
    float d0 = dt_at(0, t), d1 = dt_at(0, t + 1);
    for (int c = 0; c < a.nc; ++c) {
      const int st = c % STAGES;
      const int t0 = c * Q, len = min(Q, a.s - t0);
      const float e0 = dt_at(c + 1, t), e1 = dt_at(c + 1, t + 1);
      char* xs = base + st * G::STAGE;
      char* bs = xs + G::X_BYTES;
      mbar_wait(&empty[st], ((c / STAGES) & 1) ^ 1);
      if (!a.tma) {
        load_tile(xs, Q, 1,
                  a.x + bb * a.x_sb + t0 * a.x_ss + hh * a.x_sh + m0, a.x_ss,
                  len, a.p - m0);
        load_tile(bs, Q, 1, a.B + bb * a.B_sb + t0 * a.B_ss + n0, a.B_ss,
                  len, a.n - n0);
      }
      float c0, c1;
      warp_scan_pair(Ah * d0, Ah * d1, c0, c1);
      const float cq = __shfl_sync(0xffffffffu, c1, 31);
      float* w = W + st * G::WROW;
      w[t] = expf(cq - c0) * d0;
      w[t + 1] = expf(cq - c1) * d1;
      if (lane == 0) w[Q] = expf(cq);
      if (a.tma && lane == 0) {
        mbar_arrive_expect_tx(&full[st], G::STAGE);
        tma_load_4d(xs, &a.xmap, &full[st], m0, t0, hh, bb);
        tma_load_3d(bs, &a.bmap, &full[st], n0, t0, bb);
      } else {
        mbar_arrive(&full[st]);
      }
      d0 = e0;
      d1 = e1;
    }
  } else {
    // ---- consumer warpgroup: the carry H in registers.  Per chunk the
    // chunk's own state S_c = (w . x)^T B is issued into a fresh
    // accumulator; while it runs, H (the state entering the chunk) is
    // written out; then H = exp(cum_Q) H + S_c.
    const int wq = tid / 32, l = tid % 32;
    const int r0 = 16 * wq + l / 4;        // this thread's rows r0, r0 + 8
    char* stg = base + G::OFF_STG + wq * 2 * STG_BYTES;   // hi, then lo
    float H[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) H[i] = 0.f;
    __nv_bfloat16* hs =
        a.hs + (static_cast<long long>(bb) * a.h + hh) * a.nc * 2 * PP * NP;
    for (int c = 0; c < a.nc; ++c) {
      const int st = c % STAGES;
      const char* xs = base + st * G::STAGE;
      const float* w = W + st * G::WROW;
      mbar_wait(&full[st], (c / STAGES) & 1);
      // A = (w . x)^T, hi and lo: register j of k-step kk holds rows
      // r0 + 8 (j % 2) and tokens 16 kk + 2 (l % 4) + 8 (j / 2) + {0, 1}
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = r0 + 8 * (j % 2);
          const int t = 16 * kk + 2 * (l % 4) + 8 * (j / 2);
          split(w[t] * tile_at(xs, Q, t, row),
                w[t + 1] * tile_at(xs, Q, t + 1, row), ahi[kk][j], alo[kk][j]);
        }
      fence_regs(ahi);
      fence_regs(alo);
      float S[32];                         // the first k-step overwrites it
      wgmma_fence();
      const uint32_t b_addr = smem_addr(xs + G::X_BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db =
            smem_desc(b_addr + kk * 16 * SW, SW, Q * SW, 8 * SW);
        Wgmma<64>::rs<1>(S, ahi[kk], db, kk > 0);
        Wgmma<64>::rs<1>(S, alo[kk], db, 1);
      }
      wgmma_commit();
      // the state entering chunk c, as bf16 hi and lo, while S_c runs
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        uint32_t hi, lo;
        split(H[i], H[i + 1], hi, lo);
        stage_put(stg, i, hi);
        stage_put(stg + STG_BYTES, i, lo);
      }
      __syncwarp();
      __nv_bfloat16* hc = hs + static_cast<long long>(c) * 2 * PP * NP +
                          (m0 + 16 * wq) * NP + n0;
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int k = l; k < 16 * 8; k += 32) {    // [16 rows][8 pieces]
          const int r = k / 8, cc = 8 * (k % 8);
          *reinterpret_cast<uint4*>(hc + (part * PP + r) * NP + cc) =
              *reinterpret_cast<const uint4*>(stg + part * STG_BYTES +
                                              r * STG_ROW + 2 * cc);
        }
      wgmma_wait<0>();
      fence_regs(S);
      const float decay = w[Q];
#pragma unroll
      for (int i = 0; i < 32; ++i) H[i] = fmaf(H[i], decay, S[i]);
      __syncwarp();
      if (l == 0) mbar_arrive(&empty[st]);
    }
    if (a.final_state != nullptr) {
      float* fs = a.final_state + (static_cast<long long>(bb) * a.h + hh) *
                                      a.p * a.n;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = m0 + r0 + 8 * ((i / 2) % 2);
        const int col = n0 + 8 * (i / 4) + 2 * (l % 4) + i % 2;
        if (row < a.p && col < a.n) fs[row * a.n + col] = H[i];
      }
    }
  }
}

// ---- kernel 2: the chunks' outputs
template <int PP, int NP>
struct OutGeo {
  static constexpr int C_BYTES = Q * 2 * NP;    // C [Q][NP] (and B)
  static constexpr int X_BYTES = Q * 2 * PP;    // x [Q][PP]
  static constexpr int H_BYTES = PP * 2 * NP;   // H hi or lo [PP][NP]
  static constexpr int STAGE = X_BYTES + 2 * H_BYTES;
  static constexpr int STAGES = 2;
  static constexpr int OFF_RING = C_BYTES;
  // B waits in stage 1's place until C B^T is done
  static constexpr int OFF_B = OFF_RING + STAGE;
  static constexpr int OFF_CUM = OFF_RING + STAGES * STAGE;  // [GROUP][Q]
  static constexpr int OFF_DT = OFF_CUM + GROUP * Q * 4;     // [GROUP][Q]
  static constexpr int OFF_BAR = OFF_DT + GROUP * Q * 4;
  static constexpr int SMEM = 1024 + OFF_BAR + 8 * (2 + 2 * STAGES);
  static_assert(C_BYTES <= STAGE, "B does not fit in a stage");
  static_assert(SMEM <= 232448, "output kernel does not fit in shared memory");
};

// Grid (nc, ceil(h / GROUP), b).  Held to two blocks an SM: the bytes two
// blocks keep in flight set its pace, and ptxas left to itself takes
// registers enough for one.
template <int PP, int NP>
__global__ void __launch_bounds__(NTHREADS, 2)
    ssd_output_kernel_tc(const __grid_constant__ Args a) {
  using namespace hopper;
  using G = OutGeo<PP, NP>;
  constexpr int STAGES = G::STAGES;
  extern __shared__ float smem[];
  const uint32_t s0 = smem_addr(smem);
  char* base = reinterpret_cast<char*>(smem) + ((1024 - (s0 & 1023)) & 1023);
  char* Cs = base;
  char* Bs = base + G::OFF_B;
  float* cum = reinterpret_cast<float*>(base + G::OFF_CUM);
  float* dts = reinterpret_cast<float*>(base + G::OFF_DT);
  uint64_t* cb_full = reinterpret_cast<uint64_t*>(base + G::OFF_BAR);
  uint64_t* b_free = cb_full + 1;
  uint64_t* full = b_free + 1;
  uint64_t* empty = full + STAGES;
  const int c = blockIdx.x, bb = blockIdx.z;
  const int h0 = blockIdx.y * GROUP;
  const int nh = min(GROUP, a.h - h0);
  const int t0 = c * Q, len = min(Q, a.s - t0);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(cb_full, 32);
    mbar_init(b_free, NCONS / 32);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 32);
      mbar_init(&empty[st], NCONS / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NCONS) {
    // ---- producer warp: dt and cum of the group, C and B, then per head
    // x and the entering state
    const int lane = tid - NCONS;
    const float* dt = a.dt + bb * a.dt_sb + t0 * a.dt_ss + h0;
    for (int i = lane; i < Q * nh; i += 32) {   // one [Q x nh] read
      const int t = i / nh, g = i % nh;
      dts[g * Q + t] = t < len ? dt[t * a.dt_ss + g] : 0.f;
    }
    __syncwarp();
    for (int g = 0; g < nh; ++g) {
      const float Ag = a.A[h0 + g];
      float c0, c1;
      warp_scan_pair(Ag * dts[g * Q + 2 * lane], Ag * dts[g * Q + 2 * lane + 1],
                     c0, c1);
      cum[g * Q + 2 * lane] = c0;
      cum[g * Q + 2 * lane + 1] = c1;
    }
    if (!a.tma) {
      load_tile(Cs, Q, NP / COLS, a.C + bb * a.C_sb + t0 * a.C_ss, a.C_ss,
                len, a.n);
      load_tile(Bs, Q, NP / COLS, a.B + bb * a.B_sb + t0 * a.B_ss, a.B_ss,
                len, a.n);
    }
    if (a.tma && lane == 0) {
      mbar_arrive_expect_tx(cb_full, 2 * G::C_BYTES);
      for (int cb = 0; cb < NP / COLS; ++cb) {
        tma_load_3d(Cs + cb * Q * SW, &a.cmap, cb_full, cb * COLS, t0, bb);
        tma_load_3d(Bs + cb * Q * SW, &a.bmap, cb_full, cb * COLS, t0, bb);
      }
    } else {
      mbar_arrive(cb_full);
    }
    for (int g = 0; g < nh; ++g) {
      const int st = g % STAGES, hh = h0 + g;
      char* xs = base + G::OFF_RING + st * G::STAGE;
      char* hhi = xs + G::X_BYTES;
      char* hlo = hhi + G::H_BYTES;
      mbar_wait(&empty[st], ((g / STAGES) & 1) ^ 1);
      if (g == 1) mbar_wait(b_free, 0);    // stage 1 held B
      if (!a.tma)
        load_tile(xs, Q, PP / COLS,
                  a.x + bb * a.x_sb + t0 * a.x_ss + hh * a.x_sh, a.x_ss, len,
                  a.p);
      if (lane == 0) {
        const int hrow = static_cast<int>(
            ((static_cast<long long>(bb) * a.h + hh) * a.nc + c) * 2 * PP);
        mbar_arrive_expect_tx(&full[st],
                              (a.tma ? G::X_BYTES : 0) + 2 * G::H_BYTES);
        if (a.tma)
          for (int cb = 0; cb < PP / COLS; ++cb)
            tma_load_4d(xs + cb * Q * SW, &a.xmap, &full[st], cb * COLS, t0,
                        hh, bb);
        for (int cb = 0; cb < NP / COLS; ++cb) {
          tma_load_2d(hhi + cb * PP * SW, &a.hmap, &full[st], cb * COLS, hrow);
          tma_load_2d(hlo + cb * PP * SW, &a.hmap, &full[st], cb * COLS,
                      hrow + PP);
        }
      } else {
        mbar_arrive(&full[st]);
      }
    }
  } else {
    // ---- consumer warpgroup
    const int wq = tid / 32, l = tid % 32;
    const int r0 = 16 * wq + l / 4;        // this thread's rows r0, r0 + 8
    const uint32_t c_addr = smem_addr(Cs);
    float cb[32];                          // C B^T, f32, once for the group
    mbar_wait(cb_full, 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint32_t off = (kk * 32 / SW) * Q * SW + kk * 32 % SW;
      Wgmma<64>::ss<0>(cb, smem_desc(c_addr + off, SW, 0, 8 * SW),
                       smem_desc(smem_addr(Bs) + off, SW, 0, 8 * SW), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(cb);
    __syncwarp();
    if (l == 0) mbar_arrive(b_free);
    for (int g = 0; g < nh; ++g) {
      const int st = g % STAGES, hh = h0 + g;
      const char* xs = base + G::OFF_RING + st * G::STAGE;
      const uint32_t x_addr = smem_addr(xs);
      const uint32_t hi_addr = x_addr + G::X_BYTES;
      const uint32_t lo_addr = hi_addr + G::H_BYTES;
      const float* cg = cum + g * Q;
      const float* dg = dts + g * Q;
      const float ci[2] = {cg[r0], cg[r0 + 8]};
      mbar_wait(&full[st], (g / STAGES) & 1);
      // y = C H^T, from the hi then the lo part of H (its first k-step
      // overwrites y)
      float y[PP / 2];
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk) {
          const uint32_t cbk = kk * 32 / SW, in = kk * 32 % SW;
          Wgmma<PP>::template ss<0>(
              y, smem_desc(c_addr + cbk * Q * SW + in, SW, 0, 8 * SW),
              smem_desc((part ? lo_addr : hi_addr) + cbk * PP * SW + in, SW,
                        0, 8 * SW),
              part > 0 || kk > 0);
        }
      wgmma_commit();
      // while it runs: P = C B^T . exp(cum_i - cum_j) dt_j for j <= i, hi
      // and lo, as the A operand (accumulator registers 8 kk .. 8 kk + 7
      // are columns 16 kk .. 16 kk + 15)
      uint32_t phi[4][4], plo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j;
          const int row = r0 + 8 * (j % 2);
          const int col = 16 * kk + 8 * (j / 2) + 2 * (l % 4);
          const float v0 =
              col <= row ? cb[i] * expf(ci[j % 2] - cg[col]) * dg[col] : 0.f;
          const float v1 = col + 1 <= row
                               ? cb[i + 1] * expf(ci[j % 2] - cg[col + 1]) *
                                     dg[col + 1]
                               : 0.f;
          split(v0, v1, phi[kk][j], plo[kk][j]);
        }
      const float e[2] = {expf(ci[0]), expf(ci[1])};
      wgmma_wait<0>();
      fence_regs(y);
      fence_regs(phi);
      fence_regs(plo);
#pragma unroll
      for (int i = 0; i < PP / 2; ++i) y[i] *= e[(i / 2) % 2];
      fence_regs(y);
      // y += P x, x MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dx =
            smem_desc(x_addr + kk * 16 * SW, SW, Q * SW, 8 * SW);
        Wgmma<PP>::template rs<1>(y, phi[kk], dx, 1);
        Wgmma<PP>::template rs<1>(y, plo[kk], dx, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(y);
      // y + D x, rounded once; rows past the sequence are not written
      const float Dh = a.D[hh];
#pragma unroll
      for (int i = 0; i < PP / 2; i += 2) {
        const int row = r0 + 8 * ((i / 2) % 2);
        const int col = 8 * (i / 4) + 2 * (l % 4);
        if (row >= len || col >= a.p) continue;
        const long long at =
            ((static_cast<long long>(bb) * a.s + t0 + row) * a.h + hh) * a.p +
            col;
        const float v0 = y[i] + Dh * tile_at(xs, Q, row, col);
        if (a.p % 2 == 0) {
          const float v1 = y[i + 1] + Dh * tile_at(xs, Q, row, col + 1);
          *reinterpret_cast<uint32_t*>(a.y + at) = pack_bf16x2(v0, v1);
        } else {
          a.y[at] = __float2bfloat16(v0);
          if (col + 1 < a.p)
            a.y[at + 1] =
                __float2bfloat16(y[i + 1] + Dh * tile_at(xs, Q, row, col + 1));
        }
      }
      __syncwarp();
      if (l == 0) mbar_arrive(&empty[st]);
    }
  }
}

// Byte stride of a dimension for its tensor map: a dimension of size 1 is
// never stepped, so any legal stride does.
inline uint64_t map_stride(long long stride, int size) {
  return size > 1 ? static_cast<uint64_t>(stride) * 2 : 16;
}

template <int PP, int NP>
cudaError_t launch(Args& a, cudaStream_t stream) {
  using SG = StateGeo;
  using OG = OutGeo<PP, NP>;
  const long long rows = static_cast<long long>(a.b) * a.h * a.nc * 2 * PP;
  if (rows > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err;
  const uint64_t hdims[2] = {uint64_t(NP), uint64_t(rows)};
  const uint64_t hstr[1] = {uint64_t(NP) * 2};
  const uint32_t hbox[2] = {COLS, PP};
  if ((err = hopper::make_tensor_map(&a.hmap, a.hs, 2, hdims, hstr, hbox,
                                     SW)) != cudaSuccess)
    return err;
  if (a.tma) {
    const uint64_t xdims[4] = {uint64_t(a.p), uint64_t(a.s), uint64_t(a.h),
                               uint64_t(a.b)};
    const uint64_t xstr[3] = {map_stride(a.x_ss, a.s), map_stride(a.x_sh, a.h),
                              map_stride(a.x_sb, a.b)};
    const uint32_t xbox[4] = {COLS, Q, 1, 1};
    const uint64_t ndims[3] = {uint64_t(a.n), uint64_t(a.s), uint64_t(a.b)};
    const uint64_t bstr[2] = {map_stride(a.B_ss, a.s), map_stride(a.B_sb, a.b)};
    const uint64_t cstr[2] = {map_stride(a.C_ss, a.s), map_stride(a.C_sb, a.b)};
    const uint32_t nbox[3] = {COLS, Q, 1};
    if ((err = hopper::make_tensor_map(&a.xmap, a.x, 4, xdims, xstr, xbox,
                                       SW)) != cudaSuccess ||
        (err = hopper::make_tensor_map(&a.bmap, a.B, 3, ndims, bstr, nbox,
                                       SW)) != cudaSuccess ||
        (err = hopper::make_tensor_map(&a.cmap, a.C, 3, ndims, cstr, nbox,
                                       SW)) != cudaSuccess)
      return err;
  }
  auto state_kernel = ssd_state_kernel_tc<PP, NP>;
  auto output_kernel = ssd_output_kernel_tc<PP, NP>;
  if ((err = cudaFuncSetAttribute(state_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SG::SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(output_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  OG::SMEM)) != cudaSuccess)
    return err;
  const dim3 state_grid(NP / COLS * (PP / COLS), a.h, a.b);
  state_kernel<<<state_grid, NTHREADS, SG::SMEM, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 out_grid(a.nc, (a.h + GROUP - 1) / GROUP, a.b);
  output_kernel<<<out_grid, NTHREADS, OG::SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32 (the three CUDA-core kernels), 1 = bfloat16 (the two
// tensor-core kernels) for x, B, C and y; dt, A and D are f32.  Strides are
// in elements; the last dim of x, dt, B and C is contiguous, y is
// contiguous [b,s,h,p].  Scratch, with nc = ceil(s / 64):
//   float32:  cum of b*h*nc*64 floats and states of b*h*nc*p*n floats;
//   bfloat16: cum unused, states of b*h*nc*PP*NP floats (PP, NP: p and n
//             rounded up to 64 or 128), 16-byte aligned.
// final_state [b,h,p,n] f32 may be null.  tma (bfloat16): 1 to read x, B
// and C by TMA (each 16-byte aligned, strides in 16-byte multiples:
// kernels/tma.py), 0 to load them by threads.  Returns the cudaError_t of
// the launches (0 on success); nothing synchronises.
int ssd_fwd(const void* x, const float* dt, const float* A, const void* B,
            const void* C, const float* D, void* y, float* cum,
            float* states, float* final_state, int b, int s, int h, int p,
            int n, long long x_sb, long long x_ss, long long x_sh,
            long long dt_sb, long long dt_ss, long long B_sb, long long B_ss,
            long long C_sb, long long C_ss, int dtype, int tma, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || p > MAX_P || n <= 0 ||
      n > MAX_N || b > 65535 || h > 65535)
    return cudaErrorInvalidValue;
  const int nc = (s + Q - 1) / Q;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Args a{static_cast<const float*>(x), dt, A, static_cast<const float*>(B),
           static_cast<const float*>(C), D, static_cast<float*>(y), cum,
           states, final_state, b, s, h, p, n, nc,
           x_sb, x_ss, x_sh, dt_sb, dt_ss, B_sb, B_ss, C_sb, C_ss};
    return launch(a, st);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  tc::Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.B = static_cast<const __nv_bfloat16*>(B);
  a.C = static_cast<const __nv_bfloat16*>(C);
  a.dt = dt;
  a.A = A;
  a.D = D;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.hs = reinterpret_cast<__nv_bfloat16*>(states);
  a.final_state = final_state;
  a.b = b;
  a.s = s;
  a.h = h;
  a.p = p;
  a.n = n;
  a.nc = nc;
  a.tma = tma;
  a.x_sb = x_sb;
  a.x_ss = x_ss;
  a.x_sh = x_sh;
  a.dt_sb = dt_sb;
  a.dt_ss = dt_ss;
  a.B_sb = B_sb;
  a.B_ss = B_ss;
  a.C_sb = C_sb;
  a.C_ss = C_ss;
  if (p <= 64) return n <= 64 ? tc::launch<64, 64>(a, st) : tc::launch<64, 128>(a, st);
  return n <= 64 ? tc::launch<128, 64>(a, st) : tc::launch<128, 128>(a, st);
}

const char* ssd_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
