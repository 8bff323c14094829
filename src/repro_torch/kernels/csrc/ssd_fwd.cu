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
// and optionally the final state H [b,h,p,n] in f32.  Arithmetic is f32 on
// bf16 or f32 inputs.  The D x skip is added here in f32 before the one
// rounding of y, as repro/kernels/ssd_scan.py::ssd_chunked_jnp does (the
// Pallas wrapper rounds y first and adds the skip after).  The plain
// version is repro_torch/kernels/ref.py::ssd_scan_ref.
//
// What bounds it on an H100: at mamba2-130m's training and prefill shape
// (b=4, s=4096, h=24, p=64, n=128, bf16) the work is ~20 GFLOP (C B^T once
// per (b, chunk), the intra-chunk, inter-chunk and state products 6.4
// GFLOP each) against ~111 MB that must move (x and y 50 MB each, dt, B,
// C): 0.020 ms at the bf16 tensor-core peak against 0.033 ms at 3.35 TB/s,
// so the bound is memory.  This first version does its products as f32
// FMAs on the CUDA cores (67 TFLOP/s peak, and recomputes C B^T per head,
// 32 GFLOP in all), so arithmetic limits it, through shared-memory reads
// as in the flash kernel: each thread computes a 4 x 4 tile from four A and
// four B values per step.
//
// What the design does about it:
//   * the Pallas kernel runs its grid (b, h, chunk) with the chunk axis
//     sequential and the [p,n] state carried in VMEM.  Hopper runs blocks in
//     no order, and a grid of (b, h) alone is 96 blocks for 132 SMs, so the
//     chunk recurrence is split out (the chunk-parallel form of the Mamba-2
//     paper, section 6) into three kernels on one stream:
//       1. per (chunk, h, b): cum by one thread, written out for kernels 2
//          and 3, and the chunk's own state S_c = (w . x)^T B with
//          w = exp(cum_Q - cum) dt, written to f32 scratch [b,h,nc,p,n];
//       2. per (b, h, 256 state elements): the sequential pass over the
//          chunks H_c = exp(cum_Q) H_{c-1} + S_c, overwriting each S_c with
//          the state entering its chunk, and the final state; each thread
//          keeps 16 loads of S_c in flight;
//       3. per (chunk, h, b): y from C B^T, the masked decay, x, the
//          entering state and D.
//     At the main shape that is b h nc = 6,144 blocks for kernels 1 and 3.
//     The state scratch (100.7 MB each way at the main shape) is traffic of
//     this design, not of the function, and is not in the bound;
//   * exp(cum_i - cum_j) is computed only where i >= j: above the diagonal
//     the difference is a positive sum that overflows f32 at long chunks
//     (ROADMAP.md, C3);
//   * a fixed chunk of Q = 64 tokens (the reference halves its chunk until
//     it divides s, down to 2 for s = 4094); the ragged last chunk is
//     masked here: its missing tokens count as dt = 0, x = B = C = 0, which
//     leave the state unchanged, and their y is not written;
//   * each kernel stages its tiles in shared memory as f32 (Q = 64 keeps a
//     [Q, n] tile at 33 KB for n = 128; kernel 3 holds C, B then the
//     entering state, the masked scores and x, 100 KB, two blocks per SM);
//     x, dt, B and C are read through their strides, so the model's slices
//     of the convolution output are never copied;
//   * C B^T does not depend on the head (ngroups = 1), yet kernel 3, like
//     the Pallas kernel, recomputes it for each head: sharing it across
//     heads, mma.sync / wgmma with bf16 operands, TMA and fusing kernel 2
//     into a look-back are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int Q = 64;              // tokens per chunk
constexpr int TX = 16;             // threads across an output tile's columns
constexpr int TY = 16;             // threads across its rows
constexpr int NTHREADS = TX * TY;
constexpr int TILE = 64;           // output tile: 4 x 4 values per thread
constexpr int RPT = TILE / TY;
constexpr int CPT = TILE / TX;
constexpr int MAX_P = 128;
constexpr int MAX_N = 128;
constexpr int PASS_THREADS = 256;
constexpr int PASS_BATCH = 16;           // chunk-state loads in flight

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  void* y;
  float* cum;                      // [b][h][nc][Q]
  float* states;                   // [b][h][nc][p][n]
  float* final_state;              // [b][h][p][n] or null
  int b, s, h, p, n, nc;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, B_sb, B_ss, C_sb, C_ss;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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
template <typename T>
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
  const T* x = static_cast<const T*>(a.x) + bb * a.x_sb + t0 * a.x_ss + hh * a.x_sh;
  const T* B = static_cast<const T*>(a.B) + bb * a.B_sb + t0 * a.B_ss;
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
    if (t < len)
      v = expf(cum_end - cum[t]) * dt[t * a.dt_ss] * to_float(x[t * a.x_ss + k]);
    wx[t * (p + 1) + k] = v;
  }
  for (int i = tid; i < Q * n; i += NTHREADS) {
    const int t = i / n, k = i % n;
    Bs[t * (n + 1) + k] = t < len ? to_float(B[t * a.B_ss + k]) : 0.f;
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
template <typename T>
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
  const T* x = static_cast<const T*>(a.x) + bb * a.x_sb + t0 * a.x_ss + hh * a.x_sh;
  const T* B = static_cast<const T*>(a.B) + bb * a.B_sb + t0 * a.B_ss;
  const T* C = static_cast<const T*>(a.C) + bb * a.C_sb + t0 * a.C_ss;
  const float* dt = a.dt + bb * a.dt_sb + t0 * a.dt_ss + hh;
  const float* cum_in = a.cum + (bh * a.nc + c) * Q;

  for (int t = tid; t < Q; t += NTHREADS) {
    cum[t] = cum_in[t];
    dts[t] = t < len ? dt[t * a.dt_ss] : 0.f;
  }
  for (int i = tid; i < Q * n; i += NTHREADS) {
    const int t = i / n, k = i % n;
    const bool in = t < len;
    Cs[t * (n + 1) + k] = in ? to_float(C[t * a.C_ss + k]) : 0.f;
    BH[t * (n + 1) + k] = in ? to_float(B[t * a.B_ss + k]) : 0.f;
  }
  for (int i = tid; i < Q * p; i += NTHREADS) {
    const int t = i / p, k = i % p;
    xs[t * (p + 1) + k] = t < len ? to_float(x[t * a.x_ss + k]) : 0.f;
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
  T* y = static_cast<T*>(a.y) + ((static_cast<long long>(bb) * a.s + t0) * a.h + hh) * p;
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
          store(y + r * y_ss + pc, intra[i][j] + decay * inter[i][j] +
                                       Dh * xs[r * (p + 1) + pc]);
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

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem1 = state_smem(a.p, a.n);
  const size_t smem2 = sizeof(float) * a.nc;
  const size_t smem3 = output_smem(a.p, a.n);
  auto state_kernel = ssd_chunk_state_kernel<T>;
  auto output_kernel = ssd_chunk_output_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_state_pass_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      output_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.nc, a.h, a.b);
  state_kernel<<<grid, NTHREADS, smem1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int pn = a.p * a.n;
  const dim3 pass_grid((pn + PASS_THREADS - 1) / PASS_THREADS, a.h, a.b);
  ssd_state_pass_kernel<<<pass_grid, PASS_THREADS, smem2, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  output_kernel<<<grid, NTHREADS, smem3, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt, A, D, cum, states
// and final_state are f32.  Strides are in elements; the last dim of x, dt,
// B and C is contiguous, y is contiguous [b,s,h,p].  cum is f32 scratch of
// b*h*nc*Q and states of b*h*nc*p*n with nc = ceil(s / 64); final_state
// [b,h,p,n] may be null.  Returns the cudaError_t of the launches (0 on
// success); nothing synchronises.
int ssd_fwd(const void* x, const float* dt, const float* A, const void* B,
            const void* C, const float* D, void* y, float* cum,
            float* states, float* final_state, int b, int s, int h, int p,
            int n, long long x_sb, long long x_ss, long long x_sh,
            long long dt_sb, long long dt_ss, long long B_sb, long long B_ss,
            long long C_sb, long long C_ss, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || p > MAX_P || n <= 0 ||
      n > MAX_N || b > 65535 || h > 65535)
    return cudaErrorInvalidValue;
  Args a{x,    dt,   A,    B,    C,    D,    y,    cum,  states, final_state,
         b,    s,    h,    p,    n,    (s + Q - 1) / Q,
         x_sb, x_ss, x_sh, dt_sb, dt_ss, B_sb, B_ss, C_sb, C_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, st);
  return cudaErrorInvalidValue;
}

const char* ssd_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
