// Mamba-2 SSD chunked scan, backward, for Hopper (sm_90a), CUDA C++.
//
// Replaces the backward rule of the TPU kernel's custom_vjp,
// repro/kernels/ssd_pallas.py::_bwd, which takes jax.vjp through
// repro/kernels/ssd_scan.py::ssd_chunked_jnp (jnp outside any Pallas
// kernel).  For the forward of csrc/ssd_fwd.cu (x [b,s,h,p], dt [b,s,h]
// after softplus, A [h], B and C [b,s,n] shared by all heads, D [h]) it
// takes gy [b,s,h,p] and, optionally, the final state's gradient gstate
// [b,h,p,n] and writes dx, ddt, dA, dB, dC and dD.  In each chunk of Q = 64
// tokens, with cum = cumsum(A dt), L_ij = exp(cum_i - cum_j) for i >= j,
// S = C B^T, G_ij = gy_i . x_j, H the state entering the chunk and dH the
// gradient of the one leaving it:
//   dH_prev = exp(cum_end) dH + sum_i exp(cum_i) gy_i (x) C_i   (reverse
//             pass over the chunks, from gstate or 0);
//   dx_j    = dt_j [sum_i S_ij L_ij gy_i + exp(cum_end - cum_j) dH B_j]
//             + D gy_j;
//   dC_i    = sum_j dS_ij B_j + exp(cum_i) gy_i^T H,
//   dB_j    = sum_i dS_ij C_i + exp(cum_end - cum_j) dt_j x_j^T dH,
//             dS_ij = G_ij L_ij dt_j, each summed over the heads;
//   ddt_j   = sum_i S_ij L_ij G_ij + q_j + A rcs_j, q_j = exp(cum_end -
//             cum_j) x_j . (dH B_j), rcs the reverse cumsum over the chunk
//             of d(cum); dA = sum dt rcs; dD = sum gy . x.
// The plain version is repro_torch/kernels/ref.py::ssd_bwd_ref, which
// spells out d(cum).  Mamba-2 paper (arXiv:2405.21060), section 6, for the
// chunked decomposition.
//
// What bounds it on an H100: at mamba2-130m's training shape (b=4, s=4096,
// h=24, p=64, n=128, bf16) the function's products are ~52 GFLOP (the
// chunk states and the dH terms, C B^T once per (b, chunk), the
// intra-chunk dx, dS, dB and dC products per head) against ~170 MB that
// must move (x, gy and dx 50 MB each, B, C, dB, dC, dt and ddt): 0.052 ms
// at the bf16 tensor-core peak against 0.051 ms at 3.35 TB/s.
//
// Hopper runs blocks in no order, so the recurrences over the chunks are
// split out of the chunks' gradients.  Common to both paths: exp(cum_i -
// cum_j) is formed only where i >= j (ROADMAP.md, C3); cum is summed in
// f64 and its differences are taken in f64 and rounded to f32 before the
// exp, as the plain version does; x, dt, B and C are read through their
// strides (the model passes slices of the convolution's output), gy,
// gstate and the outputs are contiguous; the ragged last chunk reads its
// missing tokens as dt = 0, x = B = C = gy = 0, as the forward does, and
// writes nothing for them; no atomics, so two calls give the same bits.
//
// bf16 -> three kernels, the products on the tensor cores (hopper.cuh):
//   1. ssd_bwd_state_kernel_tc, per (64 rows and 64 columns of the state,
//      head, batch, direction): the two walks over the chunks with the
//      carry in a wgmma accumulator, as csrc/ssd_fwd.cu's state kernel
//      (whose code this repeats).  Forward, H = exp(cum_Q) H + (w . x)^T B
//      with w = exp(cum_Q - cum) dt, from 0, writing H as it enters each
//      chunk; backward, dH = exp(cum_Q) dH + (e . gy)^T C with e =
//      exp(cum), from gstate, writing dH as it leaves each chunk.  Each is
//      one m64n64k16 product a chunk with a weighted register A operand;
//      the states go out as bf16 hi + lo, [b,h,nc,2,PP,NP];
//   2. ssd_bwd_grad_kernel_tc, per (chunk, group of 8 heads, batch): C and
//      B once, then per head, over a ring of stages, x, gy, H and dH; two
//      consumer warpgroups and a producer warpgroup (see the kernel).  The
//      transposed Q x Q operands (W^T, dS^T) come from the products taken
//      the other way (B C^T, x gy^T), not through shared memory; dB and dC
//      are summed over the group's heads in registers and leave as f32
//      partials; a producer warp finishes each head: d(cum), its reverse
//      cumsum, ddt and the dA/dD partials, by warp scans in f64;
//   3. ssd_bwd_sum_kernel_tc: the groups' dB and dC partials and the (b,
//      chunk) partials of dA and dD (a warp a head), each summed in one
//      fixed order.
//   Precision: bf16 operands with f32 accumulators, but w . x, e . gy, dS,
//   W and the states are f32 values; each is split into hi = bf16(v) and
//   lo = bf16(v - hi) and both parts go into one accumulator (~16 bits
//   kept; x, gy, B and C are bf16 already).  The state scratch is one write
//   and one read of H and of dH (201.3 MB each at the main shape).  Tiles
//   are rows of 64 bf16 with the 128B swizzle, p and n padded to 64 or 128
//   (zeros past them).  x, gy, B and C come by TMA (4-d over x and gy, 3-d
//   over B and C, zero fill past s); where the wrapper finds one of them
//   outside TMA's preconditions (kernels/tma.py) the producers load them by
//   threads into the same layout.  The states always come by TMA.
// f32 -> four kernels, f32 FMAs on the CUDA cores (67 TFLOP/s peak), for
// the f32 checks (TF32 would break their tolerances):
//   1. ssd_bwd_chunk_state_kernel, per (chunk, h, b): cum by one thread in
//      f64 (written out for kernels 2 and 3), the chunk's own state S_c =
//      sum_j exp(cum_end - cum_j) dt_j x_j (x) B_j and G_c = sum_i
//      exp(cum_i) gy_i (x) C_i, each to f32 scratch [b,h,nc,p,n];
//   2. ssd_bwd_state_pass_kernel, per (b, h, 256 state elements): the
//      forward pass over the chunks overwrites each S_c with the state
//      entering its chunk, then the reverse pass, from gstate, overwrites
//      each G_c with the gradient of the state leaving its chunk; each
//      thread keeps PASS_BATCH loads in flight;
//   3. ssd_bwd_chunk_grad_kernel, per (chunk, b), every head in turn: C B^T
//      once for the block, then per head G, dS and S L in shared memory, the
//      row and column sums of d(cum), dx, q and e, and the head's dB and dC
//      added in registers, so they are summed over the heads in one fixed
//      order; the entering state and dH come through shared memory 64
//      columns of n at a time (<dH, H> summed as dH replaces H there); one
//      thread then forms d(cum), its reverse cumsum, ddt and the (b, chunk,
//      h) partials of dA and dD;
//   4. ssd_bwd_reduce_kernel, per head: dA and dD summed over (b, chunk)
//      from the partials in a fixed order.
//   Each tile product is the forward's: a 4 x 4 block of a 64 x 64 tile a
//   thread, operands staged as f32 in shared memory with rows padded to an
//   odd length.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

#include "hopper.cuh"

namespace {

constexpr int Q = 64;              // tokens per chunk
constexpr int Q1 = Q + 1;          // a padded row of a [Q][Q] tile
constexpr int MAX_P = 128;
constexpr int MAX_N = 128;
constexpr int TX = 16;             // threads across an output tile's columns
constexpr int TY = 16;             // threads across its rows
constexpr int NTHREADS = TX * TY;
constexpr int TILE = 64;           // output tile: 4 x 4 values per thread
constexpr int RPT = TILE / TY;
constexpr int CPT = TILE / TX;
constexpr int PT = MAX_P / TILE;   // 64-wide tiles of p and of n
constexpr int NT = MAX_N / TILE;
constexpr int HB1 = TILE + 1;      // a padded row of 64 columns of H or dH
constexpr int PASS_THREADS = 256;
constexpr int PASS_BATCH = 16;     // chunk-state loads in flight

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* D;
  const float* gy;                 // [b][s][h][p]
  const float* gstate;             // [b][h][p][n] or null
  float* dx;                       // [b][s][h][p]
  float* ddt;                      // [b][s][h]
  float* dA;                       // [h]
  float* dB;                       // [b][s][n]
  float* dC;                       // [b][s][n]
  float* dD;                       // [h]
  double* cum;                     // [b][h][nc][Q]
  float* states;                   // [b][h][nc][p][n]: S_c, then H entering c
  float* dstates;                  // [b][h][nc][p][n]: G_c, then dH leaving c
  float* parts;                    // [2][b][nc][h]: dA and dD partials
  int b, s, h, p, n, nc;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, B_sb, B_ss, C_sb, C_ss;
};

// acc[i][j] += sum_{k < K} a[r_i * a_r + k * a_k] * b[c_j * b_c + k * b_k]
// with r_i = r0 + ty + i*TY and c_j = c0 + tx + j*TX, clamped to the rows
// and columns that exist (the caller uses only those).
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

// The sum over the 16 threads of a tile row (tx = 0..15: 16 neighbouring
// lanes of one warp), in the same order on every call.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Kernel 1: grid (nc, h, b).  cum of the chunk, its own state S_c and G_c.
__global__ void __launch_bounds__(NTHREADS)
    ssd_bwd_chunk_state_kernel(const Args a) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int p = a.p, n = a.n;
  const int t0 = c * Q;
  const int len = min(Q, a.s - t0);
  double* cum = reinterpret_cast<double*>(smem);   // [Q]
  float* wv = smem + 2 * Q;                // [Q][p + 1]: w_t x_t, then gy
  float* nv = wv + Q * (p + 1);            // [Q][n + 1]: B, then C
  const long long bh = static_cast<long long>(bb) * a.h + hh;
  const float* x = a.x + bb * a.x_sb + t0 * a.x_ss + hh * a.x_sh;
  const float* gy = a.gy + ((static_cast<long long>(bb) * a.s + t0) * a.h + hh) * p;
  const long long gy_ss = static_cast<long long>(a.h) * p;
  const float* B = a.B + bb * a.B_sb + t0 * a.B_ss;
  const float* C = a.C + bb * a.C_sb + t0 * a.C_ss;
  const float* dt = a.dt + bb * a.dt_sb + t0 * a.dt_ss + hh;

  for (int t = tid; t < Q; t += NTHREADS) cum[t] = t < len ? dt[t * a.dt_ss] : 0.f;
  __syncthreads();
  if (tid == 0) {                          // sequential, as cumsum
    const double A = a.A[hh];
    double run = 0.;
    for (int t = 0; t < Q; ++t) {
      run += A * cum[t];
      cum[t] = run;
    }
  }
  __syncthreads();
  double* cum_out = a.cum + (bh * a.nc + c) * Q;
  for (int t = tid; t < Q; t += NTHREADS) cum_out[t] = cum[t];
  const double cum_end = cum[Q - 1];
  const long long so = (bh * a.nc + c) * p * n;

  for (int part = 0; part < 2; ++part) {
    // part 0: S_c[pi][nj] = sum_t exp(cum_end - cum_t) dt_t x_t[pi] B_t[nj]
    // part 1: G_c[pi][nj] = sum_t exp(cum_t) gy_t[pi] C_t[nj]
    for (int i = tid; i < Q * p; i += NTHREADS) {
      const int t = i / p, k = i % p;
      float v = 0.f;
      if (t < len)
        v = part == 0 ? expf(static_cast<float>(cum_end - cum[t])) *
                            dt[t * a.dt_ss] * x[t * a.x_ss + k]
                      : expf(static_cast<float>(cum[t])) * gy[t * gy_ss + k];
      wv[t * (p + 1) + k] = v;
    }
    const float* m = part == 0 ? B : C;
    const long long m_ss = part == 0 ? a.B_ss : a.C_ss;
    for (int i = tid; i < Q * n; i += NTHREADS) {
      const int t = i / n, k = i % n;
      nv[t * (n + 1) + k] = t < len ? m[t * m_ss + k] : 0.f;
    }
    __syncthreads();
    float* out = (part == 0 ? a.states : a.dstates) + so;
    for (int p0 = 0; p0 < p; p0 += TILE)
      for (int n0 = 0; n0 < n; n0 += TILE) {
        float acc[RPT][CPT];
        zero(acc);
        tile_product(wv, 1, p + 1, p, p0, nv, 1, n + 1, n, n0, Q, acc);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const int pi = p0 + ty + i * TY, nj = n0 + tx + j * TX;
            if (pi < p && nj < n) out[pi * n + nj] = acc[i][j];
          }
      }
    __syncthreads();                       // wv and nv are refilled
  }
}

// Kernel 2: grid (ceil(p n / PASS_THREADS), h, b).  One thread per state
// element walks the chunks forward (H: S_c -> the state entering chunk c),
// then backward from gstate (dH: G_c -> the gradient of the state leaving
// chunk c).  The loads of a batch of chunks are issued before the chain
// uses the first, as in csrc/ssd_fwd.cu's pass.
__global__ void __launch_bounds__(PASS_THREADS)
    ssd_bwd_state_pass_kernel(const Args a) {
  extern __shared__ float smem[];
  float* decay = smem;                     // [nc]: exp(cum_end) a chunk
  const int hh = blockIdx.y, bb = blockIdx.z;
  const long long bh = static_cast<long long>(bb) * a.h + hh;
  for (int c = threadIdx.x; c < a.nc; c += PASS_THREADS)
    decay[c] = expf(static_cast<float>(a.cum[(bh * a.nc + c) * Q + (Q - 1)]));
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
  float* __restrict__ ds = a.dstates + bh * a.nc * pn + e;
  float dH = a.gstate != nullptr ? a.gstate[bh * pn + e] : 0.f;
  for (int c1 = a.nc - 1; c1 >= 0; c1 -= PASS_BATCH) {
    float G[PASS_BATCH];
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k)
      G[k] = c1 - k >= 0 ? ds[(c1 - k) * pn] : 0.f;
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      const int c = c1 - k;
      if (c >= 0) {
        ds[c * pn] = dH;
        dH = fmaf(dH, decay[c], G[k]);     // the gradient leaving chunk c - 1
      }
    }
  }
}

// Kernel 3: grid (nc, b), every head in turn.  The chunk's gradients.
__global__ void __launch_bounds__(NTHREADS)
    ssd_bwd_chunk_grad_kernel(const Args a) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, bb = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int p = a.p, n = a.n, p1 = p + 1, n1 = n + 1;
  const int t0 = c * Q;
  const int len = min(Q, a.s - t0);
  double* cum = reinterpret_cast<double*>(smem);   // [Q]
  float* Bs = smem + 2 * Q;                // [Q][n + 1]
  float* Cs = Bs + Q * n1;                 // [Q][n + 1]
  float* Sm = Cs + Q * n1;                 // [Q][Q1]: C B^T
  float* Ws = Sm + Q * Q1;                 // [Q][Q1]: S_ij L_ij, j <= i
  float* dS = Ws + Q * Q1;                 // [Q][Q1]: G_ij L_ij dt_j, j <= i
  float* xs = dS + Q * Q1;                 // [Q][p + 1]
  float* gs = xs + Q * p1;                 // [Q][p + 1]
  float* HD = gs + Q * p1;                 // [p][HB1]: 64 columns of H or dH
  float* colpart = HD + p * HB1;           // [TY][Q]
  float* dts = colpart + TY * Q;           // [Q]
  float* rowm = dts + Q;                   // [Q]: sum_j P_ij dt_j
  float* colp = rowm + Q;                  // [Q]: sum_i P_ij
  float* ev = colp + Q;                    // [Q]: e_i
  float* qv = ev + Q;                      // [Q]: q_j
  float* dg = qv + Q;                      // [Q]: G_jj
  float* red = dg + Q;                     // [NTHREADS / 32]
  const float* B = a.B + bb * a.B_sb + t0 * a.B_ss;
  const float* C = a.C + bb * a.C_sb + t0 * a.C_ss;

  for (int i = tid; i < Q * n; i += NTHREADS) {
    const int t = i / n, k = i % n;
    const bool in = t < len;
    Cs[t * n1 + k] = in ? C[t * a.C_ss + k] : 0.f;
    Bs[t * n1 + k] = in ? B[t * a.B_ss + k] : 0.f;
  }
  __syncthreads();
  {  // S = C B^T, once for every head
    float acc[RPT][CPT];
    zero(acc);
    tile_product(Cs, n1, 1, Q, 0, Bs, n1, 1, Q, 0, n, acc);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        Sm[(ty + i * TY) * Q1 + tx + j * TX] = acc[i][j];
  }
  float dBacc[NT][RPT][CPT], dCacc[NT][RPT][CPT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    zero(dBacc[nt]);
    zero(dCacc[nt]);
  }

  for (int hh = 0; hh < a.h; ++hh) {
    __syncthreads();                       // the last head is done with smem
    const long long bh = static_cast<long long>(bb) * a.h + hh;
    const float* x = a.x + bb * a.x_sb + t0 * a.x_ss + hh * a.x_sh;
    const long long g0 = ((static_cast<long long>(bb) * a.s + t0) * a.h + hh) * p;
    const long long g_ss = static_cast<long long>(a.h) * p;
    const float* dt = a.dt + bb * a.dt_sb + t0 * a.dt_ss + hh;
    const double* cum_in = a.cum + (bh * a.nc + c) * Q;
    for (int t = tid; t < Q; t += NTHREADS) {
      cum[t] = cum_in[t];
      dts[t] = t < len ? dt[t * a.dt_ss] : 0.f;
    }
    for (int i = tid; i < Q * p; i += NTHREADS) {
      const int t = i / p, k = i % p;
      const bool in = t < len;
      xs[t * p1 + k] = in ? x[t * a.x_ss + k] : 0.f;
      gs[t * p1 + k] = in ? a.gy[g0 + t * g_ss + k] : 0.f;
    }
    __syncthreads();
    const double cum_end = cum[Q - 1];
    float ecum[RPT], dec[RPT];             // exp(cum_r), exp(cum_end - cum_r)
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + i * TY;
      ecum[i] = expf(static_cast<float>(cum[r]));
      dec[i] = expf(static_cast<float>(cum_end - cum[r]));
    }

    {  // G = gy x^T; W = S . L and dS = G . L . dt_j where j <= i; the row
       // sums of P dt_j and the column sums of P = S . L . G; G's diagonal
      float acc[RPT][CPT];
      zero(acc);
      tile_product(gs, p1, 1, Q, 0, xs, p1, 1, Q, 0, p, acc);
      float rs[RPT], cs[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) cs[j] = 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        rs[i] = 0.f;
        const int r = ty + i * TY;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int q = tx + j * TX;
          float w = 0.f, d = 0.f;
          if (q <= r) {                    // the mask before the exp (C3)
            const float l = expf(static_cast<float>(cum[r] - cum[q]));
            w = Sm[r * Q1 + q] * l;
            d = acc[i][j] * l * dts[q];
            const float P = w * acc[i][j];
            rs[i] = fmaf(P, dts[q], rs[i]);
            cs[j] += P;
          }
          Ws[r * Q1 + q] = w;
          dS[r * Q1 + q] = d;
          if (q == r) dg[r] = acc[i][j];
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float v = row_sum(rs[i]);
        if (tx == 0) rowm[ty + i * TY] = v;
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) colpart[ty * Q + tx + j * TX] = cs[j];
    }
    __syncthreads();
    if (tid < Q) {
      float v = 0.f;
      for (int k = 0; k < TY; ++k) v += colpart[k * Q + tid];
      colp[tid] = v;
    }

    // dx, first its intra-chunk part W^T gy (scaled by dt_j at the end)
    float dxacc[PT][RPT][CPT];
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      zero(dxacc[pt]);
      if (pt * TILE < p)
        tile_product(Ws, 1, Q1, Q, 0, gs, 1, p1, p, pt * TILE, Q, dxacc[pt]);
    }
    // dC += dS B, dB += dS^T C
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      if (nt * TILE < n) {
        tile_product(dS, Q1, 1, Q, 0, Bs, 1, n1, n, nt * TILE, Q, dCacc[nt]);
        tile_product(dS, 1, Q1, Q, 0, Cs, 1, n1, n, nt * TILE, Q, dBacc[nt]);
      }

    // the state terms, 64 columns of n at a time: H then dH in HD
    const long long so = (bh * a.nc + c) * p * n;
    float erow[RPT], qrow[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) erow[i] = qrow[i] = 0.f;
    float hdh = 0.f;                       // this thread's part of <dH, H>
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int nb = nt * TILE;
      if (nb >= n) continue;               // (unrolled: a skipped tile)
      const int nw = min(TILE, n - nb);
      __syncthreads();                     // HD is free
      for (int i = tid; i < p * nw; i += NTHREADS) {
        const int r = i / nw, k = i % nw;
        HD[r * HB1 + k] = a.states[so + r * n + nb + k];
      }
      __syncthreads();
      {  // gy H: dC_i += exp(cum_i) (gy_i^T H), e_i's C_i . (gy_i^T H)
        float acc[RPT][CPT];
        zero(acc);
        tile_product(gs, p1, 1, Q, 0, HD, 1, HB1, nw, 0, p, acc);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = ty + i * TY;
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const int k = tx + j * TX;
            if (k < nw) {
              dCacc[nt][i][j] = fmaf(ecum[i], acc[i][j], dCacc[nt][i][j]);
              erow[i] = fmaf(Cs[r * n1 + nb + k], acc[i][j], erow[i]);
            }
          }
        }
      }
      __syncthreads();                     // every thread is done with H
      for (int i = tid; i < p * nw; i += NTHREADS) {
        const int r = i / nw, k = i % nw;
        const float d = a.dstates[so + r * n + nb + k];
        hdh = fmaf(HD[r * HB1 + k], d, hdh);
        HD[r * HB1 + k] = d;
      }
      __syncthreads();
      {  // x dH: dB_j += exp(cum_end - cum_j) dt_j (x_j^T dH)
        float acc[RPT][CPT];
        zero(acc);
        tile_product(xs, p1, 1, Q, 0, HD, 1, HB1, nw, 0, p, acc);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float w = dec[i] * dts[ty + i * TY];
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            if (tx + j * TX < nw) dBacc[nt][i][j] = fmaf(w, acc[i][j], dBacc[nt][i][j]);
        }
      }
      // B dH^T: dx_j += exp(cum_end - cum_j) (dH B_j) (times dt_j at the
      // end), q_j's x_j . exp(cum_end - cum_j) (dH B_j)
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        if (pt * TILE >= p) continue;
        float acc[RPT][CPT];
        zero(acc);
        tile_product(Bs + nb, n1, 1, Q, 0, HD, HB1, 1, p, pt * TILE, nw, acc);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = ty + i * TY;
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const int pc = pt * TILE + tx + j * TX;
            if (pc < p) {
              const float v = dec[i] * acc[i][j];
              dxacc[pt][i][j] += v;
              qrow[i] = fmaf(xs[r * p1 + pc], v, qrow[i]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float e = row_sum(erow[i]);
      const float q = row_sum(qrow[i]);
      if (tx == 0) {
        ev[ty + i * TY] = ecum[i] * e;
        qv[ty + i * TY] = q;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      hdh += __shfl_xor_sync(0xffffffffu, hdh, off);
    if (tid % 32 == 0) red[tid / 32] = hdh;
    __syncthreads();

    if (tid == 0) {  // d(cum), its reverse cumsum, ddt and the partials
      double dot = 0., sq = 0.;
      for (int w = 0; w < NTHREADS / 32; ++w) dot += red[w];
      for (int t = 0; t < Q; ++t) sq += static_cast<double>(dts[t]) * qv[t];
      const float Ah = a.A[hh];
      float* ddt = a.ddt + (static_cast<long long>(bb) * a.s + t0) * a.h + hh;
      double run = 0., dA = 0., dD = 0.;
      for (int t = Q - 1; t >= 0; --t) {
        double dc = static_cast<double>(rowm[t]) -
                    static_cast<double>(dts[t]) * colp[t] + ev[t] -
                    static_cast<double>(dts[t]) * qv[t];
        if (t == Q - 1)
          dc += static_cast<double>(expf(static_cast<float>(cum_end))) * dot + sq;
        run += dc;                         // sum of d(cum) over tokens >= t
        dA += static_cast<double>(dts[t]) * run;
        dD += dg[t];
        if (t < len)
          ddt[t * static_cast<long long>(a.h)] =
              static_cast<float>(colp[t] + qv[t] + Ah * run);
      }
      const long long pi = (static_cast<long long>(bb) * a.nc + c) * a.h + hh;
      a.parts[pi] = static_cast<float>(dA);
      a.parts[static_cast<long long>(a.b) * a.nc * a.h + pi] = static_cast<float>(dD);
    }

    // dx = dt_j (intra + state part) + D gy
    const float Dh = a.D[hh];
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = ty + i * TY;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int pc = pt * TILE + tx + j * TX;
          if (r < len && pc < p)
            a.dx[g0 + r * g_ss + pc] =
                fmaf(dts[r], dxacc[pt][i][j], Dh * gs[r * p1 + pc]);
        }
      }
  }

  // dB and dC, summed over the heads in order, rounded once
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + i * TY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int k = nt * TILE + tx + j * TX;
        if (r < len && k < n) {
          const long long at = (static_cast<long long>(bb) * a.s + t0 + r) * n + k;
          a.dB[at] = dBacc[nt][i][j];
          a.dC[at] = dCacc[nt][i][j];
        }
      }
    }
}

// Kernel 4: grid (ceil(h / PASS_THREADS)).  dA and dD from the partials of
// every (b, chunk), in order.
__global__ void __launch_bounds__(PASS_THREADS)
    ssd_bwd_reduce_kernel(const Args a) {
  const int hh = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (hh >= a.h) return;
  const long long m = static_cast<long long>(a.b) * a.nc;
  double dA = 0., dD = 0.;
  for (long long i = 0; i < m; ++i) {
    dA += a.parts[i * a.h + hh];
    dD += a.parts[(m + i) * a.h + hh];
  }
  a.dA[hh] = static_cast<float>(dA);
  a.dD[hh] = static_cast<float>(dD);
}

size_t state_smem(int p, int n) {
  return sizeof(double) * Q + sizeof(float) * (Q * (p + 1) + Q * (n + 1));
}

size_t grad_smem(int p, int n) {
  return sizeof(double) * Q +
         sizeof(float) * (2 * Q * (n + 1) + 3 * Q * Q1 + 2 * Q * (p + 1) +
                          p * HB1 + TY * Q + 6 * Q + NTHREADS / 32);
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto state_kernel = ssd_bwd_chunk_state_kernel;
  auto pass_kernel = ssd_bwd_state_pass_kernel;
  auto grad_kernel = ssd_bwd_chunk_grad_kernel;
  auto reduce_kernel = ssd_bwd_reduce_kernel;
  const size_t smem1 = state_smem(a.p, a.n);
  const size_t smem2 = sizeof(float) * a.nc;
  const size_t smem3 = grad_smem(a.p, a.n);
  const size_t smem4 = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(state_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem1))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(pass_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem2))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(grad_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem3))) != cudaSuccess)
    return err;
  const dim3 state_grid(a.nc, a.h, a.b);
  state_kernel<<<state_grid, NTHREADS, smem1, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int pn = a.p * a.n;
  const dim3 pass_grid((pn + PASS_THREADS - 1) / PASS_THREADS, a.h, a.b);
  pass_kernel<<<pass_grid, PASS_THREADS, smem2, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grad_grid(a.nc, a.b);
  grad_kernel<<<grad_grid, NTHREADS, smem3, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 reduce_grid((a.h + PASS_THREADS - 1) / PASS_THREADS);
  reduce_kernel<<<reduce_grid, PASS_THREADS, smem4, stream>>>(a);
  return cudaGetLastError();
}

int run(const void* x, const float* dt, const float* A, const void* B,
        const void* C, const float* D, const void* gy, const float* gstate,
        void* dx, float* ddt, float* dA, void* dB, void* dC, float* dD,
        double* cum, float* work, int b, int s, int h, int p, int n,
        long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
        long long dt_ss, long long B_sb, long long B_ss, long long C_sb,
        long long C_ss, cudaStream_t stream) {
  const int nc = (s + Q - 1) / Q;
  const long long bhcpn = static_cast<long long>(b) * h * nc * p * n;
  Args a{static_cast<const float*>(x), dt, A, static_cast<const float*>(B),
         static_cast<const float*>(C), D, static_cast<const float*>(gy),
         gstate, static_cast<float*>(dx), ddt, dA, static_cast<float*>(dB),
         static_cast<float*>(dC), dD, cum, work, work + bhcpn,
         work + 2 * bhcpn, b, s, h, p, n, nc,
         x_sb, x_ss, x_sh, dt_sb, dt_ss, B_sb, B_ss, C_sb, C_ss};
  return launch(a, stream);
}

// ------------------------------------------------------ bf16, tensor cores
namespace tc {

constexpr int SW = 128;            // every tile: rows of 64 bf16, 128B swizzle
constexpr int COLS = SW / 2;       // elements in a row of a column block
constexpr int NCONS = 128;         // one consumer warpgroup
constexpr int STATE_THREADS = NCONS + 32;      // and a producer warp
// two, and a producer warpgroup whose first two warps work: with 9 warps
// or more a thread could hold 168 registers at most, so the producers give
// theirs to the consumers (128 x 56 + 256 x 224 <= 65536)
constexpr int GRAD_THREADS = 3 * NCONS;
constexpr int PROD_REGS = 56;
constexpr int CONS_REGS = 224;
constexpr int GROUP = 8;           // heads per block of the gradient kernel
constexpr int SUM_THREADS = 256;
constexpr int SUM_ITEMS = 16;      // dB and dC elements a thread sums

struct Args {
  hopper::TensorMap xmap, gmap;         // x, gy: 4-d (p, s, h, b)
  hopper::TensorMap bmap, cmap;         // B, C: 3-d (n, s, b)
  hopper::TensorMap hmap, dmap;         // 2-d over hs and dhs
  const __nv_bfloat16* x;               // the same, for the threads' route
  const __nv_bfloat16* gy;
  const __nv_bfloat16* B;
  const __nv_bfloat16* C;
  const float* dt;
  const float* A;
  const float* D;
  const float* gstate;                  // [b][h][p][n] or null
  __nv_bfloat16* dx;
  float* ddt;
  float* dA;
  __nv_bfloat16* dB;
  __nv_bfloat16* dC;
  float* dD;
  // [b][h][nc][2][PP][NP], bf16 hi then lo: the states entering each chunk
  // (hs) and the gradients of the states leaving it (dhs)
  __nv_bfloat16* hs;
  __nv_bfloat16* dhs;
  float* pB;                            // [groups][b][s][n]: dB partials
  float* pC;                            // [groups][b][s][n]: dC partials
  float* parts;                         // [2][b][nc][h]: dA, dD partials
  int b, s, h, p, n, nc, groups, tma;
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

// Inclusive prefix sums in f64, in lane order, of the pairs (v0, v1) that
// the lanes of a warp hold: lane l gets the sums through token 2l and
// 2l + 1.
__device__ __forceinline__ void warp_scan_pair(double v0, double v1,
                                               double& c0, double& c1) {
  const int lane = threadIdx.x % 32;
  double s = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += o;
  }
  double before = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) before = 0.;
  c0 = before + v0;
  c1 = c0 + v1;
}

// The same from the other end: lane l gets the sums over tokens >= 2l and
// >= 2l + 1.
__device__ __forceinline__ void warp_rscan_pair(double v0, double v1,
                                                double& r0, double& r1) {
  const int lane = threadIdx.x % 32;
  double s = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_down_sync(0xffffffffu, s, off);
    if (lane + off < 32) s += o;
  }
  double after = __shfl_down_sync(0xffffffffu, s, 1);
  if (lane == 31) after = 0.;
  r1 = after + v1;
  r0 = r1 + v0;
}

// The sum over a warp's lanes, the same bits on every lane.
template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The sum over the 4 lanes that hold one accumulator row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

// The bf16 in the low or high half of a 32-bit word, as f32.
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  const uint32_t u = w << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  const uint32_t u = w & 0xffff0000u;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

// This thread's part of <dH, H> over a stage's tiles (H hi, H lo, dH hi,
// dH lo, `bytes` each, one after the other): the 16-byte pieces from `at`
// on, `step` bytes apart.  Both states share one layout, so the pieces pair
// up whatever the swizzle.
__device__ __forceinline__ float stage_dot(const char* hs, int bytes, int at,
                                           int step) {
  float acc = 0.f;
  for (int o = at; o < bytes; o += step) {
    const uint4 a = *reinterpret_cast<const uint4*>(hs + o);
    const uint4 b = *reinterpret_cast<const uint4*>(hs + bytes + o);
    const uint4 c = *reinterpret_cast<const uint4*>(hs + 2 * bytes + o);
    const uint4 d = *reinterpret_cast<const uint4*>(hs + 3 * bytes + o);
    const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
    const uint32_t wc[4] = {c.x, c.y, c.z, c.w}, wd[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc = fmaf(bf16_lo(wa[k]) + bf16_lo(wb[k]), bf16_lo(wc[k]) + bf16_lo(wd[k]),
                 acc);
      acc = fmaf(bf16_hi(wa[k]) + bf16_hi(wb[k]), bf16_hi(wc[k]) + bf16_hi(wd[k]),
                 acc);
    }
  }
  return acc;
}

// The state's rows that a consumer warp holds (16 rows of the m64n64
// accumulator) leave through shared memory, so that global memory sees
// whole 16-byte pieces of rows (as in csrc/ssd_fwd.cu's state kernel).
constexpr int STG_ROW = 2 * (COLS + 8);          // bytes
constexpr int STG_BYTES = 16 * STG_ROW;

__device__ __forceinline__ void stage_put(char* buf, int i, uint32_t v) {
  const int l = threadIdx.x % 32;
  const int r = l / 4 + 8 * ((i / 2) % 2), c = 8 * (i / 4) + 2 * (l % 4);
  *reinterpret_cast<uint32_t*>(buf + r * STG_ROW + 2 * c) = v;
}

// ---- kernel 1: the two walks over the chunks
struct StateGeo {
  static constexpr int X_BYTES = Q * SW;        // x or gy [Q][64 state rows]
  static constexpr int B_BYTES = Q * SW;        // B or C [Q][64 columns of n]
  static constexpr int STAGE = X_BYTES + B_BYTES;
  static constexpr int STAGES = 4;
  static constexpr int WROW = Q + 4;            // w [Q], then exp(cum_Q)
  static constexpr int OFF_W = STAGES * STAGE;
  static constexpr int OFF_STG = OFF_W + STAGES * WROW * 4;  // [warp][hi, lo]
  static constexpr int OFF_BAR = OFF_STG + 4 * 2 * STG_BYTES;
  static constexpr int SMEM = 1024 + OFF_BAR + 8 * 2 * STAGES;
};

// Grid (2 * NP / 64 * PP / 64, h, b): a block carries the rows m0..m0+63
// and columns n0..n0+63 of one (head, batch)'s state.  The first half of
// the blocks walk the chunks forward, H = exp(cum_Q) H + S_c with S_c =
// (w . x)^T B, w = exp(cum_Q - cum) dt, from 0, writing H as it enters each
// chunk; the second half walk them backward, dH = exp(cum_Q) dH + G_c with
// G_c = (e . gy)^T C, e = exp(cum), from gstate (or 0), writing dH as it
// leaves each chunk.  Both are one m64n64k16 product a chunk with a
// weighted register A operand (hi and lo), the carry in its accumulator.
template <int PP, int NP>
__global__ void __launch_bounds__(STATE_THREADS)
    ssd_bwd_state_kernel_tc(const __grid_constant__ Args a) {
  using namespace hopper;
  using G = StateGeo;
  constexpr int STAGES = G::STAGES;
  constexpr int TILES = NP / COLS * (PP / COLS);
  extern __shared__ float smem[];
  const uint32_t s0 = smem_addr(smem);
  char* base = reinterpret_cast<char*>(smem) + ((1024 - (s0 & 1023)) & 1023);
  float* W = reinterpret_cast<float*>(base + G::OFF_W);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + G::OFF_BAR);
  uint64_t* empty = full + STAGES;
  const bool rev = blockIdx.x >= TILES;
  const int tile = blockIdx.x % TILES;
  const int n0 = tile % (NP / COLS) * COLS;
  const int m0 = tile / (NP / COLS) * COLS;
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
    // ---- producer warp: per chunk, cum (a warp scan in f64), the weights
    // and exp(cum_Q), then the two tiles.  dt of the next chunk is loaded a
    // chunk ahead, so its latency overlaps.
    const int lane = tid - NCONS;
    const double Ah = a.A[hh];
    const float* dt = a.dt + bb * a.dt_sb + hh;
    const int t = 2 * lane;
    auto dt_at = [&](int c, int i) {
      return c >= 0 && c < a.nc && c * Q + i < a.s ? dt[(c * Q + i) * a.dt_ss]
                                                   : 0.f;
    };
    const long long gy_ss = static_cast<long long>(a.h) * a.p;
    const __nv_bfloat16* X =
        rev ? a.gy + static_cast<long long>(bb) * a.s * gy_ss + hh * a.p
            : a.x + bb * a.x_sb + hh * a.x_sh;
    const long long X_ss = rev ? gy_ss : a.x_ss;
    const __nv_bfloat16* N = rev ? a.C + bb * a.C_sb : a.B + bb * a.B_sb;
    const long long N_ss = rev ? a.C_ss : a.B_ss;
    int c = rev ? a.nc - 1 : 0;
    float d0 = dt_at(c, t), d1 = dt_at(c, t + 1);
    for (int k = 0; k < a.nc; ++k) {
      const int st = k % STAGES;
      c = rev ? a.nc - 1 - k : k;
      const int t0 = c * Q, len = min(Q, a.s - t0);
      const float e0 = dt_at(rev ? c - 1 : c + 1, t);
      const float e1 = dt_at(rev ? c - 1 : c + 1, t + 1);
      char* xs = base + st * G::STAGE;
      char* bs = xs + G::X_BYTES;
      mbar_wait(&empty[st], ((k / STAGES) & 1) ^ 1);
      if (!a.tma) {
        load_tile(xs, Q, 1, X + t0 * X_ss + m0, X_ss, len, a.p - m0);
        load_tile(bs, Q, 1, N + t0 * N_ss + n0, N_ss, len, a.n - n0);
      }
      double c0, c1;
      warp_scan_pair(Ah * d0, Ah * d1, c0, c1);
      const double cq = __shfl_sync(0xffffffffu, c1, 31);
      float* w = W + st * G::WROW;
      if (rev) {
        w[t] = expf(static_cast<float>(c0));
        w[t + 1] = expf(static_cast<float>(c1));
      } else {
        w[t] = expf(static_cast<float>(cq - c0)) * d0;
        w[t + 1] = expf(static_cast<float>(cq - c1)) * d1;
      }
      if (lane == 0) w[Q] = expf(static_cast<float>(cq));
      if (a.tma && lane == 0) {
        mbar_arrive_expect_tx(&full[st], G::STAGE);
        tma_load_4d(xs, rev ? &a.gmap : &a.xmap, &full[st], m0, t0, hh, bb);
        tma_load_3d(bs, rev ? &a.cmap : &a.bmap, &full[st], n0, t0, bb);
      } else {
        mbar_arrive(&full[st]);
      }
      d0 = e0;
      d1 = e1;
    }
  } else {
    // ---- consumer warpgroup: the carry in registers.  Per chunk its own
    // term (w . x)^T B or (e . gy)^T C is issued into a fresh accumulator;
    // while it runs, the carry is written out; then carry = exp(cum_Q)
    // carry + term.
    const int wq = tid / 32, l = tid % 32;
    const int r0 = 16 * wq + l / 4;        // this thread's rows r0, r0 + 8
    char* stg = base + G::OFF_STG + wq * 2 * STG_BYTES;   // hi, then lo
    const long long bh = static_cast<long long>(bb) * a.h + hh;
    float H[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = m0 + r0 + 8 * ((i / 2) % 2);
      const int col = n0 + 8 * (i / 4) + 2 * (l % 4) + i % 2;
      H[i] = rev && a.gstate != nullptr && row < a.p && col < a.n
                 ? a.gstate[(bh * a.p + row) * a.n + col]
                 : 0.f;
    }
    __nv_bfloat16* hs = (rev ? a.dhs : a.hs) + bh * a.nc * 2 * PP * NP;
    for (int k = 0; k < a.nc; ++k) {
      const int st = k % STAGES;
      const int c = rev ? a.nc - 1 - k : k;
      const char* xs = base + st * G::STAGE;
      const float* w = W + st * G::WROW;
      mbar_wait(&full[st], (k / STAGES) & 1);
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
      // the carry at chunk c, as bf16 hi and lo, while the term runs
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
        for (int k2 = l; k2 < 16 * 8; k2 += 32) {   // [16 rows][8 pieces]
          const int r = k2 / 8, cc = 8 * (k2 % 8);
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
  }
}

// ---- kernel 2: the chunks' gradients
template <int PP, int NP>
struct GradGeo {
  static constexpr int C_BYTES = Q * 2 * NP;    // C or B [Q][NP]
  static constexpr int X_BYTES = Q * 2 * PP;    // x or gy [Q][PP]
  static constexpr int H_BYTES = PP * 2 * NP;   // a part of H or dH [PP][NP]
  // x, gy, H hi, H lo, dH hi, dH lo
  static constexpr int STAGE = 2 * X_BYTES + 4 * H_BYTES;
  static constexpr int OFF_B = C_BYTES;
  static constexpr int OFF_RING = 2 * C_BYTES;
  static constexpr int ST_BYTES = Q * (Q + 1) * 4;   // B C^T, f32 [Q][Q + 1]
  // a head's scalars: rowm_i, e_i, colp_j, q_j [Q]; <dH, H> [8 warps]; dD [4]
  static constexpr int SC = 4 * Q + 12;
  static constexpr int REST =
      ST_BYTES + GROUP * Q * (8 + 4) + 2 * SC * 4 + 8 * 12;
  // two stages where they fit (p <= 64), else one
  static constexpr int STAGES =
      1024 + OFF_RING + 2 * STAGE + REST <= 232448 ? 2 : 1;
  static constexpr int OFF_ST = OFF_RING + STAGES * STAGE;
  static constexpr int OFF_CUM = OFF_ST + ST_BYTES;          // [GROUP][Q]
  static constexpr int OFF_DT = OFF_CUM + GROUP * Q * 8;     // [GROUP][Q]
  static constexpr int OFF_SC = OFF_DT + GROUP * Q * 4;      // [2][SC]
  static constexpr int OFF_BAR = OFF_SC + 2 * SC * 4;
  static constexpr int SMEM = 1024 + OFF_BAR + 8 * (2 + 2 * STAGES + 4);
  static_assert(SMEM <= 232448, "gradient kernel does not fit");
};

// L_ij = exp(cum_i - cum_j) at row j (cum_j = cr) and tokens i = col and
// col + 1, masked to i >= j before the exp (the difference in f64, rounded
// to f32).
__device__ __forceinline__ void decay_pair(const double* cg, double cr,
                                           int row, int col, float& l0,
                                           float& l1) {
  l0 = col >= row ? expf(static_cast<float>(cg[col] - cr)) : 0.f;
  l1 = col + 1 >= row ? expf(static_cast<float>(cg[col + 1] - cr)) : 0.f;
}

// This thread's accumulator elements (rows r0, r0 + 8 of 64, N / 2
// registers) to rows < len and columns < n of a row-major f32 matrix.
template <int R>
__device__ __forceinline__ void put_rows(float* out, const float (&v)[R],
                                         int r0, int len, int n) {
  const int l = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = r0 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (l % 4) + i % 2;
    if (row < len && col < n) out[static_cast<long long>(row) * n + col] = v[i];
  }
}

// Z = A S for one 64-column block of a state (H or dH), k over p: A [Q][PP]
// K-major at a_addr (gy or x), the state MN-major at s_addr (hi) and
// s_addr + part_bytes (lo), both parts into Z; committed, not waited on.
template <int PP>
__device__ __forceinline__ void state_product(float (&Z)[32], uint32_t a_addr,
                                              uint32_t s_addr,
                                              uint32_t part_bytes) {
  using namespace hopper;
#pragma unroll
  for (int part = 0; part < 2; ++part)
#pragma unroll
    for (int kk = 0; kk < PP / 16; ++kk) {
      const uint32_t off = (kk * 32 / SW) * Q * SW + kk * 32 % SW;
      Wgmma<64>::ss<1>(Z, smem_desc(a_addr + off, SW, 0, 8 * SW),
                       smem_desc(s_addr + part * part_bytes + kk * 16 * SW,
                                 SW, 0, 8 * SW),
                       part > 0 || kk > 0);
    }
  wgmma_commit();
}

// An opaque zero: offsets taken from it inside a loop are computed there,
// not hoisted out of the loop into registers that every iteration keeps
// (the shared-memory addresses of a head's invariant reads and the wgmma
// descriptors of C and B).
__device__ __forceinline__ uint32_t opaque_zero() {
  uint32_t z = 0;
  asm volatile("" : "+r"(z));
  return z;
}

// The producer warp's per-head tail, once both warpgroups have left their
// scalars: d(cum) = rowm - dt colp + e - dt q, with exp(cum_Q) <dH, H> +
// sum dt q added at the chunk's last token; its reverse cumsum rcs (a warp
// scan in f64); ddt = colp + q + A rcs; the (b, chunk, h) partials of dA =
// sum dt rcs and dD = sum gy . x.
__device__ void finish_head(const Args& a, const float* s, const double* cg,
                            const float* dg, int hh, int bb, int c, int t0,
                            int len) {
  const int lane = threadIdx.x % 32, t = 2 * lane;
  const float* rowm = s;
  const float* e = s + Q;
  const float* colp = s + 2 * Q;
  const float* q = s + 3 * Q;
  double hdh = 0., dd = 0.;
  for (int w = 0; w < 8; ++w) hdh += s[4 * Q + w];
  for (int w = 0; w < 4; ++w) dd += s[4 * Q + 8 + w];
  const double d0 = dg[t], d1 = dg[t + 1];
  const double sq = warp_sum(d0 * q[t] + d1 * q[t + 1]);
  double u0 = rowm[t] - d0 * colp[t] + e[t] - d0 * q[t];
  double u1 = rowm[t + 1] - d1 * colp[t + 1] + e[t + 1] - d1 * q[t + 1];
  if (lane == 31)
    u1 += static_cast<double>(expf(static_cast<float>(cg[Q - 1]))) * hdh + sq;
  double r0, r1;
  warp_rscan_pair(u0, u1, r0, r1);
  const double Ah = a.A[hh];
  float* ddt = a.ddt + (static_cast<long long>(bb) * a.s + t0) * a.h + hh;
  if (t < len)
    ddt[static_cast<long long>(t) * a.h] =
        static_cast<float>(static_cast<double>(colp[t] + q[t]) + Ah * r0);
  if (t + 1 < len)
    ddt[static_cast<long long>(t + 1) * a.h] = static_cast<float>(
        static_cast<double>(colp[t + 1] + q[t + 1]) + Ah * r1);
  const double dA = warp_sum(d0 * r0 + d1 * r1);
  if (lane == 0) {
    const long long pi = (static_cast<long long>(bb) * a.nc + c) * a.h + hh;
    a.parts[pi] = static_cast<float>(dA);
    a.parts[static_cast<long long>(a.b) * a.nc * a.h + pi] =
        static_cast<float>(dd);
  }
}

// dx of one head at rows r0 and r0 + 8 of the chunk (tokens j), in the
// calling warpgroup: y = B dH^T (B K-major over n, dH K-major, hi then
// lo); q_j = dec_j x_j . y_j; then y = dec_j y + W^T gy, W^T_ji = S^T_ji
// L_ij for i >= j from the shared S^T as the register A operand (hi and
// lo), gy MN-major over the chunk's tokens; dx = dt_j y + D gy, rounded
// once, rows past the sequence not written.  q gets q_j of the two rows.
template <int PP, int NP>
__device__ __forceinline__ void head_dx(const Args& a, const char* xs,
                                        uint32_t b_addr, const float* STs,
                                        const double* cg, const float* dg,
                                        int r0, int hh, int bb, int t0,
                                        int len, float (&q)[2]) {
  using namespace hopper;
  using G = GradGeo<PP, NP>;
  const int l = threadIdx.x % 32;
  const char* gs = xs + G::X_BYTES;
  const uint32_t g_addr = smem_addr(gs);
  const uint32_t d_addr = g_addr + G::X_BYTES + 2 * G::H_BYTES;
  const double cj[2] = {cg[r0], cg[r0 + 8]};
  const float dec[2] = {expf(static_cast<float>(cg[Q - 1] - cj[0])),
                        expf(static_cast<float>(cg[Q - 1] - cj[1]))};
  const float dtj[2] = {dg[r0], dg[r0 + 8]};
  float y[PP / 2];
  wgmma_fence();
#pragma unroll
  for (int part = 0; part < 2; ++part)
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint32_t cbk = kk * 32 / SW, in = kk * 32 % SW;
      Wgmma<PP>::template ss<0>(
          y, smem_desc(b_addr + cbk * Q * SW + in, SW, 0, 8 * SW),
          smem_desc(d_addr + part * G::H_BYTES + cbk * PP * SW + in, SW,
                    0, 8 * SW),
          part > 0 || kk > 0);
    }
  wgmma_commit();
  // while it runs: W^T, hi and lo, as the A operand of W^T gy
  uint32_t whi[4][4], wlo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float l0, l1;
      decay_pair(cg, cj[j % 2], r0 + 8 * (j % 2),
                 16 * kk + 8 * (j / 2) + 2 * (l % 4), l0, l1);
      const float* sr = STs + (r0 + 8 * (j % 2)) * (Q + 1) +
                        16 * kk + 8 * (j / 2) + 2 * (l % 4);
      split(sr[0] * l0, sr[1] * l1, whi[kk][j], wlo[kk][j]);
    }
  wgmma_wait<0>();
  fence_regs(y);
  fence_regs(whi);
  fence_regs(wlo);
  // q_j = dec_j x_j . (B dH^T)_j; then y = dec_j y + W^T gy, gy
  // MN-major over the chunk's tokens
  q[0] = q[1] = 0.f;
#pragma unroll
  for (int i = 0; i < PP / 2; ++i) {
    const int hf = (i / 2) % 2;
    const int col = 8 * (i / 4) + 2 * (l % 4) + i % 2;
    q[hf] = fmaf(tile_at(xs, Q, r0 + 8 * hf, col), y[i], q[hf]);
    y[i] *= dec[hf];
  }
  fence_regs(y);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dg_ =
        smem_desc(g_addr + kk * 16 * SW, SW, Q * SW, 8 * SW);
    Wgmma<PP>::template rs<1>(y, whi[kk], dg_, 1);
    Wgmma<PP>::template rs<1>(y, wlo[kk], dg_, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(y);
  // dx = dt_j y + D gy, rounded once; rows past the sequence are not
  // written
  const float Dh = a.D[hh];
#pragma unroll
  for (int i = 0; i < PP / 2; i += 2) {
    const int hf = (i / 2) % 2;
    const int row = r0 + 8 * hf;
    const int col = 8 * (i / 4) + 2 * (l % 4);
    if (row >= len || col >= a.p) continue;
    const long long at =
        ((static_cast<long long>(bb) * a.s + t0 + row) * a.h + hh) * a.p +
        col;
    const float v0 = fmaf(dtj[hf], y[i], Dh * tile_at(gs, Q, row, col));
    if (a.p % 2 == 0) {
      const float v1 =
          fmaf(dtj[hf], y[i + 1], Dh * tile_at(gs, Q, row, col + 1));
      *reinterpret_cast<uint32_t*>(a.dx + at) = pack_bf16x2(v0, v1);
    } else {
      a.dx[at] = __float2bfloat16(v0);
      if (col + 1 < a.p)
        a.dx[at + 1] = __float2bfloat16(
            fmaf(dtj[hf], y[i + 1], Dh * tile_at(gs, Q, row, col + 1)));
    }
  }
  q[0] = dec[0] * quad_sum(q[0]);
  q[1] = dec[1] * quad_sum(q[1]);
}

// Grid (nc, groups, b): a block takes one chunk of one batch row and up to
// GROUP heads.  C and B come in once; per head, over a ring of stages, x,
// gy and the entering H and leaving dH (hi and lo).  In each chunk, with
// rows i and columns j of its Q x Q matrices, L_ij = exp(cum_i - cum_j)
// for i >= j (masked before the exp):
//   warpgroup 0 (rows i): G = gy x^T; dS = G . L . dt_j (register A, hi
//     and lo) and rowm_i = sum_j dS_ij S_ij from the f32 values; then per
//     64 columns of n Z = gy H, e_i's C_i . Z_i, Z = exp(cum_i) Z + dS B,
//     the head's dC there, summed over the group's heads in registers;
//   warpgroup 1 (rows j): S^T = B C^T once for the group, to shared memory
//     for both warpgroups; per head G^T = x gy^T, dS^T as the register A
//     operand (the transposes come from the products taken the other way,
//     not through shared memory), colp_j = sum_i W^T_ji G^T_ji with W^T =
//     S^T . L^T; per 64 columns of n the head's dB = dec_j dt_j (x dH) +
//     dS^T C there, summed over the group's heads in registers; then dx
//     (head_dx);
//   (64 columns at a time keep a product's accumulator at 32 registers;
//   at n = 128 the kernel still spills some hundred bytes)
//   the producer warpgroup's first warp loads the ring; its second finishes
//   each head (finish_head) from the scalars the two warpgroups leave in
//   one of two buffers, and frees the buffer for the head two on.
// The group's dB and dC go out as f32 partials, summed by kernel 3.
template <int PP, int NP>
__global__ void __launch_bounds__(GRAD_THREADS, 1)
    ssd_bwd_grad_kernel_tc(const __grid_constant__ Args a) {
  using namespace hopper;
  using G = GradGeo<PP, NP>;
  constexpr int STAGES = G::STAGES;
  extern __shared__ float smem[];
  const uint32_t s0 = smem_addr(smem);
  char* base = reinterpret_cast<char*>(smem) + ((1024 - (s0 & 1023)) & 1023);
  char* Cs = base;
  char* Bs = base + G::OFF_B;
  float* STs = reinterpret_cast<float*>(base + G::OFF_ST);
  double* cum = reinterpret_cast<double*>(base + G::OFF_CUM);
  float* dts = reinterpret_cast<float*>(base + G::OFF_DT);
  float* scal = reinterpret_cast<float*>(base + G::OFF_SC);
  uint64_t* cb_full = reinterpret_cast<uint64_t*>(base + G::OFF_BAR);
  uint64_t* full = cb_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* ready = empty + STAGES;        // [2]: a head's scalars are in
  uint64_t* sfree = ready + 2;             // [2]: and have been read
  uint64_t* st_ready = sfree + 2;          // S^T is in
  const int c = blockIdx.x, grp = blockIdx.y, bb = blockIdx.z;
  const int h0 = grp * GROUP;
  const int nh = min(GROUP, a.h - h0);
  const int t0 = c * Q, len = min(Q, a.s - t0);
  const int tid = threadIdx.x;
  const uint32_t c_addr = smem_addr(Cs), b_addr = smem_addr(Bs);
  if (tid == 0) {
    mbar_init(cb_full, 32);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 32);
      mbar_init(&empty[st], 2 * NCONS / 32);
    }
    for (int k = 0; k < 2; ++k) {
      mbar_init(&ready[k], 2 * NCONS);
      mbar_init(&sfree[k], 32);
    }
    mbar_init(st_ready, NCONS);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 2 * NCONS) {
    // ---- producer warpgroup: the first warp loads, the second finishes
    // the heads, the other two leave
    setmaxnreg_dec<PROD_REGS>();
    if (tid >= 2 * NCONS + 64) return;
    if (tid >= 2 * NCONS + 32) {
      // finish_head for each head once both warpgroups have left its
      // scalars, then the buffer is free again
      for (int f = 0; f < nh; ++f) {
        mbar_wait(&ready[f & 1], (f >> 1) & 1);
        finish_head(a, scal + (f & 1) * G::SC, cum + f * Q, dts + f * Q,
                    h0 + f, bb, c, t0, len);
        mbar_arrive(&sfree[f & 1]);
      }
      return;
    }
    // dt and cum of the group, C and B, then per head x, gy, H and dH
    const int lane = tid - 2 * NCONS;
    const float* dt = a.dt + bb * a.dt_sb + t0 * a.dt_ss + h0;
    for (int i = lane; i < Q * nh; i += 32) {   // one [Q x nh] read
      const int t = i / nh, g = i % nh;
      dts[g * Q + t] = t < len ? dt[t * a.dt_ss + g] : 0.f;
    }
    __syncwarp();
    for (int g = 0; g < nh; ++g) {
      const double Ag = a.A[h0 + g];
      double c0, c1;
      warp_scan_pair(Ag * dts[g * Q + 2 * lane],
                     Ag * dts[g * Q + 2 * lane + 1], c0, c1);
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
    const long long gy_ss = static_cast<long long>(a.h) * a.p;
    for (int g = 0; g < nh; ++g) {
      const int st = g % STAGES, hh = h0 + g;
      char* xs = base + G::OFF_RING + st * G::STAGE;
      char* gs = xs + G::X_BYTES;
      char* hst = gs + G::X_BYTES;       // H hi, H lo, dH hi, dH lo
      mbar_wait(&empty[st], ((g / STAGES) & 1) ^ 1);
      if (!a.tma) {
        load_tile(xs, Q, PP / COLS,
                  a.x + bb * a.x_sb + t0 * a.x_ss + hh * a.x_sh, a.x_ss,
                  len, a.p);
        load_tile(gs, Q, PP / COLS,
                  a.gy + (static_cast<long long>(bb) * a.s + t0) * gy_ss +
                      hh * a.p,
                  gy_ss, len, a.p);
      }
      if (lane == 0) {
        const int hrow = static_cast<int>(
            ((static_cast<long long>(bb) * a.h + hh) * a.nc + c) * 2 * PP);
        mbar_arrive_expect_tx(
            &full[st], (a.tma ? 2 * G::X_BYTES : 0) + 4 * G::H_BYTES);
        if (a.tma)
          for (int cb = 0; cb < PP / COLS; ++cb) {
            tma_load_4d(xs + cb * Q * SW, &a.xmap, &full[st], cb * COLS, t0,
                        hh, bb);
            tma_load_4d(gs + cb * Q * SW, &a.gmap, &full[st], cb * COLS, t0,
                        hh, bb);
          }
        for (int part = 0; part < 2; ++part)
          for (int cb = 0; cb < NP / COLS; ++cb) {
            tma_load_2d(hst + part * G::H_BYTES + cb * PP * SW, &a.hmap,
                        &full[st], cb * COLS, hrow + part * PP);
            tma_load_2d(hst + (2 + part) * G::H_BYTES + cb * PP * SW,
                        &a.dmap, &full[st], cb * COLS, hrow + part * PP);
          }
      } else {
        mbar_arrive(&full[st]);
      }
    }
  } else if (tid < NCONS) {
    // ---- warpgroup 0: rows i; dS, and dC summed over the heads
    setmaxnreg_inc<CONS_REGS>();
    const int wq = tid / 32, l = tid % 32;
    const int r0 = 16 * wq + l / 4;        // this thread's rows r0, r0 + 8
    float dCs[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) dCs[i] = 0.f;
    mbar_wait(cb_full, 0);
    mbar_wait(st_ready, 0);
    for (int g = 0; g < nh; ++g) {
      const uint32_t z = opaque_zero();
      const char* Cz = Cs + z;
      const float* STz = STs + z;
      const uint32_t bz = b_addr + z;
      const int st = g % STAGES;
      const char* xs = base + G::OFF_RING + st * G::STAGE;
      const uint32_t x_addr = smem_addr(xs);
      const uint32_t g_addr = x_addr + G::X_BYTES;
      const uint32_t h_addr = g_addr + G::X_BYTES;
      const double* cg = cum + g * Q;
      const float* dg = dts + g * Q;
      const double ci[2] = {cg[r0], cg[r0 + 8]};
      mbar_wait(&full[st], (g / STAGES) & 1);
      // G = gy x^T (both K-major over p); Z = gy H for 64 columns of n at
      // a time, the first behind G
      float Gm[32], Z[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PP / 16; ++kk) {
        const uint32_t off = (kk * 32 / SW) * Q * SW + kk * 32 % SW;
        Wgmma<64>::ss<0>(Gm, smem_desc(g_addr + off, SW, 0, 8 * SW),
                         smem_desc(x_addr + off, SW, 0, 8 * SW), kk > 0);
      }
      wgmma_commit();
      state_product<PP>(Z, g_addr, h_addr, G::H_BYTES);
      wgmma_wait<1>();
      fence_regs(Gm);
      // dS_ij = G_ij L_ij dt_j for j <= i, hi and lo, as the A operand
      // (accumulator registers 8 kk .. 8 kk + 7 are columns 16 kk .. 16 kk
      // + 15); rowm_i = sum_j dS_ij S_ij; G's diagonal for dD
      uint32_t shi[4][4], slo[4][4];
      float diag = 0.f, rowm[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j;
          const int row = r0 + 8 * (j % 2);
          const int col = 16 * kk + 8 * (j / 2) + 2 * (l % 4);
          const double cr = ci[j % 2];
          const float v0 =
              col <= row ? Gm[i] * expf(static_cast<float>(cr - cg[col])) *
                               dg[col]
                         : 0.f;
          const float v1 =
              col + 1 <= row ? Gm[i + 1] *
                                   expf(static_cast<float>(cr - cg[col + 1])) *
                                   dg[col + 1]
                             : 0.f;
          if (col == row) diag += Gm[i];
          if (col + 1 == row) diag += Gm[i + 1];
          rowm[j % 2] = fmaf(v0, STz[col * (Q + 1) + row],
                             fmaf(v1, STz[(col + 1) * (Q + 1) + row],
                                  rowm[j % 2]));
          split(v0, v1, shi[kk][j], slo[kk][j]);
        }
      const float e[2] = {expf(static_cast<float>(ci[0])),
                          expf(static_cast<float>(ci[1]))};
      fence_regs(shi);
      fence_regs(slo);
      // per 64 columns of n: e_i's C_i . (gy H)_i, then the head's dC
      // there, Z = exp(cum_i) Z + dS B (B MN-major over the chunk's
      // tokens), added to dC's sum
      float ec[2] = {0.f, 0.f}, hdh = 0.f;
#pragma unroll
      for (int nb = 0; nb < NP / COLS; ++nb) {
        if (nb > 0) {
          wgmma_fence();
          state_product<PP>(Z, g_addr, h_addr + nb * PP * SW, G::H_BYTES);
        }
        wgmma_wait<0>();
        fence_regs(Z);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hf = (i / 2) % 2;
          const int col = nb * COLS + 8 * (i / 4) + 2 * (l % 4) + i % 2;
          ec[hf] = fmaf(tile_at(Cz, Q, r0 + 8 * hf, col), Z[i], ec[hf]);
          Z[i] *= e[hf];
        }
        fence_regs(Z);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = smem_desc(bz + nb * Q * SW + kk * 16 * SW,
                                        SW, 0, 8 * SW);
          Wgmma<64>::rs<1>(Z, shi[kk], db, 1);
          Wgmma<64>::rs<1>(Z, slo[kk], db, 1);
        }
        wgmma_commit();
        // while the last runs: this thread's part of <dH, H>
        if (nb == NP / COLS - 1)
          hdh = stage_dot(xs + 2 * G::X_BYTES, G::H_BYTES, 16 * tid,
                          16 * 2 * NCONS);
        wgmma_wait<0>();
        fence_regs(Z);
#pragma unroll
        for (int i = 0; i < 32; ++i) dCs[nb * 32 + i] += Z[i];
      }
      __syncwarp();
      if (l == 0) mbar_arrive(&empty[st]);
      hdh = warp_sum(hdh);
      diag = warp_sum(diag);
      for (int hf = 0; hf < 2; ++hf) {
        rowm[hf] = quad_sum(rowm[hf]);
        ec[hf] = e[hf] * quad_sum(ec[hf]);
      }
      if (g >= 2) mbar_wait(&sfree[g & 1], ((g >> 1) + 1) & 1);
      float* s = scal + (g & 1) * G::SC;
      if (l % 4 == 0)
        for (int hf = 0; hf < 2; ++hf) {
          s[r0 + 8 * hf] = rowm[hf];
          s[Q + r0 + 8 * hf] = ec[hf];
        }
      if (l == 0) {
        s[4 * Q + wq] = hdh;
        s[4 * Q + 8 + wq] = diag;
      }
      mbar_arrive(&ready[g & 1]);
    }
    const long long m = static_cast<long long>(a.b) * a.s * a.n;
    put_rows(a.pC + grp * m + (static_cast<long long>(bb) * a.s + t0) * a.n,
             dCs, r0, len, a.n);
  } else {
    // ---- warpgroup 1: rows j; dS^T and W^T, dB summed over the heads, dx
    setmaxnreg_inc<CONS_REGS>();
    const int tw = tid - NCONS, wq = tw / 32, l = tid % 32;
    const int r0 = 16 * wq + l / 4;        // this thread's rows r0, r0 + 8
    float dBs[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) dBs[i] = 0.f;
    mbar_wait(cb_full, 0);
    {  // S^T = B C^T (both K-major over n), once for the group, for both
       // warpgroups
      float S[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        const uint32_t off = (kk * 32 / SW) * Q * SW + kk * 32 % SW;
        Wgmma<64>::ss<0>(S, smem_desc(b_addr + off, SW, 0, 8 * SW),
                         smem_desc(c_addr + off, SW, 0, 8 * SW), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(S);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        STs[(r0 + 8 * ((i / 2) % 2)) * (Q + 1) + 8 * (i / 4) + 2 * (l % 4) +
            i % 2] = S[i];
      mbar_arrive(st_ready);
    }
    for (int g = 0; g < nh; ++g) {
      const uint32_t z = opaque_zero();
      const float* STz = STs + z;
      const uint32_t bz = b_addr + z, cz = c_addr + z;
      const int st = g % STAGES, hh = h0 + g;
      const char* xs = base + G::OFF_RING + st * G::STAGE;
      const uint32_t x_addr = smem_addr(xs);
      const uint32_t g_addr = x_addr + G::X_BYTES;
      const uint32_t d_addr = g_addr + G::X_BYTES + 2 * G::H_BYTES;
      const double* cg = cum + g * Q;
      const float* dg = dts + g * Q;
      const double cj[2] = {cg[r0], cg[r0 + 8]};
      const float dec[2] = {expf(static_cast<float>(cg[Q - 1] - cj[0])),
                            expf(static_cast<float>(cg[Q - 1] - cj[1]))};
      const float dtj[2] = {dg[r0], dg[r0 + 8]};
      mbar_wait(&full[st], (g / STAGES) & 1);
      // G^T = x gy^T (both K-major over p); Z = x dH for 64 columns of n
      // at a time, the first behind G^T
      float Gt[32], Z[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PP / 16; ++kk) {
        const uint32_t off = (kk * 32 / SW) * Q * SW + kk * 32 % SW;
        Wgmma<64>::ss<0>(Gt, smem_desc(x_addr + off, SW, 0, 8 * SW),
                         smem_desc(g_addr + off, SW, 0, 8 * SW), kk > 0);
      }
      wgmma_commit();
      state_product<PP>(Z, x_addr, d_addr, G::H_BYTES);
      wgmma_wait<1>();
      fence_regs(Gt);
      // dS^T_ji = G^T_ji L_ij dt_j for i >= j, hi and lo; colp_j = sum_i
      // W^T_ji G^T_ji with W^T_ji = S^T_ji L_ij
      uint32_t thi[4][4], tlo[4][4];
      float colp[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j;
          float l0, l1;
          decay_pair(cg, cj[j % 2], r0 + 8 * (j % 2),
                     16 * kk + 8 * (j / 2) + 2 * (l % 4), l0, l1);
          const float* sr = STz + (r0 + 8 * (j % 2)) * (Q + 1) +
                            16 * kk + 8 * (j / 2) + 2 * (l % 4);
          colp[j % 2] =
              fmaf(sr[0] * l0, Gt[i], fmaf(sr[1] * l1, Gt[i + 1], colp[j % 2]));
          split(Gt[i] * l0 * dtj[j % 2], Gt[i + 1] * l1 * dtj[j % 2],
                thi[kk][j], tlo[kk][j]);
        }
      fence_regs(thi);
      fence_regs(tlo);
      // per 64 columns of n, the head's dB there: Z = dec_j dt_j (x dH) +
      // dS^T C (C MN-major over the chunk's tokens), added to dB's sum
      float hdh = 0.f;
#pragma unroll
      for (int nb = 0; nb < NP / COLS; ++nb) {
        if (nb > 0) {
          wgmma_fence();
          state_product<PP>(Z, x_addr, d_addr + nb * PP * SW, G::H_BYTES);
        }
        wgmma_wait<0>();
        fence_regs(Z);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          Z[i] *= dec[(i / 2) % 2] * dtj[(i / 2) % 2];
        fence_regs(Z);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dc = smem_desc(cz + nb * Q * SW + kk * 16 * SW,
                                        SW, 0, 8 * SW);
          Wgmma<64>::rs<1>(Z, thi[kk], dc, 1);
          Wgmma<64>::rs<1>(Z, tlo[kk], dc, 1);
        }
        wgmma_commit();
        // while the last runs: this thread's part of <dH, H>
        if (nb == NP / COLS - 1)
          hdh = stage_dot(xs + 2 * G::X_BYTES, G::H_BYTES, 16 * tid,
                          16 * 2 * NCONS);
        wgmma_wait<0>();
        fence_regs(Z);
#pragma unroll
        for (int i = 0; i < 32; ++i) dBs[nb * 32 + i] += Z[i];
      }
      float q[2];
      head_dx<PP, NP>(a, xs, bz, STz, cg, dg, r0, hh, bb, t0, len, q);
      __syncwarp();
      if (l == 0) mbar_arrive(&empty[st]);
      colp[0] = quad_sum(colp[0]);
      colp[1] = quad_sum(colp[1]);
      hdh = warp_sum(hdh);
      if (g >= 2) mbar_wait(&sfree[g & 1], ((g >> 1) + 1) & 1);
      float* s = scal + (g & 1) * G::SC;
      if (l % 4 == 0) {
        s[2 * Q + r0] = colp[0];
        s[2 * Q + r0 + 8] = colp[1];
        s[3 * Q + r0] = q[0];
        s[3 * Q + r0 + 8] = q[1];
      }
      if (l == 0) s[4 * Q + 4 + wq] = hdh;
      mbar_arrive(&ready[g & 1]);
    }
    const long long m = static_cast<long long>(a.b) * a.s * a.n;
    put_rows(a.pB + grp * m + (static_cast<long long>(bb) * a.s + t0) * a.n,
             dBs, r0, len, a.n);
  }
}

// ---- kernel 3: the first blocks sum the dA and dD partials of every (b,
// chunk), a warp a head (each lane a strided share, then the warp's
// tree); the others the groups' dB and dC partials; each sum in one fixed
// order, rounded once
__global__ void __launch_bounds__(SUM_THREADS)
    ssd_bwd_sum_kernel_tc(const __grid_constant__ Args a) {
  constexpr int WARPS = SUM_THREADS / 32;
  const int head_blocks = (a.h + WARPS - 1) / WARPS;
  if (static_cast<int>(blockIdx.x) < head_blocks) {
    const int hh = blockIdx.x * WARPS + threadIdx.x / 32;
    if (hh >= a.h) return;
    const long long m = static_cast<long long>(a.b) * a.nc;
    double dA = 0., dD = 0.;
    for (long long i = threadIdx.x % 32; i < m; i += 32) {
      dA += a.parts[i * a.h + hh];
      dD += a.parts[(m + i) * a.h + hh];
    }
    dA = warp_sum(dA);
    dD = warp_sum(dD);
    if (threadIdx.x % 32 == 0) {
      a.dA[hh] = static_cast<float>(dA);
      a.dD[hh] = static_cast<float>(dD);
    }
    return;
  }
  const long long m = static_cast<long long>(a.b) * a.s * a.n;
  const long long step =
      static_cast<long long>(gridDim.x - head_blocks) * SUM_THREADS;
  for (long long i = static_cast<long long>(blockIdx.x - head_blocks) *
                         SUM_THREADS +
                     threadIdx.x;
       i < m; i += step) {
    float vb = 0.f, vc = 0.f;
    for (int g = 0; g < a.groups; ++g) {
      vb += a.pB[g * m + i];
      vc += a.pC[g * m + i];
    }
    a.dB[i] = __float2bfloat16(vb);
    a.dC[i] = __float2bfloat16(vc);
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
  using GG = GradGeo<PP, NP>;
  const long long rows = static_cast<long long>(a.b) * a.h * a.nc * 2 * PP;
  const long long m = static_cast<long long>(a.b) * a.s * a.n;
  if (rows > INT_MAX || m / SUM_THREADS + 2 > INT_MAX)
    return cudaErrorInvalidValue;
  cudaError_t err;
  const uint64_t hdims[2] = {uint64_t(NP), uint64_t(rows)};
  const uint64_t hstr[1] = {uint64_t(NP) * 2};
  const uint32_t hbox[2] = {COLS, PP};
  if ((err = hopper::make_tensor_map(&a.hmap, a.hs, 2, hdims, hstr, hbox,
                                     SW)) != cudaSuccess ||
      (err = hopper::make_tensor_map(&a.dmap, a.dhs, 2, hdims, hstr, hbox,
                                     SW)) != cudaSuccess)
    return err;
  if (a.tma) {
    const uint64_t xdims[4] = {uint64_t(a.p), uint64_t(a.s), uint64_t(a.h),
                               uint64_t(a.b)};
    const uint64_t xstr[3] = {map_stride(a.x_ss, a.s), map_stride(a.x_sh, a.h),
                              map_stride(a.x_sb, a.b)};
    const long long gy_ss = static_cast<long long>(a.h) * a.p;
    const uint64_t gstr[3] = {map_stride(gy_ss, a.s), map_stride(a.p, a.h),
                              map_stride(gy_ss * a.s, a.b)};
    const uint32_t xbox[4] = {COLS, Q, 1, 1};
    const uint64_t ndims[3] = {uint64_t(a.n), uint64_t(a.s), uint64_t(a.b)};
    const uint64_t bstr[2] = {map_stride(a.B_ss, a.s), map_stride(a.B_sb, a.b)};
    const uint64_t cstr[2] = {map_stride(a.C_ss, a.s), map_stride(a.C_sb, a.b)};
    const uint32_t nbox[3] = {COLS, Q, 1};
    if ((err = hopper::make_tensor_map(&a.xmap, a.x, 4, xdims, xstr, xbox,
                                       SW)) != cudaSuccess ||
        (err = hopper::make_tensor_map(&a.gmap, a.gy, 4, xdims, gstr, xbox,
                                       SW)) != cudaSuccess ||
        (err = hopper::make_tensor_map(&a.bmap, a.B, 3, ndims, bstr, nbox,
                                       SW)) != cudaSuccess ||
        (err = hopper::make_tensor_map(&a.cmap, a.C, 3, ndims, cstr, nbox,
                                       SW)) != cudaSuccess)
      return err;
  }
  auto state_kernel = ssd_bwd_state_kernel_tc<PP, NP>;
  auto grad_kernel = ssd_bwd_grad_kernel_tc<PP, NP>;
  if ((err = cudaFuncSetAttribute(state_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SG::SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(grad_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  GG::SMEM)) != cudaSuccess)
    return err;
  const dim3 state_grid(2 * (NP / COLS) * (PP / COLS), a.h, a.b);
  state_kernel<<<state_grid, STATE_THREADS, SG::SMEM, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grad_grid(a.nc, a.groups, a.b);
  grad_kernel<<<grad_grid, GRAD_THREADS, GG::SMEM, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long per_block = static_cast<long long>(SUM_THREADS) * SUM_ITEMS;
  const dim3 sum_grid(static_cast<unsigned>(
      (a.h + SUM_THREADS / 32 - 1) / (SUM_THREADS / 32) +
      (m + per_block - 1) / per_block));
  ssd_bwd_sum_kernel_tc<<<sum_grid, SUM_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32 (the four CUDA-core kernels), 1 = bfloat16 (the three
// tensor-core kernels) for x, B, C, gy, dx, dB and dC; dt, A, D, gstate,
// ddt, dA and dD are f32.  Strides are in elements; the last dim of x, dt,
// B and C is contiguous; gy, gstate, dx, ddt, dB and dC are contiguous;
// gstate [b,h,p,n] may be null (a zero gradient of the final state).
// Scratch, with nc = ceil(s / 64):
//   float32:  cum of b*h*nc*64 doubles, and work of 2*b*h*nc*p*n + 2*b*nc*h
//             floats (the entering states, the leaving states' gradients,
//             the partials of dA and dD);
//   bfloat16: cum unused, and work of 2*b*h*nc*PP*NP + 2*G*b*s*n +
//             2*b*nc*h floats (the entering states and the leaving states'
//             gradients as bf16 hi and lo, the G = ceil(h / 8) head groups'
//             partials of dB and dC, the partials of dA and dD), PP, NP: p
//             and n rounded up to 64 or 128; 16-byte aligned.
// tma (bfloat16): 1 to read x, gy, B and C by TMA (each 16-byte aligned,
// strides in 16-byte multiples: kernels/tma.py), 0 to load them by
// threads.  Returns the cudaError_t of the launches (0 on success);
// nothing synchronises.
int ssd_bwd(const void* x, const float* dt, const float* A, const void* B,
            const void* C, const float* D, const void* gy,
            const float* gstate, void* dx, float* ddt, float* dA, void* dB,
            void* dC, float* dD, double* cum, float* work, int b, int s,
            int h, int p, int n, long long x_sb, long long x_ss,
            long long x_sh, long long dt_sb, long long dt_ss, long long B_sb,
            long long B_ss, long long C_sb, long long C_ss, int dtype,
            int tma, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || p > MAX_P || n <= 0 ||
      n > MAX_N || b > 65535 || h > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run(x, dt, A, B, C, D, gy, gstate, dx, ddt, dA, dB, dC, dD, cum,
               work, b, s, h, p, n, x_sb, x_ss, x_sh, dt_sb, dt_ss, B_sb,
               B_ss, C_sb, C_ss, st);
  if (dtype != 1) return cudaErrorInvalidValue;
  const int nc = (s + Q - 1) / Q;
  const int pp = p <= 64 ? 64 : 128, np = n <= 64 ? 64 : 128;
  const long long states = static_cast<long long>(b) * h * nc * pp * np;
  const long long m = static_cast<long long>(b) * s * n;
  tc::Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.gy = static_cast<const __nv_bfloat16*>(gy);
  a.B = static_cast<const __nv_bfloat16*>(B);
  a.C = static_cast<const __nv_bfloat16*>(C);
  a.dt = dt;
  a.A = A;
  a.D = D;
  a.gstate = gstate;
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.ddt = ddt;
  a.dA = dA;
  a.dB = static_cast<__nv_bfloat16*>(dB);
  a.dC = static_cast<__nv_bfloat16*>(dC);
  a.dD = dD;
  a.hs = reinterpret_cast<__nv_bfloat16*>(work);
  a.dhs = reinterpret_cast<__nv_bfloat16*>(work + states);
  a.groups = (h + tc::GROUP - 1) / tc::GROUP;
  a.pB = work + 2 * states;
  a.pC = a.pB + a.groups * m;
  a.parts = a.pC + a.groups * m;
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

const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
