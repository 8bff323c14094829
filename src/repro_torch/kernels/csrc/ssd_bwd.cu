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
// h=24, p=64, n=128, bf16) the products it runs are ~52 GFLOP (the
// recomputed chunk states and the dH terms, C B^T once per (b, chunk), the
// intra-chunk dx, dS, dB and dC products per head) against ~170 MB that
// must move (x, gy and dx 50 MB each, B, C, dB, dC, dt and ddt): 0.052 ms
// at the bf16 tensor-core peak against 0.051 ms at 3.35 TB/s.  This first
// version runs every product as f32 FMAs on the CUDA cores (67 TFLOP/s
// peak), bf16 inputs widened on load, so the CUDA cores bound it; the
// tensor cores are later work (ROADMAP.md, B1).
//
// Hopper runs blocks in no order, so the reverse recurrence over chunks is
// split out, as in csrc/ssd_fwd.cu's f32 path, read backwards:
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
// No atomics, so two calls give the same bits.  exp(cum_i - cum_j) is
// formed only where i >= j (ROADMAP.md, C3), differences of cum are taken
// in f64 and rounded to f32 before the exp, as in csrc/ssd_fwd.cu.  x, dt,
// B and C are read through their strides (the model passes slices of the
// convolution's output); gy, gstate and the outputs are contiguous.  The
// ragged last chunk reads its missing tokens as dt = 0, x = B = C = gy = 0,
// as the forward does, and writes nothing for them.  Each tile product is
// the forward's: a 4 x 4 block of a 64 x 64 tile a thread, operands staged
// as f32 in shared memory with rows padded to an odd length.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
struct Args {
  const T* x;
  const float* dt;
  const float* A;
  const T* B;
  const T* C;
  const float* D;
  const T* gy;                     // [b][s][h][p]
  const float* gstate;             // [b][h][p][n] or null
  T* dx;                           // [b][s][h][p]
  float* ddt;                      // [b][s][h]
  float* dA;                       // [h]
  T* dB;                           // [b][s][n]
  T* dC;                           // [b][s][n]
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
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    ssd_bwd_chunk_state_kernel(const Args<T> a) {
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
  const T* x = a.x + bb * a.x_sb + t0 * a.x_ss + hh * a.x_sh;
  const T* gy = a.gy + ((static_cast<long long>(bb) * a.s + t0) * a.h + hh) * p;
  const long long gy_ss = static_cast<long long>(a.h) * p;
  const T* B = a.B + bb * a.B_sb + t0 * a.B_ss;
  const T* C = a.C + bb * a.C_sb + t0 * a.C_ss;
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
                            dt[t * a.dt_ss] * to_f(x[t * a.x_ss + k])
                      : expf(static_cast<float>(cum[t])) * to_f(gy[t * gy_ss + k]);
      wv[t * (p + 1) + k] = v;
    }
    const T* m = part == 0 ? B : C;
    const long long m_ss = part == 0 ? a.B_ss : a.C_ss;
    for (int i = tid; i < Q * n; i += NTHREADS) {
      const int t = i / n, k = i % n;
      nv[t * (n + 1) + k] = t < len ? to_f(m[t * m_ss + k]) : 0.f;
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
template <typename T>
__global__ void __launch_bounds__(PASS_THREADS)
    ssd_bwd_state_pass_kernel(const Args<T> a) {
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
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    ssd_bwd_chunk_grad_kernel(const Args<T> a) {
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
  const T* B = a.B + bb * a.B_sb + t0 * a.B_ss;
  const T* C = a.C + bb * a.C_sb + t0 * a.C_ss;

  for (int i = tid; i < Q * n; i += NTHREADS) {
    const int t = i / n, k = i % n;
    const bool in = t < len;
    Cs[t * n1 + k] = in ? to_f(C[t * a.C_ss + k]) : 0.f;
    Bs[t * n1 + k] = in ? to_f(B[t * a.B_ss + k]) : 0.f;
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
    const T* x = a.x + bb * a.x_sb + t0 * a.x_ss + hh * a.x_sh;
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
      xs[t * p1 + k] = in ? to_f(x[t * a.x_ss + k]) : 0.f;
      gs[t * p1 + k] = in ? to_f(a.gy[g0 + t * g_ss + k]) : 0.f;
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
            put(a.dx + g0 + r * g_ss + pc,
                fmaf(dts[r], dxacc[pt][i][j], Dh * gs[r * p1 + pc]));
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
          put(a.dB + at, dBacc[nt][i][j]);
          put(a.dC + at, dCacc[nt][i][j]);
        }
      }
    }
}

// Kernel 4: grid (ceil(h / PASS_THREADS)).  dA and dD from the partials of
// every (b, chunk), in order.
template <typename T>
__global__ void __launch_bounds__(PASS_THREADS)
    ssd_bwd_reduce_kernel(const Args<T> a) {
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

template <typename T>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  auto state_kernel = ssd_bwd_chunk_state_kernel<T>;
  auto pass_kernel = ssd_bwd_state_pass_kernel<T>;
  auto grad_kernel = ssd_bwd_chunk_grad_kernel<T>;
  auto reduce_kernel = ssd_bwd_reduce_kernel<T>;
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

template <typename T>
int run(const void* x, const float* dt, const float* A, const void* B,
        const void* C, const float* D, const void* gy, const float* gstate,
        void* dx, float* ddt, float* dA, void* dB, void* dC, float* dD,
        double* cum, float* work, int b, int s, int h, int p, int n,
        long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
        long long dt_ss, long long B_sb, long long B_ss, long long C_sb,
        long long C_ss, cudaStream_t stream) {
  const int nc = (s + Q - 1) / Q;
  const long long bhcpn = static_cast<long long>(b) * h * nc * p * n;
  Args<T> a{static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
            static_cast<const T*>(C), D, static_cast<const T*>(gy), gstate,
            static_cast<T*>(dx), ddt, dA, static_cast<T*>(dB),
            static_cast<T*>(dC), dD, cum, work, work + bhcpn,
            work + 2 * bhcpn, b, s, h, p, n, nc,
            x_sb, x_ss, x_sh, dt_sb, dt_ss, B_sb, B_ss, C_sb, C_ss};
  return launch(a, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 for x, B, C, gy, dx, dB and dC (f32
// arithmetic on the CUDA cores either way); dt, A, D, gstate, ddt, dA and
// dD are f32.  Strides are in elements; the last dim of x, dt, B and C is
// contiguous; gy, gstate, dx, ddt, dB and dC are contiguous; gstate [b,h,p,n]
// may be null (a zero gradient of the final state).  Scratch, with nc =
// ceil(s / 64): cum of b*h*nc*64 doubles, and work of 2*b*h*nc*p*n +
// 2*b*nc*h floats (the entering states, the leaving states' gradients, the
// partials of dA and dD).  Returns the cudaError_t of the launches (0 on
// success); nothing synchronises.
int ssd_bwd(const void* x, const float* dt, const float* A, const void* B,
            const void* C, const float* D, const void* gy,
            const float* gstate, void* dx, float* ddt, float* dA, void* dB,
            void* dC, float* dD, double* cum, float* work, int b, int s,
            int h, int p, int n, long long x_sb, long long x_ss,
            long long x_sh, long long dt_sb, long long dt_ss, long long B_sb,
            long long B_ss, long long C_sb, long long C_ss, int dtype,
            void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || p > MAX_P || n <= 0 ||
      n > MAX_N || b > 65535 || h > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, dt, A, B, C, D, gy, gstate, dx, ddt, dA, dB, dC, dD,
                      cum, work, b, s, h, p, n, x_sb, x_ss, x_sh, dt_sb,
                      dt_ss, B_sb, B_ss, C_sb, C_ss, st);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, dt, A, B, C, D, gy, gstate, dx, ddt, dA, dB,
                              dC, dD, cum, work, b, s, h, p, n, x_sb, x_ss,
                              x_sh, dt_sb, dt_ss, B_sb, B_ss, C_sb, C_ss, st);
  return cudaErrorInvalidValue;
}

const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
