// Distillation-KL backward for Hopper (sm_90a), CUDA C++: the logit
// gradients of one vocabulary chunk.
//
// Replaces the backward rule of the TPU kernel's custom_vjp,
// repro/kernels/distill_kl_pallas.py::_bwd, which runs
// repro/kernels/distill_kl.py::_distill_kl_bwd (jnp outside any Pallas
// kernel).  For the vocabulary columns [v0, v0 + vc) it writes, for every
// token n and column v, with z = h W / T recomputed for the student (h_s
// [N,Ds], W_s [Ds,V]) and the teacher (h_t [N,Dt], W_t [Dt,V]),
//   dz_s = (exp(z_s - lse_s) - p_t) w_n,
//   dz_t = p_t ((z_t - e_t) - (z_s - e_s)) w_n,     p_t = exp(z_t - lse_t),
// from the forward's statistics (csrc/distill_kl_fwd.cu) and the token
// weight w_n = mask_n / max(sum mask, 1) g / T, which the wrapper forms.
// Each element of the [N, ldz] chunk buffers is written once: no atomics,
// no sum across blocks, so two calls give the same bits.  Either side may
// be left out (a null buffer); both products are recomputed either way,
// since each side's gradient reads both.  The two products that follow
// over each chunk, dh += dz W^T and dW = h^T dz, are cuBLAS calls in the
// wrapper (repro_torch/kernels/distill_kl.py), as the JAX package leaves
// them to XLA.  The plain version is
// repro_torch/kernels/ref.py::distill_kl_bwd_ref.
//
// What bounds it on an H100: at the main-path shape (N = 8192 tokens,
// Ds = Dt = 1024, V = 151936, bf16) the recompute is the forward's two
// products, 2 N V (Ds + Dt) = 5.10 TFLOP, against the inputs read once
// and 2.49 GB of bf16 dz_s written: arithmetic, 5.16 ms at the bf16
// tensor-core peak (the writes alone take 0.74 ms at 3.35 TB/s).  The
// design is the forward's tile loop with another epilogue:
// bf16 -> distill_kl_dz_kernel_tc, on the tensor cores (hopper.cuh):
//   * a block owns 128 tokens (two consumer warpgroups of 64) and walks a
//     range of the chunk's 128-column vocabulary tiles (grid.y splits the
//     chunk's tiles so that about eight blocks a SM are launched); per tile
//     a K-loop over D in 64-deep slabs, the student's product and then the
//     teacher's;
//   * one producer warp keeps a ring of four stages full by TMA (128B
//     swizzle): per slab the h slab [128 x 64] and the W slab [64 x 128],
//     W [D,V] row-major as MN-major (two 64-column boxes, the transpose
//     bit), embed.T as K-major, so a tied embedding is never copied;
//   * each slab is four wgmma m64n128k16 into f32 registers, z_s and z_t
//     side by side (2 x 64 registers a thread);
//   * the epilogue reads the thread's two tokens' statistics once a block,
//     forms both gradients in f32 (exp as exp2 of x log2 e), rounds them
//     to bf16 and writes each pair of neighbouring columns as one 32-bit
//     store; the forward's split-and-merge is gone, because nothing is
//     summed over the vocabulary.
//   At the main-path shape its five chunks take 11.84 ms and the products
//   6.84 ms, 19.26 ms in all against the bound's 10.31 (H100 80GB HBM3 at
//   700 W, chip_smoke.py).
// f32 -> distill_kl_dz_kernel, f32 FMAs on the CUDA cores, for the f32
// checks (TF32 would break their tolerances): the forward's CUDA-core tile
// product (64 tokens x 64 columns, 32-deep chunks of h and W staged
// through shared memory, a 4 x 4 block of z a thread) with dz kept in f32.
// Ragged N, D and V are masked here (the bf16 path reads zeros past the
// ends through TMA; columns at or past vc and tokens at or past N are not
// written); the kernels have no fallback.

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

// The statistics and weights of the chunk, shared by both paths.
struct Stats {
  const float* lse_s;
  const float* lse_t;
  const float* e_t;
  const float* e_s;
  const float* tok_w;             // w_n = mask_n / max(sum mask, 1) g / T
};

struct Args {
  const float* hs;
  const float* ws;
  const float* ht;
  const float* wt;
  Stats st;
  float* dzs;                     // [N][ldz] or null
  float* dzt;
  int N, Ds, Dt, v0, vc, ldz, tiles_per_split;
  long long hs_sn, ws_sd, ws_sv;
  long long ht_sn, wt_sd, wt_sv;
  float inv_temp;
};

// The two gradients of one (token, column) from its logits.
struct Grad {
  float s, t;
};

__device__ __forceinline__ Grad grads(float zs, float zt, float lse_s,
                                      float lse_t, float e_t, float e_s,
                                      float wn) {
  const float pt = expf(zt - lse_t);
  return {(expf(zs - lse_s) - pt) * wn, pt * ((zt - e_t) - (zs - e_s)) * wn};
}

// z[i][j] = sum_d h[t0 + ty + i*TY, d] W[d, v0 + tx + j*TX] over d < D, with
// h and W staged through shared memory KC dims at a time (zero outside N,
// D and the chunk's last column v_end).
__device__ __forceinline__ void tile_product(
    const float* h, long long h_sn, const float* w, long long w_sd,
    long long w_sv, int t0, int N, int D, int v0, int v_end, float* Hs,
    float* Ws, float (&z)[RPT][CPT]) {
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
      Hs[r * HSTRIDE + d] = (t < N && dd < D) ? h[t * h_sn + dd] : 0.f;
    }
    if (w_sv == 1) {   // [D, V] row-major: columns are contiguous
      for (int i = tid; i < KC * BV; i += NTHREADS) {
        const int d = i / BV, c = i % BV;
        const int dd = d0 + d, v = v0 + c;
        Ws[d * WSTRIDE + c] =
            (dd < D && v < v_end) ? w[dd * w_sd + v * w_sv] : 0.f;
      }
    } else {           // e.g. embed.T: the hidden dims are contiguous
      for (int i = tid; i < KC * BV; i += NTHREADS) {
        const int c = i / KC, d = i % KC;
        const int dd = d0 + d, v = v0 + c;
        Ws[d * WSTRIDE + c] =
            (dd < D && v < v_end) ? w[dd * w_sd + v * w_sv] : 0.f;
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

__global__ void __launch_bounds__(NTHREADS)
    distill_kl_dz_kernel(const Args a) {
  extern __shared__ float smem[];
  float* Hs = smem;                       // [BT][HSTRIDE]
  float* Ws = smem + BT * HSTRIDE;        // [KC][WSTRIDE]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int t0 = blockIdx.x * BT;
  const int ntiles = (a.vc + BV - 1) / BV;
  const int tile_lo = blockIdx.y * a.tiles_per_split;
  const int tile_hi = min(ntiles, tile_lo + a.tiles_per_split);
  const int v_end = a.v0 + a.vc;

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int c0 = tile * BV;             // the tile's first chunk column
    float zs[RPT][CPT], zt[RPT][CPT];
    tile_product(a.hs, a.hs_sn, a.ws, a.ws_sd, a.ws_sv, t0, a.N, a.Ds,
                 a.v0 + c0, v_end, Hs, Ws, zs);
    tile_product(a.ht, a.ht_sn, a.wt, a.wt_sd, a.wt_sv, t0, a.N, a.Dt,
                 a.v0 + c0, v_end, Hs, Ws, zt);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = t0 + ty + i * TY;
      if (t >= a.N) continue;
      const float ls = a.st.lse_s[t], lt = a.st.lse_t[t], et = a.st.e_t[t],
                  es = a.st.e_s[t], wn = a.st.tok_w[t];
      const long long row = static_cast<long long>(t) * a.ldz;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = c0 + tx + j * TX;
        if (c >= a.vc) continue;
        const Grad g = grads(zs[i][j] * a.inv_temp, zt[i][j] * a.inv_temp,
                             ls, lt, et, es, wn);
        if (a.dzs != nullptr) a.dzs[row + c] = g.s;
        if (a.dzt != nullptr) a.dzt[row + c] = g.t;
      }
    }
  }
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (BT * HSTRIDE + KC * WSTRIDE);
  cudaError_t err = cudaFuncSetAttribute(
      distill_kl_dz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (a.vc + BV - 1) / BV;
  const dim3 grid((a.N + BT - 1) / BT,
                  (ntiles + a.tiles_per_split - 1) / a.tiles_per_split);
  distill_kl_dz_kernel<<<grid, NTHREADS, smem, stream>>>(a);
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
  Stats st;
  __nv_bfloat16* dzs;                 // [N][ldz] or null
  __nv_bfloat16* dzt;
  int N, Ds, Dt, v0, vc, ldz, tiles_per_split;
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

// One of a thread's two tokens: its statistics, log2 e times the lse's,
// and whether it lies inside N.
struct Row {
  float ls2, lt2, et, es, wn;
  long long off;                      // the token's first element in dz
  bool in;
};

// Writes two neighbouring columns (c, c + 1) of one token, or only c where
// c + 1 is past the chunk; c is even and ldz is even, so a pair is one
// aligned 32-bit word.
__device__ __forceinline__ void store2(__nv_bfloat16* dz, long long off,
                                       int c, int vc, float x0, float x1) {
  if (c + 1 < vc)
    *reinterpret_cast<uint32_t*>(dz + off + c) = hopper::pack_bf16x2(x0, x1);
  else if (c < vc)
    dz[off + c] = __float2bfloat16(x0);
}

// dz of this thread's elements of one 128-column tile from its logits;
// the accumulator's register i holds row 16 w + l / 4 + 8 ((i / 2) % 2)
// and column 8 (i / 4) + 2 (l % 4) + i % 2 of the warpgroup's 64 x 128.
__device__ __forceinline__ void epilogue(const Args& a, float (&zs)[BV / 2],
                                         float (&zt)[BV / 2],
                                         const Row (&rows)[2], int c0) {
  const int l = threadIdx.x % 32;
  const float k = a.inv_temp * LOG2E;   // z log2 e
#pragma unroll
  for (int i = 0; i < BV / 2; i += 2) {
    const Row& r = rows[(i / 2) % 2];
    const int c = c0 + 8 * (i / 4) + 2 * (l % 4);
    if (!r.in || c >= a.vc) continue;
    float gs[2], gt[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float zs2 = zs[i + e] * k, zt2 = zt[i + e] * k;
      const float pt = exp2f(zt2 - r.lt2);
      gs[e] = (exp2f(zs2 - r.ls2) - pt) * r.wn;
      // (z_t - e_t) - (z_s - e_s) in the logits' own units
      gt[e] = pt * ((zt[i + e] * a.inv_temp - r.et) -
                    (zs[i + e] * a.inv_temp - r.es)) * r.wn;
    }
    if (a.dzs != nullptr) store2(a.dzs, r.off, c, a.vc, gs[0], gs[1]);
    if (a.dzt != nullptr) store2(a.dzt, r.off, c, a.vc, gt[0], gt[1]);
  }
}

// TBS, TBT: W_s, W_t MN-major ([D,V] row-major) = 1, K-major (embed.T) = 0.
template <int TBS, int TBT>
__global__ void __launch_bounds__(NTHREADS, 1)
    distill_kl_dz_kernel_tc(const __grid_constant__ Args a) {
  using namespace hopper;
  extern __shared__ float smem[];
  const uint32_t s0 = smem_addr(smem);
  char* base = reinterpret_cast<char*>(smem) + ((1024 - (s0 & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BT;
  const int ntiles = (a.vc + BV - 1) / BV;
  const int tile_lo = blockIdx.y * a.tiles_per_split;
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
        const int v = a.v0 + tile * BV;
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
              tma_load_2d(sb + H_BYTES, wm, &full[st], v, j * BK);
              tma_load_2d(sb + H_BYTES + W_BYTES / 2, wm, &full[st], v + 64,
                          j * BK);
            } else {
              tma_load_2d(sb + H_BYTES, wm, &full[st], j * BK, v);
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
    Row rows[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + g * 64 + 16 * w + l / 4 + 8 * r;
      rows[r].in = t < a.N;
      const int tt = rows[r].in ? t : 0;
      rows[r].ls2 = a.st.lse_s[tt] * LOG2E;
      rows[r].lt2 = a.st.lse_t[tt] * LOG2E;
      rows[r].et = a.st.e_t[tt];
      rows[r].es = a.st.e_s[tt];
      rows[r].wn = a.st.tok_w[tt];
      rows[r].off = static_cast<long long>(tt) * a.ldz;
    }
    int it = 0;
    for (int tile = tile_lo; tile < tile_hi; ++tile) {
      float zs[BV / 2], zt[BV / 2];
      product<TBS>(zs, nks, it, base, full, empty, g);
      product<TBT>(zt, nkt, it, base, full, empty, g);
      epilogue(a, zs, zt, rows, tile * BV);
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

// W [D,V] through its strides, the whole vocabulary (a chunk is a range of
// its columns): MN-major (v contiguous) -> *mn = 1, two 64 x 64 boxes a
// slab; K-major (d contiguous, embed.T) -> *mn = 0, one 64 x 128 box.
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
cudaError_t launch_tiles(const Args& a, cudaStream_t stream) {
  auto kernel = distill_kl_dz_kernel_tc<TBS, TBT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const int ntiles = (a.vc + BV - 1) / BV;
  const dim3 grid((a.N + BT - 1) / BT,
                  (ntiles + a.tiles_per_split - 1) / a.tiles_per_split);
  kernel<<<grid, NTHREADS, SMEM, stream>>>(a);
  return cudaGetLastError();
}

inline cudaError_t launch(const void* hs, const void* ws, const void* ht,
                          const void* wt, const Stats& st, void* dzs,
                          void* dzt, int N, int Ds, int Dt, int V, int v0,
                          int vc, int ldz, int tiles_per_split,
                          long long hs_sn, long long ws_sd, long long ws_sv,
                          long long ht_sn, long long wt_sd, long long wt_sv,
                          float inv_temp, cudaStream_t stream) {
  Args a;
  a.st = st;
  a.dzs = static_cast<__nv_bfloat16*>(dzs);
  a.dzt = static_cast<__nv_bfloat16*>(dzt);
  a.N = N;
  a.Ds = Ds;
  a.Dt = Dt;
  a.v0 = v0;
  a.vc = vc;
  a.ldz = ldz;
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
  if (mn_s && mn_t) return launch_tiles<1, 1>(a, stream);
  if (mn_s) return launch_tiles<1, 0>(a, stream);
  if (mn_t) return launch_tiles<0, 1>(a, stream);
  return launch_tiles<0, 0>(a, stream);
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32 (distill_kl_dz_kernel, 64 x 64 tiles, dz in f32), 1 =
// bfloat16 (distill_kl_dz_kernel_tc, 128 x 128 tiles, dz rounded to bf16,
// inputs read through TMA: 16-byte-aligned bases, strides in 16-byte
// multiples, one of W's strides 1; checked by the Python wrapper).  W is
// the whole [D, V] through its strides (in elements); h must be contiguous
// along its hidden dim.  lse_s, lse_t, e_t, e_s and tok_w are f32 [N].  dzs
// and dzt (either may be null, not both) are [N][ldz] in the inputs' dtype;
// column c of the chunk is vocabulary column v0 + c, c < vc, and columns at
// or past vc are not written.  The chunk's vocabulary tiles are split into
// blocks of tiles_per_split.  Returns the cudaError_t of the launch (0 on
// success); nothing synchronises.
int distill_kl_bwd(const void* hs, const void* ws, const void* ht,
                   const void* wt, const float* lse_s, const float* lse_t,
                   const float* e_t, const float* e_s, const float* tok_w,
                   void* dzs, void* dzt, int N, int Ds, int Dt, int V, int v0,
                   int vc, int ldz, int tiles_per_split, long long hs_sn,
                   long long ws_sd, long long ws_sv, long long ht_sn,
                   long long wt_sd, long long wt_sv, float inv_temp,
                   int dtype, void* stream) {
  if (N <= 0 || Ds <= 0 || Dt <= 0 || V <= 0 || v0 < 0 || vc <= 0 ||
      v0 + static_cast<long long>(vc) > V || ldz < vc ||
      tiles_per_split <= 0 || (dtype != 0 && dtype != 1) ||
      (dzs == nullptr && dzt == nullptr) || (dtype == 1 && ldz % 2 != 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Stats st{lse_s, lse_t, e_t, e_s, tok_w};
  if (dtype == 0) {
    Args a{static_cast<const float*>(hs), static_cast<const float*>(ws),
           static_cast<const float*>(ht), static_cast<const float*>(wt),
           st, static_cast<float*>(dzs), static_cast<float*>(dzt),
           N, Ds, Dt, v0, vc, ldz, tiles_per_split,
           hs_sn, ws_sd, ws_sv, ht_sn, wt_sd, wt_sv, inv_temp};
    return launch(a, s);
  }
  return tc::launch(hs, ws, ht, wt, st, dzs, dzt, N, Ds, Dt, V, v0, vc, ldz,
                    tiles_per_split, hs_sn, ws_sd, ws_sv, ht_sn, wt_sd,
                    wt_sv, inv_temp, s);
}

const char* distill_kl_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
