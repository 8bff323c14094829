"""The CPU stand-in for ``hopper.cuh`` (``tests/torch_cuda_emu.py``) held
against ``torch.matmul``.

``WGMMA_SRC`` is a one-tile kernel written against ``hopper.cuh`` alone:
one warpgroup loads A [64, K] (through a 2-d or a 3-d tensor map) and B
by TMA into 128B/64B/32B-swizzled shared memory under an mbarrier, or
writes B itself into the same layout and fences it for the async proxy,
then runs ``wgmma`` m64nNk16 over K with A
from shared memory or from registers and B K-major ([N, K]) or MN-major
([K, N], split into column blocks at LBO), and writes D from the
accumulator fragment.  Run under the stand-in, D must equal A @ B: this
pins the stand-in's swizzle, descriptor decoding and fragment layouts to
one another.  The same source compiled by ``nvcc`` is the on-card probe of
the real instructions.  The stand-in's TMA preconditions are checked too.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_cuda_emu  # noqa: E402

WGMMA_SRC = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

struct ProbeArgs {
  hopper::TensorMap amap, bmap;
  const __nv_bfloat16* a;          // A [64, K] in global memory (register A)
  const __nv_bfloat16* b;          // B as stored (threads' loads)
  float* d;                        // D [64, N]
  int reg_a, a_3d, b_threads;
};

// The byte address a TMA load with this swizzle gives offset a.
__device__ __forceinline__ uint32_t swizzled(uint32_t a, int sw) {
  return a ^ (((a >> 7) & uint32_t(sw / 16 - 1)) << 4);
}

template <int N, int K, int TB>
__global__ void __launch_bounds__(128)
    wgmma_probe_kernel(const __grid_constant__ ProbeArgs p) {
  using namespace hopper;
  constexpr int SWA = 2 * K;
  constexpr int SWB = TB ? (2 * N < 128 ? 2 * N : 128) : 2 * K;
  constexpr int ABYTES = 64 * SWA;
  constexpr int BBYTES = 2 * N * K;
  extern __shared__ float smem[];
  const uint32_t s0 = smem_addr(smem);
  char* base = reinterpret_cast<char*>(smem) + ((1024 - (s0 & 1023)) & 1023);
  char* As = base;
  char* Bs = base + ABYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(Bs + BBYTES);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (p.b_threads) {
    // B written by the threads into the layout TMA gives, then made
    // visible to wgmma
    for (int i = tid; i < N * K; i += 128) {
      const int n = TB ? i % N : i / K, k = TB ? i / N : i % K;
      const uint32_t off =
          TB ? (n / (SWB / 2)) * K * SWB + k * SWB + (n % (SWB / 2)) * 2
             : n * SWB + k * 2;
      *reinterpret_cast<__nv_bfloat16*>(Bs + swizzled(off, SWB)) = p.b[i];
    }
    fence_proxy_async();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, ABYTES + (p.b_threads ? 0 : BBYTES));
    if (p.a_3d)
      tma_load_3d(As, &p.amap, bar, 0, 0, 0);
    else
      tma_load_2d(As, &p.amap, bar, 0, 0);
    if (p.b_threads) {
    } else if (TB == 0) {
      tma_load_2d(Bs, &p.bmap, bar, 0, 0);
    } else {
      for (int blk = 0; blk < N / (SWB / 2); ++blk)
        tma_load_2d(Bs + blk * K * SWB, &p.bmap, bar, blk * (SWB / 2), 0);
    }
  }
  mbar_wait(bar, 0);
  const int w = tid / 32, l = tid % 32;
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  uint32_t fr[K / 16][4];
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = 16 * w + l / 4 + 8 * (j % 2);
      const int k = 16 * kk + 2 * (l % 4) + 8 * (j / 2);
      fr[kk][j] = pack_bf16x2(__bfloat162float(p.a[row * K + k]),
                              __bfloat162float(p.a[row * K + k + 1]));
    }
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db =
        TB == 0 ? smem_desc(smem_addr(Bs) + 32 * kk, SWB, 0, 8 * SWB)
                : smem_desc(smem_addr(Bs) + 16 * SWB * kk, SWB, K * SWB,
                            8 * SWB);
    if (p.reg_a) {
      Wgmma<N>::template rs<TB>(d, fr[kk], db, 1);
    } else {
      const uint64_t da = smem_desc(smem_addr(As) + 32 * kk, SWA, 0, 8 * SWA);
      Wgmma<N>::template ss<TB>(d, da, db, kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int row = 16 * w + l / 4 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (l % 4) + i % 2;
    p.d[row * N + col] = d[i];
  }
}

template <int N, int K, int TB>
cudaError_t launch(const void* A, const void* B, float* D, int mode,
                   cudaStream_t stream) {
  constexpr int SWB = TB ? (2 * N < 128 ? 2 * N : 128) : 2 * K;
  ProbeArgs p;
  p.a = static_cast<const __nv_bfloat16*>(A);
  p.b = static_cast<const __nv_bfloat16*>(B);
  p.d = D;
  p.reg_a = mode & 1;
  p.a_3d = (mode >> 1) & 1;
  p.b_threads = (mode >> 2) & 1;
  // A [64, K] as a 2-d map, or as a 3-d one with a leading dim of 1
  const uint64_t adims[3] = {K, 64, 1}, astr[2] = {2 * K, 2 * K * 64};
  const uint32_t abox[3] = {K, 64, 1};
  cudaError_t err = hopper::make_tensor_map(&p.amap, A, p.a_3d ? 3 : 2,
                                            adims, astr, abox, 2 * K);
  if (err != cudaSuccess) return err;
  if (TB == 0) {      // B [N, K]
    const uint64_t dims[2] = {K, N}, str[1] = {2 * K};
    const uint32_t box[2] = {K, N};
    err = hopper::make_tensor_map(&p.bmap, B, 2, dims, str, box, SWB);
  } else {            // B [K, N]
    const uint64_t dims[2] = {N, K}, str[1] = {2 * N};
    const uint32_t box[2] = {SWB / 2, K};
    err = hopper::make_tensor_map(&p.bmap, B, 2, dims, str, box, SWB);
  }
  if (err != cudaSuccess) return err;
  const size_t smem = 1024 + 64 * 2 * K + 2 * N * K + 8;
  auto kernel = wgmma_probe_kernel<N, K, TB>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int N, int K>
cudaError_t by_major(const void* A, const void* B, float* D, int mn_major,
                     int mode, cudaStream_t s) {
  return mn_major ? launch<N, K, 1>(A, B, D, mode, s)
                  : launch<N, K, 0>(A, B, D, mode, s);
}

template <int N>
cudaError_t by_k(const void* A, const void* B, float* D, int K, int mn_major,
                 int mode, cudaStream_t s) {
  switch (K) {
    case 16: return by_major<N, 16>(A, B, D, mn_major, mode, s);
    case 32: return by_major<N, 32>(A, B, D, mn_major, mode, s);
    case 64: return by_major<N, 64>(A, B, D, mn_major, mode, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int wgmma_probe(const void* A, const void* B, float* D, int N,
                           int K, int mn_major, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return by_k<16>(A, B, D, K, mn_major, mode, s);
    case 32: return by_k<32>(A, B, D, K, mn_major, mode, s);
    case 64: return by_k<64>(A, B, D, K, mn_major, mode, s);
    case 128: return by_k<128>(A, B, D, K, mn_major, mode, s);
    default: return cudaErrorInvalidValue;
  }
}
"""

ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

# (N, K, B MN-major, mode): every swizzle width for A and for B in both
# majors (K = 16/32/64 -> 32/64/128 bytes; MN-major N = 16/32/64), N = 128
# MN-major across two column blocks (LBO); mode bits: 1 A from registers,
# 2 A through a 3-d tensor map, 4 B written by the threads (and the proxy
# fence) instead of TMA
REG_A, A_3D, B_THREADS = 1, 2, 4
CASES = [(16, 16, 0, 0), (32, 32, 0, 0), (64, 64, 0, 0), (128, 64, 0, 0),
         (16, 32, 1, 0), (32, 16, 1, 0), (64, 64, 1, 0), (128, 64, 1, 0),
         (64, 64, 0, REG_A), (128, 32, 1, REG_A), (16, 64, 1, REG_A),
         (64, 64, 0, A_3D), (64, 64, 1, B_THREADS),
         (128, 64, 1, REG_A | B_THREADS), (32, 32, 0, A_3D | B_THREADS)]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = torch_cuda_emu.build("wgmma_probe",
                               tmp_path_factory.mktemp("hopper_emu"),
                               WGMMA_SRC)
    lib.wgmma_probe.argtypes = ARGTYPES
    lib.wgmma_probe.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}-k{c[1]}-"
                         f"{'mn' if c[2] else 'k'}major-"
                         f"{'regA' if c[3] & REG_A else 'smemA'}"
                         + ("-A3d" if c[3] & A_3D else "")
                         + ("-Bthreads" if c[3] & B_THREADS else ""))
def test_stand_in_wgmma_matches_matmul(lib, case):
    N, K, mn_major, mode = case
    rng = np.random.default_rng(N * 1000 + K)
    a = torch.from_numpy(rng.standard_normal((64, K), dtype=np.float32)
                         ).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32)
                         ).to(torch.bfloat16)
    b_store = b.contiguous() if mn_major else b.T.contiguous()
    d = torch.full((64, N), float("nan"))
    err = lib.wgmma_probe(a.data_ptr(), b_store.data_ptr(), d.data_ptr(), N,
                          K, mn_major, mode, None)
    assert err == 0
    # bf16 products are exact in float32; only the summation order differs
    torch.testing.assert_close(d, a.float() @ b.float(), atol=1e-5,
                               rtol=1e-5)


def test_stand_in_refuses_a_misaligned_tensor_map(lib):
    a = torch.zeros(64 * 16 + 8, dtype=torch.bfloat16)
    b = torch.zeros(16 * 16, dtype=torch.bfloat16)
    d = torch.zeros(64, 16)
    # base 2 bytes past a 16-byte boundary: make_tensor_map refuses it
    err = lib.wgmma_probe(a.data_ptr() + 2, b.data_ptr(), d.data_ptr(), 16,
                          16, 0, 0, None)
    assert err != 0
