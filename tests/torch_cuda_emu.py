"""Run a CUDA kernel source of the port on the CPU, for the tests.

A source under ``src/repro_torch/kernels/csrc/`` is compiled with ``g++``
against the stand-in CUDA headers below and loaded with ctypes; the tests
then call its C entry point with CPU tensors and hold the result against
the kernel's plain version.  This checks a kernel's indexing, masking,
tiling, reductions and pipeline phases on every CPU run; the build, the
launch, the fragment layouts on the real tensor cores and the speed on the
card are ``chip_smoke.py``'s.

Two rewrites make a source compile here: its ``extern __shared__``
declaration becomes a pointer to ``g_smem``, and each ``<<<grid, threads,
smem, stream>>>(args)`` launch becomes ``emu_launch(...)``, a loop over
the blocks.  ``hopper.cuh`` (the Hopper primitives: mbarriers, TMA,
wgmma) is replaced by ``HOPPER_CUH`` below, which keeps its interface.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc"
SHARED = ("extern __shared__ float smem[];", "float* smem = g_smem;")
LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*\w+>>>"
                    r"\((\w+)\);")

CUDA_RUNTIME_H = r"""// CPU stand-in for the parts of the CUDA runtime that the port's kernels
// use, so that a kernel source can be compiled with g++ and run on the
// CPU.  Each block runs as one std::thread per CUDA thread, and blocks run
// one after another.  __syncthreads is a std::barrier over the block.  A
// warp shuffle exchanges values through an array between two barriers of
// its warp, which holds while all 32 lanes of the warp reach it (true of
// shuffles in warp-uniform control flow); __syncwarp is that barrier.  The
// state of the Hopper stand-ins (mbarriers, warpgroup rendezvous) lives
// here too and is reset for every block.  The test rewrites the kernel's
// `extern __shared__` declaration and its `<<<...>>>` launch into
// `g_smem` and `emu_launch`.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <climits>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaErrorEmulatedFault = 999
};

struct alignas(16) uint4 {
  unsigned x, y, z, w;
};

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim;
inline std::barrier<>* g_bar = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> g_warp_bar;
inline std::vector<std::unique_ptr<std::barrier<>>> g_group_bar;
inline uint32_t g_shfl[1024];
// the shared window: 1024-aligned, as the swizzle reads its address bits
alignas(1024) inline float g_smem[1 << 16];

// A fault the card would turn into a failed launch or a hang (a TMA
// destination off its alignment, a barrier wait that never ends): noted
// here, and emu_launch returns cudaErrorEmulatedFault.
inline std::atomic<int> g_fault{0};
inline void emu_fault(const char* what) {
  if (g_fault.exchange(1) == 0)
    std::fprintf(stderr, "emulated fault: %s\n", what);
}

struct EmuMbar {
  uint32_t expected = 0, pending = 0, phase = 0;
  long long tx = 0;
};
inline std::mutex g_mbar_mu;
inline std::condition_variable g_mbar_cv;
inline std::map<const void*, EmuMbar> g_mbar;

inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  g_warp_bar[threadIdx.x / 32]->arrive_and_wait();
}

template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  std::memcpy(&g_shfl[threadIdx.x], &v, 4);
  __syncwarp();
  T r;
  std::memcpy(&r, &g_shfl[threadIdx.x ^ lane_mask], 4);
  __syncwarp();
  return r;
}

template <typename T>
inline T __shfl_sync(unsigned, T v, int src_lane) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  std::memcpy(&g_shfl[threadIdx.x], &v, 4);
  __syncwarp();
  T r;
  std::memcpy(&r, &g_shfl[threadIdx.x / 32 * 32 + src_lane % 32], 4);
  __syncwarp();
  return r;
}

template <typename T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  std::memcpy(&g_shfl[threadIdx.x], &v, 4);
  __syncwarp();
  T r = v;
  if (threadIdx.x % 32 >= delta)
    std::memcpy(&r, &g_shfl[threadIdx.x - delta], 4);
  __syncwarp();
  return r;
}

template <typename K>
cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

template <typename K, typename A>
cudaError_t emu_launch(K kernel, dim3 grid, int nthreads, size_t smem_bytes,
                       const A& args) {
  if (smem_bytes > sizeof(g_smem) || nthreads > 1024)
    return cudaErrorInvalidValue;
  gridDim = grid;
  g_fault = 0;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::barrier<> bar(nthreads);
        g_bar = &bar;
        g_warp_bar.clear();
        for (int w = 0; w * 32 < nthreads; ++w)
          g_warp_bar.emplace_back(
              std::make_unique<std::barrier<>>(min(32, nthreads - 32 * w)));
        g_group_bar.clear();
        for (int g = 0; (g + 1) * 128 <= nthreads; ++g)
          g_group_bar.emplace_back(std::make_unique<std::barrier<>>(128));
        g_mbar.clear();
        // NaN-fill, so a read of shared memory no thread wrote shows up
        std::fill(std::begin(g_smem), std::end(g_smem), NAN);
        std::vector<std::thread> threads;
        for (int t = 0; t < nthreads; ++t)
          threads.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(x, y, z);
            kernel(args);
          });
        for (auto& th : threads) th.join();
      }
  return g_fault ? cudaErrorEmulatedFault : cudaSuccess;
}
"""

CUDA_BF16_H = r"""// CPU stand-in for cuda_bf16.h: bfloat16 as its 16 bits, with the two
// conversions the port's kernels use (round to nearest even, as on the card).
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t x;
};

inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = uint32_t(h.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{uint16_t(u >> 16)};
}
"""



HOPPER_CUH = r"""// CPU stand-in for src/repro_torch/kernels/csrc/hopper.cuh, with the same
// interface.  It synchronises only the threads the hardware does:
//   * an mbarrier is a phase counter (pending arrivals, expected bytes)
//     under one mutex and condition variable; mbar_wait blocks until the
//     phase of the given parity has completed;
//   * a TMA load runs in the issuing thread: it copies the box element by
//     element, fills elements outside the tensor with zeros, stores each at
//     its swizzled address (16-byte chunk bits 4.. XOR address bits 7..),
//     and then completes its bytes on the mbarrier;
//   * a wgmma is a rendezvous of the 128 threads of one warpgroup: each
//     thread posts its A fragment (register A), all meet, each computes its
//     own accumulator registers from the descriptors (undoing the same
//     swizzle) with PTX's fragment layouts, and all meet again.  The
//     products are exact in f32 and summed over k in order; fence, commit
//     and wait are no-ops, as the result exists once the call returns;
//   * the proxy fence is a no-op: the CPU has one view of memory;
//   * setmaxnreg is a no-op: registers are not modelled.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define __grid_constant__

namespace hopper {

struct alignas(64) TensorMap {
  const uint8_t* base;
  int rank, swizzle;
  uint64_t dims[5], strides[5];     // strides[i]: bytes of dims[i + 1]
  uint32_t box[5];
};

// The driver's preconditions for a tiled bf16 map, as far as they concern
// the port: a 16-byte-aligned base, strides in 16-byte multiples below
// 2^40, dims in [1, 2^32], boxes of 1..256 elements whose inner extent is
// one row of the swizzle.
inline cudaError_t make_tensor_map(TensorMap* map, const void* base, int rank,
                                   const uint64_t* dims,
                                   const uint64_t* strides,
                                   const uint32_t* box, int swizzle) {
  if (rank < 1 || rank > 5 || reinterpret_cast<uintptr_t>(base) % 16 ||
      (swizzle != 32 && swizzle != 64 && swizzle != 128) ||
      box[0] * 2 != uint32_t(swizzle))
    return cudaErrorInvalidValue;
  map->base = static_cast<const uint8_t*>(base);
  map->rank = rank;
  map->swizzle = swizzle;
  for (int i = 0; i < rank; ++i) {
    if (dims[i] < 1 || dims[i] > (1ull << 32) || box[i] < 1 || box[i] > 256)
      return cudaErrorInvalidValue;
    if (i + 1 < rank && (strides[i] % 16 || strides[i] >= (1ull << 40)))
      return cudaErrorInvalidValue;
    map->dims[i] = dims[i];
    map->box[i] = box[i];
    map->strides[i] = i + 1 < rank ? strides[i] : 0;
  }
  return cudaSuccess;
}

inline uint32_t smem_addr(const void* p) {
  return uint32_t(static_cast<const char*>(p) -
                  reinterpret_cast<const char*>(g_smem));
}

inline uint32_t swizzle_addr(uint32_t a, int swizzle) {
  return a ^ (((a >> 7) & uint32_t(swizzle / 16 - 1)) << 4);
}

inline void mbar_init(uint64_t* bar, uint32_t count) {
  std::lock_guard<std::mutex> lk(g_mbar_mu);
  EmuMbar& m = g_mbar[bar];
  m.expected = m.pending = count;
  m.phase = 0;
  m.tx = 0;
}

inline void fence_barrier_init() {}

// caller holds g_mbar_mu
inline void mbar_update(const void* bar, int arrivals, long long tx) {
  auto it = g_mbar.find(bar);
  if (it == g_mbar.end()) return emu_fault("mbarrier used before its init");
  EmuMbar& m = it->second;
  if (arrivals > int(m.pending))
    return emu_fault("more arrivals than the mbarrier expects");
  m.pending -= arrivals;
  m.tx += tx;
  if (m.pending == 0 && m.tx == 0) {
    m.phase ^= 1;
    m.pending = m.expected;
    g_mbar_cv.notify_all();
  }
}

inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> lk(g_mbar_mu);
  mbar_update(bar, 1, 0);
}

inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lk(g_mbar_mu);
  mbar_update(bar, 1, bytes);
}

inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  std::unique_lock<std::mutex> lk(g_mbar_mu);
  auto done = [&] {
    auto it = g_mbar.find(bar);
    return it == g_mbar.end() || it->second.phase != parity;
  };
  if (!g_mbar_cv.wait_for(lk, std::chrono::seconds(30), done))
    emu_fault("an mbarrier wait that never ends");
  if (g_mbar.find(bar) == g_mbar.end())
    emu_fault("mbarrier waited on before its init");
}

inline void tma_load(void* dst, const TensorMap* m, uint64_t* bar,
                     const int* c) {
  const uint32_t base = smem_addr(dst);
  if (base % 1024) return emu_fault("TMA destination not 1024-aligned");
  size_t n = 1;
  for (int r = 0; r < m->rank; ++r) n *= m->box[r];
  if (base + 2 * n > sizeof(g_smem))
    return emu_fault("TMA destination outside shared memory");
  char* smem = reinterpret_cast<char*>(g_smem);
  for (size_t idx = 0; idx < n; ++idx) {
    size_t rest = idx;
    uint64_t off = 0;
    bool in = true;
    for (int r = 0; r < m->rank; ++r) {
      const long long coord = c[r] + (long long)(rest % m->box[r]);
      rest /= m->box[r];
      if (coord < 0 || coord >= (long long)m->dims[r]) in = false;
      else off += uint64_t(coord) * (r == 0 ? 2 : m->strides[r - 1]);
    }
    uint16_t v = 0;
    if (in) std::memcpy(&v, m->base + off, 2);
    std::memcpy(smem + swizzle_addr(base + 2 * uint32_t(idx), m->swizzle),
                &v, 2);
  }
  std::lock_guard<std::mutex> lk(g_mbar_mu);
  mbar_update(bar, 0, -(long long)(2 * n));
}

inline void tma_load_2d(void* dst, const TensorMap* map, uint64_t* bar,
                        int c0, int c1) {
  const int c[2] = {c0, c1};
  tma_load(dst, map, bar, c);
}

inline void tma_load_3d(void* dst, const TensorMap* map, uint64_t* bar,
                        int c0, int c1, int c2) {
  const int c[3] = {c0, c1, c2};
  tma_load(dst, map, bar, c);
}

inline void tma_load_4d(void* dst, const TensorMap* map, uint64_t* bar,
                        int c0, int c1, int c2, int c3) {
  const int c[4] = {c0, c1, c2, c3};
  tma_load(dst, map, bar, c);
}

inline uint64_t smem_desc(uint32_t addr, int swizzle, uint32_t lbo,
                          uint32_t sbo) {
  const uint64_t mode = swizzle == 128 ? 1 : swizzle == 64 ? 2 : 3;
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

inline void fence_proxy_async() {}

template <int R>
inline void setmaxnreg_dec() {}
template <int R>
inline void setmaxnreg_inc() {}

inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N>
inline void wgmma_wait() {}
template <int R>
inline void fence_regs(float (&)[R]) {}
template <int R>
inline void fence_regs(uint32_t (&)[R]) {}
template <int R, int C>
inline void fence_regs(uint32_t (&)[R][C]) {}

inline uint32_t pack_bf16x2(float lo, float hi) {
  return uint32_t(__float2bfloat16(lo).x) |
         (uint32_t(__float2bfloat16(hi).x) << 16);
}

inline float bf16_at(uint32_t addr) {
  if (addr + 2 > sizeof(g_smem)) {
    emu_fault("wgmma operand outside shared memory");
    return 0.f;
  }
  __nv_bfloat16 h;
  std::memcpy(&h.x, reinterpret_cast<const char*>(g_smem) + addr, 2);
  return __bfloat162float(h);
}

// Element (mn, k) of a shared-memory operand: K-major rows of `swizzle`
// bytes in groups of 8 at SBO; MN-major column blocks of swizzle / 2
// elements at LBO, K rows of `swizzle` bytes in groups of 8 at SBO.
inline float operand_at(uint64_t desc, int mn, int k, bool mn_major) {
  const uint32_t start = uint32_t(desc & 0x3FFF) << 4;
  const uint32_t lbo = uint32_t((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = uint32_t((desc >> 32) & 0x3FFF) << 4;
  const int mode = int(desc >> 62);
  const int sw = mode == 1 ? 128 : mode == 2 ? 64 : mode == 3 ? 32 : 0;
  if (sw == 0) {
    emu_fault("wgmma descriptor without a swizzle mode");
    return 0.f;
  }
  const int per = sw / 2;
  const uint32_t a =
      mn_major ? start + uint32_t(mn / per) * lbo + uint32_t(mn % per) * 2 +
                     uint32_t(k / 8) * sbo + uint32_t(k % 8) * sw
               : start + uint32_t(mn / 8) * sbo + uint32_t(mn % 8) * sw +
                     uint32_t(k) * 2;
  return bf16_at(swizzle_addr(a, sw));
}

inline uint32_t g_afrag[8][128][4];

template <int N>
inline void emu_wgmma(float* d, const uint32_t* afrag, uint64_t da,
                      uint64_t db, int accumulate, int trans_b) {
  const int t = int(threadIdx.x), wg = t / 128, r = t % 128;
  if (wg >= int(g_group_bar.size()))
    return emu_fault("wgmma outside a warpgroup");
  if (afrag != nullptr) std::memcpy(g_afrag[wg][r], afrag, 16);
  g_group_bar[wg]->arrive_and_wait();
  const int w = r / 32, l = r % 32;
  float a[2][16];
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * w + l / 4 + 8 * h;
    for (int k = 0; k < 16; ++k) {
      if (afrag == nullptr) {
        a[h][k] = operand_at(da, row, k, false);
      } else {
        // register A: the lane and register holding (row, k)
        const int rr = row % 16;
        const int lane = (rr % 8) * 4 + (k % 8) / 2;
        const int reg = rr / 8 + 2 * (k / 8);
        const uint32_t word = g_afrag[wg][32 * (row / 16) + lane][reg];
        __nv_bfloat16 v{uint16_t(k % 2 ? word >> 16 : word & 0xFFFF)};
        a[h][k] = __bfloat162float(v);
      }
    }
  }
  for (int i = 0; i < N / 2; ++i) {
    const int h = (i / 2) % 2;
    const int col = 8 * (i / 4) + 2 * (l % 4) + i % 2;
    float s = 0.f;
    for (int k = 0; k < 16; ++k)
      s += a[h][k] * operand_at(db, col, k, trans_b != 0);
    d[i] = accumulate ? d[i] + s : s;
  }
  g_group_bar[wg]->arrive_and_wait();
}

template <int N>
struct Wgmma {
  template <int TRANS_B>
  static void ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                 int accumulate) {
    emu_wgmma<N>(d, nullptr, desc_a, desc_b, accumulate, TRANS_B);
  }
  template <int TRANS_B>
  static void rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b,
                 int accumulate) {
    emu_wgmma<N>(d, a, 0, desc_b, accumulate, TRANS_B);
  }
};

}  // namespace hopper
"""


def emulated_source(name: str, src: str | None = None) -> str:
    """``csrc/<name>.cu`` (or the source text given) with its shared memory
    and launches rewritten."""
    if src is None:
        src = (CSRC / f"{name}.cu").read_text()
    assert src.count(SHARED[0]) >= 1, \
        f"{name}.cu no longer declares {SHARED[0]!r}"
    src = src.replace(*SHARED)
    src, n = LAUNCH.subn(r"emu_launch(\1, \2, \3, \4, \5);", src)
    assert n >= 1, f"{name}.cu has no <<<grid, threads, smem, stream>>> launch"
    return src


def build(name: str, out: Path, src: str | None = None) -> ctypes.CDLL:
    """Compile the emulated ``csrc/<name>.cu`` (or the source text given)
    into ``out`` and load it (the test skips where there is no g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel source for the CPU")
    (out / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (out / "cuda_bf16.h").write_text(CUDA_BF16_H)
    (out / "hopper.cuh").write_text(HOPPER_CUH)
    cpp = out / f"{name}_emu.cpp"
    cpp.write_text(emulated_source(name, src))
    so = out / f"lib{name}_emu.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
         f"-I{out}", "-Wno-unknown-pragmas", "-o", str(so), str(cpp)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))
