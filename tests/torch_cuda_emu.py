"""Run a CUDA kernel source of the port on the CPU, for the tests.

A source under ``src/repro_torch/kernels/csrc/`` is compiled with ``g++``
against the stand-in CUDA headers below and loaded with ctypes; the tests
then call its C entry point with CPU tensors and hold the result against
the kernel's plain version.  This checks a kernel's indexing, masking,
tiling and reductions on every CPU run; the build, the launch and the
speed on the card are ``chip_smoke.py``'s.

Two rewrites make a source compile here: its ``extern __shared__``
declaration becomes a pointer to ``g_smem``, and each ``<<<grid, threads,
smem, stream>>>(args)`` launch becomes ``emu_launch(...)``, a loop over
the blocks.
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
// CPU.  Each block runs as one
// std::thread per CUDA thread; __syncthreads is a std::barrier over the
// block, and a warp shuffle exchanges values through an array between two
// barriers, which holds while every thread of the block reaches every
// shuffle (true of kernels whose shuffles sit in block-uniform control
// flow).  Blocks run one after another.  The test rewrites the kernel's
// `extern __shared__` declaration and its `<<<...>>>` launch into
// `g_smem` and `emu_launch`.
#pragma once
#include <algorithm>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim;
inline std::barrier<>* g_bar = nullptr;
inline float g_shfl[1024];
alignas(16) inline float g_smem[1 << 16];

inline void __syncthreads() { g_bar->arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  g_shfl[threadIdx.x] = v;
  __syncthreads();
  const float r = g_shfl[threadIdx.x ^ lane_mask];
  __syncthreads();
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
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::barrier<> bar(nthreads);
        g_bar = &bar;
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
  return cudaSuccess;
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



def emulated_source(name: str) -> str:
    """``csrc/<name>.cu`` with its shared memory and launches rewritten."""
    src = (CSRC / f"{name}.cu").read_text()
    assert src.count(SHARED[0]) >= 1, \
        f"{name}.cu no longer declares {SHARED[0]!r}"
    src = src.replace(*SHARED)
    src, n = LAUNCH.subn(r"emu_launch(\1, \2, \3, \4, \5);", src)
    assert n >= 1, f"{name}.cu has no <<<grid, threads, smem, stream>>> launch"
    return src


def build(name: str, out: Path) -> ctypes.CDLL:
    """Compile the emulated ``csrc/<name>.cu`` into ``out`` and load it
    (the test skips where there is no g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel source for the CPU")
    (out / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (out / "cuda_bf16.h").write_text(CUDA_BF16_H)
    cpp = out / f"{name}_emu.cpp"
    cpp.write_text(emulated_source(name))
    so = out / f"lib{name}_emu.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
         f"-I{out}", "-Wno-unknown-pragmas", "-o", str(so), str(cpp)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))
