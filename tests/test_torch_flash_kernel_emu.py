"""The CUDA flash kernel's source, run on the CPU.

``src/repro_torch/kernels/csrc/flash_fwd.cu`` is compiled with ``g++``
against the stand-in CUDA headers below (one ``std::thread`` per CUDA
thread, ``__syncthreads`` as a barrier), loaded with ctypes and
called with CPU tensors through the wrapper's own C signature.  Its output
is held against the plain version, ``flash_attention_ref``, with the card's
tolerances.  This checks the kernel's indexing, masking, tile skipping and
online softmax on every CPU run; the build, the launch and the speed on
the card are ``chip_smoke.py``'s.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_ref,  # noqa: E402
                                     visible_mask)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_fwd.cu"
REWRITES = [
    ("extern __shared__ float smem[];", "float* smem = g_smem;"),
    ("kernel<<<grid, NTHREADS, smem, stream>>>(a);",
     "emu_launch(kernel, grid, NTHREADS, smem, a);"),
]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

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

CASES = [
    # (B, S, T, H, KV, D), dtype, causal, window, q_offset, positions
    ((1, 128, 128, 4, 2, 16), torch.float32, True, 0, 0, None),
    ((1, 128, 64, 4, 1, 16), torch.float32, True, 32, 0, None),   # hidden rows
    ((1, 64, 64, 6, 3, 8), torch.bfloat16, False, 0, 0, None),
    ((1, 70, 130, 2, 2, 128), torch.bfloat16, True, 0, 0, None),  # ragged
    ((1, 200, 200, 2, 1, 64), torch.float32, True, 32, 0, None),  # ragged
    ((1, 64, 128, 4, 2, 32), torch.float32, True, 0, 32, "perm"),
    ((1, 64, 128, 4, 2, 32), torch.bfloat16, True, 24, 32, "perm"),
    ((1, 32, 64, 2, 2, 8), torch.float32, True, 0, 0, "future"),  # all hidden
    ((2, 96, 96, 4, 2, 32), torch.float32, True, 0, 0, "strided"),
]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel source for the CPU")
    src = SOURCE.read_text()
    for old, new in REWRITES:
        assert src.count(old) == 1, f"kernel source no longer has {old!r}"
        src = src.replace(old, new)
    out = tmp_path_factory.mktemp("flash_emu")
    (out / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (out / "cuda_bf16.h").write_text(CUDA_BF16_H)
    cpp = out / "flash_fwd_emu.cpp"
    cpp.write_text(src)
    so = out / "libflash_fwd_emu.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
         f"-I{out}", "-Wno-unknown-pragmas", "-o", str(so), str(cpp)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.flash_fwd.argtypes = fa._ARGTYPES
    lib.flash_fwd.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c[0]))
                         + f"-{str(c[1])[6:]}-c{int(c[2])}-w{c[3]}-o{c[4]}"
                         + f"-{c[5]}")
def test_kernel_source_matches_plain_version(lib, case):
    (B, S, T, H, KV, D), dtype, causal, window, q_offset, pos_kind = case
    rng = np.random.default_rng(0)
    if pos_kind == "strided":
        # [B, H, S, D] storage seen as [B, S, H, D]: the kernel must follow
        # the strides
        q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                    ).to(dtype).transpose(1, 2)
                   for s in ((B, H, S, D), (B, KV, T, D), (B, KV, T, D)))
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                    ).to(dtype)
                   for s in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D)))
    positions = None
    if pos_kind == "perm":
        positions = torch.from_numpy(rng.permutation(T).astype(np.int32))
    elif pos_kind == "future":
        positions = torch.arange(S, S + T, dtype=torch.int32)
    o = torch.full((B, S, H, D), float("nan")).to(dtype)
    lse = torch.full((B, S, H), float("nan"))
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        positions.data_ptr() if positions is not None else None,
        o.data_ptr(), lse.data_ptr(), B, S, T, H, KV, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        D ** -0.5, int(causal), window, q_offset,
        0 if dtype == torch.float32 else 1, None)
    assert err == 0
    o_ref, lse_ref = flash_attention_ref(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset,
                                         kv_positions=positions)
    vis = visible_mask(S, T, causal=causal, window=window, q_offset=q_offset,
                       kv_positions=positions).any(dim=1)
    assert not torch.isnan(o.float()).any()
    torch.testing.assert_close(o[:, vis].float(), o_ref[:, vis].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse[:, vis], lse_ref[:, vis], atol=1e-4,
                               rtol=1e-5)
    assert torch.all(o[:, ~vis] == 0)
    assert torch.all(lse[:, ~vis] <= -1e29)
