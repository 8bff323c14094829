"""The CUDA flash kernel's source, run on the CPU.

``src/repro_torch/kernels/csrc/flash_fwd.cu`` is compiled with ``g++``
against the stand-in CUDA headers of ``tests/torch_cuda_emu.py`` (one
``std::thread`` per CUDA thread, ``__syncthreads`` as a barrier), loaded
with ctypes and called with CPU tensors through the wrapper's own C
signature.  float32 runs the CUDA-core kernel; bfloat16 runs the
tensor-core kernel (TMA, mbarriers, wgmma) under the stand-in for
``hopper.cuh``.  Its output is held against the plain version,
``flash_attention_ref``, with the card's tolerances.  This checks the
kernel's indexing, masking, tile skipping, online softmax and pipeline
phases on every CPU run; the build, the launch, the fragment layouts on
the real tensor cores and the speed on the card are ``chip_smoke.py``'s.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_cuda_emu  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_ref,  # noqa: E402
                                     visible_mask)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

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
    # the tensor-core path at the models' head dims: a full 128-row q tile
    # and ragged T, causal and not, a window, a strided view
    ((1, 128, 200, 2, 1, 64), torch.bfloat16, True, 0, 72, None),
    ((1, 128, 136, 2, 2, 128), torch.bfloat16, False, 0, 0, None),
    ((1, 256, 256, 2, 1, 64), torch.bfloat16, True, 48, 0, None),
    ((2, 130, 130, 2, 1, 128), torch.bfloat16, True, 0, 0, "strided"),
    ((1, 96, 96, 2, 1, 16), torch.bfloat16, True, 0, 0, None),
]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = torch_cuda_emu.build("flash_fwd",
                               tmp_path_factory.mktemp("flash_emu"))
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
