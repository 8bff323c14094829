"""The CUDA distillation-KL kernel's source, run on the CPU.

``src/repro_torch/kernels/csrc/distill_kl_fwd.cu`` (both ``__global__``s:
the per-split partial statistics and their merge) is compiled with
``g++`` against the stand-in CUDA headers of ``tests/torch_cuda_emu.py``
and called with CPU tensors through the wrapper's own C signature and its
split rule.  The four statistics are held against the plain version,
``distill_kl_stats_ref``: ragged N and V, Ds != Dt, W transposed as a
tied ``embed.T`` is, several vocabulary splits, f32 and bf16.  float32
runs the CUDA-core kernel; bfloat16 runs the tensor-core kernel (TMA,
mbarriers, wgmma) under the stand-in for ``hopper.cuh``.
"""
import contextlib
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_cuda_emu  # noqa: E402
from repro_torch.kernels import distill_kl as dk  # noqa: E402
from repro_torch.kernels.ref import distill_kl_stats_ref  # noqa: E402

# float32: the kernel and the plain version sum D-long products and
# V-long exponentials in different orders; bf16 inputs are the same
# numbers on both sides (both compute in float32), so one tolerance holds
TOL = dict(atol=2e-5, rtol=2e-5)


def _ref(*args, **kw):
    """``distill_kl_stats_ref`` on one CPU thread, as the oracle of
    ``test_torch_ssd_kernel_emu.py`` runs: with several, MKL may pick
    another blocking of its float32 products from one run to the next (as
    the machine's load changes), and the oracle must not depend on the
    load."""
    with _one_thread():
        return distill_kl_stats_ref(*args, **kw)


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


CASES = [
    # N, Ds, Dt, V, dtype, T, w layout, SM count (sets the split)
    (64, 32, 32, 640, torch.float32, 1.0, "rows", 1),     # 3 tiles a split
    (70, 40, 24, 300, torch.float32, 2.0, "rows", 4),     # ragged N, V
    (33, 16, 48, 200, torch.bfloat16, 1.0, "embed_t", 3),
    (96, 64, 64, 129, torch.float32, 2.0, "embed_t", 8),  # 1 column tile
    # the tensor-core path: D a multiple of 64 in both W layouts, ragged N
    # and V, several splits; then D not a multiple of 64, Ds != Dt
    (130, 64, 128, 520, torch.bfloat16, 2.0, "rows", 2),
    (130, 128, 64, 520, torch.bfloat16, 1.0, "embed_t", 2),
    (200, 96, 160, 1000, torch.bfloat16, 2.0, "rows", 1),
]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = torch_cuda_emu.build("distill_kl_fwd",
                               tmp_path_factory.mktemp("distill_kl_emu"))
    lib.distill_kl_fwd.argtypes = dk._ARGTYPES
    lib.distill_kl_fwd.restype = ctypes.c_int
    return lib


def _w(rng, D, V, dtype, layout):
    if layout == "embed_t":       # [V, D] storage seen as [D, V]
        return torch.from_numpy(
            rng.standard_normal((V, D), dtype=np.float32) * 0.3
        ).to(dtype).T
    return torch.from_numpy(
        rng.standard_normal((D, V), dtype=np.float32) * 0.3).to(dtype)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    map(str, c[:4])) + f"-{str(c[4])[6:]}-T{c[5]}-{c[6]}-sm{c[7]}")
def test_kernel_source_matches_plain_version(lib, case):
    N, Ds, Dt, V, dtype, T, layout, sms = case
    rng = np.random.default_rng(0)
    h_s = torch.from_numpy(rng.standard_normal((N, Ds),
                                               dtype=np.float32)).to(dtype)
    h_t = torch.from_numpy(rng.standard_normal((N, Dt),
                                               dtype=np.float32)).to(dtype)
    w_s = _w(rng, Ds, V, dtype, layout)
    w_t = _w(rng, Dt, V, dtype, layout)
    nsplit, per = dk.splits(N, V, sms, dtype)
    bv = dk.TILES[dtype][1]
    assert nsplit * per * bv >= V > (nsplit - 1) * per * bv
    part = torch.full((6, nsplit, N), float("nan"))
    out = torch.full((4, N), float("nan"))
    err = lib.distill_kl_fwd(
        h_s.data_ptr(), w_s.data_ptr(), h_t.data_ptr(), w_t.data_ptr(),
        part.data_ptr(), *(o.data_ptr() for o in out), N, Ds, Dt, V, nsplit,
        per, h_s.stride(0), w_s.stride(0), w_s.stride(1), h_t.stride(0),
        w_t.stride(0), w_t.stride(1), 1.0 / T,
        0 if dtype == torch.float32 else 1, None)
    assert err == 0
    ref = _ref(h_s, w_s, h_t, w_t, T, block_v=64)
    for got, want in zip(out, ref):
        torch.testing.assert_close(got, want, **TOL)


def test_kernel_source_rejects_a_split_that_misses_the_vocabulary(lib):
    x = torch.zeros(4, 8)
    w = torch.zeros(8, 200)
    err = lib.distill_kl_fwd(
        x.data_ptr(), w.data_ptr(), x.data_ptr(), w.data_ptr(),
        x.data_ptr(), *(x.data_ptr(),) * 4, 4, 8, 8, 200, 1, 3, 8, 200, 1,
        8, 200, 1, 1.0, 0, None)
    assert err != 0
