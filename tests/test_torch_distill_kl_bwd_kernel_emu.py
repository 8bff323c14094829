"""The CUDA distillation-KL backward kernel's source, run on the CPU.

``src/repro_torch/kernels/csrc/distill_kl_bwd.cu`` (the logit gradients of
one vocabulary chunk) is compiled with ``g++`` against the stand-in CUDA
headers of ``tests/torch_cuda_emu.py`` and called with CPU tensors through
the wrapper's own C signature, chunk after chunk as the op
``repro_torch::distill_kl_bwd`` calls it (``chunk_cols``-style chunks
smaller than V, a ragged last chunk, the wrapper's split rule).  dz of
each side asked for is held against the plain version's formulas
(``ref.distill_kl_bwd_ref``: ``dz_s = (p_s - p_t) w``, ``dz_t = p_t ((z_t
- e_t) - (z_s - e_s)) w``) on the forward's statistics: ragged N and V,
Ds != Dt, W as rows and as a tied ``embed.T``, masked and unmasked, T 1
and 2.  float32 runs the CUDA-core kernel, and there the op's products
(``distill_kl._products``) run on each chunk too, and dh and dW are held
against ``distill_kl_bwd_ref`` itself; bfloat16 runs the tensor-core
kernel (TMA, mbarriers, wgmma) under the stand-in for ``hopper.cuh``, its
dz rounded to bf16.
"""
import contextlib
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_cuda_emu  # noqa: E402
from repro_torch.kernels import distill_kl as dk  # noqa: E402
from repro_torch.kernels.ref import (distill_kl_bwd_ref,  # noqa: E402
                                     distill_kl_stats_ref)

# dz: float32 sums of D-long products in other orders on both sides, then
# an exp; a bf16 dz is rounded once from such an f32 value, so it is held
# to one bf16 step (2^-8 of its value) beyond that.  Both relative to the
# side's largest |dz|, since dz_s cancels where p_s is close to p_t.
DZ_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}
DZ_ATOL = 1e-5
# dh and dW from float32 dz against the oracle: sums of up to V products
# in other orders
GRAD_TOL = dict(atol=2e-6, rtol=2e-5)


@contextlib.contextmanager
def _one_thread():
    """The oracle on one CPU thread: with several, MKL may pick another
    blocking of its float32 products from one run to the next (as the
    machine's load changes), and the oracle must not depend on the load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


CASES = [
    # N, Ds, Dt, V, dtype, T, W layout, masked, Vc, SM count, sides
    (70, 40, 24, 300, torch.float32, 2.0, "rows", True, 128, 4, "st"),
    (64, 32, 48, 200, torch.float32, 1.0, "embed_t", False, 128, 2, "s"),
    (33, 16, 48, 200, torch.bfloat16, 1.0, "embed_t", True, 256, 3, "st"),
    (130, 64, 128, 520, torch.bfloat16, 2.0, "rows", False, 256, 2, "s"),
    # an odd last chunk (7 columns): the single-element store
    (130, 128, 64, 391, torch.bfloat16, 1.0, "embed_t", True, 128, 2, "st"),
    (200, 96, 160, 1000, torch.bfloat16, 2.0, "rows", True, 384, 1, "t"),
]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = torch_cuda_emu.build("distill_kl_bwd",
                               tmp_path_factory.mktemp("distill_kl_bwd_emu"))
    lib.distill_kl_bwd.argtypes = dk._BWD_ARGTYPES
    lib.distill_kl_bwd.restype = ctypes.c_int
    return lib


def _w(rng, D, V, dtype, layout):
    if layout == "embed_t":       # [V, D] storage seen as [D, V]
        return torch.from_numpy(
            rng.standard_normal((V, D), dtype=np.float32) * 0.3
        ).to(dtype).T
    return torch.from_numpy(
        rng.standard_normal((D, V), dtype=np.float32) * 0.3).to(dtype)


def _inputs(case):
    N, Ds, Dt, V, dtype, T, layout, masked = case[:8]
    rng = np.random.default_rng(0)
    h_s = torch.from_numpy(rng.standard_normal((N, Ds),
                                               dtype=np.float32)).to(dtype)
    h_t = torch.from_numpy(rng.standard_normal((N, Dt),
                                               dtype=np.float32)).to(dtype)
    w_s = _w(rng, Ds, V, dtype, layout)
    w_t = _w(rng, Dt, V, dtype, layout)
    mask = torch.from_numpy(rng.random(N) < 0.7) if masked else None
    with _one_thread():
        stats = distill_kl_stats_ref(h_s, w_s, h_t, w_t, T)
    # DistillKL.backward's token weight at g = 1.3
    tok_w = (mask.float() / mask.float().sum().clamp_min(1.0)
             if masked else torch.full((N,), 1.0 / N))
    tok_w = tok_w * 1.3 / T
    return h_s, w_s, h_t, w_t, stats, tok_w


def _dz_ref(h_s, w_s, h_t, w_t, stats, tok_w, T):
    """The plain version's dz, over the whole vocabulary in float32."""
    lse_s, lse_t, e_t, e_s = (x[:, None] for x in stats)
    with _one_thread():
        zs = (h_s.float() @ w_s.float()) / T
        zt = (h_t.float() @ w_t.float()) / T
    pt = torch.exp(zt - lse_t)
    w = tok_w[:, None]
    return ((torch.exp(zs - lse_s) - pt) * w,
            pt * ((zt - e_t) - (zs - e_s)) * w)


def _run(lib, case, h_s, w_s, h_t, w_t, stats, tok_w, products=False):
    """The op's chunk loop on the emulated kernel -> (dz_s, dz_t) over the
    whole vocabulary (None for a side not asked for), and with
    ``products`` the op's (dh_s, dw_s, dh_t, dw_t) from them."""
    N, Ds, Dt, V, dtype, T, _, _, Vc, sms, sides = case
    need_s, need_t = "s" in sides, "t" in sides
    dz = torch.full((int(need_s) + int(need_t), N, Vc), float("nan"),
                    dtype=dtype)
    dzs = dz[0] if need_s else None
    dzt = dz[int(need_s)] if need_t else None
    full = [torch.full((N, V), float("nan")) if x is not None else None
            for x in (dzs, dzt)]
    grads = ([torch.zeros(N, Ds), torch.empty_like(w_s),
              torch.zeros(N, Dt), torch.empty_like(w_t)]
             if products else None)
    for v0 in range(0, V, Vc):
        vc = min(Vc, V - v0)
        _, per = dk.splits(N, vc, sms, dtype)
        err = lib.distill_kl_bwd(
            h_s.data_ptr(), w_s.data_ptr(), h_t.data_ptr(), w_t.data_ptr(),
            *(x.data_ptr() for x in (*stats, tok_w)),
            dzs.data_ptr() if dzs is not None else None,
            dzt.data_ptr() if dzt is not None else None,
            N, Ds, Dt, V, v0, vc, Vc, per, h_s.stride(0), w_s.stride(0),
            w_s.stride(1), h_t.stride(0), w_t.stride(0), w_t.stride(1),
            1.0 / T, 0 if dtype == torch.float32 else 1, None)
        assert err == 0
        for f, d in zip(full, (dzs, dzt)):
            if d is not None:
                f[:, v0:v0 + vc] = d[:, :vc].float()
        if products:
            with _one_thread():
                if need_s:
                    dk._products(h_s, w_s, dzs[:, :vc], grads[0], grads[1],
                                 v0, vc)
                if need_t:
                    dk._products(h_t, w_t, dzt[:, :vc], grads[2], grads[3],
                                 v0, vc)
    return full, grads


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    map(str, c[:4])) + f"-{str(c[4])[6:]}-T{c[5]}-{c[6]}-"
    f"{'mask' if c[7] else 'all'}-vc{c[8]}-sm{c[9]}-{c[10]}")
def test_kernel_source_matches_plain_version(lib, case):
    dtype, T, masked, sides = case[4], case[5], case[7], case[10]
    h_s, w_s, h_t, w_t, stats, tok_w = _inputs(case)
    f32 = dtype == torch.float32
    (got_s, got_t), grads = _run(lib, case, h_s, w_s, h_t, w_t, stats,
                                 tok_w, products=f32)
    want_s, want_t = _dz_ref(h_s, w_s, h_t, w_t, stats, tok_w, T)
    for side, got, want in (("s", got_s, want_s), ("t", got_t, want_t)):
        if side not in sides:
            assert got is None
            continue
        assert bool(torch.isfinite(got).all()), f"dz_{side} not finite"
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=DZ_TOL[dtype],
                                   atol=DZ_ATOL * scale)
        if masked:        # a masked token's gradient is exactly 0
            assert bool((got[tok_w == 0] == 0).all())
    if f32:
        needs = ("s" in sides,) * 2 + ("t" in sides,) * 2
        with _one_thread():
            want = distill_kl_bwd_ref(h_s, w_s, h_t, w_t, *stats, tok_w, T,
                                      needs=needs, block_v=64)
        for need, g, w in zip(needs, grads, want):
            if need:
                assert g.stride() == w.stride()
                torch.testing.assert_close(g, w, **GRAD_TOL)


def test_kernel_source_rejects_a_chunk_past_the_vocabulary(lib):
    x = torch.zeros(4, 8)
    w = torch.zeros(8, 200)
    s = torch.zeros(4)
    args = [x.data_ptr(), w.data_ptr(), x.data_ptr(), w.data_ptr(),
            *(s.data_ptr(),) * 5, x.data_ptr(), None, 4, 8, 8, 200, 128, 73,
            128, 1, 8, 200, 1, 8, 200, 1, 1.0, 0, None]
    assert lib.distill_kl_bwd(*args) != 0          # 128 + 73 > 200
    args[15] = 0
    args[9] = None                                 # no side asked for
    assert lib.distill_kl_bwd(*args) != 0
