"""The CUDA flash backward's source, run on the CPU.

``src/repro_torch/kernels/csrc/flash_bwd.cu`` is compiled with ``g++``
against the stand-in CUDA headers of ``tests/torch_cuda_emu.py`` (one
``std::thread`` per CUDA thread, ``__syncthreads`` as a barrier), loaded
with ctypes and called with CPU tensors through the wrapper's own C
signature.  float32 runs the CUDA-core kernels; bfloat16 runs the
tensor-core kernels (TMA, mbarriers, wgmma) under the stand-in for
``hopper.cuh``.  dq, dk and dv are held against the plain version,
``flash_bwd_ref``, on one thread (ROADMAP.md, C5), each element within
``GRAD_TOL`` of ``1 + |ref|`` (``chip_smoke.py``'s limits), and rows with
no visible key must give exactly 0.  One float32 case with an lse
cotangent is also held to the JAX package's ``_flash_bwd_core`` on the
same numpy inputs.  The build, the launch, the fragment layouts on the
real tensor cores and the speed on the card are ``chip_smoke.py``'s.
"""
import contextlib
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_cuda_emu  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_ref,  # noqa: E402
                                     flash_bwd_ref, visible_mask)

# f32: both sides sum f32 products in other orders; bf16: the kernel
# rounds P and dS to bf16 before their products, and both sides round the
# gradients to bf16 (chip_smoke.py's GRAD_TOL)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


CASES = [
    # (B, S, T, H, KV, D), dtype, causal, window, q_offset, positions, dlse
    ((1, 128, 128, 4, 2, 16), torch.float32, True, 0, 0, None, True),
    ((2, 64, 64, 2, 2, 32), torch.float32, False, 0, 0, None, False),
    ((1, 128, 64, 4, 1, 16), torch.float32, True, 32, 0, None, True),
    ((1, 70, 130, 3, 1, 8), torch.float32, True, 0, 0, None, True),  # ragged
    ((1, 64, 128, 4, 2, 32), torch.float32, True, 24, 32, "perm", True),
    ((1, 32, 64, 2, 2, 8), torch.float32, True, 0, 0, "future", True),
    ((2, 96, 96, 4, 2, 32), torch.float32, True, 0, 0, "strided", False),
    ((1, 64, 64, 2, 1, 128), torch.float32, False, 0, 0, None, True),
    # the tensor-core kernels: G = 1 and G > 1, causal, non-causal and a
    # window, ragged S != T, permuted and hidden key positions, strided
    # views, head dims 8 (padded), 16, 64 and 128
    ((1, 128, 128, 2, 2, 64), torch.bfloat16, True, 0, 0, None, False),
    ((1, 128, 128, 4, 2, 16), torch.bfloat16, True, 0, 0, None, True),
    ((1, 128, 200, 2, 1, 64), torch.bfloat16, False, 0, 0, None, True),
    ((1, 200, 136, 2, 1, 64), torch.bfloat16, True, 48, 72, None, False),
    ((1, 70, 130, 2, 2, 128), torch.bfloat16, True, 0, 0, None, True),
    ((1, 64, 128, 4, 2, 32), torch.bfloat16, True, 24, 32, "perm", True),
    ((1, 64, 128, 2, 1, 16), torch.bfloat16, True, 0, 0, "future", True),
    ((2, 130, 130, 2, 1, 128), torch.bfloat16, True, 0, 0, "strided", True),
    ((1, 64, 64, 6, 3, 8), torch.bfloat16, False, 0, 0, None, True),
    # several streamed tiles a block (64 q rows in dK/dV, 128 KV rows in dQ
    # at D <= 64 and 64 at D = 128), with the masked and unmasked softmax
    # loops in one block: ragged ends past 128, causal and not, a window
    # and q_offset that straddle a 128-row tile, G = 3 over several tiles,
    # D = 128 over three and four tiles
    ((1, 300, 260, 2, 1, 64), torch.bfloat16, True, 0, 0, None, True),
    ((1, 290, 200, 2, 2, 32), torch.bfloat16, False, 0, 0, None, False),
    ((1, 260, 300, 2, 1, 64), torch.bfloat16, True, 100, 40, None, True),
    ((1, 256, 264, 6, 2, 32), torch.bfloat16, True, 0, 0, None, True),
    ((1, 200, 300, 2, 1, 128), torch.bfloat16, False, 0, 0, None, True),
]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = torch_cuda_emu.build("flash_bwd",
                               tmp_path_factory.mktemp("flash_bwd_emu"))
    lib.flash_bwd.argtypes = fa._BWD_ARGTYPES
    lib.flash_bwd.restype = ctypes.c_int
    return lib


def _inputs(case, seed=0):
    (B, S, T, H, KV, D), dtype, causal, window, q_offset, pos_kind, \
        with_dlse = case
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    if pos_kind == "strided":
        # [B, H, S, D] storage seen as [B, S, H, D]: the kernels follow the
        # strides
        q = randn(B, H, S, D).to(dtype).transpose(1, 2)
        k = randn(B, KV, T, D).to(dtype).transpose(1, 2)
        v = randn(B, KV, T, D).to(dtype).transpose(1, 2)
    else:
        q, k, v = (randn(*s).to(dtype)
                   for s in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D)))
    positions = None
    if pos_kind == "perm":
        positions = torch.from_numpy(rng.permutation(T).astype(np.int32))
    elif pos_kind == "future":            # every key after every query
        positions = torch.arange(S + q_offset, S + q_offset + T,
                                 dtype=torch.int32)
    do = randn(B, S, H, D).to(dtype)
    dlse = randn(B, S, H) if with_dlse else None
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_positions=positions)
    return q, k, v, do, dlse, kw


def _forward(q, k, v, kw):
    """o and lse of the plain version, contiguous as the kernel's forward
    writes them (the op refuses other layouts)."""
    with _one_thread():
        o, lse = flash_attention_ref(q, k, v, **kw)
    return o.contiguous(), lse.contiguous()


def _launch(lib, q, k, v, o, lse, do, dlse, kw):
    B, S, H, D = q.shape
    _, T, KV, _ = k.shape
    dq = torch.full(q.shape, float("nan")).to(q.dtype)
    dk = torch.full((B, T, KV, D), float("nan")).to(q.dtype)
    dv = torch.full((B, T, KV, D), float("nan")).to(q.dtype)
    delta = torch.full((B, S, H), float("nan"))
    pos = kw["kv_positions"]
    err = lib.flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(),
        dlse.data_ptr() if dlse is not None else None,
        pos.data_ptr() if pos is not None else None,
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        B, S, T, H, KV, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], D ** -0.5, int(kw["causal"]), kw["window"],
        kw["q_offset"], 0 if q.dtype == torch.float32 else 1, None)
    assert err == 0
    return dq, dk, dv, delta


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs()
            / (1 + want.float().abs())).max().item()


@pytest.mark.parametrize(
    "case", CASES, ids=lambda c: "-".join(map(str, c[0]))
    + f"-{str(c[1])[6:]}-c{int(c[2])}-w{c[3]}-o{c[4]}-{c[5]}"
    + ("-dlse" if c[6] else ""))
def test_kernel_source_matches_plain_version(lib, case):
    q, k, v, do, dlse, kw = _inputs(case)
    o, lse = _forward(q, k, v, kw)
    with _one_thread():
        want = flash_bwd_ref(q, k, v, o, lse, do, dlse, **kw)
    dq, dk, dv, delta = _launch(lib, q, k, v, o, lse, do, dlse, kw)
    want_delta = (do.float() * o.float()).sum(-1)
    if dlse is not None:
        want_delta = want_delta - dlse
    torch.testing.assert_close(delta, want_delta, atol=1e-5, rtol=1e-5)
    tol = GRAD_TOL[q.dtype]
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert g.dtype == q.dtype and g.is_contiguous(), name
        assert not torch.isnan(g.float()).any(), name
        assert _rel(g, w) <= tol, (name, _rel(g, w))
    S, T = q.shape[1], k.shape[1]
    hidden = ~visible_mask(S, T, **kw).any(dim=1)
    assert torch.all(dq[:, hidden] == 0)
    if not (~hidden).any():                # no row sees a key
        assert torch.all(dk == 0) and torch.all(dv == 0)


def test_two_calls_give_the_same_bits(lib):
    """No atomics: the sums are taken in one fixed order."""
    case = ((1, 128, 200, 4, 2, 64), torch.bfloat16, True, 0, 72, None,
            True)
    q, k, v, do, dlse, kw = _inputs(case, seed=1)
    o, lse = _forward(q, k, v, kw)
    first = _launch(lib, q, k, v, o, lse, do, dlse, kw)
    second = _launch(lib, q, k, v, o, lse, do, dlse, kw)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


def test_kernel_source_matches_jax_flash_bwd_core(lib):
    """One float32 case with an lse cotangent against the JAX package's
    blockwise backward, ``repro/kernels/ref.py::_flash_bwd_core``."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    case = ((1, 128, 128, 4, 2, 32), torch.float32, True, 0, 0, None, True)
    q, k, v, do, dlse, kw = _inputs(case, seed=2)
    o, lse = _forward(q, k, v, kw)
    dq, dk, dv, _ = _launch(lib, q, k, v, o, lse, do, dlse, kw)
    res = tuple(jnp.asarray(x.numpy()) for x in (q, k, v, o, lse)) + (
        None, None, jnp.int32(0), None)
    want = jref._flash_bwd_core(True, 0, q.shape[-1] ** -0.5, (64, 64), res,
                                jnp.asarray(do.numpy()),
                                jnp.asarray(dlse.numpy()))[:3]
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        w = torch.from_numpy(np.array(w))
        assert _rel(g, w) <= GRAD_TOL[torch.float32], (name, _rel(g, w))
