"""Mamba-2 SSD (state-space duality) scan: the chunked algorithm, the
single-token recurrence, and the CUDA forward with its autograd Function.

Counterpart of ``repro/kernels/ssd_scan.py`` and
``repro/kernels/ssd_pallas.py``.  Shapes: x [b, s, h, p], dt [b, s, h]
(after softplus), A [h] (< 0), B and C [b, s, n] shared by all heads
(ngroups = 1), D [h].

* :func:`ssd_chunked` ports ``ssd_chunked_jnp`` (chunk rule included) with
  one change: the intra-chunk decay ``exp(cum_i - cum_j)`` is masked before
  the ``exp``, not after.  Above the diagonal ``cum_i - cum_j`` is a sum of
  ``|A dt|`` that passes 88.7 at chunk 128 and overflows float32; the JAX
  version's ``where`` drops the inf in the forward, but its VJP multiplies
  the zero cotangent by inf and gives NaN (ROADMAP.md, C3).  Here the
  masked entries are ``exp(-inf) = 0`` with a zero gradient.
* :func:`ssd_decode_step` ports the one-token recurrence; the JAX package
  computes it outside any kernel, and so does the port.
* :func:`ssd_fwd` is the ctypes wrapper of ``csrc/ssd_fwd.cu``, which
  replaces the TPU kernel ``ssd_pallas.py::_kernel``; the source says what
  bounds it on an H100 and what its design does about that.  It counts its
  launches in ``ssd_fwd.launches``; :func:`tma_route` is its choice of how
  bf16 tiles are loaded and :func:`scratch` its scratch sizes.
* :class:`SSDScan` gives a forward a gradient: its backward recomputes
  through :func:`ssd_chunked` and returns the VJP, as
  ``ssd_pallas.py::_bwd`` does through ``ssd_chunked_jnp``.  A hand-written
  backward kernel is later work (ROADMAP.md, B4).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tma import tma_violation

CHUNK = 64                  # the kernel's fixed chunk length
MAX_P, MAX_N = 128, 128     # the largest head and state dims it takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
             + [ctypes.c_void_p])


# --------------------------------------------------------------------------- #
# plain PyTorch
# --------------------------------------------------------------------------- #
def ssd_chunked(x, dt, A, B, C, D, *, chunk: int = 128,
                initial_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """-> y [b, s, h, p] in x's dtype, and with ``return_state`` the final
    state [b, h, p, n] float32.  All chunks' intra-chunk terms are computed
    at once; the length-``s/Q`` recurrence over chunk states is a loop."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    Q = min(chunk, s)
    while s % Q:            # the JAX package's rule: halve until it divides
        Q //= 2
    nc = s // Q
    xf = x.float().reshape(b, nc, Q, h, p)
    dtf = dt.float().reshape(b, nc, Q, h)
    Bf = B.float().reshape(b, nc, Q, n)
    Cf = C.float().reshape(b, nc, Q, n)
    cum = torch.cumsum(A.float() * dtf, dim=2)                  # [b,nc,Q,h]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # [b,nc,i,j,h]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(diff.masked_fill(~tri[:, :, None], float("-inf")))
    scores = torch.einsum("bcin,bcjn->bcij", Cf, Bf)[..., None] * L
    dx = dtf[..., None] * xf                                    # [b,nc,Q,h,p]
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, dx)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)           # [b,nc,Q,h]
    S_c = torch.einsum("bcjhp,bcjn->bchpn", (decay_to_end * dtf)[..., None]
                       * xf, Bf)                                 # [b,nc,h,p,n]
    decay_chunk = torch.exp(cum[:, :, -1, :])[..., None, None]  # [b,nc,h,1,1]
    H = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    entering = []
    for c in range(nc):
        entering.append(H)
        H = H * decay_chunk[:, c] + S_c[:, c]
    Hprev = torch.stack(entering, dim=1)                        # [b,nc,h,p,n]
    y = y + torch.einsum("bcin,bchpn->bcihp", Cf, Hprev) \
        * torch.exp(cum)[..., None]
    y = y.reshape(b, s, h, p) + x.float() * D.float()[None, None, :, None]
    y = y.to(x.dtype)
    return (y, H) if return_state else y


def ssd_decode_step(state, xt, dtt, A, Bt, Ct, D):
    """One-token SSD recurrence: state [b, h, p, n] float32, xt [b, h, p],
    dtt [b, h], Bt and Ct [b, n] -> (state', y [b, h, p] in xt's dtype)."""
    decay = torch.exp(A[None] * dtt.float())
    dBx = torch.einsum("bh,bn,bhp->bhpn", dtt.float(), Bt.float(),
                       xt.float())
    state = state * decay[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", state, Ct.float())
    y = y + xt.float() * D[None, :, None]
    return state, y.to(xt.dtype)


# --------------------------------------------------------------------------- #
# the CUDA forward
# --------------------------------------------------------------------------- #
def _lib() -> ctypes.CDLL:
    lib = _build.build("ssd_fwd").lib
    if lib.ssd_fwd.argtypes is None:
        lib.ssd_fwd.argtypes = _ARGTYPES
        lib.ssd_fwd.restype = ctypes.c_int
        lib.ssd_fwd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dt, A, B, C, D):
    xs = (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D))
    if not all(t.is_cuda for _, t in xs):
        raise ValueError("ssd_fwd takes CUDA tensors; CPU tensors go to "
                         "kernels.ssd_scan.ssd_chunked")
    if len({t.device for _, t in xs}) != 1:
        raise ValueError("x, dt, A, B, C, D on different devices")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_fwd takes float32 or bfloat16 x, B, C of one "
                        f"dtype, got {x.dtype}, {B.dtype}, {C.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A, D)):
        raise TypeError(f"dt, A and D must be float32, got {dt.dtype}, "
                        f"{A.dtype}, {D.dtype}")
    if x.dim() != 4:
        raise ValueError(f"expected x [b,s,h,p], got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if (dt.shape != (b, s, h) or A.shape != (h,) or D.shape != (h,)
            or B.shape != (b, s, n) or C.shape != (b, s, n)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}, D "
                         f"{tuple(D.shape)}")
    if not (0 < p <= MAX_P and 0 < n <= MAX_N):
        raise ValueError(f"head dim {p} and state dim {n} must lie in "
                         f"[1, {MAX_P}] and [1, {MAX_N}]")
    for name, t in (("x", x), ("dt", dt), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    if not (A.is_contiguous() and D.is_contiguous()):
        raise ValueError("A and D must be contiguous")


def tma_route(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor) -> bool:
    """Whether the bf16 kernels read x, B and C by TMA (all three meet its
    preconditions, ``kernels/tma.py``) or load their tiles by threads."""
    return all(tma_violation(t.shape, t.stride(), t.data_ptr(),
                             t.element_size()) is None for t in (x, B, C))


def scratch(b: int, s: int, h: int, p: int, n: int,
            dtype: torch.dtype) -> tuple[int, int]:
    """Float32 elements of the kernel's two scratch buffers (cum, states)
    for these dims: float32 inputs keep cum [b,h,nc,64] and the chunk
    states [b,h,nc,p,n]; bf16 inputs need no cum and keep the entering
    states as bf16 hi and lo parts [b,h,nc,2,PP,NP], p and n rounded up
    to 64 or 128 (the same bytes as [b,h,nc,PP,NP] in f32)."""
    nc = -(-s // CHUNK)
    if dtype == torch.float32:
        return b * h * nc * CHUNK, b * h * nc * p * n
    pp, np_ = (64 if p <= 64 else 128), (64 if n <= 64 else 128)
    return 0, b * h * nc * pp * np_


def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
            return_state: bool = False):
    """The SSD scan on one CUDA device -> y [b, s, h, p] in x's dtype
    (D·x skip included), and with ``return_state`` the final state
    [b, h, p, n] float32.  x, dt, B and C are read through their strides
    (the model hands in slices of the convolution's output).  bf16 runs
    on the tensor cores, x, B and C by TMA where :func:`tma_route` allows
    and by threads elsewhere; float32 on the CUDA cores.

    The result carries no gradient: a call that autograd would record
    raises.  Differentiable callers go through :class:`SSDScan`
    (``kernels.ops.ssd_scan`` does)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C, D)):
        raise RuntimeError(
            "ssd_fwd has no gradient of its own: differentiate through "
            "kernels.ops.ssd_scan (the SSDScan Function)")
    _check(x, dt, A, B, C, D)
    b, s, h, p = x.shape
    n = B.shape[-1]
    dev = x.device
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    state = (torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
             if return_state else None)
    n_cum, n_states = scratch(b, s, h, p, n, x.dtype)
    cum = torch.empty(n_cum, dtype=torch.float32, device=dev)
    states = torch.empty(n_states, dtype=torch.float32, device=dev)
    tma = x.dtype == torch.bfloat16 and tma_route(x, B, C)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), y.data_ptr(), cum.data_ptr(),
            states.data_ptr(),
            state.data_ptr() if state is not None else None,
            b, s, h, p, n, x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), B.stride(0), B.stride(1),
            C.stride(0), C.stride(1), _DTYPES[x.dtype], int(tma), stream)
    if err != 0:
        raise RuntimeError("ssd_fwd launch failed: "
                           + lib.ssd_fwd_error_string(err).decode())
    ssd_fwd.launches += 1
    return (y, state) if return_state else y


ssd_fwd.launches = 0     # type: ignore[attr-defined]


# --------------------------------------------------------------------------- #
# autograd
# --------------------------------------------------------------------------- #
class SSDScan(torch.autograd.Function):
    """y (and the final state) of the SSD scan.

    ``apply(x, dt, A, B, C, D, chunk, return_state, forward)`` where
    ``forward(x, dt, A, B, C, D, return_state=...)`` is the CUDA kernel's
    wrapper on the card or a plain version in the tests.  The backward
    recomputes :func:`ssd_chunked` at ``chunk`` under autograd and returns
    its VJP."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk, return_state,
                forward: Callable):
        out = forward(x, dt, A, B, C, D, return_state=return_state)
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.chunk, ctx.return_state = chunk, return_state
        return out

    @staticmethod
    def backward(ctx, gy, gstate=None):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:6]
        ins = [t.detach().requires_grad_(nd) for t, nd in zip(saved, need)]
        wrt = [t for t, nd in zip(ins, need) if nd]
        if not wrt:
            return (None,) * 9
        with torch.enable_grad():
            y, state = ssd_chunked(*ins, chunk=ctx.chunk, return_state=True)
            outs, gouts = [y], [gy]
            if gstate is not None:
                outs.append(state)
                gouts.append(gstate)
            grads = iter(torch.autograd.grad(outs, wrt, gouts))
        return (*(next(grads) if nd else None for nd in need), None, None,
                None)
