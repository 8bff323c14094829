"""Mamba-2 SSD (state-space duality) scan: the chunked algorithm, the
single-token recurrence, and the CUDA forward and backward with their
autograd Function.

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
  masked entries are ``exp(-inf) = 0`` with a zero gradient.  The
  differences of ``cum`` are taken in float64: both terms grow with the
  chunk's decay, and in float32 their difference loses the digits of a
  small one (at 4094 tokens y then errs by ~1e-4 of 1 + |y|).
* :func:`ssd_decode_step` ports the one-token recurrence; the JAX package
  computes it outside any kernel, and so does the port.
* :func:`ssd_fwd` is the wrapper of ``csrc/ssd_fwd.cu``, which replaces
  the TPU kernel ``ssd_pallas.py::_kernel``; the source says what bounds
  it on an H100 and what its design does about that.  It calls the
  CUDA-only op ``repro_torch::ssd_fwd``, whose implementation launches
  through ctypes and whose fake function allocates the same outputs for a
  dry-run on fake tensors.  It counts its launches in
  ``ssd_fwd.launches``; :func:`tma_route` is its choice of how
  bf16 tiles are loaded and :func:`scratch` its scratch sizes.
* :func:`ssd_bwd` is the wrapper of ``csrc/ssd_bwd.cu``, which replaces
  the backward rule ``ssd_pallas.py::_bwd`` (``jax.vjp`` through
  ``ssd_chunked_jnp``): the CUDA-only op ``repro_torch::ssd_bwd`` writes
  dx, ddt, dA, dB, dC and dD from the saved inputs, gy and the final
  state's gradient, into scratch that the wrapper allocates
  (:func:`bwd_scratch`), so that a dry-run counts it; bf16 on the tensor
  cores, x, gy, B and C by TMA where :func:`tma_route` allows, float32 on
  the CUDA cores.  It counts its launches in ``ssd_bwd.launches``.
* :class:`SSDScan` gives a forward a gradient: its backward calls the
  backward function it was handed beside the forward (on the card
  :func:`ssd_fwd` and :func:`ssd_bwd`, both hand-written kernels).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.tma import tma_violation

CHUNK = 64                  # the kernel's fixed chunk length
MAX_P, MAX_N = 128, 128     # the largest head and state dims it takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
             + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                 + [ctypes.c_void_p])
BWD_GROUP = 8               # heads a block of the bf16 backward's gradients


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
    cum64 = torch.cumsum(A.double() * dtf.double(), dim=2)      # [b,nc,Q,h]
    cum = cum64.float()
    diff = (cum64[:, :, :, None, :]
            - cum64[:, :, None, :, :]).float()                  # [b,nc,i,j,h]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(diff.masked_fill(~tri[:, :, None], float("-inf")))
    scores = torch.einsum("bcin,bcjn->bcij", Cf, Bf)[..., None] * L
    dx = dtf[..., None] * xf                                    # [b,nc,Q,h,p]
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, dx)
    decay_to_end = torch.exp((cum64[:, :, -1:, :] - cum64).float())
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
        lib.ssd_fwd.restype = ctypes.c_int
        lib.ssd_fwd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_fwd_error_string.restype = ctypes.c_char_p
        lib.ssd_fwd.argtypes = _ARGTYPES    # last: other threads test it
    return lib


def _check(x, dt, A, B, C, D, name="ssd_fwd", plain="ssd_scan.ssd_chunked"):
    xs = (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D))
    if not all(t.is_cuda or t.is_meta for _, t in xs):
        raise ValueError(f"{name} takes CUDA (or a dry-run's meta) tensors; "
                         f"CPU tensors go to kernels.{plain}")
    if len({t.device for _, t in xs}) != 1:
        raise ValueError("x, dt, A, B, C, D on different devices")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 x, B, C of one "
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


def tma_route(*tensors: torch.Tensor) -> bool:
    """Whether the bf16 kernels read their tiles of these tensors (the
    forward's x, B and C; the backward's also gy) by TMA (all meet its
    preconditions, ``kernels/tma.py``) or load them by threads."""
    return all(tma_violation(t.shape, t.stride(), t.data_ptr(),
                             t.element_size()) is None for t in tensors)


def scratch(b: int, s: int, h: int, p: int, n: int,
            dtype: torch.dtype) -> tuple[int, int]:
    """Elements of the kernel's two scratch buffers for these dims: cum
    (float64) and states (float32).  Float32 inputs keep cum [b,h,nc,64]
    and the chunk states [b,h,nc,p,n]; bf16 inputs need no cum and keep the
    entering
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
    y, state = torch.ops.repro_torch.ssd_fwd(x, dt, A, B, C, D,
                                             bool(return_state))
    return (y, state) if return_state else y


@torch.library.custom_op(
    "repro_torch::ssd_fwd", mutates_args=(), device_types="cuda",
    schema="(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, Tensor D, "
           "bool return_state) -> (Tensor, Tensor)")
def _ssd_fwd_op(x, dt, A, B, C, D, return_state):
    """The launch: y, the final state ([0] without ``return_state``) and
    the scratch allocated, x/B/C's route chosen, the kernels on the current
    stream, one count in ``ssd_fwd.launches``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    dev = x.device
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    state = torch.empty((b, h, p, n) if return_state else (0,),
                        dtype=torch.float32, device=dev)
    n_cum, n_states = scratch(b, s, h, p, n, x.dtype)
    cum = torch.empty(n_cum, dtype=torch.float64, device=dev)
    states = torch.empty(n_states, dtype=torch.float32, device=dev)
    tma = x.dtype == torch.bfloat16 and tma_route(x, B, C)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), y.data_ptr(), cum.data_ptr(),
            states.data_ptr(),
            state.data_ptr() if return_state else None,
            b, s, h, p, n, x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), B.stride(0), B.stride(1),
            C.stride(0), C.stride(1), _DTYPES[x.dtype], int(tma), stream)
    if err != 0:
        raise RuntimeError("ssd_fwd launch failed: "
                           + lib.ssd_fwd_error_string(err).decode())
    _build.count_launch(ssd_fwd)
    return y, state


@_ssd_fwd_op.register_fake
def _ssd_fwd_fake(x, dt, A, B, C, D, return_state):
    """The outputs the launch allocates, without launching."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    return (torch.empty((b, s, h, p), dtype=x.dtype, device=x.device),
            torch.empty((b, h, p, n) if return_state else (0,),
                        dtype=torch.float32, device=x.device))


@register_flop_formula(torch.ops.repro_torch.ssd_fwd)
def _ssd_fwd_flops(x_shape, dt_shape, A_shape, B_shape, C_shape, D_shape,
                   return_state, *args, out_shape=None, **kwargs) -> int:
    """C B^T once per (b, chunk), the intra-chunk product, the inter-chunk
    product and the chunk states: ``PERF.md``'s bound count."""
    b, s, h, p = x_shape
    n = B_shape[-1]
    nc = -(-s // CHUNK)
    return (2 * b * nc * CHUNK * CHUNK * n + 2 * b * h * nc * CHUNK * CHUNK
            * p + 2 * 2 * b * h * s * p * n)


ssd_fwd.launches = 0     # type: ignore[attr-defined]


# --------------------------------------------------------------------------- #
# the CUDA backward
# --------------------------------------------------------------------------- #
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.build("ssd_bwd").lib
    if lib.ssd_bwd.argtypes is None:
        lib.ssd_bwd.restype = ctypes.c_int
        lib.ssd_bwd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_bwd_error_string.restype = ctypes.c_char_p
        lib.ssd_bwd.argtypes = _BWD_ARGTYPES    # last: other threads test it
    return lib


def bwd_scratch(b: int, s: int, h: int, p: int, n: int,
                dtype: torch.dtype) -> tuple[int, int]:
    """Elements of the backward's two scratch buffers, cum (float64) and
    work (float32).  Float32 inputs keep cum [b, h, nc, 64] and in work the
    states entering each chunk and the gradients of the states leaving
    them, [b, h, nc, p, n] each, then the [2, b, nc, h] partials of dA and
    dD.  bf16 inputs need no cum and keep in work the same states as bf16
    hi and lo parts, [b, h, nc, 2, PP, NP] each (p and n rounded up to 64
    or 128), the f32 partials of dB and dC of each group of
    :data:`BWD_GROUP` heads, [groups, b, s, n] each, then the partials of
    dA and dD."""
    nc = -(-s // CHUNK)
    if dtype == torch.float32:
        return b * h * nc * CHUNK, 2 * b * h * nc * p * n + 2 * b * nc * h
    pp, np_ = (64 if p <= 64 else 128), (64 if n <= 64 else 128)
    groups = -(-h // BWD_GROUP)
    return 0, (2 * b * h * nc * pp * np_ + 2 * groups * b * s * n
               + 2 * b * nc * h)


def _check_bwd(x, dt, A, B, C, D, gy, gstate):
    """``_check``'s inputs, gy like x (contiguous) and gstate [b, h, p, n]
    float32 (contiguous) or None."""
    _check(x, dt, A, B, C, D, "ssd_bwd", "ref.ssd_bwd_ref")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if (gy.shape != x.shape or gy.dtype != x.dtype or gy.device != x.device
            or not gy.is_contiguous()):
        raise ValueError(f"ssd_bwd: gy must be a contiguous {x.dtype} "
                         f"tensor of shape {tuple(x.shape)} on x's device, "
                         f"got {gy.dtype} {tuple(gy.shape)} strides "
                         f"{gy.stride()} on {gy.device}")
    if gstate is not None and (
            gstate.shape != (b, h, p, n) or gstate.dtype != torch.float32
            or gstate.device != x.device or not gstate.is_contiguous()):
        raise ValueError(f"ssd_bwd: gstate must be a contiguous float32 "
                         f"tensor of shape {(b, h, p, n)} on x's device, got "
                         f"{gstate.dtype} {tuple(gstate.shape)} on "
                         f"{gstate.device}")


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
            gy: torch.Tensor, gstate: Optional[torch.Tensor] = None):
    """The SSD scan's gradients on one CUDA device -> (dx, ddt, dA, dB, dC,
    dD): dx, dB and dC in x's dtype, ddt, dA and dD float32.  ``gy`` is
    y's gradient, ``gstate`` the final state's (None: zero).  x, dt, B and
    C are read through their strides; gy and gstate are made contiguous.
    bf16 runs on the tensor cores, x, gy, B and C by TMA where
    :func:`tma_route` allows and by threads elsewhere; float32 on the CUDA
    cores.

    CUDA (and a dry-run's meta) tensors only: it allocates the scratch
    (:func:`bwd_scratch`) and calls the op ``repro_torch::ssd_bwd``.  CPU
    tensors go to the plain version, ``kernels.ref.ssd_bwd_ref``.  A call
    that autograd would record raises: the result carries no gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B, C, D, gy, gstate)):
        raise RuntimeError(
            "ssd_bwd has no gradient of its own: it is the backward of "
            "kernels.ops.ssd_scan (the SSDScan Function)")
    gy = gy.contiguous()
    if gstate is not None:
        gstate = gstate.float().contiguous()
    _check_bwd(x, dt, A, B, C, D, gy, gstate)
    b, s, h, p = x.shape
    n = B.shape[-1]
    n_cum, n_work = bwd_scratch(b, s, h, p, n, x.dtype)
    cum = torch.empty(n_cum, dtype=torch.float64, device=x.device)
    work = torch.empty(n_work, dtype=torch.float32, device=x.device)
    return tuple(torch.ops.repro_torch.ssd_bwd(x, dt, A, B, C, D, gy, gstate,
                                               cum, work))


@torch.library.custom_op(
    "repro_torch::ssd_bwd", mutates_args=("cum", "work"), device_types="cuda",
    schema="(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, Tensor D, "
           "Tensor gy, Tensor? gstate, Tensor(a!) cum, Tensor(b!) work) -> "
           "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
def _ssd_bwd_op(x, dt, A, B, C, D, gy, gstate, cum, work):
    """The launch: the inputs and the scratch checked, the six gradients
    allocated, x/gy/B/C's route chosen, the kernels on the current stream,
    one count in ``ssd_bwd.launches``."""
    _check_bwd(x, dt, A, B, C, D, gy, gstate)
    b, s, h, p = x.shape
    n = B.shape[-1]
    n_cum, n_work = bwd_scratch(b, s, h, p, n, x.dtype)
    if (cum.dtype != torch.float64 or cum.numel() < n_cum
            or work.dtype != torch.float32 or work.numel() < n_work
            or not (cum.is_contiguous() and work.is_contiguous())):
        raise ValueError(f"ssd_bwd: scratch must be contiguous float64 "
                         f"[{n_cum}] and float32 [{n_work}], got {cum.dtype} "
                         f"{tuple(cum.shape)} and {work.dtype} "
                         f"{tuple(work.shape)}")
    dx, ddt, dA, dB, dC, dD = _bwd_outputs(x, B)
    tma = x.dtype == torch.bfloat16 and tma_route(x, B, C, gy)
    lib = _bwd_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), gy.data_ptr(),
            None if gstate is None else gstate.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            dD.data_ptr(), cum.data_ptr(), work.data_ptr(), b, s, h, p, n,
            x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
            dt.stride(1), B.stride(0), B.stride(1), C.stride(0), C.stride(1),
            _DTYPES[x.dtype], int(tma), stream)
    if err != 0:
        raise RuntimeError("ssd_bwd launch failed: "
                           + lib.ssd_bwd_error_string(err).decode())
    _build.count_launch(ssd_bwd)
    return dx, ddt, dA, dB, dC, dD


def _bwd_outputs(x, B):
    """(dx, ddt, dA, dB, dC, dD) as the launch allocates them: contiguous,
    dx, dB and dC in x's dtype, the others float32."""
    b, s, h, p = x.shape
    n = B.shape[-1]

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=x.device)

    return (empty((b, s, h, p), x.dtype), empty((b, s, h), torch.float32),
            empty((h,), torch.float32), empty((b, s, n), x.dtype),
            empty((b, s, n), x.dtype), empty((h,), torch.float32))


@_ssd_bwd_op.register_fake
def _ssd_bwd_fake(x, dt, A, B, C, D, gy, gstate, cum, work):
    """The outputs the launch allocates, without launching (the scratch is
    the wrapper's, so a dry-run has counted it already)."""
    return _bwd_outputs(x, B)


@register_flop_formula(torch.ops.repro_torch.ssd_bwd)
def _ssd_bwd_flops(x_shape, dt_shape, A_shape, B_shape, C_shape, D_shape,
                   gy_shape, gstate_shape, cum_shape, work_shape, *args,
                   out_shape=None, **kwargs) -> int:
    """The products the kernels run: the chunk states S_c and G_c and the
    three dH and H products (gy H, x dH, B dH^T), 10 Q p n a (b, h, chunk);
    C B^T once per (b, chunk); G, W^T gy, dS B and dS^T C, 4 Q^2 (p + n)
    a (b, h, chunk): ``PERF.md``'s bound count."""
    b, s, h, p = x_shape
    n = B_shape[-1]
    nc, Q = -(-s // CHUNK), CHUNK
    return (10 * b * h * nc * Q * p * n + 2 * b * nc * Q * Q * n
            + 4 * b * h * nc * Q * Q * (p + n))


ssd_bwd.launches = 0     # type: ignore[attr-defined]


# --------------------------------------------------------------------------- #
# autograd
# --------------------------------------------------------------------------- #
class SSDScan(torch.autograd.Function):
    """y (and the final state) of the SSD scan.

    ``apply(x, dt, A, B, C, D, return_state, forward, backward)`` where
    ``forward(x, dt, A, B, C, D, return_state=...)`` and ``backward(x, dt,
    A, B, C, D, gy, gstate)`` -> (dx, ddt, dA, dB, dC, dD) are the CUDA
    kernels' wrappers on the card (:func:`ssd_fwd`, :func:`ssd_bwd`) or
    plain versions in the tests."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, return_state, forward: Callable,
                backward: Callable):
        out = forward(x, dt, A, B, C, D, return_state=return_state)
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.return_state, ctx.backward = return_state, backward
        return out

    @staticmethod
    def backward(ctx, gy, gstate=None):
        """The gradients the inputs ask for (``needs_input_grad``), from
        the backward function on the saved inputs, gy and (with
        ``return_state``) the final state's gradient."""
        need = ctx.needs_input_grad[:6]
        if not any(need):
            return (None,) * 9
        grads = ctx.backward(*ctx.saved_tensors, gy,
                             gstate if ctx.return_state else None)
        return (*(g if nd else None for g, nd in zip(grads, need)), None,
                None, None)
