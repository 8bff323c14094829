"""Distillation KL on the card: the CUDA statistics and gradient kernels'
wrappers and the autograd Function of the KL.

Counterpart of ``repro/kernels/distill_kl.py`` and
``repro/kernels/distill_kl_pallas.py``.  The forward kernel
(``csrc/distill_kl_fwd.cu``) replaces the TPU kernel
``distill_kl_pallas.py::_kernel``, the backward kernel
(``csrc/distill_kl_bwd.cu``) its backward rule (``_bwd``, which runs
``distill_kl.py::_distill_kl_bwd``); each source says what bounds it on
an H100 and what its design does about that.  bf16 inputs go to their
tensor-core paths (wgmma on TMA-fed shared memory), which need what
:mod:`repro_torch.kernels.tma` checks; float32 inputs to their CUDA-core
paths.  :func:`distill_kl_fwd` checks what it is given and calls the
CUDA-only op ``repro_torch::distill_kl_fwd``, whose implementation
allocates the four [N] float32 outputs (one [4, N] tensor) and the split
scratch, launches on the current stream and raises if the launch was
refused; it counts its launches in ``distill_kl_fwd.launches``.
:func:`distill_kl_bwd` does the same for ``repro_torch::distill_kl_bwd``:
per vocabulary chunk of :func:`chunk_cols` columns the kernel writes the
logit gradients dz into a chunk buffer (the op's mutated ``dz``
argument, allocated by the wrapper, so that a dry-run counts its bytes),
and two cuBLAS products take them to ``dh += dz W^T`` (float32) and ``dW =
h^T dz`` (W's dtype and strides), as the JAX package leaves those
products to XLA; one count in ``distill_kl_bwd.launches`` a call.  Each
op's fake function allocates the same outputs without a launch, for a
dry-run on fake tensors, and its flop formula is the count ``PERF.md``'s
bound uses.

:class:`DistillKL` is the KL as an autograd Function: its forward takes
the per-token statistics from the function :mod:`repro_torch.kernels.ops`
hands it (this kernel for CUDA tensors, the plain version
``kernels.ref.distill_kl_stats_ref`` for CPU tensors) and forms the
masked mean with :func:`_kl_from_stats`; its backward forms the token
weights and takes the gradients from the function ``ops`` hands it
beside (:func:`distill_kl_bwd` for CUDA tensors, the plain version
``kernels.ref.distill_kl_bwd_ref`` for CPU tensors).
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.tma import check_tma

# (token block, vocabulary tile, blocks per SM to aim for) of each path: the
# tensor-core kernel runs one block per SM, so it splits the vocabulary
# finer to even out the last wave
TILES = {torch.bfloat16: (128, 128, 8), torch.float32: (64, 64, 4)}
BT, BV = TILES[torch.bfloat16][:2]   # the tensor-core kernel's tiles
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = _build.build("distill_kl_fwd").lib
    if lib.distill_kl_fwd.argtypes is None:
        lib.distill_kl_fwd.restype = ctypes.c_int
        lib.distill_kl_fwd_error_string.argtypes = [ctypes.c_int]
        lib.distill_kl_fwd_error_string.restype = ctypes.c_char_p
        lib.distill_kl_fwd.argtypes = _ARGTYPES    # last: other threads test it
    return lib


def _check(h_s, w_s, h_t, w_t, name="distill_kl_fwd",
           plain="distill_kl_stats_ref"):
    xs = (("h_s", h_s), ("w_s", w_s), ("h_t", h_t), ("w_t", w_t))
    if not all(x.is_cuda or x.is_meta for _, x in xs):
        raise ValueError(f"{name} takes CUDA (or a dry-run's meta) "
                         f"tensors; CPU tensors go to kernels.ref.{plain}")
    if len({x.device for _, x in xs}) != 1:
        raise ValueError("h_s, w_s, h_t, w_t on different devices")
    if h_s.dtype not in _DTYPES or any(x.dtype != h_s.dtype for _, x in xs):
        raise TypeError(f"{name} takes float32 or bfloat16 inputs of one "
                        f"dtype, got {[str(x.dtype) for _, x in xs]}")
    if any(x.dim() != 2 for _, x in xs):
        raise ValueError("expected h_s [N,Ds], w_s [Ds,V], h_t [N,Dt], "
                         "w_t [Dt,V]")
    N, Ds = h_s.shape
    Dt, V = w_t.shape
    if (h_t.shape[0] != N or w_s.shape != (Ds, V) or h_t.shape[1] != Dt
            or min(N, Ds, Dt, V) == 0):
        raise ValueError(f"shape mismatch: h_s {tuple(h_s.shape)}, w_s "
                         f"{tuple(w_s.shape)}, h_t {tuple(h_t.shape)}, w_t "
                         f"{tuple(w_t.shape)}")
    for name, x in (("h_s", h_s), ("h_t", h_t)):
        if x.stride(1) != 1:
            raise ValueError(f"{name} must be contiguous in its hidden dim")


def splits(N: int, V: int, sms: int,
           dtype: torch.dtype = torch.bfloat16) -> tuple[int, int]:
    """(nsplit, tiles_per_split) for the path that ``dtype`` takes: split
    the vocabulary tiles so that about the path's blocks per SM (``TILES``)
    are launched, and no split is empty."""
    bt, bv, per_sm = TILES[dtype]
    ntiles = -(-V // bv)
    nsplit = max(1, min(ntiles, -(-per_sm * sms // -(-N // bt))))
    per = -(-ntiles // nsplit)
    return -(-ntiles // per), per


def distill_kl_fwd(h_s: torch.Tensor, w_s: torch.Tensor, h_t: torch.Tensor,
                   w_t: torch.Tensor, T: float = 1.0):
    """h_s [N,Ds], w_s [Ds,V], h_t [N,Dt], w_t [Dt,V] on one CUDA device ->
    float32 [N] each: (lse_s, lse_t, e_t, e_s) of ``z = h W / T``.  W is
    read through its strides (``embed.T`` is not copied).  Checks its
    inputs and calls the op ``repro_torch::distill_kl_fwd``, whose one
    [4, N] output the four rows are views of."""
    _check(h_s, w_s, h_t, w_t)
    return tuple(torch.ops.repro_torch.distill_kl_fwd(h_s, w_s, h_t, w_t,
                                                      1.0 / float(T)))


@torch.library.custom_op(
    "repro_torch::distill_kl_fwd", mutates_args=(), device_types="cuda",
    schema="(Tensor h_s, Tensor w_s, Tensor h_t, Tensor w_t, float inv_t) "
           "-> Tensor")
def _distill_kl_fwd_op(h_s, w_s, h_t, w_t, inv_t):
    """The launch: TMA's preconditions on bf16 inputs, the split scratch
    and the [4, N] output allocated, the kernel on the current stream, one
    count in ``distill_kl_fwd.launches``."""
    if h_s.dtype == torch.bfloat16:      # the tensor-core kernel's TMA
        for name, x in (("h_s", h_s), ("w_s", w_s), ("h_t", h_t),
                        ("w_t", w_t)):
            # W in whichever orientation has the contiguous dim last
            check_tma(name, x.T if name[0] == "w" and x.stride(0) == 1
                      and x.stride(1) != 1 else x)
    N, Ds = h_s.shape
    Dt, V = w_t.shape
    dev = h_s.device
    nsplit, per = splits(N, V,
                         torch.cuda.get_device_properties(dev)
                         .multi_processor_count, h_s.dtype)
    part = torch.empty((6, nsplit, N), dtype=torch.float32, device=dev)
    out = torch.empty((4, N), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.distill_kl_fwd(
            h_s.data_ptr(), w_s.data_ptr(), h_t.data_ptr(), w_t.data_ptr(),
            part.data_ptr(), *(o.data_ptr() for o in out), N, Ds, Dt, V,
            nsplit, per, h_s.stride(0), w_s.stride(0), w_s.stride(1),
            h_t.stride(0), w_t.stride(0), w_t.stride(1), float(inv_t),
            _DTYPES[h_s.dtype], stream)
    if err != 0:
        raise RuntimeError("distill_kl_fwd launch failed: "
                           + lib.distill_kl_fwd_error_string(err).decode())
    _build.count_launch(distill_kl_fwd)
    return out


@_distill_kl_fwd_op.register_fake
def _distill_kl_fwd_fake(h_s, w_s, h_t, w_t, inv_t):
    """The output the launch allocates, without launching."""
    return torch.empty((4, h_s.shape[0]), dtype=torch.float32,
                       device=h_s.device)


@register_flop_formula(torch.ops.repro_torch.distill_kl_fwd)
def _distill_kl_fwd_flops(h_s_shape, w_s_shape, h_t_shape, w_t_shape, inv_t,
                          *args, out_shape=None, **kwargs) -> int:
    """The two logit products, 2 N V (Ds + Dt): ``PERF.md``'s bound
    count."""
    N, Ds = h_s_shape
    Dt, V = w_t_shape
    return 2 * N * V * (Ds + Dt)


distill_kl_fwd.launches = 0     # type: ignore[attr-defined]


# --------------------------------------------------------------------------- #
# Backward: the dz kernel's wrapper and op
# --------------------------------------------------------------------------- #
#: the chunk buffer's cap: dz of every side asked for, [N, Vc] each
CHUNK_BYTES = 512 * 2 ** 20
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                 + [ctypes.c_longlong] * 6
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.build("distill_kl_bwd").lib
    if lib.distill_kl_bwd.argtypes is None:
        lib.distill_kl_bwd.restype = ctypes.c_int
        lib.distill_kl_bwd_error_string.argtypes = [ctypes.c_int]
        lib.distill_kl_bwd_error_string.restype = ctypes.c_char_p
        lib.distill_kl_bwd.argtypes = _BWD_ARGTYPES  # last: threads test it
    return lib


def chunk_cols(N: int, V: int, dtype: torch.dtype, sides: int = 1) -> int:
    """Vc, the columns of a vocabulary chunk: the largest multiple of 128
    with ``sides`` [N, Vc] buffers of ``dtype`` within CHUNK_BYTES (32768
    at N = 8192 in bf16, one side), at least 128 and no more than V needs."""
    elt = torch.empty((), dtype=dtype).element_size()
    vc = CHUNK_BYTES // (sides * N * elt) // BV * BV
    return min(max(vc, BV), -(-V // BV) * BV)


def _check_bwd(h_s, w_s, h_t, w_t, stats, tok_w):
    """``_check``'s h and W, and the forward's statistics and the token
    weight: float32 [N] each, contiguous, on h's device."""
    _check(h_s, w_s, h_t, w_t, "distill_kl_bwd", "distill_kl_bwd_ref")
    N = h_s.shape[0]
    for name, x in zip(("lse_s", "lse_t", "e_t", "e_s", "tok_w"),
                       (*stats, tok_w)):
        if (x.shape != (N,) or x.dtype != torch.float32
                or x.device != h_s.device or not x.is_contiguous()):
            raise ValueError(
                f"distill_kl_bwd: {name} must be a contiguous float32 tensor "
                f"of shape ({N},) on h_s's device, got {x.dtype} "
                f"{tuple(x.shape)} strides {x.stride()} on {x.device}")


def distill_kl_bwd(h_s, w_s, h_t, w_t, lse_s, lse_t, e_t, e_s, tok_w,
                   T: float = 1.0, *, needs=(True, True, False, False)):
    """The gradients of the KL -> (dh_s, dw_s, dh_t, dw_t), None where
    ``needs`` (one flag an input) says no; dh in h's dtype, dW in W's dtype
    and strides.  ``tok_w`` [N] float32 is each token's weight, ``mask /
    max(sum mask, 1) g / T``; (lse_s, lse_t, e_t, e_s) are the forward's.

    CUDA (and a dry-run's meta) tensors only: it checks its inputs,
    allocates the chunk buffer ([sides, N, chunk_cols] in the inputs'
    dtype) and calls the op ``repro_torch::distill_kl_bwd``.  CPU tensors
    go to the plain version, ``kernels.ref.distill_kl_bwd_ref``
    (:mod:`repro_torch.kernels.ops` picks)."""
    _check_bwd(h_s, w_s, h_t, w_t, (lse_s, lse_t, e_t, e_s), tok_w)
    need_hs, need_ws, need_ht, need_wt = (bool(n) for n in needs)
    sides = int(need_hs or need_ws) + int(need_ht or need_wt)
    if sides == 0:
        return None, None, None, None
    N, V = h_s.shape[0], w_s.shape[1]
    dz = torch.empty((sides, N, chunk_cols(N, V, h_s.dtype, sides)),
                     dtype=h_s.dtype, device=h_s.device)
    dhs, dws, dht, dwt = torch.ops.repro_torch.distill_kl_bwd(
        h_s, w_s, h_t, w_t, lse_s, lse_t, e_t, e_s, tok_w, dz,
        1.0 / float(T), need_hs, need_ws, need_ht, need_wt)
    return (dhs.to(h_s.dtype) if need_hs else None,
            dws if need_ws else None,
            dht.to(h_t.dtype) if need_ht else None,
            dwt if need_wt else None)


def _products(h, w, dz, dh, dw, v0: int, vc: int) -> None:
    """One chunk's products: ``dh += dz W[:, chunk]^T`` in float32, and
    ``dW[:, chunk] = h^T dz`` written in W's dtype and strides (for a tied
    ``embed.T``, ``dz^T h`` into the embedding's rows: nothing is
    transposed or copied).  Either may be None."""
    if dh is not None:
        wc = w[:, v0:v0 + vc].T
        if dz.dtype == torch.float32:
            dh.addmm_(dz, wc)
        else:
            torch.addmm(dh, dz, wc, out_dtype=torch.float32, out=dh)
    if dw is not None:
        out = dw[:, v0:v0 + vc]
        if out.stride(0) == 1:
            torch.mm(dz.T, h, out=out.T)
        else:
            torch.mm(h.T, dz, out=out)


@torch.library.custom_op(
    "repro_torch::distill_kl_bwd", mutates_args=("dz",), device_types="cuda",
    schema="(Tensor h_s, Tensor w_s, Tensor h_t, Tensor w_t, Tensor lse_s, "
           "Tensor lse_t, Tensor e_t, Tensor e_s, Tensor tok_w, "
           "Tensor(a!) dz, float inv_t, bool need_hs, bool need_ws, "
           "bool need_ht, bool need_wt) -> (Tensor, Tensor, Tensor, Tensor)")
def _distill_kl_bwd_op(h_s, w_s, h_t, w_t, lse_s, lse_t, e_t, e_s, tok_w,
                       dz, inv_t, need_hs, need_ws, need_ht, need_wt):
    """The launch: the inputs checked (TMA's preconditions on bf16 h and W),
    dh (float32) and dW (W's dtype and strides) allocated, and for each
    chunk of ``dz.shape[2]`` columns the dz kernel then the products on the
    current stream; one count in ``distill_kl_bwd.launches``.  An output
    that is not asked for is an empty tensor."""
    _check_bwd(h_s, w_s, h_t, w_t, (lse_s, lse_t, e_t, e_s), tok_w)
    if h_s.dtype == torch.bfloat16:      # the tensor-core kernel's TMA
        for name, x in (("h_s", h_s), ("w_s", w_s), ("h_t", h_t),
                        ("w_t", w_t)):
            check_tma(name, x.T if name[0] == "w" and x.stride(0) == 1
                      and x.stride(1) != 1 else x)
    N, Ds = h_s.shape
    Dt, V = w_t.shape
    need_s, need_t = need_hs or need_ws, need_ht or need_wt
    Vc = dz.shape[2]
    if (dz.dtype != h_s.dtype or dz.device != h_s.device
            or not dz.is_contiguous() or dz.shape[:2]
            != (int(need_s) + int(need_t), N) or Vc % BV):
        raise ValueError(f"distill_kl_bwd: dz must be a contiguous "
                         f"{h_s.dtype} [sides, {N}, 128 k] buffer, got "
                         f"{dz.dtype} {tuple(dz.shape)}")
    outs = _bwd_outputs(h_s, w_s, h_t, w_t, need_hs, need_ws, need_ht,
                        need_wt)
    dhs, dws, dht, dwt = (x if n else None for x, n in
                          zip(outs, (need_hs, need_ws, need_ht, need_wt)))
    for dh in (dhs, dht):
        if dh is not None:
            dh.zero_()
    dzs = dz[0] if need_s else None
    dzt = dz[int(need_s)] if need_t else None
    with torch.cuda.device(h_s.device):
        for v0 in range(0, V, Vc):
            vc = min(Vc, V - v0)
            launch_dz(h_s, w_s, h_t, w_t, (lse_s, lse_t, e_t, e_s), tok_w,
                      dzs, dzt, v0, vc, inv_t)
            if need_s:
                _products(h_s, w_s, dzs[:, :vc], dhs, dws, v0, vc)
            if need_t:
                _products(h_t, w_t, dzt[:, :vc], dht, dwt, v0, vc)
    _build.count_launch(distill_kl_bwd)
    return outs


def launch_dz(h_s, w_s, h_t, w_t, stats, tok_w, dzs, dzt, v0: int, vc: int,
              inv_t: float) -> None:
    """The dz kernel alone on one chunk, on the current stream: columns
    [v0, v0 + vc) into the first vc columns of the [N, ldz] buffers dzs and
    dzt (either None), for the op and for timing it apart from the
    products; raises if the launch is refused.  Counts nothing."""
    dz = dzs if dzs is not None else dzt
    N, Ds = h_s.shape
    Dt, V = w_t.shape
    lib = _bwd_lib()
    sms = torch.cuda.get_device_properties(h_s.device).multi_processor_count
    _, per = splits(N, vc, sms, h_s.dtype)
    err = lib.distill_kl_bwd(
        h_s.data_ptr(), w_s.data_ptr(), h_t.data_ptr(), w_t.data_ptr(),
        *(x.data_ptr() for x in (*stats, tok_w)),
        dzs.data_ptr() if dzs is not None else None,
        dzt.data_ptr() if dzt is not None else None,
        N, Ds, Dt, V, v0, vc, dz.stride(0), per, h_s.stride(0),
        w_s.stride(0), w_s.stride(1), h_t.stride(0), w_t.stride(0),
        w_t.stride(1), float(inv_t), _DTYPES[h_s.dtype],
        torch.cuda.current_stream(h_s.device).cuda_stream)
    if err != 0:
        raise RuntimeError("distill_kl_bwd launch failed: "
                           + lib.distill_kl_bwd_error_string(err).decode())


def _bwd_outputs(h_s, w_s, h_t, w_t, need_hs, need_ws, need_ht, need_wt):
    """(dh_s, dw_s, dh_t, dw_t) as the launch allocates them: dh float32,
    dW like W (``empty_like`` keeps an ``embed.T``'s strides), an output
    not asked for empty."""
    def dh(h, need):
        return torch.empty(h.shape if need else (0,), dtype=torch.float32,
                           device=h.device)

    def dw(w, need):
        return (torch.empty_like(w) if need
                else torch.empty((0,), dtype=w.dtype, device=w.device))

    return (dh(h_s, need_hs), dw(w_s, need_ws), dh(h_t, need_ht),
            dw(w_t, need_wt))


@_distill_kl_bwd_op.register_fake
def _distill_kl_bwd_fake(h_s, w_s, h_t, w_t, lse_s, lse_t, e_t, e_s, tok_w,
                         dz, inv_t, need_hs, need_ws, need_ht, need_wt):
    """The outputs the launch allocates, without launching (the chunk
    buffer is the wrapper's, so a dry-run has counted it already)."""
    return _bwd_outputs(h_s, w_s, h_t, w_t, need_hs, need_ws, need_ht,
                        need_wt)


@register_flop_formula(torch.ops.repro_torch.distill_kl_bwd)
def _distill_kl_bwd_flops(h_s_shape, w_s_shape, h_t_shape, w_t_shape,
                          lse_s_shape, lse_t_shape, e_t_shape, e_s_shape,
                          tok_w_shape, dz_shape, inv_t, need_hs, need_ws,
                          need_ht, need_wt, *args, out_shape=None,
                          **kwargs) -> int:
    """The two logit products recomputed, 2 N V (Ds + Dt), and 2 N V D for
    each of dh and dW asked for (4 N V Ds on the student side): the count
    ``PERF.md``'s bound uses."""
    N, Ds = h_s_shape
    Dt, V = w_t_shape
    return 2 * N * V * (Ds + Dt + (int(need_hs) + int(need_ws)) * Ds
                        + (int(need_ht) + int(need_wt)) * Dt)


distill_kl_bwd.launches = 0     # type: ignore[attr-defined]


def _kl_from_stats(lse_s, lse_t, e_t, e_s, mask=None) -> torch.Tensor:
    """Masked-mean KL(p_t || p_s) from the per-token statistics
    (``repro/kernels/distill_kl.py::_kl_from_stats``)."""
    kl = e_t - lse_t - e_s + lse_s
    if mask is not None:
        m = mask.float()
        return (kl * m).sum() / m.sum().clamp_min(1.0)
    return kl.mean()


class DistillKL(torch.autograd.Function):
    """KL(p_t || p_s), token mean, from hidden states and unembeddings.

    ``apply(h_s, w_s, h_t, w_t, mask, T, stats, grads)`` where
    ``stats(h_s, w_s, h_t, w_t, T)`` returns (lse_s, lse_t, e_t, e_s) and
    ``grads(h_s, w_s, h_t, w_t, lse_s, lse_t, e_t, e_s, tok_w, T,
    needs=)`` returns (dh_s, dw_s, dh_t, dw_t), None where ``needs`` (one
    flag an input) says no."""

    @staticmethod
    def forward(ctx, h_s, w_s, h_t, w_t, mask, T, stats, grads):
        lse_s, lse_t, e_t, e_s = stats(h_s, w_s, h_t, w_t, T)
        ctx.save_for_backward(h_s, w_s, h_t, w_t, mask, lse_s, lse_t, e_t,
                              e_s)
        ctx.T, ctx.grads = T, grads
        return _kl_from_stats(lse_s, lse_t, e_t, e_s, mask)

    @staticmethod
    def backward(ctx, g):
        """The token weight ``w = mask / max(sum mask, 1) g / T`` (``g / (N
        T)`` without a mask), then the gradients of the analytic second pass of
        ``distill_kl.py::_distill_kl_bwd``.  Teacher gradients are computed
        only when autograd asks for them (the distillation step's teacher
        inputs are detached)."""
        h_s, w_s, h_t, w_t, mask, lse_s, lse_t, e_t, e_s = ctx.saved_tensors
        N = h_s.shape[0]
        if mask is not None:
            tok_w = mask.float()
            tok_w = tok_w / tok_w.sum().clamp_min(1.0)
        else:
            tok_w = torch.full((N,), 1.0 / N, dtype=torch.float32,
                               device=h_s.device)
        tok_w = tok_w * g.float() / ctx.T
        dhs, dws, dht, dwt = ctx.grads(h_s, w_s, h_t, w_t, lse_s, lse_t, e_t,
                                       e_s, tok_w, ctx.T,
                                       needs=tuple(ctx.needs_input_grad[:4]))
        return dhs, dws, dht, dwt, None, None, None, None
