"""Distillation KL on the card: the CUDA statistics kernel's wrapper and the
autograd Function of the KL.

Counterpart of ``repro/kernels/distill_kl.py`` and
``repro/kernels/distill_kl_pallas.py``.  The kernel
(``csrc/distill_kl_fwd.cu``) replaces the TPU kernel
``distill_kl_pallas.py::_kernel``; its source says what bounds it on an
H100 and what its design does about that.  bf16 inputs go to its
tensor-core path (wgmma on TMA-fed shared memory), which needs what
:mod:`repro_torch.kernels.tma` checks; float32 inputs to its CUDA-core
path.  :func:`distill_kl_fwd` checks what it is given, allocates the four
[N] float32 outputs and the split scratch, launches on the current stream
and raises if the launch was refused.  It counts its launches in
``distill_kl_fwd.launches``.

:class:`DistillKL` is the KL as an autograd Function: its forward takes
the per-token statistics from the function :mod:`repro_torch.kernels.ops`
hands it (this kernel for CUDA tensors, the plain version
``kernels.ref.distill_kl_stats_ref`` for CPU tensors) and forms the
masked mean with :func:`_kl_from_stats`; its backward is the analytic
chunked pass of ``distill_kl.py::_distill_kl_bwd``.  Both are plain torch
here because the JAX package computes them in jnp outside the Pallas
kernel; a hand-written backward kernel is later work (ROADMAP.md, B3).
"""
from __future__ import annotations

import ctypes

import torch

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
        lib.distill_kl_fwd.argtypes = _ARGTYPES
        lib.distill_kl_fwd.restype = ctypes.c_int
        lib.distill_kl_fwd_error_string.argtypes = [ctypes.c_int]
        lib.distill_kl_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(h_s, w_s, h_t, w_t):
    xs = (("h_s", h_s), ("w_s", w_s), ("h_t", h_t), ("w_t", w_t))
    if not all(x.is_cuda for _, x in xs):
        raise ValueError("distill_kl_fwd takes CUDA tensors; CPU tensors go "
                         "to kernels.ref.distill_kl_stats_ref")
    if len({x.device for _, x in xs}) != 1:
        raise ValueError("h_s, w_s, h_t, w_t on different devices")
    if h_s.dtype not in _DTYPES or any(x.dtype != h_s.dtype for _, x in xs):
        raise TypeError(f"distill_kl_fwd takes float32 or bfloat16 inputs of "
                        f"one dtype, got {[str(x.dtype) for _, x in xs]}")
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
    if h_s.dtype == torch.bfloat16:      # the tensor-core kernel's TMA
        for name, x in xs:
            # W in whichever orientation has the contiguous dim last
            check_tma(name, x.T if name[0] == "w" and x.stride(0) == 1
                      and x.stride(1) != 1 else x)


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
    read through its strides (``embed.T`` is not copied)."""
    _check(h_s, w_s, h_t, w_t)
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
            h_t.stride(0), w_t.stride(0), w_t.stride(1), 1.0 / float(T),
            _DTYPES[h_s.dtype], stream)
    if err != 0:
        raise RuntimeError("distill_kl_fwd launch failed: "
                           + lib.distill_kl_fwd_error_string(err).decode())
    distill_kl_fwd.launches += 1
    return tuple(out)


distill_kl_fwd.launches = 0     # type: ignore[attr-defined]


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

    ``apply(h_s, w_s, h_t, w_t, mask, T, block_v, stats)`` where
    ``stats(h_s, w_s, h_t, w_t, T)`` returns (lse_s, lse_t, e_t, e_s)."""

    @staticmethod
    def forward(ctx, h_s, w_s, h_t, w_t, mask, T, block_v, stats):
        lse_s, lse_t, e_t, e_s = stats(h_s, w_s, h_t, w_t, T)
        ctx.save_for_backward(h_s, w_s, h_t, w_t, mask, lse_s, lse_t, e_t,
                              e_s)
        ctx.T, ctx.block_v = T, block_v
        return _kl_from_stats(lse_s, lse_t, e_t, e_s, mask)

    @staticmethod
    def backward(ctx, g):
        """The analytic second pass, chunked over the vocabulary:
        ``dz_s = (p_s - p_t) w / T``,
        ``dz_t = p_t ((z_t - e_t) - (z_s - e_s)) w / T``, ``dh = dz W^T``,
        ``dW = h^T dz`` with w the token weight.  Products are
        ``torch.matmul`` on float32 blocks.  W is cast one vocabulary block
        at a time, never whole: at qwen1.5-0.5b's vocabulary a float32 copy
        of both W would take about 1.2 GB.  Teacher gradients are computed
        only when autograd asks for them (the distillation step's teacher
        inputs are detached)."""
        h_s, w_s, h_t, w_t, mask, lse_s, lse_t, e_t, e_s = ctx.saved_tensors
        T, bv = ctx.T, ctx.block_v
        need_hs, need_ws, need_ht, need_wt = ctx.needs_input_grad[:4]
        N, V = h_s.shape[0], w_s.shape[1]
        if mask is not None:
            tok_w = mask.float()
            tok_w = tok_w / tok_w.sum().clamp_min(1.0)
        else:
            tok_w = torch.full((N,), 1.0 / N, dtype=torch.float32,
                               device=h_s.device)
        tok_w = (tok_w * g.float())[:, None] / T
        hs, ht = h_s.float(), h_t.float()
        dhs = torch.zeros_like(hs) if need_hs else None
        dht = torch.zeros_like(ht) if need_ht else None
        # in W's dtype and strides: each block is written once, cast as the
        # JAX package casts the whole float32 gradient at the end
        dws = torch.empty_like(w_s) if need_ws else None
        dwt = torch.empty_like(w_t) if need_wt else None
        for v0 in range(0, V, bv):
            v1 = min(v0 + bv, V)
            wsb, wtb = w_s[:, v0:v1].float(), w_t[:, v0:v1].float()
            zs = (hs @ wsb) / T
            zt = (ht @ wtb) / T
            pt = torch.exp(zt - lse_t[:, None])
            if need_hs or need_ws:
                dzs = (torch.exp(zs - lse_s[:, None]) - pt) * tok_w
                if need_hs:
                    dhs += dzs @ wsb.T
                if need_ws:
                    dws[:, v0:v1] = hs.T @ dzs
            if need_ht or need_wt:
                dzt = pt * ((zt - e_t[:, None]) - (zs - e_s[:, None])) * tok_w
                if need_ht:
                    dht += dzt @ wtb.T
                if need_wt:
                    dwt[:, v0:v1] = ht.T @ dzt
        return (None if dhs is None else dhs.to(h_s.dtype), dws,
                None if dht is None else dht.to(h_t.dtype), dwt,
                None, None, None, None)

