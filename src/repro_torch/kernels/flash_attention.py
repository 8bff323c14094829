"""Flash attention on the card: the CUDA forward's wrapper and the
autograd Functions around it.

The kernel (``csrc/flash_fwd.cu``) replaces the TPU kernel
``repro/kernels/flash_attention.py::_fwd_kernel``; its source says what
bounds it on an H100 and what its design does about that.  bf16 inputs go
to its tensor-core path (wgmma on TMA-fed shared memory), which needs
what :mod:`repro_torch.kernels.tma` checks; float32 inputs to its
CUDA-core path.
:func:`flash_fwd` checks what it is given, allocates ``o`` and ``lse``,
launches on the current stream and raises if the launch was refused.  It
counts its launches in ``flash_fwd.launches``.

:class:`FlashAttention` (-> o) and :class:`FlashAttentionLse`
(-> (o, lse)) give the kernel a gradient.  Their backward,
:func:`flash_bwd`, is a port of ``repro/kernels/ref.py::_flash_bwd_core``
in torch ops: the JAX package computes this backward in jnp outside any
Pallas kernel (``repro/kernels/flash_attention.py:203-235``), so plain
PyTorch here is its counterpart, not a fallback.  A hand-written backward
kernel is later work (ROADMAP.md, B2).

The plain version of the forward is
:func:`repro_torch.kernels.ref.flash_attention_ref`;
:mod:`repro_torch.kernels.ops` routes CPU tensors there and CUDA tensors
through the Functions here.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tma import check_tma

HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9
             + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    built = _build.build("flash_fwd")
    lib = built.lib
    if lib.flash_fwd.argtypes is None:
        lib.flash_fwd.argtypes = _ARGTYPES
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, kv_positions):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_fwd takes CUDA tensors; CPU tensors go to "
                         "kernels.ref.flash_attention_ref")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,S,H,D] and k, v [B,T,KV,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    _, T, KV, Dk = k.shape
    if k.shape[0] != B or Dk != D or KV == 0 or H % KV:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)} (need equal B and D, "
                         f"H % KV == 0)")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not built; supported: {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        if x.dtype == torch.bfloat16:    # the tensor-core kernel's TMA
            check_tma(name, x)
    if kv_positions is not None:
        if (kv_positions.shape != (T,) or kv_positions.dtype != torch.int32
                or kv_positions.device != q.device
                or not kv_positions.is_contiguous()):
            raise ValueError("kv_positions must be a contiguous int32 [T] "
                             "tensor on q's device")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              scale: Optional[float] = None, q_offset: int = 0,
              kv_positions: Optional[torch.Tensor] = None):
    """q [B,S,H,D], k/v [B,T,KV,D] on one CUDA device
    -> (o [B,S,H,D] in q's dtype, lse [B,S,H] float32).

    The result carries no gradient: a call that autograd would record
    raises, so that a training step cannot lose attention's gradient
    silently.  Differentiable callers go through :class:`FlashAttention`
    or :class:`FlashAttentionLse` (``kernels.ops`` does)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_fwd has no gradient of its own: differentiate through "
            "kernels.ops.flash_attention[_lse] (the FlashAttention "
            "Functions)")
    _check(q, k, v, kv_positions)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kv_positions.data_ptr() if kv_positions is not None else None,
            o.data_ptr(), lse.data_ptr(), B, S, T, H, KV, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), int(bool(causal)), int(window), int(q_offset),
            _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.flash_fwd_error_string(err).decode())
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0     # type: ignore[attr-defined]


# --------------------------------------------------------------------------- #
# Backward (blockwise recompute) and the autograd Functions
# --------------------------------------------------------------------------- #
BWD_BLOCK = 512


def flash_bwd(q, k, v, o, lse, do, dlse=None, *, causal: bool = True,
              window: int = 0, scale: Optional[float] = None,
              q_offset: int = 0, kv_positions: Optional[torch.Tensor] = None,
              block: int = BWD_BLOCK):
    """Blockwise-recompute flash backward -> (dq, dk, dv) in the inputs'
    dtypes; port of ``repro/kernels/ref.py::_flash_bwd_core``.

    float32 throughout.  ``delta = sum(do * o) - dlse`` per row (``dlse``
    is the cotangent of lse, None when only o was used); per (q block,
    kv block) the probabilities are recomputed from lse with the
    difference-based masks, ``ds = p (dp - delta) scale``, and dk/dv are
    summed over the G query heads of each KV head.  Masked probabilities
    are exactly 0, so rows with no visible key give zero gradient
    (ROADMAP.md, C1).  Blocks that no row can see are skipped when the key
    positions are implicit."""
    B, S, H, D = q.shape
    _, T, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    dev = q.device

    def heads_first(x):                        # [B,S,H,.] -> [B,KV,G,S,.]
        return x.float().reshape(B, S, KV, G, -1).permute(0, 2, 3, 1, 4)

    qf, dof = heads_first(q), heads_first(do)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]          # [B,KV,1,T,D]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    delta = (do.float() * o.float()).sum(-1)                # [B,S,H]
    if dlse is not None:
        delta = delta - dlse.float()
    lse_r = heads_first(lse[..., None])                     # [B,KV,G,S,1]
    delta_r = heads_first(delta[..., None])
    dq = torch.zeros_like(qf)
    dk = torch.zeros((B, KV, T, D), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    kv_pos = (kv_positions.to(device=dev, dtype=torch.int64)
              if kv_positions is not None else None)
    for q0 in range(0, S, block):
        q1 = min(q0 + block, S)
        q_pos = torch.arange(q0, q1, device=dev) + q_offset
        for k0 in range(0, T, block):
            k1 = min(k0 + block, T)
            if kv_pos is None:
                if causal and k0 > q1 - 1 + q_offset:
                    continue
                if window > 0 and q0 + q_offset - (k1 - 1) >= window:
                    continue
                kp = torch.arange(k0, k1, device=dev)
            else:
                kp = kv_pos[k0:k1]
            diff = q_pos[:, None] - kp[None, :]
            vis = torch.ones_like(diff, dtype=torch.bool)
            if causal:
                vis &= diff >= 0
            if window > 0:
                vis &= diff < window
            qb, dob = qf[:, :, :, q0:q1], dof[:, :, :, q0:q1]
            kb, vb = kf[:, :, :, k0:k1], vf[:, :, :, k0:k1]
            s = (qb * scale) @ kb.transpose(-1, -2)          # [B,KV,G,bq,bk]
            p = torch.exp(s - lse_r[:, :, :, q0:q1]).masked_fill(~vis, 0.0)
            dp = dob @ vb.transpose(-1, -2)
            ds = p * (dp - delta_r[:, :, :, q0:q1]) * scale
            dq[:, :, :, q0:q1] += ds @ kb
            dk[:, :, k0:k1] += (ds.transpose(-1, -2) @ qb).sum(2)
            dv[:, :, k0:k1] += (p.transpose(-1, -2) @ dob).sum(2)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def _save(ctx, q, k, v, o, lse, kv_positions, causal, window, scale,
          q_offset):
    ctx.save_for_backward(q, k, v, o, lse, kv_positions)
    ctx.kw = dict(causal=causal, window=window, scale=scale,
                  q_offset=q_offset)


def _grads(ctx, do, dlse):
    q, k, v, o, lse, kv_positions = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, o, lse, do, dlse,
                           kv_positions=kv_positions, **ctx.kw)
    return dq, dk, dv, None, None, None, None, None


class FlashAttention(torch.autograd.Function):
    """o = flash attention of (q, k, v): the CUDA forward, the blockwise
    backward :func:`flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, kv_positions, causal, window, scale, q_offset):
        o, lse = flash_fwd(q, k, v, causal=causal, window=window,
                           scale=scale, q_offset=q_offset,
                           kv_positions=kv_positions)
        _save(ctx, q, k, v, o, lse, kv_positions, causal, window, scale,
              q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        return _grads(ctx, do, None)


class FlashAttentionLse(torch.autograd.Function):
    """(o, lse) of flash attention; the backward takes the lse cotangent
    too (``delta = sum(do * o) - dlse``)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_positions, causal, window, scale, q_offset):
        o, lse = flash_fwd(q, k, v, causal=causal, window=window,
                           scale=scale, q_offset=q_offset,
                           kv_positions=kv_positions)
        _save(ctx, q, k, v, o, lse, kv_positions, causal, window, scale,
              q_offset)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        return _grads(ctx, do, dlse)
