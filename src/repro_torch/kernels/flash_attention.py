"""Flash attention forward: the CUDA kernel's wrapper.

The kernel (``csrc/flash_fwd.cu``) replaces the TPU kernel
``repro/kernels/flash_attention.py::_fwd_kernel``; its source says what
bounds it on an H100 and what its design does about that.  This wrapper
checks what it is given, allocates ``o`` and ``lse``, launches on the
current stream and raises if the launch was refused.  It counts its
launches in ``flash_fwd.launches``.

The plain version is :func:`repro_torch.kernels.ref.flash_attention_ref`;
:mod:`repro_torch.kernels.ops` routes CPU tensors there and CUDA tensors
here.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

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
    -> (o [B,S,H,D] in q's dtype, lse [B,S,H] float32)."""
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
