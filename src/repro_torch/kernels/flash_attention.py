"""Flash attention on the card: the CUDA forward's and backward's wrappers
and the autograd Functions around them.

The forward kernel (``csrc/flash_fwd.cu``) replaces the TPU kernel
``repro/kernels/flash_attention.py::_fwd_kernel``, the backward kernels
(``csrc/flash_bwd.cu``) its backward rule (``_bwd_vjp`` and
``_bwd_lse_vjp``, which run ``repro/kernels/ref.py::_flash_bwd_core``);
each source says what bounds it on an H100 and what its design does
about that.  bf16 inputs go to their tensor-core paths (wgmma on TMA-fed
shared memory), which need what :mod:`repro_torch.kernels.tma` checks;
float32 inputs to their CUDA-core paths.
:func:`flash_fwd` checks what it is given and calls the CUDA-only op
``repro_torch::flash_fwd`` (``torch.library.custom_op``), whose
implementation allocates ``o`` and ``lse``, launches on the current stream
and raises if the launch was refused; it counts its launches in
``flash_fwd.launches``.  :func:`flash_bwd` does the same for
``repro_torch::flash_bwd`` (dq, dk, dv and a float32 delta scratch; three
kernels a launch, counted once in ``flash_bwd.launches``).  Each op's fake
function allocates the same outputs without a launch, so a dry-run on
fake tensors (``launch.dryrun``) traces the kernel route and counts the
kernels' own outputs, and its flop formula is the count ``PERF.md``'s
bound uses.

:class:`FlashAttention` (-> o) and :class:`FlashAttentionLse`
(-> (o, lse)) give the kernel a gradient through :func:`flash_bwd`.

The plain versions are :func:`repro_torch.kernels.ref.flash_attention_ref`
and :func:`repro_torch.kernels.ref.flash_bwd_ref`;
:mod:`repro_torch.kernels.ops` routes CPU tensors to the former and CUDA
tensors through the Functions here, and :func:`flash_bwd` sends CPU
tensors to the latter.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, ref
from repro_torch.kernels.tma import check_tma

HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9
             + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                 + [ctypes.c_longlong] * 9
                 + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _lib(name: str = "flash_fwd", argtypes=_ARGTYPES) -> ctypes.CDLL:
    lib = _build.build(name).lib
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        fn.argtypes = argtypes    # last: other threads test it
    return lib


def _check(q, k, v, kv_positions, name="flash_fwd",
           plain="flash_attention_ref"):
    if not all(x.is_cuda or x.is_meta for x in (q, k, v)):
        raise ValueError(f"{name} takes CUDA (or a dry-run's meta) "
                         f"tensors; CPU tensors go to kernels.ref.{plain}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 q/k/v of one "
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
    -> (o [B,S,H,D] in q's dtype, lse [B,S,H] float32).

    Checks its inputs and calls the op ``repro_torch::flash_fwd``, which
    launches the kernel (a fake or meta tensor gets
    :func:`_flash_fwd_fake`'s outputs instead).  The result carries no gradient: a call that
    autograd would record raises, so that a training step cannot lose
    attention's gradient silently.  Differentiable callers go through
    :class:`FlashAttention` or :class:`FlashAttentionLse` (``kernels.ops``
    does)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_fwd has no gradient of its own: differentiate through "
            "kernels.ops.flash_attention[_lse] (the FlashAttention "
            "Functions)")
    _check(q, k, v, kv_positions)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return torch.ops.repro_torch.flash_fwd(q, k, v, kv_positions,
                                           bool(causal), int(window),
                                           float(scale), int(q_offset))


@torch.library.custom_op(
    "repro_torch::flash_fwd", mutates_args=(), device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, Tensor? kv_positions, "
           "bool causal, int window, float scale, int q_offset) "
           "-> (Tensor, Tensor)")
def _flash_fwd_op(q, k, v, kv_positions, causal, window, scale, q_offset):
    """The launch: TMA's preconditions on bf16 inputs, o and lse allocated,
    the kernel on the current stream, one count in ``flash_fwd.launches``."""
    if q.dtype == torch.bfloat16:        # the tensor-core kernel's TMA
        for name, x in (("q", q), ("k", k), ("v", v)):
            check_tma(name, x)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
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
    _build.count_launch(flash_fwd)
    return o, lse


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, kv_positions, causal, window, scale, q_offset):
    """The outputs the launch allocates, without launching: what a dry-run
    on fake tensors sees of the kernel."""
    B, S, H, D = q.shape
    return (torch.empty((B, S, H, D), dtype=q.dtype, device=q.device),
            torch.empty((B, S, H), dtype=torch.float32, device=q.device))


def visible_pairs(S: int, T: int, causal: bool, window: int,
                  q_offset: int = 0) -> int:
    """The (query row, key column) pairs the kernel computes with implicit
    key positions ``arange(T)``: the work its operation count scales
    with."""
    total = 0
    for s in range(S):
        pos = s + q_offset
        hi = min(T - 1, pos) if causal else T - 1
        lo = max(0, pos - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def _head_pairs(q_shape, k_shape, kv_positions_shape, causal, window,
                q_offset) -> int:
    """B H D times the visible pairs; explicit key positions count every
    pair."""
    B, S, H, D = q_shape
    T = k_shape[1]
    pairs = (S * T if kv_positions_shape is not None
             else visible_pairs(S, T, causal, window, q_offset))
    return B * H * D * pairs


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _flash_fwd_flops(q_shape, k_shape, v_shape, kv_positions_shape, causal,
                     window, scale, q_offset, *args, out_shape=None,
                     **kwargs) -> int:
    """4 B H D per visible pair (q k^T and p v), the count ``PERF.md``'s
    bound column uses; explicit key positions count every pair."""
    return 4 * _head_pairs(q_shape, k_shape, kv_positions_shape, causal,
                           window, q_offset)


flash_fwd.launches = 0     # type: ignore[attr-defined]


# --------------------------------------------------------------------------- #
# Backward: the CUDA kernels' wrapper and op, and the autograd Functions
# --------------------------------------------------------------------------- #
def _check_bwd(q, k, v, o, lse, dout, dlse, kv_positions):
    """What the backward's op takes: ``_check``'s q/k/v, o and do of q's
    shape and dtype, lse (and dlse) float32 [B,S,H], all contiguous but
    q/k/v."""
    _check(q, k, v, kv_positions, "flash_bwd", "flash_bwd_ref")
    B, S, H, _ = q.shape
    for name, x, shape, dtype in (("o", o, q.shape, q.dtype),
                                  ("do", dout, q.shape, q.dtype),
                                  ("lse", lse, (B, S, H), torch.float32),
                                  ("dlse", dlse, (B, S, H), torch.float32)):
        if x is None and name == "dlse":
            continue
        if (x.shape != shape or x.dtype != dtype or x.device != q.device
                or not x.is_contiguous()):
            raise ValueError(
                f"flash_bwd: {name} must be a contiguous {dtype} tensor of "
                f"shape {tuple(shape)} on q's device, got {x.dtype} "
                f"{tuple(x.shape)} strides {x.stride()} on {x.device}")


def flash_bwd(q, k, v, o, lse, do, dlse=None, *, causal: bool = True,
              window: int = 0, scale: Optional[float] = None,
              q_offset: int = 0, kv_positions: Optional[torch.Tensor] = None):
    """The backward of :func:`flash_fwd` -> (dq, dk, dv) in q's dtype;
    ``do`` is o's cotangent, ``dlse`` lse's (None when only o was used).

    CUDA (and a dry-run's meta) tensors go to the op
    ``repro_torch::flash_bwd``, which launches ``csrc/flash_bwd.cu``; CPU
    tensors to the plain version, ``kernels.ref.flash_bwd_ref``.  ``do``
    and ``dlse`` are made contiguous (and ``dlse`` float32) only where they
    are not."""
    if not (q.is_cuda or q.is_meta):
        return ref.flash_bwd_ref(q, k, v, o, lse, do, dlse, causal=causal,
                                 window=window, scale=scale,
                                 q_offset=q_offset, kv_positions=kv_positions)
    if not do.is_contiguous():
        do = do.contiguous()
    if dlse is not None and (dlse.dtype != torch.float32
                             or not dlse.is_contiguous()):
        dlse = dlse.float().contiguous()
    _check_bwd(q, k, v, o, lse, do, dlse, kv_positions)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return torch.ops.repro_torch.flash_bwd(q, k, v, o, lse, do, dlse,
                                           kv_positions, bool(causal),
                                           int(window), float(scale),
                                           int(q_offset))


@torch.library.custom_op(
    "repro_torch::flash_bwd", mutates_args=(), device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, "
           "Tensor dout, Tensor? dlse, Tensor? kv_positions, bool causal, "
           "int window, float scale, int q_offset) "
           "-> (Tensor, Tensor, Tensor)")
def _flash_bwd_op(q, k, v, o, lse, dout, dlse, kv_positions, causal, window,
                  scale, q_offset):
    """The launch: the inputs checked (TMA's preconditions on bf16 q, k, v,
    o and do), dq/dk/dv and the f32 delta scratch allocated, the three
    kernels on the current stream, one count in ``flash_bwd.launches``."""
    _check_bwd(q, k, v, o, lse, dout, dlse, kv_positions)
    if q.dtype == torch.bfloat16:        # TMA, and the delta's 16-byte loads
        for name, x in (("q", q), ("k", k), ("v", v), ("o", o), ("do", dout)):
            check_tma(name, x)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, T, KV, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, T, KV, D), dtype=v.dtype, device=q.device)
    if dq.numel() == 0 or dk.numel() == 0:    # no pair: zero gradients
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    lib = _lib("flash_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), dout.data_ptr(),
            dlse.data_ptr() if dlse is not None else None,
            kv_positions.data_ptr() if kv_positions is not None else None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            B, S, T, H, KV, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), int(bool(causal)), int(window), int(q_offset),
            _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError("flash_bwd launch failed: "
                           + lib.flash_bwd_error_string(err).decode())
    _build.count_launch(flash_bwd)
    return dq, dk, dv


@_flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, o, lse, dout, dlse, kv_positions, causal,
                    window, scale, q_offset):
    """dq, dk, dv as the launch allocates them, without launching (the
    delta scratch lives inside the launch and is not an output)."""
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty(k.shape, dtype=k.dtype, device=q.device),
            torch.empty(v.shape, dtype=v.dtype, device=q.device))


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _flash_bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape,
                     do_shape, dlse_shape, kv_positions_shape, causal,
                     window, scale, q_offset, *args, out_shape=None,
                     **kwargs) -> int:
    """10 B H D per visible pair (the five products s = q k^T, dp = do
    v^T, dq = ds k, dk = ds^T q, dv = p^T do): the same pairs as the
    forward's count, 2.5 times it, and the count ``PERF.md``'s bound
    uses.  The kernels recompute s and dp for dq (seven products a pair);
    the bound counts the work, not the recompute."""
    return 10 * _head_pairs(q_shape, k_shape, kv_positions_shape, causal,
                            window, q_offset)


flash_bwd.launches = 0     # type: ignore[attr-defined]


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
    """o = flash attention of (q, k, v): the CUDA forward and backward
    (:func:`flash_fwd`, :func:`flash_bwd`)."""

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


def merge_flash_partials(o_parts, lse_parts):
    """Online-softmax merge of flash partials over disjoint KV chunks;
    port of ``repro/kernels/flash_attention.py::merge_flash_partials``.

    ``o_parts`` [N,B,S,H,D] (or a list of [B,S,H,D]), ``lse_parts``
    [N,B,S,H] (or a list of [B,S,H]) -> (o, lse) over the union of the
    chunks.  Exact: each partial is its chunk's softmax-weighted value sum
    with its log-sum-exp, so reweighting by ``exp(lse_i - lse)``
    rebuilds the global softmax.  A fully masked chunk carries lse <=
    -1e29 and merges with weight 0.  Plain torch in float32, which
    autograd differentiates; the chunks' Functions take the resulting
    (do_i, dlse_i) cotangents."""
    if isinstance(o_parts, (list, tuple)):
        o_parts = torch.stack(list(o_parts))
    if isinstance(lse_parts, (list, tuple)):
        lse_parts = torch.stack(list(lse_parts))
    m = lse_parts.amax(dim=0)
    w = torch.exp(lse_parts - m[None])
    total = w.sum(dim=0).clamp_min(1e-30)
    lse = m + torch.log(total)
    o = (o_parts.float() * (w / total[None])[..., None]).sum(dim=0)
    return o.to(o_parts.dtype), lse
