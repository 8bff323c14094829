"""Kernel dispatch by the tensors' device.

CUDA tensors go to the hand-written kernel, or raise; CPU tensors go to
the plain version in :mod:`repro_torch.kernels.ref`.  There is no
environment switch and no fallback: a CUDA tensor never reaches the plain
version through here.  Meta tensors (a dry-run's fake tensors,
:mod:`repro_torch.launch.dryrun`) take the kernel's route too, where the
kernel's op (``repro_torch::flash_fwd``, ``::flash_bwd``, ...) gives its
shape function's outputs and launches nothing.  On the card, attention
goes through the autograd Functions of
:mod:`repro_torch.kernels.flash_attention`, whose backward is the CUDA
kernel of ``csrc/flash_bwd.cu``, so a CUDA q/k/v that requires grad gets
its gradient from hand-written kernels both ways; on the CPU autograd
differentiates the plain version.  The distillation KL goes through
:class:`~repro_torch.kernels.distill_kl.DistillKL` on both devices, with
the statistics and gradient functions of the tensors' route (the kernels
of ``csrc/distill_kl_fwd.cu`` and ``csrc/distill_kl_bwd.cu``, or their
plain versions).  The SSD scan goes through
:class:`~repro_torch.kernels.ssd_scan.SSDScan` on the card, with the
forward and backward kernels of ``csrc/ssd_fwd.cu`` and
``csrc/ssd_bwd.cu``; on the CPU autograd differentiates ``ssd_chunked``.
(The JAX package's ``repro/kernels/ops.py`` picks
its tier with an ``impl`` argument; the port has one kernel per device.)
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import distill_kl as dk
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd


def kernel_route(x: torch.Tensor) -> bool:
    """Whether ``x`` goes to the hand-written kernel: a CUDA tensor, or a
    meta tensor standing for one in a dry-run."""
    return x.is_cuda or x.is_meta


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None, q_offset: int = 0,
                        kv_positions: Optional[torch.Tensor] = None):
    """-> (o [B,S,H,D], lse [B,S,H] float32); q [B,S,H,D], k/v [B,T,KV,D].

    ``kv_positions`` [T] int32 replaces the implicit ``arange(T)`` key
    positions; ``q_offset`` is the absolute position of ``q[:, 0]``."""
    if kernel_route(q):
        return fa.FlashAttentionLse.apply(q, k, v, kv_positions, causal,
                                          window, scale, q_offset)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=q_offset,
                                   kv_positions=kv_positions)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    segment_q=None, segment_kv=None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    kv_positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Attention output only; see :func:`flash_attention_lse`.

    ``segment_q`` [B, S] / ``segment_kv`` [B, T] restrict each row to keys
    of its own segment (packed sequences).  The plain version computes
    that mask; the CUDA kernel has no segment operand yet, so CUDA
    tensors with segment ids raise."""
    if kernel_route(q):
        if segment_q is not None or segment_kv is not None:
            raise ValueError(
                "flash_attention: segment ids (packed sequences) on CUDA "
                "tensors need a segment operand in csrc/flash_fwd.cu, "
                "which is not written yet; see ROADMAP.md, B5")
        return fa.FlashAttention.apply(q, k, v, kv_positions, causal, window,
                                       scale, q_offset)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=q_offset,
                                   kv_positions=kv_positions,
                                   segment_q=segment_q,
                                   segment_kv=segment_kv)[0]


def distill_kl(h_s: torch.Tensor, w_s: torch.Tensor, h_t: torch.Tensor,
               w_t: torch.Tensor, *, mask: Optional[torch.Tensor] = None,
               temperature: float = 1.0, block_v: int = 2048
               ) -> torch.Tensor:
    """Chunked-vocab KL(p_t || p_s), masked token mean, from hidden states
    h [N, D] and unembeddings w [D, V]; never forms the [N, V] logits.

    The per-token statistics and the gradients come from the CUDA kernels
    for CUDA tensors (``distill_kl_fwd``, ``distill_kl_bwd``) and from
    ``ref.distill_kl_stats_ref`` and ``ref.distill_kl_bwd_ref``, chunked by
    ``block_v``, for CPU tensors; both go through the same
    :class:`~repro_torch.kernels.distill_kl.DistillKL` Function."""
    if kernel_route(h_s):
        stats, grads = dk.distill_kl_fwd, dk.distill_kl_bwd
    else:
        stats = functools.partial(ref.distill_kl_stats_ref, block_v=block_v)
        grads = functools.partial(ref.distill_kl_bwd_ref, block_v=block_v)
    return dk.DistillKL.apply(h_s, w_s, h_t, w_t, mask, float(temperature),
                              stats, grads)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 128, return_state: bool = False):
    """Mamba-2 SSD over a full sequence -> y [b, s, h, p] (and with
    ``return_state`` the final state [b, h, p, n] float32); shapes as in
    :mod:`repro_torch.kernels.ssd_scan`.

    CUDA tensors go through :class:`~repro_torch.kernels.ssd_scan.SSDScan`
    with the forward and backward kernels (``ssd_fwd``, ``ssd_bwd``), both
    at their fixed 64-token chunk, so ``chunk`` does not apply; CPU
    tensors go to ``ssd_chunked`` at ``chunk``, which autograd
    differentiates."""
    if kernel_route(x):
        return ssd.SSDScan.apply(x, dt, A, B, C, D, bool(return_state),
                                 ssd.ssd_fwd, ssd.ssd_bwd)
    return ssd.ssd_chunked(x, dt, A, B, C, D, chunk=chunk,
                           return_state=return_state)
