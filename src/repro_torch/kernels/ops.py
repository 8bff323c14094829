"""Kernel dispatch by the tensors' device.

CUDA tensors go to the hand-written kernel, or raise; CPU tensors go to
the plain version in :mod:`repro_torch.kernels.ref`.  There is no
environment switch and no fallback: a CUDA tensor never reaches the plain
version through here.  On the card, attention goes through the autograd
Functions of :mod:`repro_torch.kernels.flash_attention`, so a CUDA q/k/v
that requires grad gets its gradient; on the CPU autograd differentiates
the plain version.  (The JAX package's ``repro/kernels/ops.py`` picks
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


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None, q_offset: int = 0,
                        kv_positions: Optional[torch.Tensor] = None):
    """-> (o [B,S,H,D], lse [B,S,H] float32); q [B,S,H,D], k/v [B,T,KV,D].

    ``kv_positions`` [T] int32 replaces the implicit ``arange(T)`` key
    positions; ``q_offset`` is the absolute position of ``q[:, 0]``."""
    if q.is_cuda:
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
    """Attention output only; see :func:`flash_attention_lse`."""
    if segment_q is not None or segment_kv is not None:
        raise NotImplementedError(
            "segment ids (packed sequences) are not ported yet; see "
            "ROADMAP.md, B1")
    if q.is_cuda:
        return fa.FlashAttention.apply(q, k, v, kv_positions, causal, window,
                                       scale, q_offset)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=q_offset,
                                   kv_positions=kv_positions)[0]


def distill_kl(h_s: torch.Tensor, w_s: torch.Tensor, h_t: torch.Tensor,
               w_t: torch.Tensor, *, mask: Optional[torch.Tensor] = None,
               temperature: float = 1.0, block_v: int = 2048
               ) -> torch.Tensor:
    """Chunked-vocab KL(p_t || p_s), masked token mean, from hidden states
    h [N, D] and unembeddings w [D, V]; never forms the [N, V] logits.

    The per-token statistics come from the CUDA kernel for CUDA tensors
    and from ``ref.distill_kl_stats_ref`` for CPU tensors; both go through
    the same :class:`~repro_torch.kernels.distill_kl.DistillKL` Function,
    whose backward is chunked by ``block_v``."""
    if h_s.is_cuda:
        stats = dk.distill_kl_fwd
    else:
        stats = functools.partial(ref.distill_kl_stats_ref, block_v=block_v)
    return dk.DistillKL.apply(h_s, w_s, h_t, w_t, mask, float(temperature),
                              int(block_v), stats)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 128, return_state: bool = False):
    """Mamba-2 SSD over a full sequence -> y [b, s, h, p] (and with
    ``return_state`` the final state [b, h, p, n] float32); shapes as in
    :mod:`repro_torch.kernels.ssd_scan`.

    CUDA tensors go through :class:`~repro_torch.kernels.ssd_scan.SSDScan`
    with the kernel's forward (its fixed 64-token chunk) and a backward
    recomputed by ``ssd_chunked`` at ``chunk``; CPU tensors go to
    ``ssd_chunked`` at ``chunk``, which autograd differentiates."""
    if x.is_cuda:
        return ssd.SSDScan.apply(x, dt, A, B, C, D, int(chunk),
                                 bool(return_state), ssd.ssd_fwd)
    return ssd.ssd_chunked(x, dt, A, B, C, D, chunk=chunk,
                           return_state=return_state)
