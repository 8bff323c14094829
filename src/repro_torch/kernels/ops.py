"""Kernel dispatch by the tensors' device.

CUDA tensors go to the hand-written kernel, or raise; CPU tensors go to
the plain version in :mod:`repro_torch.kernels.ref`.  There is no
environment switch and no fallback: a CUDA tensor never reaches the plain
version through here.  (The JAX package's ``repro/kernels/ops.py`` picks
its tier with an ``impl`` argument; the port has one kernel per device.)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None, q_offset: int = 0,
                        kv_positions: Optional[torch.Tensor] = None):
    """-> (o [B,S,H,D], lse [B,S,H] float32); q [B,S,H,D], k/v [B,T,KV,D].

    ``kv_positions`` [T] int32 replaces the implicit ``arange(T)`` key
    positions; ``q_offset`` is the absolute position of ``q[:, 0]``."""
    if q.is_cuda:
        return fa.flash_fwd(q, k, v, causal=causal, window=window,
                            scale=scale, q_offset=q_offset,
                            kv_positions=kv_positions)
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
    return flash_attention_lse(q, k, v, causal=causal, window=window,
                               scale=scale, q_offset=q_offset,
                               kv_positions=kv_positions)[0]
