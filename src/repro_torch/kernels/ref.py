"""Plain PyTorch versions of the port's kernels.

``flash_attention_ref`` is the direct formula for what
``kernels/csrc/flash_fwd.cu`` computes, in float32, with the JAX package's
difference-based masks (``repro/kernels/ref.py::_mask``), ``NEG_INF =
-1e30``, the ``l >= 1e-30`` clamp and ``lse = m + log l``
(``repro/kernels/ref.py::_flash_fwd_raw``).  CPU tensors take this path;
``chip_smoke.py`` holds the CUDA kernel against it on the card.

Rows with no visible key (only with ``q_offset``, ``kv_positions`` or a
window) give ``o = 0`` and ``lse <= -1e29``: masked probabilities are set
to exactly 0 rather than ``exp(-1e30 - m)``.  Everywhere else this equals
the JAX package's softmax.

Shapes: q [B, S, H, D]; k, v [B, T, KV, D] with H % KV == 0 (GQA by
``kv_head = h // (H // KV)``, no KV duplication).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def visible_mask(S: int, T: int, *, causal: bool, window: int,
                 q_offset: int = 0,
                 kv_positions: Optional[torch.Tensor] = None,
                 device=None) -> torch.Tensor:
    """Boolean [S, T]: True where query row s may attend key column t."""
    q_pos = torch.arange(S, device=device) + q_offset
    kv_pos = (torch.arange(T, device=device) if kv_positions is None
              else kv_positions.to(device=device, dtype=torch.int64))
    diff = q_pos[:, None] - kv_pos[None, :]
    m = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        m &= diff >= 0
    if window > 0:
        m &= diff < window
    return m


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: Optional[float] = None, q_offset: int = 0,
                        kv_positions: Optional[torch.Tensor] = None):
    """-> (o [B, S, H, D] in q's dtype, lse [B, S, H] float32)."""
    B, S, H, D = q.shape
    _, T, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qf = q.reshape(B, S, KV, G, D).float() * scale
    logits = torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    mask = visible_mask(S, T, causal=causal, window=window,
                        q_offset=q_offset, kv_positions=kv_positions,
                        device=q.device)
    logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgst,btkd->bskgd", p / l, v.float())
    lse = (m + torch.log(l))[..., 0]                     # [B, KV, G, S]
    return (o.reshape(B, S, H, D).to(q.dtype),
            lse.permute(0, 3, 1, 2).reshape(B, S, H))
