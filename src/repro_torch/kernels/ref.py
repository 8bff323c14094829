"""Plain PyTorch versions of the port's kernels.

``flash_attention_ref`` is the plain version of ``csrc/flash_fwd.cu``,
``distill_kl_stats_ref`` that of ``csrc/distill_kl_fwd.cu`` and
``ssd_scan_ref`` that of ``csrc/ssd_fwd.cu``; ``distill_kl_reference``
(the full-materialisation KL) and ``ssd_reference`` (the sequential SSD
scan) are oracles, for tests only.

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

from repro_torch.kernels import ssd_scan

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


# --------------------------------------------------------------------------- #
# Distillation KL
# --------------------------------------------------------------------------- #
def distill_kl_stats_ref(h_s: torch.Tensor, w_s: torch.Tensor,
                         h_t: torch.Tensor, w_t: torch.Tensor,
                         T: float = 1.0, block_v: int = 2048):
    """Per-token statistics of KL(p_t || p_s), streamed over vocab blocks.

    h_s [N, Ds], w_s [Ds, V], h_t [N, Dt], w_t [Dt, V]; ``z = h W / T``.
    Returns float32 [N] each: ``lse_s``, ``lse_t``, ``e_t = sum p_t z_t``
    and ``e_s = sum p_t z_s``.  Port of
    ``repro/kernels/distill_kl.py::_fwd_pass`` in float32, with the
    ``max(l, 1e-30)`` clamps of the Pallas kernel
    (``distill_kl_pallas.py:73-79``); the last block may be ragged.  Each
    block of W is cast to float32 on its own, so no [N, V] logits and no
    float32 copy of W exist at once."""
    N = h_s.shape[0]
    V = w_s.shape[1]
    hs, ht = h_s.float(), h_t.float()
    dev = h_s.device
    ms = torch.full((N,), NEG_INF, dtype=torch.float32, device=dev)
    mt = ms.clone()
    ls, lt, ut, us = (torch.zeros(N, dtype=torch.float32, device=dev)
                      for _ in range(4))
    for v0 in range(0, V, block_v):
        zs = (hs @ w_s[:, v0:v0 + block_v].float()) / T
        zt = (ht @ w_t[:, v0:v0 + block_v].float()) / T
        ms_n = torch.maximum(ms, zs.amax(-1))
        ls = ls * torch.exp(ms - ms_n) + torch.exp(zs - ms_n[:, None]).sum(-1)
        mt_n = torch.maximum(mt, zt.amax(-1))
        corr = torch.exp(mt - mt_n)
        pt = torch.exp(zt - mt_n[:, None])
        lt = lt * corr + pt.sum(-1)
        ut = ut * corr + (pt * zt).sum(-1)
        us = us * corr + (pt * zs).sum(-1)
        ms, mt = ms_n, mt_n
    lt = lt.clamp_min(1e-30)
    return (ms + torch.log(ls.clamp_min(1e-30)), mt + torch.log(lt),
            ut / lt, us / lt)


def distill_kl_reference(h_s, w_s, h_t, w_t, *, mask=None,
                         temperature: float = 1.0) -> torch.Tensor:
    """KL(p_t || p_s), token mean, from the materialised [N, V] logits
    (``repro/kernels/ref.py::distill_kl_reference``).  Tests only."""
    zs = (h_s.float() @ w_s.float()) / temperature
    zt = (h_t.float() @ w_t.float()) / temperature
    ls = torch.log_softmax(zs, dim=-1)
    lt = torch.log_softmax(zt, dim=-1)
    kl = (torch.exp(lt) * (lt - ls)).sum(-1)
    if mask is not None:
        m = mask.float()
        return (kl * m).sum() / m.sum().clamp_min(1.0)
    return kl.mean()


# --------------------------------------------------------------------------- #
# Mamba-2 SSD scan
# --------------------------------------------------------------------------- #
def ssd_reference(x, dt, A, B, C, D):
    """Sequential SSD scan, the oracle (``repro/kernels/ref.py::
    ssd_reference``): one token at a time, so no ``exp`` of a positive sum
    is ever formed and its gradients are finite at any length.

    x [b, s, h, p], dt [b, s, h] (softplus'ed), A [h] (< 0), B and C
    [b, s, n] (one group), D [h] -> y [b, s, h, p] in x's dtype."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(A[None] * dtf[:, t])                     # [b, h]
        dBx = torch.einsum("bh,bn,bhp->bhpn", dtf[:, t], Bf[:, t], xf[:, t])
        state = state * decay[..., None, None] + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    y = torch.stack(ys, dim=1) + xf * D[None, None, :, None]
    return y.to(x.dtype)


def ssd_scan_ref(x, dt, A, B, C, D, *, return_state: bool = False):
    """The plain version of ``csrc/ssd_fwd.cu``: the chunked scan at the
    kernel's fixed chunk (``ssd_scan.CHUNK``), with a ragged last chunk
    padded by tokens of ``dt = 0``, ``x = B = C = 0``, which leave the state
    as it is.  -> y [b, s, h, p] in x's dtype (the D·x skip added in float32
    before the one rounding), and with ``return_state`` the final state
    [b, h, p, n] float32."""
    s = x.shape[1]
    pad = -s % ssd_scan.CHUNK

    def padded(t):
        return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

    y, state = ssd_scan.ssd_chunked(padded(x), padded(dt), A, padded(B),
                                    padded(C), D, chunk=ssd_scan.CHUNK,
                                    return_state=True)
    y = y[:, :s]
    return (y, state) if return_state else y
