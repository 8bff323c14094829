"""Plain PyTorch versions of the port's kernels.

``flash_attention_ref`` is the plain version of ``csrc/flash_fwd.cu``,
``flash_bwd_ref`` (the blockwise-recompute backward, float32 block
products in a Python loop) that of ``csrc/flash_bwd.cu``,
``distill_kl_stats_ref`` that of ``csrc/distill_kl_fwd.cu``,
``distill_kl_bwd_ref`` (the KL's gradients, float32 block products in a
Python loop) that of ``csrc/distill_kl_bwd.cu`` with its products and
``ssd_scan_ref`` that of ``csrc/ssd_fwd.cu`` and ``ssd_bwd_ref`` (the
scan's gradients, chunk by chunk) that of ``csrc/ssd_bwd.cu``;
``distill_kl_reference``
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
                        kv_positions: Optional[torch.Tensor] = None,
                        segment_q: Optional[torch.Tensor] = None,
                        segment_kv: Optional[torch.Tensor] = None):
    """-> (o [B, S, H, D] in q's dtype, lse [B, S, H] float32).

    ``segment_q`` [B, S] and ``segment_kv`` [B, T] (packed sequences; both
    or neither) let a row see only keys of its own segment, as the JAX
    package's ``_mask`` does."""
    B, S, H, D = q.shape
    _, T, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qf = q.reshape(B, S, KV, G, D).float() * scale
    logits = torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    mask = visible_mask(S, T, causal=causal, window=window,
                        q_offset=q_offset, kv_positions=kv_positions,
                        device=q.device)
    if (segment_q is None) != (segment_kv is None):
        raise ValueError("segment ids: pass both segment_q and segment_kv, "
                         "or neither")
    if segment_q is not None:
        same = segment_q.to(q.device)[:, :, None] == \
            segment_kv.to(q.device)[:, None, :]               # [B, S, T]
        mask = (mask[None] & same)[:, None, None]              # [B,1,1,S,T]
    logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgst,btkd->bskgd", p / l, v.float())
    lse = (m + torch.log(l))[..., 0]                     # [B, KV, G, S]
    return (o.reshape(B, S, H, D).to(q.dtype),
            lse.permute(0, 3, 1, 2).reshape(B, S, H))


# --------------------------------------------------------------------------- #
# Flash attention backward
# --------------------------------------------------------------------------- #
BWD_BLOCK = 512


def flash_bwd_ref(q, k, v, o, lse, do, dlse=None, *, causal: bool = True,
                  window: int = 0, scale: Optional[float] = None,
                  q_offset: int = 0,
                  kv_positions: Optional[torch.Tensor] = None,
                  block: int = BWD_BLOCK):
    """Blockwise-recompute flash backward -> (dq, dk, dv) in the inputs'
    dtypes; port of ``repro/kernels/ref.py::_flash_bwd_core`` and the
    plain version of ``csrc/flash_bwd.cu``.

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


def distill_kl_bwd_ref(h_s, w_s, h_t, w_t, lse_s, lse_t, e_t, e_s, tok_w,
                       T: float = 1.0, *, needs=(True, True, True, True),
                       block_v: int = 2048):
    """The analytic second pass of the KL, chunked over the vocabulary ->
    (dh_s, dw_s, dh_t, dw_t), None where ``needs`` (one flag an input)
    says no; port of ``repro/kernels/distill_kl.py::_distill_kl_bwd`` and
    the plain version of ``csrc/distill_kl_bwd.cu`` with its products.

    ``dz_s = (p_s - p_t) w``, ``dz_t = p_t ((z_t - e_t) - (z_s - e_s)) w``,
    ``dh = dz W^T``, ``dW = h^T dz`` with ``tok_w`` [N] float32 the token
    weight w (``mask / max(sum mask, 1) g / T``) and (lse_s, lse_t, e_t,
    e_s) the forward's statistics.  Products are ``torch.matmul`` on
    float32 blocks.  W is cast one vocabulary block at a time, never whole:
    at qwen1.5-0.5b's vocabulary a float32 copy of both W would take about
    1.2 GB.  dh is cast to h's dtype at the end, each block of dW to W's
    dtype as it is written (``empty_like`` keeps W's strides), as the JAX
    package casts the whole float32 gradient at the end."""
    need_hs, need_ws, need_ht, need_wt = needs
    V = w_s.shape[1]
    bv = block_v
    tok_w = tok_w[:, None]
    hs, ht = h_s.float(), h_t.float()
    dhs = torch.zeros_like(hs) if need_hs else None
    dht = torch.zeros_like(ht) if need_ht else None
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
            None if dht is None else dht.to(h_t.dtype), dwt)


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


def ssd_bwd_ref(x, dt, A, B, C, D, gy, gstate=None):
    """The plain version of ``csrc/ssd_bwd.cu``: the VJP of the scan
    (``ssd_pallas.py::_bwd``, ``jax.vjp`` through ``ssd_chunked_jnp``) in
    the kernel's own decomposition, 64-token chunks (``ssd_scan.CHUNK``)
    with the ragged tail padded as :func:`ssd_scan_ref` pads it.

    Per chunk, with cum = cumsum(A dt), L_ij = exp(cum_i - cum_j) for
    i >= j (masked before the ``exp``, ROADMAP.md C3), S = C B^T and G_ij =
    gy_i . x_j, H the state entering the chunk and dH the gradient of the
    one leaving it:

    * the entering states by a loop over chunks, the leaving states'
      gradients by a reverse loop from ``gstate`` (or 0): dH_prev =
      exp(cum_end) dH + sum_i exp(cum_i) gy_i (x) C_i;
    * dx_j = dt_j [sum_i S_ij L_ij gy_i + exp(cum_end - cum_j) dH B_j]
      + D gy_j;
    * dC_i = sum_j dS_ij B_j + exp(cum_i) gy_i^T H and dB_j = sum_i dS_ij
      C_i + exp(cum_end - cum_j) dt_j x_j^T dH, dS_ij = G_ij L_ij dt_j,
      summed over the heads;
    * ddt_j = sum_i S_ij L_ij G_ij + q_j + A rcs_j, q_j = exp(cum_end -
      cum_j) x_j . (dH B_j), rcs the reverse cumsum over the chunk of
      d(cum); dA = sum dt rcs and dD = sum gy . x.

    x [b, s, h, p], dt [b, s, h], A [h], B and C [b, s, n], D [h], gy like
    x, gstate [b, h, p, n] or None -> (dx, ddt, dA, dB, dC, dD): dx, dB and
    dC in x's dtype, the others float32.  Products in float32; differences
    of cum, d(cum) and the sums of dA and dD in float64."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    Q = ssd_scan.CHUNK
    pad = -s % Q
    nc = (s + pad) // Q

    def chunked(t, *tail):
        t = torch.nn.functional.pad(t.float(),
                                    (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, nc, Q, *tail)

    xf, gyf = chunked(x, h, p), chunked(gy, h, p)       # [b, c, Q, h, p]
    dtf = chunked(dt, h)                                 # [b, c, Q, h]
    Bf, Cf = chunked(B, n), chunked(C, n)                # [b, c, Q, n]
    Af = A.float()
    cum64 = torch.cumsum(Af.double() * dtf.double(), dim=2)
    cum = cum64.float()
    diff = (cum64[:, :, :, None, :] - cum64[:, :, None, :, :]).float()
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(diff.masked_fill(~tri[:, :, None], float("-inf")))
    decay_end = torch.exp((cum64[:, :, -1:, :] - cum64).float())  # [b,c,Q,h]
    decay_chunk = torch.exp(cum[:, :, -1, :])[..., None, None]    # [b,c,h,1,1]

    S_c = torch.einsum("bcjhp,bcjn->bchpn",
                       (decay_end * dtf)[..., None] * xf, Bf)
    G_c = torch.einsum("bcihp,bcin->bchpn",
                       torch.exp(cum)[..., None] * gyf, Cf)
    H = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(H)
        H = H * decay_chunk[:, c] + S_c[:, c]
    dH = (torch.zeros_like(H) if gstate is None else gstate.float())
    leaving = [dH] * nc
    for c in reversed(range(nc)):
        leaving[c] = dH
        dH = dH * decay_chunk[:, c] + G_c[:, c]
    Hin = torch.stack(entering, dim=1)                   # [b, c, h, p, n]
    dHo = torch.stack(leaving, dim=1)

    S = torch.einsum("bcin,bcjn->bcij", Cf, Bf)[..., None]    # [b,c,i,j,1]
    G = torch.einsum("bcihp,bcjhp->bcijh", gyf, xf)
    W = S * L
    P = W * G
    dS = G * L * dtf[:, :, None]
    BdH = torch.einsum("bcjn,bchpn->bcjhp", Bf, dHo)
    dx = dtf[..., None] * (torch.einsum("bcijh,bcihp->bcjhp", W, gyf)
                           + decay_end[..., None] * BdH) \
        + D.float()[:, None] * gyf
    gyH = torch.einsum("bcihp,bchpn->bcihn", gyf, Hin)
    dC = (torch.einsum("bcijh,bcjn->bcin", dS, Bf)
          + torch.einsum("bcih,bcihn->bcin", torch.exp(cum), gyH))
    xdH = torch.einsum("bcjhp,bchpn->bcjhn", xf, dHo)
    dB = (torch.einsum("bcijh,bcin->bcjn", dS, Cf)
          + torch.einsum("bcjh,bcjhn->bcjn", decay_end * dtf, xdH))
    q = decay_end * (xf * BdH).sum(-1)                   # [b, c, Q, h]
    e = torch.exp(cum) * torch.einsum("bcin,bcihn->bcih", Cf, gyH)
    col_p = P.sum(dim=2)                                 # over i: [b,c,j,h]
    row_m = (P * dtf[:, :, None]).sum(dim=3)             # over j: [b,c,i,h]
    # d(cum) and its reverse cumsum in float64: its terms reach ~1e3 at
    # mamba2-130m's widths and cancel, and dA sums dt rcs over every token
    dtd = dtf.double()
    dcum = (row_m.double() - dtd * col_p + e - dtd * q)
    end = (torch.exp(cum[:, :, -1]) * (dHo * Hin).sum((-2, -1))
           + (dtf * q).sum(2))                           # [b, c, h]
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + end[:, :, None]],
                     dim=2)
    rcs = dcum.flip(2).cumsum(2).flip(2)
    ddt = (col_p + q + Af * rcs).float()
    dA = (dtd * rcs).sum((0, 1, 2)).float()
    dD = (gyf.double() * xf.double()).sum((0, 1, 2, 4)).float()

    def unchunk(t, dtype):
        return t.reshape(b, nc * Q, *t.shape[3:])[:, :s].to(dtype)

    return (unchunk(dx, x.dtype), unchunk(ddt, torch.float32), dA,
            unchunk(dB, B.dtype), unchunk(dC, C.dtype), dD)
