"""Top-k mixture-of-experts with capacity-slotted dispatch (GShard-style).

Counterpart of ``repro/models/moe.py``: the same parameter keys, shapes
and dtypes (``router [d, E]`` float32, ``w_gate``/``w_up [E, d, f]``,
``w_down [E, f, d]``), the same routing and the same capacity rule.

Per group (one sample): tokens choose their top-k experts; the position
of each (token, k) slot inside its expert's capacity buffer comes from a
cumulative count over the slots in the order ``s * K + k``; slots past the
capacity are dropped (the token passes through the residual), as in
GShard/Switch with ``capacity_factor``.

The three expert products are batched matrix products, which the JAX
package also computes outside any Pallas kernel (``jnp.einsum``); here
they are ``torch.bmm`` on an expert-major dispatch buffer ``[E, B, C,
D]``, the reference's ``[B, E, C, D]`` with its first two axes swapped so
that each expert's rows are contiguous.  Each product sums over the same
axis as the reference's.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.profiler

from repro_torch.core.types import ArchConfig
from repro_torch.models.common import ParamSpec, torch_dtype


def moe_specs(cfg: ArchConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = torch_dtype(cfg.dtype)
    return {
        "router": ParamSpec((d, e), ("embed_nosplit", "experts_r"),
                            "normal", torch.float32, (0,)),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", "mlp"),
                            "normal", dt, (1,)),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", "mlp"),
                          "normal", dt, (1,)),
        "w_down": ParamSpec((e, f, d), ("experts", "mlp", "embed"),
                            "normal", dt, (1,)),
    }


def capacity(tokens_per_group: int, cfg: ArchConfig) -> int:
    c = math.ceil(tokens_per_group * cfg.experts_per_token
                  / cfg.num_experts * cfg.capacity_factor)
    return max(int(c), cfg.experts_per_token)


def route(p, x: torch.Tensor, cfg: ArchConfig):
    """x [B, S, D] -> (router logits [B, S, E] float32, top-k gates
    [B, S, K] renormalised by softmax, expert indices [B, S, K] in
    descending logit order)."""
    logits = x.float() @ p["router"]
    gate_logits, idx = torch.topk(logits, cfg.experts_per_token, dim=-1)
    return logits, torch.softmax(gate_logits, dim=-1), idx


def moe(p, x: torch.Tensor, cfg: ArchConfig, *, return_stats: bool = False,
        tp_in: Optional[Callable] = None) -> Tuple[torch.Tensor, ...]:
    """x [B, S, D] -> (y [B, S, D], aux loss scalar float32).

    ``return_stats=True`` also returns the router statistics the aux loss
    is built from, ``stats`` [2, E] float32: ``stats[0]`` = frac (mean
    routed assignments per expert) and ``stats[1]`` = prob (mean router
    probability per expert), token means over this call's rows.  Both
    are linear in the token population, so a caller that splits a batch
    (micro-batches, data or sequence ranks) averages them and rebuilds the
    exact aux ``E * sum(frac * prob) / K``; the aux itself is nonlinear in
    them and does not average.

    ``tp_in`` (Megatron tensor parallelism, ``dist.pipeline``): the
    expert weights hold this rank's slice of the ``mlp`` dim, so ``y`` is
    a partial sum the caller all-reduces over the model group.  Routing
    reads ``x`` as it is, replicated on every rank; the expert path reads
    ``tp_in(x)`` and the combine ``tp_in(gates)``, identities whose
    backward all-reduces the gradient over the group, so that the
    router's and ``x``'s gradients come out whole on every rank.

    The reference passes the gate product through ``grad_dtype_barrier``
    (an identity whose backward casts the cotangent to the primal's
    dtype); PyTorch's autograd already gives a bf16 tensor a bf16
    gradient, so no op stands in for it."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = capacity(S, cfg)

    with torch.profiler.record_function("moe.route"):
        logits, gates, idx = route(p, x, cfg)
        if tp_in is not None:
            x, gates = tp_in(x), tp_in(gates)
        # position of each (token, k) slot in its expert's buffer: a count
        # over the slots in the order s * K + k, per sample
        oh = F.one_hot(idx, E)                                  # [B,S,K,E]
        pos = torch.cumsum(oh.reshape(B, S * K, E), dim=1).reshape(
            B, S, K, E).gather(-1, idx[..., None])[..., 0] - 1  # [B,S,K]
        keep = pos < C
        pos_c = pos.clamp(0, C - 1)
        # load-balancing aux loss (Switch): frac comes from the indices and
        # carries no gradient
        frac = oh.sum(dim=2).float().mean(dim=(0, 1))
        prob = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
        aux = E * torch.sum(frac * prob) / K

    with torch.profiler.record_function("moe.dispatch"):
        # row (e, b, pos) of the buffer seen as [E * B * C, D]
        b_ix = torch.arange(B, device=x.device)[:, None, None]
        row = ((idx * B + b_ix) * C + pos_c).reshape(-1)        # [B*S*K]
        # out of place, accumulating: a dropped slot adds exactly 0 at
        # position C - 1 of its expert
        w = keep.to(x.dtype)
        xe = x.new_zeros((E * B * C, D)).index_put(
            (row,), (x[:, :, None, :] * w[..., None]).reshape(-1, D),
            accumulate=True)

    with torch.profiler.record_function("moe.experts"):
        xf = xe.reshape(E, B * C, D)
        g = torch.bmm(xf, p["w_gate"])
        u = torch.bmm(xf, p["w_up"])
        h = F.silu(g.float()).to(x.dtype) * u
        ye = torch.bmm(h, p["w_down"]).reshape(E * B * C, D)

    with torch.profiler.record_function("moe.combine"):
        # y[b, s] = sum_k gate * keep * ye[idx, b, pos]
        gathered = ye.index_select(0, row).reshape(B, S, K, D)
        gw = (gates * keep.float()).to(x.dtype)
        y = torch.sum(gathered * gw[..., None], dim=2)
    if return_stats:
        return y, aux, torch.stack([frac, prob]).float()
    return y, aux
