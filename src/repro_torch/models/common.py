"""Common model building blocks: param specs, init, norms, RoPE, loss.

Counterpart of ``repro/models/common.py``.  Every model defines a
param-spec tree, a nested dict whose leaves are :class:`ParamSpec`; the
parameter tree built from it has the JAX package's keys, shapes and
stacked ``layers`` axis, so a JAX tree converts leaf for leaf
(:mod:`repro_torch.convert`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


class ParamSpec(NamedTuple):
    shape: tuple
    axes: tuple            # logical axis name (or None) per dim; len == ndim
    init: str = "normal"   # normal | zeros | ones | embed
    dtype: torch.dtype = torch.bfloat16
    fan_in_dims: tuple = ()   # dims contracted at use time (for scaled init)


def tree_map(fn: Callable[[Any], Any], tree):
    """Map ``fn`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in the order :func:`tree_map` visits
    them."""
    out: list = []
    tree_map(out.append, tree)
    return out


def flatten_with_path(tree, prefix: Tuple[str, ...] = ()
                      ) -> List[Tuple[str, Any]]:
    """(dotted path, leaf) pairs in the order, and with the names, of the
    JAX package's ``tree_flatten_with_path``: dict keys sorted, named-tuple
    fields by name, list and tuple items by index; None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten_with_path(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for k in tree._fields
                for x in flatten_with_path(getattr(tree, k), prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flatten_with_path(v, prefix + (str(i),))]
    return [(".".join(prefix), tree)]


def tree_unflatten(like, leaves) -> dict:
    """A tree shaped like ``like`` whose leaves are ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_like(like, other):
    """``other``'s leaves in a tree keyed and ordered as ``like``: two
    trees with the same keys may list them in different orders (a
    ``Model``'s parameter tree puts a level's tensors before its subtrees,
    its spec tree keeps the specs' order)."""
    if isinstance(like, dict):
        return {k: tree_like(v, other[k]) for k, v in like.items()}
    return other


def stack_specs(spec_tree, n: int, axis_name: str = "layers"):
    """Prepend a stacked `layers` dim to every spec."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, (axis_name,) + s.axes, s.init,
                            s.dtype, tuple(d + 1 for d in s.fan_in_dims)),
        spec_tree)


def unbind_layers(stacked: dict) -> list:
    """A tree stacked on axis 0 -> one tree per layer.  One unbind per
    leaf: its backward stacks the layers' gradients once, where indexing
    would add a zero-filled full-size gradient per layer."""
    leaves = tree_map(lambda x: x.unbind(0), stacked)
    n = len(tree_leaves(leaves)[0])
    return [tree_map(lambda xs: xs[i], leaves) for i in range(n)]


def _init_one(spec: ParamSpec, gen: torch.Generator, device) -> torch.Tensor:
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "zeros":
        return out.zero_()
    if spec.init == "ones":
        return out.fill_(1.0)
    if spec.init == "embed":
        # 1/sqrt(d) keeps tied-unembedding logits O(1) at init
        std = 1.0 / math.sqrt(spec.shape[-1])
        trunc = False
    else:
        # truncated normal at +-2 std with fan-in scaling (the JAX package's
        # truncated_normal(-2, 2) * std)
        fan_in = 1
        dims = spec.fan_in_dims or tuple(range(max(len(spec.shape) - 1, 1)))
        for d in dims:
            fan_in *= spec.shape[d]
        std = 1.0 / math.sqrt(max(fan_in, 1))
        trunc = True
    # fill a stacked leaf layer by layer, in float32, so the float32 scratch
    # stays one layer
    rows = out if out.dim() > 2 else out[None]
    for row in rows:
        tmp = torch.empty(row.shape, dtype=torch.float32, device=device)
        if trunc:
            torch.nn.init.trunc_normal_(tmp, 0.0, std, -2.0 * std, 2.0 * std,
                                        generator=gen)
        else:
            tmp.normal_(0.0, std, generator=gen)
        row.copy_(tmp)
    return out


def init_params(spec_tree, gen: torch.Generator, device) -> dict:
    """Materialize a spec tree on ``device`` from ``gen`` (leaves in sorted
    key order, so one seed gives one tree)."""
    if isinstance(spec_tree, dict):
        return {k: init_params(spec_tree[k], gen, device)
                for k in sorted(spec_tree)}
    return _init_one(spec_tree, gen, device)


def shard_act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Activation-sharding hook; an identity until the multi-device slice."""
    return x


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


# --------------------------------------------------------------------------- #
# Rotary position embeddings
# --------------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions broadcastable to [..., seq].
    Rotates split halves (not interleaved pairs), as the JAX package does."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_frequencies(hd, theta)).to(x.device)
    angles = positions[..., None].float() * freqs          # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                   # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------------- #
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32. logits [..., V], labels [...]."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return masked_mean(lse - gold, mask)


def masked_mean(nll: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean of the token losses ``nll`` where ``mask`` is set (all of
    them without one)."""
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / m.sum().clamp_min(1.0)
    return nll.mean()
