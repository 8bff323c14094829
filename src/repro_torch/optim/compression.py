"""Gradient compression for the data-parallel all-reduce: bf16, and int8
with error feedback.

Counterpart of ``repro/optim/compression.py``.  Halving (bf16) or
quartering (int8) the bytes of the gradient all-reduce is a direct win on
the collective's time at scale.  int8 uses per-tensor max-abs scaling and
an error-feedback residual: the quantization error is added back into the
next step's gradient, which keeps the long-run update unbiased.

Both methods use the reference's compressed all-reduce decomposition, so
the compressed dtype is what goes on the wire:

1. compress locally, flatten, pad to a multiple of ``n`` and split into
   ``n`` chunks;
2. ``all_to_all_single`` the chunks (a reduce-scatter's data movement);
3. dequantize **per source**, each with its own scale, and sum in float32;
4. re-compress the reduced chunk and all-gather it.

The reference bitcasts bf16 to uint16 because XLA's CPU backend upcasts a
bf16 collective; ``torch.distributed`` sends bf16 and int8 as they are
(gloo refuses uint16 and int16 in ``all_to_all_single``).  The reference
skips the collectives when the axis has one member; the port runs the same
decomposition on a one-rank group too, so that the wire path runs wherever
the step does: the bf16 result is then the reference's bit for bit, and
the int8 one is within one float32 rounding of the scale.

Each collective wrapper counts, in plain integer attributes, the payload
bytes it hands to its collectives, by dtype: the all-to-all's send buffer
(the all-gather sends ``1/n`` of it back, so both phases carry the same
share under the ring model) and, for int8, the float32 scales apart
(``compressed_psum_int8.int8_bytes`` / ``.float32_bytes``,
``compressed_psum_bf16.bfloat16_bytes``, ``psum.float32_bytes``).  Divided
by :func:`wire_bytes` of the tree in float32 they give the wire ratio.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.distributed as dist
import torch.profiler

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten

METHODS = ("none", "bf16", "int8")


def _quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    with torch.profiler.record_function("compression.quantize"):
        xf = x.float()
        scale = xf.abs().max().clamp_min(1e-12) / 127.0
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        return q, scale


def _dequant_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    with torch.profiler.record_function("compression.dequantize"):
        return q.float() * scale


def _chunk(flat: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(n, -1), pad


def _unchunk(flat: torch.Tensor, pad: int, shape) -> torch.Tensor:
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def _all_to_all(chunks: torch.Tensor, group) -> torch.Tensor:
    recv = torch.empty_like(chunks)
    dist.all_to_all_single(recv, chunks, group=group)
    return recv


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The float32 sum-reduce over ``group`` (the uncompressed method)."""
    out = x.float().clone()
    psum.float32_bytes += out.numel() * 4
    dist.all_reduce(out, group=group)
    return out


psum.float32_bytes = 0


def compressed_psum_int8(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-on-the-wire sum-reduce over ``group``: all-to-all of int8
    chunks, an exact per-source dequantize and float32 sum, requantize,
    all-gather of int8."""
    n = dist.get_world_size(group)
    q, scale = _quant_int8(x)
    chunks, pad = _chunk(q.reshape(-1), n)                     # [n, C] int8
    compressed_psum_int8.int8_bytes += chunks.numel()
    compressed_psum_int8.float32_bytes += 2 * 4
    recv = _all_to_all(chunks, group)
    scales = _all_gather(scale.reshape(1), group)[:, 0]        # [n] f32
    with torch.profiler.record_function("compression.dequantize"):
        part = (recv.float() * scales[:, None]).sum(dim=0)
    rq, rscale = _quant_int8(part)                             # phase 2
    out_q = _all_gather(rq, group)                             # [n, C] int8
    out_s = _all_gather(rscale.reshape(1), group)              # [n, 1] f32
    with torch.profiler.record_function("compression.dequantize"):
        out = (out_q.float() * out_s).reshape(-1)
    return _unchunk(out, pad, x.shape).to(x.dtype)


compressed_psum_int8.int8_bytes = 0
compressed_psum_int8.float32_bytes = 0


def compressed_psum_bf16(x: torch.Tensor, group=None) -> torch.Tensor:
    """bf16-on-the-wire sum-reduce over ``group``: all-to-all of bf16
    chunks, float32 sum, round to bf16, all-gather."""
    n = dist.get_world_size(group)
    with torch.profiler.record_function("compression.quantize"):
        sent = x.to(torch.bfloat16)
    chunks, pad = _chunk(sent.reshape(-1), n)                  # [n, C] bf16
    compressed_psum_bf16.bfloat16_bytes += chunks.numel() * 2
    recv = _all_to_all(chunks, group)
    with torch.profiler.record_function("compression.dequantize"):
        part = recv.float().sum(dim=0)
    with torch.profiler.record_function("compression.quantize"):
        part = part.to(torch.bfloat16)
    out = _all_gather(part, group).reshape(-1)
    with torch.profiler.record_function("compression.dequantize"):
        out = out.float()
    return _unchunk(out, pad, x.shape).to(x.dtype)


compressed_psum_bf16.bfloat16_bytes = 0


def reset_wire_counts() -> None:
    psum.float32_bytes = 0
    compressed_psum_int8.int8_bytes = 0
    compressed_psum_int8.float32_bytes = 0
    compressed_psum_bf16.bfloat16_bytes = 0


def wire_counts() -> dict:
    """The payload bytes counted since :func:`reset_wire_counts`, by
    wrapper and dtype."""
    return {"psum.float32": psum.float32_bytes,
            "int8.int8": compressed_psum_int8.int8_bytes,
            "int8.float32": compressed_psum_int8.float32_bytes,
            "bf16.bfloat16": compressed_psum_bf16.bfloat16_bytes}


class ErrorFeedback(NamedTuple):
    residual: Any                 # same tree as grads, float32


def ef_init(grads_like) -> ErrorFeedback:
    return ErrorFeedback(tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
        grads_like))


def ef_compress_tree(grads, ef: ErrorFeedback, group=None,
                     method: str = "int8", *, mean: bool = True):
    """Error-feedback compression and a reduce over ``group`` of a gradient
    tree -> (reduced, new ErrorFeedback).

    ``mean=True`` averages over the group (each rank holds a full gradient
    of its own shard's loss); ``mean=False`` sums (each rank holds a part of
    a global loss's gradient).  The residual is the local (phase-1)
    compression error, added into the next step's gradient before it is
    compressed."""
    if method not in METHODS:
        raise ValueError(f"unknown compression method {method!r}; "
                         f"expected one of {METHODS}")
    cnt = float(dist.get_world_size(group)) if mean else 1.0

    def one(g, r):
        corrected = g.float() + r
        if method == "int8":
            q, scale = _quant_int8(corrected)
            new_r = corrected - _dequant_int8(q, scale)
            out = compressed_psum_int8(corrected, group) / cnt
        elif method == "bf16":
            with torch.profiler.record_function("compression.quantize"):
                sent = corrected.to(torch.bfloat16)
            new_r = corrected - sent.float()
            out = compressed_psum_bf16(corrected, group) / cnt
        else:
            out = psum(corrected, group) / cnt
            new_r = torch.zeros_like(corrected)
        return out.to(g.dtype), new_r

    outs = [one(g, r) for g, r in zip(tree_leaves(grads),
                                      tree_leaves(ef.residual))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            ErrorFeedback(tree_unflatten(grads, [o[1] for o in outs])))


def wire_bytes(tree, method: str) -> int:
    """Per-rank payload bytes a data-parallel reduction of ``tree``
    compresses to (the ring model multiplies every method by the same
    ``2(n-1)/n``, so the payload ratio is the wire ratio)."""
    per = {"int8": 1, "bf16": 2, "none": 4}[method]
    return sum(x.numel() * per for x in tree_leaves(tree))
