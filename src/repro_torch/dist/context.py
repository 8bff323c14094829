"""Context-parallel attention over a section mesh's ``seq`` axis (paper
§3.2: the ``cp`` knob of a section's ``C^s``).

Counterpart of ``repro/dist/context.py``.  The reference is one
controller: its arrays are global and a ``shard_map`` hands each device
its sequence shard.  The port runs one process a rank, so each rank holds
its own shard ``[B, S/cp, H, D]`` of q, k and v (its data rows and its
sequence columns) and talks to the other ranks of its ``seq`` group.
Three exact modes, each running the in-shard attention through
``kernels.ops`` (the CUDA flash kernel for CUDA tensors, its plain
version for CPU tensors):

* ``ulysses`` -- an all-to-all reshards ``[B, S/cp, H, D]`` to ``[B, S,
  H/cp, D]``, flash attention runs over the whole sequence on a slice of
  the heads, and an all-to-all reshards back.  Needs ``H % cp == 0`` and
  ``KV % cp == 0``.  With ``overlap_chunks = c > 1`` the K/V all-to-alls
  go chunk by chunk and the partial outputs merge exactly
  (:func:`~repro_torch.kernels.flash_attention.merge_flash_partials`);
  chunk ``j`` of every rank's shard lands interleaved, at global positions
  ``d * S/cp + j * S/(cp c) + [0, S/(cp c))`` for each rank ``d``, which
  the kernel takes as ``kv_positions``.
* ``ulysses_mqa`` -- KV heads repeated ``cp / gcd(KV, cp)`` times so that
  they split over the ranks, then plain ulysses.
* ``allgather`` -- q stays sequence-sharded, K and V are all-gathered and
  the causal mask is offset by the shard's first position.

torch.distributed records no gradient through a collective, so each one
is a ``torch.autograd.Function`` here: an all-to-all's backward is the
inverse all-to-all and an all-gather's is a reduce-scatter (sum).

:func:`cp_attention_impl` gives the callable that
``models.attention.attention_impl`` installs: every self-attention call of
a model then runs :func:`cp_attention`, and RoPE takes the shard's global
positions from it (the reference's arrays are global, so its positions
are already right).  The reference's ``impl`` (kernel tier),
``block_q``/``block_kv``, ``batch_axes`` (a layout pin inside its
``shard_map``) and ``axis`` have no counterpart: the port dispatches by
device, its kernel picks its own tiles, a rank's rows are its own, and
every section mesh names its CP axis ``seq``.  The same attention runs
over another group of axes (``axes=``): the train steps give it the data
axes when a global batch smaller than them is laid out with its sequence
over them, as the reference's ``batch_spec`` does (``train.step
.DataLayout``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import AXIS_SEQ, axes_group
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import merge_flash_partials

CP_MODES = ("auto", "ulysses", "ulysses_mqa", "allgather")


def _ulysses_ok(H: int, KV: int, cp: int) -> bool:
    return H % cp == 0 and KV % cp == 0


def _mqa_ok(H: int, KV: int, cp: int) -> bool:
    if H % cp or H % KV:
        return False
    r = cp // math.gcd(KV, cp)
    return (H // KV) % r == 0


def resolve_cp_mode(mode: str, *, H: int, KV: int, cp: int,
                    section: Optional[str] = None) -> str:
    """Resolve ``auto`` to a concrete CP attention mode; validate explicit
    modes against the head counts (a requested mode that cannot run is a
    config error, attributed to ``section``)."""
    where = f" (section {section!r})" if section else ""
    if mode not in CP_MODES:
        raise ValueError(f"cp_attention{where}: unknown mode {mode!r}, "
                         f"expected one of {CP_MODES}")
    if cp == 1:
        return "ulysses"            # degenerate: no resharding either way
    if mode == "auto":
        if _ulysses_ok(H, KV, cp):
            return "ulysses"
        from repro_torch.roofline.analysis import cp_attention_comm
        ag = cp_attention_comm("allgather", H=H, KV=KV, D=1, cp=cp, S=cp)
        if _mqa_ok(H, KV, cp):
            mqa = cp_attention_comm("ulysses_mqa", H=H, KV=KV, D=1,
                                    cp=cp, S=cp)
            if mqa["wire_bytes"] < ag["wire_bytes"]:
                return "ulysses_mqa"
        return "allgather"
    if mode == "ulysses" and not _ulysses_ok(H, KV, cp):
        raise ValueError(
            f"cp_attention{where}: mode='ulysses' needs H % cp == 0 and "
            f"KV % cp == 0, got H={H}, KV={KV}, cp={cp} — use "
            f"'ulysses_mqa', 'allgather', or 'auto'")
    if mode == "ulysses_mqa" and not _mqa_ok(H, KV, cp):
        raise ValueError(
            f"cp_attention{where}: mode='ulysses_mqa' needs H % cp == 0 "
            f"and cp/gcd(KV, cp) to divide H/KV, got H={H}, KV={KV}, "
            f"cp={cp}")
    return mode


# --------------------------------------------------------------------------- #
# Collectives with a gradient
# --------------------------------------------------------------------------- #
def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [n, ...] -> [n, ...]: block ``r`` goes to rank ``r`` of
    ``group``, and block ``r`` of the result came from rank ``r``."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S/n, H, D] sequence shards -> [B, S, H/n, D] head slices (JAX's
    tiled ``all_to_all(split_axis=2, concat_axis=1)``)."""
    n = dist.get_world_size(group)
    B, sl, H, D = x.shape
    blocks = x.reshape(B, sl, n, H // n, D).permute(2, 0, 1, 3, 4)
    got = _all_to_all(blocks, group)              # [n, B, S/n, H/n, D]
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * sl, H // n, D)


def _heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S, H/n, D] head slices -> [B, S/n, H, D] sequence shards (the
    inverse of :func:`_seq_to_heads`)."""
    n = dist.get_world_size(group)
    B, S, h, D = x.shape
    blocks = x.reshape(B, n, S // n, h, D).permute(1, 0, 2, 3, 4)
    got = _all_to_all(blocks, group)              # [n, B, S/n, H/n, D]
    return got.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * h, D)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.group), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.group), None


class _GatherSeq(torch.autograd.Function):
    """[B, S/n, ...] shards -> [B, S, ...] in rank order; the backward
    sums each rank's cotangent of every shard onto its owner."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        parts = [c.contiguous() for c in g.chunk(n, dim=1)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=ctx.group)
        return out, None


# --------------------------------------------------------------------------- #
# CP attention
# --------------------------------------------------------------------------- #
def _chunk_positions(cp: int, shard_len: int, j: int, cl: int,
                     device) -> torch.Tensor:
    """The global key positions of chunk ``j`` after the all-to-all, as
    the contiguous int32 tensor the flash kernel takes, made on the
    device (no host copy on the stream)."""
    rank = torch.arange(cp, device=device, dtype=torch.int32)[:, None]
    col = torch.arange(cl, device=device, dtype=torch.int32)[None, :]
    return (rank * shard_len + j * cl + col).reshape(-1).contiguous()


def cp_attention(q, k, v, mesh, *, mode: str = "auto", causal: bool = True,
                 window: int = 0,
                 scale: Optional[float] = None, overlap_chunks: int = 1,
                 section: Optional[str] = None,
                 seq_group: Optional[tuple] = None):
    """Context-parallel GQA attention on this rank's sequence shard.

    q [B, S/cp, H, D]; k, v [B, S/cp, KV, D] -- rank ``c`` of the mesh's
    sequence group holds global positions ``[c S/cp, (c+1) S/cp)``: the
    group of its ``seq`` axis (``dist.sharding.section_mesh``'s), or
    ``seq_group``, ``dist.sharding.axes_group(mesh, axes)`` of other axes
    (the data axes of a batch laid out with its sequence over them).
    Returns this rank's [B, S/cp, H, D].  Every rank of the group calls it
    with the same shapes and arguments.

    overlap_chunks -- ulysses only: the K/V all-to-alls go in this many
    chunks and the partial flash outputs are merged (exact); must divide
    S/cp.  The allgather and ulysses_mqa modes ignore it."""
    group, cp, idx = seq_group or axes_group(mesh, (AXIS_SEQ,))
    B, shard_len, H, D = q.shape
    KV = k.shape[2]
    mode = resolve_cp_mode(mode, H=H, KV=KV, cp=cp, section=section)
    where = f" (section {section!r})" if section else ""
    chunks = int(overlap_chunks)
    if chunks < 1:
        raise ValueError(f"cp_attention{where}: overlap_chunks={chunks} "
                         f"must be >= 1")
    if mode != "ulysses":
        chunks = 1
    if shard_len % chunks:
        raise ValueError(
            f"cp_attention{where}: overlap_chunks={chunks} must divide "
            f"the local sequence shard S/cp={shard_len}")
    kw = dict(causal=causal, window=window, scale=scale)
    if mode == "allgather":
        kg = _GatherSeq.apply(k, group)
        vg = _GatherSeq.apply(v, group)
        return kops.flash_attention(q, kg, vg, q_offset=idx * shard_len,
                                    **kw)
    if mode == "ulysses_mqa":
        # replicate KV heads so that they head-shard, then plain ulysses
        r = cp // math.gcd(KV, cp)
        k = k.repeat_interleave(r, dim=2)
        v = v.repeat_interleave(r, dim=2)
    qh = _SeqToHeads.apply(q, group)
    if chunks == 1:
        o = kops.flash_attention(qh, _SeqToHeads.apply(k, group),
                                 _SeqToHeads.apply(v, group), **kw)
        return _HeadsToSeq.apply(o, group)
    # per-chunk K/V all-to-alls and partial flash calls, merged exactly;
    # after the all-to-all, rank d's sub-slice of chunk j sits at global
    # positions d * S/cp + j * cl + [0, cl): hence kv_positions
    cl = shard_len // chunks
    parts_o, parts_lse = [], []
    for j in range(chunks):
        kj = _SeqToHeads.apply(k[:, j * cl:(j + 1) * cl], group)
        vj = _SeqToHeads.apply(v[:, j * cl:(j + 1) * cl], group)
        pos = _chunk_positions(cp, shard_len, j, cl, q.device)
        oj, lse_j = kops.flash_attention_lse(qh, kj, vj, kv_positions=pos,
                                             **kw)
        parts_o.append(oj)
        parts_lse.append(lse_j)
    o, _ = merge_flash_partials(parts_o, parts_lse)
    return _HeadsToSeq.apply(o, group)


def cp_attention_impl(mesh, *, mode: str = "auto", overlap_chunks: int = 1,
                      section: Optional[str] = None, axes=(AXIS_SEQ,)):
    """The model-pluggable CP attention: a callable with the
    ``models.attention.attention_impl`` contract -- ``impl(q, k, v, *,
    causal, window, segment_q, segment_kv, scale)`` on this rank's
    sequence shard -- that runs :func:`cp_attention` over the group of
    this mesh's ``axes`` (its ``seq`` axis by default; the data axes for a
    batch whose sequence is laid out over them), and whose
    ``positions(S_local, device)`` gives the shard's global positions for
    RoPE.  ``section`` names the installing section
    in unsupported-feature errors.  Its ``whole_sequence(x)`` and
    ``own_columns(y)`` run a layer that needs the whole sequence (a Mamba
    mixer's scan, a MoE layer's per-sample capacity) on the gathered
    shards, every sequence rank alike, and keep the rank's columns."""
    where = f" (section {section!r})" if section else ""
    cached: list = []

    def seq_group() -> tuple:
        """(group, size, index) of the axes, made at the first call."""
        if not cached:
            cached.append(axes_group(mesh, axes))
        return cached[0]

    def _impl(q, k, v, *, causal=True, window=0, segment_q=None,
              segment_kv=None, scale=None):
        if segment_q is not None or segment_kv is not None:
            raise NotImplementedError(
                f"cp_attention{where}: packed-sequence segment ids are "
                f"not supported under context parallelism")
        if q.shape[1] != k.shape[1]:
            raise NotImplementedError(
                f"cp_attention{where}: cross-attention (S_q != S_kv) is "
                f"not supported under context parallelism")
        return cp_attention(q, k, v, mesh, mode=mode, causal=causal,
                            window=window, scale=scale,
                            overlap_chunks=overlap_chunks, section=section,
                            seq_group=seq_group())

    def positions(shard_len: int, device) -> torch.Tensor:
        first = seq_group()[2] * shard_len
        return torch.arange(first, first + shard_len, device=device)

    def whole_sequence(x: torch.Tensor) -> torch.Tensor:
        """The shards [B, S/cp, ...] of every sequence rank, gathered into
        [B, S, ...]; the gradient of each rank's copy sums back onto the
        shards' owners."""
        return _GatherSeq.apply(x, seq_group()[0])

    def own_columns(y: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a whole-sequence [B, S, ...]."""
        _, n_ranks, idx = seq_group()
        n = y.shape[1] // n_ranks
        return y[:, idx * n:(idx + 1) * n]

    _impl.positions = positions
    _impl.whole_sequence = whole_sequence
    _impl.own_columns = own_columns
    return _impl
