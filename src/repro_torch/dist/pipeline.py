"""Stage-partitioned (GPipe) training loss, and Megatron tensor parallelism
inside a stage (paper §3.2: the ``pp`` and ``tp`` knobs of a section's
``C^s``).

Counterpart of ``repro/dist/pipeline.py``.  The reference is one
controller: ``build_pp_loss`` runs a GPipe schedule inside one
``shard_map`` over every mesh axis, hops activations with ``ppermute``
and lets ``jax.grad`` transpose the whole schedule.  The port runs one
process a rank, so each rank holds its stage's blocks as plain tensors and
runs its own part of the schedule:

* **Only the live ticks.**  The reference runs every stage at every tick
  and masks the dead ones (SPMD is uniform); here stage ``s`` runs
  micro-batch ``t`` once, at tick ``t + s``.  The numbers are the same,
  and the router statistics need no live mask.
* **Activations cross stages point to point**: a stage's output goes to
  stage ``s + 1`` with ``dist.send``, and in the backward its input's
  gradient goes back to ``s - 1``.
* **An explicit backward.**  ``loss_fn.value_and_grad`` runs the forward
  schedule, keeps each micro-batch's stage input as a fresh leaf and its
  output, and then the backward in one fixed order on every rank: the
  cross-entropy part (local), the sum of the final hidden's gradient onto
  the last stage, each micro-batch's stage backward in reverse order with
  its boundary gradient sent to the stage before, the embedding's
  gradient from stage 0, and last the sums of the leaves that several
  stages share.  Blocking point-to-point calls and collectives then pair
  up in the same order on every rank, which autograd's own traversal of
  one graph holding all of them would not fix.
* **Vocab-parallel cross-entropy**, as in the reference: the last stage's
  final hidden is broadcast over the stage axis, each stage scores its
  ``padded_vocab / pp`` slice of ``embed`` (tied) or ``unembed``, and the
  slices combine through a distributed logsumexp (the max is an
  all-reduce MAX of a detached value) and a sum of the gold logit.  A
  tied embedding lookup is a sum over the stages of masked rows, exact
  because each row lives on one stage.  Where the padded vocabulary does
  not divide the stages, the last stage alone scores the whole vocabulary
  (the masked path).
* **The MoE aux**: each MoE layer's router statistics (``moe(...,
  return_stats=True)``) are summed over the micro-batches and divided by
  their number, averaged over the data axes, and only then combined into
  ``E * sum(frac * prob) / K`` per stage; the stages' terms add up.  The
  result equals the monolithic loss's aux over the whole batch.
* **Gradients of leaves shared across ranks**, which the reference's
  ``shard_map`` sums when it transposes a replicated input: a leaf the
  stage axis does not split (``final_norm``, and on the masked path
  ``embed``/``unembed`` and ``vision_proj``) takes contributions on
  several stages and is summed over the stage axis; a stage's own layer
  block and vocabulary slice are not.  Every leaf's gradient is summed
  over the data axes.  Nothing is summed over ``model``: see below.

Megatron tensor parallelism (:class:`TensorParallel`, the reference's
``tp_axis``/``tp_attn``/``tp_ffn``): the attention mixer on this rank's
``H/tp`` query and ``KV/tp`` key-value heads (in the plain and cp regimes,
where ``tp`` is a multiple of the KV heads above them, the one KV head of
its query heads' group, :func:`kv_repeat`) and the FFN on its ``d_ff /
tp`` columns each sit between a conjugate pair of autograd Functions.  In
front of the region, :class:`_CopyToGroup` is the identity forward and
all-reduces the gradient over the model group in the backward; after it,
:class:`_ReduceFromGroup` all-reduces the partial outputs forward and is
the identity backward (the reference's ``psum`` inside ``shard_map`` gives
both).  Every tensor a region reads that is not sliced (the input, a GELU
MLP's ``b_out`` scaled by 1/tp, a MoE layer's gates) goes through the
first, so that every model rank ends the backward with the whole gradient
of every leaf it does not slice: those gradients are not summed over
``model``; a KV head that several ranks share is the exception, its
gradient summed over them as the compute blocks are reduced
(``dist.sharding.reduce_to``).  :func:`_tp_plan` gates which regions are
sliced; Mamba mixers and the MoE router and expert dims stay whole, as in
the reference.  The staged loss keeps the reference's gate (KV divided by
tp).  At tp 1 the same code runs with a one-rank group.

The train step (``train/step.py``) builds this loss for a mesh whose
``pipe`` axis is above 1 and runs :class:`TensorParallel` in its plain
regime on a ``model`` axis above 1; the compound runtime does the latter
for a section.  The reference's ``impl`` (kernel tier) and ``act_hook``
(XLA layout hooks) have no counterpart: the port dispatches by device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from repro_torch.core.types import ArchConfig
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import (AXIS_DATA, AXIS_MODEL, AXIS_PIPE,
                                       AXIS_POD, P)
from repro_torch.models import attention as att
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.models.common import (tree_leaves, tree_like, tree_map,
                                       tree_unflatten)


# --------------------------------------------------------------------------- #
# Collectives with a gradient
# --------------------------------------------------------------------------- #
class _CopyToGroup(torch.autograd.Function):
    """Megatron's ``f``: the identity forward, an all-reduce (sum) of the
    gradient over ``group`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """:class:`_CopyToGroup` (Megatron's ``f``) over ``group``."""
    return _CopyToGroup.apply(x, group)


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's ``g``: an all-reduce (sum) forward, the identity
    backward.  Also the sum a replicated loss is built from (every rank
    differentiates its own term)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOverGroups(torch.autograd.Function):
    """The mean of ``x`` over the ranks of ``groups`` (their product has
    ``n`` ranks), forward and backward: each rank's statistics weigh 1/n
    in the mean every rank then holds, and each rank's loss reads that
    mean, so a rank's gradient is the mean of every rank's cotangent."""

    @staticmethod
    def forward(ctx, x, groups, n):
        ctx.groups, ctx.n = groups, n
        x = x.contiguous().clone()
        for g in groups:
            dist.all_reduce(x, group=g)
        return x / n

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g / ctx.n, None, None


def mean_over(x: torch.Tensor, groups: Sequence, n: int) -> torch.Tensor:
    """:class:`_MeanOverGroups`: ``x`` averaged over the ranks of
    ``groups``, with the gradient of a loss that every rank holds."""
    return _MeanOverGroups.apply(x, tuple(groups), n)


# --------------------------------------------------------------------------- #
# Vocab-parallel cross-entropy
# --------------------------------------------------------------------------- #
def vocab_max(logits: torch.Tensor) -> torch.Tensor:
    """A vocabulary slice's row maxima [...] of its float32 logits [...,
    Vs] (padded columns masked), to be maxed over the slices."""
    return logits.detach().amax(dim=-1)


def vocab_partials(logits: torch.Tensor, labels: torch.Tensor, off: int,
                   mx: torch.Tensor) -> tuple:
    """One slice's part of the cross-entropy, given the row maxima ``mx``
    over every slice: (``exp(logits - mx)`` [..., Vs], its row sums [...],
    the gold logit where the label falls in the slice ``[off, off + Vs)``
    else 0 [...], the label's column in the slice (clamped) and whether it
    falls there).  The row sums and gold logits are summed over the
    slices."""
    vs = logits.shape[-1]
    ex = torch.exp(logits.detach() - mx[..., None])
    loc = labels.long() - off
    mine = (loc >= 0) & (loc < vs)
    col = loc.clamp(0, vs - 1)
    gold = torch.gather(logits.detach(), -1, col[..., None])[..., 0]
    return ex, ex.sum(dim=-1), gold * mine, col, mine


def vocab_nll(mx: torch.Tensor, se: torch.Tensor,
              gold: torch.Tensor) -> torch.Tensor:
    """The token NLL from the row maxima, exponential sums and gold logits
    combined over every slice."""
    return torch.log(se) + mx - gold


def vocab_grad(ex: torch.Tensor, se: torch.Tensor, col: torch.Tensor,
               mine: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The NLL's gradient on one slice's logits: the slice's softmax
    (``ex`` over the summed ``se``) minus its one-hot, times ``g``."""
    out = ex / se[..., None]
    out.scatter_add_(-1, col[..., None], -mine.to(out.dtype)[..., None])
    return out * g[..., None]


class _VocabParallelNLL(torch.autograd.Function):
    """The token NLL of logits whose vocabulary is split over ``group``:
    each rank holds the float32 logits of its slice ``[off, off + Vs)``;
    the row maxima are max-reduced, the exponential sums and gold logits
    sum-reduced over the group, and every rank returns the whole NLL.  Its
    backward is this slice's softmax minus its one-hot: the gradient of
    the rank's own logits, which is what each rank differentiates."""

    @staticmethod
    def forward(ctx, logits, labels, off, group):
        mx = vocab_max(logits)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
        ex, se, gold, col, mine = vocab_partials(logits, labels, off, mx)
        sums = torch.stack([se, gold])
        dist.all_reduce(sums, group=group)
        ctx.save_for_backward(ex, sums[0], col, mine)
        return vocab_nll(mx, sums[0], sums[1])

    @staticmethod
    def backward(ctx, g):
        ex, se, col, mine = ctx.saved_tensors
        return vocab_grad(ex, se, col, mine, g), None, None, None


class _GatherVocab(torch.autograd.Function):
    """An output layer's vocabulary slices [D, V/n] gathered whole over
    ``group`` into [D, V]; the backward sums every rank's gradient of the
    whole and keeps this rank's slice (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, w, group):
        ctx.group = group
        return shd._all_gather_dim(w, 1, group)

    @staticmethod
    def backward(ctx, g):
        return shd._reduce_scatter_dim(g.contiguous(), 1, ctx.group), None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, off: int,
                       group) -> torch.Tensor:
    """:class:`_VocabParallelNLL`: the NLL [...] of every token from this
    rank's float32 logits [..., Vs] of the vocabulary slice starting at
    ``off``, combined over ``group``."""
    return _VocabParallelNLL.apply(logits, labels, off, group)


@dataclass(frozen=True)
class TensorParallel:
    """Megatron tensor parallelism over one model group: ``attn`` and
    ``ffn`` say which regions compute on this rank's slice (the gates of
    :func:`_tp_plan`); ``kv_repeat`` is :func:`kv_repeat`'s count of
    ranks that share a KV head (1: the ranks split the KV heads).
    ``enter`` and ``exit`` are the conjugate pair around a region (see
    the module docstring).  ``vocab``: the output layer (and a tied
    embedding) computes on this rank's ``1/size`` slice of the padded
    vocabulary, the ``index``-th, and the cross-entropy combines the
    slices (:meth:`nll`)."""
    group: Any
    size: int
    attn: bool
    ffn: bool
    kv_repeat: int = 1
    vocab: bool = False
    index: int = 0

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToGroup.apply(x, self.group)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromGroup.apply(x, self.group)

    def vocab_offset(self, vs: int) -> int:
        """The first vocabulary row of this rank's slice of ``vs``."""
        return self.index * vs if self.vocab else 0

    def gather_vocab(self, w: torch.Tensor) -> torch.Tensor:
        """This rank's output-layer slice [D, V/size] gathered whole
        (:class:`_GatherVocab`), each rank's gradient of the whole summed
        into its slice."""
        return _GatherVocab.apply(w, self.group)

    def nll(self, logits: torch.Tensor, labels: torch.Tensor
            ) -> torch.Tensor:
        """:func:`vocab_parallel_nll` of this rank's slice over the model
        group."""
        return vocab_parallel_nll(logits, labels,
                                  self.vocab_offset(logits.shape[-1]),
                                  self.group)


# --------------------------------------------------------------------------- #
# Layout
# --------------------------------------------------------------------------- #
def _stage_axis(mesh, axis: Optional[str]) -> str:
    if axis is not None:
        return axis
    return AXIS_PIPE if AXIS_PIPE in shd.mesh_shape(mesh) else AXIS_POD


def _data_axes(mesh, st_ax: str, data_axis) -> tuple:
    """The data axes of the schedule, outermost first: every one of
    (pod, data) the mesh has that is not the stage axis (on a multi-pod
    pipeline mesh the pod axis carries data too, as in
    ``sharding.dp_axes``)."""
    if data_axis is not None:
        return (data_axis,) if isinstance(data_axis, str) else \
            tuple(data_axis)
    return tuple(a for a in (AXIS_POD, AXIS_DATA)
                 if a in shd.mesh_shape(mesh) and a != st_ax)


def contiguous_microbatch(tree, t: int, msz: int):
    """Micro-batch ``t``: the ``t``-th contiguous ``msz`` rows of the
    data shard's batch.  Under the shard-major layout ``[dp, n_micro,
    mbs]`` of the train step this is the micro-batch
    ``_split_microbatches`` gives."""
    return tree_map(lambda a: a[t * msz:(t + 1) * msz], tree)


def kv_repeat(cfg: ArchConfig, tp: int) -> int:
    """The ranks of a ``model`` axis of ``tp`` that share each KV head when
    the axis exceeds the KV heads and is a multiple of them: ``tp / KV``
    (Megatron's rule for GQA; each rank's ``H / tp`` contiguous query
    heads then lie in one group, and the rank takes that group's KV head,
    ``r // (tp / KV)``).  1 otherwise."""
    kv = cfg.num_kv_heads
    return tp // kv if 0 < kv < tp and tp % kv == 0 else 1


def _tp_plan(cfg: ArchConfig, mesh, st_ax: Optional[str], *,
             repeat_kv: bool = False):
    """(tp_axis, tp_attn, tp_ffn): which stage-body dims the ``model``
    axis slices exactly.  Attention needs ``head_pad == 0`` and ``H % tp
    == KV % tp == 0`` (contiguous head slices then keep GQA groups
    whole), or with ``repeat_kv`` (the plain and cp regimes) ``H % tp ==
    0`` and a :func:`kv_repeat` above 1; the FFN needs ``d_ff % tp ==
    0``."""
    tp = shd.mesh_shape(mesh).get(AXIS_MODEL, 1)
    if tp <= 1 or st_ax == AXIS_MODEL:
        return None, False, False
    has_attn = any(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    kv = cfg.num_kv_heads
    tp_attn = (has_attn and cfg.head_pad == 0 and cfg.num_heads % tp == 0
               and kv > 0 and (kv % tp == 0 or (
                   repeat_kv and kv_repeat(cfg, tp) > 1)))
    tp_ffn = cfg.d_ff > 0 and cfg.d_ff % tp == 0
    if not (tp_attn or tp_ffn):
        return None, False, False
    return AXIS_MODEL, tp_attn, tp_ffn


def _tp_spec(s, st_ax: Optional[str], tp_axis, tp_attn: bool, tp_ffn: bool,
             kv_rep: int = 1):
    """The spec of one leaf (``ParamSpec`` ``s``) as a stage body computes
    it: the stacked dim on the stage axis (None: every layer), and under
    TP ``heads``/``kv_heads`` (attention) and ``mlp`` (FFN) on the model
    axis, ``kv_heads`` repeated ``kv_rep`` times first
    (``dist.sharding.Repeated``) where the ranks share KV heads."""
    entries = []
    for ax in s.axes:
        if ax == "layers":
            entries.append(st_ax)
        elif tp_attn and ax == "kv_heads" and kv_rep > 1:
            entries.append(shd.Repeated(tp_axis, kv_rep))
        elif tp_attn and ax in ("heads", "kv_heads"):
            entries.append(tp_axis)
        elif tp_ffn and ax == "mlp":
            entries.append(tp_axis)
        else:
            entries.append(None)
    return P(*entries)


def compute_specs(cfg: ArchConfig, *, stage_axis: Optional[str] = None,
                  tp_axis=None, tp_attn: bool = False, tp_ffn: bool = False,
                  vocab_axis: Optional[str] = None, kv_rep: int = 1) -> dict:
    """The spec tree of the blocks a rank computes with (the reference's
    ``shard_map`` in_specs): the layer blocks of :func:`_tp_spec`, the
    vocab dim of ``embed`` (tied) or ``unembed`` on ``vocab_axis`` under
    vocab-parallel CE (the stage axis in the pipeline, ``model`` under
    tensor parallelism), every other leaf whole."""
    specs = tf.lm_specs(cfg)
    out = {k: tree_map(lambda s: P(), v) for k, v in specs.items()
           if k != "layers"}
    out["layers"] = tree_map(
        lambda s: _tp_spec(s, stage_axis, tp_axis, tp_attn, tp_ffn, kv_rep),
        specs["layers"])
    if vocab_axis is not None and cfg.tie_embeddings:
        out["embed"] = P(vocab_axis, None)
    if vocab_axis is not None and "unembed" in out:
        out["unembed"] = P(None, vocab_axis)
    return out


def vocab_splits(cfg: ArchConfig, mesh) -> bool:
    """Whether the padded vocabulary splits over ``mesh``'s model axis
    above 1 (the reference's ``vocab`` rule on ``model``)."""
    tp = shd.mesh_shape(mesh).get(AXIS_MODEL, 1)
    return tp > 1 and cfg.padded_vocab % tp == 0


def tensor_parallel(cfg: ArchConfig, mesh, *, repeat_kv: bool = False,
                    vocab: bool = False) -> Optional[TensorParallel]:
    """The plain regime's :class:`TensorParallel` on ``mesh``'s model
    axis, or None where the axis is 1 or no region passes the gates.
    ``repeat_kv``: attention also slices where the axis is a multiple of
    the KV heads above them, each KV head on :func:`kv_repeat` ranks (the
    train steps; the serving builders keep the reference's gate).
    ``vocab``: the output layer and the cross-entropy split the padded
    vocabulary over the axis where it divides it (the reference's
    ``vocab`` rule on ``model``; the train step's loss)."""
    tp = shd.mesh_shape(mesh).get(AXIS_MODEL, 1)
    tp_axis, tp_attn, tp_ffn = _tp_plan(cfg, mesh, None, repeat_kv=repeat_kv)
    vp = vocab and vocab_splits(cfg, mesh)
    if tp_axis is None and not vp:
        return None
    return TensorParallel(mesh.get_group(AXIS_MODEL), tp, tp_attn, tp_ffn,
                          kv_repeat(cfg, tp) if tp_attn else 1, vp,
                          shd.coordinate(mesh)[AXIS_MODEL])


def tp_rank_blocks(cfg: ArchConfig, tree, specs, tp: int, rank: int):
    """Model rank ``rank``'s compute blocks of ``tree`` under the plain
    regime's tensor parallelism at ``tp`` (KV heads repeated where ``tp``
    exceeds them), from its coordinate alone, with no collective.
    ``tree`` is any part of the parameters (one attention sub-layer's
    ``{wq, wk, wv, wo}``, say) and ``specs`` its ParamSpec tree.  At tp >
    KV the rank's attention blocks hold ``H / tp`` query heads and the
    one KV head of their group."""
    mesh = {AXIS_MODEL: tp}
    _, tp_attn, tp_ffn = _tp_plan(cfg, mesh, None, repeat_kv=True)
    rep = kv_repeat(cfg, tp) if tp_attn else 1
    return tree_unflatten(tree, [
        shd.shard(x, _tp_spec(s, None, AXIS_MODEL, tp_attn, tp_ffn, rep),
                  mesh, {AXIS_MODEL: rank})
        for x, s in zip(tree_leaves(tree), tree_leaves(tree_like(tree,
                                                                  specs)))])


# --------------------------------------------------------------------------- #
# The staged loss
# --------------------------------------------------------------------------- #
class PipelineLoss:
    """``loss_fn`` of :func:`build_pp_loss` (see the module docstring).

    ``loss_fn(params, batch)`` is the forward alone and
    ``loss_fn.value_and_grad(params, batch)`` the loss and its gradients.
    ``params`` is this rank's tree of blocks under ``loss_fn.specs`` (a
    full tree gives them through ``loss_fn.local(full)``); ``batch`` is
    the global batch, the same on every rank, of which the rank keeps its
    data shard's contiguous rows when they divide into the data axes and
    the micro-batches (else every data rank runs the whole batch, and no
    sum over the data axes follows).  With ``sharded=`` True or False the
    batch is this rank's block instead: its rows of that split, or the
    whole batch every data rank runs.  Every rank of the mesh calls them
    together."""

    def __init__(self, cfg: ArchConfig, mesh, n_micro: int, *, st_ax: str,
                 d_ax: tuple, remat: bool, aux_weight: float, causal: bool,
                 vp: bool, Vs: int, tp: Optional[TensorParallel],
                 specs: dict, mb_layout: Callable):
        self.cfg, self.mesh, self.n_micro = cfg, mesh, n_micro
        self.st_ax, self.d_ax = st_ax, d_ax
        self.remat, self.aux_weight, self.causal = remat, aux_weight, causal
        self.vp, self.Vs, self.tp = vp, Vs, tp
        self.specs, self.mb_layout = specs, mb_layout
        sizes = shd.mesh_shape(mesh)
        coord = shd.coordinate(mesh)
        self.pp, self.stage = sizes[st_ax], coord[st_ax]
        self.dp = shd.axis_size(mesh, d_ax) if d_ax else 1
        self.d_idx = 0
        for a in d_ax:
            self.d_idx = self.d_idx * sizes[a] + coord[a]
        self.pk, _ = tf.group_layout(cfg)
        self.E = max(cfg.num_experts, 1)
        self.pipe_group = mesh.get_group(st_ax)
        # the global ranks of this rank's stage group, in stage order
        self.pipe_ranks = dist.get_process_group_ranks(self.pipe_group)

    # ---- layout ------------------------------------------------------- #
    def local(self, full: dict) -> dict:
        """This rank's blocks of a full parameter tree."""
        return shd.shard_tree(full, tree_like(full, self.specs), self.mesh)

    def grad_axes(self, spec, data: bool = True) -> tuple:
        """The axes a leaf's gradient (under ``spec``) is summed over:
        the stage axis where the stage axis does not split it, then the
        data axes (``data``: the data ranks split the batch)."""
        used = {a for e in spec for a in shd._axes(e)}
        return ((() if self.st_ax in used else (self.st_ax,))
                + (tuple(self.d_ax) if data else ()))

    def _rows(self, batch: dict, sharded: Optional[bool]
              ) -> Tuple[dict, bool]:
        if sharded is not None:
            return batch, sharded and bool(self.d_ax)
        gb = batch["tokens"].shape[0]
        shard = bool(self.d_ax) and gb % (self.dp * self.n_micro) == 0
        if not shard:
            return batch, False
        n = gb // self.dp
        return tree_map(lambda x: x[self.d_idx * n:(self.d_idx + 1) * n],
                        batch), True

    # ---- pieces of the schedule -------------------------------------- #
    def _stage_fwd(self, layers, x):
        """This stage's layer groups -> (x, stats [n_moe, 2, E])."""
        stats = []
        for period in cm.unbind_layers(layers):
            for j, (mixer, ffn) in enumerate(self.pk):
                is_moe = ffn == "moe"
                args = (period[f"sub{j}"], x, self.cfg, mixer, ffn, None,
                        self.causal, is_moe, self.tp)
                if self.remat and torch.is_grad_enabled():
                    out = torch.utils.checkpoint.checkpoint(
                        tf._sublayer_fwd, *args, use_reentrant=False,
                        context_fn=att.remat_context)
                else:
                    out = tf._sublayer_fwd(*args)
                x = out[0]
                if is_moe:
                    stats.append(out[2])
        if stats:
            return x, torch.stack(stats)
        return x, x.new_zeros((0, 2, self.E), dtype=torch.float32)

    def _vp_part(self, p, mb):
        """This stage's masked rows of the tied embedding lookup."""
        return tf.vocab_rows(p["embed"], mb["tokens"], self.stage * self.Vs)

    def _ce(self, p, h, mb):
        """(nll sum, mask sum) of one micro-batch from its final hidden
        ``h`` on this stage (vocab slice, or the whole vocabulary)."""
        cfg = self.cfg
        h = tf.apply_norm(p["final_norm"], h, cfg)
        m = mb.get("loss_mask")
        if self.vp:
            off = self.stage * self.Vs
            logits = tf.unembed(p, cfg, h, offset=off).float()
            nll = vocab_parallel_nll(logits, mb["labels"], off,
                                     self.pipe_group)
        else:
            logits = tf.unembed(p, cfg, h).float()
            nll = torch.logsumexp(logits, dim=-1) - torch.gather(
                logits, -1, mb["labels"].long()[..., None])[..., 0]
        m = torch.ones_like(nll) if m is None else m.float()
        return (nll * m).sum(), m.sum()

    def _send(self, x, to: int):
        dist.send(x.detach().contiguous(), self.pipe_ranks[to])

    def _recv(self, like_shape, dtype, device, frm: int):
        buf = torch.empty(like_shape, dtype=dtype, device=device)
        dist.recv(buf, self.pipe_ranks[frm])
        return buf

    # ---- the schedule ----------------------------------------------- #
    def __call__(self, params: dict, batch: dict, *,
                 sharded: Optional[bool] = None) -> torch.Tensor:
        with torch.no_grad():
            return self._run(params, batch, grad=False, sharded=sharded)[0]

    def value_and_grad(self, params: dict, batch: dict, *,
                       reduce: bool = True, sharded: Optional[bool] = None):
        """-> (loss, gradients): the gradients in ``params``' layout,
        float32.  ``reduce=False`` leaves them unsummed over the axes of
        :meth:`grad_axes` ``(spec, data=sharded)`` (the data axes where
        they split the batch, and the stage axis for a leaf the stages
        share), for a caller that reduce-scatters them."""
        return self._run(params, batch, grad=True, reduce=reduce,
                         sharded=sharded)

    def _run(self, params, batch, *, grad: bool, reduce: bool = True,
             sharded: Optional[bool] = None):
        cfg, pp, s = self.cfg, self.pp, self.stage
        last = pp - 1
        p = tree_map(lambda x: x.detach().requires_grad_(grad), params)
        leaves = tree_leaves(p)
        local, shard_b = self._rows(batch, sharded)
        Bl = local["tokens"].shape[0]
        if Bl % self.n_micro:
            raise ValueError(f"the local batch of {Bl} rows does not split "
                             f"into {self.n_micro} micro-batches")
        msz = Bl // self.n_micro
        mbs = [self.mb_layout(local, t, msz) for t in range(self.n_micro)]
        vp_tied = self.vp and cfg.tie_embeddings
        dev = leaves[0].device
        dtype = p["embed"].dtype
        shape = (msz, local["tokens"].shape[1], cfg.d_model)

        # embeddings: every stage takes part under vp with tied tables
        parts, emb_leaves, inputs = [], [], []
        with torch.set_grad_enabled(grad):
            for t, mb in enumerate(mbs):
                if vp_tied:
                    part = self._vp_part(p, mb)
                    x = part.detach().clone()
                    dist.all_reduce(x, group=self.pipe_group)
                    parts.append(part)
                    if s == 0:
                        x = x.requires_grad_(grad)
                        emb_leaves.append(x)
                        inputs.append(tf.vision_scatter(p, cfg, x, mb))
                elif s == 0:
                    inputs.append(tf.embed_tokens(p, cfg, mb))

            # the forward ticks this stage is live in
            ins, outs, stats = [], [], []
            for t in range(self.n_micro):
                if s == 0:
                    x = inputs[t]
                else:
                    x = self._recv(shape, dtype, dev, s - 1).requires_grad_(
                        grad)
                h, st = self._stage_fwd(p["layers"], x)
                if s < last:
                    self._send(h, s + 1)
                ins.append(x)
                outs.append(h)
                stats.append(st)

            # the MoE aux: statistics over the micro-batches, then the data
            n_moe = stats[0].shape[0]
            aux_tot = torch.zeros((), dtype=torch.float32, device=dev)
            if n_moe:
                st_mean = torch.stack([x.detach() for x in stats]).sum(0) \
                    / self.n_micro
                if shard_b and self.dp > 1:
                    for a in self.d_ax:
                        dist.all_reduce(st_mean, group=self.mesh.get_group(a))
                    st_mean = st_mean / self.dp
                frac, prob = st_mean[:, 0], st_mean[:, 1]
                K = cfg.experts_per_token
                aux_local = self.E * torch.sum(frac * prob) / K
                aux_tot = aux_local.clone()
                dist.all_reduce(aux_tot, group=self.pipe_group)
                # d aux / d stats of one micro-batch on this data rank
                scale = self.aux_weight / (self.n_micro * (
                    self.dp if shard_b else 1))
                d_st = torch.stack([prob, frac], dim=1) * (self.E / K * scale)

            # final norm + unembed + CE sums
            h_leaves, nll, msum = [], None, None
            for j, mb in enumerate(mbs):
                if self.vp:
                    buf = outs[j].detach().clone() if s == last else \
                        torch.empty(shape, dtype=dtype, device=dev)
                    dist.broadcast(buf, self.pipe_ranks[last],
                                   group=self.pipe_group)
                elif s == last:
                    buf = outs[j].detach()
                else:
                    continue
                hj = buf.requires_grad_(grad)
                h_leaves.append(hj)
                a, b = self._ce(p, hj, mb)
                nll = a if nll is None else nll + a
                msum = b if msum is None else msum + b

        zero = torch.zeros((), dtype=torch.float32, device=dev)
        totals = torch.stack([zero if nll is None else nll.detach(),
                              zero if msum is None else msum.detach()])
        sum_ax = () if self.vp else (self.st_ax,)
        if shard_b:
            sum_ax = sum_ax + tuple(self.d_ax)
        for a in sum_ax:
            dist.all_reduce(totals, group=self.mesh.get_group(a))
        denom = totals[1].clamp_min(1.0)
        loss = totals[0] / denom + self.aux_weight * aux_tot
        if not grad:
            return loss, None

        # ---- the backward, in one order on every rank ---------------- #
        acc = [torch.zeros(x.shape, dtype=torch.float32, device=dev)
               for x in leaves]

        def add(gs):
            for a, g in zip(acc, gs):
                if g is not None:
                    a.add_(g.float())

        # (1) the cross-entropy part, local
        dh = [None] * self.n_micro
        if nll is not None:
            got = torch.autograd.grad(nll / denom, leaves + h_leaves,
                                      allow_unused=True)
            add(got[:len(leaves)])
            dh = [torch.zeros_like(x) if g is None else g
                  for x, g in zip(h_leaves, got[len(leaves):])]
        # (2) the final hidden's gradient summed onto the last stage
        if self.vp:
            for j in range(self.n_micro):
                dist.reduce(dh[j], self.pipe_ranks[last],
                            group=self.pipe_group)
        # (3) each micro-batch's stage backward, last first
        d_emb = [None] * self.n_micro
        for t in reversed(range(self.n_micro)):
            g_out = dh[t] if s == last else self._recv(
                shape, dtype, dev, s + 1)
            outs_t, grads_t = [outs[t]], [g_out]
            if n_moe:
                outs_t.append(stats[t])
                grads_t.append(d_st.expand_as(stats[t]).contiguous())
            wrt = list(leaves)
            if s > 0:
                wrt.append(ins[t])
            elif vp_tied:
                wrt.append(emb_leaves[t])
            got = torch.autograd.grad(outs_t, wrt, grads_t,
                                      allow_unused=True)
            add(got[:len(leaves)])
            if s > 0:
                self._send(got[-1], s - 1)
            elif vp_tied:
                d_emb[t] = got[-1]
            del outs_t, grads_t, got
            outs[t] = stats[t] = ins[t] = None
        # (4) stage 0's embedding gradient to every stage's vocab slice
        if vp_tied:
            for t in range(self.n_micro):
                d = d_emb[t] if s == 0 else torch.empty(
                    shape, dtype=dtype, device=dev)
                if d is None:
                    d = torch.zeros(shape, dtype=dtype, device=dev)
                d = d.contiguous()
                dist.broadcast(d, self.pipe_ranks[0], group=self.pipe_group)
                add(torch.autograd.grad(parts[t], leaves, d,
                                        allow_unused=True))
        # (5) leaves several stages (and data ranks) share
        if reduce:
            for a_t, spec in zip(acc, tree_leaves(tree_like(p, self.specs))):
                for ax in self.grad_axes(spec):
                    if ax == self.st_ax or shard_b:
                        dist.all_reduce(a_t, group=self.mesh.get_group(ax))
        return loss.detach(), tree_unflatten(params, acc)


def build_pp_loss(cfg: ArchConfig, mesh, n_micro: int = 1, *,
                  stage_axis: Optional[str] = None, data_axis=None,
                  remat: bool = True, aux_weight: float = 0.01,
                  causal: bool = True, vocab_parallel="auto",
                  mb_layout: Callable = contiguous_microbatch):
    """-> ``(loss_fn, info)``: the GPipe loss of ``cfg``'s LM on ``mesh``
    (a ``DeviceMesh`` with named axes), equal to the monolithic
    ``lm_loss`` over the whole batch, MoE aux included.  ``loss_fn`` is a
    :class:`PipelineLoss`; ``info`` has the reference's keys and values.

    causal         -- False for encoder-style (ViT) sections.
    vocab_parallel -- ``"auto"`` (on iff the padded vocabulary divides the
                      stages), True or False.
    mb_layout      -- ``(local_batch, t, msz) -> micro-batch``."""
    st_ax = _stage_axis(mesh, stage_axis)
    d_ax = _data_axes(mesh, st_ax, data_axis)
    sizes = shd.mesh_shape(mesh)
    pp = sizes[st_ax]
    pk, reps = tf.group_layout(cfg)
    if reps % pp:
        raise ValueError(f"{cfg.name}: {reps} layer groups do not divide "
                         f"{pp} pipeline stages")
    per_stage = reps // pp
    n_moe = per_stage * sum(1 for _, ffn in pk if ffn == "moe")
    if vocab_parallel == "auto":
        vp = pp > 1 and cfg.padded_vocab % pp == 0
    else:
        vp = bool(vocab_parallel)
        if vp and cfg.padded_vocab % pp:
            raise ValueError(
                f"vocab_parallel=True but padded_vocab={cfg.padded_vocab} "
                f"does not divide pp={pp}")
    Vs = cfg.padded_vocab // pp if vp else cfg.padded_vocab
    tp_axis, tp_attn, tp_ffn = _tp_plan(cfg, mesh, st_ax)
    tp = (TensorParallel(mesh.get_group(tp_axis), sizes[tp_axis], tp_attn,
                         tp_ffn) if tp_axis is not None else None)
    specs = compute_specs(cfg, stage_axis=st_ax, tp_axis=tp_axis,
                          tp_attn=tp_attn, tp_ffn=tp_ffn,
                          vocab_axis=st_ax if vp else None)
    loss_fn = PipelineLoss(cfg, mesh, n_micro, st_ax=st_ax, d_ax=d_ax,
                           remat=remat, aux_weight=aux_weight, causal=causal,
                           vp=vp, Vs=Vs, tp=tp, specs=specs,
                           mb_layout=mb_layout)
    info = {"stage_axis": st_ax, "data_axis": d_ax or None, "stages": pp,
            "groups_per_stage": per_stage, "n_micro": n_micro,
            "moe_layers_per_stage": n_moe, "vocab_parallel": vp,
            "vocab_shard": Vs, "tp_axis": tp_axis, "tp_attn": tp_attn,
            "tp_ffn": tp_ffn}
    return loss_fn, info
