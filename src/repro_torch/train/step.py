"""The train step: loss, backward, micro-batch gradient accumulation, AdamW;
on one device, or data-parallel over a mesh with FSDP parameter sharding,
ZeRO optimizer-state sharding and, optionally, a compressed gradient
all-reduce.

Counterpart of ``repro/train/step.py::build_train_step`` in its plain
regime.  PyTorch runs eagerly, so there is no jit; ``step`` is a plain
function.

* ``mesh=None``: the single-device step.  The global batch is split into
  ``num_microbatches`` micro-batches, each micro-batch's gradient is
  accumulated in float32, and one ``adamw.update`` follows.
* ``mesh=`` a ``DeviceMesh`` from ``dist.sharding.section_mesh``: one
  process per rank.  Parameters rest as blocks by
  ``spec_for(rules_for(cfg, mesh))`` (``embed`` over ``data``), and ``mu``,
  ``nu`` and ``master`` by ``zero_extend`` when ``zero_opt``.  The step
  takes this rank's block of the global batch (``step.block``,
  :class:`DataLayout`) in the reference's layout
  (``dist.sharding.batch_layout``): its rows of the shard-major layout
  ``[dp, n_micro, mbs]`` where the batch divides the data axes, else its
  columns of every row where the sequence divides them (the model's
  attention then runs over the data axes' group,
  ``dist.context.cp_attention_impl(axes=)``, at the shard's global
  positions), else the whole batch on every data rank.  It all-gathers
  the parameters, runs the forward and backward on full tensors (the hand-written kernels
  unchanged), accumulates float32 gradients over its micro-batches,
  reduce-scatters each into its optimizer-state block, runs AdamW on the
  blocks with the clip norm of the whole tree, and all-gathers the new
  master blocks, cast, into parameter blocks.  Each micro-batch's masked
  mean is weighted by this rank's share of the mask total over every data
  rank, so that the summed gradient is the reference's global mean in
  each layout (a replicated batch's ranks each weigh ``1 / dp``).
* ``grad_compress`` ``"bf16"``/``"int8"``: as in the reference, each rank
  takes its own shard's mean loss and gradient, and one compressed
  mean-reduce (``optim.compression``) replaces the float32 one; the step
  takes and returns the error-feedback residual ``ef``, stacked ``[1, ...]``
  on each rank.

* a ``seq`` axis above 1: the context-parallel regime (``"cp"``).  Each
  rank takes its data rows and its sequence columns of every batch leaf
  (labels come with the batch, so no token crosses a shard), and the
  model's attention runs through ``dist.context.cp_attention_impl``,
  installed with ``models.attention.attention_impl``.  Each masked mean
  divides by the mask total over the data and sequence ranks, and the
  gradients are summed over both before the reduce-scatter into the ZeRO
  blocks: parameters are replicated over ``seq``.  The vlm family's image
  slots stay whole on every sequence rank, which splices those inside its
  shard (``models.transformer.vision_scatter``).
* a ``model`` axis above 1 (plain and cp regimes): Megatron tensor
  parallelism (``dist.pipeline.TensorParallel``) under the gates of
  ``dist.pipeline._tp_plan``: each rank takes its heads and ``d_ff``
  slices of the layer weights and gathers every other leaf whole.  Where
  the axis exceeds the KV heads and is a multiple of them, a rank takes
  its ``H / tp`` query heads and the one KV head of their group, each KV
  head repeated over the ``tp / KV`` ranks of its group
  (``dist.sharding.Repeated``), and that head's gradient is the sum over
  those ranks (``dist.sharding.reduce_to``).  The regions the gates
  refuse compute whole on every model rank: attention where the KV heads
  neither divide the axis nor are divided by it, or with ``head_pad``; a
  Mamba mixer, the experts.  Where the padded vocabulary divides the
  axis, the output layer (``unembed``, or a tied ``embed``) is sliced
  over it too, as the reference's ``vocab`` rule places it: each rank
  forms only its ``[rows, S, padded_vocab / tp]`` logits, the
  cross-entropy combines the slices' maxima, exponential sums and gold
  logits (``dist.pipeline.vocab_parallel_nll``), and a tied lookup sums
  each rank's rows (``models.transformer.vocab_rows``).  Every rank then
  holds the whole gradient of each leaf it does not slice, so nothing is
  summed over ``model``: a ZeRO block that extends over ``model`` takes
  its slice.
  With a ``seq`` axis as well (cp x tp), each (seq, model) rank runs
  ``cp_attention`` over its sequence group on its own head slice.  A
  batch whose sequence lies over the data axes in the cp regime is
  replicated over ``seq``, as the reference lays it out.
* a ``pipe`` axis above 1: the pipeline regime (``"pp"``).  The loss is
  ``dist.pipeline.build_pp_loss``'s GPipe schedule over this rank's stage
  (vocab-parallel CE where the padded vocabulary divides the stages, TP
  inside the stage on a ``model`` axis), micro-batched inside the
  schedule as in the reference; the step takes its ``value_and_grad``
  and reduces each gradient over the data axes (where they split the
  batch: a block with the sequence over them is gathered whole, and a
  whole batch runs on every data rank, as the reference's staged loss
  takes rows or all of them) and, for a leaf the stages share, over
  ``pipe``.  Its metrics are ``loss``, ``grad_norm`` and
  ``lr``, as the reference's.

The MoE and hybrid families on more than one data or sequence rank take
each micro-batch's router statistics averaged over those ranks before
the load-balancing loss is formed (``models.transformer.sharded_forward``),
which is the reference's aux over the micro-batch's global rows.  pp x
cp and the audio family under pp are refused as in the reference, and so
is ``grad_compress`` with a global batch that does not divide the data
axes.  The audio family's block with the sequence over the data axes is
gathered whole and runs replicated (its cross-attention has no sequence
shard).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, List, Optional

import torch

from repro_torch.core.types import ArchConfig, ParallelConfig, ShapeConfig
from repro_torch.dist import pipeline as pl
from repro_torch.dist import sharding as shd
from repro_torch.models import attention as att
from repro_torch.models import transformer as tf
from repro_torch.models.common import (tree_leaves, tree_like, tree_map,
                                       tree_unflatten)
from repro_torch.models.model import Model
from repro_torch.optim import adamw, schedules
from repro_torch.optim import compression as gcomp

def check_single_device(parallel: ParallelConfig, what: str) -> None:
    """Raise for every ParallelConfig knob a step on one device cannot
    run."""
    compress = parallel.grad_compress or "none"
    if parallel.devices != 1 or compress != "none":
        raise NotImplementedError(
            f"{what}: dp={parallel.dp}, tp={parallel.tp}, pp={parallel.pp}, "
            f"cp={parallel.cp}, grad_compress={compress!r} run only on a "
            "mesh: train.step.build_train_step(..., mesh=dist.sharding"
            ".section_mesh(ranks, parallel)) under torch.distributed "
            "(ROADMAP.md, A6.1, A6.3, A6.4); a compound section on several "
            "ranks is ROADMAP.md, A6.2")


def parallel_regime(mesh, parallel: ParallelConfig) -> str:
    """Validate ``parallel`` against ``mesh`` (a ``DeviceMesh`` or an
    ``{axis: size}`` mapping) and name the step regime: ``"pp"`` for a
    ``pipe`` axis above 1, ``"cp"`` for a ``seq`` axis above 1, else
    ``"plain"`` (tensor parallelism runs inside the plain and pp regimes).
    A mismatch, or a CP knob out of range, raises ``ValueError``; pp x cp
    raises as in the reference."""
    sizes = shd.mesh_shape(mesh)
    have = {"pp": sizes.get(shd.AXIS_PIPE, 1),
            "cp": sizes.get(shd.AXIS_SEQ, 1),
            "tp": sizes.get(shd.AXIS_MODEL, 1),
            "dp": shd.axis_size(mesh, shd.dp_axes(mesh))}
    axis = {"pp": "pipe", "cp": "seq", "tp": "model", "dp": "data"}
    for k, n in have.items():
        if getattr(parallel, k) != n:
            raise ValueError(
                f"ParallelConfig.{k}={getattr(parallel, k)} does not match "
                f"the mesh's {axis[k]} axis ({n}): a section must run on a "
                "mesh carved by section_mesh, not fall back to replication")
    if have["pp"] > 1 and have["cp"] > 1:
        raise NotImplementedError(
            "pp x cp composition is not supported (CP's sequence shards "
            "cannot nest inside the pipeline's stages); use pp x tp "
            "instead")
    from repro_torch.dist.context import CP_MODES
    if parallel.cp_mode not in CP_MODES:
        raise ValueError(
            f"ParallelConfig.cp_mode={parallel.cp_mode!r}: expected one "
            f"of {CP_MODES}")
    if parallel.cp_overlap_chunks < 1:
        raise ValueError(
            f"ParallelConfig.cp_overlap_chunks="
            f"{parallel.cp_overlap_chunks}: must be >= 1")
    if parallel.cp_overlap_chunks > 1 and parallel.cp_mode in (
            "allgather", "ulysses_mqa"):
        raise ValueError(
            f"ParallelConfig.cp_overlap_chunks="
            f"{parallel.cp_overlap_chunks} only applies to the ulysses "
            f"mode's K/V a2a chain, but cp_mode={parallel.cp_mode!r} "
            f"was forced")
    if have["pp"] > 1:
        return "pp"
    return "cp" if have["cp"] > 1 else "plain"


def _check_pp_cp_support(cfg: ArchConfig, regime: str) -> None:
    """The families the PP and CP regimes refuse, the reference's: audio
    under either, whose encoder-decoder stack is not staged and whose
    cross-attention has no sequence shard, and attention-free archs under
    cp, whose seq axis would be replicated silently."""
    if regime == "pp" and cfg.family == "audio":
        raise NotImplementedError(
            "pipeline parallelism is not implemented for encoder-decoder "
            "(audio) sections: build_pp_loss stages the lm_specs stack")
    if regime != "cp":
        return
    if cfg.family == "audio":
        raise NotImplementedError(
            "context parallelism is not implemented for encoder-"
            "decoder (audio) sections (cross-attention)")
    if cfg.attention_free:
        raise NotImplementedError(
            f"cp>1 on attention-free arch {cfg.name!r}: there is no "
            "attention to sequence-shard, the seq axis would be "
            "silently replicated")


def num_microbatches(shape: ShapeConfig, parallel: ParallelConfig,
                     dp_total: int = 1) -> int:
    """Gradient-accumulation depth for this shape over ``dp_total`` data
    ranks.

    Raises when the global batch cannot be laid out as ``[dp_total,
    n_micro, mbs]``, rather than train on duplicated data."""
    denom = dp_total * parallel.mbs
    if shape.global_batch > denom and shape.global_batch % denom:
        raise ValueError(
            f"global_batch={shape.global_batch} is not a multiple of "
            f"dp_total*mbs={dp_total}*{parallel.mbs}: grad accumulation would "
            "train on duplicated data with an inflated effective batch; "
            "adjust ShapeConfig.global_batch or ParallelConfig.mbs")
    return max(shape.global_batch // denom, 1)


def _split_microbatches(batch: dict, n_micro: int, dp_total: int = 1):
    """[GB, ...] -> a list of ``n_micro`` batches of [GB / n_micro, ...],
    shard-major as in the JAX package (contiguous when ``dp_total`` is 1).
    Raises on batches that do not divide."""
    def split(x):
        gb = x.shape[0]
        mgb = gb // n_micro
        per = mgb // dp_total
        if per == 0 or gb % n_micro or mgb % dp_total:
            raise ValueError(
                f"cannot split batch dim {gb} into {n_micro} microbatches "
                f"× {dp_total} DP shards: global_batch must be a multiple "
                "of dp_total*mbs")
        y = x.reshape((dp_total, n_micro, per) + x.shape[1:])
        return y.transpose(0, 1).reshape((n_micro, mgb) + x.shape[1:])
    split_tree = tree_map(split, batch)
    return [tree_map(lambda x: x[i], split_tree) for i in range(n_micro)]


def _accumulate(loss_fn: Callable, params: dict, leaves: list, mbs: list,
                weights: Optional[torch.Tensor] = None):
    """``loss_fn(params, mb) -> (loss, metrics)`` and its gradient with
    respect to ``leaves`` for each micro-batch, the loss and metrics scaled
    by ``weights[i]`` when given -> (gradients, sums of the loss and of
    each metric).  The gradients are the micro-batch's own when there is
    one, else their float32 sum."""
    g_acc, sums = None, {}
    for i, mb in enumerate(mbs):
        loss, metrics = loss_fn(params, mb)
        if weights is not None:
            loss = loss * weights[i]
            metrics = {k: v * weights[i] for k, v in metrics.items()}
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            if len(mbs) == 1:
                g_acc = list(grads)
            elif g_acc is None:
                g_acc = [g.float() for g in grads]
            else:
                for a, g in zip(g_acc, grads):
                    a.add_(g.float())
            for k, v in {"loss": loss, **metrics}.items():
                sums[k] = sums.get(k, 0.0) + v.detach().float()
        del loss, metrics, grads
    return g_acc, sums


def accumulate_and_update(loss_fn: Callable, params: dict,
                          opt_state: adamw.AdamWState, batch: dict,
                          step_idx, *, n_micro: int, lr_fn: Callable,
                          opt_cfg: adamw.AdamWConfig):
    """``loss_fn(params, mb) -> (loss, metrics)`` over the micro-batches of
    ``batch``: float32 gradient accumulation, then one AdamW update.

    Returns (new params, optimizer state, metrics) with metrics ``loss``,
    ``grad_norm`` and ``lr`` plus the micro-batch mean of every scalar
    ``loss_fn`` reports.  The new parameters are fresh leaves that
    require grad, ready for the next step."""
    leaves = tree_leaves(params)
    if not all(x.requires_grad for x in leaves):
        raise ValueError("the train step differentiates with respect to the "
                         "parameter tree: its leaves must require grad")
    mbs = [batch] if n_micro == 1 else _split_microbatches(batch, n_micro)
    g_acc, sums = _accumulate(loss_fn, params, leaves, mbs)
    if n_micro > 1:
        with torch.no_grad():
            g_acc = [(a / n_micro).to(p.dtype) for a, p in zip(g_acc, leaves)]
    lr = lr_fn(step_idx)
    new_params, opt_state, gnorm = adamw.update(
        tree_unflatten(params, g_acc), opt_state, lr, opt_cfg)
    new_params = tree_map(lambda x: x.requires_grad_(), new_params)
    out = {k: v / n_micro for k, v in sums.items()}
    out.update(grad_norm=gnorm, lr=lr)
    return new_params, opt_state, out


def add_f32(acc: Optional[list], total: Optional[torch.Tensor],
            loss: torch.Tensor, grads) -> tuple:
    """The colocated compound steps' accumulation: ``acc`` (float32
    gradient sums, None before the first micro-batch) plus ``grads`` and
    ``total`` plus the detached ``loss``, both summed from zero in
    micro-batch order -> (acc, total)."""
    with torch.no_grad():
        if acc is None:
            acc = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                   for g in grads]
            total = torch.zeros((), dtype=torch.float32, device=loss.device)
        for a, g in zip(acc, grads):
            a.add_(g.float())
        return acc, total + loss.detach()


def mesh_parallel(mesh, mbs: int = 1) -> ParallelConfig:
    """The ``ParallelConfig`` whose knobs a mesh's axes size (the data
    degree over ``pod`` and ``data``)."""
    sizes = shd.mesh_shape(mesh)
    return ParallelConfig(dp=shd.axis_size(mesh, shd.dp_axes(mesh)),
                          tp=sizes.get(shd.AXIS_MODEL, 1),
                          pp=sizes.get(shd.AXIS_PIPE, 1),
                          cp=sizes.get(shd.AXIS_SEQ, 1), mbs=mbs)


def default_lr_schedule():
    return functools.partial(schedules.warmup_cosine, peak_lr=3e-4,
                             warmup_steps=100, total_steps=10_000)


def build_train_step(model: Model, parallel: ParallelConfig,
                     shape: ShapeConfig, *, mesh=None, lr_schedule=None,
                     opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig()):
    """-> ``step(params, opt_state, batch, step_idx) -> (params, opt_state,
    {"loss", "grad_norm", "lr", "ce", "aux"})``.

    ``mesh=None``: ``params`` is a parameter tree whose leaves require grad
    (the model's own ``param_tree()`` at the first step, the returned tree
    after); ``opt_state`` comes from ``adamw.init`` and is updated in
    place.

    With a ``mesh``, see :func:`build_sharded_step`."""
    if mesh is not None:
        return build_sharded_step(model, parallel, shape, mesh,
                                  lr_schedule=lr_schedule, opt_cfg=opt_cfg)
    check_single_device(parallel, f"build_train_step({model.cfg.name})")
    n_micro = num_microbatches(shape, parallel)
    lr_fn = lr_schedule or default_lr_schedule()

    def loss_fn(p, mb):
        return model.loss(mb, params=p, remat=parallel.remat)

    def step(params, opt_state, batch, step_idx):
        return accumulate_and_update(loss_fn, params, opt_state, batch,
                                     step_idx, n_micro=n_micro, lr_fn=lr_fn,
                                     opt_cfg=opt_cfg)

    # the arguments the step writes in place, for analysis.donation
    step._in_place = (1,)
    step._in_place_label = "train_step(params, opt)"
    return step


# --------------------------------------------------------------------------- #
# The data-parallel step over a mesh
# --------------------------------------------------------------------------- #
def _mask_total(mb: dict) -> torch.Tensor:
    """The token count a micro-batch's masked mean divides by."""
    mask = mb.get("loss_mask")
    if mask is None:
        return torch.tensor(float(mb["labels"].numel()),
                            device=mb["labels"].device)
    return mask.float().sum()


def reduce_grads(grads: List[torch.Tensor], specs: list, mesh, axes,
                 have: Optional[list] = None) -> List[torch.Tensor]:
    """Each rank's float32 gradient summed over the data ``axes`` and kept
    in its optimizer-state block (``specs``), one leaf at a time;
    ``have``: the specs of the blocks the gradients are of (whole leaves
    when None)."""
    have = have or [None] * len(grads)
    return [shd.reduce_to(g, s, mesh, axes, have=h)
            for g, s, h in zip(grads, specs, have)]


def model_context(cfg: ArchConfig, specs, mesh, regime: str,
                  parallel: ParallelConfig, *, section: Optional[str] = None,
                  seq_ax: Optional[tuple] = None, vocab: bool = False):
    """How a rank of ``mesh`` runs a model of ``cfg`` whose parameters
    follow the ParamSpec tree ``specs``, in the plain or cp regime ->
    (context factory, compute specs).

    The context installs attention over the ranks that split the sequence
    (``seq_ax``, :attr:`DataLayout.seq_ax`: by default ``seq`` in the cp
    regime), Megatron TP on the ``model`` axis
    (:func:`dist.pipeline.tensor_parallel`; with ``vocab`` the output
    layer and the cross-entropy split the vocabulary over it too) and, for
    a model with MoE layers on more than one data or sequence rank, the
    mean of the router statistics over those ranks.  TP runs where the
    forward is ``models.transformer.lm_forward`` over the ``lm_specs``
    tree; any other model (whisper's encoder-decoder, the MLLM's vision
    tower) computes whole on every model rank.  The compute specs are the
    blocks the rank computes with (``dist.pipeline.compute_specs``: its TP
    slices, every other leaf whole), a tree over ``specs``."""
    sum_ax = shd.dp_axes(mesh) + ((shd.AXIS_SEQ,) if regime == "cp" else ())
    if seq_ax is None:
        seq_ax = (shd.AXIS_SEQ,) if regime == "cp" else ()
    sizes = shd.mesh_shape(mesh)
    n = shd.axis_size(mesh, sum_ax)

    def shapes(t):
        return tree_map(lambda x: tuple(x.shape), t)
    tp = None
    if cfg.family != "audio" and shapes(specs) == shapes(tf.lm_specs(cfg)):
        tp = pl.tensor_parallel(cfg, mesh, repeat_kv=True, vocab=vocab)
    if tp is None:
        c_specs = tree_map(lambda x: shd.P(), specs)
    else:
        c_specs = pl.compute_specs(cfg, tp_axis=shd.AXIS_MODEL,
                                   tp_attn=tp.attn, tp_ffn=tp.ffn,
                                   kv_rep=tp.kv_repeat,
                                   vocab_axis=shd.AXIS_MODEL if tp.vocab
                                   else None)
    stats_mean = None
    if cfg.num_experts and n > 1:
        groups = [mesh.get_group(a) for a in sum_ax if sizes[a] > 1]

        def stats_mean(stats):
            return pl.mean_over(stats, groups, n)
    impl = None
    if seq_ax == (shd.AXIS_SEQ,):
        from repro_torch.dist.context import cp_attention_impl
        impl = cp_attention_impl(mesh, mode=parallel.cp_mode,
                                 overlap_chunks=parallel.cp_overlap_chunks,
                                 section=section)
    elif seq_ax:
        # the sequence over the data axes: the cp knobs name the seq axis
        from repro_torch.dist.context import cp_attention_impl
        impl = cp_attention_impl(mesh, section=section, axes=seq_ax)

    @contextlib.contextmanager
    def ctx():
        with contextlib.ExitStack() as stack:
            if impl is not None:
                stack.enter_context(att.attention_impl(impl))
            if tp is not None or stats_mean is not None:
                stack.enter_context(tf.sharded_forward(
                    tp=tp, stats_mean=stats_mean))
            yield

    return ctx, c_specs


def _check_sharded(cfg: ArchConfig, parallel: ParallelConfig,
                   shape: ShapeConfig, mesh) -> tuple:
    """The refusals of the sharded step, the reference's -> (regime, data
    axes, their size).  A global batch that does not divide the data axes
    is legal (:class:`DataLayout`'s sequence and replicated layouts),
    except under ``grad_compress``."""
    regime = parallel_regime(mesh, parallel)
    _check_pp_cp_support(cfg, regime)
    dp_ax = shd.dp_axes(mesh)
    dp_total = shd.axis_size(mesh, dp_ax)
    sizes = shd.mesh_shape(mesh)
    if regime == "pp":
        reps, pp = tf.group_layout(cfg)[1], sizes[shd.AXIS_PIPE]
        if reps % pp:
            raise ValueError(f"{cfg.name}: {reps} layer groups do not "
                             f"divide {pp} pipeline stages")
    cp = sizes.get(shd.AXIS_SEQ, 1)
    compress = parallel.grad_compress or "none"
    if compress not in gcomp.METHODS:
        raise ValueError(f"ParallelConfig.grad_compress={compress!r}: "
                         f"expected one of {gcomp.METHODS}")
    if compress != "none" and (regime != "plain" or any(
            sizes.get(a, 1) > 1 for a in (shd.AXIS_PIPE, shd.AXIS_SEQ,
                                          shd.AXIS_MODEL))):
        raise NotImplementedError(
            "grad_compress requires the plain regime on a dp-only mesh: the "
            "compressed all-reduce runs over the data axis alone and cannot "
            "nest inside pp/cp schedules or compose with tp")
    if regime == "cp" and shape.seq_len % cp:
        raise ValueError(
            f"sequence length {shape.seq_len} does not divide the mesh "
            f"{shd.AXIS_SEQ!r} axis ({cp})")
    if compress != "none" and len(dp_ax) > 1:
        raise NotImplementedError(
            "grad_compress supports a single data axis (got a multi-pod dp "
            "mesh); compress per pod or disable")
    if compress != "none" and shape.global_batch % dp_total:
        raise NotImplementedError(
            f"grad_compress needs the global batch ({shape.global_batch}) "
            f"to divide the data axis ({dp_total}) so every shard owns a "
            "real slice of the batch")
    return regime, dp_ax, dp_total


class BlockTree:
    """A parameter tree at rest as this rank's blocks of ``mesh``, and what
    every step over a mesh does with it (the sharded train step, the
    colocated compound steps): gather the blocks the forward computes
    with, reduce float32 gradients into the optimizer-state blocks, run
    AdamW on those blocks and gather the new parameter blocks.

    ``p_specs`` lays the parameters out at rest, ``c_specs`` names the
    blocks the forward computes with (whole leaves, or a rank's TP slices
    and stage blocks), ``o_specs`` is an ``AdamWState`` of specs (None for
    a frozen tree, which is only gathered).  Each spec tree has the keys of
    the parameter tree; the methods take and return lists in the parameter
    tree's leaf order (:meth:`lists`)."""

    def __init__(self, mesh, p_specs, c_specs, o_specs=None):
        self.mesh = mesh
        self.p_specs, self.c_specs, self.o_specs = p_specs, c_specs, o_specs

    @classmethod
    def of(cls, specs, mesh, rules: dict, c_specs=None, *,
           zero: Optional[bool] = True) -> "BlockTree":
        """The blocks of the ParamSpec tree ``specs`` under ``rules``
        (``dist.sharding.rules_for``): parameters by ``param_shardings``,
        the optimizer state by ``opt_state_shardings(zero=zero)``, none
        when ``zero`` is None (a frozen tree); ``c_specs`` default to
        whole leaves."""
        if c_specs is None:
            c_specs = tree_map(lambda s: shd.P(), specs)
        o_specs = None if zero is None else shd.opt_state_shardings(
            specs, mesh, rules, zero=zero)
        return cls(mesh, shd.param_shardings(specs, mesh, rules), c_specs,
                   o_specs)

    def lists(self, params) -> tuple:
        """The parameter, optimizer-state (None for a frozen tree) and
        compute specs in ``params``' leaf order."""
        p = tree_leaves(tree_like(params, self.p_specs))
        o = (None if self.o_specs is None
             else tree_leaves(tree_like(params, self.o_specs.master)))
        return p, o, tree_leaves(tree_like(params, self.c_specs))

    def compute(self, params, lists, *, grad: bool = True) -> list:
        """The blocks the forward computes with, gathered from this rank's
        blocks (leaves that require grad unless ``grad`` is False)."""
        p_list, _, c_list = lists
        with torch.no_grad():
            full = [shd.reshard(x, s, c, self.mesh)
                    for x, s, c in zip(tree_leaves(params), p_list, c_list)]
        return [x.requires_grad_() for x in full] if grad else full

    def reduce(self, grads, lists, axes) -> list:
        """Gradients of the compute blocks, as float32, summed over the mesh
        ``axes`` into this rank's optimizer-state blocks."""
        _, o_list, c_list = lists
        with torch.no_grad():
            return reduce_grads([g.float() for g in grads], o_list,
                                self.mesh, axes, have=c_list)

    def grad_tree(self, params, g_opt) -> dict:
        """Optimizer-state blocks of the gradients, in the parameters'
        dtypes, as a tree shaped like ``params``."""
        with torch.no_grad():
            return tree_unflatten(params, [
                g.to(x.dtype) for g, x in zip(g_opt, tree_leaves(params))])

    def global_norm(self, grads, params) -> torch.Tensor:
        """The global norm of a :meth:`grad_tree` (each element once)."""
        return adamw.sharded_global_norm(
            grads, tree_like(params, self.o_specs.master), self.mesh)

    def apply(self, params, opt_state: adamw.AdamWState, grads, lists, lr,
              opt_cfg: adamw.AdamWConfig, gnorm: torch.Tensor):
        """AdamW on the optimizer-state blocks (``opt_state`` in place),
        clipped by ``gnorm`` -> (new parameter blocks, optimizer state)."""
        p_list, o_list, _ = lists
        new_master, opt_state, _ = adamw.update(
            grads, opt_state, lr, opt_cfg,
            gnorm=gnorm if opt_cfg.clip_norm > 0 else None)
        with torch.no_grad():
            new = [shd.reshard(x, o, p, self.mesh) for x, o, p in
                   zip(tree_leaves(new_master), o_list, p_list)]
        return tree_unflatten(params, new), opt_state

    def update(self, params, opt_state: adamw.AdamWState, g_opt, lists, lr,
               opt_cfg: adamw.AdamWConfig):
        """:meth:`grad_tree`, :meth:`global_norm` and :meth:`apply` ->
        (new parameter blocks, optimizer state, grad norm)."""
        grads = self.grad_tree(params, g_opt)
        gnorm = self.global_norm(grads, params)
        params, opt_state = self.apply(params, opt_state, grads, lists, lr,
                                       opt_cfg, gnorm)
        return params, opt_state, gnorm


#: batch leaves of the vlm family that index the whole sequence: every
#: sequence rank keeps them whole (``models.transformer.vision_scatter``
#: takes the slots inside its shard)
IMAGE_SLOT_KEYS = ("image_embeds", "image_pos", "image_valid")


class DataLayout:
    """This rank's share of a global batch of ``global_batch`` x
    ``seq_len`` on ``mesh``, in the reference's layout
    (``dist.sharding.batch_layout``, ``kind``):

    * ``"rows"``: each data rank owns its rows of the shard-major layout
      ``[dp, n_micro, mbs]``;
    * ``"sequence"`` (the batch does not divide the data axes, its
      sequence does): each data rank owns its sequence columns of every
      row, and the model's attention runs over the data axes' group
      (``dist.context.cp_attention_impl(axes=)``);
    * ``"replicated"``: every data rank runs the whole batch.

    With ``gather`` (the staged loss, which takes rows or all of them,
    and the audio family, whose cross-attention has no sequence shard)
    the rank computes on its rows where the batch divides the data axes,
    else on the whole batch, every leaf of its block gathered to that
    (the reference's rule may split a leaf whose dim 1 is not the
    sequence, such as whisper's frames).

    In the cp regime each [B, S] leaf is split over ``seq`` as well where
    the data axes leave its dim 1 free (a ``"sequence"`` batch is
    replicated over ``seq``), and :data:`IMAGE_SLOT_KEYS` keep only their
    rows split.  :meth:`block` cuts a rank's block from the global batch on
    the host; the steps take that block.  :meth:`weights` gives each
    micro-batch's share of the mask total over every data (and sequence)
    rank, so that the weighted masked means sum to the global one in every
    layout, and :meth:`means` the metric means over those ranks.
    ``input_specs``: the global batch's leaves (tensors, or shapes as
    tuples) by key.  ``global_batch=None``: rows of pre-microbatched
    batches only (:meth:`rows`, the MLLM and multi-teacher steps)."""

    def __init__(self, mesh, regime: str, n_micro: int, seq_len: int,
                 global_batch: Optional[int] = None,
                 input_specs: Optional[dict] = None, *,
                 gather: bool = False):
        self.mesh, self.regime, self.n_micro = mesh, regime, n_micro
        self.seq_len = seq_len
        self.dp_ax = shd.dp_axes(mesh)
        self.dp_total = shd.axis_size(mesh, self.dp_ax)
        # the axes a gradient or a mask total sums over: data, and seq in
        # the cp regime (parameters are replicated over seq)
        self.sum_ax = self.dp_ax + ((shd.AXIS_SEQ,) if regime == "cp"
                                    else ())
        sizes, coord = shd.mesh_shape(mesh), shd.coordinate(mesh)
        self.rank = 0
        for a in self.dp_ax:
            self.rank = self.rank * sizes[a] + coord[a]
        self.kind = ("rows" if global_batch is None else
                     shd.batch_layout(mesh, global_batch, seq_len))
        self.gather = gather
        #: the axes the model's sequence is split over while it computes
        self.seq_ax = (self.dp_ax if self.kind == "sequence" and not
                       gather else (shd.AXIS_SEQ,) if regime == "cp"
                       else ())
        self.global_batch = global_batch
        self.specs: dict = {}
        for k, x in (input_specs or {}).items():
            self.spec(k, getattr(x, "shape", x))

    def spec(self, key: str, shape) -> "shd.PartitionSpec":
        """The spec of batch leaf ``key`` of global ``shape``
        (:func:`batch_leaf_spec`)."""
        if key not in self.specs:
            self.specs[key] = batch_leaf_spec(self.mesh, self.kind, key,
                                              shape)
        return self.specs[key]

    def block(self, batch: dict) -> dict:
        """This rank's block of the global ``batch`` (on the host, before
        it moves to the device), each leaf a tensor of its own that keeps
        no reference to the global one."""
        return {k: shd.shard(v, self.spec(k, v.shape), self.mesh).clone()
                for k, v in batch.items()}

    def local(self, block: dict) -> dict:
        """The batch this rank computes with from its block: the block
        itself, or with ``gather`` its rows or the whole batch."""
        tok = block["tokens"]
        if self.global_batch is not None and "tokens" in self.specs:
            want = tuple(shd.shard(torch.empty(
                (self.global_batch, self.seq_len), device="meta"),
                self.specs["tokens"], self.mesh).shape)
            if tuple(tok.shape[:2]) != want:
                raise ValueError(
                    f"the step takes this rank's block of the batch, tokens "
                    f"{want}, not {tuple(tok.shape)}: cut it with "
                    "step.block(global_batch)")
        if not self.gather:
            return block
        want = shd.P(self.dp_ax if self.kind == "rows" else None)
        return {k: shd.reshard(v, self.specs[k], want, self.mesh)
                for k, v in block.items()}

    def rows(self, m: int) -> tuple:
        """(first row, count) of this rank's rows of a microbatch of ``m``
        rows split over the data axes (the reference's ``P(None, dp)``)."""
        if m % self.dp_total:
            raise ValueError(f"microbatches of {m} rows do not split over "
                             f"{self.dp_total} data ranks")
        n = m // self.dp_total
        return self.rank * n, n

    def microbatches(self, block: dict) -> list:
        """This rank's micro-batches of its ``block``."""
        local = self.local(block)
        return [local] if self.n_micro == 1 else _split_microbatches(
            local, self.n_micro)

    def weights(self, mbs: list) -> torch.Tensor:
        """Each micro-batch's mask total here over its total on every data
        (and sequence) rank."""
        counts = torch.stack([_mask_total(mb) for mb in mbs])
        totals = shd.all_reduce_axes(counts.clone(), self.mesh, self.sum_ax)
        return counts / totals.clamp_min(1.0)

    def means(self, sums: dict, mean_over: int = 1) -> dict:
        """The micro-batch means of ``sums``, summed over the data ranks
        (divided by ``mean_over``) in one all-reduce."""
        keys = list(sums)
        packed = shd.all_reduce_axes(torch.stack([sums[k] for k in keys]),
                                     self.mesh, self.sum_ax)
        if mean_over > 1:
            packed = packed / mean_over
        return {k: v / self.n_micro for k, v in zip(keys, packed.unbind(0))}


def batch_leaf_spec(mesh, kind: str, key: str, shape) -> "shd.PartitionSpec":
    """The spec of the batch leaf ``key`` of global ``shape`` in a batch
    laid out as ``kind`` (``dist.sharding.batch_layout``): the
    reference's ``data_shardings`` rule, except that
    :data:`IMAGE_SLOT_KEYS` keep only their rows split."""
    if key in IMAGE_SLOT_KEYS:
        return shd.P(shd.dp_axes(mesh) if kind == "rows" else None)
    return shd.data_shardings(mesh, tuple(shape))


def microbatch_rows(lay: DataLayout, batch: dict, keys) -> dict:
    """This rank's block of a pre-microbatched global batch ``[n_mb, m,
    ...]``: its rows of each micro-batch for ``keys`` (the reference's
    ``P(None, dp)``, :meth:`DataLayout.rows`), every other leaf whole."""
    lo, n = lay.rows(batch["tokens"].shape[1])
    return {k: v[:, lo:lo + n].clone() if k in keys else v
            for k, v in batch.items()}


def build_sharded_step(model: Model, parallel: ParallelConfig,
                       shape: ShapeConfig, mesh, *, lr_schedule=None,
                       opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig()):
    """The data-parallel step on ``mesh`` (see the module docstring) ->
    ``step(params, opt_state, batch, step_idx) -> (params, opt_state,
    metrics)``, or with ``grad_compress`` ``step(params, opt_state, batch,
    step_idx, ef) -> (params, opt_state, metrics, ef)``.

    ``params`` and ``opt_state`` are this rank's blocks under
    ``step.shardings["params"]`` and ``["opt"]`` (``dist.sharding
    .shard_tree``); ``batch`` is this rank's block of the global batch,
    ``step.block(global_batch)`` (:class:`DataLayout`; its specs are
    ``step.shardings["batch"]``).  With compression,
    ``step.shardings["ef_init"](params)`` gives the zero residual.  Every
    rank must call the step: it runs collectives."""
    cfg = model.cfg
    regime, dp_ax, dp_total = _check_sharded(cfg, parallel, shape, mesh)
    compress = parallel.grad_compress or "none"
    n_micro = num_microbatches(shape, parallel, dp_total)
    lr_fn = lr_schedule or default_lr_schedule()
    specs = model.specs()
    rules = shd.rules_for(cfg, mesh)
    data_group = mesh.get_group(dp_ax[0]) if compress != "none" else None
    lay = DataLayout(mesh, regime, n_micro, shape.seq_len,
                     shape.global_batch, model.input_specs(shape),
                     gather=regime == "pp" or cfg.family == "audio")
    if regime == "pp":
        pp_loss, _ = pl.build_pp_loss(cfg, mesh, n_micro,
                                      remat=parallel.remat,
                                      causal=cfg.family != "vit")
        c_specs = pp_loss.specs
    else:
        model_ctx, c_specs = model_context(cfg, specs, mesh, regime,
                                           parallel, seq_ax=lay.seq_ax,
                                           vocab=True)

        def loss_fn(p, mb):
            with model_ctx():
                return model.loss(mb, params=p, remat=parallel.remat)
    blocks = BlockTree.of(specs, mesh, rules, c_specs,
                          zero=parallel.zero_opt)

    def finish(params, opt_state, g_opt, step_idx, metrics, lists):
        """AdamW on the optimizer-state blocks -> parameter blocks."""
        lr = lr_fn(step_idx)
        params, opt_state, gnorm = blocks.update(params, opt_state, g_opt,
                                                 lists, lr, opt_cfg)
        metrics.update(grad_norm=gnorm, lr=lr)
        return params, opt_state, metrics

    if regime == "pp":
        def step(params, opt_state, batch, step_idx):
            lists = blocks.lists(params)
            local = blocks.compute(params, lists)
            rows = lay.kind == "rows"
            loss, grads = pp_loss.value_and_grad(
                tree_unflatten(params, local), lay.local(batch),
                reduce=False, sharded=rows)
            del local
            with torch.no_grad():
                g_opt = [shd.reduce_to(g, o, mesh,
                                       pp_loss.grad_axes(c, data=rows),
                                       have=c) for g, o, c in
                         zip(tree_leaves(grads), lists[1], lists[2])]
            del grads
            return finish(params, opt_state, g_opt, step_idx,
                          {"loss": loss}, lists)
    elif compress == "none":
        def step(params, opt_state, batch, step_idx):
            mbs = lay.microbatches(batch)
            weights = lay.weights(mbs)
            lists = blocks.lists(params)
            full = blocks.compute(params, lists)
            g_acc, sums = _accumulate(loss_fn, tree_unflatten(params, full),
                                      full, mbs, weights)
            del full
            g_acc = blocks.reduce(g_acc, lists, lay.sum_ax)
            if n_micro > 1:
                g_acc = [a / n_micro for a in g_acc]
            return finish(params, opt_state, g_acc, step_idx,
                          lay.means(sums), lists)
    else:
        def step(params, opt_state, batch, step_idx, ef):
            mbs = lay.microbatches(batch)
            lists = blocks.lists(params)
            full = blocks.compute(params, lists)
            g_acc, sums = _accumulate(loss_fn, tree_unflatten(params, full),
                                      full, mbs)
            del full
            with torch.no_grad():
                g = [a.float() / n_micro for a in g_acc]
                red, new_ef = gcomp.ef_compress_tree(
                    tree_unflatten(params, g), gcomp.ErrorFeedback(
                        tree_map(lambda x: x[0], tree_like(params, ef))),
                    data_group, compress, mean=True)
                g_opt = [shd.shard(x, s, mesh)
                         for x, s in zip(tree_leaves(red), lists[1])]
            params, opt_state, metrics = finish(
                params, opt_state, g_opt, step_idx,
                lay.means(sums, dp_total), lists)
            return (params, opt_state, metrics,
                    tree_map(lambda x: x[None], new_ef.residual))

    def ef_init(params):
        """The zero error-feedback residual, this rank's ``[1, ...]`` slice
        of the reference's stacked ``[dp, ...]`` one."""
        dev = tree_leaves(params)[0].device
        return tree_map(lambda s: torch.zeros((1,) + tuple(s.shape),
                                              dtype=torch.float32,
                                              device=dev),
                        tree_like(params, specs))

    step.mesh = mesh
    step.block = lay.block
    step.shardings = {"params": blocks.p_specs, "opt": blocks.o_specs,
                      "batch": lay.specs}
    if compress != "none":
        step.shardings["ef_init"] = ef_init
    step._in_place = (1,)
    step._in_place_label = "train_step[sharded](params, opt)"
    return step


# --------------------------------------------------------------------------- #
# The serving steps over a mesh
# --------------------------------------------------------------------------- #
def _check_no_pp_cp_serving(mesh, kind: str) -> None:
    sizes = shd.mesh_shape(mesh)
    if sizes.get(shd.AXIS_PIPE, 1) > 1 or sizes.get(shd.AXIS_SEQ, 1) > 1:
        raise NotImplementedError(
            f"{kind} cells do not support pipe/seq mesh axes > 1: serving "
            "shards long contexts over the model axis instead "
            "(kv_cache_spec flash-decoding split)")


def _live(spec, sizes: dict, ndim: int) -> tuple:
    """``spec``'s axes for each of ``ndim`` dims, without the axes of size
    1 (which split nothing)."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(tuple(a for a in shd._axes(e) if sizes[a] > 1)
                 for e in spec)


def _without(spec, axis: str):
    """``spec`` with ``axis`` taken out of every dim."""
    return shd.P(*(tuple(a for a in shd._axes(e) if a != axis)
                   for e in spec))


class _ServingLayout:
    """Where a serving step's tensors rest and where it computes with them.

    At rest (the step's arguments and results) parameters follow
    ``param_shardings``, the batch ``data_shardings``, the cache
    ``cache_shardings`` and the logits ``logits_sharding``, the
    reference's specs.  To compute, a rank gathers each parameter whole,
    or to its Megatron slice where the TP gates pass
    (``dist.pipeline.compute_specs``), keeps its data rows of the batch
    (all rows where the batch does not divide the data axes) and holds each
    cache leaf:

    * attention under TP: its ``kv_heads`` slice, which is its resting
      block;
    * attention whose cache rests with the *sequence* over ``model`` (a KV
      head count the axis does not divide): its sequence slice in decode,
      attended there and merged over ``model``
      (``models.attention.SeqSplit``); prefill computes the whole sequence
      and keeps its slice;
    * anything else that rests over ``model`` (a Mamba ``conv``/``ssm``
      leaf, whose mixer TP keeps whole; a cache whose attention the gates
      keep whole): whole, gathered over ``model`` for each decode step and
      its slice written back in place.

    Whisper's encoder-decoder takes the same gates (``models.encdec``):
    its attentions, their self and cross caches and its MLPs are sliced
    where they pass."""

    def __init__(self, model: Model, mesh, shape: ShapeConfig,
                 cache_shape: ShapeConfig):
        cfg = model.cfg
        self.cfg, self.mesh = cfg, mesh
        self.sizes = shd.mesh_shape(mesh)
        specs = model.specs()
        self.p_specs = shd.param_shardings(specs, mesh,
                                           shd.rules_for(cfg, mesh))
        self.b_specs = shd.data_shardings(mesh, model.input_specs(shape))
        self.c_specs = shd.cache_shardings(mesh,
                                           model.cache_specs(cache_shape))
        self.logits_spec = shd.logits_sharding(mesh, shape.global_batch,
                                               cfg.padded_vocab)
        self.tp = pl.tensor_parallel(cfg, mesh)
        if self.tp is None:
            self.pc_specs = tree_map(lambda s: shd.P(), specs)
        elif cfg.family == "audio":
            self.pc_specs = _tp_specs(specs, self.tp)
        else:
            self.pc_specs = pl.compute_specs(cfg, tp_axis=shd.AXIS_MODEL,
                                             tp_attn=self.tp.attn,
                                             tp_ffn=self.tp.ffn)
        dp = shd.dp_axes(mesh)
        rows = bool(dp) and shape.global_batch % shd.axis_size(mesh, dp) == 0
        self.rows = shd.P(dp if rows else None)
        m = self.sizes.get(shd.AXIS_MODEL, 1)
        split = []

        def plan(rest, key):
            """(prefill, decode) compute specs of one resting cache leaf."""
            attn = key in ("k", "v")
            if attn and self.tp is not None and self.tp.attn:
                return rest, rest
            whole = _without(rest, shd.AXIS_MODEL)
            if attn and m > 1 and shd.AXIS_MODEL in shd._axes(rest[-3]):
                split.append(True)
                return whole, rest
            return whole, whole

        def walk(t, key, i):
            if isinstance(t, dict):
                return {k: walk(v, k, i) for k, v in t.items()}
            return plan(t, key)[i]
        self.prefill_c = walk(self.c_specs, None, 0)
        self.decode_c = walk(self.c_specs, None, 1)
        self.kv_split = None
        if split:
            self.kv_split = att.SeqSplit(mesh.get_group(shd.AXIS_MODEL), m,
                                         shd.coordinate(mesh)[shd.AXIS_MODEL])

    def move(self, x: torch.Tensor, src, dst) -> torch.Tensor:
        """``x``, a block under ``src``, as the block under ``dst`` (itself
        where the two split it alike)."""
        if _live(src, self.sizes, x.dim()) == _live(dst, self.sizes,
                                                      x.dim()):
            return x
        return shd.reshard(x, src, dst, self.mesh)

    def params(self, params: dict) -> dict:
        return _zip3(self.move, params, tree_like(params, self.p_specs),
                     tree_like(params, self.pc_specs))

    def context(self, decode: bool):
        if self.tp is None and not (decode and self.kv_split is not None):
            return contextlib.nullcontext()
        return tf.sharded_forward(tp=self.tp, kv_split=self.kv_split
                                  if decode else None)

    def logits(self, logits: torch.Tensor) -> torch.Tensor:
        return self.move(logits, shd.P(*self.rows, None), self.logits_spec)


def _tp_specs(specs, tp) -> dict:
    """Compute specs of whisper's parameters under ``tp``: the
    ``heads``/``kv_heads`` dims of every attention and the ``mlp`` dim of
    every MLP over ``model`` where the gates pass, every other dim
    whole."""
    def one(s):
        return shd.P(*(shd.AXIS_MODEL if (tp.attn and ax in ("heads",
                                                            "kv_heads"))
                       or (tp.ffn and ax == "mlp") else None
                       for ax in s.axes))
    return tree_map(one, specs)


def _zip3(fn, tree, a, b):
    if isinstance(tree, dict):
        return {k: _zip3(fn, v, a[k], b[k]) for k, v in tree.items()}
    return fn(tree, a, b)


def _serving_fns(model: Model):
    """(prefill(p, batch, extra_cache), decode(p, cache, token, pos)) of
    the model's family, on an explicit parameter tree."""
    from repro_torch.models import encdec as ed
    cfg = model.cfg
    if cfg.family == "vit":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-only vit family has no prefill or "
            "decode (the reference's Model.prefill is None)")
    if cfg.family == "audio":
        return (functools.partial(ed.encdec_prefill, cfg=cfg),
                functools.partial(ed.encdec_decode, cfg=cfg))
    return (functools.partial(tf.lm_prefill, cfg=cfg),
            functools.partial(tf.lm_decode, cfg=cfg))


def build_prefill_step(model: Model, mesh, shape: ShapeConfig, *,
                       extra_cache: int = 0):
    """The sharded prefill: ``repro``'s ``build_prefill_step`` over one
    process per rank -> ``(step, specs)``.

    ``step(params, batch) -> (logits, cache)`` takes this rank's parameter
    blocks (``specs["params"]``) and batch block (``specs["batch"]``) and
    returns this rank's block of the last-token logits
    (``specs["logits"]``, ``logits_sharding``) and of the cache
    (``specs["cache"]``, ``cache_shardings``); see :class:`_ServingLayout`
    for how it computes.  ``extra_cache``: decode slots beyond the prompt
    (``Model.prefill``'s), which the reference's builder does not take.
    Every rank of the mesh calls the step together.  Meshes with ``pipe``
    or ``seq`` above 1 are refused, as in the reference."""
    _check_no_pp_cp_serving(mesh, "prefill")
    cache_shape = ShapeConfig(shape.name, "decode",
                              shape.seq_len + extra_cache,
                              shape.global_batch)
    lay = _ServingLayout(model, mesh, shape, cache_shape)
    prefill, _ = _serving_fns(model)
    b_c = tree_map(lambda s: shd.P(*lay.rows, *([None] * (len(s) - 1))),
                   lay.b_specs)

    @torch.inference_mode()
    def step(params, batch):
        p = lay.params(params)
        b = _zip3(lay.move, batch, tree_like(batch, lay.b_specs),
                  tree_like(batch, b_c))
        with lay.context(decode=False):
            logits, cache = prefill(p, batch=b, extra_cache=extra_cache)
        del p
        cache = _zip3(lay.move, cache, tree_like(cache, lay.prefill_c),
                      tree_like(cache, lay.c_specs))
        return lay.logits(logits), cache

    step.mesh = mesh
    specs = {"params": lay.p_specs, "batch": lay.b_specs,
             "cache": lay.c_specs, "logits": lay.logits_spec}
    step.shardings = specs
    return step, specs


def build_decode_step(model: Model, mesh, shape: ShapeConfig):
    """The sharded decode step: ``repro``'s ``build_decode_step`` over one
    process per rank -> ``(step, specs)``.

    ``step(params, cache, token, pos) -> (logits, cache)``: this rank's
    parameter blocks, cache blocks (a cache of ``shape.seq_len`` slots,
    ``cache_shardings``), token block [B, 1] (``specs["token"]``) and the
    absolute position (an int, the same on every rank); it writes the new
    key and value into the cache blocks in place (the reference donates
    them) and returns this rank's logits block and the cache.  See
    :class:`_ServingLayout` for the compute layout.  Every rank of the mesh
    calls the step together; ``pipe``/``seq`` above 1 are refused."""
    _check_no_pp_cp_serving(mesh, "decode")
    lay = _ServingLayout(model, mesh, shape, shape)
    _, decode = _serving_fns(model)
    t_rest = lay.b_specs["token"]
    t_c = shd.P(*lay.rows, None)

    @torch.inference_mode()
    def step(params, cache, token, pos):
        p = lay.params(params)
        tok = lay.move(token, t_rest, t_c)
        work = _zip3(lay.move, cache, tree_like(cache, lay.c_specs),
                     tree_like(cache, lay.decode_c))
        with lay.context(decode=True):
            logits, work = decode(p, cache=work, token=tok, pos=int(pos))
        del p

        for r, w, c, s in zip(tree_leaves(cache), tree_leaves(work),
                              tree_leaves(tree_like(cache, lay.decode_c)),
                              tree_leaves(tree_like(cache, lay.c_specs))):
            if w is not r:
                r.copy_(lay.move(w, c, s))
        return lay.logits(logits), cache

    step.mesh = mesh
    specs = {"params": lay.p_specs, "cache": lay.c_specs, "token": t_rest,
             "logits": lay.logits_spec}
    step.shardings = specs
    step._in_place = (1,)
    step._in_place_label = "decode_step(cache)"
    return step, specs
