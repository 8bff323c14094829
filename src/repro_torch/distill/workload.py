"""Knowledge distillation with the teacher's output layer colocated with
the student (paper §2.2, §3.1).

Counterpart of ``repro/distill/workload.py``.  The teacher body is a
forward-only section that produces final hidden states; the teacher's
unembedding lives with the student, which computes
CE + α·T²·KL(p_teacher ‖ p_student) from both models' hidden states
through the chunked-vocab ``distill_kl`` kernel, so neither model's
[N, V] distillation logits are formed.  Two execution modes:

* ``build_colocated_step`` — teacher and student in one step on one
  device (the numerical oracle);
* ``DistillRuntime`` — disaggregated: teacher and student sections on
  their own devices (or one card shared, each section on its own worker
  thread and CUDA stream), hidden states flowing through the message
  queue; a declaration (``distill_spec``) on the generic
  :class:`~repro_torch.core.workload.CompoundRuntime`.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.core import workload as wl
from repro_torch.core.types import ArchConfig, ParallelConfig, ShapeConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as tf
from repro_torch.models.common import tree_unflatten
from repro_torch.optim import adamw, schedules
from repro_torch.train.step import (accumulate_and_update,
                                    check_single_device, default_lr_schedule,
                                    num_microbatches)


def teacher_hidden(params_t, t_cfg: ArchConfig, tokens: torch.Tensor, *,
                   remat: bool = True) -> torch.Tensor:
    """Teacher body forward, recorded by no autograd: final hidden states
    [B, S, D_t] (no unembedding)."""
    with torch.no_grad():
        h, _ = tf.lm_forward(params_t, t_cfg, {"tokens": tokens},
                             remat=remat, logits_out=False)
    return h


def teacher_unembedding(params_t, t_cfg: ArchConfig) -> torch.Tensor:
    """The teacher's output layer as [D_t, V], detached: ``embed.T`` (a
    view, not a copy) when the embeddings are tied."""
    w = params_t["embed"].T if t_cfg.tie_embeddings else params_t["unembed"]
    return w.detach()


def rows_kl(group, size: int, index: int, *, w_summed: bool = False):
    """A stand-in for ``kernels.ops.distill_kl`` on a ``model`` axis whose
    ``size`` ranks hold the same token rows and the same whole output
    layers (Megatron TP): the KL kernel runs on this rank's ``index``-th
    of ``size`` contiguous parts of the rows, instead of every model rank
    running it on all of them.  The student's hidden states and output
    layer enter through Megatron's ``f`` (``dist.pipeline.copy_to``), so
    their KL gradients are summed over the model ranks in the backward
    (``w_summed``: the student's output layer is gathered from its
    vocabulary slices, ``models.transformer.output_layer``, whose backward
    sums it already); the value returned on each rank is the masked mean
    over every row."""
    from repro_torch.dist import pipeline as pl

    def kl(h_s, w_s, h_t, w_t, *, mask=None, temperature: float = 1.0):
        N = h_s.shape[0]
        lo, hi = index * N // size, (index + 1) * N // size
        h = pl.copy_to(h_s, group)
        w = w_s if w_summed else pl.copy_to(w_s, group)
        m = None if mask is None else mask[lo:hi]
        part = kops.distill_kl(h[lo:hi], w, h_t[lo:hi], w_t, mask=m,
                               temperature=temperature)
        with torch.no_grad():
            # this part's share of the masked mean over every row
            share = (torch.tensor(float(hi - lo) / N, device=h_s.device)
                     if mask is None else
                     m.float().sum() / mask.float().sum().clamp_min(1.0))
        part = part * share
        whole = part.detach().clone()
        dist.all_reduce(whole, group=group)
        return part + (whole - part.detach())
    return kl


def mesh_kl(mesh, *, w_summed: bool = False):
    """The KL a colocated step on ``mesh`` computes its terms with:
    :func:`rows_kl` on a ``model`` axis above 1, else
    ``kernels.ops.distill_kl``."""
    from repro_torch.dist import sharding as shd
    tp = shd.mesh_shape(mesh).get(shd.AXIS_MODEL, 1)
    if tp == 1:
        return kops.distill_kl
    return rows_kl(mesh.get_group(shd.AXIS_MODEL), tp,
                   shd.coordinate(mesh)[shd.AXIS_MODEL], w_summed=w_summed)


def distill_loss(params_s, s_cfg: ArchConfig, batch: dict,
                 h_teacher: torch.Tensor, teacher_unembed: torch.Tensor, *,
                 alpha: float = 0.5, temperature: float = 2.0,
                 remat: bool = True, kl=kops.distill_kl):
    """-> (CE + α·T²·KL, {"ce", "kl", "aux"}) from hidden states, with the
    teacher's output layer colocated here; ``kl`` computes the KL term
    (:func:`mesh_kl` on a mesh)."""
    h_s, aux = tf.lm_forward(params_s, s_cfg, batch, remat=remat,
                             logits_out=False)
    ce = tf.hidden_ce(params_s, s_cfg, h_s, batch["labels"],
                      batch.get("loss_mask"))
    B, S, Ds = h_s.shape
    w_s = tf.output_layer(params_s, s_cfg)
    mask = batch.get("loss_mask")
    kl_v = kl(
        h_s.reshape(B * S, Ds), w_s,
        h_teacher.detach().reshape(B * S, -1), teacher_unembed.detach(),
        mask=None if mask is None else mask.reshape(B * S),
        temperature=temperature)
    loss = (1 - alpha) * ce + alpha * (temperature ** 2) * kl_v
    return loss, {"ce": ce, "kl": kl_v, "aux": aux}


def build_colocated_step(t_cfg: ArchConfig, s_cfg: ArchConfig,
                         shape: ShapeConfig, parallel: ParallelConfig, *,
                         alpha: float = 0.5, temperature: float = 2.0,
                         lr_schedule=None,
                         opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                         mesh=None):
    """-> ``step(params_s, opt_state, params_t, batch, step_idx) ->
    (params_s, opt_state, {"loss", "grad_norm", "lr", "ce", "kl", "aux"})``.

    Per micro-batch: the frozen teacher's forward (no autograd), then the
    student's loss and backward; float32 gradient accumulation and one
    AdamW update of the student, as ``build_train_step`` does.  The
    teacher's parameters get no gradient.

    ``mesh`` (a ``DeviceMesh`` with the reference's axis names): the
    reference's colocated step on a mesh, one process a rank, dispatched
    as ``build_train_step(..., mesh=)`` is.  Both sections are validated
    by ``core.workload.validate_section_parallel`` (a ``pipe`` axis above
    1 raises, as in the reference: the distillation loss is not staged).  The student's parameters are
    this rank's blocks under ``step.shardings["student"]`` with ZeRO
    optimizer-state blocks (``["opt"]``), the teacher's under
    ``rules_for(t_cfg, mesh, teacher=True)`` (``["teacher"]``), gathered
    once a step and given no gradient; ``batch`` is this rank's block of
    the global batch, ``step.block(global_batch)``, in the reference's
    layout (``train.step.DataLayout``): its rows of the shard-major layout
    where the batch divides the data axes, else its sequence columns of
    every row (both models' attention then runs over the data axes'
    group), else the whole batch; on a ``seq`` axis also its sequence
    columns, where both models' attention runs through ``cp_attention``.
    At tp > 1 both models run under Megatron TP, the KL kernel takes both
    output layers whole (the kernel needs whole [D, V] unembeddings) and
    each model rank its share of the token rows (:func:`rows_kl`).  Where
    the student's padded vocabulary divides ``model``, its cross-entropy
    is vocab-parallel, as the train step's: each rank forms only its
    slice's logits, and the KL gathers the student's output layer whole
    from the slices (``models.transformer.output_layer``), whose backward
    sums each rank's KL gradient into its slice.  On a one-rank mesh the
    step equals the meshless one bit for bit."""
    if mesh is not None:
        return _build_mesh_step(t_cfg, s_cfg, shape, parallel, mesh,
                                alpha=alpha, temperature=temperature,
                                lr_schedule=lr_schedule, opt_cfg=opt_cfg)
    for cfg, role in ((t_cfg, "teacher"), (s_cfg, "student")):
        check_single_device(parallel,
                            f"distill.colocated({role}: {cfg.name})")
    n_micro = num_microbatches(shape, parallel)
    lr_fn = lr_schedule or default_lr_schedule()

    def step(params_s, opt_state, params_t, batch, step_idx):
        w_t = teacher_unembedding(params_t, t_cfg)

        def loss_fn(p, mb):
            h_t = teacher_hidden(params_t, t_cfg, mb["tokens"],
                                 remat=parallel.remat)
            return distill_loss(p, s_cfg, mb, h_t, w_t, alpha=alpha,
                                temperature=temperature,
                                remat=parallel.remat)

        return accumulate_and_update(loss_fn, params_s, opt_state, batch,
                                     step_idx, n_micro=n_micro, lr_fn=lr_fn,
                                     opt_cfg=opt_cfg)

    return step


def _build_mesh_step(t_cfg: ArchConfig, s_cfg: ArchConfig,
                     shape: ShapeConfig, parallel: ParallelConfig, mesh, *,
                     alpha: float, temperature: float, lr_schedule,
                     opt_cfg: adamw.AdamWConfig):
    """:func:`build_colocated_step` on ``mesh`` (see there)."""
    from repro_torch.dist import pipeline as pl
    from repro_torch.dist import sharding as shd
    from repro_torch.train import step as st
    for cfg, role in ((t_cfg, "teacher"), (s_cfg, "student")):
        wl.validate_section_parallel(f"distill.colocated({role})", cfg,
                                     parallel, mesh)
    if (parallel.grad_compress or "none") != "none":
        raise NotImplementedError(
            f"distill.colocated: grad_compress={parallel.grad_compress!r} "
            "is a knob of the sharded train step and of compound sections "
            "(CompoundRuntime(ranks=)); the colocated step reduces in "
            "float32, as the reference's does")
    regime, _, dp_total = st._check_sharded(s_cfg, parallel, shape, mesh)
    n_micro = num_microbatches(shape, parallel, dp_total)
    lr_fn = lr_schedule or default_lr_schedule()
    bs = (shape.global_batch, shape.seq_len)
    lay = st.DataLayout(mesh, regime, n_micro, shape.seq_len,
                        shape.global_batch,
                        {"tokens": bs, "labels": bs, "loss_mask": bs})
    t_specs, s_specs = tf.lm_specs(t_cfg), tf.lm_specs(s_cfg)
    t_ctx, t_c = st.model_context(t_cfg, t_specs, mesh, regime, parallel,
                                  seq_ax=lay.seq_ax)
    s_ctx, s_c = st.model_context(s_cfg, s_specs, mesh, regime, parallel,
                                  seq_ax=lay.seq_ax, vocab=True)
    teacher = st.BlockTree.of(t_specs, mesh,
                              shd.rules_for(t_cfg, mesh, teacher=True), t_c,
                              zero=None)
    student = st.BlockTree.of(s_specs, mesh, shd.rules_for(s_cfg, mesh), s_c,
                              zero=True)
    kl = mesh_kl(mesh, w_summed=pl.vocab_splits(s_cfg, mesh))

    def step(params_s, opt_state, params_t, batch, step_idx):
        mbs = lay.microbatches(batch)
        weights = lay.weights(mbs)
        full_t = tree_unflatten(params_t, teacher.compute(
            params_t, teacher.lists(params_t), grad=False))
        w_t = teacher_unembedding(full_t, t_cfg)
        lists = student.lists(params_s)
        full = student.compute(params_s, lists)

        def loss_fn(p, mb):
            with t_ctx():
                h_t = teacher_hidden(full_t, t_cfg, mb["tokens"],
                                     remat=parallel.remat)
            with s_ctx():
                return distill_loss(p, s_cfg, mb, h_t, w_t, alpha=alpha,
                                    temperature=temperature,
                                    remat=parallel.remat, kl=kl)

        g_acc, sums = st._accumulate(loss_fn, tree_unflatten(params_s, full),
                                     full, mbs, weights)
        del full, full_t, w_t
        g_acc = student.reduce(g_acc, lists, lay.sum_ax)
        if n_micro > 1:
            g_acc = [a / n_micro for a in g_acc]
        lr = lr_fn(step_idx)
        params_s, opt_state, gnorm = student.update(
            params_s, opt_state, g_acc, lists, lr, opt_cfg)
        metrics = lay.means(sums)
        metrics.update(grad_norm=gnorm, lr=lr)
        return params_s, opt_state, metrics

    step.mesh = mesh
    step.block = lay.block
    step.shardings = {"teacher": teacher.p_specs, "student": student.p_specs,
                      "opt": student.o_specs, "batch": lay.specs}
    step._in_place = (1,)
    step._in_place_label = "distill.colocated[sharded](params_s, opt)"
    return step


# --------------------------------------------------------------------------- #
# Declarative workload spec + thin runtime wrapper (paper-faithful)
# --------------------------------------------------------------------------- #
def distill_spec(t_cfg: ArchConfig, s_cfg: ArchConfig, *,
                 teacher_parallel: ParallelConfig,
                 student_parallel: ParallelConfig,
                 alpha: float = 0.5, temperature: float = 2.0
                 ) -> wl.WorkloadSpec:
    """KD as a declaration: a forward-only teacher section emitting final
    hidden states, and the critical student section computing CE + KL
    with the teacher's (colocated) output layer as a const.  Left
    shape-polymorphic (no global_batch/seq_len): the runtime binds shapes
    from the first batch, one microbatch per iteration."""
    hidden = wl.Port("hidden", (wl.SEQ, t_cfg.d_model), t_cfg.dtype)

    def teacher_fn(pt, x):
        return {"hidden": teacher_hidden(pt, t_cfg, x["tokens"],
                                         remat=teacher_parallel.remat)}

    def student_fn(ps, x):
        batch = {"tokens": x["tokens"], "labels": x["labels"],
                 "loss_mask": x["loss_mask"]}
        loss, met = distill_loss(
            ps, s_cfg, batch, x["teacher.hidden"], x["w_t"], alpha=alpha,
            temperature=temperature, remat=student_parallel.remat)
        return loss, {"ce": met["ce"], "kl": met["kl"]}

    teacher = wl.SectionSpec(
        "teacher", t_cfg, teacher_parallel, teacher_fn,
        tf.lm_specs(t_cfg),
        inputs={"tokens": wl.Field((wl.SEQ,), "int32")},
        emits=(hidden,), mode="fwd_only")
    student = wl.SectionSpec(
        "student", s_cfg, student_parallel, student_fn,
        tf.lm_specs(s_cfg),
        inputs={"tokens": wl.Field((wl.SEQ,), "int32"),
                "labels": wl.Field((wl.SEQ,), "int32"),
                "loss_mask": wl.Field((wl.SEQ,), "float32")},
        consumes=(wl.Consume("teacher", hidden),),
        loss=True, loss_aux=True, critical=True,
        consts={"w_t": wl.Field((t_cfg.d_model, t_cfg.padded_vocab),
                                t_cfg.dtype)})
    return wl.WorkloadSpec("distill", (teacher, student))


#: ``train_iteration``'s default ``w_t``: take the teacher's output layer
_UNSET = object()


class DistillRuntime:
    """Teacher and student sections on their own devices, hidden states
    flowing through the message queue: a thin declaration over
    :class:`~repro_torch.core.workload.CompoundRuntime` (``distill_spec``
    above).

    ``devices`` lists the teacher's device, then the student's (default:
    every visible card; ``[torch.device("cuda:0")] * 2`` shares one card,
    ``["cpu", "cpu"]`` runs on the host).  ``ranks`` carves section meshes
    instead (the teacher's ranks, then the student's), whose data degrees
    must satisfy the paper's eq. 1, ``DP^s = fanout · DP^t``; the student
    may also split the sequence over a ``seq`` axis (``student_parallel
    .cp``), each of its ranks taking the KL of its own tokens.
    ``train_iteration`` updates ``opt``'s tensors in place."""

    def __init__(self, t_cfg: ArchConfig, s_cfg: ArchConfig, *,
                 teacher_parallel: ParallelConfig,
                 student_parallel: ParallelConfig,
                 devices=None, ranks=None, alpha: float = 0.5,
                 temperature: float = 2.0, lr: float = 1e-3,
                 opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig()):
        fanout = student_parallel.dp // teacher_parallel.dp
        if teacher_parallel.dp * fanout != student_parallel.dp:
            raise ValueError(
                f"fanout constraint (paper eq. 1) violated: the student's "
                f"dp={student_parallel.dp} is not a multiple of the "
                f"teacher's dp={teacher_parallel.dp}")
        self.fanout = fanout
        self.t_cfg, self.s_cfg = t_cfg, s_cfg
        self.alpha, self.temperature = alpha, temperature
        self.spec = distill_spec(t_cfg, s_cfg,
                                 teacher_parallel=teacher_parallel,
                                 student_parallel=student_parallel,
                                 alpha=alpha, temperature=temperature)
        self.runtime = wl.CompoundRuntime(
            self.spec, devices=devices, ranks=ranks,
            lr_schedule=functools.partial(schedules.constant, peak_lr=lr),
            opt_cfg=opt_cfg)
        self.rt = self.runtime.rt
        self.graph = self.runtime.graph
        self.executor = self.runtime.executor
        self.last_execution = None

    # ------------------------------------------------------------------ #
    def init(self, seed: int = 0) -> Tuple:
        """(teacher params, student params, student optimizer state): on
        section meshes this rank's blocks, None for a section it does not
        run."""
        params, opts = self.runtime.init(seed)
        return (params.get("teacher"), params.get("student"),
                opts.get("student"))

    def teacher_unembed(self, params_t) -> torch.Tensor:
        """The teacher's output layer, on the student section's device (on
        section meshes: the teacher's origin sends it to every student
        rank; every rank calls this, and the ranks without the student get
        None)."""
        w = None
        if params_t is not None:
            # on section meshes the teacher's ranks gather it first: its
            # vocab dim rests split over the model axis
            key = "embed" if self.t_cfg.tie_embeddings else "unembed"
            w = teacher_unembedding(
                {key: self.runtime.full_leaf("teacher", params_t, key)},
                self.t_cfg)
        return self.runtime.transfer(
            "teacher", "student", "w_t", w,
            (self.t_cfg.d_model, self.t_cfg.padded_vocab), self.t_cfg.dtype)

    def train_iteration(self, params_t, params_s, opt, batch, step_idx, *,
                        w_t=_UNSET, timeout: float = 300.0):
        """One global-batch iteration on the compound executor: teacher
        fwd (its own worker) → hidden-state push → student pull +
        loss/grads → the student's AdamW update on its worker, with the
        realized timeline on ``last_execution``.  Returns (params_s, opt,
        metrics).  ``w_t`` is what :meth:`teacher_unembed` gave (on
        section meshes, None on a rank without the student); left out,
        every rank takes it again."""
        if w_t is _UNSET or (w_t is None and self.rt.meshes is None):
            w_t = self.teacher_unembed(params_t)
        params = {n: p for n, p in (("teacher", params_t),
                                    ("student", params_s)) if p is not None}
        opts = {} if opt is None else {"student": opt}
        params, opts, metrics = self.runtime.train_iteration(
            params, opts, batch, step_idx,
            consts={"student": {"w_t": w_t}}, timeout=timeout)
        self.last_execution = metrics["execution"]
        return params.get("student"), opts.get("student"), metrics

    def shutdown(self):
        self.runtime.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
