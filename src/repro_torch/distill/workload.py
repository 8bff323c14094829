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

from repro_torch.core import workload as wl
from repro_torch.core.types import ArchConfig, ParallelConfig, ShapeConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
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


def distill_loss(params_s, s_cfg: ArchConfig, batch: dict,
                 h_teacher: torch.Tensor, teacher_unembed: torch.Tensor, *,
                 alpha: float = 0.5, temperature: float = 2.0,
                 remat: bool = True):
    """-> (CE + α·T²·KL, {"ce", "kl", "aux"}) from hidden states, with the
    teacher's output layer colocated here."""
    h_s, aux = tf.lm_forward(params_s, s_cfg, batch, remat=remat,
                             logits_out=False)
    logits = tf.unembed(params_s, s_cfg, h_s)
    ce = cm.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    B, S, Ds = h_s.shape
    w_s = (params_s["embed"].T if s_cfg.tie_embeddings
           else params_s["unembed"])
    mask = batch.get("loss_mask")
    kl = kops.distill_kl(
        h_s.reshape(B * S, Ds), w_s,
        h_teacher.detach().reshape(B * S, -1), teacher_unembed.detach(),
        mask=None if mask is None else mask.reshape(B * S),
        temperature=temperature)
    loss = (1 - alpha) * ce + alpha * (temperature ** 2) * kl
    return loss, {"ce": ce, "kl": kl, "aux": aux}


def build_colocated_step(t_cfg: ArchConfig, s_cfg: ArchConfig,
                         shape: ShapeConfig, parallel: ParallelConfig, *,
                         alpha: float = 0.5, temperature: float = 2.0,
                         lr_schedule=None,
                         opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig()):
    """-> ``step(params_s, opt_state, params_t, batch, step_idx) ->
    (params_s, opt_state, {"loss", "grad_norm", "lr", "ce", "kl", "aux"})``.

    Per micro-batch: the frozen teacher's forward (no autograd), then the
    student's loss and backward; float32 gradient accumulation and one
    AdamW update of the student, as ``build_train_step`` does.  The
    teacher's parameters get no gradient."""
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
