"""Knowledge distillation with the teacher's output layer colocated with
the student (paper §2.2, §3.1), on one device.

Counterpart of ``repro/distill/workload.py``'s ``teacher_hidden``,
``distill_loss`` and ``build_colocated_step``.  The teacher body is a
forward-only section that produces final hidden states; the teacher's
unembedding lives with the student, which computes
CE + α·T²·KL(p_teacher ‖ p_student) from both models' hidden states
through the chunked-vocab ``distill_kl`` kernel, so neither model's
[N, V] distillation logits are formed.  ``distill_spec`` and
``DistillRuntime`` (the disaggregated compound runtime) are not ported
yet (ROADMAP.md, A4).
"""
from __future__ import annotations

import torch

from repro_torch.core.types import ArchConfig, ParallelConfig, ShapeConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
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

