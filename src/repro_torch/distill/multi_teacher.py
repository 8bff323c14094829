"""Multi-teacher knowledge distillation with data-dependent routing.
Counterpart of ``repro/distill/multi_teacher.py``.

TWO frozen teacher sections feed one student.  The generalist teacher
sees every sample; the *specialist* teacher activates only on samples
whose ``domain`` flag routes to it (data-dependent activation), so the
wavefront scheduler groups specialist samples into fewer microbatches and
the specialist section never runs on pure-generalist microbatches.

Per §3.1 both teachers' output layers are colocated with the student
(consts ``w_a`` / ``w_b``): only hidden states cross the section
boundaries, and the student computes

    loss = (1-α)·CE + α·T²·(KL_a + KL_b·[domain])

with the chunked-vocab ``distill_kl`` kernel.  Specialist rows travel in
the capacity layout (gathered + zero-padded) and are scattered back to
sample slots inside the student loss; the KL_b token mask comes from
scattering ``act_valid`` — an all-generalist microbatch contributes an
exact-zero KL_b.

:func:`multi_teacher_spec` is run by the generic
:class:`repro_torch.core.workload.CompoundRuntime` (on devices, or on
section meshes with ``ranks=``; :func:`student_consts` hands the teachers'
output layers to the student either way);
:func:`build_colocated_step` is the one-device oracle (a Python loop over
the microbatches of :func:`colocated_batch`) the runtime is held against.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import workload as wl
from repro_torch.core.types import ArchConfig, ParallelConfig
from repro_torch.distill.workload import (mesh_kl, teacher_hidden,
                                          teacher_unembedding)
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw, schedules
from repro_torch.train.step import add_f32

LM_KEYS = ("tokens", "labels", "loss_mask")


# --------------------------------------------------------------------------- #
# Shared arithmetic (oracle ≡ disaggregated)
# --------------------------------------------------------------------------- #
def specialist_hidden(pt, tb_cfg: ArchConfig, tokens: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Specialist-teacher hidden states for the gathered (capacity-layout)
    domain samples of one microbatch, padding rows masked to exact zero.
    tokens [cap, S], valid [cap] → h [cap, S, D_b]."""
    h = teacher_hidden(pt, tb_cfg, tokens)
    return h * valid[:, None, None].to(h.dtype)


def student_mt_loss(ps, s_cfg: ArchConfig, batch: dict, h_a, w_a, h_b,
                    b_idx, b_valid, w_b, *, alpha: float,
                    temperature: float, share=None, kl=kops.distill_kl):
    """CE + α·T²·(KL vs generalist + domain-masked KL vs specialist).
    h_b arrives in capacity layout and is scattered back to sample slots
    by ``b_idx``; the KL_b mask is the scattered ``b_valid``.  ``share``
    (a section mesh's ``inputs["loss_share"]``) weights CE and KL_a by
    this rank's share of ``loss_mask`` and KL_b by its share of the KL_b
    mask, so that the terms sum over the student's data ranks to the
    global means (the specialist's rows need not fall evenly).  ``kl``
    computes each KL term (``distill.workload.mesh_kl`` on a mesh)."""
    h_s, _ = tf.lm_forward(ps, s_cfg, batch, remat=True, logits_out=False)
    logits = tf.unembed(ps, s_cfg, h_s)
    ce = cm.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    B, S, Ds = h_s.shape
    w_s = ps["embed"].T if s_cfg.tie_embeddings else ps["unembed"]
    hsf = h_s.reshape(B * S, Ds)
    lm = batch["loss_mask"].reshape(B * S)
    T = temperature
    kl_a = kl(hsf, w_s, h_a.detach().reshape(B * S, -1),
                           w_a.detach(), mask=lm, temperature=T)
    b_idx = b_idx.long()
    hb = torch.zeros((B,) + tuple(h_b.shape[1:]), dtype=h_b.dtype,
                     device=h_b.device).index_add(0, b_idx, h_b.detach())
    mb = torch.zeros((B,), dtype=torch.float32,
                     device=b_valid.device).index_add(0, b_idx,
                                                      b_valid.float())
    mask_b = (batch["loss_mask"] * mb[:, None]).reshape(B * S)
    kl_b = kl(hsf, w_s, hb.reshape(B * S, -1), w_b.detach(),
                           mask=mask_b, temperature=T)
    if share is not None:
        s_lm, s_b = share(lm, mask_b).unbind(0)
        ce, kl_a, kl_b = ce * s_lm, kl_a * s_lm, kl_b * s_b
    loss = (1 - alpha) * ce + alpha * T * T * (kl_a + kl_b)
    return loss, {"ce": ce, "kl_a": kl_a, "kl_b": kl_b}


# --------------------------------------------------------------------------- #
# The declaration (run it with CompoundRuntime — no bespoke runtime class)
# --------------------------------------------------------------------------- #
def multi_teacher_spec(ta_cfg: ArchConfig, tb_cfg: ArchConfig,
                       s_cfg: ArchConfig, *,
                       ta_parallel: ParallelConfig,
                       tb_parallel: ParallelConfig,
                       s_parallel: ParallelConfig,
                       global_batch: int, seq_len: int, mbs: int,
                       alpha: float = 0.5, temperature: float = 2.0
                       ) -> wl.WorkloadSpec:
    """Two frozen teachers → one student, specialist routed by the
    per-sample ``domain`` flag."""
    h_a = wl.Port("hidden", (wl.SEQ, ta_cfg.d_model), ta_cfg.dtype)
    h_b = wl.Port("hidden", (wl.SEQ, tb_cfg.d_model), tb_cfg.dtype)

    def ta_fn(pt, x):
        return {"hidden": teacher_hidden(pt, ta_cfg, x["tokens"])}

    def tb_fn(pt, x):
        return {"hidden": specialist_hidden(pt, tb_cfg, x["tokens"],
                                            x["act_valid"])}

    def s_fn(ps, x):
        batch = {k: x[k] for k in LM_KEYS}
        return student_mt_loss(
            ps, s_cfg, batch, x["teacher_a.hidden"], x["w_a"],
            x["teacher_b.hidden"], x["teacher_b.act_idx"],
            x["teacher_b.act_valid"], x["w_b"], alpha=alpha,
            temperature=temperature, share=x.get("loss_share"))

    tok = {"tokens": wl.Field((wl.SEQ,), "int32")}
    teacher_a = wl.SectionSpec(
        "teacher_a", ta_cfg, ta_parallel, ta_fn, tf.lm_specs(ta_cfg),
        inputs=tok, emits=(h_a,), mode="fwd_only")
    teacher_b = wl.SectionSpec(
        "teacher_b", tb_cfg, tb_parallel, tb_fn, tf.lm_specs(tb_cfg),
        inputs=tok, emits=(h_b,), mode="fwd_only",
        activation=lambda b: np.asarray(b["domain"]).astype(bool))
    student = wl.SectionSpec(
        "student", s_cfg, s_parallel, s_fn, tf.lm_specs(s_cfg),
        inputs={"tokens": wl.Field((wl.SEQ,), "int32"),
                "labels": wl.Field((wl.SEQ,), "int32"),
                "loss_mask": wl.Field((wl.SEQ,), "float32")},
        consumes=(wl.Consume("teacher_a", h_a),
                  wl.Consume("teacher_b", h_b)),
        loss=True, loss_aux=True, critical=True, loss_share=True,
        consts={"w_a": wl.Field((ta_cfg.d_model, ta_cfg.padded_vocab),
                                ta_cfg.dtype),
                "w_b": wl.Field((tb_cfg.d_model, tb_cfg.padded_vocab),
                                tb_cfg.dtype)})
    return wl.WorkloadSpec("multi_teacher",
                           (teacher_a, teacher_b, student),
                           seq_len=seq_len, global_batch=global_batch,
                           mbs=mbs)


def teacher_unembed(params_t, t_cfg: ArchConfig, device) -> torch.Tensor:
    """A teacher's (student-colocated) output layer, on the student
    section's device."""
    return teacher_unembedding(params_t, t_cfg).to(device)


def student_consts(rt: wl.CompoundRuntime, params: dict, ta_cfg: ArchConfig,
                   tb_cfg: ArchConfig) -> dict:
    """The ``consts`` of :meth:`CompoundRuntime.submit_iteration`: both
    teachers' output layers on the student's device.  On section meshes
    (``ranks=``) each teacher's origin sends its own to the student's
    ranks: every rank calls this with the params it holds, and a rank
    without the student gets ``{}``."""
    out = {}
    for sec, cfg, key in (("teacher_a", ta_cfg, "w_a"),
                          ("teacher_b", tb_cfg, "w_b")):
        p = params.get(sec)
        w = teacher_unembedding(p, cfg) if p is not None else None
        out[key] = rt.transfer(sec, "student", key, w,
                               (cfg.d_model, cfg.padded_vocab), cfg.dtype)
    return {"student": out} if "student" in rt.local_sections else {}


# --------------------------------------------------------------------------- #
# Colocated one-device oracle
# --------------------------------------------------------------------------- #
def colocated_batch(batch: dict, plan: wl.IterationPlan, device=None
                    ) -> dict:
    """Permute into the plan's dispatch order, pre-split into
    [n_mb, mbs, ...], and attach the specialist capacity layout — the
    oracle's loop sees exactly the executor's microbatch composition.
    Tensors land on ``device`` (default: the CPU)."""
    order = torch.as_tensor(plan.order, dtype=torch.int64)
    out = {}
    for k in LM_KEYS:
        v = torch.as_tensor(batch[k]).cpu().index_select(0, order)
        out[k] = v.reshape((plan.n_mb, plan.mbs) + tuple(v.shape[1:]))
    act = plan.activation["teacher_b"]
    out["b_idx"] = torch.as_tensor(act.idx, dtype=torch.int64)
    out["b_valid"] = torch.as_tensor(act.valid)
    return {k: v.to(device or "cpu") for k, v in out.items()}


def build_colocated_step(ta_cfg: ArchConfig, tb_cfg: ArchConfig,
                         s_cfg: ArchConfig, *, alpha: float = 0.5,
                         temperature: float = 2.0, lr_schedule=None,
                         opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                         return_grads: bool = False, mesh=None):
    """-> ``step(params_s, opt_state, params_a, params_b, w_a, w_b, batch,
    step_idx) -> (params_s, opt_state, metrics)`` over a batch from
    :func:`colocated_batch`: per microbatch, both teacher forwards (the
    specialist on its gathered domain samples) + the student loss, the
    student's gradients accumulated in float32 in dispatch order, one
    AdamW update (``opt_state`` in place).

    ``mesh`` (a ``DeviceMesh`` with the reference's axis names): the
    reference's step on a mesh (microbatch rows over the data axes; ``w_a``,
    ``w_b``, ``b_idx`` and ``b_valid`` replicated), one process a rank.
    ``params_s``/``opt_state`` are this rank's blocks under
    ``step.shardings["student"]``/``["opt"]`` (ZeRO), each teacher's under
    ``rules_for(cfg, mesh, teacher=True)`` (``["teacher_a"]``,
    ``["teacher_b"]``), gathered once a step; ``batch`` is this rank's
    block of :func:`colocated_batch`, ``step.block(batch)``: its rows of
    every microbatch, ``b_idx`` and ``b_valid`` whole.  The specialist runs on the routed rows among a rank's own
    (``core.workload.rows_capacity``); CE and KL_a are weighted by the
    rank's share of ``loss_mask``, KL_b by its share of the routed tokens,
    which may fall unevenly over the data ranks (``student_mt_loss``'s
    ``share``).  All three models run under Megatron TP on a ``model``
    axis; a ``seq`` or ``pipe`` axis above 1 raises (the reference's step
    installs no ``cp_attention``).  On a one-rank mesh the step equals the
    meshless one bit for bit."""
    lr_fn = lr_schedule or functools.partial(schedules.constant,
                                             peak_lr=1e-3)
    if mesh is not None:
        return _build_mesh_step(ta_cfg, tb_cfg, s_cfg, mesh, alpha=alpha,
                                temperature=temperature, lr_fn=lr_fn,
                                opt_cfg=opt_cfg, return_grads=return_grads)

    def step(params_s, opt_state, params_a, params_b, w_a, w_b, batch,
             step_idx):
        n_mb = batch["tokens"].shape[0]
        leaves = tree_leaves(params_s)
        g_acc, l_sum = None, None
        for i in range(n_mb):
            mb = {k: batch[k][i] for k in LM_KEYS}
            bidx, bval = batch["b_idx"][i], batch["b_valid"][i]
            h_a = teacher_hidden(params_a, ta_cfg, mb["tokens"])
            h_b = specialist_hidden(params_b, tb_cfg,
                                    mb["tokens"].index_select(0, bidx), bval)
            p = tree_map(lambda x: x.detach().requires_grad_(), params_s)
            loss, _ = student_mt_loss(p, s_cfg, mb, h_a, w_a, h_b, bidx,
                                      bval, w_b, alpha=alpha,
                                      temperature=temperature)
            g_acc, l_sum = add_f32(g_acc, l_sum, loss,
                                   torch.autograd.grad(loss, tree_leaves(p)))
        with torch.no_grad():
            grads = tree_unflatten(params_s, [(a / n_mb).to(x.dtype) for a, x
                                              in zip(g_acc, leaves)])
        lr = lr_fn(step_idx)
        new_p, new_opt, gnorm = adamw.update(grads, opt_state, lr, opt_cfg)
        metrics = {"loss": (l_sum / n_mb).float(), "grad_norm": gnorm,
                   "lr": lr}
        if return_grads:
            metrics["grads"] = grads
        return new_p, new_opt, metrics

    return step


def _build_mesh_step(ta_cfg: ArchConfig, tb_cfg: ArchConfig,
                     s_cfg: ArchConfig, mesh, *, alpha: float,
                     temperature: float, lr_fn, opt_cfg: adamw.AdamWConfig,
                     return_grads: bool):
    """:func:`build_colocated_step` on ``mesh`` (see there)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.train import step as st
    par = st.mesh_parallel(mesh)
    cfgs = (("teacher_a", ta_cfg), ("teacher_b", tb_cfg), ("student", s_cfg))
    for name, cfg in cfgs:
        regime = wl.validate_section_parallel(
            f"multi_teacher.colocated({name})", cfg, par, mesh)
        if regime != "plain":
            raise NotImplementedError(
                f"multi_teacher.colocated({name}): a seq axis of "
                f"{par.cp}: the colocated multi-teacher step runs in the "
                "plain regime (the reference's installs no cp_attention)")
    lay = st.DataLayout(mesh, "plain", 1, 0)
    trees, ctxs = {}, {}
    for name, cfg in cfgs:
        specs = tf.lm_specs(cfg)
        ctxs[name], c = st.model_context(cfg, specs, mesh, "plain", par)
        student = name == "student"
        trees[name] = st.BlockTree.of(
            specs, mesh, shd.rules_for(cfg, mesh, teacher=not student), c,
            zero=True if student else None)
    blocks = trees["student"]
    kl = mesh_kl(mesh)

    def share(*masks: torch.Tensor) -> torch.Tensor:
        """Per mask, this rank's sum over the sum across the data ranks."""
        with torch.no_grad():
            local = torch.stack([m.float().sum() for m in masks])
            total = shd.all_reduce_axes(local.clone(), mesh, lay.sum_ax)
            return local / torch.where(total > 0, total,
                                       torch.ones_like(total))

    def step(params_s, opt_state, params_a, params_b, w_a, w_b, batch,
             step_idx):
        n_mb, n = batch["tokens"].shape[:2]
        lo = lay.rank * n
        # the teachers' forwards read no output layer (w_a, w_b stand for
        # them), so theirs are not gathered
        body = {sec: {key: x for key, x in tree.items() if key != "unembed"}
                for sec, tree in (("teacher_a", params_a),
                                  ("teacher_b", params_b))}
        full_t = {sec: tree_unflatten(tree, trees[sec].compute(
            tree, trees[sec].lists(tree), grad=False))
            for sec, tree in body.items()}
        lists = blocks.lists(params_s)
        full = blocks.compute(params_s, lists)
        p = tree_unflatten(params_s, full)
        g_acc, l_sum = None, None
        for i in range(n_mb):
            mb = {k: batch[k][i] for k in LM_KEYS}
            bidx, bval = wl.rows_capacity(batch["b_idx"][i],
                                          batch["b_valid"][i], lo, n)
            with ctxs["teacher_a"]():
                h_a = teacher_hidden(full_t["teacher_a"], ta_cfg,
                                     mb["tokens"])
            with ctxs["teacher_b"]():
                h_b = specialist_hidden(full_t["teacher_b"], tb_cfg,
                                        mb["tokens"].index_select(0, bidx),
                                        bval)
            with ctxs["student"]():
                loss, _ = student_mt_loss(p, s_cfg, mb, h_a, w_a, h_b, bidx,
                                          bval, w_b, alpha=alpha,
                                          temperature=temperature,
                                          share=share, kl=kl)
            g_acc, l_sum = st.add_f32(g_acc, l_sum, loss,
                                      torch.autograd.grad(loss, full))
            del loss, h_a, h_b
        del full, p, full_t
        g_opt = blocks.reduce(g_acc, lists, lay.sum_ax)
        del g_acc
        lr = lr_fn(step_idx)
        grads = blocks.grad_tree(params_s, [a / n_mb for a in g_opt])
        gnorm = blocks.global_norm(grads, params_s)
        new_p, new_opt = blocks.apply(params_s, opt_state, grads, lists, lr,
                                      opt_cfg, gnorm)
        l_sum = shd.all_reduce_axes(l_sum, mesh, lay.sum_ax)
        metrics = {"loss": (l_sum / n_mb).float(), "grad_norm": gnorm,
                   "lr": lr}
        if return_grads:
            metrics["grads"] = grads
        return new_p, new_opt, metrics

    step.mesh = mesh
    step.block = functools.partial(st.microbatch_rows, lay, keys=LM_KEYS)
    step.shardings = {k: t.p_specs for k, t in trees.items()}
    step.shardings["opt"] = blocks.o_specs
    return step
