"""MLLM compound workload: ViT encoder section → LLM backbone section.
Counterpart of ``repro/mllm/workload.py``.

The headline Maestro workload (§2.1/§4.1): modality sections activate
*per sample* — text-only samples bypass the vision section entirely — and
the wavefront scheduler reorders samples so the critical (LLM) section
never stalls on vision work.  Two execution modes share one arithmetic:

* :func:`build_colocated_step` — one device, a Python loop over the
  microbatches of :func:`colocated_batch`, each doing the ViT forward of
  its image samples (gathered to the static per-microbatch capacity) +
  the LM loss with image-slot injection, joint gradients accumulated in
  float32 in microbatch order, one AdamW update.  The numerical oracle.
* :class:`MLLMRuntime` — disaggregated on the compound executor: the ViT
  section runs fwd/bwd tasks for *image-bearing microbatches only* on its
  own device (or its own worker thread and CUDA stream of a shared card),
  embeddings and their cotangents cross the message queue, and each
  iteration's microbatch composition comes from the wavefront order.

Both modes perform the same per-microbatch computations in the same order
(the disaggregated path only *skips* work whose contribution is an exact
zero), so on the CPU under ``torch.use_deterministic_algorithms`` the
runtime's losses, grad norms and parameters equal the colocated step's
bit for bit, on mixed and on all-text batches
(``tests/test_torch_mllm.py``).

Static vs dynamic shapes: each microbatch has a *static* vision capacity
(= its sample count); image samples are gathered into that capacity and
zero-padded with local index 0 and ``valid = 0``.  A padding row repeats
index 0, so the embeddings are scattered back to sample slots by
``index_add`` (the reference's ``.at[idx].add``), never by assignment,
which could let the zero padding row overwrite the real image's
embedding.  Whether a microbatch dispatches vision work at all is
dynamic (data-dependent activation).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import workload as wl
from repro_torch.core.scheduler import ScheduleResult
from repro_torch.core.types import ArchConfig, ParallelConfig
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.models import vlm
from repro_torch.models.common import (tree_leaves, tree_like, tree_map,
                                       tree_unflatten)
from repro_torch.optim import adamw, schedules
from repro_torch.train.step import add_f32

#: batch keys the LM step consumes (vision arrives as ``image_embeds``)
LM_KEYS = ("tokens", "labels", "loss_mask", "image_pos", "image_valid")


# --------------------------------------------------------------------------- #
# Shared per-microbatch arithmetic (oracle ≡ disaggregated)
# --------------------------------------------------------------------------- #
def vit_forward(pv, vit_cfg: ArchConfig, patches: torch.Tensor,
                valid: torch.Tensor, *, remat: bool = True) -> torch.Tensor:
    """ViT-encode the gathered image samples of one microbatch and mask
    padding rows.  patches [cap, P, pd], valid [cap] → emb [cap, K, Vd]."""
    emb = vlm.vit_encode(pv, vit_cfg, patches, remat=remat)
    return emb * valid[:, None, None].to(emb.dtype)


def lm_microbatch_loss(pl, lm_cfg: ArchConfig, mb: dict, emb: torch.Tensor,
                       vidx: torch.Tensor) -> torch.Tensor:
    """LM loss of one microbatch: scatter the (masked) vision embeddings
    back into per-sample image slots, then the backbone loss with
    image-slot injection.  emb [cap, K, Vd], vidx [cap] local indices
    (padding rows repeat index 0 and carry exact-zero embeddings)."""
    n = mb["tokens"].shape[0]
    img = torch.zeros((n,) + tuple(emb.shape[1:]), dtype=emb.dtype,
                      device=emb.device).index_add(0, vidx.long(), emb)
    lmb = {k: mb[k] for k in LM_KEYS if k in mb}
    lmb["image_embeds"] = img
    loss, _ = tf.lm_loss(pl, lm_cfg, lmb)
    return loss


# --------------------------------------------------------------------------- #
# Per-iteration plan: wavefront order → microbatch composition
# --------------------------------------------------------------------------- #
class IterationPlan(wl.IterationPlan):
    """The generic :class:`repro_torch.core.workload.IterationPlan` with
    the MLLM accessors (the ViT is the one activated section)."""

    @property
    def image_mbs(self):
        return self.activation["vit"].active_mbs

    @property
    def vis_idx(self):
        return self.activation["vit"].idx

    @property
    def vis_valid(self):
        return self.activation["vit"].valid


def build_plan(order: Sequence[int], has_image: np.ndarray, mbs: int,
               schedule: Optional[ScheduleResult] = None) -> IterationPlan:
    act = wl.build_activation(order, has_image, mbs)
    return IterationPlan(tuple(order), mbs, len(order) // mbs,
                         {"vit": act}, schedule)


def colocated_batch(batch: dict, plan: wl.IterationPlan) -> dict:
    """Lay one global batch out for the colocated oracle: permute into the
    plan's dispatch order and pre-split into [n_mb, mbs, ...] so the
    oracle's loop sees exactly the executor's microbatch composition.
    Host tensors; the step moves each microbatch onto its device."""
    order = torch.as_tensor(plan.order, dtype=torch.int64)
    out = {}
    for k in LM_KEYS + ("patches",):
        v = torch.as_tensor(batch[k]).cpu().index_select(0, order)
        out[k] = v.reshape((plan.n_mb, plan.mbs) + tuple(v.shape[1:]))
    act = plan.activation["vit"]
    out["vis_idx"] = torch.as_tensor(act.idx, dtype=torch.int64)
    out["vis_valid"] = torch.as_tensor(act.valid)
    return out


# --------------------------------------------------------------------------- #
# Colocated one-device oracle
# --------------------------------------------------------------------------- #
def build_colocated_step(vit_cfg: ArchConfig, lm_cfg: ArchConfig, *,
                         device="cuda", lr_schedule=None,
                         opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                         return_grads: bool = False, mesh=None):
    """-> ``step(params, opt_state, batch, step_idx) -> (params, opt_state,
    {"loss", "grad_norm", "lr"[, "grads"]})`` over a batch from
    :func:`colocated_batch`, with ``params`` keyed ``{"vit", "lm"}`` on
    ``device`` and ``opt_state = adamw.init(params)`` (updated in place).

    Per microbatch, on every microbatch as the reference's single jit
    does: the ViT forward on the gathered image samples (padding rows
    masked to exact zero) + the LM loss, joint gradients by autograd,
    accumulated in float32 in dispatch order; then one AdamW update whose
    joint grad norm sums the per-leaf squares in the runtime's order
    (sections sorted by name: ``llm`` before ``vit``).

    ``mesh`` (a ``DeviceMesh`` with the reference's axis names): the
    reference's step on a mesh (its microbatch rows over the data axes,
    ``vis_idx``/``vis_valid`` replicated), one process a rank.  ``params``
    and ``opt_state`` are this rank's blocks under ``step.shardings
    ["params"]`` and ``["opt"]`` (each section's ``rules_for``, ZeRO
    optimizer state, as the reference's ``opt_state_shardings`` default);
    ``batch`` is this rank's block of :func:`colocated_batch`,
    ``step.block(batch)``: its rows of every microbatch, ``vis_idx`` and
    ``vis_valid`` whole.  A rank runs the ViT on the image
    rows of its own LM rows (``core.workload.rows_capacity``: indices local
    to its rows, padding rows masked to exact zero; a rank holding no image
    runs it on padding alone and joins every collective), weights each
    microbatch's loss by its share of the mask total, and sums both
    sections' gradients over the data ranks.  The LM runs under Megatron
    TP on a ``model`` axis, the ViT whole on every model rank; a ``seq`` or
    ``pipe`` axis above 1 raises (``core.workload
    .validate_section_parallel``: the vlm family's image splice takes
    global positions).  On a one-rank mesh the step equals the meshless one
    bit for bit."""
    lr_fn = lr_schedule or functools.partial(schedules.constant,
                                             peak_lr=1e-3)
    if mesh is not None:
        return _build_mesh_step(vit_cfg, lm_cfg, mesh, lr_fn=lr_fn,
                                opt_cfg=opt_cfg, return_grads=return_grads)

    def joint_loss(ps, mb, vidx, vval):
        emb = vit_forward(ps["vit"], vit_cfg,
                          mb["patches"].index_select(0, vidx), vval)
        return lm_microbatch_loss(ps["lm"], lm_cfg, mb, emb, vidx)

    def step(params, opt_state, batch, step_idx):
        n_mb = batch["tokens"].shape[0]
        leaves = tree_leaves(params)
        g_acc, l_sum = None, None
        for i in range(n_mb):
            mb = {k: batch[k][i].to(device) for k in LM_KEYS + ("patches",)}
            vidx = batch["vis_idx"][i].to(device)
            vval = batch["vis_valid"][i].to(device)
            p = tree_map(lambda x: x.detach().requires_grad_(), params)
            loss = joint_loss(p, mb, vidx, vval)
            g_acc, l_sum = add_f32(g_acc, l_sum, loss,
                                   torch.autograd.grad(loss, tree_leaves(p)))
            del loss, p
        with torch.no_grad():
            grads = tree_unflatten(params, [(a / n_mb).to(x.dtype) for a, x
                                            in zip(g_acc, leaves)])
        del g_acc
        gnorm = adamw.global_norm({"lm": grads["lm"], "vit": grads["vit"]})
        lr = lr_fn(step_idx)
        new_p, new_opt, _ = adamw.update(
            grads, opt_state, lr, opt_cfg,
            gnorm=gnorm if opt_cfg.clip_norm > 0 else None)
        metrics = {"loss": (l_sum / n_mb).float(), "grad_norm": gnorm,
                   "lr": lr}
        if return_grads:
            metrics["grads"] = grads
        return new_p, new_opt, metrics

    return step


def _build_mesh_step(vit_cfg: ArchConfig, lm_cfg: ArchConfig, mesh, *,
                     lr_fn, opt_cfg: adamw.AdamWConfig, return_grads: bool):
    """:func:`build_colocated_step` on ``mesh`` (see there)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.train import step as st
    par = st.mesh_parallel(mesh)
    for name, cfg in (("vit", vit_cfg), ("llm", lm_cfg)):
        wl.validate_section_parallel(f"mllm.colocated({name})", cfg, par,
                                     mesh)
    lay = st.DataLayout(mesh, "plain", 1, 0)
    v_specs, l_specs = vlm.vit_specs(vit_cfg), tf.lm_specs(lm_cfg)
    v_ctx, v_c = st.model_context(vit_cfg, v_specs, mesh, "plain", par)
    l_ctx, l_c = st.model_context(lm_cfg, l_specs, mesh, "plain", par)
    vit = st.BlockTree.of(v_specs, mesh, shd.rules_for(vit_cfg, mesh), v_c)
    lm = st.BlockTree.of(l_specs, mesh, shd.rules_for(lm_cfg, mesh), l_c)
    ov, ol = vit.o_specs, lm.o_specs
    joint = st.BlockTree(
        mesh, {"vit": vit.p_specs, "lm": lm.p_specs},
        {"vit": v_c, "lm": l_c},
        adamw.AdamWState(step=ol.step, mu={"vit": ov.mu, "lm": ol.mu},
                         nu={"vit": ov.nu, "lm": ol.nu},
                         master={"vit": ov.master, "lm": ol.master}))

    def step(params, opt_state, batch, step_idx):
        n_mb, n = batch["tokens"].shape[:2]
        lo = lay.rank * n
        lists = joint.lists(params)
        full = joint.compute(params, lists)
        fp = tree_unflatten(params, full)
        dev = full[0].device
        mbs = [{k: batch[k][i].to(dev)
                for k in LM_KEYS + ("patches",)} for i in range(n_mb)]
        weights = lay.weights(mbs)
        g_acc, l_sum = None, None
        for i, mb in enumerate(mbs):
            vidx, vval = wl.rows_capacity(batch["vis_idx"][i].to(dev),
                                          batch["vis_valid"][i].to(dev),
                                          lo, n)
            with v_ctx():
                emb = vit_forward(fp["vit"], vit_cfg,
                                  mb["patches"].index_select(0, vidx), vval)
            with l_ctx():
                loss = lm_microbatch_loss(fp["lm"], lm_cfg, mb, emb, vidx)
            # this rank's share of the microbatch's global mean
            loss = loss * weights[i]
            g_acc, l_sum = st.add_f32(g_acc, l_sum, loss,
                                      torch.autograd.grad(loss, full))
            del loss, emb
        del full, fp, mbs
        g_opt = joint.reduce(g_acc, lists, lay.sum_ax)
        del g_acc
        grads = joint.grad_tree(params, [a / n_mb for a in g_opt])
        del g_opt
        gnorm = adamw.sharded_global_norm(
            {"lm": grads["lm"], "vit": grads["vit"]},
            {"lm": tree_like(params["lm"], ol.master),
             "vit": tree_like(params["vit"], ov.master)}, mesh)
        lr = lr_fn(step_idx)
        new_p, new_opt = joint.apply(params, opt_state, grads, lists, lr,
                                     opt_cfg, gnorm)
        l_sum = shd.all_reduce_axes(l_sum, mesh, lay.sum_ax)
        metrics = {"loss": (l_sum / n_mb).float(), "grad_norm": gnorm,
                   "lr": lr}
        if return_grads:
            metrics["grads"] = grads
        return new_p, new_opt, metrics

    step.mesh = mesh
    step.block = functools.partial(st.microbatch_rows, lay,
                                   keys=LM_KEYS + ("patches",))
    step.shardings = {"params": joint.p_specs, "opt": joint.o_specs}
    return step


def init_compound_params(vit_cfg: ArchConfig, lm_cfg: ArchConfig, *,
                         seed: int = 0, device="cuda") -> dict:
    """Joint ``{"vit", "lm"}`` params on ``device``, each section from a
    ``torch.Generator`` seeded as :meth:`CompoundRuntime.init` seeds the
    spec's sections (``vit`` ``seed``, ``lm`` ``seed + 1``)."""
    out = {}
    for i, (name, specs) in enumerate((("vit", vlm.vit_specs(vit_cfg)),
                                       ("lm", tf.lm_specs(lm_cfg)))):
        gen = torch.Generator(device=device).manual_seed(seed + i)
        out[name] = cm.init_params(specs, gen, device)
    return out


# --------------------------------------------------------------------------- #
# Declarative workload spec + thin runtime wrapper
# --------------------------------------------------------------------------- #
def mllm_spec(vit_cfg: ArchConfig, lm_cfg: ArchConfig, *,
              vit_parallel: ParallelConfig, lm_parallel: ParallelConfig,
              global_batch: int, seq_len: int, mbs: int) -> wl.WorkloadSpec:
    """The MLLM workload as a declaration: a data-dependent ViT section
    emitting per-microbatch vision embeddings, and the critical LM
    section scattering them into image slots.  Everything else — section
    devices and streams, AdamW, the joint grad-norm, wavefront dispatch —
    is the generic :class:`repro_torch.core.workload.CompoundRuntime`."""
    K, Vd = lm_cfg.max_image_tokens, lm_cfg.vision_dim
    ds = vlm.downsample_factor(vit_cfg)
    P = K * ds
    if K % vit_parallel.cp:
        raise ValueError(
            f"section 'vit': cp={vit_parallel.cp} splits its {P} patches into "
            f"shards of {P / vit_parallel.cp:g}, not a multiple of the "
            f"downsample factor {ds}: the merge would join tokens across a "
            "shard boundary")
    emb = wl.Port("emb", (K, Vd), vit_cfg.dtype)

    def vit_fn(pv, x):
        return {"emb": vit_forward(pv, vit_cfg, x["patches"],
                                   x["act_valid"])}

    def llm_fn(pl, x):
        mb = {k: x[k] for k in LM_KEYS}
        return lm_microbatch_loss(pl, lm_cfg, mb, x["vit.emb"],
                                  x["vit.act_idx"])

    vit = wl.SectionSpec(
        "vit", vit_cfg, vit_parallel, vit_fn, vlm.vit_specs(vit_cfg),
        inputs={"patches": wl.Field((P, vit_cfg.frontend_dim),
                                    vit_cfg.dtype)},
        emits=(emb,),
        activation=lambda b: np.asarray(b["has_image"]).astype(bool),
        seq_len=P)
    llm = wl.SectionSpec(
        "llm", lm_cfg, lm_parallel, llm_fn, tf.lm_specs(lm_cfg),
        inputs={"tokens": wl.Field((wl.SEQ,), "int32"),
                "labels": wl.Field((wl.SEQ,), "int32"),
                "loss_mask": wl.Field((wl.SEQ,), "float32"),
                "image_pos": wl.Field((K,), "int32", seq_split=False),
                "image_valid": wl.Field((K,), "int32", seq_split=False)},
        consumes=(wl.Consume("vit", emb, seq_split=False),),
        loss=True, critical=True)
    return wl.WorkloadSpec("mllm", (vit, llm), seq_len=seq_len,
                           global_batch=global_batch, mbs=mbs)


def _sections(tree):
    """``{"vit", "lm"}`` → the spec's ``{"vit", "llm"}`` (on section
    meshes a rank holds only its own sections' trees)."""
    return {s: tree[j] for j, s in (("vit", "vit"), ("lm", "llm"))
            if tree.get(j) is not None}


def _joint(tree):
    """The spec's ``{"vit", "llm"}`` → ``{"vit", "lm"}``."""
    return {j: tree[s] for j, s in (("vit", "vit"), ("lm", "llm"))
            if s in tree}


class MLLMRuntime:
    """ViT and LLM sections on their own devices (or one card shared, each
    section on its own worker thread and CUDA stream), driven by the
    generic :class:`~repro_torch.core.workload.CompoundRuntime`: this
    class is the MLLM parameter/metric surface (params keyed ``{"vit",
    "lm"}``, ``n_vit_tasks``, the MLLM ``IterationPlan``) over
    :func:`mllm_spec`.

    ``devices`` lists the ViT's device, then the LLM's (default: every
    visible card; ``[torch.device("cuda:0")] * 2`` shares one card,
    ``["cpu", "cpu"]`` runs on the host).  ``ranks`` carves section
    meshes instead (the ViT's ranks, then the LM's), each section at its
    own data degree; the ViT may also split its patch sequence over a
    ``seq`` axis (``vit_parallel.cp``, the reference's default of 2 in
    ``build_vlm_graph``), each rank merging the tokens of its own shard.
    The LM may split its token sequence too (``lm_parallel.cp``): each of
    its sequence ranks takes the image slots and embeddings whole and
    splices those inside its shard (``models.transformer.vision_scatter``),
    and the embeddings' cotangent sums over them."""

    def __init__(self, vit_cfg: ArchConfig, lm_cfg: ArchConfig, *,
                 vit_parallel: ParallelConfig, lm_parallel: ParallelConfig,
                 global_batch: int, seq_len: int, mbs: int,
                 devices=None, ranks=None, lr_schedule=None,
                 opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                 lookahead: int = 0):
        self.vit_cfg, self.lm_cfg = vit_cfg, lm_cfg
        self.spec = mllm_spec(vit_cfg, lm_cfg, vit_parallel=vit_parallel,
                              lm_parallel=lm_parallel,
                              global_batch=global_batch, seq_len=seq_len,
                              mbs=mbs)
        self._crt = wl.CompoundRuntime(
            self.spec, devices=devices, ranks=ranks,
            lr_schedule=lr_schedule or functools.partial(
                schedules.constant, peak_lr=1e-3),
            opt_cfg=opt_cfg, lookahead=lookahead)
        self.rt = self._crt.rt
        self.executor = self._crt.executor
        self.graph = self._crt.graph

    # ------------------------------------------------------------------ #
    def init(self, seed: int = 0):
        """Init + place both sections' params (as
        :func:`init_compound_params` draws them) and their optimizer
        states (on section meshes, this rank's sections' blocks)."""
        if self.rt.meshes is not None:
            p, o = self._crt.init(seed)
            return _joint(p), _joint(o)
        return self.place(init_compound_params(
            self.vit_cfg, self.lm_cfg, seed=seed,
            device=self.rt.device("vit")))

    def place(self, params):
        """Place a joint ``{"vit", "lm"}`` param tree onto the sections'
        devices and build matching optimizer states."""
        p, o = self._crt.place(_sections(params))
        return _joint(p), _joint(o)

    def plan_iteration(self, has_image, *, reorder: bool = True
                       ) -> IterationPlan:
        p = self._crt.plan_iteration({"has_image": has_image},
                                     reorder=reorder)
        return IterationPlan(p.order, p.mbs, p.n_mb, p.activation,
                             p.schedule)

    # ------------------------------------------------------------------ #
    @staticmethod
    def _remap_metrics(metrics):
        # n_vit_tasks counts the data-dependent compute tasks only: the
        # worker-side ``upd``, which every trainable section runs, is left
        # out (None on a rank that does not run the ViT)
        n = metrics["n_tasks"].get("vit")
        metrics["n_vit_tasks"] = None if n is None else n - 1
        if "grads" in metrics:
            metrics["grads"] = _joint(metrics["grads"])
        return metrics

    def train_iteration(self, params, opts, batch, step_idx, *,
                        reorder: bool = True,
                        plan: Optional[IterationPlan] = None,
                        return_grads: bool = False,
                        timeout: float = 300.0):
        """One serialized global-batch iteration through the executor.
        Returns (params, opts, metrics) with metrics carrying the realized
        ``execution`` (timeline, makespan, utilization) and the plan."""
        if plan is None:
            plan = self.plan_iteration(batch["has_image"], reorder=reorder)
        p, o, metrics = self._crt.train_iteration(
            _sections(params), _sections(opts), batch, step_idx, plan=plan,
            return_grads=return_grads, timeout=timeout)
        return _joint(p), _joint(o), self._remap_metrics(metrics)

    # ------------------------------------------------------------------ #
    # streaming surface (cross-iteration lookahead)
    # ------------------------------------------------------------------ #
    def install(self, params, opts):
        """Adopt (params, opts) — keyed ``{"vit", "lm"}`` — as the
        streaming state advanced by worker-side updates."""
        self._crt.install(_sections(params), _sections(opts))

    def state(self):
        p, o = self._crt.state()
        return _joint(p), _joint(o)

    def blocks(self):
        """The streaming state as held (on section meshes this rank's
        blocks, which ``train_iteration`` and ``install`` take)."""
        p, o = self._crt.blocks()
        return _joint(p), _joint(o)

    @property
    def in_flight(self) -> int:
        return self._crt.in_flight

    @property
    def lookahead(self) -> int:
        return self._crt.lookahead

    @lookahead.setter
    def lookahead(self, depth: int) -> None:
        self._crt.lookahead = int(depth)

    def submit_iteration(self, batch, step_idx, *, reorder: bool = True,
                         plan: Optional[IterationPlan] = None,
                         return_grads: bool = False,
                         timeout: float = 300.0) -> int:
        if plan is None:
            plan = self.plan_iteration(batch["has_image"], reorder=reorder)
        return self._crt.submit_iteration(
            batch, step_idx, plan=plan, return_grads=return_grads,
            timeout=timeout)

    def retire(self, *, timeout: float = 300.0):
        return self._remap_metrics(self._crt.retire(timeout=timeout))

    def drain(self, *, timeout: float = 300.0):
        return [self._remap_metrics(m)
                for m in self._crt.drain(timeout=timeout)]

    def shutdown(self):
        self._crt.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
