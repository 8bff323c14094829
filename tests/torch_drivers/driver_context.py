"""Context parallelism on spawned gloo ranks: the port's CP attention and
the train step's cp regime.

    python tests/torch_drivers/driver_context.py CASE WORLD IN.npz OUT.npz

``attn``: ``IN.npz`` holds ``q``, ``k``, ``v`` (full, float32); each rank
takes its sequence shard on a ``section_mesh`` of ``ParallelConfig(cp=
WORLD)`` and runs every mode of :data:`ATTN_CASES` for its world size,
forward and the gradients of ``sum(o ** 2)``; rank 0 writes the gathered
``<case>/{o,dq,dk,dv}``.

``step`` / ``layout``: the cases of :data:`STEP_CASES` /
:data:`LAYOUT_CASES` for this world size, each from ``<case>/params/
<path>`` (float32, cast to the parameters' dtypes) and one global batch
``<case>/batch/<key>``, of which each rank takes its block
(``step.block``): one sharded train step at its ``ParallelConfig``;
rank 0 writes
``<case>/{loss,grad_norm}`` and the gathered ``<case>/params/<path>``.
A case whose name ends in ``_planted`` splices each shard's image slots
without the shard's shift (every shard reads the global positions as its
own), a fault the bounds must catch.

Prints ``DRIVER_OK context CASE``.  Imports no ``jax`` and nothing of
``repro``.
"""
import functools
import sys

import numpy as np
import torch
import torch.distributed as dist

from dist_util import flat, nest, spawn
from driver_pipeline import logit_width
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.types import ParallelConfig, ShapeConfig
from repro_torch.dist import context as cpx
from repro_torch.dist import sharding as shd
from repro_torch.models.common import tree_like
from repro_torch.models import transformer as tf
from repro_torch.models.model import build_model, model_specs
from repro_torch.optim import adamw, schedules
from repro_torch.train import step as step_mod

#: tests/drivers/driver_pipeline_cp.py's matrix: (name, mode, chunks,
#: window) per world size
ATTN_CASES = {
    4: [("ulysses", "ulysses", 1, 0), ("allgather", "allgather", 1, 0),
        ("chunks2", "ulysses", 2, 0), ("chunks4", "ulysses", 4, 0),
        ("chunks4_w24", "ulysses", 4, 24), ("auto", "auto", 1, 0)],
    8: [("ulysses_mqa", "ulysses_mqa", 1, 0),
        ("allgather", "allgather", 1, 0), ("auto", "auto", 1, 0)],
}

#: tests/drivers/driver_train_step_dist.py's cp2 step (granite, 4 layers),
#: a cp-only mesh whose heads divide 4, so that ulysses runs chunked, the
#: MoE and hybrid families (router statistics over data x seq; jamba's
#: Mamba mixers over the whole sequence), cp x tp (granite's 2 KV heads
#: split over 2 model ranks; granite-20b's one KV head repeated on both),
#: and the vlm family's image splice on sequence shards (pixtral)
STEP_CASES = {
    4: [("dp2cp2", "granite-3-8b", dict(num_layers=4),
         dict(dp=2, cp=2, mbs=2)),
        ("cp4c2", "qwen1.5-0.5b", {},
         dict(cp=4, mbs=4, cp_mode="ulysses", cp_overlap_chunks=2)),
        ("mix_d2cp2", "mixtral-8x22b", dict(num_layers=2),
         dict(dp=2, cp=2, mbs=2)),
        ("jamba_d2cp2", "jamba-v0.1-52b", {}, dict(dp=2, cp=2, mbs=2)),
        ("g_cp2t2", "granite-3-8b", dict(num_layers=4),
         dict(cp=2, tp=2, mbs=4)),
        ("g20_cp2t2", "granite-20b", {}, dict(cp=2, tp=2, mbs=4)),
        ("pix_d2cp2", "pixtral-12b", {}, dict(dp=2, cp=2, mbs=2)),
        ("pix_d2cp2_planted", "pixtral-12b", {}, dict(dp=2, cp=2, mbs=2))],
}
STEP_GB, STEP_S = 8, 16

#: (name, arch, config overrides, ParallelConfig knobs, (global batch,
#: sequence)): a batch of 1 at (dp 2, cp 2), its sequence over the data
#: ranks and replicated over seq, as the reference lays it out; the tied
#: vocabulary split over the model ranks at cp x tp
LAYOUT_CASES = {
    4: [("seq_b1_d2cp2", "granite-3-8b", dict(num_layers=4),
         dict(dp=2, cp=2), (1, 16)),
        ("vp_q_cp2t2", "qwen1.5-0.5b", {}, dict(cp=2, tp=2, mbs=8),
         (8, 16))],
}
# tests/drivers/driver_train_step_dist.py:32-36
STEP_OPT = adamw.AdamWConfig(eps=1e-3)
STEP_LR = functools.partial(schedules.constant, peak_lr=1e-3)


def _gather_seq(x: torch.Tensor, mesh) -> torch.Tensor:
    """Dim 1 shards of the ``seq`` axis -> the full tensor."""
    group = mesh.get_group(shd.AXIS_SEQ)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def case_attn(rank, world, arrays, out):
    mesh = shd.section_mesh(range(world), ParallelConfig(cp=world))
    n = arrays["q"].shape[1] // world
    full = {k: torch.from_numpy(arrays[k]) for k in ("q", "k", "v")}
    for name, mode, chunks, window in ATTN_CASES[world]:
        loc = {k: x[:, rank * n:(rank + 1) * n].clone().requires_grad_()
               for k, x in full.items()}
        o = cpx.cp_attention(loc["q"], loc["k"], loc["v"], mesh, mode=mode,
                             causal=True, window=window,
                             overlap_chunks=chunks)
        g = torch.autograd.grad((o ** 2).sum(), [loc["q"], loc["k"],
                                                  loc["v"]])
        got = [_gather_seq(x.detach(), mesh) for x in (o, *g)]
        if rank == 0:
            for key, x in zip(("o", "dq", "dk", "dv"), got):
                out[f"{name}/{key}"] = x.numpy()


def _cast(tree, specs):
    """IN.npz's float32 leaves back to their parameters' dtypes."""
    if isinstance(tree, dict):
        return {k: _cast(v, specs[k]) for k, v in tree.items()}
    return tree.to(specs.dtype)


def case_step(rank, world, arrays, out, cases=STEP_CASES):
    for name, arch, over, knobs, *shape in cases[world]:
        gb, seq = shape[0] if shape else (STEP_GB, STEP_S)
        cfg = get_reduced(arch).replace(dtype="float32", **over)
        params = _cast(params_from_numpy(nest(arrays, f"{name}/params/"),
                                         device="cpu"), model_specs(cfg))
        model = build_model(cfg, params, device="cpu")
        par = ParallelConfig(**knobs)
        mesh = shd.section_mesh(range(world), par)
        step = step_mod.build_train_step(
            model, par, ShapeConfig("t", "train", seq, gb),
            mesh=mesh, lr_schedule=STEP_LR, opt_cfg=STEP_OPT)
        sh = step.shardings
        p = shd.shard_tree(model.param_tree(), sh["params"], mesh)
        opt = adamw.init(shd.shard_tree(model.param_tree(),
                                        sh["opt"].master, mesh))
        batch = step.block({k: torch.from_numpy(v) for k, v in
                            nest(arrays, f"{name}/batch/").items()})
        offset = tf._slot_offset
        if name.endswith("_planted"):
            tf._slot_offset = lambda shard_len, device: 0
        try:
            with logit_width() as width:
                p, opt, met = step(p, opt, batch, 0)
        finally:
            tf._slot_offset = offset
        new = shd.gather_tree(p, tree_like(p, sh["params"]), mesh)
        if rank == 0:
            out[f"{name}/logit_width"] = np.array(width)
            out[f"{name}/loss"] = np.array([float(met["loss"])])
            out[f"{name}/grad_norm"] = np.array([float(met["grad_norm"])])
            out.update(flat(new, f"{name}/params/"))


def case_layout(rank, world, arrays, out):
    case_step(rank, world, arrays, out, LAYOUT_CASES)


def work(rank, world, case, in_path, out_path):
    arrays = np.load(in_path)
    out = {}
    globals()[f"case_{case}"](rank, world, arrays, out)
    if rank == 0:
        np.savez(out_path, **out)


if __name__ == "__main__":
    case, world = sys.argv[1], int(sys.argv[2])
    spawn(work, world, case, *sys.argv[3:5])
    print(f"DRIVER_OK context {case}")
