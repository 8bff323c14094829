"""The colocated compound steps on a mesh: spawned gloo ranks.

    python tests/torch_drivers/driver_colocated.py CASE WORLD IN.npz OUT

``CASE`` is one of

* ``distill``: ``distill.workload.build_colocated_step(..., mesh=)`` at
  (dp 2, tp 2) on 4 ranks, one step;
* ``dp2``: ``mllm.workload.build_colocated_step(..., mesh=)`` and
  ``distill.multi_teacher.build_colocated_step(..., mesh=)`` at dp 2 on 2
  ranks, one step each, then the multi-teacher step at tp 2 on the same
  ranks;
* ``world1``: each of the three on a one-rank mesh against its meshless
  step, two steps each, compared bit for bit here;
* ``distill_b1``: the distillation step at dp 2 on 2 ranks with a global
  batch of one row (``distill_b1/batch/<key>``), its sequence laid out
  over the data ranks.

Each mesh step takes this rank's block of the batch (``step.block``).

``IN.npz`` holds the full parameter trees (``<case>/params/<tree>/<path>``,
float32) and the batches (``<case>/batch/<key>``); rank 0 writes
``OUT.0.npz`` with each step's loss and grad norm and the full updated
parameters (``<case>/params/<path>``), or for ``world1`` one flag per
comparison.  Prints ``DRIVER_OK colocated <CASE>``.  Imports no ``jax`` and
nothing of ``repro``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dist_util import flat, nest, spawn  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import workload as wl  # noqa: E402
from repro_torch.core.types import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.distill import multi_teacher as mt  # noqa: E402
from repro_torch.distill import workload as dw  # noqa: E402
from repro_torch.mllm import workload as mw  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models import vlm  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402

#: distillation: global batch, sequence, rows a micro-batch, the mesh
D_B, D_S, D_MBS, D_PAR = 8, 16, 2, ParallelConfig(dp=2, tp=2, mbs=2)
#: the distillation step at one row on 2 data ranks
D1_B, D1_PAR = 1, ParallelConfig(dp=2)
#: MLLM and multi-teacher: global batch, sequence, microbatch rows
B, S, MBS = 8, 32, 4
#: the image rows and the specialist's routed rows, in dispatch order: in
#: each MLLM microbatch one data rank's rows hold no image; the routed rows
#: fall 2 : 1 and 0 : 1 over the two data ranks
HAS_IMAGE = (1, 1, 0, 0, 0, 0, 1, 0)
DOMAIN = (1, 1, 1, 0, 0, 0, 0, 1)
LR = 1e-3
#: a large epsilon keeps AdamW's first update linear in the gradient, so
#: that float32 rounding in a tiny gradient cannot flip its sign-like step
OPT = adamw.AdamWConfig(eps=1e-3)


def lr_fn(step):
    return schedules.constant(step, peak_lr=LR)


# --------------------------------------------------------------------------- #
# configurations, shared with the test
# --------------------------------------------------------------------------- #
def distill_cfgs():
    """Teacher and student (reduced qwen2.5-32b and qwen1.5-0.5b, float32,
    vocabulary 512; the student's embeddings tied)."""
    return (get_reduced("qwen2.5-32b").replace(dtype="float32",
                                               vocab_size=512),
            get_reduced("qwen1.5-0.5b").replace(dtype="float32",
                                                vocab_size=512))


def mllm_cfgs():
    """The ViT and the LM of tests/test_torch_mllm.py."""
    lm = get_reduced("pixtral-12b").replace(
        dtype="float32", vocab_size=256, vision_dim=32, max_image_tokens=4)
    vit = vlm.vit_config(num_layers=2, d_model=32, num_heads=2, d_ff=64,
                         patch_dim=16, downsample=4, out_dim=32,
                         name="vit-tiny").replace(dtype="float32")
    return vit, lm


def mt_cfgs():
    """Generalist, specialist and student (reduced, float32, vocabulary
    256; the specialist narrower)."""
    ta = get_reduced("qwen2.5-32b").replace(dtype="float32", vocab_size=256)
    tb = get_reduced("granite-3-8b").replace(dtype="float32", vocab_size=256,
                                             d_model=64, head_dim=16,
                                             d_ff=128)
    s = get_reduced("qwen1.5-0.5b").replace(dtype="float32", vocab_size=256)
    return ta, tb, s


# --------------------------------------------------------------------------- #
# loading
# --------------------------------------------------------------------------- #
def params(arrays, prefix: str, specs) -> dict:
    """The float32 tree ``prefix`` of IN.npz in its parameters' dtypes."""
    def cast(tree, s):
        if isinstance(tree, dict):
            return {k: cast(tree[k], s[k]) for k in s}
        return torch.from_numpy(np.asarray(tree)).to(s.dtype)
    return cast(nest(arrays, prefix), specs)


def batch(arrays, prefix: str) -> dict:
    """A batch of IN.npz; ``patches`` back to bfloat16 (stored exactly)."""
    out = {k: torch.from_numpy(np.asarray(v))
           for k, v in nest(arrays, prefix).items()}
    if "patches" in out:
        out["patches"] = out["patches"].to(torch.bfloat16)
    return out


def mllm_batch(arrays, prefix: str = "mllm/batch/"):
    """(the colocated batch, the plan) of the MLLM case, FIFO order."""
    b = batch(arrays, prefix)
    plan = mw.build_plan(tuple(range(B)), b["has_image"].numpy(), MBS)
    return mw.colocated_batch(b, plan), plan


def mt_batch(arrays, prefix: str = "mt/batch/"):
    """(the colocated batch, the plan) of the multi-teacher case."""
    b = batch(arrays, prefix)
    act = wl.build_activation(tuple(range(B)), b["domain"].numpy(), MBS)
    plan = wl.IterationPlan(tuple(range(B)), MBS, B // MBS,
                            {"teacher_b": act})
    return mt.colocated_batch(b, plan), plan


def opt_state(full_tree, step, key: str, mesh):
    """The optimizer state's blocks of a full tree, or ``adamw.init`` of
    the tree itself without a mesh."""
    if mesh is None:
        return adamw.init(full_tree)
    return adamw.init(shd.shard_tree(full_tree,
                                     step.shardings[key].master, mesh))


def full(blocks, specs, mesh) -> dict:
    """Every leaf of a tree of blocks, gathered whole."""
    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k]) for k in t}
        return shd.gather(t, s, mesh)
    return walk(blocks, specs)


# --------------------------------------------------------------------------- #
# the steps
# --------------------------------------------------------------------------- #
def distill_step(arrays, mesh, par=None, gb: int = D_B,
                 prefix: str = "distill/batch/"):
    """-> (step, the student's blocks, opt, the teacher's blocks, batch)
    on ``mesh``, or the meshless step and full trees with ``mesh`` None."""
    t_cfg, s_cfg = distill_cfgs()
    if par is None:
        par = (D_PAR if mesh is not None and shd.mesh_shape(mesh)["data"] > 1
               else ParallelConfig(mbs=D_MBS))
    step = dw.build_colocated_step(
        t_cfg, s_cfg, ShapeConfig("d", "train", D_S, gb), par, mesh=mesh,
        lr_schedule=lr_fn, opt_cfg=OPT)
    pt = params(arrays, "distill/params/teacher/", tf.lm_specs(t_cfg))
    ps = params(arrays, "distill/params/student/", tf.lm_specs(s_cfg))
    opt = opt_state(ps, step, "opt", mesh)
    if mesh is None:
        ps = tree_map(lambda x: x.requires_grad_(), ps)
    else:
        pt = shd.shard_tree(pt, step.shardings["teacher"], mesh)
        ps = shd.shard_tree(ps, step.shardings["student"], mesh)
    return step, ps, opt, pt, feed(step, batch(arrays, prefix))


def mllm_step(arrays, mesh):
    vit, lm = mllm_cfgs()
    step = mw.build_colocated_step(vit, lm, device="cpu", mesh=mesh,
                                   lr_schedule=lr_fn, opt_cfg=OPT)
    p = {"vit": params(arrays, "mllm/params/vit/", vlm.vit_specs(vit)),
         "lm": params(arrays, "mllm/params/lm/", tf.lm_specs(lm))}
    opt = opt_state(p, step, "opt", mesh)
    if mesh is not None:
        p = shd.shard_tree(p, step.shardings["params"], mesh)
    return step, p, opt, feed(step, mllm_batch(arrays)[0])


def mt_step(arrays, mesh):
    ta, tb, s = mt_cfgs()
    step = mt.build_colocated_step(ta, tb, s, mesh=mesh, lr_schedule=lr_fn,
                                   opt_cfg=OPT)
    pa = params(arrays, "mt/params/teacher_a/", tf.lm_specs(ta))
    pb = params(arrays, "mt/params/teacher_b/", tf.lm_specs(tb))
    ps = params(arrays, "mt/params/student/", tf.lm_specs(s))
    w_a = mt.teacher_unembed(pa, ta, "cpu")
    w_b = mt.teacher_unembed(pb, tb, "cpu")
    opt = opt_state(ps, step, "opt", mesh)
    if mesh is None:
        ps = tree_map(lambda x: x.requires_grad_(), ps)
    else:
        pa = shd.shard_tree(pa, step.shardings["teacher_a"], mesh)
        pb = shd.shard_tree(pb, step.shardings["teacher_b"], mesh)
        ps = shd.shard_tree(ps, step.shardings["student"], mesh)
    return step, ps, opt, pa, pb, w_a, w_b, feed(step, mt_batch(arrays)[0])


def feed(step, b: dict) -> dict:
    """What the step takes of the global batch ``b``: this rank's block on
    a mesh, else all of it."""
    return step.block(b) if hasattr(step, "block") else b


def _record(out: dict, name: str, met: dict, tree) -> None:
    out[f"{name}/loss"] = np.asarray([float(met["loss"])])
    out[f"{name}/grad_norm"] = np.asarray([float(met["grad_norm"])])
    out.update(flat(tree, f"{name}/params/"))


# --------------------------------------------------------------------------- #
# cases
# --------------------------------------------------------------------------- #
def case_distill(rank, world, arrays, out):
    mesh = shd.section_mesh(range(world), D_PAR)
    step, ps, opt, pt, b = distill_step(arrays, mesh)
    ps, opt, met = step(ps, opt, pt, b, 0)
    res = {}
    _record(res, "distill", met,
            full(ps, step.shardings["student"], mesh))
    if rank == 0:
        np.savez(f"{out}.{rank}.npz", **res)


def case_dp2(rank, world, arrays, out):
    mesh = shd.section_mesh(range(world), ParallelConfig(dp=world))
    res = {}
    step, p, opt, cb = mllm_step(arrays, mesh)
    p, opt, met = step(p, opt, cb, 0)
    _record(res, "mllm", met, full(p, step.shardings["params"], mesh))
    step, ps, opt, pa, pb, w_a, w_b, cb = mt_step(arrays, mesh)
    ps, opt, met = step(ps, opt, pa, pb, w_a, w_b, cb, 0)
    _record(res, "mt", met, full(ps, step.shardings["student"], mesh))
    # the same two ranks as one model axis: the KL terms on each rank's
    # half of the token rows
    mesh = shd.section_mesh(range(world), ParallelConfig(tp=world))
    step, ps, opt, pa, pb, w_a, w_b, cb = mt_step(arrays, mesh)
    ps, opt, met = step(ps, opt, pa, pb, w_a, w_b, cb, 0)
    _record(res, "mt_tp2", met, full(ps, step.shardings["student"], mesh))
    if rank == 0:
        np.savez(f"{out}.{rank}.npz", **res)


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def case_world1(rank, world, arrays, out):
    """Each mesh step on a one-rank mesh against its meshless step, two
    steps, bit for bit."""
    torch.use_deterministic_algorithms(True)
    mesh = shd.section_mesh([0], ParallelConfig(mbs=D_MBS))
    res = {}
    runs = {}
    for name, build in (("distill", distill_step), ("mllm", mllm_step),
                        ("mt", mt_step)):
        runs[name] = [list(build(arrays, None)),
                      list(build(arrays, mesh))]
    for i in range(2):
        for name, (plain, meshed) in runs.items():
            got = []
            for r in (plain, meshed):
                step, p, opt, *rest = r
                if name == "distill":
                    p, opt, met = step(p, opt, rest[0], rest[1], i)
                elif name == "mllm":
                    p, opt, met = step(p, opt, rest[0], i)
                else:
                    p, opt, met = step(p, opt, *rest, i)
                r[1], r[2] = p, opt
                got.append((p, met))
            (p0, m0), (p1, m1) = got
            res[f"{name}/{i}/loss"] = np.asarray(
                [torch.equal(m0["loss"], m1["loss"])])
            res[f"{name}/{i}/grad_norm"] = np.asarray(
                [torch.equal(m0["grad_norm"], m1["grad_norm"])])
            res[f"{name}/{i}/params"] = np.asarray([_equal(p0, p1)])
    np.savez(f"{out}.{rank}.npz", **res)


def case_distill_b1(rank, world, arrays, out):
    mesh = shd.section_mesh(range(world), D1_PAR)
    step, ps, opt, pt, b = distill_step(arrays, mesh, D1_PAR, D1_B,
                                        "distill_b1/batch/")
    ps, opt, met = step(ps, opt, pt, b, 0)
    res = {}
    _record(res, "distill_b1", met,
            full(ps, step.shardings["student"], mesh))
    if rank == 0:
        np.savez(f"{out}.{rank}.npz", **res)


CASES = {"distill": case_distill, "dp2": case_dp2, "world1": case_world1,
         "distill_b1": case_distill_b1}


def _main(rank, world, case, in_path, out):
    CASES[case](rank, world, np.load(in_path), out)


if __name__ == "__main__":
    case, world, in_path, out = (sys.argv[1], int(sys.argv[2]), sys.argv[3],
                                 sys.argv[4])
    spawn(_main, world, case, in_path, out)
    print(f"DRIVER_OK colocated {case}")
