"""The three colocated compound steps on a mesh, on the CPU: the port's
``build_colocated_step(..., mesh=)`` of distillation, MLLM training and
multi-teacher distillation on spawned gloo ranks
(``tests/torch_drivers/driver_colocated.py``) against the JAX package's
``build_colocated_step`` on a mesh of the same shape, one step each from
the same parameters and batch.

* distillation at (dp 2, tp 2) on 4 ranks: the teacher (reduced
  qwen2.5-32b) under Megatron TP with ``teacher=True`` rules, the student
  (reduced qwen1.5-0.5b, tied embeddings) with ZeRO blocks, 2 micro-batches
  and a ragged loss mask;
* MLLM at dp 2, in microbatches of 4 whose image rows fall on one data rank
  only (each rank runs the ViT on its own image rows, remapped to local
  indices; the other on padding alone);
* multi-teacher at dp 2, the specialist's routed rows falling 2 : 1 and
  0 : 1 over the two ranks (KL_b weighted by each rank's share of them),
  and at tp 2 on the same two ranks (each KL term on each model rank's
  half of the token rows).

The JAX oracle runs while the ranks run, in a subprocess with 4 virtual
devices and Auto-typed meshes (``python tests/test_torch_colocated_mesh.py
--jax-oracle IN.npz OUT.npz``).  Loss and grad norm agree within
``REL`` (1e-5) of the JAX value, and every updated parameter leaf within
``LEAF_REL`` (2e-5) of that leaf's largest magnitude (float32).  Each
mesh step on a one-rank mesh equals its meshless step bit for bit over
two steps (the ``world1`` case).  A ``pipe`` axis above 1 raises, with
or without cp.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import glob  # noqa: E402
import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
DRIVERS = ROOT / "tests" / "torch_drivers"
sys.path.insert(0, str(DRIVERS))

import driver_colocated as dc  # noqa: E402
from repro_torch.core.types import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.data.synthetic import vlm_batches  # noqa: E402
from repro_torch.distill import multi_teacher as mt  # noqa: E402
from repro_torch.distill import workload as dw  # noqa: E402
from repro_torch.mllm import workload as mw  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models import vlm  # noqa: E402

#: float32 agreement with the JAX value (loss, grad norm)
REL = 1e-5
#: float32 agreement of each updated parameter leaf, of that leaf's largest
#: magnitude: the attention biases start at zero, so their largest
#: magnitude is one AdamW step, against which the float32 noise of their
#: gradients (sums over every token) shows at up to 1e-5
LEAF_REL = 2e-5


def _tree(specs, seed):
    return cm.init_params(specs, torch.Generator().manual_seed(seed), "cpu")


def _flat(tree, prefix):
    return dc.flat(tree, prefix)


def _inputs() -> dict:
    """Parameters and batches of the three cases (see the driver)."""
    rng = np.random.default_rng(0)
    out = {}
    t_cfg, s_cfg = dc.distill_cfgs()
    out.update(_flat(_tree(tf.lm_specs(t_cfg), 1), "distill/params/teacher/"))
    out.update(_flat(_tree(tf.lm_specs(s_cfg), 0), "distill/params/student/"))
    for k in ("tokens", "labels"):
        out[f"distill/batch/{k}"] = rng.integers(
            0, s_cfg.vocab_size, (dc.D_B, dc.D_S)).astype(np.int64)
    out["distill/batch/loss_mask"] = (
        rng.random((dc.D_B, dc.D_S)) < 0.7).astype(np.float32)
    vit, lm = dc.mllm_cfgs()
    out.update(_flat(mw.init_compound_params(vit, lm, seed=0, device="cpu"),
                     "mllm/params/"))
    b = next(vlm_batches(batch=dc.B, seq_len=dc.S, vocab=lm.vocab_size,
                         vision_ratio=1.0, image_tokens=lm.max_image_tokens,
                         patch_dim=vit.frontend_dim,
                         downsample=vlm.downsample_factor(vit), seed=0,
                         device="cpu"))
    has = np.asarray(dc.HAS_IMAGE, bool)
    b = {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
         for k, v in b.items()}
    b["patches"][~has] = 0.0
    b["image_valid"][~has] = 0
    b["loss_mask"][~has] = 1.0
    b["has_image"] = has.astype(np.int32)
    out.update({f"mllm/batch/{k}": v for k, v in b.items()})
    ta, tb, s = dc.mt_cfgs()
    for name, cfg, seed in (("teacher_a", ta, 1), ("teacher_b", tb, 2),
                            ("student", s, 0)):
        out.update(_flat(_tree(tf.lm_specs(cfg), seed),
                         f"mt/params/{name}/"))
    t = rng.integers(0, s.vocab_size, (dc.B, dc.S + 1)).astype(np.int64)
    out["mt/batch/tokens"], out["mt/batch/labels"] = t[:, :-1], t[:, 1:]
    out["mt/batch/loss_mask"] = (rng.random((dc.B, dc.S)) < 0.8).astype(
        np.float32)
    out["mt/batch/domain"] = np.asarray(dc.DOMAIN, np.int32)
    return out


# --------------------------------------------------------------------------- #
# the JAX oracle
# --------------------------------------------------------------------------- #
def jax_oracle(in_path: str, out_path: str) -> None:
    """One step of each JAX colocated step on an Auto-typed mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, Mesh
    from repro.configs import get_reduced as jreduced
    from repro.core import workload as jwl
    from repro.core.types import ParallelConfig as JParallel
    from repro.core.types import ShapeConfig as JShape
    from repro.distill import multi_teacher as jmt
    from repro.distill.workload import build_colocated_step as jdistill
    from repro.mllm import workload as jmw
    from repro.models import transformer as jtf
    from repro.models.common import init_params as jinit_params
    from repro.models.vlm import vit_config as jvit
    from repro.models.vlm import vit_specs as jvit_specs
    from repro.optim import adamw as jadamw
    from repro.optim import schedules as jsched
    from test_torch_compound import _flatten, _unflatten, save_tree

    assert len(jax.devices()) == 4, jax.devices()
    arrays = np.load(in_path)
    names = ("data", "pipe", "seq", "model")

    def mesh(shape):
        n = int(np.prod(shape))
        return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names,
                    axis_types=(AxisType.Auto,) * 4)

    def given(prefix, specs):
        dtypes = _flatten(jax.tree_util.tree_map(
            lambda x: np.asarray(x).dtype,
            jinit_params(specs, jax.random.PRNGKey(0))), prefix)
        return _unflatten({k: arrays[k].astype(dt)
                           for k, dt in dtypes.items()}, prefix)

    def batch(prefix):
        return {k[len(prefix):]: np.asarray(arrays[k]) for k in arrays.files
                if k.startswith(prefix)}

    lr = lambda s: jsched.constant(s, peak_lr=dc.LR)  # noqa: E731
    opt_cfg = jadamw.AdamWConfig(eps=dc.OPT.eps)
    out = {}

    def record(name, met, params):
        out[f"{name}/loss"] = np.asarray([float(met["loss"])])
        out[f"{name}/grad_norm"] = np.asarray([float(met["grad_norm"])])
        save_tree(out, jax.device_get(params), f"{name}/params")

    # distillation at (dp 2, tp 2)
    kw = dict(dtype="float32", vocab_size=512)
    t_cfg = jreduced("qwen2.5-32b").replace(**kw)
    s_cfg = jreduced("qwen1.5-0.5b").replace(**kw)
    m = mesh((2, 1, 1, 2))
    step, sh = jdistill(t_cfg, s_cfg, m, JShape("d", "train", dc.D_S, dc.D_B),
                        JParallel(dp=2, tp=2, mbs=dc.D_MBS), impl="ref",
                        lr_schedule=lr, opt_cfg=opt_cfg)
    pt = given("distill/params/teacher", jtf.lm_specs(t_cfg))
    ps = given("distill/params/student", jtf.lm_specs(s_cfg))
    b = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
         for k, v in batch("distill/batch/").items()}
    with m:
        new, _, met = step(jax.device_put(ps, sh["student"]),
                           jax.device_put(jadamw.init(ps), sh["opt"]),
                           jax.device_put(pt, sh["teacher"]), b,
                           jnp.int32(0))
    record("distill", met, new)

    # MLLM at dp 2
    lm = jreduced("pixtral-12b").replace(
        dtype="float32", vocab_size=256, vision_dim=32, max_image_tokens=4)
    vit = jvit(num_layers=2, d_model=32, num_heads=2, d_ff=64, patch_dim=16,
               downsample=4, out_dim=32, name="vit-tiny").replace(
                   dtype="float32")
    m = mesh((2, 1, 1, 1))
    step, sh = jmw.build_colocated_step(vit, lm, m, mbs=dc.MBS,
                                        seq_len=dc.S, impl="ref",
                                        lr_schedule=lr, opt_cfg=opt_cfg)
    p = {"vit": given("mllm/params/vit", jvit_specs(vit)),
         "lm": given("mllm/params/lm", jtf.lm_specs(lm))}
    b = batch("mllm/batch/")
    b["patches"] = jnp.asarray(b["patches"], jnp.bfloat16)
    plan = jmw.build_plan(tuple(range(dc.B)), b["has_image"], dc.MBS)
    with m:
        new, _, met = step(jax.device_put(p, sh["params"]),
                           jax.device_put(jadamw.init(p), sh["opt"]),
                           jmw.colocated_batch(b, plan), jnp.int32(0))
    record("mllm", met, new)

    # multi-teacher at dp 2
    kw = dict(dtype="float32", vocab_size=256)
    ta = jreduced("qwen2.5-32b").replace(**kw)
    tb = jreduced("granite-3-8b").replace(d_model=64, head_dim=16, d_ff=128,
                                          **kw)
    s = jreduced("qwen1.5-0.5b").replace(**kw)
    pa = given("mt/params/teacher_a", jtf.lm_specs(ta))
    pb = given("mt/params/teacher_b", jtf.lm_specs(tb))
    ps = given("mt/params/student", jtf.lm_specs(s))
    b = batch("mt/batch/")
    order = tuple(range(dc.B))
    plan = jwl.IterationPlan(order, dc.MBS, dc.B // dc.MBS, {
        "teacher_b": jwl.build_activation(order, b["domain"], dc.MBS)})
    for name, m in (("mt", m), ("mt_tp2", mesh((1, 1, 1, 2)))):
        step, sh = jmt.build_colocated_step(ta, tb, s, m, mbs=dc.MBS,
                                            seq_len=dc.S, impl="ref",
                                            lr_schedule=lr, opt_cfg=opt_cfg)
        with m:
            w_a, w_b = (jmt.teacher_unembed(t, c, m)
                        for t, c in ((pa, ta), (pb, tb)))
            new, _, met = step(jax.device_put(ps, sh["student"]),
                               jax.device_put(jadamw.init(ps), sh["opt"]),
                               jax.device_put(pa, sh["teacher_a"]),
                               jax.device_put(pb, sh["teacher_b"]), w_a,
                               w_b, jmt.colocated_batch(b, plan),
                               jnp.int32(0))
        record(name, met, new)
    np.savez(out_path, **out)


# --------------------------------------------------------------------------- #
# the runs
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("colocated_mesh")
    np.savez(tmp / "in.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(DRIVERS)]))
    env.pop("XLA_FLAGS", None)
    procs = {case: subprocess.Popen(
        [sys.executable, str(DRIVERS / "driver_colocated.py"), case,
         str(world), str(tmp / "in.npz"), str(tmp / case)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for case, world in (("distill", 4), ("dp2", 2), ("world1", 1))}
    env = dict(env, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), str(DRIVERS)]))
    procs["jax"] = subprocess.Popen(
        [sys.executable, __file__, "--jax-oracle", str(tmp / "in.npz"),
         str(tmp / "jax.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    got = {}
    for case, proc in procs.items():
        so, se = proc.communicate(timeout=420)
        assert proc.returncode == 0, (case, so[-3000:] + se[-6000:])
        if case == "jax":
            got[case] = np.load(tmp / "jax.npz")
            continue
        assert f"DRIVER_OK colocated {case}" in so, so[-3000:]
        [path] = glob.glob(f"{tmp / case}.0.npz")
        got[case] = np.load(path)
    return got


def _close_to_jax(got, jx, name):
    for k in ("loss", "grad_norm"):
        want = float(jx[f"{name}/{k}"][0])
        have = float(got[f"{name}/{k}"][0])
        print(f"{name} {k}: port {have:.9g}, JAX {want:.9g}")
        assert abs(have - want) <= REL * abs(want), (name, k, have, want)
    prefix = f"{name}/params/"
    have = {k[len(prefix):]: got[k] for k in got.files
            if k.startswith(prefix)}
    want = {k[len(prefix):]: jx[k] for k in jx.files
            if k.startswith(prefix)}
    assert have.keys() == want.keys()
    worst = 0.0
    for k, w in want.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(have[k] - w).max())
        worst = max(worst, err / scale)
        assert err <= LEAF_REL * scale, (name, k, err, scale)
    print(f"{name}: worst leaf {worst:.3g} of its largest magnitude")


def test_distill_dp2_tp2_matches_jax_colocated_step(runs):
    _close_to_jax(runs["distill"], runs["jax"], "distill")


def test_mllm_dp2_matches_jax_colocated_step(runs):
    # each microbatch's images lie among one data rank's rows only
    vit, _ = dc.mllm_cfgs()
    plan = mw.build_plan(tuple(range(dc.B)), np.asarray(dc.HAS_IMAGE), dc.MBS)
    half = dc.MBS // 2
    for i in range(plan.n_mb):
        ranks = {int(j) // half for j, v in zip(plan.vis_idx[i],
                                                 plan.vis_valid[i]) if v}
        assert len(ranks) == 1, (i, plan.vis_idx[i], plan.vis_valid[i])
    del vit
    _close_to_jax(runs["dp2"], runs["jax"], "mllm")


def test_multi_teacher_dp2_matches_jax_colocated_step(runs):
    # the routed rows fall unevenly over the two data ranks
    dom = np.asarray(dc.DOMAIN).reshape(-1, 2, dc.MBS // 2).sum(-1)
    assert (dom[:, 0] != dom[:, 1]).all(), dom
    _close_to_jax(runs["dp2"], runs["jax"], "mt")


def test_multi_teacher_tp2_matches_jax_colocated_step(runs):
    """Both KL terms on each model rank's half of the token rows
    (``distill.workload.rows_kl``), the teachers under Megatron TP."""
    _close_to_jax(runs["dp2"], runs["jax"], "mt_tp2")


@pytest.mark.parametrize("name", ["distill", "mllm", "mt"])
def test_one_rank_mesh_step_equals_meshless_step_bitwise(runs, name):
    got = runs["world1"]
    for i in range(2):
        for k in ("loss", "grad_norm", "params"):
            assert bool(got[f"{name}/{i}/{k}"][0]), (name, i, k)


def _sizes(**kw):
    return {"data": kw.get("dp", 1), "pipe": kw.get("pp", 1),
            "seq": kw.get("cp", 1), "model": kw.get("tp", 1)}


@pytest.mark.parametrize("par,match", [
    (ParallelConfig(dp=2, pp=2), "cannot be stage-partitioned"),
    (ParallelConfig(cp=2, pp=2), "pp x cp"),
])
def test_mesh_steps_refuse_pp_and_cp_tp(par, match):
    t_cfg, s_cfg = dc.distill_cfgs()
    mesh = _sizes(dp=par.dp, pp=par.pp, cp=par.cp, tp=par.tp)
    with pytest.raises(NotImplementedError,
                       match=rf"distill\.colocated\(teacher\).*{match}"):
        dw.build_colocated_step(t_cfg, s_cfg, ShapeConfig("d", "train", 16, 8),
                                par, mesh=mesh)
    vit, lm = dc.mllm_cfgs()
    with pytest.raises(NotImplementedError, match="mllm.colocated"):
        mw.build_colocated_step(vit, lm, mesh=mesh)
    ta, tb, s = dc.mt_cfgs()
    with pytest.raises(NotImplementedError, match="multi_teacher.colocated"):
        mt.build_colocated_step(ta, tb, s, mesh=mesh)


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    jax_oracle(sys.argv[2], sys.argv[3])
