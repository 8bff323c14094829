"""The reference's batch and vocabulary layouts on a section mesh, and
planner-sized sections, on the CPU.

(a) The three batch layouts (``dist.sharding.batch_layout``: rows over the
    data axes, else the sequence over them, else the whole batch on every
    data rank) through the port's sharded steps on spawned gloo ranks, each
    rank fed its block of the global batch (``step.block``), against the
    JAX package's ``build_train_step`` on Auto-axes ``section_mesh``es of
    8 virtual devices, float32, from the same parameters and batches:

    * ``tests/torch_drivers/driver_dp.py`` at world 4: a batch of 1 on dp
      4, a batch of 6 on dp 4 at mbs 2 and mixtral's MoE at a batch of 1
      (each with the sequence over the data ranks; the router statistics
      averaged over them), two steps each;
    * ``driver_pipeline.py layout`` at world 4: a batch of 3 on dp 2 with a
      sequence of 15 (replicated; qwen, and whisper, whose frames the
      reference's rule splits over the data ranks all the same), the
      pipeline regime at a batch of 1 on (dp 2, pp 2);
    * ``driver_context.py layout`` at world 4: a batch of 1 at (dp 2, cp
      2), its sequence over the data ranks and replicated over ``seq``;
    * ``driver_colocated.py distill_b1`` at world 2: the distillation step
      at a batch of 1 on dp 2.

(b) Vocab-parallel cross-entropy at tp > 1 with the embeddings tied
    (qwen1.5-0.5b reduced): tp 4 with three padded vocabulary rows
    (``driver_pipeline.py layout``) and cp 2 x tp 2 (``driver_context.py
    layout``), against the JAX step; every logit tensor a rank forms is
    ``padded_vocab / tp`` wide.  The untied cases (granite reduced at tp 2,
    tp 4 and cp 2 x tp 2) are ``tests/test_torch_tp.py``'s and
    ``test_torch_context_step.py``'s, whose steps take this path too.

(c) Planted faults, each of which must miss the bounds of its unplanted
    case: data rank 0's rows counted twice in the replicated layout, and
    the first vocabulary slice left out of the log-sum-exp.

(d) ``carve_sections(ranks=, gpu_counts=)`` against the reference's
    ``carve_sections(devices, gpu_counts=)`` on 8 virtual devices (the
    effective ``ParallelConfig``s and the rank ranges, and the refusal),
    on a fake process group of 8 ranks; and a ``MaestroRuntime`` sized by
    the planner's H100 plan on a fake world of its ranks.

(e) In the process: the port's ``batch_spec``/``batch_layout`` against
    the reference's ``batch_spec``, and the specs of every batch leaf
    against the reference's ``data_shardings`` (from the oracle).

The JAX oracle runs in three processes while the ranks run (``python
tests/test_torch_batch_layout.py --jax-oracle IN.npz OUT.npz PART 3``);
the port's carving runs in one more (``--port-carve OUT.json``).
Bounds: the train steps' loss within 1e-5, grad norm within 1e-3 and
every parameter within 1e-4 (``tests/drivers/driver_train_step_dist.py``'s,
as ``test_torch_tp.py``); the distillation step's loss and grad norm
within 1e-5 of the JAX value relative, each leaf within 2e-5 of its
largest magnitude (``test_torch_colocated_mesh.py``'s).
"""
import json
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import subprocess  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
DRIVERS = ROOT / "tests" / "torch_drivers"
sys.path.insert(0, str(DRIVERS))

import driver_colocated as dcol  # noqa: E402
import driver_context as dctx  # noqa: E402
import driver_pipeline as dpl  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from dist_util import flat  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402

DLOSS, DGNORM, DPARAMS = 1e-5, 1e-3, 1e-4
REL, LEAF_REL = 1e-5, 2e-5
DP_LR, DP_STEPS = 1e-3, 2
#: driver_dp.py's cases: (name, arch, config overrides, mbs, batch, seq)
DP_CASES = [("seq_b1_d4", "qwen1.5-0.5b", {}, 1, 1, 16),
            ("seq_b6_d4", "granite-3-8b", {"num_layers": 2}, 2, 6, 16),
            ("moe_b1_d4", "mixtral-8x22b", {"num_layers": 2}, 1, 1, 16)]
#: the train-step cases of the pipeline and context drivers, (name, arch,
#: overrides, knobs, (batch, seq)), the planted ones not in the oracle
STEP_CASES = dpl.LAYOUT_CASES + dctx.LAYOUT_CASES[4]
ORACLE = [c for c in STEP_CASES if not c[0].endswith("_planted")]
PLANTED = {"rep_b3_d2_planted": "rep_b3_d2", "vp_q_t4_planted": "vp_q_t4"}
#: carve_sections cases: (name, teacher knobs, student knobs, gpu_counts);
#: the last does not factor (5 ranks over the student's dp 2)
CARVE_CASES = [
    ("widen", {}, {"dp": 2}, {"teacher": 2, "student": 6}),
    ("narrow", {"tp": 4}, {"dp": 2, "tp": 2}, {"teacher": 2}),
    ("same", {"dp": 2}, {"dp": 2, "cp": 2}, None),
    ("odd", {}, {"dp": 2}, {"teacher": 3, "student": 5}),
]
ORACLE_PARTS = 3


# --------------------------------------------------------------------------- #
# inputs
# --------------------------------------------------------------------------- #
def _cfg(arch, over):
    return tcfgs.get_reduced(arch).replace(dtype="float32", **over)


def _lm_batch(rng, cfg, gb, s, prefix):
    return {prefix + "tokens": rng.integers(0, cfg.vocab_size, (gb, s))
            .astype(np.int32),
            prefix + "labels": rng.integers(0, cfg.vocab_size, (gb, s))
            .astype(np.int32),
            prefix + "loss_mask": (rng.random((gb, s)) < 0.8)
            .astype(np.float32)}


def _inputs() -> dict:
    out = {}
    for i, (name, arch, over, mbs, gb, s) in enumerate(DP_CASES):
        cfg = _cfg(arch, over)
        out.update(flat(tbuild(cfg, device="cpu", seed=i).param_tree(),
                        f"{name}/params/"))
        rng = np.random.default_rng(10 + i)
        for k in range(DP_STEPS):
            out.update(_lm_batch(rng, cfg, gb, s, f"{name}/batch{k}/"))
    for i, (name, arch, over, _, (gb, s)) in enumerate(STEP_CASES):
        cfg = _cfg(arch, over)
        out.update(flat(tbuild(cfg, device="cpu", seed=0).param_tree(),
                        f"{name}/params/"))
        rng = np.random.default_rng(0)
        out.update(_lm_batch(rng, cfg, gb, s, f"{name}/batch/"))
        if cfg.family == "audio":
            out[f"{name}/batch/frames"] = rng.standard_normal(
                (gb, cfg.frontend_frames, cfg.frontend_dim)).astype(
                np.float32)
    t_cfg, s_cfg = dcol.distill_cfgs()
    out.update(flat(tbuild(t_cfg, device="cpu", seed=0).param_tree(),
                    "distill/params/teacher/"))
    out.update(flat(tbuild(s_cfg, device="cpu", seed=1).param_tree(),
                    "distill/params/student/"))
    out.update(_lm_batch(np.random.default_rng(3), s_cfg, dcol.D1_B,
                         dcol.D_S, "distill_b1/batch/"))
    return out


# --------------------------------------------------------------------------- #
# the JAX oracle
# --------------------------------------------------------------------------- #
def _jax_carve() -> dict:
    """The reference's effective ParallelConfigs and device ranges (or its
    error) of each carve case on 8 virtual devices."""
    import jax
    from repro.configs import get_reduced
    from repro.core.graph import build_distill_graph
    from repro.core.runtime import carve_sections
    from repro.core.types import ParallelConfig
    cfg = get_reduced("qwen1.5-0.5b")
    out = {}
    for name, t, s, counts in CARVE_CASES:
        g = build_distill_graph(cfg, cfg, teacher_parallel=ParallelConfig(
            **t), student_parallel=ParallelConfig(**s))
        try:
            meshes, pars = carve_sections(g, jax.devices(),
                                          gpu_counts=counts)
        except ValueError as e:
            out[name] = str(e)
            continue
        out[name] = {n: [[p.dp, p.tp, p.pp, p.cp],
                         [int(d.id) for d in meshes[n].devices.flat]]
                     for n, p in pars.items()}
    return out


def _jax_data_specs() -> dict:
    """The reference's ``data_shardings`` specs of each train case's
    batch on its section mesh."""
    import jax
    from repro.core.types import ParallelConfig
    from repro.dist import sharding as jshd
    out = {}
    cases = ([(n, dict(dp=4, mbs=m), (b, s)) for n, _, _, m, b, s in DP_CASES]
             + [(c[0], c[3], c[4]) for c in ORACLE])
    for name, knobs, (gb, s) in cases:
        par = ParallelConfig(**knobs)
        mesh = jshd.section_mesh(jax.devices()[:par.devices], par)
        specs = jshd.data_shardings(mesh, {
            k: jax.ShapeDtypeStruct((gb, s), np.int32)
            for k in ("tokens", "labels", "loss_mask")})
        out[name] = {k: [list(e) if isinstance(e, tuple) else e
                         for e in v.spec] for k, v in specs.items()}
    return out


def jax_oracle(in_path: str, out_path: str, part: int, parts: int) -> None:
    """One JAX step a train case (two for driver_dp's) on ``section_mesh``
    of the first ``ParallelConfig.devices`` virtual devices, the
    distillation step at a batch of 1; the cases ``part::parts``.  Part 0
    also carves and writes the batch specs."""
    import functools
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced
    from repro.core.types import ParallelConfig, ShapeConfig
    from repro.dist import sharding as jshd
    from repro.distill.workload import build_colocated_step as jdistill
    from repro.models import transformer as jtf
    from repro.models.common import init_params as jinit
    from repro.models.model import build_model
    from repro.optim import adamw, schedules
    from repro.train import step as jstep
    from test_torch_compound import _flatten, _unflatten, save_tree

    assert len(jax.devices()) == 8, jax.devices()
    arrays = np.load(in_path)
    out = {}

    def given(prefix, tree):
        dtypes = _flatten(jax.tree_util.tree_map(
            lambda x: np.asarray(x).dtype, tree), prefix)
        return _unflatten({k: arrays[k].astype(dt)
                           for k, dt in dtypes.items()}, prefix)

    def batch(prefix):
        return {k[len(prefix):]: jnp.asarray(arrays[k]) for k in arrays.files
                if k.startswith(prefix)}

    def train(name, arch, over, knobs, gb, s, steps, lr_fn):
        cfg = get_reduced(arch).replace(dtype="float32", **over)
        model = build_model(cfg, impl="ref")
        params = given(name + "/params", model.init(jax.random.PRNGKey(0)))
        par = ParallelConfig(**knobs)
        mesh = jshd.section_mesh(jax.devices()[:par.devices], par)
        step, sh = jstep.build_train_step(
            model, mesh, par, ShapeConfig("t", "train", s, gb),
            lr_schedule=lr_fn, opt_cfg=adamw.AdamWConfig(eps=1e-3))
        with mesh:
            p = jax.device_put(params, sh["params"])
            o = jax.device_put(adamw.init(params), sh["opt"])
            mets = []
            for i in range(steps):
                b = batch(f"{name}/batch{i}/" if steps > 1
                          else f"{name}/batch/")
                p, o, met = step(p, o, b, jnp.int32(i))
                mets.append([float(met["loss"]), float(met["grad_norm"])])
            p = jax.device_get(p)
        out[f"{name}/metrics"] = np.asarray(mets)
        save_tree(out, p, f"{name}/params")

    jobs = [functools.partial(
        train, n, a, o, dict(dp=4, mbs=m), b, s, DP_STEPS,
        functools.partial(schedules.warmup_cosine, peak_lr=DP_LR,
                          warmup_steps=1, total_steps=DP_STEPS))
        for n, a, o, m, b, s in DP_CASES]
    jobs += [functools.partial(
        train, n, a, o, k, b, s, 1,
        functools.partial(schedules.constant, peak_lr=1e-3))
        for n, a, o, k, (b, s) in ORACLE]

    def distill():
        kw = dict(dtype="float32", vocab_size=512)
        t_cfg = get_reduced("qwen2.5-32b").replace(**kw)
        s_cfg = get_reduced("qwen1.5-0.5b").replace(**kw)
        par = ParallelConfig(dp=2)
        mesh = jshd.section_mesh(jax.devices()[:2], par)
        step, sh = jdistill(
            t_cfg, s_cfg, mesh, ShapeConfig("d", "train", dcol.D_S,
                                            dcol.D1_B), par, impl="ref",
            lr_schedule=lambda s: schedules.constant(s, peak_lr=dcol.LR),
            opt_cfg=adamw.AdamWConfig(eps=dcol.OPT.eps))
        key = jax.random.PRNGKey(0)
        pt = given("distill/params/teacher", jinit(jtf.lm_specs(t_cfg), key))
        ps = given("distill/params/student", jinit(jtf.lm_specs(s_cfg), key))
        with mesh:
            new, _, met = step(jax.device_put(ps, sh["student"]),
                               jax.device_put(adamw.init(ps), sh["opt"]),
                               jax.device_put(pt, sh["teacher"]),
                               batch("distill_b1/batch/"), jnp.int32(0))
        out["distill_b1/metrics"] = np.asarray(
            [[float(met["loss"]), float(met["grad_norm"])]])
        save_tree(out, jax.device_get(new), "distill_b1/params")

    jobs.append(distill)
    for job in jobs[part::parts]:
        job()
    if part == 0:
        out["carve"] = np.asarray(json.dumps(_jax_carve()))
        out["data_specs"] = np.asarray(json.dumps(_jax_data_specs()))
    np.savez(out_path, **out)


# --------------------------------------------------------------------------- #
# the port's carving on fake process groups
# --------------------------------------------------------------------------- #
def port_carve(out_path: str) -> None:
    """Each carve case on a fake world of 8, and a ``MaestroRuntime``
    sized by the planner's H100 plan of ``self_distill_compound`` on a
    fake world of its ranks."""
    from repro_torch.configs.compound import self_distill_compound
    from repro_torch.core.graph import build_distill_graph
    from repro_torch.core.planner import plan
    from repro_torch.core.runtime import MaestroRuntime, carve_sections
    from repro_torch.core.types import H100, ParallelConfig
    from repro_torch.launch.dryrun import fake_world
    cfg = tcfgs.get_reduced("qwen1.5-0.5b")
    fake_world(8, 0)
    out = {}
    for name, t, s, counts in CARVE_CASES:
        g = build_distill_graph(cfg, cfg, teacher_parallel=ParallelConfig(
            **t), student_parallel=ParallelConfig(**s))
        try:
            meshes, pars = carve_sections(g, ranks=range(8),
                                          gpu_counts=counts)
        except ValueError as e:
            out[name] = str(e)
            continue
        out[name] = {n: [[p.dp, p.tp, p.pp, p.cp],
                         [int(r) for r in meshes[n].mesh.flatten()]]
                     for n, p in pars.items()}
    g = self_distill_compound()
    sizes = plan(g, critical_gpus=8, seq_len=4096, global_batch=256,
                 hw=H100)
    counts = {name: sp.n_gpus for name, sp in sizes.sections.items()}
    fake_world(sum(counts.values()), 0)
    with MaestroRuntime(g, ranks=range(sum(counts.values())),
                        gpu_counts=counts) as rt:
        out["planned"] = {
            "counts": counts, "local": rt.local_sections,
            "parallel": {n: [rt.parallel(n).dp, rt.parallel(n).tp,
                             rt.parallel(n).devices] for n in counts},
            "mesh": {n: shd.mesh_shape(rt.mesh(n)) for n in counts}}
    Path(out_path).write_text(json.dumps(out))


# --------------------------------------------------------------------------- #
# the run
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("layout")
    np.savez(tmp / "in.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(DRIVERS)]))
    env.pop("XLA_FLAGS", None)
    jenv = dict(env, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), str(DRIVERS)]))
    procs = {f"jax{i}": [sys.executable, __file__, "--jax-oracle",
                         str(tmp / "in.npz"), str(tmp / f"jax{i}.npz"),
                         str(i), str(ORACLE_PARTS)]
             for i in range(ORACLE_PARTS)}
    procs["carve"] = [sys.executable, __file__, "--port-carve",
                      str(tmp / "carve.json")]
    cases = [dict(name=n, arch=a, over=dict(o, dtype="float32"), mbs=m,
                  zero=True, steps=DP_STEPS, batch=b, seq=s, lr=DP_LR,
                  spec_dtypes=True) for n, a, o, m, b, s in DP_CASES]
    (tmp / "dp.json").write_text(json.dumps(cases))
    procs["dp"] = [sys.executable, str(DRIVERS / "driver_dp.py"), "4",
                   str(tmp / "dp.json"), str(tmp / "in.npz"),
                   str(tmp / "dp.npz")]
    procs["pipeline"] = [sys.executable, str(DRIVERS / "driver_pipeline.py"),
                         "layout", "4", str(tmp / "in.npz"),
                         str(tmp / "pipeline.npz")]
    procs["context"] = [sys.executable, str(DRIVERS / "driver_context.py"),
                        "layout", "4", str(tmp / "in.npz"),
                        str(tmp / "context.npz")]
    procs["colocated"] = [sys.executable, str(DRIVERS / "driver_colocated.py"),
                          "distill_b1", "2", str(tmp / "in.npz"),
                          str(tmp / "colocated")]
    running = {k: subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=jenv if k.startswith("jax") else env)
        for k, cmd in procs.items()}
    try:
        done = {k: p.communicate(timeout=600) for k, p in running.items()}
    finally:
        for p in running.values():
            p.kill()
    for k, (so, se) in done.items():
        assert running[k].returncode == 0, (k, so[-3000:] + se[-6000:])
    jx = {}
    for i in range(ORACLE_PARTS):
        jx.update(np.load(tmp / f"jax{i}.npz"))
    got = {}
    for f in ("dp.npz", "pipeline.npz", "context.npz", "colocated.0.npz"):
        got.update(np.load(tmp / f))
    return got, jx, json.loads((tmp / "carve.json").read_text())


def _params_gap(got, jx, name, ref) -> float:
    keys = [k[len(ref) + 8:] for k in jx if k.startswith(f"{ref}/params/")
            and not k.startswith("dtype:")]
    assert keys and {k[len(name) + 8:] for k in got if k.startswith(
        f"{name}/params/")} == set(keys)
    return max(float(np.abs(got[f"{name}/params/{k}"]
                            - jx[f"{ref}/params/{k}"]).max()) for k in keys)


def _gaps(got, jx, name, ref=None) -> tuple:
    ref = ref or name
    loss, gnorm = jx[f"{ref}/metrics"][-1]
    return (abs(float(np.asarray(got[f"{name}/loss"]).ravel()[-1]) - loss),
            abs(float(np.asarray(got[f"{name}/grad_norm"]).ravel()[-1])
                - gnorm), _params_gap(got, jx, name, ref))


@pytest.mark.parametrize("name", [c[0] for c in DP_CASES]
                         + [c[0] for c in ORACLE])
def test_layout_matches_jax_section_mesh_step(run, name):
    got, jx, _ = run
    dloss, dgnorm, worst = _gaps(got, jx, name)
    assert dloss < DLOSS, dloss
    assert dgnorm < DGNORM, dgnorm
    assert worst < DPARAMS, worst


@pytest.mark.parametrize("name", [c[0] for c in DP_CASES])
def test_dp_steps_match_jax_step_by_step(run, name):
    """Both steps of driver_dp's cases: the second one moves the
    parameters (the first step's warmup lr is 0)."""
    got, jx, _ = run
    want = jx[f"{name}/metrics"]
    np.testing.assert_allclose(got[f"{name}/loss"], want[:, 0], atol=DLOSS)
    np.testing.assert_allclose(got[f"{name}/grad_norm"], want[:, 1],
                               atol=DGNORM)


def test_distill_step_at_one_row_matches_jax(run):
    got, jx, _ = run
    loss, gnorm = jx["distill_b1/metrics"][0]
    assert abs(float(got["distill_b1/loss"][0]) - loss) <= REL * abs(loss)
    assert abs(float(got["distill_b1/grad_norm"][0]) - gnorm) <= \
        REL * abs(gnorm)
    keys = [k for k in jx if k.startswith("distill_b1/params/")]
    assert keys
    for k in keys:
        scale = max(float(np.abs(jx[k]).max()), 1e-30)
        assert float(np.abs(got[k] - jx[k]).max()) <= LEAF_REL * scale, k


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_planted_fault_misses_the_bounds(run, name):
    got, jx, _ = run
    g = _gaps(got, jx, name, PLANTED[name])
    assert not (g[0] < DLOSS and g[1] < DGNORM and g[2] < DPARAMS), g


@pytest.mark.parametrize("name", ["vp_q_t4", "vp_q_cp2t2", "vp_q_t4_planted"])
def test_no_rank_forms_logits_wider_than_its_vocab_slice(run, name):
    got, _, _ = run
    tp = dict((c[0], c[3]) for c in STEP_CASES)[name]["tp"]
    cfg = _cfg(*[(c[1], c[2]) for c in STEP_CASES if c[0] == name][0])
    assert int(got[f"{name}/logit_width"][0]) == cfg.padded_vocab // tp


def test_carving_matches_the_reference(run):
    _, jx, port = run
    ref = json.loads(str(jx["carve"]))
    for name, *_ in CARVE_CASES:
        if isinstance(ref[name], str):
            assert isinstance(port[name], str) and "do not factor" in \
                port[name] and "do not factor" in ref[name], (port, ref)
        else:
            assert port[name] == ref[name], (name, port[name], ref[name])
    assert ref["widen"]["student"][0] == [2, 3, 1, 1]


def test_planner_sized_runtime(run):
    """The planner's counts size each section's mesh: every section's
    ``tp`` is its count over dp pp cp (all 1 in the graph)."""
    _, _, port = run
    p = port["planned"]
    assert p["local"] == ["teacher"]
    for name, n in p["counts"].items():
        assert p["parallel"][name] == [1, n, n]
        assert p["mesh"][name] == {"data": 1, "pipe": 1, "seq": 1,
                                   "model": n}


def test_batch_specs_match_the_reference(run):
    """Each train case's batch leaves: the port's ``DataLayout`` specs (on
    its mesh's sizes) against the reference's ``data_shardings``."""
    from repro_torch.core.types import ParallelConfig
    from repro_torch.train.step import batch_leaf_spec
    _, jx, _ = run
    ref = json.loads(str(jx["data_specs"]))
    cases = ([(n, dict(dp=4, mbs=m), (b, s)) for n, _, _, m, b, s in DP_CASES]
             + [(c[0], c[3], c[4]) for c in ORACLE])
    for name, knobs, (gb, s) in cases:
        par = ParallelConfig(**knobs)
        sizes = {"data": par.dp, "pipe": par.pp, "seq": par.cp,
                 "model": par.tp}
        kind = shd.batch_layout(sizes, gb, s)
        for key, want in ref[name].items():
            got = [list(e) if isinstance(e, tuple) else e
                   for e in batch_leaf_spec(sizes, kind, key, (gb, s))]
            assert got + [None] * (len(want) - len(got)) == want, (
                name, key, got, want)


# --------------------------------------------------------------------------- #
# in the process
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("sizes,batch,seq,kind", [
    ({"data": 4, "pipe": 1, "seq": 1, "model": 1}, 8, 16, "rows"),
    ({"data": 4, "pipe": 1, "seq": 1, "model": 1}, 1, 16, "sequence"),
    ({"data": 4, "pipe": 1, "seq": 1, "model": 1}, 6, 16, "sequence"),
    ({"data": 2, "pipe": 1, "seq": 1, "model": 2}, 3, 15, "replicated"),
    ({"data": 2, "pipe": 1, "seq": 2, "model": 1}, 1, 6, "sequence"),
    ({"pod": 2, "data": 2, "model": 2}, 2, 12, "sequence"),
    ({"pod": 2, "data": 2, "model": 2}, 4, 12, "rows"),
])
def test_batch_layout_is_the_references(sizes, batch, seq, kind):
    from repro.dist import sharding as jshd
    mesh = types.SimpleNamespace(axis_names=tuple(sizes), shape=sizes)
    want = tuple(jshd.batch_spec(mesh, batch, seq))
    assert tuple(shd.batch_spec(sizes, batch, seq)) == want
    assert shd.batch_layout(sizes, batch, seq) == kind


def test_vocab_rows_and_slice_logits_mask_the_padding():
    """``vocab_rows`` sums to the whole lookup over the slices, and each
    slice's logits mask the padded rows past ``vocab_size``."""
    cfg = _cfg("qwen1.5-0.5b", dict(vocab_size=509, vocab_pad=3))
    table = torch.randn(cfg.padded_vocab, 8)
    tok = torch.randint(0, cfg.vocab_size, (2, 5))
    vs = cfg.padded_vocab // 4
    parts = [ttf.vocab_rows(table[r * vs:(r + 1) * vs], tok, r * vs)
             for r in range(4)]
    assert torch.equal(sum(parts), table[tok])
    h = torch.randn(2, 5, 8)
    last = ttf.unembed({"embed": table[3 * vs:]}, cfg, h, offset=3 * vs)
    assert bool((last[..., -3:] == -1e30).all())
    assert bool((last[..., :-3] > -1e29).all())


def test_gpu_counts_size_device_carved_sections():
    """Without ranks, a count of 1 narrows a section's ``tp`` to 1, so it
    carves onto one device; a count of 2 needs a mesh and raises, and one
    that does not factor into dp pp cp raises the reference's error."""
    from repro_torch.core.graph import build_distill_graph
    from repro_torch.core.runtime import MaestroRuntime, carve_sections
    from repro_torch.core.types import ParallelConfig
    cfg = tcfgs.get_reduced("qwen1.5-0.5b")
    g = build_distill_graph(cfg, cfg,
                            teacher_parallel=ParallelConfig(tp=2))
    with pytest.raises(NotImplementedError, match="section 'teacher'"):
        carve_sections(g, ["cpu", "cpu"])
    devs = carve_sections(g, ["cpu", "cpu"], gpu_counts={"teacher": 1})
    assert set(devs) == {"teacher", "student"}
    with MaestroRuntime(g, ["cpu", "cpu"], gpu_counts={"teacher": 1}) as rt:
        assert rt.parallel("teacher").tp == 1
        assert rt.parallel("student") == g.sections["student"].parallel
    wide = build_distill_graph(cfg, cfg, fanout=2,
                               student_parallel=ParallelConfig(dp=2))
    with pytest.raises(ValueError, match="do not factor"):
        carve_sections(wide, ["cpu"] * 4, gpu_counts={"student": 3})


if __name__ == "__main__" and sys.argv[1] == "--jax-oracle":
    jax_oracle(sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5]))
elif __name__ == "__main__" and sys.argv[1] == "--port-carve":
    port_carve(sys.argv[2])
