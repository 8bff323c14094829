"""The port's data-parallel train step (FSDP parameter blocks, ZeRO
optimizer-state blocks) against the JAX package, on the CPU.

(a) At world sizes 2 and 4 (spawned gloo ranks,
    ``tests/torch_drivers/driver_dp.py``): the plain (replicated optimizer
    state) and ZeRO steps on the reduced qwen1.5-0.5b config, pixtral-12b's
    reduced VLM with image rows on some ranks only (uneven loss masks), and
    mamba2-130m's reduced config, float32, 3 steps.  Losses, grad norms,
    the gathered parameters and master weights must match the JAX
    single-device step on the same global batches, micro-batched in the
    reference's shard-major layout (``repro.train.step._split_microbatches``),
    within ``TOL``: the reference's GSPMD step is that global computation.
(b) World size 1 on gloo: the sharded step, through ``build_train_step``
    and through ``launch.train.run(..., mesh=)``, equals the port's
    single-device step bit for bit.
(c) The refusals: pp x cp, compression with a model axis, several data
    axes or a
    batch that does not divide, a mesh that disagrees with its
    ``ParallelConfig``; the launcher's ``--data`` without ``torchrun`` and
    ``--model``.  And the ``torchrun`` launch itself on 2 gloo ranks.

The compressed steps are in ``tests/test_torch_dp_compressed.py``.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.train import step as jstep  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
import torch.distributed as dist  # noqa: E402
from repro_torch.core.types import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.common import flatten_with_path  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DRIVER = ROOT / "tests" / "torch_drivers" / "driver_dp.py"
# tests/test_torch_train.py's tolerance for three steps against JAX: the
# two frameworks sum products and reductions in different orders
TOL = dict(atol=2e-4, rtol=2e-4)
OPT_EPS = 1e-3            # both sides; tests/test_torch_train.py says why
B, S, STEPS, LR = 8, 16, 3, 1e-2
WORLDS = (2, 4)
# ``rows``: a micro-batch's rows over all ranks (world x mbs); the same at
# every world size, so each JAX oracle compiles once a case
CASES = [
    dict(name="qwen_plain", arch="qwen1.5-0.5b", over={"dtype": "float32"},
         rows=8, zero=False),
    dict(name="qwen_zero", arch="qwen1.5-0.5b", over={"dtype": "float32"},
         rows=4, zero=True),
    dict(name="vlm_zero", arch="pixtral-12b",
         over={"dtype": "float32", "vocab_size": 128,
               "max_image_tokens": 4}, rows=4, zero=True),
    dict(name="mamba_zero", arch="mamba2-130m", over={"dtype": "float32"},
         rows=4, zero=True),
]


def _mbs(case, world):
    return case["rows"] // world


def _params(case, seed):
    """The port's seeded init (the JAX package's tree layout) plus seeded
    noise, as numpy."""
    tcfg = tcfgs.get_reduced(case["arch"]).replace(**case["over"])
    rng = np.random.default_rng(seed)
    init = tbuild(tcfg, device="cpu", seed=seed).param_tree()
    return _tree_map(
        lambda x: (x.detach().float().numpy()
                   + 0.05 * rng.standard_normal(x.shape, dtype=np.float32)),
        init)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def _batch(case, rng):
    """A global batch whose loss masks differ by row: random holes, and in
    the VLM case the first half of the rows carry an image in their
    leading K positions, which take no loss, and the rest none."""
    cfg = jcfgs.get_reduced(case["arch"]).replace(**case["over"])
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)),
         "loss_mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if cfg.family == "vlm":
        K = cfg.max_image_tokens
        has = np.arange(B) < B // 2
        b["loss_mask"][has, :K] = 0.0
        b["image_pos"] = np.tile(np.arange(K), (B, 1))
        b["image_valid"] = np.tile(has[:, None], (1, K)).astype(np.int32)
        b["image_embeds"] = (rng.standard_normal(
            (B, K, cfg.vision_dim), dtype=np.float32) * has[:, None, None])
    return b


def _inputs():
    arrays, batches, params = {}, {}, {}
    for ci, case in enumerate(CASES):
        params[case["name"]] = _params(case, ci)
        for k, v in _flat(params[case["name"]]).items():
            arrays[f"{case['name']}/params/{k}"] = v
        rng = np.random.default_rng(100 + ci)
        batches[case["name"]] = [_batch(case, rng) for _ in range(STEPS)]
        for i, b in enumerate(batches[case["name"]]):
            for k, v in b.items():
                arrays[f"{case['name']}/batch{i}/{k}"] = v
    return arrays, params, batches


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _grad_fn(arch, over):
    jm = jbuild(jcfgs.get_reduced(arch).replace(**dict(over)))
    return jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b),
                                      has_aux=True))


def _jax_trajectory(case, np_params, batches, world):
    """The JAX single-device step on the global batches, micro-batched in
    the reference's shard-major layout for ``world`` data shards."""
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    opt = jadamw.init(params)
    n_micro = max(B // (world * _mbs(case, world)), 1)
    grad_fn = _grad_fn(case["arch"], tuple(sorted(case["over"].items())))
    losses, gnorms = [], []
    for i, b in enumerate(batches):
        jb = {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else v.dtype)
              for k, v in b.items()}
        parts = jstep._split_microbatches(jb, n_micro, world)
        g_sum, l_sum = None, 0.0
        for j in range(n_micro):
            (loss, _), g = grad_fn(params, jax.tree_util.tree_map(
                lambda x: x[j], parts))
            g_sum = g if g_sum is None else jax.tree_util.tree_map(
                jnp.add, g_sum, g)
            l_sum = l_sum + loss
        grads = jax.tree_util.tree_map(lambda g: g / n_micro, g_sum)
        lr = jsched.warmup_cosine(jnp.int32(i), peak_lr=LR, warmup_steps=1,
                                  total_steps=STEPS)
        params, opt, gn = jadamw.update(
            grads, opt, lr, jadamw.AdamWConfig(eps=OPT_EPS))
        losses.append(float(l_sum / n_micro))
        gnorms.append(float(gn))
    return {"loss": np.array(losses), "grad_norm": np.array(gnorms),
            "params": _flat(params), "master": _flat(opt.master)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per world size: driver_dp.py's output and the JAX oracle of each
    case."""
    tmp = tmp_path_factory.mktemp("dp")
    arrays, params, batches = _inputs()
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for world in WORLDS:             # the drivers run while JAX computes
        cases = [dict(c, mbs=_mbs(c, world), batch=B, seq=S, steps=STEPS,
                      lr=LR) for c in CASES]
        (tmp / f"cases{world}.json").write_text(json.dumps(cases))
        procs[world] = subprocess.Popen(
            [sys.executable, str(DRIVER), str(world),
             str(tmp / f"cases{world}.json"), str(tmp / "in.npz"),
             str(tmp / f"out{world}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
    try:
        want = {(world, c["name"]): _jax_trajectory(
            c, params[c["name"]], batches[c["name"]], world)
            for world in WORLDS for c in CASES}
        outs = {world: p.communicate(timeout=600)
                for world, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    out = {}
    for world, (stdout, stderr) in outs.items():
        assert "DRIVER_OK dp" in stdout, stdout + stderr
        got = np.load(tmp / f"out{world}.npz")
        for case in CASES:
            name = case["name"]
            out[world, name] = ({k[len(name) + 1:]: got[k] for k in got.files
                                 if k.startswith(name + "/")},
                                want[world, name])
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_sharded_step_matches_jax(runs, world, name):
    got, want = runs[world, name]
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], **TOL)
    for what in ("params", "master"):
        for path, w in want[what].items():
            np.testing.assert_allclose(got[f"{what}/{path}"], w,
                                       err_msg=f"{what}/{path}", **TOL)


def test_uneven_masks_reach_the_ranks():
    """The VLM case's rows differ in loss tokens between ranks at both
    world sizes, so a mean of per-rank means would differ from the
    reference's global mean."""
    case = CASES[2]
    b = _batch(case, np.random.default_rng(0))
    for world in WORLDS:
        per_rank = b["loss_mask"].reshape(world, -1).sum(axis=1)
        assert len(set(per_rank.tolist())) > 1, per_rank


# --------------------------------------------------------------------------- #
# (b) world size 1 against the single-device step, bit for bit
# --------------------------------------------------------------------------- #
@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo process group in this process, deterministic
    kernels on one thread (a CPU's float32 blocking may otherwise change
    with the machine's load, ROADMAP.md C5), all undone after."""
    was, threads = torch.are_deterministic_algorithms_enabled(), \
        torch.get_num_threads()
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield shd.section_mesh([0], ParallelConfig())
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)
        torch.use_deterministic_algorithms(was)


def _state(params, opt):
    return flatten_with_path({"params": params, "opt": opt})


def _bitwise_diff(a, b):
    fa, fb = _state(*a), _state(*b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    return [p for (p, x), (_, y) in zip(fa, fb)
            if not torch.equal(x.detach(), y.detach())]


@pytest.mark.parametrize("zero,mbs", [(True, 2), (False, 4)])
def test_world_size_1_equals_single_device_bitwise(world1, zero, mbs):
    cfg = tcfgs.get_reduced("qwen1.5-0.5b").replace(dtype="float32")
    shape = ShapeConfig("t", "train", S, 4)
    par = ParallelConfig(mbs=mbs, zero_opt=zero)
    kw = dict(lr_schedule=functools.partial(tsched.constant, peak_lr=1e-2),
              opt_cfg=tadamw.AdamWConfig(eps=OPT_EPS))
    rng = np.random.default_rng(3)
    batches = [{k: torch.from_numpy(v) for k, v in _batch(
        CASES[0], rng).items()} for _ in range(3)]
    batches = [{k: v[:4] for k, v in b.items()} for b in batches]
    out = {}
    for sharded in (False, True):
        tm = tbuild(cfg, device="cpu", seed=0)
        step = tstep.build_train_step(tm, par, shape,
                                      mesh=world1 if sharded else None, **kw)
        params = tm.param_tree()
        if sharded:
            sh = step.shardings
            opt = tadamw.init(shd.shard_tree(params, sh["opt"].master,
                                             world1))
            params = shd.shard_tree(params, sh["params"], world1)
        else:
            opt = tadamw.init(params)
        losses = []
        for i, b in enumerate(batches):
            params, opt, met = step(params, opt, b, i)
            losses.append(float(met["loss"]))
        out[sharded] = (losses, params, opt)
    assert out[True][0] == out[False][0]
    assert _bitwise_diff(out[True][1:], out[False][1:]) == []


def test_world_size_1_launcher_run_equals_plain_bitwise(world1):
    kw = dict(reduced=True, steps=3, batch=4, seq=16, mbs=2,
              dtype="float32", device="cpu", seed=0, log_every=100)
    a = tlaunch.run("qwen1.5-0.5b", **kw)
    b = tlaunch.run("qwen1.5-0.5b", mesh=world1, **kw)
    assert a.result.losses == b.result.losses
    assert a.flash_launches == b.flash_launches
    assert _bitwise_diff((a.result.params, a.result.opt_state),
                         (b.result.params, b.result.opt_state)) == []


# --------------------------------------------------------------------------- #
# (c) refusals, and the torchrun launch
# --------------------------------------------------------------------------- #
def _mesh(**sizes):
    base = {"data": 1, "pipe": 1, "seq": 1, "model": 1}
    base.update(sizes)
    return base


def _model(name="granite-3-8b"):
    return tbuild(tcfgs.get_reduced(name).replace(dtype="float32"),
                  device="cpu")


@pytest.mark.parametrize("knob,axes,item", [
    (dict(tp=2, cp=2), dict(model=2, seq=2), None),
    (dict(pp=2, cp=2), dict(pipe=2, seq=2), "pp x cp composition"),
    (dict(cp=2), dict(seq=2), None),
    (dict(tp=2, grad_compress="int8"), dict(model=2), "dp-only mesh")])
def test_other_regimes_raise_naming_their_item(knob, axes, item):
    # the pipe and model axes' regimes run (tests/test_torch_pp_step.py,
    # test_torch_tp.py) and so does the seq axis's (test_torch_context*.py),
    # with a model axis too and for the vlm family's image splice (item
    # None: the step's checks give the cp regime); what stays refused: pp
    # x cp (as in the reference) and a compressed all-reduce outside a
    # dp-only mesh
    model = _model("pixtral-12b") if knob == dict(cp=2) else _model()
    if item is None:
        regime, _, _ = tstep._check_sharded(
            model.cfg, ParallelConfig(**knob),
            ShapeConfig("t", "train", 8, 4), _mesh(**axes))
        assert regime == "cp"
        return
    with pytest.raises(NotImplementedError, match=item):
        tstep.build_train_step(model, ParallelConfig(**knob),
                               ShapeConfig("t", "train", 8, 4),
                               mesh=_mesh(**axes))


def test_pp_and_cp_together_raise():
    with pytest.raises(NotImplementedError,
                       match="pp x cp composition is not supported"):
        tstep.parallel_regime(_mesh(pipe=2, seq=2), ParallelConfig(pp=2,
                                                                   cp=2))


@pytest.mark.parametrize("name", ["mixtral-8x22b", "jamba-v0.1-52b"])
def test_moe_and_hybrid_under_dp_raise(name):
    # MoE and hybrid train at dp > 1 now (their router statistics are
    # averaged over the data ranks: tests/test_torch_tp.py), and like
    # every family at cp x tp: the step's checks give the cp regime
    regime, dp_ax, dp_total = tstep._check_sharded(
        _model(name).cfg, ParallelConfig(dp=2, cp=2, tp=2),
        ShapeConfig("t", "train", 8, 4), _mesh(data=2, seq=2, model=2))
    assert (regime, dp_ax, dp_total) == ("cp", ("data",), 2)


@pytest.mark.parametrize("mesh,par,match", [
    (_mesh(data=4), ParallelConfig(dp=2), "dp=2"),
    (_mesh(data=2), ParallelConfig(dp=2, pp=2), "pp=2"),
    (_mesh(data=2, seq=2), ParallelConfig(dp=2), "cp=1"),
    (_mesh(data=2), ParallelConfig(dp=2, tp=4), "tp=4")])
def test_mesh_that_disagrees_with_its_config_raises(mesh, par, match):
    with pytest.raises(ValueError, match=match):
        tstep.parallel_regime(mesh, par)


def test_compression_refusals():
    shape = ShapeConfig("t", "train", 8, 6)
    with pytest.raises(NotImplementedError, match="divide"):
        tstep.build_train_step(_model(), ParallelConfig(
            dp=4, grad_compress="int8"), shape, mesh=_mesh(data=4))
    with pytest.raises(NotImplementedError, match="single data axis"):
        tstep.build_train_step(
            _model(), ParallelConfig(dp=4, grad_compress="bf16"),
            ShapeConfig("t", "train", 8, 8),
            mesh={"pod": 2, "data": 2, "pipe": 1, "seq": 1, "model": 1})
    with pytest.raises(ValueError, match="fp4"):
        tstep.build_train_step(_model(), ParallelConfig(
            dp=2, grad_compress="fp4"), ShapeConfig("t", "train", 8, 8),
            mesh=_mesh(data=2))


def test_single_device_step_names_the_mesh_for_dp():
    with pytest.raises(NotImplementedError, match="mesh=.*A6.1"):
        tstep.build_train_step(_model(), ParallelConfig(dp=2),
                               ShapeConfig("t", "train", 8, 4))


def test_launcher_refusals():
    base = ["--reduced", "--arch", "qwen1.5-0.5b", "--device", "cpu"]
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        tlaunch.main(base + ["--data", "2"])
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        tlaunch.main(base + ["--model", "2"])


def test_torchrun_launch_on_two_gloo_ranks(tmp_path):
    """``torchrun`` (standalone rendezvous on a free local port) starts
    two ranks of the launcher; rank 0 alone prints, and a checkpoint of the
    sharded run restores on one device with the full shapes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--data", "2", "--device", "cpu", "--arch", "qwen1.5-0.5b",
         "--reduced", "--steps", "3", "--batch", "4", "--seq", "16",
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("done: 3 steps") == 1, proc.stdout
    assert "mesh={'data': 2, 'pipe': 1, 'seq': 1, 'model': 1}" in proc.stdout
    from repro_torch.checkpoint.checkpointer import Checkpointer
    ck = Checkpointer(tmp_path)
    assert ck.all_steps() == [2, 3]
    cfg = tcfgs.get_reduced("qwen1.5-0.5b")
    tm = tbuild(cfg, device="cpu")
    target = {"params": tm.param_tree(), "opt": tadamw.init(tm.param_tree())}
    state = ck.restore(3, target)
    assert int(state["opt"].step) == 3
    for (p, x), (_, y) in zip(flatten_with_path(state),
                              flatten_with_path(target)):
        assert x.shape == y.shape, p
