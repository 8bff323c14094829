"""Helpers of the sharded-step tests (``tests/test_torch_pp_step.py``,
``test_torch_tp.py``): one train step a case on spawned gloo ranks
(``tests/torch_drivers/driver_pipeline.py``), the JAX package's
``build_train_step`` on ``section_mesh`` as the oracle, and the reference
driver's bounds."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DRIVERS = ROOT / "tests" / "torch_drivers"
sys.path.insert(0, str(DRIVERS))

import driver_pipeline as dpl  # noqa: E402
from dist_util import flat  # noqa: E402

WORLD = 8
# tests/drivers/driver_train_step_dist.py:86-91
DLOSS, DGNORM, DPARAMS = 1e-5, 1e-3, 1e-4


def jax_steps(cases, in_path: str, out_path: str) -> None:
    """One JAX ``build_train_step`` step a case on ``section_mesh`` of the
    first ``ParallelConfig.devices`` virtual devices (Auto axes), with the
    driver's AdamW (eps 1e-3, constant lr 1e-3)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced
    from repro.core.types import ParallelConfig, ShapeConfig
    from repro.dist import sharding as jshd
    from repro.models.model import build_model
    from repro.optim import adamw, schedules
    from repro.train import step as jstep
    from test_torch_compound import _flatten, _unflatten, save_tree

    assert len(jax.devices()) == 8, jax.devices()
    arrays = np.load(in_path)
    out = {}
    for name, arch, over, knobs in cases:
        cfg = get_reduced(arch).replace(dtype="float32", **over)
        model = build_model(cfg, impl="ref")
        dtypes = _flatten(jax.tree_util.tree_map(
            lambda x: np.asarray(x).dtype,
            model.init(jax.random.PRNGKey(0))), name + "/params")
        params = _unflatten({k: arrays[k].astype(dt)
                             for k, dt in dtypes.items()}, name + "/params")
        par = ParallelConfig(**knobs)
        mesh = jshd.section_mesh(jax.devices()[:par.devices], par)
        step, sh = jstep.build_train_step(
            model, mesh, par, ShapeConfig("t", "train", dpl.STEP_S,
                                          dpl.STEP_GB),
            lr_schedule=lambda s: schedules.constant(s, peak_lr=1e-3),
            opt_cfg=adamw.AdamWConfig(eps=1e-3))
        batch = {k[len(name) + 7:]: jnp.asarray(arrays[k])
                 for k in arrays.files if k.startswith(f"{name}/batch/")}
        with mesh:
            p = jax.device_put(params, sh["params"])
            o = jax.device_put(adamw.init(params), sh["opt"])
            p, _, met = step(p, o, batch, jnp.int32(0))
            p = jax.device_get(p)
        out[f"{name}/metrics"] = np.array([float(met["loss"]),
                                           float(met["grad_norm"])])
        save_tree(out, p, f"{name}/params")
    np.savez(out_path, **out)


def run(case: str, cases, oracle_cases, test_file: str, tmp: Path,
        parts: int = 1):
    """The driver's ``case`` on :data:`WORLD` ranks and the JAX oracle of
    ``oracle_cases`` (``python TEST_FILE --jax-oracle IN OUT PART PARTS``,
    ``parts`` processes), run at once -> (port npz, JAX arrays)."""
    import repro_torch.configs as tcfgs
    from repro_torch.models.model import build_model
    inputs = {}
    for name, arch, over, _ in cases:
        cfg = tcfgs.get_reduced(arch).replace(dtype="float32", **over)
        inputs.update(flat(build_model(cfg, device="cpu", seed=0)
                           .param_tree(), f"{name}/params/"))
        rng = np.random.default_rng(0)
        shape = (dpl.STEP_GB, dpl.STEP_S)
        for k in ("tokens", "labels"):
            inputs[f"{name}/batch/{k}"] = rng.integers(
                0, cfg.vocab_size, shape).astype(np.int32)
        inputs[f"{name}/batch/loss_mask"] = (
            rng.random(shape) < 0.8).astype(np.float32)
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(DRIVERS)]))
    env.pop("XLA_FLAGS", None)
    jenv = dict(env, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), str(DRIVERS)]))
    oracles = [subprocess.Popen(
        [sys.executable, test_file, "--jax-oracle", str(tmp / "in.npz"),
         str(tmp / f"jax{i}.npz"), str(i), str(parts)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=jenv)
        for i in range(parts)]
    proc = subprocess.run(
        [sys.executable, str(DRIVERS / "driver_pipeline.py"), case,
         str(WORLD), str(tmp / "in.npz"), str(tmp / "out.npz")],
        capture_output=True, text=True, env=env, timeout=480)
    assert proc.returncode == 0 and f"DRIVER_OK pipeline {case}" in \
        proc.stdout, proc.stdout[-3000:] + proc.stderr[-6000:]
    jx = {}
    for i, oracle in enumerate(oracles):
        out, err = oracle.communicate(timeout=600)
        assert oracle.returncode == 0, out[-3000:] + err[-6000:]
        jx.update(np.load(tmp / f"jax{i}.npz"))
    return np.load(tmp / "out.npz"), jx


def gaps(got, jx, name: str, ref: str) -> tuple:
    """(|dloss|, |dgnorm|, max |dparam|) of the port's case ``name``
    against the oracle's case ``ref``."""
    loss, gnorm = jx[f"{ref}/metrics"]
    keys = [k[len(ref) + 8:] for k in jx if k.startswith(f"{ref}/params/")]
    assert keys and {k[len(name) + 8:] for k in got.files
                     if k.startswith(f"{name}/params/")} == set(keys)
    worst = max(float(np.abs(got[f"{name}/params/{k}"]
                             - jx[f"{ref}/params/{k}"]).max()) for k in keys)
    return (abs(float(got[f"{name}/loss"][0]) - loss),
            abs(float(got[f"{name}/grad_norm"][0]) - gnorm), worst)


def within(g: tuple) -> bool:
    return g[0] < DLOSS and g[1] < DGNORM and g[2] < DPARAMS
