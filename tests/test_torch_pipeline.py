"""``dist.pipeline.build_pp_loss`` (GPipe, vocab-parallel CE, TP inside
stages) on 8 gloo ranks against the JAX package's ``build_pp_loss`` and
its monolithic ``tf.lm_loss``, on the CPU.

The cases are ``tests/torch_drivers/driver_pipeline.py``'s
``LOSS_CASES``, each from the same parameters and global batch (a loss
mask with about a fifth of its tokens off):

* granite-3-8b (4 layers) on (data 2, pipe 2), 2 micro-batches, and
  mixtral (2 layers, the MoE aux rebuilt from router statistics) and
  qwen1.5-0.5b (tied embeddings: the vocab-parallel lookup) on the same
  mesh -- ``tests/drivers/driver_train_step_dist.py``'s oracles;
* (pod 2, data 2, pipe 2), whose data axes are ("pod", "data"), and stages
  on ``pod`` with no ``pipe`` axis, (pod 2, data 4) over 16 rows --
  ``driver_pipeline_cp.py``'s;
* pipe 4 with 4 micro-batches, vocab-parallel and masked CE;
* (pipe 2, model 2): granite-3-8b (attention and MLP sliced) and
  granite-20b (one KV head, so attention stays whole; a GELU MLP whose
  ``b_out`` is added 1/tp a rank).

The JAX side runs on an 8-virtual-device host in a subprocess while the
ranks run (``python tests/test_torch_pipeline.py --jax-oracle IN.npz
OUT.npz``) on Auto meshes.  Bounds: the reference driver's, loss within
1e-5 and every gradient within 5e-4 (the bf16 norm scales' gradients
round differently per micro-batch); each case's ``info`` equals the
reference's.  The driver runs under a timeout, so a schedule that
deadlocks fails the test instead of hanging the suite.
"""
import json
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DRIVERS = ROOT / "tests" / "torch_drivers"
sys.path.insert(0, str(DRIVERS))
import driver_pipeline as dpl  # noqa: E402
from dist_util import flat  # noqa: E402

CASES = dpl.LOSS_CASES
WORLD = 8
#: JAX oracle processes, each compiling its share of the cases
ORACLES = 2
S = 16
# tests/drivers/driver_train_step_dist.py:139-144
DLOSS, DGRAD = 1e-5, 5e-4


def _jax_params(arrays, name, cfg):
    import jax
    from repro.models.model import build_model
    from test_torch_compound import _flatten, _unflatten
    dtypes = _flatten(jax.tree_util.tree_map(
        lambda x: np.asarray(x).dtype,
        build_model(cfg, impl="ref").init(jax.random.PRNGKey(0))),
        name + "/params")
    return _unflatten({k: arrays[k].astype(dt) for k, dt in dtypes.items()},
                      name + "/params")


def _jax_batch(arrays, name):
    import jax.numpy as jnp
    return {k[len(name) + 7:]: jnp.asarray(arrays[k])
            for k in arrays.files if k.startswith(f"{name}/batch/")}


def jax_oracle(in_path: str, out_path: str, part: int, parts: int) -> None:
    """Each case's JAX ``build_pp_loss`` (jitted value and gradient) on an
    Auto mesh of the first virtual devices, and the monolithic loss; the
    cases ``part::parts``, so that several processes share them."""
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_reduced
    from repro.dist.pipeline import build_pp_loss
    from repro.models import transformer as jtf
    from test_torch_compound import save_tree

    assert len(jax.devices()) == 8, jax.devices()
    arrays = np.load(in_path)
    out, monolithic = {}, {}
    for name, arch, over, axes, shape, n_micro, vp, gb in \
            CASES[part::parts]:
        cfg = get_reduced(arch).replace(dtype="float32", **over)
        params = _jax_params(arrays, name, cfg)
        batch = _jax_batch(arrays, name)
        mesh = jax.make_mesh(shape, axes, (AxisType.Auto,) * len(axes),
                             devices=jax.devices()[:int(np.prod(shape))])
        loss_fn, info = build_pp_loss(cfg, mesh, n_micro, impl="ref",
                                      vocab_parallel=vp)
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
        # cases of one model and batch size share their inputs
        key = (arch, tuple(sorted(over.items())), gb)
        if key not in monolithic:
            monolithic[key] = jax.jit(jax.value_and_grad(
                lambda p: jtf.lm_loss(p, cfg, batch, impl="ref")[0]))(params)
        mono, g_mono = monolithic[key]
        out[f"{name}/loss"] = np.array([float(loss), float(mono)])
        out[f"{name}/info"] = np.array(json.dumps(info))
        save_tree(out, jax.device_get(grads), f"{name}/grads")
        save_tree(out, jax.device_get(g_mono), f"{name}/mono")
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def pp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    inputs = {}
    for name, arch, over, *_, gb in CASES:
        cfg = tcfgs.get_reduced(arch).replace(dtype="float32", **over)
        inputs.update(flat(tbuild(cfg, device="cpu", seed=0).param_tree(),
                           f"{name}/params/"))
        rng = np.random.default_rng(0)
        for k in ("tokens", "labels"):
            inputs[f"{name}/batch/{k}"] = rng.integers(
                0, cfg.vocab_size, (gb, S)).astype(np.int32)
        inputs[f"{name}/batch/loss_mask"] = (
            rng.random((gb, S)) < 0.8).astype(np.float32)
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(DRIVERS)]))
    env.pop("XLA_FLAGS", None)
    jenv = dict(env, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), str(DRIVERS)]))
    oracles = [subprocess.Popen(
        [sys.executable, __file__, "--jax-oracle", str(tmp / "in.npz"),
         str(tmp / f"jax{i}.npz"), str(i), str(ORACLES)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=jenv)
        for i in range(ORACLES)]
    proc = subprocess.run(
        [sys.executable, str(DRIVERS / "driver_pipeline.py"), "loss",
         str(WORLD), str(tmp / "in.npz"), str(tmp / "out.npz")],
        capture_output=True, text=True, env=env, timeout=360)
    assert proc.returncode == 0 and "DRIVER_OK pipeline loss" in \
        proc.stdout, proc.stdout[-3000:] + proc.stderr[-6000:]
    jx = {}
    for i, oracle in enumerate(oracles):
        out, err = oracle.communicate(timeout=600)
        assert oracle.returncode == 0, out[-3000:] + err[-6000:]
        jx.update(np.load(tmp / f"jax{i}.npz"))
    return np.load(tmp / "out.npz"), jx


def _worst(got, jx, name, ref):
    keys = [k for k in jx if k.startswith(f"{name}/{ref}/")]
    assert keys
    mine = {k for k in got.files if k.startswith(f"{name}/grads/")}
    assert mine == {f"{name}/grads/{k[len(name) + len(ref) + 2:]}"
                    for k in keys}
    return max(float(np.abs(got[f"{name}/grads/" + k[len(name) + len(ref)
                                                     + 2:]] - jx[k]).max())
               for k in keys)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_pp_loss_matches_jax_pp_loss_and_monolithic(pp_run, name):
    got, jx = pp_run
    loss = float(got[f"{name}/loss"][0])
    jpp, jmono = (float(x) for x in jx[f"{name}/loss"])
    assert abs(loss - jpp) < DLOSS and abs(loss - jmono) < DLOSS, \
        (loss, jpp, jmono)
    assert abs(float(got[f"{name}/fwd_loss"][0]) - loss) < 1e-6
    assert _worst(got, jx, name, "grads") < DGRAD
    assert _worst(got, jx, name, "mono") < DGRAD


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_pp_info_matches_jax(pp_run, name):
    got, jx = pp_run
    assert json.loads(str(got[f"{name}/info"])) == \
        json.loads(str(jx[f"{name}/info"]))


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    jax_oracle(sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5]))
