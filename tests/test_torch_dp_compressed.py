"""The port's compressed data-parallel step at world size 8 against the
reference's.

The configuration of ``tests/drivers/driver_compression.py``'s
``build_train_step`` part (reduced qwen1.5-0.5b, float32, 2 layers,
vocabulary 64, d_ff 96; global batch 8 x 16, ``ParallelConfig(dp=8,
mbs=1, zero_opt=False)``, AdamW eps 1e-3, the default schedule), 4 steps
with ``grad_compress`` "none", "bf16" and "int8":

* the reference's ``run_steps`` logic on 8 virtual devices, run by this
  file as ``python tests/test_torch_dp_compressed.py --jax-oracle out.npz``
  (driver_compression.py runs every check on import, so it is not
  imported);
* the port on 8 spawned gloo ranks (``tests/torch_drivers/driver_dp.py``)
  from the reference's initial parameters (in their dtypes) and batches.

The port's losses must match the reference's within ``REF_TOL``, ten
times tighter than driver_compression.py's own compressed-against-exact
tolerance (``DRIVER_TOL``), which the port's compressed trajectories must
also keep against its own uncompressed one; the int8 residual must be
non-zero.
"""
import os
import sys

if __name__ == "__main__":
    # the JAX oracle: 8 virtual CPU devices, set before JAX is imported
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import json  # noqa: E402
import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DRIVER = ROOT / "tests" / "torch_drivers" / "driver_dp.py"
DP, GB, S, STEPS = 8, 8, 16, 4
OVER = {"dtype": "float32", "num_layers": 2, "vocab_size": 64, "d_ff": 96}
METHODS = ("none", "bf16", "int8")
# tests/drivers/driver_compression.py:158, relative loss deviation of a
# compressed trajectory from the exact one
DRIVER_TOL = {"bf16": 1e-3, "int8": 5e-2}
# the port against the reference, method for method: ten times tighter
# (the uncompressed step: tests/test_torch_train.py's float32 tolerance)
REF_TOL = {"none": 2e-4, "bf16": 1e-4, "int8": 1e-4}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _inputs():
    """The reference's initial parameters (PRNG key 0) and batches."""
    from repro.configs import get_reduced
    from repro.models.model import build_model
    cfg = get_reduced("qwen1.5-0.5b").replace(**OVER)
    init = build_model(cfg, impl="ref").init(jax.random.PRNGKey(0))
    out = {f"params/{k}": v for k, v in _flat(
        jax.tree_util.tree_map(np.asarray, init)).items()}
    for i in range(STEPS):
        r = np.random.default_rng(i)
        out.update({f"batch{i}/tokens": r.integers(0, cfg.vocab_size,
                                                   (GB, S)),
                    f"batch{i}/labels": r.integers(0, cfg.vocab_size,
                                                   (GB, S)),
                    f"batch{i}/loss_mask": np.ones((GB, S), np.float32)})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's driver output, the JAX oracle's), computed at once."""
    tmp = tmp_path_factory.mktemp("dpc")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    inputs = _inputs()
    np.savez(tmp / "in.npz", **{f"{m}/{k}": v for m in METHODS
                                for k, v in inputs.items()})
    cases = [dict(name=m, arch="qwen1.5-0.5b", over=OVER, mbs=1, zero=False,
                  compress=m, steps=STEPS, batch=GB, seq=S, lr=None,
                  spec_dtypes=True)
             for m in METHODS]
    (tmp / "cases.json").write_text(json.dumps(cases))
    port = subprocess.Popen(
        [sys.executable, str(DRIVER), str(DP), str(tmp / "cases.json"),
         str(tmp / "in.npz"), str(tmp / "port.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        ref = subprocess.run([sys.executable, __file__, "--jax-oracle",
                              str(tmp / "jax.npz")], capture_output=True,
                             text=True, env=env, timeout=600)
        out, err = port.communicate(timeout=600)
    finally:
        port.kill()
    assert ref.returncode == 0, ref.stdout + ref.stderr
    assert "DRIVER_OK dp" in out, out + err
    want = np.load(tmp / "jax.npz")
    got = np.load(tmp / "port.npz")
    for m in METHODS:
        print(f"{m}: port {got[f'{m}/loss']} reference {want[f'loss/{m}']}")
    return got, want


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-8)))


@pytest.mark.parametrize("method", METHODS)
def test_losses_match_the_reference(runs, method):
    port, ref = runs
    dev = _rel(port[f"{method}/loss"], ref[f"loss/{method}"])
    assert dev < REF_TOL[method], (method, dev, port[f"{method}/loss"],
                                   ref[f"loss/{method}"])


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_compressed_tracks_the_exact_trajectory(runs, method):
    port, ref = runs
    dev = _rel(port[f"{method}/loss"], port["none/loss"])
    assert dev < DRIVER_TOL[method], (method, dev)
    assert _rel(ref[f"loss/{method}"], ref["loss/none"]) < DRIVER_TOL[method]


def test_int8_residual_is_nonzero(runs):
    port, ref = runs
    assert float(port["int8/ef_max"][0]) > 0
    assert float(ref["ef_max/int8"]) > 0


def test_uncompressed_parameters_match_the_reference(runs):
    port, ref = runs
    for k in ref.files:
        if k.startswith("final/"):
            np.testing.assert_allclose(
                port[f"none/params/{k[len('final/'):]}"], ref[k],
                atol=2e-4, rtol=2e-4, err_msg=k)


# --------------------------------------------------------------------------- #
# the JAX oracle (run as a script): driver_compression.py's run_steps
# --------------------------------------------------------------------------- #
def _jax_oracle(out_path):
    from repro.configs import get_reduced
    from repro.core.types import ParallelConfig, ShapeConfig
    from repro.dist import sharding as shd
    from repro.models.model import build_model
    from repro.optim import adamw
    from repro.train import step as step_mod

    cfg = get_reduced("qwen1.5-0.5b").replace(**OVER)
    shape = ShapeConfig("t", "train", S, GB)
    model = build_model(cfg, impl="ref")
    inputs = _inputs()
    batches = [{k: inputs[f"batch{i}/{k}"] for k in ("tokens", "labels",
                                                     "loss_mask")}
               for i in range(STEPS)]
    out = {}
    for method in METHODS:
        par = ParallelConfig(dp=DP, mbs=1, zero_opt=False,
                             grad_compress=method)
        mesh = shd.section_mesh(jax.devices(), par)
        step, sh = step_mod.build_train_step(
            model, mesh, par, shape, opt_cfg=adamw.AdamWConfig(eps=1e-3))
        # a fresh init for each run, as run_steps does: the step donates
        params = jax.device_put(model.init(jax.random.PRNGKey(0)),
                                sh["params"])
        opt = jax.device_put(adamw.init(params), sh["opt"])
        ef = sh["ef_init"](params) if method != "none" else None
        losses = []
        for i, b in enumerate(batches):
            jb = {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64
                                 else v.dtype) for k, v in b.items()}
            args = (params, opt, jb, jnp.int32(i))
            if method == "none":
                params, opt, m = step(*args)
            else:
                params, opt, m, ef = step(*args, ef)
            losses.append(float(m["loss"]))
        out[f"loss/{method}"] = np.array(losses)
        if method == "none":
            out.update({f"final/{k}": v for k, v in _flat(
                jax.tree_util.tree_map(np.asarray, params)).items()})
        else:
            out[f"ef_max/{method}"] = np.array(max(
                float(jnp.max(jnp.abs(x)))
                for x in jax.tree_util.tree_leaves(ef)))
    np.savez(out_path, **out)


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    _jax_oracle(sys.argv[2])
