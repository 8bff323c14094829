"""Compressed section reductions through section meshes on 8 gloo ranks:
the two-section workload of ``tests/drivers/driver_compression.py:177-219``
(``enc``: h = tanh(x·w), trainable producer; ``head``: mean((h·v - y)²),
the loss), each section at dp 4 (``enc`` on ranks 0-3, ``head`` on 4-7)
with the same ``grad_compress``, four iterations of batch 8 in
microbatches of 4, ``AdamWConfig(clip_norm=1.0)``, from the same float32
parameters.

* bf16 within 1e-3 and int8 within 5e-2 (relative) of "none": the
  reference driver's bounds;
* the int8 error-feedback residual is non-zero;
* "none" against the JAX ``CompoundRuntime`` of the same workload on 8
  virtual devices, run by this file in a subprocess while the ranks run
  (``python tests/test_torch_sections_compressed.py --jax-oracle IN.npz
  OUT.npz``), within 1e-5 relative.
"""
import os
import sys

if __name__ == "__main__":
    # the JAX oracle: 8 virtual CPU devices, set before JAX is imported
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ITERS = 4
DRIVER_TOL = {"bf16": 1e-3, "int8": 5e-2}
JAX_TOL = 1e-5


def _inputs():
    from torch_sections_util import driver_sections as ds
    rng = np.random.default_rng(0)
    out = {"params/enc/w": (rng.normal(size=(ds.CD, ds.CD)) * 0.25).astype(
               np.float32),
           "params/head/v": (rng.normal(size=(ds.CD, ds.CD)) * 0.25).astype(
               np.float32)}
    for i in range(ITERS):
        for k in ("x", "y"):
            out[f"batch{i}/{k}"] = rng.normal(
                size=(ds.CB, ds.CS, ds.CD)).astype(np.float32)
    return out


def jax_oracle(in_path: str, out_path: str) -> None:
    """driver_compression.py's CompoundRuntime with grad_compress "none",
    from IN.npz's parameters and batches."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced
    from repro.core import workload as wl
    from repro.core.types import ParallelConfig
    from repro.models import common as cm
    from repro.optim import adamw

    assert len(jax.devices()) == 8, jax.devices()
    arrays = np.load(in_path)
    B, S2, MBS, D = 8, 8, 4, 16
    cfg = get_reduced("qwen1.5-0.5b")
    h_port = wl.Port("h", (S2, D), "float32")
    par = ParallelConfig(dp=4, grad_compress="none")

    def enc_fn(p, x):
        return {"h": jnp.tanh(x["x"] @ p["w"])}

    def head_fn(p, x):
        pred = x["enc.h"] @ p["v"]
        return jnp.mean(jnp.square(pred - x["y"]))

    enc = wl.SectionSpec(
        "enc", cfg, par, enc_fn,
        {"w": cm.ParamSpec((D, D), (None, None), "normal", jnp.float32)},
        inputs={"x": wl.Field((S2, D), "float32")}, emits=(h_port,))
    head = wl.SectionSpec(
        "head", cfg, par, head_fn,
        {"v": cm.ParamSpec((D, D), (None, None), "normal", jnp.float32)},
        inputs={"y": wl.Field((S2, D), "float32")},
        consumes=(wl.Consume("enc", h_port),), loss=True, critical=True)
    spec = wl.WorkloadSpec("t", (enc, head), seq_len=S2, global_batch=B,
                           mbs=MBS)
    rt = wl.CompoundRuntime(spec, opt_cfg=adamw.AdamWConfig(clip_norm=1.0))
    params, opts = rt.place({"enc": {"w": jnp.asarray(arrays["params/enc/w"])},
                             "head": {"v": jnp.asarray(
                                 arrays["params/head/v"])}})
    losses = []
    for i in range(ITERS):
        b = {k: arrays[f"batch{i}/{k}"] for k in ("x", "y")}
        params, opts, m = rt.train_iteration(params, opts, b, i)
        losses.append(float(m["loss"]))
    rt.shutdown()
    np.savez(out_path, loss=np.asarray(losses))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("torch")
    import torch_sections_util as su
    tmp = tmp_path_factory.mktemp("comp")
    inputs = _inputs()
    proc, prefix = su.start("compressed", 8, inputs, tmp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    oracle = subprocess.Popen(
        [sys.executable, __file__, "--jax-oracle", str(tmp / "in.npz"),
         str(tmp / "jax.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    got = su.finish(proc, prefix, "compressed")
    out, err = oracle.communicate(timeout=600)
    assert oracle.returncode == 0, out[-3000:] + err[-6000:]
    return got, np.load(tmp / "jax.npz")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-8)))


def test_compressed_within_driver_bounds_of_exact(runs):
    got, _ = runs
    head = got[4]
    base = head["none/loss"]
    assert len(base) == ITERS and np.all(np.isfinite(base))
    for method, tol in DRIVER_TOL.items():
        assert _rel(head[f"{method}/loss"], base) < tol, method
    # every head rank reports the same losses
    for r in (5, 6, 7):
        for method in ("none", "bf16", "int8"):
            np.testing.assert_array_equal(got[r][f"{method}/loss"],
                                          head[f"{method}/loss"])


def test_int8_residual_nonzero(runs):
    got, _ = runs
    assert all(float(npz["ef_max"][0]) > 0 for npz in got.values())


def test_uncompressed_matches_jax_compound_runtime(runs):
    got, jax_out = runs
    assert _rel(got[4]["none/loss"], jax_out["loss"]) < JAX_TOL


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    jax_oracle(sys.argv[2], sys.argv[3])
