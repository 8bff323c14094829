"""The train step's context-parallel regime (``build_train_step(...,
mesh=)`` on a mesh whose ``seq`` axis is above 1) against the JAX
package's ``build_train_step`` on ``section_mesh``, on the CPU.

Eight cases on 4 gloo ranks (``tests/torch_drivers/driver_context.py
step``), one step each from the same parameters and global batch (8 x 16,
a loss mask with about a fifth of its tokens off, so that the ranks' mask
shares differ; for pixtral also 4 image slots a row at distinct random
positions, about a quarter of them invalid):

* ``dp2cp2``: ``tests/drivers/driver_train_step_dist.py``'s cp2 step,
  granite-3-8b reduced to 4 layers, ``ParallelConfig(dp=2, cp=2, mbs=2)``
  (two micro-batches a data rank, ulysses);
* ``cp4c2``: qwen1.5-0.5b reduced (4 heads, 4 KV heads, so ulysses splits
  them over 4 ranks), ``ParallelConfig(cp=4, mbs=4, cp_mode="ulysses",
  cp_overlap_chunks=2)``: the chunked path with strided ``kv_positions``;
* ``mix_d2cp2`` and ``jamba_d2cp2``: mixtral reduced to 2 layers and jamba
  reduced at ``ParallelConfig(dp=2, cp=2, mbs=2)``: each micro-batch's
  router statistics averaged over the data and sequence ranks, and the
  MoE layers (per-sample capacity) and jamba's Mamba mixers (a scan
  across shards) run over the whole sequence;
* ``g_cp2t2`` and ``g20_cp2t2``: cp x tp, ``ParallelConfig(cp=2, tp=2,
  mbs=4)``: Megatron TP on the projections and the MLP, and
  ``cp_attention`` over each model rank's sequence group on its own head
  slice (granite-3-8b reduced, 4 layers: 2 query heads on 1 KV head a
  rank; granite-20b reduced: its one KV head repeated on both model
  ranks), against the JAX step, whose attention keeps its heads whole
  over ``model``;
* ``pix_d2cp2``: pixtral-12b reduced at ``ParallelConfig(dp=2, cp=2,
  mbs=2)``: each sequence shard splices the image slots inside it;
* ``pix_d2cp2_planted``: the same with every shard reading the global
  image positions as its own (no shift), held to ``pix_d2cp2``'s oracle:
  it must miss the bounds.

The JAX step runs on an 8-virtual-device host in four subprocesses while
the ranks run (``python tests/test_torch_context_step.py --jax-oracle
IN.npz OUT.npz PART 4``), with the driver's AdamW (eps 1e-3, constant lr 1e-3) and
tolerances: loss within 1e-5, grad norm within 1e-3, every parameter
within 1e-4.  A step that summed its gradients over the data ranks only
(1/cp of the tokens) misses these bounds.
"""
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
import driver_context as dc  # noqa: E402
from dist_util import flat  # noqa: E402

CASES = dc.STEP_CASES[4]
ORACLE = [c for c in CASES if not c[0].endswith("_planted")]
ORACLE_PARTS = 4
# tests/drivers/driver_train_step_dist.py:86-91
DLOSS, DGNORM, DPARAMS = 1e-5, 1e-3, 1e-4


def jax_oracle(in_path: str, out_path: str, part: int, parts: int) -> None:
    """One JAX ``build_train_step`` step a case on ``section_mesh`` of the
    first ``ParallelConfig.devices`` virtual devices; the cases
    ``part::parts``, so that several processes share them."""
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
    for name, arch, over, knobs in ORACLE[part::parts]:
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
            model, mesh, par, ShapeConfig("t", "train", dc.STEP_S,
                                          dc.STEP_GB),
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


def _image_slots(rng, cfg, prefix: str, k: int = 4) -> dict:
    """``k`` image slots a row at distinct random positions of the whole
    sequence (so that both sequence shards hold some), about a quarter of
    them invalid, with random embeddings."""
    gb, s = dc.STEP_GB, dc.STEP_S
    return {
        prefix + "image_embeds": rng.standard_normal(
            (gb, k, cfg.vision_dim)).astype(np.float32),
        prefix + "image_pos": np.stack([rng.permutation(s)[:k]
                                        for _ in range(gb)]).astype(np.int32),
        prefix + "image_valid": (rng.random((gb, k)) < 0.75).astype(
            np.int32)}


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cpstep")
    inputs = {}
    for name, arch, over, _ in CASES:
        cfg = tcfgs.get_reduced(arch).replace(dtype="float32", **over)
        inputs.update(flat(tbuild(cfg, device="cpu", seed=0).param_tree(),
                           f"{name}/params/"))
        rng = np.random.default_rng(0)
        shape = (dc.STEP_GB, dc.STEP_S)
        for k in ("tokens", "labels"):
            inputs[f"{name}/batch/{k}"] = rng.integers(
                0, cfg.vocab_size, shape).astype(np.int32)
        inputs[f"{name}/batch/loss_mask"] = (
            rng.random(shape) < 0.8).astype(np.float32)
        if cfg.vision_dim:
            inputs.update(_image_slots(rng, cfg, f"{name}/batch/"))
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(DRIVERS)]))
    env.pop("XLA_FLAGS", None)
    jenv = dict(env, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), str(DRIVERS)]))
    oracles = [subprocess.Popen(
        [sys.executable, __file__, "--jax-oracle", str(tmp / "in.npz"),
         str(tmp / f"jax{i}.npz"), str(i), str(ORACLE_PARTS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=jenv)
        for i in range(ORACLE_PARTS)]
    proc = subprocess.run(
        [sys.executable, str(DRIVERS / "driver_context.py"), "step", "4",
         str(tmp / "in.npz"), str(tmp / "out.npz")],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0 and "DRIVER_OK context step" in \
        proc.stdout, proc.stdout[-3000:] + proc.stderr[-6000:]
    jx = {}
    for i, oracle in enumerate(oracles):
        out, err = oracle.communicate(timeout=600)
        assert oracle.returncode == 0, out[-3000:] + err[-6000:]
        jx.update(np.load(tmp / f"jax{i}.npz"))
    return np.load(tmp / "out.npz"), jx


def _gaps(got, jx, name: str, ref: str) -> tuple:
    """(|dloss|, |dgnorm|, max |dparam|) of the port's case ``name``
    against the oracle's case ``ref``."""
    loss, gnorm = jx[f"{ref}/metrics"]
    keys = [k[len(ref) + 8:] for k in jx if k.startswith(f"{ref}/params/")]
    assert keys and {k[len(name) + 8:] for k in got.files if k.startswith(
        f"{name}/params/")} == set(keys)
    worst = max(float(np.abs(got[f"{name}/params/{k}"]
                             - jx[f"{ref}/params/{k}"]).max()) for k in keys)
    return (abs(float(got[f"{name}/loss"][0]) - loss),
            abs(float(got[f"{name}/grad_norm"][0]) - gnorm), worst)


@pytest.mark.parametrize("name", [c[0] for c in ORACLE])
def test_cp_step_matches_jax_section_mesh_step(step_run, name):
    got, jx = step_run
    dloss, dgnorm, worst = _gaps(got, jx, name, name)
    assert dloss < DLOSS
    assert dgnorm < DGNORM
    assert worst < DPARAMS, worst


def test_image_splice_without_the_shard_shift_misses_the_bounds(step_run):
    got, jx = step_run
    g = _gaps(got, jx, "pix_d2cp2_planted", "pix_d2cp2")
    assert not (g[0] < DLOSS and g[1] < DGNORM and g[2] < DPARAMS), g


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    jax_oracle(sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5]))
