"""The sharded serving steps (``train.step.build_prefill_step`` and
``build_decode_step``) on 4 gloo ranks against the JAX package's builders
on Auto meshes of the same shape, on the CPU.

Each case (``tests/torch_drivers/driver_serving.py``) prefills a 4 x 40
prompt from one parameter tree (float32, through ``convert.py``) and then
decodes 4 tokens at positions 40-43 against the 40-slot cache the
prefill returns (both sides wrap the same slots).  Every rank's logits and
cache blocks, after the prefill and after the last decode, and every
decode's logits block must equal the JAX outputs' blocks under the
port's specs within 1e-5 of the largest magnitude of the JAX array:

* granite-3-8b at (data 2, model 2): attention and MLP under Megatron TP,
  the cache's KV heads over ``model``;
* granite-3-8b at (data 1, model 4): 2 KV heads do not divide 4, so the
  cache rests with its *sequence* over ``model`` and decode attends each
  rank's slice and merges the partials;
* granite-20b at (data 2, model 2): one KV head, the same sequence split;
* mixtral at (data 2, model 2): the rolling window (32 slots of a 40-token
  prompt) and MoE;
* mamba2-130m at (data 2, model 2): the ``ssm`` cache rests with its heads
  over ``model`` and the mixer computes whole;
* whisper-small at (data 2, model 2): the encoder, self- and
  cross-attention and MLPs under the same TP gates, both caches on their
  ``kv_heads`` slices.

The pp and cp refusals carry the reference's words.
"""
import os
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
DRIVERS = ROOT / "tests" / "torch_drivers"
sys.path.insert(0, str(DRIVERS))

import driver_serving as drv  # noqa: E402
from dist_util import flat  # noqa: E402

WORLD = 4
REL = 1e-5


def jax_oracle(in_path: str, out_path: str) -> None:
    """The JAX builders on ``section_mesh`` (Auto axes) of the first
    data x model virtual devices; outputs gathered to full arrays."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced
    from repro.core.types import ParallelConfig, ShapeConfig
    from repro.dist import sharding as jshd
    from repro.models.model import build_model
    from repro.train import step as jstep
    from test_torch_compound import _flatten, _unflatten

    arrays = np.load(in_path)
    out = {}
    for name, arch, over, d, m in drv.CASES:
        cfg = get_reduced(arch).replace(dtype="float32", **over)
        model = build_model(cfg, impl="ref")
        dtypes = _flatten(jax.tree_util.tree_map(
            lambda x: np.asarray(x).dtype,
            model.init(jax.random.PRNGKey(0))), name + "/params")
        params = _unflatten({k: arrays[k].astype(dt)
                             for k, dt in dtypes.items()}, name + "/params")
        par = ParallelConfig(dp=d, tp=m)
        mesh = jshd.section_mesh(jax.devices()[:par.devices], par)
        pstep, sh = jstep.build_prefill_step(
            model, mesh, ShapeConfig("p", "prefill", drv.S, drv.B))
        dstep, _ = jstep.build_decode_step(
            model, mesh, ShapeConfig("d", "decode", drv.S, drv.B))
        with mesh:
            p = jax.device_put(params, sh["params"])
            batch = {"tokens": jnp.asarray(arrays[f"{name}/tokens"],
                                           jnp.int32)}
            if cfg.family == "audio":
                batch["frames"] = jnp.asarray(arrays[f"{name}/frames"])
            logits, cache = pstep(p, batch)
            out[f"{name}/prefill/logits"] = np.array(logits, np.float32,
                                                     copy=True)
            out.update(_np_flat(cache, f"{name}/prefill/cache/"))
            for i in range(drv.DECODES):
                logits, cache = dstep(p, cache, jnp.asarray(
                    arrays[f"{name}/dec{i}"], jnp.int32),
                    jnp.int32(drv.S + i))
                out[f"{name}/dec{i}/logits"] = np.asarray(logits,
                                                          np.float32)
            out.update(_np_flat(cache, f"{name}/decode/cache/"))
    np.savez(out_path, **out)


def _np_flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_np_flat(v, f"{prefix}{k}/"))
        else:
            # a copy: the decode step donates the cache, whose buffer a
            # zero-copy view would show overwritten
            out[prefix + k] = np.array(v, np.float32, copy=True)
    return out


@pytest.fixture(scope="module")
def serving_run(tmp_path_factory):
    from repro_torch.models.model import build_model
    tmp = tmp_path_factory.mktemp("serving")
    rng = np.random.default_rng(0)
    inputs = {}
    for name, arch, over, _, _ in drv.CASES:
        cfg = drv.config(arch, over)
        inputs.update(flat(build_model(cfg, device="cpu", seed=0)
                           .param_tree(), f"{name}/params/"))
        inputs[f"{name}/tokens"] = rng.integers(
            0, cfg.vocab_size, (drv.B, drv.S)).astype(np.int64)
        if cfg.family == "audio":
            inputs[f"{name}/frames"] = rng.standard_normal(
                (drv.B, cfg.frontend_frames, cfg.frontend_dim)
            ).astype(np.float32)
        for i in range(drv.DECODES):
            inputs[f"{name}/dec{i}"] = rng.integers(
                0, cfg.vocab_size, (drv.B, 1)).astype(np.int64)
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(DRIVERS)]))
    env.pop("XLA_FLAGS", None)
    jenv = dict(env, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), str(DRIVERS)]))
    oracle = subprocess.Popen(
        [sys.executable, __file__, "--jax-oracle", str(tmp / "in.npz"),
         str(tmp / "jax.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=jenv)
    proc = subprocess.run(
        [sys.executable, str(DRIVERS / "driver_serving.py"), str(WORLD),
         str(tmp / "in.npz"), str(tmp / "out")],
        capture_output=True, text=True, env=env, timeout=360)
    assert proc.returncode == 0 and "DRIVER_OK serving" in proc.stdout, \
        proc.stdout[-3000:] + proc.stderr[-6000:]
    o_out, o_err = oracle.communicate(timeout=360)
    assert oracle.returncode == 0, o_out[-3000:] + o_err[-6000:]
    ranks = [np.load(tmp / f"out.{r}.npz") for r in range(WORLD)]
    return ranks, np.load(tmp / "jax.npz")


def _specs(name):
    """{output key: spec} of a case under the port's rules, and its mesh
    sizes."""
    from repro_torch.core.types import ShapeConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.models import model as mm
    _, arch, over, d, m = next(c for c in drv.CASES if c[0] == name)
    cfg = drv.config(arch, over)
    sizes = {"data": d, "pipe": 1, "seq": 1, "model": m}
    cache = shd.cache_shardings(sizes, mm.cache_specs(
        cfg, ShapeConfig("d", "decode", drv.S, drv.B)))
    out = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                for when in ("prefill", "decode"):
                    out[f"{name}/{when}/cache/{prefix}{k}"] = v
    walk(cache, "")
    logits = shd.logits_sharding(sizes, drv.B, cfg.padded_vocab)
    out[f"{name}/prefill/logits"] = logits
    for i in range(drv.DECODES):
        out[f"{name}/dec{i}/logits"] = logits
    return out, sizes


@pytest.mark.parametrize("name", [c[0] for c in drv.CASES])
def test_serving_blocks_match_jax_builders(serving_run, name):
    from repro_torch.dist import sharding as shd
    ranks, jx = serving_run
    specs, sizes = _specs(name)
    n = sizes["data"] * sizes["model"]
    worst = {}
    for key, spec in specs.items():
        want_full = torch.from_numpy(jx[key])
        scale = float(want_full.abs().max())
        for r in range(n):
            coord = {"data": r // sizes["model"], "pipe": 0, "seq": 0,
                     "model": r % sizes["model"]}
            want = shd.shard(want_full, spec, sizes, coord)
            got = torch.from_numpy(ranks[r][key])
            assert got.shape == want.shape, (key, r, got.shape, want.shape)
            err = float((got - want).abs().max()) / max(scale, 1e-30)
            worst[key] = max(worst.get(key, 0.0), err)
    bad = {k: v for k, v in worst.items() if v > REL}
    assert not bad, bad


def test_serving_builders_reject_pp_and_cp_meshes():
    from repro_torch.core.types import ShapeConfig
    from repro_torch.models.model import build_model
    from repro_torch.train import step as step_mod
    model = build_model(drv.config("granite-3-8b", {}), device="cpu")
    for axis in ("pipe", "seq"):
        mesh = {"data": 1, "pipe": 1, "seq": 1, "model": 1, axis: 2}
        with pytest.raises(NotImplementedError,
                           match="do not support pipe/seq mesh axes"):
            step_mod.build_decode_step(model, mesh,
                                       ShapeConfig("t", "decode", 32, 4))
        with pytest.raises(NotImplementedError, match="prefill cells"):
            step_mod.build_prefill_step(model, mesh,
                                        ShapeConfig("t", "prefill", 32, 4))


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    jax_oracle(sys.argv[2], sys.argv[3])
