"""``examples/vlm_training_torch.py``'s training against the JAX runtime.

The example trains the reduced compound VLM for 25 iterations and asserts
that its loss falls: the mean of the last five iterations below the first
five's (``learned``).  The reference's example compares the last batch's
loss with the first's.  Here the example's configuration runs in one
process (section meshes change only the sums' order,
``tests/test_torch_sections_mllm.py``) from
the port's init at seed 0 on ``vlm_batches(seed=0)``, and the JAX
``MLLMRuntime`` runs at the reference example's layout (the ViT at dp 4,
the LM at dp 4, 8 virtual CPU devices) from the same parameters in a
subprocess (``python tests/test_torch_vlm_example.py --jax-oracle
IN.npz OUT.npz``), and from its own init at seed 1 on seed 1's batches.

* The port's losses follow the JAX runtime's within ``TOL`` at every
  iteration: the example's losses are the reference's, given the same
  parameters.
* ``learned`` holds on all three curves.  The single-batch comparison is
  printed beside it (``pytest -s``): it fails on both runtimes from the
  port's seed-0 init, and on the JAX package's own init at seed 1.
"""
import functools
import importlib.util
import json
import os
import sys

if __name__ == "__main__":
    # the JAX oracle: 8 virtual CPU devices, set before JAX is imported
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import torch_sections_util as su  # noqa: E402
from repro_torch.core.types import ParallelConfig  # noqa: E402
from repro_torch.data.synthetic import vlm_batches  # noqa: E402
from repro_torch.mllm import workload as mw  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SEED, JAX_SEED = 0, 1
# float32 sums over 4 data ranks against one process, carried through
# 25 AdamW steps: measured 4.3e-5 at most
TOL = 2e-4


def _example():
    spec = importlib.util.spec_from_file_location(
        "vlm_training_torch", ROOT / "examples" / "vlm_training_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batches(make, ex, seed: int, **kw):
    return make(batch=ex.B, seq_len=ex.S, vocab=1024, vision_ratio=0.5,
                image_tokens=ex.K, patch_dim=16, seed=seed, **kw)


def jax_oracle(in_path: str, out_path: str) -> None:
    """The reference example's runtime, 25 serialized iterations: from
    IN.npz's parameters (the port's init, float32, each cast back to the
    JAX init's dtype) on seed SEED's batches, and from its own init at
    JAX_SEED on that seed's batches."""
    import jax
    from repro.configs import get_reduced as jreduced
    from repro.core.types import ParallelConfig as JParallel
    from repro.data.synthetic import vlm_batches as jvlm_batches
    from repro.mllm.workload import MLLMRuntime as JMLLMRuntime
    from repro.mllm.workload import init_compound_params as jinit
    from repro.models.vlm import vit_config as jvit
    from repro.optim import schedules as jschedules
    from test_torch_compound import _flatten, _unflatten

    assert len(jax.devices()) == 8, jax.devices()
    ex = _example()
    lm = jreduced("pixtral-12b").replace(
        dtype="float32", vocab_size=1024, vision_dim=64,
        max_image_tokens=ex.K)
    vit = jvit(num_layers=2, d_model=64, num_heads=4, d_ff=128,
               patch_dim=16, downsample=4, out_dim=64,
               name="vit-tiny").replace(dtype="float32")
    rt = JMLLMRuntime(vit, lm, vit_parallel=JParallel(dp=4),
                      lm_parallel=JParallel(dp=4), global_batch=ex.B,
                      seq_len=ex.S, mbs=ex.MBS, impl="ref",
                      lr_schedule=functools.partial(jschedules.constant,
                                                    peak_lr=ex.LR))
    arrays = np.load(in_path)
    init = jinit(vit, lm, jax.random.PRNGKey(0))
    dtypes = _flatten(jax.tree_util.tree_map(
        lambda x: np.asarray(x).dtype, init), "params")
    out = {}
    for name, seed, start in (
            ("same_init", SEED, lambda: rt.place(_unflatten(
                {k: arrays[k].astype(dt) for k, dt in dtypes.items()},
                "params"))),
            ("own_init", JAX_SEED,
             lambda: rt.init(jax.random.PRNGKey(JAX_SEED)))):
        params, opts = start()
        data = _batches(jvlm_batches, ex, seed)
        losses = []
        for i in range(ex.ITERS):
            params, opts, m = rt.train_iteration(params, opts, next(data), i)
            losses.append(float(m["loss"]))
        out[name] = np.asarray(losses)
    rt.shutdown()
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def curves(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vlm")
    ex = _example()
    vit, lm = ex.configs()
    with mw.MLLMRuntime(vit, lm, vit_parallel=ParallelConfig(),
                        lm_parallel=ParallelConfig(), devices=["cpu", "cpu"],
                        global_batch=ex.B, seq_len=ex.S, mbs=ex.MBS,
                        lr_schedule=functools.partial(schedules.constant,
                                                      peak_lr=ex.LR)) as rt:
        params, opts = rt.init(SEED)
        np.savez(tmp / "in.npz", **{f"params/{k}": v
                                    for k, v in su.flat(params).items()})
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                               str(ROOT / "tests")]))
        env.pop("XLA_FLAGS", None)
        oracle = subprocess.Popen(
            [sys.executable, __file__, "--jax-oracle", str(tmp / "in.npz"),
             str(tmp / "jax.npz")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env)
        data = _batches(vlm_batches, ex, SEED, device="cpu")
        losses = []
        for i in range(ex.ITERS):
            params, opts, m = rt.train_iteration(params, opts, next(data), i)
            losses.append(float(m["loss"]))
    out, err = oracle.communicate(timeout=600)
    assert oracle.returncode == 0, out[-3000:] + err[-6000:]
    jx = np.load(tmp / "jax.npz")
    got = {"port": np.asarray(losses), "jax_same_init": jx["same_init"],
           "jax_own_init": jx["own_init"]}
    print(json.dumps({k: {"losses": v.tolist(),
                          "mean_first_five": float(v[:5].mean()),
                          "mean_last_five": float(v[-5:].mean()),
                          "last_below_first": bool(v[-1] < v[0])}
                      for k, v in got.items()}))
    return ex, got


def test_port_losses_follow_the_jax_runtime(curves):
    _, got = curves
    gap = np.abs(got["port"] - got["jax_same_init"])
    assert gap.max() <= TOL, (gap.max(), int(gap.argmax()))


@pytest.mark.parametrize("run", ["port", "jax_same_init", "jax_own_init"])
def test_example_criterion_holds(curves, run):
    ex, got = curves
    losses = got[run]
    assert np.isfinite(losses).all() and len(losses) == ex.ITERS
    assert ex.learned(losses), losses


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    jax_oracle(sys.argv[2], sys.argv[3])
