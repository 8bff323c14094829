"""MLLM training through section meshes on 8 gloo ranks
(``MLLMRuntime(..., ranks=)``): the ViT at dp 4 on ranks 0-3 and the LM at
dp 4 on ranks 4-7, at the reduced pairing of
``tests/drivers/driver_mllm_runtime.py`` (batch 16 x 32 in microbatches of
4, so each rank holds one row of each), three iterations (mixed, all
text, mixed) with the joint clip at 0.05.

The structural checks of driver_mllm_runtime.py, on every rank: the
wavefront reorders and needs no more image microbatches than FIFO; the
ViT ranks run ``2·|image_mbs|`` tasks (fwd and bwd), none on the all-text
batch; the queue counts ``2·|image_mbs| + 2`` logical pushes (embeddings,
their cotangents and the two grad-norm messages); the joint grad norm is
above the clip threshold.  The driver also holds lookahead 2 to the
serialized run bit for bit.  A ViT with ``cp=2`` validates, and so does
an LM with ``cp=2`` (both run in
``tests/test_torch_context_sections.py``).

Against two references on the same plans from the same parameters: the
JAX ``MLLMRuntime`` at the same layout (the ViT at dp 4 on 4 virtual
devices, the LM at dp 4 on 4 more, run by this file in a subprocess while
the ranks run: ``python tests/test_torch_sections_mllm.py --jax-oracle
IN.npz OUT.npz``) and the port's one-process ``MLLMRuntime``.  Losses,
grad norms and both sections' gradients:

* losses and grad norms within ``TOL`` at the first iteration and
  ``STEP_TOL`` after an update (measured at most 2.4e-5 relative);
* a float32 gradient within ``TOL`` at iterations 0 and 1 (measured at
  most 3.3e-6 of its leaf's largest element), and within ``LATE_SCALE``
  of its largest element at iteration 2 (see there);
* a bfloat16 gradient (the norm scales) within ``BF16_SCALE`` of its
  largest element at every iteration.

The data ranks reorder the float32 sums (weighted per-rank means, a
reduce-scatter), and a bfloat16 leaf's gradient rounds once a rank; the
reference's own runtime is off its oracle by 1.49e-8 (ROADMAP.md, C0).
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

torch = pytest.importorskip("torch")

import torch_sections_util as su  # noqa: E402
from repro_torch.core.types import ParallelConfig  # noqa: E402
from repro_torch.data.synthetic import vlm_batches  # noqa: E402
from repro_torch.mllm import workload as mw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD, ITERS = 8, 3
SHAPE = su.driver_sections.MLLM_SHAPE
TOL = dict(atol=1e-5, rtol=1e-5)
# after the first update: tests/test_torch_distill.py's tolerance for a
# few float32 steps (AdamW's normaliser magnifies the reordered sums)
STEP_TOL = dict(atol=2e-4, rtol=2e-4)
# a bfloat16 leaf (the norm scales) takes its gradient in bfloat16 inside
# autograd, summed over the rows a rank holds (one here, four in one
# process) before the float32 reduction: the sums round differently, by a
# few bfloat16 steps of the leaf's scale; BF16_SCALE of its largest value.
BF16_SCALE = 2.0 ** -7
# after two updates (iteration 2) AdamW's second step, which unlike its
# first depends on the gradients' magnitudes, carries those bf16 leaves'
# differences into every float32 gradient: measured 2.5e-3 of a leaf's
# largest element against the JAX run and against one process alike
LATE_SCALE = 5e-3


def _batches():
    """Iterations 0 and 2 mixed (vlm_batches seed 0), iteration 1 all text
    (seed 1), as tests/test_torch_mllm.py draws them."""
    kw = dict(batch=16, seq_len=32, vocab=256, image_tokens=4, patch_dim=16,
              device="cpu")
    mixed = vlm_batches(vision_ratio=0.5, seed=0, **kw)
    text = vlm_batches(vision_ratio=0.0, seed=1, **kw)
    return [next(mixed), next(text), next(mixed)]


def jax_oracle(in_path: str, out_path: str) -> None:
    """The JAX ``MLLMRuntime`` at the driver's layout (the ViT at dp 4 on
    devices 0-3, the LM at dp 4 on 4-7) and clip, from IN.npz's
    parameters (float32, each cast back to the JAX init's dtype), three
    iterations on its own plans with their gradients."""
    import jax
    from repro.configs import get_reduced as jreduced
    from repro.core.types import ParallelConfig as JParallel
    from repro.data.synthetic import vlm_batches as jvlm_batches
    from repro.mllm.workload import MLLMRuntime as JMLLMRuntime
    from repro.mllm.workload import init_compound_params as jinit
    from repro.models.vlm import vit_config as jvit
    from repro.optim import adamw as jadamw
    from test_torch_compound import _flatten, _unflatten, save_tree

    assert len(jax.devices()) == 8, jax.devices()
    arrays = np.load(in_path)
    lm = jreduced("pixtral-12b").replace(
        dtype="float32", vocab_size=256, vision_dim=32, max_image_tokens=4)
    vit = jvit(num_layers=2, d_model=32, num_heads=2, d_ff=64, patch_dim=16,
               downsample=4, out_dim=32, name="vit-tiny").replace(
                   dtype="float32")
    dtypes = _flatten(jax.tree_util.tree_map(
        lambda x: np.asarray(x).dtype, jinit(vit, lm, jax.random.PRNGKey(0))),
        "params")
    params_host = _unflatten({k: arrays[k].astype(dt)
                              for k, dt in dtypes.items()}, "params")
    opt = su.driver_sections.MLLM_OPT
    rt = JMLLMRuntime(vit, lm, vit_parallel=JParallel(dp=4),
                      lm_parallel=JParallel(dp=4), impl="ref",
                      opt_cfg=jadamw.AdamWConfig(clip_norm=opt.clip_norm),
                      **SHAPE)
    params, opts = rt.place(params_host)
    out = {}
    kw = dict(batch=16, seq_len=32, vocab=256, image_tokens=4, patch_dim=16)
    mixed = jvlm_batches(vision_ratio=0.5, seed=0, **kw)
    text = jvlm_batches(vision_ratio=0.0, seed=1, **kw)
    for i, batch in enumerate([next(mixed), next(text), next(mixed)]):
        np.testing.assert_array_equal(np.asarray(batch["tokens"]),
                                      arrays[f"batch{i}/tokens"])
        plan = rt.plan_iteration(np.asarray(batch["has_image"]),
                                 reorder=True)
        params, opts, m = rt.train_iteration(params, opts, batch, i,
                                             plan=plan, return_grads=True)
        out[f"it{i}/order"] = np.asarray(plan.order)
        out[f"it{i}/metrics"] = np.asarray(
            [float(m["loss"]), float(m["grad_norm"])])
        save_tree(out, jax.tree_util.tree_map(np.asarray, m["grads"]),
                  f"it{i}/grads")
    rt.shutdown()
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("m")
    data = _batches()
    vit, lm = su.driver_sections.mllm_cfgs()
    inputs = {f"params/{k}": v for k, v in su.flat(
        mw.init_compound_params(vit, lm, seed=3, device="cpu")).items()}
    for i, b in enumerate(data):
        inputs.update(su.driver_sections.to_npz(b, i))
    proc, prefix = su.start("mllm", WORLD, inputs, tmp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    oracle = subprocess.Popen(
        [sys.executable, __file__, "--jax-oracle", str(tmp / "in.npz"),
         str(tmp / "jax.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    got = su.finish(proc, prefix, "mllm")
    out, err = oracle.communicate(timeout=600)
    assert oracle.returncode == 0, out[-3000:] + err[-6000:]
    return data, got, np.load(tmp / "jax.npz")



def test_structure_on_every_rank(mesh_run):
    _, got, _ = mesh_run
    assert sorted(got) == list(range(WORLD))
    for rank, npz in got.items():
        for i in range(ITERS):
            image = npz[f"it{i}/image_mbs"]
            assert len(image) <= len(npz[f"it{i}/fifo_image_mbs"])
            assert int(npz[f"it{i}/pushes"][0]) == 2 * len(image) + 2
            assert float(npz[f"it{i}/grad_norm"][0]) > \
                su.driver_sections.MLLM_OPT.clip_norm
            if rank < 4:
                assert int(npz[f"it{i}/n_vit_tasks"][0]) == 2 * len(image)
            else:
                assert f"it{i}/n_vit_tasks" not in npz.files
        assert list(npz["it0/order"]) != sorted(npz["it0/order"])
        assert len(npz["it1/image_mbs"]) == 0        # the all-text batch
        assert len(npz["it0/image_mbs"]) < len(npz["it0/fifo_image_mbs"])


def _check_iteration(i, got, want_loss, want_gnorm, want_grads, bf16, what):
    """Iteration ``i`` of the mesh run (rank 0 the ViT's origin, rank 4
    the LM's) against a reference's loss, grad norm and ``{section: flat
    gradients}``, at the tolerances of the module docstring."""
    f32 = TOL if i == 0 else STEP_TOL
    np.testing.assert_allclose(got[4][f"it{i}/loss"][0], want_loss,
                               err_msg=f"{what} loss {i}", **f32)
    np.testing.assert_allclose(got[0][f"it{i}/grad_norm"][0], want_gnorm,
                               err_msg=f"{what} grad norm {i}", **f32)
    for sec, rank in (("vit", 0), ("lm", 4)):
        have = su.flat(su.tree(got[rank], f"it{i}/grads/{sec}/"))
        want = want_grads[sec]
        assert have.keys() == want.keys()
        for k in want:
            scale = float(np.abs(want[k]).max())
            if (sec, k) in bf16:
                tol = dict(rtol=0, atol=BF16_SCALE * scale)
            elif i < 2:
                tol = TOL
            else:
                tol = dict(rtol=0, atol=LATE_SCALE * scale)
            np.testing.assert_allclose(have[k], want[k],
                                       err_msg=f"{what} {i} {sec} {k}", **tol)


def test_matches_one_process_runtime(mesh_run):
    data, got, _ = mesh_run
    vit, lm = su.driver_sections.mllm_cfgs()
    torch.use_deterministic_algorithms(True)
    try:
        with mw.MLLMRuntime(vit, lm, vit_parallel=ParallelConfig(),
                            lm_parallel=ParallelConfig(),
                            devices=["cpu", "cpu"],
                            opt_cfg=su.driver_sections.MLLM_OPT,
                            **SHAPE) as rt:
            params, opts = rt.init(3)             # the driver's seed
            for sec, rank, joint in (("vit", 0, "vit"), ("llm", 4, "lm")):
                have = su.flat(su.tree(got[rank], f"init/{sec}/"))
                for k, v in su.flat(params[joint]).items():
                    np.testing.assert_array_equal(have[k], v, err_msg=k)
            for i, b in enumerate(data):
                plan = mw.build_plan(got[4][f"it{i}/order"],
                                     b["has_image"].numpy(), SHAPE["mbs"])
                params, opts, m = rt.train_iteration(
                    params, opts, b, i, plan=plan, return_grads=True)
                bf16 = {(sec, k) for sec in ("vit", "lm")
                        for k, v in su.flat_tensors(m["grads"][sec]).items()
                        if v.dtype == torch.bfloat16}
                _check_iteration(
                    i, got, float(m["loss"]), float(m["grad_norm"]),
                    {sec: su.flat(m["grads"][sec]) for sec in ("vit", "lm")},
                    bf16, "one process")
    finally:
        torch.use_deterministic_algorithms(False)


def test_matches_jax_mllm_runtime(mesh_run):
    _, got, jx = mesh_run
    for i in range(ITERS):
        # the port's planner makes the JAX run's plan
        np.testing.assert_array_equal(got[4][f"it{i}/order"],
                                      jx[f"it{i}/order"])
        grads, bf16 = {}, set()
        for sec in ("vit", "lm"):
            grads[sec] = su.flat(su.tree(jx, f"it{i}/grads/{sec}/"))
            bf16 |= {(sec, k) for k in grads[sec]
                     if str(jx[f"dtype:it{i}/grads/{sec}/{k}"]) == "bfloat16"}
        assert bf16            # the norm scales
        loss, gnorm = jx[f"it{i}/metrics"]
        _check_iteration(i, got, loss, gnorm, grads, bf16, "JAX")


def test_vit_cp_raises_naming_a63():
    """A ViT at cp 2 now runs (tests/test_torch_context_sections.py): its
    spec validates in the cp regime, and so does an LM at cp 2, whose
    sequence ranks take the image slots whole and splice those inside
    their shards."""
    vit, lm = su.driver_sections.mllm_cfgs()
    spec = mw.mllm_spec(vit, lm, vit_parallel=ParallelConfig(dp=2, cp=2),
                        lm_parallel=ParallelConfig(dp=2, cp=2), **SHAPE)
    for name in ("vit", "llm"):
        sec = spec.section(name)
        assert mw.wl.validate_section_parallel(
            name, sec.arch, sec.parallel,
            mw.wl._mesh_sizes(sec.parallel)) == "cp"


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    jax_oracle(sys.argv[2], sys.argv[3])
