"""Context-parallel compound sections on gloo ranks against the JAX
package, on the CPU.

* MLLM (``tests/drivers/driver_mllm_runtime.py``'s ViT-CP block; then
  again with the LM at ``ParallelConfig(dp=2, cp=2)`` as well, each of its
  sequence ranks splicing the image slots inside its shard): the ViT
  at ``ParallelConfig(dp=2, cp=2)`` on ranks 0-3, each rank holding half
  of every image's patches, and the LM at dp 4 on ranks 4-7, at the
  reduced pairing of ``tests/test_torch_sections_mllm.py`` (batch 16 x
  32, microbatches of 4, the joint clip at 0.05), one mixed iteration
  (``driver_sections.py mllm_cp``).  Against the JAX ``MLLMRuntime`` at
  that layout on 8 virtual devices and the port's one-process runtime on
  the same plan: loss and grad norm within ``TOL``, every float32
  gradient within ``TOL``, a bfloat16 gradient (the norm scales) within
  ``BF16_SCALE`` of its largest element (``test_torch_sections_mllm.py``
  says why); the ViT ranks run fwd and bwd on the image microbatches
  only.
* Distillation (``tests/drivers/driver_train_step_dist.py:103-123``): the
  teacher at dp 2 on ranks 0-1 and the student at ``ParallelConfig(dp=2,
  cp=2)`` on ranks 2-5 (``driver_sections.py distill_cp``), granite-3-8b
  reduced to 4 layers as both, one iteration of 8 x 16 with about a
  third of the loss mask off, against the JAX colocated step at (dp 2,
  cp 2) on an Auto mesh: loss within 1e-5 and the student's parameters
  within 1e-4 (the driver's bounds).  Then, in the same ranks, the
  teacher at tp 2 and the student at ``ParallelConfig(cp=2, tp=2)`` (cp x
  tp: each model rank's
  2 query heads and 1 KV head under ``cp_attention`` over its sequence
  group) against the JAX colocated step at (cp 2, tp 2), same bounds.

The JAX references run in two subprocesses while the ranks run (``python
tests/test_torch_context_sections.py --jax-oracle IN_MLLM.npz IN_DISTILL.npz
OUT.npz PART 2``).
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

import torch_sections_util as su  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.types import ParallelConfig  # noqa: E402
from repro_torch.data.synthetic import vlm_batches  # noqa: E402
from repro_torch.mllm import workload as mw  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHAPE = su.driver_sections.MLLM_SHAPE
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_SCALE = 2.0 ** -7
DLOSS, DPARAMS = 1e-5, 1e-4
VLM_KW = dict(batch=16, seq_len=32, vocab=256, image_tokens=4, patch_dim=16)


def _distill_cfg(reduced):
    return reduced("granite-3-8b").replace(dtype="float32", num_layers=4)


def jax_oracle(mllm_in: str, distill_in: str, out_path: str, part: int,
               parts: int) -> None:
    """The JAX references of :data:`ORACLE_JOBS` ``part::parts``, so that
    several processes share them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_reduced as jreduced
    from repro.core.types import ParallelConfig as JParallel
    from repro.core.types import ShapeConfig as JShape
    from repro.data.synthetic import vlm_batches as jvlm_batches
    from repro.distill.workload import build_colocated_step
    from repro.mllm.workload import MLLMRuntime as JMLLMRuntime
    from repro.mllm.workload import init_compound_params as jinit
    from repro.models import transformer as jtf
    from repro.models.common import init_params as jinit_params
    from repro.models.vlm import vit_config as jvit
    from repro.optim import adamw as jadamw
    from repro.optim import schedules as jsched
    from test_torch_compound import _flatten, _unflatten, save_tree

    assert len(jax.devices()) == 8, jax.devices()
    out = {}

    def mllm(name, lm_par):
        """MLLM: the ViT at (dp 2, cp 2), the LM at ``lm_par``."""
        arrays = np.load(mllm_in)
        lm = jreduced("pixtral-12b").replace(
            dtype="float32", vocab_size=256, vision_dim=32,
            max_image_tokens=4)
        vit = jvit(num_layers=2, d_model=32, num_heads=2, d_ff=64,
                   patch_dim=16, downsample=4, out_dim=32,
                   name="vit-tiny").replace(dtype="float32")
        dtypes = _flatten(jax.tree_util.tree_map(
            lambda x: np.asarray(x).dtype,
            jinit(vit, lm, jax.random.PRNGKey(0))), "params")
        params_host = _unflatten({k: arrays[k].astype(dt)
                                  for k, dt in dtypes.items()}, "params")
        batch = next(jvlm_batches(vision_ratio=0.5, seed=0, **VLM_KW))
        np.testing.assert_array_equal(np.asarray(batch["tokens"]),
                                      arrays["batch0/tokens"])
        rt = JMLLMRuntime(
            vit, lm, vit_parallel=JParallel(dp=2, cp=2),
            lm_parallel=JParallel(**lm_par), impl="ref",
            opt_cfg=jadamw.AdamWConfig(
                clip_norm=su.driver_sections.MLLM_OPT.clip_norm), **SHAPE)
        assert dict(rt.rt.mesh("vit").shape)["seq"] == 2
        params, opts = rt.place(params_host)
        plan = rt.plan_iteration(np.asarray(batch["has_image"]),
                                 reorder=True)
        _, _, m = rt.train_iteration(params, opts, batch, 0, plan=plan,
                                     return_grads=True)
        out[f"{name}/order"] = np.asarray(plan.order)
        out[f"{name}/metrics"] = np.asarray([float(m["loss"]),
                                             float(m["grad_norm"])])
        save_tree(out, jax.tree_util.tree_map(np.asarray, m["grads"]),
                  f"{name}/grads")
        rt.shutdown()

    def distill(name, par):
        """Distillation: the colocated step at ``par`` on an Auto mesh."""
        arrays = np.load(distill_in)
        cfg = _distill_cfg(jreduced)
        dtypes = _flatten(jax.tree_util.tree_map(
            lambda x: np.asarray(x).dtype,
            jinit_params(jtf.lm_specs(cfg), jax.random.PRNGKey(0))),
            "params")
        params = _unflatten({k: arrays[k].astype(dt)
                             for k, dt in dtypes.items()}, "params")
        batch = {k[7:]: jnp.asarray(arrays[k]) for k in arrays.files
                 if k.startswith("batch0/")}
        par = JParallel(**par)
        mesh = jax.make_mesh((par.dp, 1, par.cp, par.tp),
                             ("data", "pipe", "seq", "model"),
                             axis_types=(AxisType.Auto,) * 4)
        step, sh = build_colocated_step(
            cfg, cfg, mesh, JShape("d", "train", 16, 8), par, impl="ref",
            lr_schedule=lambda s: jsched.constant(s, peak_lr=1e-3),
            opt_cfg=jadamw.AdamWConfig(eps=1e-3))
        with mesh:
            ps = jax.device_put(params, sh["student"])
            o = jax.device_put(jadamw.init(params), sh["opt"])
            pt = jax.device_put(params, sh["teacher"])
            new_p, _, met = step(ps, o, pt, batch, jnp.int32(0))
            new_p = jax.device_get(new_p)
        out[f"{name}/loss"] = np.asarray([float(met["loss"])])
        save_tree(out, new_p, f"{name}/params")

    for kind, name, par in ORACLE_JOBS[part::parts]:
        (mllm if kind == "mllm" else distill)(name, par)
    np.savez(out_path, **out)


#: the JAX references, as (kind, name, ParallelConfig knobs): the MLLM
#: runtime by its LM's layout, the colocated distillation step by its own
ORACLE_JOBS = [("mllm", "mllm", dict(dp=4)),
               ("mllm", "mllm_lmcp", dict(dp=2, cp=2)),
               ("distill", "distill", dict(dp=2, cp=2, mbs=4)),
               ("distill", "distill_cptp", dict(cp=2, tp=2, mbs=8))]
ORACLE_PARTS = 2


@pytest.fixture(scope="module")
def cp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cpsec")
    vit, lm = su.driver_sections.mllm_cfgs()
    batch = next(vlm_batches(vision_ratio=0.5, seed=0, device="cpu",
                             **VLM_KW))
    m_in = {f"params/{k}": v for k, v in su.flat(
        mw.init_compound_params(vit, lm, seed=3, device="cpu")).items()}
    m_in.update(su.driver_sections.to_npz(batch, 0))
    cfg = _distill_cfg(get_reduced)
    params = cm.init_params(tf.lm_specs(cfg), torch.Generator().manual_seed(0),
                            "cpu")
    rng = np.random.default_rng(0)
    d_in = {f"params/{k}": v for k, v in su.flat(params).items()}
    for k in ("tokens", "labels"):
        d_in[f"batch0/{k}"] = rng.integers(0, cfg.vocab_size,
                                           (8, 16)).astype(np.int32)
    d_in["batch0/loss_mask"] = (rng.random((8, 16)) < 0.7).astype(np.float32)
    (tmp / "m").mkdir()
    (tmp / "d").mkdir()
    np.savez(tmp / "m" / "in.npz", **m_in)
    np.savez(tmp / "d" / "in.npz", **d_in)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    oracles = [subprocess.Popen(
        [sys.executable, __file__, "--jax-oracle", str(tmp / "m" / "in.npz"),
         str(tmp / "d" / "in.npz"), str(tmp / f"jax{i}.npz"), str(i),
         str(ORACLE_PARTS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(ORACLE_PARTS)]
    mllm = su.run("mllm_cp", 8, m_in, tmp / "m")
    distill = su.run("distill_cp", 6, d_in, tmp / "d")
    jx = {}
    for i, oracle in enumerate(oracles):
        out, err = oracle.communicate(timeout=600)
        assert oracle.returncode == 0, out[-3000:] + err[-6000:]
        jx.update(np.load(tmp / f"jax{i}.npz"))
    np.savez(tmp / "jax.npz", **jx)
    return batch, mllm, distill, np.load(tmp / "jax.npz")


def _check_mllm(got, loss, gnorm, grads, bf16, what, pre=""):
    np.testing.assert_allclose(got[4][f"{pre}it0/loss"][0], loss,
                               err_msg=f"{what} loss", **TOL)
    np.testing.assert_allclose(got[0][f"{pre}it0/grad_norm"][0], gnorm,
                               err_msg=f"{what} grad norm", **TOL)
    for sec, rank in (("vit", 0), ("lm", 4)):
        have = su.flat(su.tree(got[rank], f"{pre}it0/grads/{sec}/"))
        assert have.keys() == grads[sec].keys()
        for k, want in grads[sec].items():
            tol = (dict(rtol=0, atol=BF16_SCALE * float(np.abs(want).max()))
                   if (sec, k) in bf16 else TOL)
            np.testing.assert_allclose(have[k], want,
                                       err_msg=f"{what} {sec} {k}", **tol)


def test_vit_cp_structure(cp_run):
    _, got, _, jx = cp_run
    assert sorted(got) == list(range(8))
    image = [int(i) for i in got[0]["it0/image_mbs"]]
    assert image and len(image) < 4
    for rank in range(4):          # every ViT rank, both sequence halves
        assert int(got[rank]["it0/n_vit_tasks"][0]) == 2 * len(image)
        assert set(got[rank]["it0/vit_order"]) == {
            f"fwd{i}" for i in image} | {f"bwd{i}" for i in image} | {"upd"}
    # the ranks agree on the final parameters of their sections
    for sec, ranks in (("vit", range(4)), ("llm", range(4, 8))):
        ref = su.tree(got[ranks[0]], f"final/{sec}/")
        for r in ranks[1:]:
            for k, v in su.flat(su.tree(got[r], f"final/{sec}/")).items():
                np.testing.assert_array_equal(v, su.flat(ref)[k])
    np.testing.assert_array_equal(got[4]["it0/order"], jx["mllm/order"])


def _check_mllm_jax(got, jx, ref: str, pre: str = "") -> None:
    grads, bf16 = {}, set()
    for sec in ("vit", "lm"):
        grads[sec] = su.flat(su.tree(jx, f"{ref}/grads/{sec}/"))
        bf16 |= {(sec, k) for k in grads[sec]
                 if str(jx[f"dtype:{ref}/grads/{sec}/{k}"]) == "bfloat16"}
    assert bf16
    loss, gnorm = jx[f"{ref}/metrics"]
    _check_mllm(got, loss, gnorm, grads, bf16, "JAX", pre)


def test_vit_cp_matches_jax_mllm_runtime(cp_run):
    _, got, _, jx = cp_run
    _check_mllm_jax(got, jx, "mllm")


def test_lm_cp_matches_jax_mllm_runtime(cp_run):
    """The LM at (dp 2, cp 2) too: its sequence ranks take the image
    embeddings whole, each splices the slots in its shard, and the
    embeddings' cotangent sums over them before it reaches the ViT."""
    _, got, _, jx = cp_run
    np.testing.assert_array_equal(got[4]["lmcp/it0/order"],
                                  jx["mllm_lmcp/order"])
    _check_mllm_jax(got, jx, "mllm_lmcp", "lmcp/")


def test_vit_cp_matches_one_process_runtime(cp_run):
    batch, got, _, _ = cp_run
    vit, lm = su.driver_sections.mllm_cfgs()
    torch.use_deterministic_algorithms(True)
    try:
        with mw.MLLMRuntime(vit, lm, vit_parallel=ParallelConfig(),
                            lm_parallel=ParallelConfig(),
                            devices=["cpu", "cpu"],
                            opt_cfg=su.driver_sections.MLLM_OPT,
                            **SHAPE) as rt:
            params, opts = rt.init(3)
            plan = mw.build_plan(got[4]["it0/order"],
                                 batch["has_image"].numpy(), SHAPE["mbs"])
            _, _, m = rt.train_iteration(params, opts, batch, 0, plan=plan,
                                         return_grads=True)
    finally:
        torch.use_deterministic_algorithms(False)
    bf16 = {(sec, k) for sec in ("vit", "lm")
            for k, v in su.flat_tensors(m["grads"][sec]).items()
            if v.dtype == torch.bfloat16}
    _check_mllm(got, float(m["loss"]), float(m["grad_norm"]),
                {sec: su.flat(m["grads"][sec]) for sec in ("vit", "lm")},
                bf16, "one process")


def _check_student(got, jx, pre: str, ref: str) -> None:
    """The student ranks' loss and final parameters of run ``pre`` against
    the JAX colocated step ``ref``."""
    assert sorted(got) == [2, 3, 4, 5]      # the student ranks report
    loss = float(got[2][f"{pre}it0/metrics"][0])
    for r in range(3, 6):          # every student rank reports the same
        np.testing.assert_array_equal(got[r][f"{pre}it0/metrics"],
                                      got[2][f"{pre}it0/metrics"])
    assert abs(loss - float(jx[f"{ref}/loss"][0])) < DLOSS
    have = su.flat(su.tree(got[2], f"{pre}final/student/"))
    want = su.flat(su.tree(jx, f"{ref}/params/"))
    assert have.keys() == want.keys()
    worst = max(float(np.abs(have[k] - want[k]).max()) for k in want)
    assert worst < DPARAMS, worst


def test_cp_student_matches_jax_colocated_step(cp_run):
    _, _, got, jx = cp_run
    _check_student(got, jx, "", "distill")


def test_cp_tp_student_matches_jax_colocated_step(cp_run):
    _, _, got, jx = cp_run
    _check_student(got, jx, "cptp/", "distill_cptp")


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    jax_oracle(sys.argv[2], sys.argv[3], sys.argv[4], int(sys.argv[5]),
               int(sys.argv[6]))
