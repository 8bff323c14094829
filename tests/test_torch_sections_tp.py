"""A compound section at tensor parallel degree 2, on the CPU: the
reference's distillation layout (``tests/drivers/driver_distill_runtime.py``)
through section meshes on 8 gloo ranks, the frozen teacher (reduced
qwen2.5-32b, float32, vocabulary 512) at ``ParallelConfig(dp=2, tp=2)``
on ranks 0-3 under Megatron TP, the student (reduced qwen1.5-0.5b) at dp
4 on ranks 4-7, four iterations of 8 x 32 from the same parameters
(``tests/torch_drivers/driver_sections.py distill_tp``).

* The losses, ce, kl and grad norms of the four iterations, and every
  student leaf after them, within 2e-4 of the JAX ``DistillRuntime`` at
  the same layout on 8 virtual devices (run while the ranks run:
  ``python tests/test_torch_sections_tp.py --jax-oracle IN.npz OUT.npz``)
  and of the port's one-process ``DistillRuntime(devices=["cpu"] * 2)``
  (``tests/test_torch_compound.py``'s tolerance for a few float32 steps).
* 4 logical pushes: one of the teacher's two model ranks at each data
  coordinate sends its rows, to two student ranks an iteration, and the
  teacher's origin its output layer, gathered over ``model``, to all four
  (8 * 2 + 4 fragments: the other model rank sends nothing).
* A section with ``pp`` above 1 raises with the reference's reason, and
  so does pp x cp; cp x tp validates.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import subprocess  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import torch_sections_util as su  # noqa: E402
from repro_torch.core import workload as twl  # noqa: E402
from repro_torch.core.types import ParallelConfig  # noqa: E402
from repro_torch.distill import workload as dw  # noqa: E402

B, S, VOCAB, ITERS, WORLD = 8, 32, 512, 4, 8
TOL = dict(atol=2e-4, rtol=2e-4)
METRICS = ("loss", "ce", "kl", "grad_norm")


def _inputs():
    """The batches and the one-process runtime's initial parameters."""
    rng = np.random.default_rng(0)
    out = {}
    for i in range(ITERS):
        out[f"batch{i}/tokens"] = rng.integers(0, VOCAB, (B, S)).astype(
            np.int32)
        out[f"batch{i}/labels"] = rng.integers(0, VOCAB, (B, S)).astype(
            np.int32)
        out[f"batch{i}/loss_mask"] = np.ones((B, S), np.float32)
    t_cfg, s_cfg = su.driver_sections.distill_cfgs()
    with dw.DistillRuntime(t_cfg, s_cfg, teacher_parallel=ParallelConfig(),
                           student_parallel=ParallelConfig(),
                           devices=["cpu", "cpu"]) as rt:
        pt, ps, _ = rt.init(0)
    out.update(su.flat(pt, "params/teacher/"))
    out.update(su.flat(ps, "params/student/"))
    return out


def jax_oracle(in_path: str, out_path: str) -> None:
    """Four iterations of the JAX ``DistillRuntime``, teacher (dp 2, tp 2)
    and student dp 4, from IN.npz's parameters."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jreduced
    from repro.core.types import ParallelConfig as JParallel
    from repro.distill.workload import DistillRuntime as JDistillRuntime
    from repro.optim import adamw as jadamw
    from test_torch_compound import save_tree

    assert len(jax.devices()) == 8, jax.devices()
    arrays = np.load(in_path)
    t_cfg = jreduced("qwen2.5-32b").replace(dtype="float32", vocab_size=VOCAB)
    s_cfg = jreduced("qwen1.5-0.5b").replace(dtype="float32",
                                             vocab_size=VOCAB)
    rt = JDistillRuntime(t_cfg, s_cfg,
                         teacher_parallel=JParallel(dp=2, tp=2),
                         student_parallel=JParallel(dp=4), impl="ref",
                         alpha=0.5, temperature=2.0, lr=1e-3)
    pt0, ps0, opt0 = rt.init(jax.random.PRNGKey(0))

    def given(like, name):
        flat = su.tree(arrays, f"params/{name}/")
        return jax.tree_util.tree_map(
            lambda x, v: jax.device_put(jnp.asarray(v, x.dtype), x.sharding),
            like, flat)
    pt, ps = given(pt0, "teacher"), given(ps0, "student")
    opt = jax.tree_util.tree_map(
        lambda x, v: jax.device_put(v, x.sharding), opt0,
        jadamw.init(ps))
    w_t = rt.teacher_unembed(pt)
    out, mets = {}, []
    for i in range(ITERS):
        batch = {k: jnp.asarray(arrays[f"batch{i}/{k}"])
                 for k in ("tokens", "labels", "loss_mask")}
        ps, opt, m = rt.train_iteration(pt, ps, opt, batch, i, w_t=w_t)
        mets.append([float(m[k]) for k in METRICS])
    out["metrics"] = np.asarray(mets, np.float64)
    save_tree(out, jax.device_get(ps), "final/student")
    rt.shutdown()
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sections_tp")
    inputs = _inputs()
    proc, prefix = su.start("distill_tp", WORLD, inputs, tmp)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(su.ROOT / "src"), str(su.ROOT / "tests"), str(su.DRIVERS)]))
    env.pop("XLA_FLAGS", None)
    oracle = subprocess.Popen(
        [sys.executable, __file__, "--jax-oracle", str(tmp / "in.npz"),
         str(tmp / "jax.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    got = su.finish(proc, prefix, "distill_tp")
    out, err = oracle.communicate(timeout=600)
    assert oracle.returncode == 0, out[-3000:] + err[-6000:]
    return inputs, got, np.load(tmp / "jax.npz")


def _student(npz, prefix):
    return {k: np.asarray(v, np.float32)
            for k, v in su.flat(su.tree(npz, prefix)).items()}


def test_teacher_tp2_matches_jax_distill_runtime(tp_run):
    _, got, jx = tp_run
    np.testing.assert_allclose(got[4]["metrics"], jx["metrics"], **TOL)
    have, want = (_student(got[4], "final/student/"),
                  _student(jx, "final/student/"))
    assert have.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(have[k], want[k], err_msg=k, **TOL)


def test_teacher_tp2_matches_one_process_runtime(tp_run):
    inputs, got, _ = tp_run
    t_cfg, s_cfg = su.driver_sections.distill_cfgs()
    with dw.DistillRuntime(t_cfg, s_cfg, teacher_parallel=ParallelConfig(),
                           student_parallel=ParallelConfig(),
                           devices=["cpu", "cpu"], lr=1e-3) as rt:
        params, opts = rt.runtime.place(
            su.driver_sections.given_params(inputs, rt.runtime))
        pt, ps, opt = params["teacher"], params["student"], opts["student"]
        w_t = rt.teacher_unembed(pt)
        mets = []
        for i in range(ITERS):
            b = {k: torch.from_numpy(inputs[f"batch{i}/{k}"])
                 for k in ("tokens", "labels", "loss_mask")}
            ps, opt, m = rt.train_iteration(pt, ps, opt, b, i, w_t=w_t)
            mets.append([float(m[k]) for k in METRICS])
    np.testing.assert_allclose(got[4]["metrics"], np.asarray(mets), **TOL)
    want = su.flat(ps)
    have = _student(got[4], "final/student/")
    assert have.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(have[k], want[k], err_msg=k, **TOL)


def test_pushes_and_fragments(tp_run):
    _, got, _ = tp_run
    assert sorted(got) == list(range(WORLD))
    for npz in got.values():
        assert int(npz["pushes"][0]) == ITERS
        assert int(npz["fragments"][0]) == 2 * 2 * ITERS + 4


@pytest.mark.parametrize("par,match", [
    (ParallelConfig(dp=2, pp=2), "cannot be stage-partitioned"),
    (ParallelConfig(cp=2, pp=2), "pp x cp"),
])
def test_section_pp_and_cp_tp_refusals(par, match):
    t_cfg, _ = su.driver_sections.distill_cfgs()
    # cp x tp runs (tests/test_torch_context_sections.py)
    cptp = ParallelConfig(cp=2, tp=2)
    assert twl.validate_section_parallel("teacher", t_cfg, cptp,
                                         twl._mesh_sizes(cptp)) == "cp"
    with pytest.raises(NotImplementedError,
                       match=rf"section 'teacher'.*{match}"):
        twl.validate_section_parallel("teacher", t_cfg, par,
                                      twl._mesh_sizes(par))


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    jax_oracle(sys.argv[2], sys.argv[3])
