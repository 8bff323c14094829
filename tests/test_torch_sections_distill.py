"""Distillation through section meshes on 6 gloo ranks
(``DistillRuntime(..., ranks=)``): the teacher (reduced qwen2.5-32b,
float32, vocabulary 512) at dp 2 on ranks 0-1, the student (reduced
qwen1.5-0.5b) at dp 4 on ranks 2-5, four iterations of 8 x 32, the
batches of ``tests/drivers/driver_distill_runtime.py``.

* ``fanout == 2`` (paper eq. 1) and 4 logical pushes, one hidden state an
  iteration (the teacher's origin hands the student its output layer
  outside the queue's count, as the reference's ``device_put`` does);
* the first loss within 1e-4 of the JAX ``distill_loss`` on the same
  parameters and batch (the reference driver's bound);
* the 4 losses, ce, kl and grad norms, and every student leaf after them,
  within 2e-4 of the port's one-process ``DistillRuntime(devices=["cpu"]
  * 2)`` from the same seed (``tests/test_torch_distill.py``'s tolerance
  for a few float32 steps);
* a teacher with ``tp=2`` and ``cp=2`` validates in the cp regime (a
  teacher at ``tp=2`` alone runs, ``tests/test_torch_sections_tp.py``, a
  student at cp x tp ``tests/test_torch_context_sections.py``), and with
  ``pp=2`` it raises, before any rank is carved.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_sections_util as su  # noqa: E402
from repro_torch.core import workload as wl  # noqa: E402
from repro_torch.core.types import ParallelConfig  # noqa: E402
from repro_torch.distill import workload as dw  # noqa: E402

B, S, VOCAB, ITERS, WORLD = 8, 32, 512, 4, 6
TOL = dict(atol=2e-4, rtol=2e-4)
JAX_TOL = 1e-4          # tests/drivers/driver_distill_runtime.py


def _batches():
    rng = np.random.default_rng(0)
    out = {}
    for i in range(ITERS):
        out[f"batch{i}/tokens"] = rng.integers(0, VOCAB, (B, S)).astype(
            np.int32)
        out[f"batch{i}/labels"] = rng.integers(0, VOCAB, (B, S)).astype(
            np.int32)
        out[f"batch{i}/loss_mask"] = np.ones((B, S), np.float32)
    return out


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    inputs = _batches()
    got = su.run("distill", WORLD, inputs, tmp_path_factory.mktemp("dist"))
    return inputs, got


def test_fanout_and_logical_pushes(mesh_run):
    _, got = mesh_run
    assert sorted(got) == list(range(WORLD))
    for npz in got.values():
        assert int(npz["fanout"][0]) == 2
        assert int(npz["pushes"][0]) == ITERS
        # each teacher rank sends its half to two student ranks an
        # iteration, and its origin the output layer to all four
        assert int(npz["fragments"][0]) == 2 * 2 * ITERS + 4


def test_first_loss_matches_jax_distill_loss(mesh_run):
    import jax.numpy as jnp
    from repro.configs import get_reduced as jreduced
    from repro.distill.workload import distill_loss, teacher_hidden

    inputs, got = mesh_run
    t_cfg = jreduced("qwen2.5-32b").replace(dtype="float32",
                                            vocab_size=VOCAB)
    s_cfg = jreduced("qwen1.5-0.5b").replace(dtype="float32",
                                             vocab_size=VOCAB)
    pt = su.tree(got[0], "init/teacher/")
    ps = su.tree(got[2], "init/student/")
    to_j = lambda t: {k: to_j(v) if isinstance(v, dict)  # noqa: E731
                      else jnp.asarray(v) for k, v in t.items()}
    pt, ps = to_j(pt), to_j(ps)
    batch = {k: jnp.asarray(inputs[f"batch0/{k}"])
             for k in ("tokens", "labels", "loss_mask")}
    h_t = teacher_hidden(pt, t_cfg, batch["tokens"], impl="ref")
    mono, _ = distill_loss(ps, s_cfg, batch, h_t, pt["unembed"], alpha=0.5,
                           temperature=2.0, impl="ref", kl_impl="ref")
    assert abs(float(mono) - got[2]["metrics"][0, 0]) < JAX_TOL


def test_losses_and_student_match_one_process_runtime(mesh_run):
    inputs, got = mesh_run
    t_cfg, s_cfg = su.driver_sections.distill_cfgs()
    torch.use_deterministic_algorithms(True)
    try:
        with dw.DistillRuntime(t_cfg, s_cfg,
                               teacher_parallel=ParallelConfig(),
                               student_parallel=ParallelConfig(),
                               devices=["cpu", "cpu"], lr=1e-3) as rt:
            pt, ps, opt = rt.init(0)
            w_t = rt.teacher_unembed(pt)
            mets = []
            for i in range(ITERS):
                b = {k: torch.from_numpy(inputs[f"batch{i}/{k}"])
                     for k in ("tokens", "labels", "loss_mask")}
                ps, opt, m = rt.train_iteration(pt, ps, opt, b, i, w_t=w_t)
                mets.append([float(m[k]) for k in
                             ("loss", "ce", "kl", "grad_norm")])
    finally:
        torch.use_deterministic_algorithms(False)
    np.testing.assert_allclose(got[2]["metrics"], np.asarray(mets), **TOL)
    want = su.flat(ps)
    have = su.flat(su.tree(got[2], "final/student/"))
    assert have.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(have[k], want[k], err_msg=k, **TOL)


def test_teacher_tp_raises_naming_a64():
    # a teacher at tp 2 runs (tests/test_torch_sections_tp.py), and at tp 2
    # with cp 2 its section validates in the cp regime (a student at cp 2
    # x tp 2 runs: tests/test_torch_context_sections.py); with a pipe axis
    # it is refused, as in the reference
    t_cfg, _ = su.driver_sections.distill_cfgs()
    par = ParallelConfig(dp=2, tp=2, cp=2)
    assert wl.validate_section_parallel("teacher", t_cfg, par,
                                        wl._mesh_sizes(par)) == "cp"
    par = ParallelConfig(dp=2, tp=2, pp=2)
    with pytest.raises(NotImplementedError,
                       match=r"section 'teacher'.*stage-partitioned"):
        wl.validate_section_parallel("teacher", t_cfg, par,
                                     wl._mesh_sizes(par))
