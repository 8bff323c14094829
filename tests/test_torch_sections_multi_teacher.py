"""Routed multi-teacher distillation through section meshes on gloo ranks
(``CompoundRuntime(multi_teacher_spec(...), ranks=range(world))``): the
generalist teacher on rank 0, the domain-routed specialist on rank 1 and
the student on the other ranks, at the reduced models of
``tests/drivers/driver_multi_teacher.py`` (batch 16 x 32 in microbatches
of 4, ``AdamWConfig(clip_norm=0.0)``), three iterations: mixed domains,
all generalist, mixed.  Two layouts run side by side: world 3 (the
student at dp 1) and world 4 (the student at dp 2, where the specialist's
samples fall unevenly between the student's two ranks, so its KL_b mean
must be weighted by each rank's share of the KL_b mask, not of
``loss_mask``: ``SectionSpec.loss_share``).

Both start from the initial parameters of the JAX ``CompoundRuntime`` run
by ``tests/test_torch_multi_teacher.py --jax-oracle`` and follow its plans:

* the specialist's rank dispatches exactly the plan's active microbatches
  (``fwd<i>``), none on the all-generalist batch;
* loss, ce, KL_a, KL_b and grad norm of every iteration, and the
  student's parameters after the three, within atol = rtol = 2e-4 of the
  port's one-process runtime (``devices=["cpu"] * 3``) and of the JAX
  runtime (``tests/test_torch_multi_teacher.py``'s tolerance).

``tests/drivers/driver_multi_teacher.py`` itself (the JAX runtime at
dp 2/2/4 against its colocated reference), run on this JAX, stops at its
student-gradient check: 1 of 256 elements is 1.19e-7 off the colocated
reference, past its atol 1e-7 (its loss check, rtol 1e-6, passes;
ROADMAP.md, C0).
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_multi_teacher as tmt  # noqa: E402
import torch_sections_util as su  # noqa: E402
from repro_torch.convert import section_params_from_numpy  # noqa: E402
from repro_torch.core import workload as wl  # noqa: E402
from repro_torch.core.types import ParallelConfig  # noqa: E402
from repro_torch.data.synthetic import routed_lm_batches  # noqa: E402
from repro_torch.distill import multi_teacher as mt  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
SHAPE = su.driver_sections.MT_SHAPE
METRICS = su.driver_sections.MT_METRICS
WORLDS = (3, 4)          # the student at dp 1 and at dp 2
SECTIONS = ("teacher_a", "teacher_b", "student")


def _batches():
    data = routed_lm_batches(batch=SHAPE["global_batch"],
                             seq_len=SHAPE["seq_len"], vocab=256,
                             specialist_ratio=0.4, seed=0, device="cpu")
    first, second, third = next(data), dict(next(data)), next(data)
    second["domain"] = torch.zeros_like(second["domain"])
    return [first, second, third]


def _one_process(data, jax_mt):
    """The port's one-process runtime from the JAX run's parameters and
    plans -> (per-iteration metrics, the student's final leaves)."""
    ta, tb, s = su.driver_sections.mt_cfgs()
    spec = mt.multi_teacher_spec(
        ta, tb, s, ta_parallel=ParallelConfig(), tb_parallel=ParallelConfig(),
        s_parallel=ParallelConfig(), **SHAPE)
    cpu = torch.device("cpu")
    init = section_params_from_numpy(
        {n: tmt.load_tree(jax_mt, f"init/{n}") for n in SECTIONS},
        {n: cpu for n in SECTIONS})
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with wl.CompoundRuntime(spec, devices=["cpu"] * 3,
                                opt_cfg=adamw.AdamWConfig(clip_norm=0.0)
                                ) as rt:
            params, opts = rt.place(init)
            consts = mt.student_consts(rt, params, ta, tb)
            mets = []
            for i, b in enumerate(data):
                params, opts, m = rt.train_iteration(
                    params, opts, b, i, plan=tmt._plan(jax_mt, i),
                    consts=consts)
                mets.append([float(m[k]) for k in METRICS])
    finally:
        torch.use_deterministic_algorithms(was)
    return np.array(mets), su.flat(params["student"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mt")
    (tmp / "jax").mkdir()
    jax_mt = tmt.run_oracle(Path(tmt.__file__), tmp / "jax")
    data = _batches()
    inputs = {"params/" + k[len("init/"):]: jax_mt[k]
              for k in jax_mt.files if k.startswith("init/")}
    for i, b in enumerate(data):         # the same data on both sides
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      jax_mt[f"tokens{i}"])
        np.testing.assert_array_equal(b["domain"].numpy(),
                                      jax_mt[f"domain{i}"])
        inputs.update(su.driver_sections.to_npz(b, i))
        for k in ("order", "active", "idx", "valid"):
            inputs[f"plan{i}/{k}"] = jax_mt[f"{k}{i}"]
    procs = {w: su.start("multi_teacher", w, inputs, tmp / f"w{w}")
             for w in WORLDS}
    one = _one_process(data, jax_mt)
    got = {w: su.finish(*procs[w], "multi_teacher") for w in WORLDS}
    return jax_mt, one, got


def _final_student(npz) -> dict:
    return su.flat(su.tree(npz, "final/student/"))


def _assert_close(got_npz, mets, student, what):
    np.testing.assert_allclose(
        np.stack([got_npz[f"it{i}/metrics"] for i in range(3)]), mets,
        err_msg=f"{what}: {METRICS}", **TOL)
    have = _final_student(got_npz)
    assert have.keys() == student.keys()
    for k in student:
        np.testing.assert_allclose(have[k], student[k], err_msg=f"{what} {k}",
                                   **TOL)


def test_specialist_runs_the_plans_microbatches(runs):
    _, _, got = runs
    for w in WORLDS:
        for i in range(3):
            active = [int(a) for a in got[w][1][f"it{i}/active"]]
            assert list(got[w][1][f"it{i}/teacher_b_tasks"]) == \
                [f"fwd{a}" for a in active]
        assert len(got[w][1]["it1/active"]) == 0           # all generalist
        assert 0 < len(got[w][1]["it0/active"]) < 4


def test_matches_one_process_runtime(runs):
    _, (mets, student), got = runs
    _assert_close(got[3][2], mets, student, "world 3")


def test_student_dp2_matches_one_process_runtime(runs):
    _, (mets, student), got = runs
    # the case a loss_mask weighting gets wrong: some microbatch holds
    # specialist samples in one student rank's rows more than the other's
    rows = np.concatenate([got[4][2][f"it{i}/domain_rows"] for i in (0, 2)])
    assert rows.shape[1] == 2
    assert np.any((rows.sum(1) > 0) & (rows[:, 0] != rows[:, 1])), rows
    _assert_close(got[4][2], mets, student, "world 4")
    # both student ranks report the same metrics and gather the same state
    np.testing.assert_array_equal(
        np.stack([got[4][3][f"it{i}/metrics"] for i in range(3)]),
        np.stack([got[4][2][f"it{i}/metrics"] for i in range(3)]))


def test_matches_jax_compound_runtime(runs):
    jax_mt, _, got = runs
    want = su.flat(su.tree(jax_mt, "final/student/"))
    for w in WORLDS:
        _assert_close(got[w][2], jax_mt["metrics"], want, f"world {w}")
