"""Routed multi-teacher distillation on the port's CompoundRuntime
(``repro_torch.distill.multi_teacher``), on the CPU in float32.

The reduced configs of ``tests/drivers/driver_multi_teacher.py`` (a
generalist teacher, a specialist teacher of another width, a student),
dp = 1 per section, ``AdamWConfig(clip_norm=0.0)`` as there, batch 16 x 32
in microbatches of 4, three iterations (the second with an all-generalist
batch, on which the specialist never runs):

* against the JAX ``CompoundRuntime`` on three virtual devices, run in a
  subprocess of this file (``python tests/test_torch_multi_teacher.py
  --jax-oracle out.npz``).  The port is given the JAX run's initial params
  and each iteration's ``IterationPlan`` (order and activation), so both
  compose the same microbatches: loss, ce, KL_a, KL_b and grad norm per
  iteration and the student params after 3 iterations within
  atol = rtol = 2e-4 (``tests/test_torch_distill.py``'s tolerance for 3
  colocated steps);
* against the port's own colocated oracle on ``colocated_batch(batch,
  plan)``: bitwise (deterministic kernels; see ``test_torch_compound.py``);
* ``teacher_b`` is dispatched exactly on the plan's active microbatches.
"""
import os
import sys
import threading

if __name__ == "__main__":
    # the JAX oracle: three virtual CPU devices, set before JAX is imported
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=3"

from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import repro_torch.core.workload as wl  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import section_params_from_numpy  # noqa: E402
from repro_torch.core.types import ParallelConfig  # noqa: E402
from repro_torch.data.synthetic import routed_lm_batches  # noqa: E402
from repro_torch.distill import multi_teacher as mt  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_compound import (TOL, _flatten, _np, load_tree,  # noqa: E402
                                 run_oracle, save_tree)

B, S, MBS, VOCAB, ITERS = 16, 32, 4, 256, 3
GENERALIST_ONLY = 1          # the iteration whose batch has no specialist
METRICS = ("loss", "ce", "kl_a", "kl_b", "grad_norm")
SECTIONS = ("teacher_a", "teacher_b", "student")


def _cfgs(reduced):
    """The reduced configs of tests/drivers/driver_multi_teacher.py."""
    ta = reduced("qwen2.5-32b").replace(dtype="float32", vocab_size=VOCAB)
    tb = reduced("granite-3-8b").replace(dtype="float32", vocab_size=VOCAB,
                                         d_model=64, head_dim=16, d_ff=128)
    st = reduced("qwen1.5-0.5b").replace(dtype="float32", vocab_size=VOCAB)
    return ta, tb, st


def _batches(gen):
    out = []
    for i in range(ITERS):
        b = dict(next(gen))
        if i == GENERALIST_ONLY:
            b["domain"] = b["domain"] * 0
        out.append(b)
    return out


def jax_multi_teacher_oracle(path: str) -> None:
    """Three iterations of the JAX CompoundRuntime(multi_teacher_spec)."""
    import jax
    from repro.configs import get_reduced as jreduced
    from repro.core import workload as jwl
    from repro.core.types import ParallelConfig as JParallel
    from repro.data.synthetic import routed_lm_batches as jrouted
    from repro.distill import multi_teacher as jmt
    from repro.optim import adamw as jadamw

    assert len(jax.devices()) == 3, jax.devices()
    ta, tb, st = _cfgs(jreduced)
    spec = jmt.multi_teacher_spec(
        ta, tb, st, ta_parallel=JParallel(), tb_parallel=JParallel(),
        s_parallel=JParallel(), global_batch=B, seq_len=S, mbs=MBS,
        impl="ref")
    rt = jwl.CompoundRuntime(spec, impl="ref",
                             opt_cfg=jadamw.AdamWConfig(clip_norm=0.0))
    # On one-device section meshes the JAX runtime traces a producer's
    # jit again on its worker thread at the first call, and the trace
    # reads the process-global activation hook that another section's
    # concurrent trace may have set: under load the two teachers' traces
    # can mix meshes and fail (ROADMAP.md, C6).  A lock around each
    # producer's jitted call keeps traces one at a time; nothing inside it
    # waits on the queue, and the arithmetic is the runtime's own.
    lock = threading.Lock()

    def one_at_a_time(fn):
        def call(*args):
            with lock:
                return fn(*args)
        return call

    rt._fwd = {k: one_at_a_time(f) for k, f in rt._fwd.items()}
    params, opts = rt.init(jax.random.PRNGKey(0))
    out = {}
    for n in SECTIONS:
        save_tree(out, params[n], f"init/{n}")
    smesh = rt.rt.mesh("student")
    consts = {"student": {"w_a": jmt.teacher_unembed(params["teacher_a"], ta,
                                                     smesh),
                          "w_b": jmt.teacher_unembed(params["teacher_b"], tb,
                                                     smesh)}}
    mets = []
    for i, batch in enumerate(_batches(jrouted(
            batch=B, seq_len=S, vocab=VOCAB, specialist_ratio=0.4,
            seed=0))):
        host = {k: np.asarray(v) for k, v in batch.items()}
        plan = rt.plan_iteration(host, reorder=True)
        act = plan.activation["teacher_b"]
        out[f"tokens{i}"] = host["tokens"]
        out[f"domain{i}"] = host["domain"]
        out[f"order{i}"] = np.asarray(plan.order)
        out[f"active{i}"] = np.asarray(act.active_mbs, np.int64)
        out[f"idx{i}"], out[f"valid{i}"] = act.idx, act.valid
        params, opts, m = rt.train_iteration(params, opts, batch, i,
                                             plan=plan, consts=consts)
        out[f"tb_tasks{i}"] = np.asarray(
            m["execution"].task_counts.get("teacher_b", 0))
        mets.append([float(m[k]) for k in METRICS])
    out["metrics"] = np.asarray(mets, np.float64)
    save_tree(out, params["student"], "final/student")
    rt.shutdown()
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_mt(tmp_path_factory):
    return run_oracle(Path(__file__), tmp_path_factory.mktemp("jax_mt"))


def _plan(npz, i) -> wl.IterationPlan:
    act = wl.SectionActivation(tuple(int(x) for x in npz[f"active{i}"]),
                               npz[f"idx{i}"], npz[f"valid{i}"])
    return wl.IterationPlan(tuple(int(x) for x in npz[f"order{i}"]), MBS,
                            B // MBS, {"teacher_b": act})


def test_multi_teacher_matches_jax_and_colocated_oracle(jax_mt):
    ta, tb, st = _cfgs(get_reduced)
    batches = _batches(routed_lm_batches(batch=B, seq_len=S, vocab=VOCAB,
                                         specialist_ratio=0.4, seed=0,
                                         device="cpu"))
    for i, b in enumerate(batches):          # the same data on both sides
        np.testing.assert_array_equal(b["tokens"].numpy(), jax_mt[f"tokens{i}"])
        np.testing.assert_array_equal(b["domain"].numpy(), jax_mt[f"domain{i}"])
    assert 0 < batches[0]["domain"].sum() < B
    opt_cfg = adamw.AdamWConfig(clip_norm=0.0)
    spec = mt.multi_teacher_spec(
        ta, tb, st, ta_parallel=ParallelConfig(), tb_parallel=ParallelConfig(),
        s_parallel=ParallelConfig(), global_batch=B, seq_len=S, mbs=MBS)
    cpu = torch.device("cpu")
    init = section_params_from_numpy(
        {n: load_tree(jax_mt, f"init/{n}") for n in SECTIONS},
        {n: cpu for n in SECTIONS})
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with wl.CompoundRuntime(spec, devices=["cpu"] * 3,
                                opt_cfg=opt_cfg) as rt:
            params, opts = rt.place({n: tree_map(torch.clone, init[n])
                                     for n in SECTIONS})
            consts = {"student": {
                "w_a": mt.teacher_unembed(params["teacher_a"], ta, cpu),
                "w_b": mt.teacher_unembed(params["teacher_b"], tb, cpu)}}
            got, plans, fifo_active = [], [], []
            for i, b in enumerate(batches):
                plan = _plan(jax_mt, i)
                fifo = rt.plan_iteration(b, reorder=False)
                assert fifo.order == tuple(range(B))
                fifo_active.append(len(fifo.activation["teacher_b"]
                                       .active_mbs))
                params, opts, m = rt.train_iteration(params, opts, b, i,
                                                     plan=plan,
                                                     consts=consts)
                n_b = len(plan.activation["teacher_b"].active_mbs)
                assert m["n_tasks"].get("teacher_b", 0) == n_b == \
                    int(jax_mt[f"tb_tasks{i}"])
                assert m["n_tasks"]["teacher_a"] == B // MBS
                assert n_b <= fifo_active[-1]
                ends = {(e.section, e.tag): e.end
                        for e in m["execution"].timeline}
                for j in plan.activation["teacher_b"].active_mbs:
                    assert ends[("teacher_b", f"fwd{j}")] <= \
                        ends[("student", f"mb{j}")]
                got.append(m)
                plans.append(plan)
            assert len(plans[GENERALIST_ONLY].activation["teacher_b"]
                       .active_mbs) == 0
            assert float(got[GENERALIST_ONLY]["kl_b"]) == 0.0

        # ---- against the JAX runtime -------------------------------- #
        np.testing.assert_allclose(
            np.asarray([[float(m[k]) for k in METRICS] for m in got]),
            jax_mt["metrics"], **TOL)
        want = _flatten(load_tree(jax_mt, "final/student"), "")
        have = _flatten(params["student"], "")
        assert have.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(_np(have[k]),
                                       np.asarray(want[k], np.float32),
                                       err_msg=k, **TOL)

        # ---- against the port's colocated oracle, bitwise ----------- #
        step = mt.build_colocated_step(ta, tb, st, opt_cfg=opt_cfg)
        ps = tree_map(torch.clone, init["student"])
        os_ = adamw.init(ps)
        for i, b in enumerate(batches):
            ps, os_, om = step(ps, os_, init["teacher_a"],
                               init["teacher_b"], consts["student"]["w_a"],
                               consts["student"]["w_b"],
                               mt.colocated_batch(b, plans[i]), i)
            assert torch.equal(om["loss"], got[i]["loss"]), i
            assert torch.equal(om["grad_norm"], got[i]["grad_norm"]), i
        for a, c in zip(tree_leaves(ps), tree_leaves(params["student"])):
            assert torch.equal(a, c)
    finally:
        torch.use_deterministic_algorithms(was)


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    jax_multi_teacher_oracle(sys.argv[2])
