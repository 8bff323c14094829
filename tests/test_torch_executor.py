"""Executed-schedule invariants of the port's compound executor
(``repro_torch.core.executor``) with stub section programs on torch
tensors, the semantics of ``tests/test_executor.py``: realized completion
order respects cross-section dependencies; dispatch equals FIFO when
wavefront reordering is disabled; partition_global_batch /
merge_fanout_schedules compose with the executor under dp>1 fanout;
SectionWorker failures stay scoped to the failing task; stream-session
overlap invariants; marked stalls are excluded from utilization.  Plus
the port's own: section devices carved from a list that names one device
once per section."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.executor import (CompoundExecutor, Dispatch,  # noqa: E402
                                       chunk_microbatches, mark_start,
                                       order_global_batch, order_samples)
from repro_torch.core.runtime import SectionWorker  # noqa: E402
from repro_torch.core.simulator import Sample  # noqa: E402


class _Jnp:
    """``jnp.full`` / ``jnp.ones`` of the JAX package's tests, as torch
    tensors."""
    float32 = torch.float32

    @staticmethod
    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype)

    @staticmethod
    def ones(shape, dtype=torch.float32):
        return torch.ones(shape, dtype=dtype)


jnp = _Jnp()


def hetero_samples(n=8):
    """Alternating image/text mix (the MLLM regime): even samples carry
    bc (vision) work, odd samples skip it."""
    return [Sample(i, 0.4 if i % 2 == 0 else 0.0, 1.0, 0.0, 0.0, 2.0,
                   0.8 if i % 2 == 0 else 0.0) for i in range(n)]


# --------------------------------------------------------------------------- #
# Dispatch-order policies
# --------------------------------------------------------------------------- #
def test_order_samples_fifo_is_identity():
    order, sched = order_samples(hetero_samples(), reorder=False)
    assert order == list(range(8))
    assert sched is None


def test_order_samples_wavefront_reorders_and_never_loses():
    s = hetero_samples()
    order, sched = order_samples(s, reorder=True)
    assert sorted(order) == list(range(8))
    assert sched is not None
    assert sched.makespan <= sched.fifo_makespan
    assert order != list(range(8)), \
        "a heterogeneous batch must actually be reordered"


def test_sample_tuples_transitive_upstream():
    """A depth-2 producer chain (adapter → vit → critical) must phase BOTH
    producers as before-critical (bc), not flip the transitive one into
    the after-critical phases."""
    from repro_torch.core.cost_model import sample_tuples
    from repro_torch.core.graph import SectionGraph
    from repro_torch.core.types import (H100, ArchConfig, ParallelConfig,
                                        SectionConfig)

    arch = ArchConfig("t", "dense", 2, 64, 4, 4, 128, 128)
    g = SectionGraph()
    g.add(SectionConfig("adapter", arch, ParallelConfig()))
    g.add(SectionConfig("vit", arch, ParallelConfig()))
    g.add(SectionConfig("llm", arch, ParallelConfig(), critical=True))
    g.connect("adapter", "vit")
    g.connect("vit", "llm")
    g.validate()
    s_on = sample_tuples(g, {"adapter": [True], "vit": [True]}, 64, n=1,
                         hw=H100)[0]
    assert s_on.t_f_ac == 0.0 and s_on.t_b_bc == 0.0
    assert s_on.t_f_bc > 0.0 and s_on.t_b_ac > 0.0
    # adapter alone still lands in bc
    s_ad = sample_tuples(g, {"adapter": [True], "vit": [False]}, 64,
                         n=1, hw=H100)[0]
    assert s_ad.t_f_bc > 0.0 and s_ad.t_f_ac == 0.0
    assert s_ad.t_f_bc < s_on.t_f_bc


def test_chunk_microbatches_contiguous():
    assert chunk_microbatches([3, 1, 0, 2], 2) == [[3, 1], [0, 2]]
    with pytest.raises(AssertionError):
        chunk_microbatches([0, 1, 2], 2)


# --------------------------------------------------------------------------- #
# Realized execution invariants
# --------------------------------------------------------------------------- #
def _producer_consumer_dispatches(ex, order, it="t"):
    q = ex.queue
    disp = []
    for i in order:
        def produce(i=i):
            v = jnp.full((2,), i, jnp.float32)
            q.push("bc", "c", f"{it}/x{i}", v)
            return int(i)
        disp.append(Dispatch("bc", f"p{i}", produce))
    for i in order:
        def consume(i=i):
            v = q.pull("bc", "c", f"{it}/x{i}", timeout=30.0)
            return float(np.asarray(v)[0])
        disp.append(Dispatch("c", f"c{i}", consume))
    return disp


def test_completion_order_respects_cross_section_dependencies():
    with CompoundExecutor(sections=["bc", "c"]) as ex:
        order, _ = order_samples(hetero_samples(), reorder=True)
        res = ex.run(_producer_consumer_dispatches(ex, order))
        ends = {(e.section, e.tag): e.end for e in res.timeline}
        for i in order:
            # the consumer of sample i can only complete after its
            # producer completed (the queue pull is the dependency)
            assert ends[("bc", f"p{i}")] <= ends[("c", f"c{i}")]
        # FIFO workers: realized critical completion order == its
        # dispatch order == the wavefront schedule order
        c_order = [t for s, t in res.completion_order if s == "c"]
        assert c_order == [f"c{i}" for i in order]
        for i in order:
            assert res.results[("c", f"c{i}")] == float(i)
        assert res.makespan > 0.0
        assert 0.0 < res.utilization("c") <= 1.0


def test_fifo_mode_realizes_incoming_order():
    with CompoundExecutor(sections=["bc", "c"]) as ex:
        order, sched = order_samples(hetero_samples(), reorder=False)
        assert sched is None
        res = ex.run(_producer_consumer_dispatches(ex, order, it="f"))
        c_order = [t for s, t in res.completion_order if s == "c"]
        assert c_order == [f"c{i}" for i in range(8)]
        assert res.dispatch_order["c"] == [f"c{i}" for i in range(8)]


def test_fanout_composition_with_executor():
    """partition_global_batch → per-rank Algorithm 1 →
    merge_fanout_schedules, executed: one producer section feeds two
    consumer ranks; realized completion respects every dependency and
    each rank consumes exactly its partition in schedule order."""
    s = hetero_samples(8)
    ranks, merged = order_global_batch(s, dp=2, reorder=True)
    assert sorted(ranks[0] + ranks[1]) == list(range(8))
    assert len(ranks[0]) == len(ranks[1]) == 4       # SPMD-equal counts
    assert sorted(merged) == sorted(
        (r, i) for r in range(2) for i in ranks[r])

    with CompoundExecutor(sections=["vit", "c0", "c1"]) as ex:
        q = ex.queue
        disp = []
        for r, i in merged:
            def produce(r=r, i=i):
                q.push("vit", f"c{r}", f"s{i}",
                       jnp.full((2,), i, jnp.float32))
                return i
            disp.append(Dispatch("vit", f"p{r}.{i}", produce))
        for r in range(2):
            for i in ranks[r]:
                def consume(r=r, i=i):
                    v = q.pull("vit", f"c{r}", f"s{i}", timeout=30.0)
                    return float(np.asarray(v)[0])
                disp.append(Dispatch(f"c{r}", f"c{i}", consume))
        res = ex.run(disp)
        ends = {(e.section, e.tag): e.end for e in res.timeline}
        for r, i in merged:
            assert ends[("vit", f"p{r}.{i}")] <= ends[(f"c{r}", f"c{i}")]
        for r in range(2):
            got = [res.results[(f"c{r}", f"c{i}")] for i in ranks[r]]
            assert got == [float(i) for i in ranks[r]]


def test_utilization_excludes_marked_stalls():
    """A consumer stalling in a blocking pull must read as section IDLE
    (mark_start re-stamps the busy window), otherwise realized
    utilization is ~1.0 no matter how badly the schedule stalls."""
    with CompoundExecutor(sections=["bc", "c"]) as ex:
        q = ex.queue

        def slow_produce():
            time.sleep(0.15)
            q.push("bc", "c", "x", jnp.ones((2,)))
            return True

        def stalled_consume():
            v = q.pull("bc", "c", "x", timeout=10.0)
            mark_start()
            time.sleep(0.02)
            return float(np.asarray(v)[0])

        res = ex.run([Dispatch("bc", "p", slow_produce),
                      Dispatch("c", "c0", lambda: 1),
                      Dispatch("c", "c1", stalled_consume)])
        assert res.utilization("c") < 0.7
        ev = {e.tag: e for e in res.section_events("c")}
        assert ev["c1"].start >= 0.1    # start re-stamped after the pull


def test_fanout_composition_fifo_mode():
    s = hetero_samples(8)
    ranks, merged = order_global_batch(s, dp=2, reorder=False)
    assert ranks == [[0, 1, 2, 3], [4, 5, 6, 7]]
    # round-robin merged producer order over contiguous rank partitions
    assert merged == [(0, 0), (1, 4), (0, 1), (1, 5), (0, 2), (1, 6),
                      (0, 3), (1, 7)]


# --------------------------------------------------------------------------- #
# Worker failure scoping (satellite)
# --------------------------------------------------------------------------- #
def test_worker_error_scoped_to_failing_task():
    w = SectionWorker("s")
    try:
        w.submit("bad", lambda: 1 / 0)
        w.submit("good", lambda: 42)
        with pytest.raises(RuntimeError, match=r"task 'bad'"):
            w.drain(1)
        # a later drain is NOT poisoned by the earlier failure
        assert w.drain(1) == {"good": 42}
    finally:
        w.stop()


def test_executor_raises_on_failing_dispatch():
    with CompoundExecutor(sections=["a"]) as ex:
        with pytest.raises(RuntimeError, match=r"boom"):
            ex.run([Dispatch("a", "boom",
                             lambda: (_ for _ in ()).throw(
                                 ValueError("inner"))),
                    Dispatch("a", "later", lambda: 1)])
        # 'later' completed after the failed drain; its stale result must
        # not satisfy (or pollute) the next run's drain
        res = ex.run([Dispatch("a", "ok", lambda: 7)])
        assert res.results == {("a", "ok"): 7}


def test_stale_task_error_after_abort_is_logged(caplog):
    """Satellite fix: a poisoned task landing after its iteration already
    aborted used to vanish without a trace — it must be logged."""
    import logging

    with CompoundExecutor(sections=["a"]) as ex:
        s = ex.session()

        def late_failure():
            time.sleep(0.2)
            raise ValueError("late-inner")

        with caplog.at_level(logging.WARNING, logger="repro_torch.executor"):
            s.submit(0, [Dispatch("a", "boom",
                                  lambda: (_ for _ in ()).throw(
                                      ValueError("inner"))),
                         Dispatch("a", "late", late_failure)])
            with pytest.raises(RuntimeError, match=r"'boom'"):
                s.retire(0)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and not caplog.records:
                time.sleep(0.01)
        assert any("stale TaskError" in r.getMessage()
                   and "late-inner" in r.getMessage()
                   for r in caplog.records)


# --------------------------------------------------------------------------- #
# Cross-iteration streaming (tentpole)
# --------------------------------------------------------------------------- #
def test_stream_overlap_invariants():
    """With lookahead, section A's fwd(i+1) may start before section B's
    upd(i) ends — but never before A's OWN upd(i) (per-section FIFO)."""
    with CompoundExecutor(sections=["a", "b"]) as ex:
        s = ex.session()

        def work(dt):
            def fn():
                time.sleep(dt)
                return dt
            return fn

        def iteration(i):
            return [Dispatch("a", "fwd", work(0.01)),
                    Dispatch("a", "upd", work(0.01)),
                    Dispatch("b", "fwd", work(0.01)),
                    Dispatch("b", "upd", work(0.3))]   # slow straggler

        s.submit(0, iteration(0))
        s.submit(1, iteration(1))
        assert s.in_flight == 2
        r0 = s.retire(0)
        r1 = s.retire(1)
        assert s.in_flight == 0

        def abs_times(res, section, tag):
            (e,) = [e for e in res.timeline
                    if e.section == section and e.tag == tag]
            return res.t0 + e.start, res.t0 + e.end

        a_upd0_end = abs_times(r0, "a", "upd")[1]
        b_upd0_end = abs_times(r0, "b", "upd")[1]
        a_fwd1_start = abs_times(r1, "a", "fwd")[0]
        # A streams into iteration 1 behind its own update...
        assert a_fwd1_start >= a_upd0_end
        # ...without waiting for B's straggling update (the old barrier)
        assert a_fwd1_start < b_upd0_end


def test_stream_serialized_depth_matches_run_completion_order():
    """Submit-then-retire one iteration at a time (lookahead depth 0)
    must realize exactly the per-section completion order of the old
    barriered CompoundExecutor.run on the same dispatch list."""
    order, _ = order_samples(hetero_samples(), reorder=True)

    def per_section(res):
        return {s: [t for sec, t in res.completion_order if sec == s]
                for s in ("bc", "c")}

    with CompoundExecutor(sections=["bc", "c"]) as ex:
        barriered = per_section(
            ex.run(_producer_consumer_dispatches(ex, order, it="r")))
    with CompoundExecutor(sections=["bc", "c"]) as ex:
        s = ex.session()
        s.submit(0, _producer_consumer_dispatches(ex, order, it="s"))
        res = s.retire(0)
        assert per_section(res) == barriered
        for i in order:
            assert res.results[("c", f"c{i}")] == float(i)


def test_stream_iteration_indices_must_increase():
    with CompoundExecutor(sections=["a"]) as ex:
        s = ex.session()
        s.submit(3, [Dispatch("a", "t", lambda: 1)])
        with pytest.raises(AssertionError, match=r"strictly increasing"):
            s.submit(3, [Dispatch("a", "t", lambda: 1)])
        s.retire(3)


# --------------------------------------------------------------------------- #
# Section devices (the port's): one device named once per section
# --------------------------------------------------------------------------- #
def test_carve_sections_shares_one_device_and_names_how():
    from repro_torch.configs import get_reduced
    from repro_torch.core.graph import build_distill_graph
    from repro_torch.core.runtime import MaestroRuntime, carve_sections
    from repro_torch.core.types import ParallelConfig

    cfg = get_reduced("qwen1.5-0.5b")
    g = build_distill_graph(cfg, cfg)
    devs = carve_sections(g, ["cpu", "cpu"])
    assert devs == {"teacher": torch.device("cpu"),
                    "student": torch.device("cpu")}
    with pytest.raises(ValueError, match=r"section 'student'.*"
                       r"once per section"):
        carve_sections(g, ["cpu"])
    wide = build_distill_graph(cfg, cfg, fanout=2,
                               student_parallel=ParallelConfig(dp=2))
    with pytest.raises(NotImplementedError, match=r"section 'student'.*A6"):
        carve_sections(wide, ["cpu"] * 3)
    with MaestroRuntime(g, ["cpu", "cpu"]) as rt:
        assert rt.device("teacher") == torch.device("cpu")
        # host sections have no CUDA stream
        assert all(w.stream is None for w in rt.workers.values())
        with pytest.raises(NotImplementedError, match="A6"):
            rt.build_train_step("student", None, None)
