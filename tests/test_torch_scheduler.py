"""The port's planning layer against the JAX package's: the section graph,
the makespan simulator, the wavefront scheduler (Algorithm 1) and the
cost model's per-sample 6-tuples.

Both sides are pure Python on the same floats, so orders, schedules and
makespans must be identical, not close.  The cost model is handed the
same ``HardwareSpec`` values on both sides (the port has no TPU default).
The port's fast scheduler also keeps the divergence contract against its
own ``wavefront_schedule_reference`` (``tests/test_scheduler_fast.py``).
"""
import dataclasses
import random

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.configs as jcfgs  # noqa: E402
from repro.configs import compound as jcomp  # noqa: E402
from repro.core import cost_model as jcost  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core.types import HardwareSpec as JHardwareSpec  # noqa: E402
from repro.core.types import ParallelConfig as JParallel  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.configs import compound as tcomp  # noqa: E402
from repro_torch.core import cost_model as tcost  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core.types import H100, HardwareSpec  # noqa: E402
from repro_torch.core.types import ParallelConfig as TParallel  # noqa: E402

# the port's H100 and the JAX package's TPU v5e, each on both sides
J_H100 = JHardwareSpec(name=H100.name, peak_flops_bf16=H100.peak_flops_bf16,
                       hbm_bandwidth=H100.hbm_bandwidth,
                       ici_bandwidth=H100.ici_bandwidth,
                       hbm_bytes=H100.hbm_bytes)
T_V5E = HardwareSpec(name=jcost.V5E.name,
                     peak_flops_bf16=jcost.V5E.peak_flops_bf16,
                     hbm_bandwidth=jcost.V5E.hbm_bandwidth,
                     ici_bandwidth=jcost.V5E.ici_bandwidth,
                     hbm_bytes=jcost.V5E.hbm_bytes)
HW_PAIRS = [(H100, J_H100), (T_V5E, jcost.V5E)]


def _pair(seed, n, general=False):
    """The same random 6-tuples as a port and a JAX ``Sample`` list."""
    rng = random.Random(seed)
    rows = []
    for i in range(n):
        if general:
            t = [rng.choice([0.0, round(rng.uniform(0, 3), 3)])
                 for _ in range(6)]
        elif rng.random() < 0.4:
            t = [0.5 * (0.5 + rng.random()), 1.0, 0, 0, 2.0,
                 1.0 * (0.5 + rng.random())]
        else:
            t = [0, 1.0, 0, 0, 2.0, 0]
        rows.append(t)
    return ([tsim.Sample(i, *t) for i, t in enumerate(rows)],
            [jsim.Sample(i, *t) for i, t in enumerate(rows)])


def _idx(order):
    return [s.idx for s in order]


def _graph_view(g):
    secs = {n: (s.arch.name, s.trainable, s.critical, s.seq_scale,
                (s.parallel.dp, s.parallel.tp, s.parallel.pp, s.parallel.cp))
            for n, s in g.sections.items()}
    edges = [(e.src, e.dst, e.hidden_handoff, e.bytes_per_token, e.fanout)
             for e in g.edges]
    return secs, edges


# --------------------------------------------------------------------------- #
# configs, graphs, parameter counts
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", tcfgs.ARCH_NAMES)
def test_param_counts_match(name):
    t, j = tcfgs.get_config(name), jcfgs.get_config(name)
    assert t.total_params() == j.total_params()
    assert t.active_params() == j.active_params()
    assert [t.layer_params(i) for i in range(t.num_layers)] == \
        [j.layer_params(i) for i in range(j.num_layers)]


@pytest.mark.parametrize("entry", sorted(tcomp.COMPOUND))
def test_compound_graphs_match(entry):
    assert set(tcomp.COMPOUND) == set(jcomp.COMPOUND)
    t, j = tcomp.COMPOUND[entry](), jcomp.COMPOUND[entry]()
    assert _graph_view(t) == _graph_view(j)
    assert t.critical.name == j.critical.name


def test_distill_graph_fanout_and_validation():
    cfg_t, cfg_j = tcfgs.get_reduced("qwen1.5-0.5b"), \
        jcfgs.get_reduced("qwen1.5-0.5b")
    t = tgraph.build_distill_graph(cfg_t, cfg_t, fanout=2,
                                   student_parallel=TParallel(dp=2))
    j = jgraph.build_distill_graph(cfg_j, cfg_j, fanout=2,
                                   student_parallel=JParallel(dp=2))
    assert _graph_view(t) == _graph_view(j)
    with pytest.raises(AssertionError, match="critical"):
        tgraph.SectionGraph().add(t.sections["teacher"]).validate()


# --------------------------------------------------------------------------- #
# simulator
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(6))
def test_simulator_identical(seed):
    ts, js = _pair(seed, 3 + seed * 2, general=True)
    a = tsim.simulate(ts, collect_timeline=True)
    b = jsim.simulate(js, collect_timeline=True)
    assert (a.makespan, a.critical_busy, a.critical_idle,
            a.resource_busy, a.timeline) == \
        (b.makespan, b.critical_busy, b.critical_idle, b.resource_busy,
         b.timeline)
    assert a.critical_utilization == b.critical_utilization
    ranks_t = [ts[i::2] for i in range(2)]
    ranks_j = [js[i::2] for i in range(2)]
    fa = tsim.simulate_fanout(ranks_t, collect_timeline=True)
    fb = jsim.simulate_fanout(ranks_j, collect_timeline=True)
    assert (fa.makespan, fa.resource_busy, fa.timeline) == \
        (fb.makespan, fb.resource_busy, fb.timeline)


# --------------------------------------------------------------------------- #
# Algorithm 1 and the DP-level mechanisms
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n,seed", [(1, 0), (8, 1), (12, 2), (16, 3),
                                    (24, 4)])
def test_wavefront_identical_to_jax(n, seed):
    ts, js = _pair(seed, n)
    for fast_t, fast_j in ((tsched.wavefront_schedule,
                            jsched.wavefront_schedule),
                           (tsched.wavefront_schedule_reference,
                            jsched.wavefront_schedule_reference)):
        a, b = fast_t(ts), fast_j(js)
        assert _idx(a.order) == _idx(b.order)
        assert (a.makespan, a.fifo_makespan) == (b.makespan, b.fifo_makespan)
        assert a.improvement == b.improvement


def test_wavefront_identical_on_general_tuples():
    for seed in range(20):
        ts, js = _pair(100 + seed, 1 + seed % 9, general=True)
        a, b = tsched.wavefront_schedule(ts), jsched.wavefront_schedule(js)
        assert _idx(a.order) == _idx(b.order), seed
        assert a.makespan == b.makespan


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_global_batch_schedule_identical(dp):
    ts, js = _pair(7, 16)
    pa = tsched.partition_global_batch(ts, dp)
    pb = jsched.partition_global_batch(js, dp)
    assert [_idx(r) for r in pa] == [_idx(r) for r in pb]
    sa, ma = tsched.schedule_global_batch(ts, dp)
    sb, mb = jsched.schedule_global_batch(js, dp)
    assert [_idx(r) for r in sa] == [_idx(r) for r in sb]
    assert [(r, s.idx) for r, s in ma] == [(r, s.idx) for r, s in mb]
    assert [(r, s.idx) for r, s in tsched.merge_fanout_schedules(pa)] == \
        [(r, s.idx) for r, s in jsched.merge_fanout_schedules(pb)]


# the divergence contract of tests/test_scheduler_fast.py, on the port
def _mk_samples(n, ratio, vf, vb, seed=0):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        if rng.random() < ratio:
            out.append(tsim.Sample(i, vf * (0.5 + rng.random()), 1.0, 0, 0,
                                   2.0, vb * (0.5 + rng.random())))
        else:
            out.append(tsim.Sample(i, 0, 1.0, 0, 0, 2.0, 0))
    return out


def test_port_greedy_makespan_matches_port_simulator():
    for seed in range(60):
        ts, _ = _pair(1000 + seed, random.Random(seed).randint(1, 14),
                      general=True)
        assert tsched._greedy_makespan([s.tuple6 for s in ts]) == \
            tsim.simulate(ts).makespan, seed


def test_port_fast_schedule_bit_identical_to_port_reference():
    for n, seed in [(1, 0), (8, 1), (12, 2), (16, 3), (24, 4)]:
        for ratio in (0.0, 0.3, 0.75):
            s = _mk_samples(n, ratio, 0.5, 1.0, seed)
            fast = tsched.wavefront_schedule(s)
            ref = tsched.wavefront_schedule_reference(s)
            assert _idx(fast.order) == _idx(ref.order), (n, seed, ratio)
            assert fast.makespan == ref.makespan
            assert fast.fifo_makespan == ref.fifo_makespan


def test_port_adversarial_float_ties_keep_divergence_contract():
    for seed in range(6):
        rng = random.Random(7000 + seed)
        soup = [0.1, 0.2, 0.3, 0.7, 0.1 + 0.2, 1.0 - 0.7]
        n = rng.randint(6, 14)
        s = [tsim.Sample(i, *[rng.choice(soup + [0.0]) for _ in range(6)])
             for i in range(n)]
        for fn in (tsched.wavefront_schedule,
                   tsched.wavefront_schedule_reference):
            r = fn(s)
            assert sorted(_idx(r.order)) == list(range(n))
            assert tsim.simulate(r.order).makespan == r.makespan
            assert r.makespan <= r.fifo_makespan
        assert tsched.wavefront_schedule(s).fifo_makespan == \
            tsched.wavefront_schedule_reference(s).fifo_makespan


# --------------------------------------------------------------------------- #
# cost model: sample 6-tuples for the scheduler
# --------------------------------------------------------------------------- #
def _flags(n, names, seed):
    rng = np.random.default_rng(seed)
    return {name: rng.random(n) < 0.4 for name in names}


@pytest.mark.parametrize("entry", ["distill_compound",
                                   "self_distill_compound"])
@pytest.mark.parametrize("hw", [0, 1], ids=["h100", "v5e"])
def test_sample_tuples_identical(entry, hw):
    t_hw, j_hw = HW_PAIRS[hw]
    tg, jg = tcomp.COMPOUND[entry](), jcomp.COMPOUND[entry]()
    for seed, seq in ((0, 4096), (1, 1024)):
        flags = _flags(16, ["teacher"], seed)
        a = tcost.sample_tuples(tg, flags, seq, n=16, hw=t_hw)
        b = jcost.sample_tuples(jg, flags, seq, n=16, hw=j_hw)
        assert [tuple(x) for x in a] == [tuple(x) for x in b]
        ta = tsched.wavefront_schedule(a)
        tb = jsched.wavefront_schedule(b)
        assert _idx(ta.order) == _idx(tb.order)
        assert (ta.makespan, ta.fifo_makespan) == \
            (tb.makespan, tb.fifo_makespan)


def test_section_cost_and_memory_identical():
    for name in ("qwen1.5-0.5b", "granite-3-8b", "mixtral-8x22b",
                 "mamba2-130m"):
        t, j = tcfgs.get_config(name), jcfgs.get_config(name)
        for tpar, jpar in ((TParallel(), JParallel()),
                           (TParallel(tp=4, mbs=2), JParallel(tp=4, mbs=2)),
                           (TParallel(pp=2, dp=2), JParallel(pp=2, dp=2))):
            for trainable in (True, False):
                a = tcost.section_cost(t, tpar, 2048, trainable=trainable,
                                       hw=H100)
                b = jcost.section_cost(j, jpar, 2048, trainable=trainable,
                                       hw=J_H100)
                assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_port_cost_model_has_no_default_device():
    cfg = tcfgs.get_reduced("qwen1.5-0.5b")
    with pytest.raises(TypeError, match="hw"):
        tcost.microbatch_time(cfg, TParallel(), 64, forward_only=True)
