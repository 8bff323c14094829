"""Spec-compile-time guarantees of the port's declarative workload API
(``repro_torch.core.workload``) against the JAX package's.

Every spec-compile case of ``tests/test_workload.py`` is built on both
sides from the same declaration and must raise the same exception type
with the same message (section and port names included), or pass on both.
The per-section parallelism cases need pipeline or context parallelism
or a carved mesh, which the port does not run yet: on the port each
raises ``NotImplementedError`` naming the section, the mesh axis and
ROADMAP.md's A6.  ``build_activation`` must give equal arrays, and the
dispatch-graph deadlock pass the same findings (severity, check, subject,
message), including on specs that deadlock.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.workload as jwl  # noqa: E402
from repro.analysis import deadlock as jdl  # noqa: E402
from repro.configs import get_reduced as jreduced  # noqa: E402
from repro.core.types import ParallelConfig as JParallel  # noqa: E402
import repro_torch.core.workload as twl  # noqa: E402
from repro_torch.analysis import core as tcore  # noqa: E402
from repro_torch.analysis import deadlock as tdl  # noqa: E402
from repro_torch.configs import get_reduced as treduced  # noqa: E402
from repro_torch.core.types import ParallelConfig as TParallel  # noqa: E402

SIDES = {"jax": (jwl, JParallel, jreduced), "port": (twl, TParallel,
                                                     treduced)}


def _cfg(side):
    return SIDES[side][2]("qwen1.5-0.5b").replace(
        dtype="float32", num_layers=2, vocab_size=64, d_ff=128)


def _producer(side, name="prod", port=None, mode="fwd_only", consumes=(),
              **kw):
    wl, P, _ = SIDES[side]
    port = port or wl.Port("h", (wl.SEQ, 16), "float32")
    return wl.SectionSpec(
        name, _cfg(side), P(),
        fn=lambda p, x: {"h": x["tokens"]}, params={},
        inputs={"tokens": wl.Field((wl.SEQ,), "int32")},
        emits=(port,), mode=mode, consumes=tuple(consumes), **kw)


def _loss(side, consumes=(), name="crit", **kw):
    wl, P, _ = SIDES[side]
    return wl.SectionSpec(
        name, _cfg(side), P(),
        fn=lambda p, x: 0.0, params={},
        inputs={"tokens": wl.Field((wl.SEQ,), "int32")},
        consumes=tuple(consumes), loss=True, critical=True, **kw)


def _spec(side, *sections):
    return SIDES[side][0].WorkloadSpec("t", tuple(sections), seq_len=8,
                                       global_batch=4, mbs=2)


# --------------------------------------------------------------------------- #
# the spec-compile cases of tests/test_workload.py:47-151, one builder each
# --------------------------------------------------------------------------- #
def valid_spec(side):
    wl = SIDES[side][0]
    port = wl.Port("h", (wl.SEQ, 16), "float32")
    return _spec(side, _producer(side, port=port),
                 _loss(side, consumes=[wl.Consume("prod", port)]))


def port_shape_mismatch(side):
    wl = SIDES[side][0]
    emit = wl.Port("h", (wl.SEQ, 16), "float32")
    expect = wl.Port("h", (wl.SEQ, 32), "float32")
    return _spec(side, _producer(side, port=emit),
                 _loss(side, consumes=[wl.Consume("prod", expect)]))


def port_dtype_mismatch(side):
    wl = SIDES[side][0]
    emit = wl.Port("h", (wl.SEQ, 16), "float32")
    expect = wl.Port("h", (wl.SEQ, 16), "bfloat16")
    return _spec(side, _producer(side, port=emit),
                 _loss(side, consumes=[wl.Consume("prod", expect)]))


def unknown_port(side):
    wl = SIDES[side][0]
    return _spec(side, _producer(side),
                 _loss(side, consumes=[wl.Consume(
                     "prod", wl.Port("nope", (4,), "float32"))]))


def unknown_section(side):
    wl = SIDES[side][0]
    return _spec(side, _producer(side),
                 _loss(side, consumes=[wl.Consume(
                     "ghost", wl.Port("h", (wl.SEQ, 16), "float32"))]))


def no_critical(side):
    return _spec(side, _producer(side))


def critical_with_activation(side):
    return _spec(side, _producer(side),
                 _loss(side, activation=lambda b: b["flag"]))


def fwd_only_loss(side):
    wl, P, _ = SIDES[side]
    bad = wl.SectionSpec(
        "crit", _cfg(side), P(), fn=lambda p, x: 0.0, params={},
        loss=True, critical=True, mode="fwd_only")
    return _spec(side, _producer(side), bad)


def trainable_port_fanout(side):
    return _spec(side, _producer(side, mode="fwd_bwd"), _loss(side))


def trainable_port_into_fwd_only(side):
    wl = SIDES[side][0]
    pa = wl.Port("a", (wl.SEQ, 16), "float32")
    pb = wl.Port("b", (wl.SEQ, 16), "float32")
    prod = _producer(side, "prod", port=pa, mode="fwd_bwd")
    mid = _producer(side, "mid", port=pb,
                    consumes=[wl.Consume("prod", pa)])
    return _spec(side, prod, mid,
                 _loss(side, consumes=[wl.Consume("mid", pb)]))


def cycle(side):
    wl = SIDES[side][0]
    pa = wl.Port("a", (4,), "float32")
    pb = wl.Port("b", (4,), "float32")
    s1 = _producer(side, "s1", port=pa, consumes=[wl.Consume("s2", pb)])
    s2 = _producer(side, "s2", port=pb, consumes=[wl.Consume("s1", pa)])
    return _spec(side, s1, s2, _loss(side))


def duplicate_sections(side):
    return _spec(side, _producer(side), _producer(side), _loss(side))


def non_loss_without_emits(side):
    wl, P, _ = SIDES[side]
    mute = wl.SectionSpec("mute", _cfg(side), P(), fn=lambda p, x: {},
                          params={}, mode="fwd_only")
    return _spec(side, mute, _loss(side))


def batch_not_multiple_of_mbs(side):
    wl = SIDES[side][0]
    port = wl.Port("h", (wl.SEQ, 16), "float32")
    return wl.WorkloadSpec(
        "t", (_producer(side, port=port),
              _loss(side, consumes=[wl.Consume("prod", port)])),
        seq_len=8, global_batch=5, mbs=2)


CASES = [valid_spec, port_shape_mismatch, port_dtype_mismatch, unknown_port,
         unknown_section, no_critical, critical_with_activation,
         fwd_only_loss, trainable_port_fanout, trainable_port_into_fwd_only,
         cycle, duplicate_sections, non_loss_without_emits,
         batch_not_multiple_of_mbs]


def _outcome(spec):
    try:
        spec.validate()
    except Exception as e:                   # compared across packages
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_spec_compile_matches_jax(case):
    want, got = _outcome(case("jax")), _outcome(case("port"))
    assert got == want
    if case is not valid_spec:
        assert got is not None and got[0] == "ValueError"


def test_to_graph_edges_and_seq_scale_match():
    graphs = {}
    for side in SIDES:
        wl = SIDES[side][0]
        port = wl.Port("h", (wl.SEQ, 16), "float32")
        prod = _producer(side, port=port, seq_len=32)
        g = _spec(side, prod, _loss(side, consumes=[
            wl.Consume("prod", port)])).to_graph()
        graphs[side] = (
            {n: (s.trainable, s.critical, s.seq_scale)
             for n, s in g.sections.items()},
            [(e.src, e.dst, e.bytes_per_token, e.fanout) for e in g.edges])
    assert graphs["port"] == graphs["jax"]
    assert graphs["port"][0]["prod"][2] == 32 / 8
    assert graphs["port"][1] == [("prod", "crit", 16 * 4, 1)]


# --------------------------------------------------------------------------- #
# per-section parallelism (tests/test_workload.py:166-200): A6 on the port
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name,arch,par,axis", [
    ("vit", "qwen1.5-0.5b", dict(pp=2), "pipe"),
    ("vit", "qwen1.5-0.5b", dict(cp=2), "seq"),
    ("ssm", "mamba2-130m", dict(cp=2), "seq"),
    ("llm", "qwen1.5-0.5b", dict(dp=2, tp=2), "model"),
])
def test_section_parallel_raises_naming_section_axis_and_a6(name, arch, par,
                                                           axis):
    cfg = treduced(arch).replace(dtype="float32")
    with pytest.raises(NotImplementedError,
                       match=rf"section '{name}'.*'{axis}'.*A6"):
        twl.validate_section_parallel(name, cfg, TParallel(**par))


def test_section_grad_compress_raises_a6_and_plain_passes():
    cfg = treduced("qwen1.5-0.5b")
    with pytest.raises(NotImplementedError, match=r"section 'lm'.*A6"):
        twl.validate_section_parallel("lm", cfg,
                                      TParallel(grad_compress="int8"))
    assert twl.validate_section_parallel("lm", cfg, TParallel()) == "plain"


def test_runtime_rejects_a_multi_device_section_before_carving():
    wl = twl
    port = wl.Port("h", (wl.SEQ, 16), "float32")
    prod = wl.SectionSpec(
        "prod", _cfg("port"), TParallel(cp=2),
        fn=lambda p, x: {"h": x["tokens"]}, params={},
        inputs={"tokens": wl.Field((wl.SEQ,), "int32")},
        emits=(port,), mode="fwd_only")
    spec = _spec("port", prod, _loss("port", consumes=[
        wl.Consume("prod", port)]))
    with pytest.raises(NotImplementedError, match=r"section 'prod'.*A6"):
        twl.CompoundRuntime(spec, devices=["cpu"])


# --------------------------------------------------------------------------- #
# activation layouts
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("order,flags,mbs", [
    (list(range(8)), [1, 0, 0, 1, 1, 0, 0, 0], 4),
    (list(range(8)), [1, 0, 0, 0, 1, 0, 0, 0], 4),
    ([0, 4, 1, 2, 3, 5, 6, 7], [1, 0, 0, 0, 1, 0, 0, 0], 4),
    (list(range(4)), [0, 0, 0, 0], 2),
    ([5, 2, 7, 0, 1, 3, 6, 4], [0, 1, 1, 0, 1, 0, 1, 1], 2),
])
def test_build_activation_matches_jax(order, flags, mbs):
    f = np.asarray(flags, bool)
    a = twl.build_activation(order, f, mbs)
    b = jwl.build_activation(order, f, mbs)
    assert a.active_mbs == b.active_mbs
    np.testing.assert_array_equal(a.idx, b.idx)
    np.testing.assert_array_equal(a.valid, b.valid)
    assert a.idx.dtype == b.idx.dtype and a.valid.dtype == b.valid.dtype


@pytest.mark.parametrize("name", ["vit", "llm", "absent"])
def test_iteration_plan_section_matches_jax(name):
    """``IterationPlan.section``: the named section's activation layout,
    None for a section without a predicate, on both sides."""
    order, flags, mbs = [5, 2, 7, 0, 1, 3, 6, 4], [0, 1, 1, 0, 1, 0, 1, 1], 2
    f = np.asarray(flags, bool)
    plans = [wl.IterationPlan(tuple(order), mbs, len(order) // mbs,
                              {"vit": wl.build_activation(order, f, mbs),
                               "llm": None} if name != "absent" else {})
             for wl in (twl, jwl)]
    a, b = (p.section(name) for p in plans)
    assert (a is None) == (b is None)
    if a is not None:
        assert a.active_mbs == b.active_mbs
        np.testing.assert_array_equal(a.idx, b.idx)
        np.testing.assert_array_equal(a.valid, b.valid)


def test_all_configs_matches_jax():
    """``configs.all_configs``: every arch's full config, by name in
    ``ARCH_NAMES`` order, field for field the reference's."""
    import dataclasses

    from repro.configs import all_configs as jall
    from repro_torch.configs import all_configs as tall
    a, b = tall(), jall()
    assert list(a) == list(b)
    for n in a:
        assert dataclasses.asdict(a[n]) == dataclasses.asdict(b[n]), n


# --------------------------------------------------------------------------- #
# the deadlock pass
# --------------------------------------------------------------------------- #
def cyclic_producers(side):
    wl = SIDES[side][0]
    pa = wl.Port("h", (wl.SEQ, 16), "float32")
    pb = wl.Port("g", (wl.SEQ, 16), "float32")
    a = _producer(side, "a", port=pa, consumes=[wl.Consume("b", pb)])
    b = _producer(side, "b", port=pb, consumes=[wl.Consume("a", pa)])
    return _spec(side, a, b, _loss(side, consumes=[wl.Consume("a", pa)]))


def unsatisfied_cotangent(side):
    wl = SIDES[side][0]
    ph = wl.Port("h", (wl.SEQ, 16), "float32")
    pg = wl.Port("g", (wl.SEQ, 16), "float32")
    prod = _producer(side, "prod", port=ph, mode="fwd_bwd")
    mid = _producer(side, "mid", port=pg, consumes=[wl.Consume("prod", ph)])
    return _spec(side, prod, mid,
                 _loss(side, consumes=[wl.Consume("mid", pg)]))


def trainable_producer(side):
    wl = SIDES[side][0]
    ph = wl.Port("h", (wl.SEQ, 16), "float32")
    return _spec(side, _producer(side, "prod", port=ph, mode="fwd_bwd"),
                 _loss(side, consumes=[wl.Consume("prod", ph)]))


def two_teachers(side):
    wl = SIDES[side][0]
    pa = wl.Port("h", (wl.SEQ, 16), "float32")
    pb = wl.Port("h", (wl.SEQ, 8), "float32")
    ta = _producer(side, "ta", port=pa)
    tb = _producer(side, "tb", port=pb,
                   activation=lambda b: b["domain"])
    return _spec(side, ta, tb, _loss(side, consumes=[
        wl.Consume("ta", pa), wl.Consume("tb", pb)]))


def _findings(rep):
    return [(f.severity.name, f.check, f.subject, f.message)
            for f in rep.findings]


@pytest.mark.parametrize("case", [valid_spec, cyclic_producers,
                                  unsatisfied_cotangent, trainable_producer,
                                  two_teachers, duplicate_sections,
                                  no_critical, unknown_section],
                         ids=lambda c: c.__name__)
@pytest.mark.parametrize("n_mb,lookahead", [(1, 0), (2, 1)])
def test_deadlock_findings_match_jax(case, n_mb, lookahead):
    want = jdl.check_spec(case("jax"), n_mb=n_mb, lookahead=lookahead)
    got = tdl.check_spec(case("port"), n_mb=n_mb, lookahead=lookahead)
    assert _findings(got) == _findings(want)
    assert got.ok == want.ok
    if case in (cyclic_producers, unsatisfied_cotangent):
        assert not got.ok
    if case in (valid_spec, trainable_producer, two_teachers):
        assert got.ok
        chains_t = tdl.model_events(case("port"), n_mb, ["s0", "s1"])
        chains_j = jdl.model_events(case("jax"), n_mb, ["s0", "s1"])
        assert {k: [e.label() for e in v] for k, v in chains_t.items()} == \
            {k: [e.label() for e in v] for k, v in chains_j.items()}


def test_check_events_synthetic_cycle_and_duplicate_push_match_jax():
    def chains(dl):
        E = dl.Event
        return {"a": [E("a", "t0", "pull", "b", "a", "s0/k1"),
                      E("a", "t0", "push", "a", "b", "s0/k2")],
                "b": [E("b", "t0", "pull", "a", "b", "s0/k2"),
                      E("b", "t0", "push", "b", "a", "s0/k1"),
                      E("b", "t1", "push", "b", "a", "s0/k1")]}
    got = tdl.check_events(chains(tdl))
    assert _findings(got) == _findings(jdl.check_events(chains(jdl)))
    assert [f.check for f in got.errors] == ["deadlock.cycle"]
    assert [f.check for f in got.warnings] == ["deadlock.duplicate-push"]


def test_report_partitions_and_raises():
    rep = tcore.AnalysisReport("p")
    rep.add(tcore.Severity.INFO, "x.i", "a", "fine")
    rep.add(tcore.Severity.WARNING, "x.w", "b", "meh")
    assert rep.ok and len(rep.warnings) == 1
    rep.add(tcore.Severity.ERROR, "x.e", "edge", "broken thing")
    assert not rep.ok and len(rep.errors) == 1
    with pytest.raises(RuntimeError, match=r"x\.e \(edge\): broken"):
        rep.raise_on_error(RuntimeError, "gate failed")
    assert "1 error(s), 1 warning(s), 1 info" in rep.summary()
    assert "x.i" not in rep.render(min_severity=tcore.Severity.WARNING)
    assert "deadlock" in tcore.PASSES
