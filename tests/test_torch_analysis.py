"""The port's affinity and aliasing passes (``repro_torch.analysis``) on the
CPU: the affinity cases of ``tests/test_analysis.py`` recast to the port's
rule (one live worker thread and one CUDA stream of its own a section),
the donation cases recast to in-place aliasing, the passes wired into a
real ``CompoundRuntime`` (refusal at build and at ``install``), clean on
the real distill, multi-teacher and MLLM runtimes on ``["cpu"] * n``, and
the ``python -m repro_torch.analysis`` CLI.  ``check_profile`` runs here
on synthetic profiler events; ``chip_smoke.py`` runs it on real traces.
"""
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402

import repro_torch.core.runtime as rt_mod  # noqa: E402
import repro_torch.core.workload as wl  # noqa: E402
from repro_torch.analysis import (PASSES, AliasedStateError,  # noqa: E402
                                  affinity, check_profile, check_trace,
                                  check_wiring, lint_spec, lint_state,
                                  lint_step_fn)
from repro_torch.analysis import __main__ as cli  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.runtime import MaestroRuntime, SectionWorker  # noqa: E402,E501
from repro_torch.core.types import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.data.synthetic import (lm_batches, routed_lm_batches,  # noqa: E402,E501
                                        vlm_batches)
from repro_torch.distill import multi_teacher as mt  # noqa: E402
from repro_torch.distill import workload as dw  # noqa: E402
from repro_torch.mllm import workload as mw  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models import vlm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _cfg():
    return get_reduced("qwen1.5-0.5b").replace(
        dtype="float32", num_layers=2, vocab_size=64, d_ff=128)


def _producer(name="prod", port=None, mode="fwd_only", consumes=()):
    port = port or wl.Port("h", (wl.SEQ, 16), "float32")
    return wl.SectionSpec(
        name, _cfg(), ParallelConfig(),
        fn=lambda p, x: {"h": x["tokens"]}, params={},
        inputs={"tokens": wl.Field((wl.SEQ,), "int32")},
        emits=(port,), mode=mode, consumes=tuple(consumes))


def _loss(consumes=(), name="crit"):
    return wl.SectionSpec(
        name, _cfg(), ParallelConfig(),
        fn=lambda p, x: 0.0, params={},
        inputs={"tokens": wl.Field((wl.SEQ,), "int32")},
        consumes=tuple(consumes), loss=True, critical=True)


def _spec(*sections):
    return wl.WorkloadSpec("t", tuple(sections), seq_len=8,
                           global_batch=4, mbs=2)


def test_pass_registry_contains_the_ported_passes():
    assert {"deadlock", "donation", "affinity"} <= set(PASSES)


# --------------------------------------------------------------------- #
# aliasing (the donation pass, recast to in-place updates)
# --------------------------------------------------------------------- #
def test_cross_section_alias_finding_names_tree_and_leaf():
    shared = torch.ones(4)
    rep = lint_state({}, {"a": {"mu": shared}, "b": {"mu": shared}})
    bad = [f for f in rep.errors
           if f.check == "donation.cross-section-alias"]
    assert bad, rep.render()
    assert bad[0].subject == "opts[a].mu"
    assert "opts[b].mu" in bad[0].message


def test_params_alias_finding():
    w = torch.ones(4)
    rep = lint_state({"s": {"w": w}}, {"s": {"master": {"w": w}}})
    bad = [f for f in rep.errors if f.check == "donation.params-alias"]
    assert bad and bad[0].subject == "opts[s].master.w"
    assert "params[s].w" in bad[0].message


def test_another_sections_params_alias_is_cross_section():
    w = torch.ones(4)
    rep = lint_state({"t": {"w": w}}, {"s": {"master": {"w": w}}})
    assert [f.check for f in rep.errors] == ["donation.cross-section-alias"]


def test_self_alias_finding_names_both_leaves():
    z = torch.zeros(4)
    rep = lint_state({}, {"s": adamw.AdamWState(torch.zeros((), dtype=torch
                                                            .int32),
                                                {"w": z}, {"w": z},
                                                {"w": torch.ones(4)})})
    bad = [f for f in rep.errors if f.check == "donation.self-alias"]
    assert bad and bad[0].subject == "opts[s]"
    assert "opts[s].mu.w" in bad[0].message
    assert "opts[s].nu.w" in bad[0].message


def test_overlapping_views_alias_and_disjoint_views_do_not():
    buf = torch.zeros(8)
    assert not lint_state({}, {"a": {"mu": buf[:4]},
                               "b": {"mu": buf[4:]}}).errors
    rep = lint_state({}, {"a": {"mu": buf[:5]}, "b": {"mu": buf[4:]}})
    assert [f.check for f in rep.errors] == ["donation.cross-section-alias"]
    grid = torch.zeros(4, 4)
    # column 0 and row 0 share one element; strided views are spanned
    rep = lint_state({}, {"a": {"mu": grid[:, 0]}, "b": {"mu": grid[0]}})
    assert rep.errors


def test_clean_state_passes():
    p = {"s": {"w": torch.ones(4)}}
    assert lint_state(p, {"s": adamw.init(p["s"])}).ok
    assert lint_state({"a": {"w": torch.ones(2)}}, {}).ok


def test_step_fn_metadata():
    cfg = _cfg()
    step = step_mod.build_train_step(build_model(cfg, device="cpu", seed=0),
                                     ParallelConfig(mbs=4),
                                     ShapeConfig("t", "train", 8, 4))
    rep = lint_step_fn(step)
    assert rep.ok and "argnums (1,) in place" in rep.findings[0].message

    def bare():
        pass
    rep2 = lint_step_fn(bare)
    assert [f.check for f in rep2.warnings] == ["donation.undeclared"]


def test_spec_signature():
    ph = wl.Port("h", (wl.SEQ, 16), "float32")
    prod = _producer("prod", port=ph, mode="fwd_bwd")
    spec = _spec(prod, _loss(consumes=[wl.Consume("prod", ph)]))
    by = {f.subject: f.message for f in lint_spec(spec).findings}
    assert "in place" in by["prod"] and "in place" in by["crit"]
    frozen = _spec(_producer("prod", port=ph),
                   _loss(consumes=[wl.Consume("prod", ph)]))
    by = {f.subject: f.message for f in lint_spec(frozen).findings}
    assert by["prod"].startswith("fwd_only")


# --------------------------------------------------------------------- #
# affinity: static wiring
# --------------------------------------------------------------------- #
class _FakeThread:
    def __init__(self, name, alive=True):
        self.name = name
        self._alive = alive

    def is_alive(self):
        return self._alive


class _FakeWorker:
    def __init__(self, name, alive=True, stream=None):
        self._thread = _FakeThread(f"section-{name}", alive)
        self.stream = stream


def _fake_rt(devices, workers):
    return SimpleNamespace(section_devices=devices, workers=workers)


def test_wiring_clean_on_a_real_runtime():
    g = _spec(_producer(), _loss(consumes=[wl.Consume(
        "prod", wl.Port("h", (wl.SEQ, 16), "float32"))])).to_graph()
    with MaestroRuntime(g, ["cpu", "cpu"]) as rt:
        rep = check_wiring(rt)
        assert rep.ok
        assert [f.check for f in rep.findings] == ["affinity.wiring"]
        assert "one live worker each" in rep.findings[0].message


def test_wiring_shared_stream_names_both_sections():
    s = SimpleNamespace(cuda_stream=7)
    rep = check_wiring(_fake_rt(
        {"a": "cpu", "b": "cpu"},
        {"a": _FakeWorker("a", stream=s), "b": _FakeWorker("b", stream=s)}))
    bad = [f for f in rep.errors if f.check == "affinity.shared-stream"]
    assert bad and bad[0].subject == "a|b"
    ok = check_wiring(_fake_rt(
        {"a": "cpu", "b": "cpu"},
        {"a": _FakeWorker("a", stream=SimpleNamespace(cuda_stream=7)),
         "b": _FakeWorker("b", stream=SimpleNamespace(cuda_stream=8))}))
    assert ok.ok and "2 on streams of their own" in ok.findings[0].message


def test_wiring_missing_dead_and_misnamed_workers():
    w = _FakeWorker("c")
    w._thread.name = "some-thread"
    rep = check_wiring(_fake_rt({"a": "cpu", "b": "cpu", "c": "cpu"},
                                {"b": _FakeWorker("b", alive=False),
                                 "c": w, "d": _FakeWorker("d")}))
    assert {f.check for f in rep.errors} == {
        "affinity.no-worker", "affinity.dead-worker", "affinity.thread-name"}
    assert [f.subject for f in rep.warnings] == ["d"]


def test_wiring_a_card_section_needs_a_stream():
    rep = check_wiring(_fake_rt({"a": "cuda:0"}, {"a": _FakeWorker("a")}))
    assert [f.check for f in rep.errors] == ["affinity.no-stream"]


# --------------------------------------------------------------------- #
# affinity: dispatch trace
# --------------------------------------------------------------------- #
def test_trace_attribution():
    ok = check_trace([("s", "section-s", "s"), ("s", "section-s", "s")])
    assert ok.ok and "2 dispatches" in ok.findings[0].message
    bad = check_trace([("s", "MainThread", None)])
    fails = [f for f in bad.errors if f.check == "affinity.foreign-thread"]
    assert fails and "not a section worker" in fails[0].message
    multi = check_trace([("s", "section-s", "s"), ("s", "section-t", "t")])
    assert {f.check for f in multi.errors} == {"affinity.foreign-thread",
                                               "affinity.multiple-threads"}


def test_record_via_real_section_worker():
    """SectionWorker._run marks its thread; record() inside a task must
    attribute the dispatch to that section's own worker."""
    w = SectionWorker("vit", "cpu")
    with affinity.tracking() as trace:
        w.submit("t0", lambda: affinity.record("vit"))
        w.drain(1)
        affinity.record("vit")          # main thread: foreign
    w.stop()
    fails = [f for f in check_trace(trace).errors
             if f.check == "affinity.foreign-thread"]
    assert fails                        # the main-thread record
    assert ("vit", "section-vit", "vit") in trace
    affinity.record("vit")              # tracking off: nothing recorded
    assert len(trace) == 2


# --------------------------------------------------------------------- #
# affinity: profiler trace (synthetic events)
# --------------------------------------------------------------------- #
class _Prof:
    """Events shaped like torch.profiler's FunctionEvents: operators on
    host threads (``thread``, ``fwd_thread``, ``cpu_parent``), each launch
    call nested under its operator, and the device work it launched with
    the call's ``id``."""

    def __init__(self):
        self.evs = []

    def events(self):
        return self.evs

    def op(self, name, thread, parent=None, fwd_thread=0, span=(0, 1)):
        e = SimpleNamespace(id=len(self.evs) + 1, name=name, thread=thread,
                            fwd_thread=fwd_thread, cpu_parent=parent,
                            device_type=DeviceType.CPU,
                            is_user_annotation=False,
                            time_range=SimpleNamespace(start=span[0],
                                                       end=span[1]))
        self.evs.append(e)
        return e

    def kernel(self, op, stream, n=1):
        for _ in range(n):
            call = self.op("cudaLaunchKernel", op.thread, op)
            self.evs.append(SimpleNamespace(
                id=call.id, name="k", device_type=DeviceType.CUDA,
                is_user_annotation=False, device_resource_id=stream))


_RT = SimpleNamespace(workers={"teacher": None, "student": None})


def _two_sections(prof):
    """Main thread 1 (copies on stream 7), teacher thread 2 (stream 13),
    student thread 3 (stream 17), whose backward runs on autograd's
    thread 4 (fwd_thread 3)."""
    prof.kernel(prof.op("aten::copy_", 1), 7, 2)
    t = prof.op(affinity.TASK_RANGE + "teacher", 2)
    prof.kernel(prof.op("aten::mm", 2, t), 13, 3)
    prof.kernel(t, 13)                          # a kernel launched by ctypes
    s = prof.op(affinity.TASK_RANGE + "student", 3)
    prof.kernel(prof.op("aten::mm", 3, s), 17, 2)
    node = prof.op("MmBackward0", 4, fwd_thread=3)
    prof.kernel(prof.op("aten::mm", 4, node), 17, 2)


def test_profile_clean_attributes_backward_by_forward_thread():
    prof = _Prof()
    _two_sections(prof)
    rep = check_profile(prof, _RT)
    assert rep.ok, rep.render()
    by = {f.subject: f.message for f in rep.findings}
    assert by["teacher"].startswith("4 kernels, all on stream 13")
    assert by["student"].startswith("4 kernels, all on stream 17")
    assert "2 kernels launched outside the sections" in by["main"]


def test_profile_range_without_launches_does_not_claim_its_thread():
    """The profiler may also list a task range on the thread that started
    it, with nothing under it: the main thread's copies stay the main
    thread's."""
    prof = _Prof()
    prof.op(affinity.TASK_RANGE + "teacher", 1)
    _two_sections(prof)
    assert check_profile(prof, _RT).ok


def test_profile_launch_the_profiler_did_not_nest():
    """A backward launch call whose interval overlaps its operator's only
    partly has no parent: the operator holding its start stands in."""
    prof = _Prof()
    _two_sections(prof)
    node = prof.op("MmBackward0", 4, fwd_thread=3, span=(10, 20))
    prof.op("aten::mm", 4, node, span=(11, 15))
    call = prof.op("cudaLaunchKernel", 4, None, span=(14, 16))
    prof.evs.append(SimpleNamespace(
        id=call.id, name="k", device_type=DeviceType.CUDA,
        is_user_annotation=False, device_resource_id=17))
    rep = check_profile(prof, _RT)
    assert rep.ok, rep.render()
    assert {f.subject: f.message for f in rep.findings}["student"] \
        .startswith("5 kernels")
    # and one outside every node is not counted as the main thread's
    call.time_range = SimpleNamespace(start=30, end=31)
    rep = check_profile(prof, _RT)
    assert rep.ok and "1 launched by autograd" in rep.findings[-1].message


def test_profile_launch_filed_beside_a_buffer_request():
    """CUPTI asking for a fresh activity buffer while it records a
    student's launch: the profiler files that call on thread 1 with no
    operator above it, its "Activity Buffer Request" the thread's next
    event (ROADMAP.md, C10).  It is counted apart; the same parentless
    launch without the request stays the main thread's."""
    prof = _Prof()
    _two_sections(prof)
    call = prof.op("cudaLaunchKernel", 1, None, span=(40, 41))
    prof.evs.append(SimpleNamespace(
        id=call.id, name="k", device_type=DeviceType.CUDA,
        is_user_annotation=False, device_resource_id=17))
    request = prof.op(affinity._BUFFER_REQUEST, 1, span=(42, 50))
    rep = check_profile(prof, _RT)
    assert rep.ok, rep.render()
    assert "1 filed by the profiler" in rep.findings[-1].message
    request.name = "aten::empty"
    checks = {f.check for f in check_profile(prof, _RT).errors}
    assert checks == {"affinity.main-on-section-stream"}


def test_profile_kernel_on_another_sections_stream():
    prof = _Prof()
    _two_sections(prof)
    t = prof.op(affinity.TASK_RANGE + "teacher", 2)
    prof.kernel(prof.op("aten::mul_", 2, t), 17)
    rep = check_profile(prof, _RT)
    bad = [f for f in rep.errors if f.check == "affinity.foreign-stream"]
    assert bad and bad[0].subject == "teacher"
    assert "stream 17: 1" in bad[0].message


def test_profile_shared_and_main_thread_streams():
    prof = _Prof()
    _two_sections(prof)
    s = prof.op(affinity.TASK_RANGE + "student", 3)
    prof.kernel(prof.op("aten::mm", 3, s), 13, 9)      # now mostly on 13
    prof.kernel(prof.op("aten::copy_", 1), 13)
    checks = {f.check for f in check_profile(prof, _RT).errors}
    assert {"affinity.foreign-stream", "affinity.shared-stream",
            "affinity.main-on-section-stream"} <= checks


def test_profile_section_without_attributed_kernels():
    prof = _Prof()
    prof.kernel(prof.op("aten::copy_", 1), 7)
    prof.op(affinity.TASK_RANGE + "teacher", 2)
    rep = check_profile(prof, _RT)
    assert [f.check for f in rep.errors] == ["affinity.unattributed"]
    # a trace without the workers' operators proves nothing
    prof = _Prof()
    prof.kernel(prof.op("aten::copy_", 1), 7)
    rep = check_profile(prof, _RT)
    assert [f.check for f in rep.errors] == ["affinity.no-task-ranges"]
    # nor one whose kernels match no launch call
    for e in prof.evs:
        e.id += 100 if e.device_type == DeviceType.CUDA else 0
    rep = check_profile(prof, _RT)
    assert [f.check for f in rep.errors] == ["affinity.unlinked"]


def test_profile_of_a_cpu_run_is_empty_and_clean():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with affinity.task_range("teacher"):
            torch.ones(4).sum()
    assert any(e.name == affinity.TASK_RANGE + "teacher"
               for e in prof.events())
    assert check_profile(prof, _RT).ok
    # no profiler: the range is a null context
    assert type(affinity.task_range("x")).__name__ == "nullcontext"


def test_task_range_is_recorded_on_a_worker_thread():
    """A profiler taken with ``profile_config()`` records the range a
    section worker opens, and the operators inside it, on the worker's
    thread."""
    from torch.profiler import ProfilerActivity, profile
    w = SectionWorker("teacher", "cpu")

    def task():
        with affinity.task_range("teacher"):
            return torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=affinity.profile_config()) as prof:
        torch.zeros(2)
        w.submit("t", task)
        w.drain(1)
    w.stop()
    by_name = {e.name: e for e in prof.events()}
    mark = by_name[affinity.TASK_RANGE + "teacher"]
    assert by_name["aten::ones"].cpu_parent is mark
    assert mark.thread != by_name["aten::zeros"].thread


# --------------------------------------------------------------------- #
# the passes in a real CompoundRuntime
# --------------------------------------------------------------------- #
def _lm_spec():
    cfg = _cfg()

    def lm_fn(p, x):
        return tf.lm_loss(p, cfg, {"tokens": x["tokens"],
                                   "labels": x["labels"]})[0]

    sec = wl.SectionSpec(
        "lm", cfg, ParallelConfig(), fn=lm_fn, params=tf.lm_specs(cfg),
        inputs={"tokens": wl.Field((wl.SEQ,), "int32"),
                "labels": wl.Field((wl.SEQ,), "int32")},
        loss=True, critical=True)
    return wl.WorkloadSpec("lm-only", (sec,), seq_len=8, global_batch=4,
                           mbs=2)


def test_runtime_install_rejects_aliased_state_and_traces_clean():
    gen = lm_batches(batch=4, seq_len=8, vocab=64, seed=0, device="cpu")
    batch = next(gen)
    with wl.CompoundRuntime(_lm_spec(), devices=["cpu"]) as rt:
        assert check_wiring(rt).ok
        p, o = rt.init(0)
        with affinity.tracking() as trace:
            rt.train_iteration(p, o, batch, 0)
        assert trace, "executor did not record any dispatches"
        assert check_trace(trace).ok
        # a master that is the params tree itself
        p2, o2 = rt.init(1)
        aliased = {"lm": o2["lm"]._replace(master=p2["lm"])}
        with pytest.raises(AliasedStateError,
                           match=r"donation\.params-alias \(opts\[lm\]"):
            rt.install(p2, aliased)
        rt.install(p2, o2)                    # the clean state installs


def test_runtime_refuses_two_sections_on_one_stream(monkeypatch):
    """Every worker handed one (stand-in) stream after its thread started:
    the runtime refuses the wiring at build and stops its workers."""
    shared = SimpleNamespace(cuda_stream=1234)
    made = []

    def worker(name, device=None):
        w = SectionWorker(name, device)
        w.submit("ready", lambda: None)
        w.drain(1)
        w.stream = shared
        made.append(w)
        return w

    monkeypatch.setattr(rt_mod, "SectionWorker", worker)
    ph = wl.Port("h", (wl.SEQ, 16), "float32")
    spec = _spec(_producer(port=ph), _loss(consumes=[wl.Consume("prod",
                                                                ph)]))
    with pytest.raises(RuntimeError, match=r"affinity\.shared-stream"):
        wl.CompoundRuntime(spec, devices=["cpu", "cpu"])
    for w in made:
        w._thread.join(timeout=10)
        assert not w._thread.is_alive()


# --------------------------------------------------------------------- #
# clean on the real runtimes
# --------------------------------------------------------------------- #
def _clean(runtime, run_iteration, params, opts):
    assert check_wiring(runtime).ok
    with affinity.tracking() as trace:
        run_iteration()
    rep = check_trace(trace)
    assert rep.ok and trace, rep.render()
    names = {s for s, _, _ in trace}
    assert names == set(runtime.rt.workers), names
    rep = lint_state(params, opts, runtime=getattr(runtime, "runtime",
                                                   runtime))
    assert rep.ok, rep.render()


def test_passes_clean_on_the_distill_runtime():
    cfg = _cfg()
    with dw.DistillRuntime(cfg, cfg, teacher_parallel=ParallelConfig(),
                           student_parallel=ParallelConfig(),
                           devices=["cpu"] * 2) as rt:
        pt, ps, opt = rt.init(0)
        batch = next(lm_batches(batch=4, seq_len=16, vocab=64, seed=0,
                                device="cpu"))
        _clean(rt, lambda: rt.train_iteration(pt, ps, opt, batch, 0),
               {"teacher": pt, "student": ps}, {"student": opt})


def test_passes_clean_on_the_multi_teacher_runtime():
    cfg = _cfg()
    spec = mt.multi_teacher_spec(
        cfg, cfg, cfg, ta_parallel=ParallelConfig(),
        tb_parallel=ParallelConfig(), s_parallel=ParallelConfig(),
        global_batch=4, seq_len=16, mbs=2)
    batch = next(routed_lm_batches(batch=4, seq_len=16, vocab=64,
                                   specialist_ratio=0.5, seed=0,
                                   device="cpu"))
    with wl.CompoundRuntime(spec, devices=["cpu"] * 3) as rt:
        params, opts = rt.init(0)
        cpu = torch.device("cpu")
        consts = {"student": {
            "w_a": mt.teacher_unembed(params["teacher_a"], cfg, cpu),
            "w_b": mt.teacher_unembed(params["teacher_b"], cfg, cpu)}}
        _clean(rt, lambda: rt.train_iteration(params, opts, batch, 0,
                                               consts=consts),
               params, opts)


def test_passes_clean_on_the_mllm_runtime():
    lm = get_reduced("pixtral-12b").replace(
        dtype="float32", vocab_size=64, vision_dim=32, max_image_tokens=4)
    vit = vlm.vit_config(num_layers=2, d_model=32, num_heads=2, d_ff=64,
                         patch_dim=16, downsample=4, out_dim=32,
                         name="vit-tiny").replace(dtype="float32")
    batch = next(vlm_batches(batch=4, seq_len=16, vocab=64, vision_ratio=0.5,
                             image_tokens=4, patch_dim=16, downsample=4,
                             seed=0, device="cpu"))
    with mw.MLLMRuntime(vit, lm, vit_parallel=ParallelConfig(),
                        lm_parallel=ParallelConfig(), global_batch=4,
                        seq_len=16, mbs=2, devices=["cpu"] * 2) as rt:
        params, opts = rt.place(mw.init_compound_params(vit, lm, seed=0,
                                                        device="cpu"))
        _clean(rt, lambda: rt.train_iteration(params, opts, batch, 0),
               {"vit": params["vit"], "llm": params["lm"]},
               {"vit": opts["vit"], "llm": opts["lm"]})
        # two sections' optimizer states sharing one master tensor
        bad = dict(opts, lm=opts["lm"]._replace(master={
            **opts["lm"].master, "embed": opts["vit"].master}))
        with pytest.raises(AliasedStateError, match="cross-section-alias"):
            rt.install(params, bad)


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #
def test_cli_clean_on_the_registered_specs(capsys):
    assert cli.main(["--min-severity", "warning"]) == 0
    out = capsys.readouterr().out
    for name in ("distill", "multi_teacher", "mllm"):
        assert f"deadlock:{name}@la1" in out
    assert out.strip().endswith("ANALYSIS OK")


def test_cli_fails_on_a_planted_cycle(monkeypatch, capsys):
    pa = wl.Port("a", (4,), "float32")
    pb = wl.Port("b", (4,), "float32")
    cyclic = _spec(_producer("s1", port=pa, consumes=[wl.Consume("s2", pb)]),
                   _producer("s2", port=pb, consumes=[wl.Consume("s1", pa)]),
                   _loss())
    monkeypatch.setattr(cli, "build_specs", lambda which: {"cyc": cyclic})
    assert cli.main([]) == 1
    out = capsys.readouterr().out
    assert "[ERROR] spec.validate (cyc)" in out and "ANALYSIS FAILED" in out


def test_cli_as_a_module():
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--spec", "distill"], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "donation.signature (student)" in out.stdout
    assert out.stdout.strip().endswith("ANALYSIS OK")
