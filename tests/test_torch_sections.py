"""Section meshes in one process (``carve_sections(ranks=)``,
``MaestroRuntime``/``CompoundRuntime(..., ranks=)``).

1. Carving refuses, before any group is made: ranks shared by two
   sections outside a one-rank world and a rank list too short; on its
   mesh a section's ``pp`` above 1 raises as in the reference
   (``validate_section_parallel``, which ``CompoundRuntime`` runs before
   it carves); ``tp`` alone, a vlm section's ``cp`` and ``cp`` with
   ``tp`` validate.
2. On a one-rank gloo group: both sections on rank 0 (``ranks=[0, 0]``),
   each with its own mesh and worker; ``MaestroRuntime.build_train_step``
   is ``train.step.build_train_step(..., mesh=)`` (one step, bit for bit).
3. On that group, ``DistillRuntime(..., ranks=[0, 0])`` equals the
   device-carved ``DistillRuntime(devices=["cpu"] * 2)`` bit for bit over
   three iterations (losses, ce, kl, grad norm, every student leaf), under
   deterministic algorithms: the gathers, reduce-scatters and all-reduces
   really run on groups of one; a gradient leaf scaled by 0.99 breaks the
   equality (the planted fault); ``grad_compress="bf16"`` keeps the losses
   within 1e-3 (tests/drivers/driver_compression.py's bound) with exactly
   half the float32 payload on the wire.  ``chip_smoke.py::phase_sections``
   runs the same on the H100 at full width.
4. The affinity pass takes a mesh runtime (one live worker a local
   section) and the aliasing lint its blocks.
5. On a card (marked ``cuda``, skipped without one): runtimes built, run
   and shut down one after another leave the card's reserved memory flat
   (each worker's stream is new, and the cuBLAS workspace PyTorch keeps
   for it is released at shutdown).
"""
import contextlib
import gc

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.analysis import affinity, donation  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import workload as wl  # noqa: E402
from repro_torch.core.graph import build_distill_graph  # noqa: E402
from repro_torch.core.runtime import MaestroRuntime, carve_sections  # noqa
from repro_torch.core.types import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.distill import workload as dw  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim import compression as gcomp  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402

B, S, VOCAB, ITERS = 8, 16, 128, 3


def _cfgs():
    over = dict(dtype="float32", vocab_size=VOCAB, num_layers=2)
    return (get_reduced("qwen2.5-32b").replace(**over),
            get_reduced("qwen1.5-0.5b").replace(**over))


# --------------------------------------------------------------------------- #
# 1. refusals
# --------------------------------------------------------------------------- #
def test_carving_refusals():
    cfg = get_reduced("qwen1.5-0.5b")
    g = build_distill_graph(cfg, cfg, fanout=2,
                            student_parallel=ParallelConfig(dp=2))
    with pytest.raises(ValueError, match="overlap only on a one-rank"):
        carve_sections(g, ranks=[0, 1, 1])
    with pytest.raises(ValueError, match="only 2 are given"):
        carve_sections(g, ranks=[0, 1])
    # a seq axis runs a dense section (A6.3), the vlm family's too, and
    # with a model axis (cp x tp); a model axis runs (A6.4), a pipe axis is
    # refused as in the reference
    vlm = get_reduced("pixtral-12b")
    for knob, item, arch in (
            (dict(pp=2), "cannot be stage-partitioned", cfg),
            (dict(cp=2), None, vlm), (dict(cp=2, tp=2), None, cfg)):
        par = ParallelConfig(**knob)
        if item is None:
            assert wl.validate_section_parallel(
                "student", arch, par, wl._mesh_sizes(par)) == "cp"
            continue
        with pytest.raises(NotImplementedError, match=item):
            wl.validate_section_parallel("student", arch, par,
                                         wl._mesh_sizes(par))
    par = ParallelConfig(tp=2)
    assert wl.validate_section_parallel("student", cfg, par,
                                        wl._mesh_sizes(par)) == "plain"
    par = ParallelConfig(cp=2)
    assert wl.validate_section_parallel("student", cfg, par,
                                        wl._mesh_sizes(par)) == "cp"
    par = ParallelConfig(dp=2, grad_compress="int8")
    assert wl.validate_section_parallel("student", cfg, par,
                                        wl._mesh_sizes(par)) == "plain"


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo group in this process, deterministic kernels on one
    thread, all undone after."""
    was, threads = torch.are_deterministic_algorithms_enabled(), \
        torch.get_num_threads()
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)
        torch.use_deterministic_algorithms(was)


# --------------------------------------------------------------------------- #
# 2. one rank, two sections; build_train_step on a section's mesh
# --------------------------------------------------------------------------- #
def test_one_rank_runs_both_sections_and_builds_their_step(world1):
    t_cfg, s_cfg = _cfgs()
    g = build_distill_graph(t_cfg, s_cfg)
    with MaestroRuntime(g, ranks=[0, 0]) as rt:
        assert rt.local_sections == ["teacher", "student"]
        assert rt.mesh("student") is not rt.mesh("teacher")
        assert shd.mesh_shape(rt.mesh("student")) == {
            "data": 1, "pipe": 1, "seq": 1, "model": 1}
        assert set(rt.workers) == {"teacher", "student"}
        assert affinity.check_wiring(rt).ok
        model = build_model(s_cfg, device="cpu", seed=0)
        shape = ShapeConfig("t", "train", S, 4)
        got = rt.build_train_step("student", model, shape)
        want = step_mod.build_train_step(model, ParallelConfig(), shape,
                                         mesh=rt.mesh("student"))
        full = model.param_tree()
        batch = next(lm_batches(batch=4, seq_len=S, vocab=VOCAB, seed=0,
                                device="cpu"))
        outs = []
        for step in (got, want):
            sh = step.shardings
            p = shd.shard_tree(full, sh["params"], rt.mesh("student"))
            o = adamw.init(shd.shard_tree(full, sh["opt"].master,
                                          rt.mesh("student")))
            p, o, m = step(p, o, step.block(batch), 0)
            outs.append((m["loss"], tree_leaves(p)))
        assert torch.equal(outs[0][0], outs[1][0])
        for a, b in zip(outs[0][1], outs[1][1]):
            assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# 3. the mesh path against device carving, bit for bit
# --------------------------------------------------------------------------- #
def _distill(t_cfg, s_cfg, batches, *, compress="none", **where):
    """Three iterations -> (metrics, final student leaves, wire bytes)."""
    with dw.DistillRuntime(
            t_cfg, s_cfg, teacher_parallel=ParallelConfig(),
            student_parallel=ParallelConfig(grad_compress=compress),
            lr=1e-3, **where) as rt:
        pt, ps, opt = rt.init(0)
        w_t = rt.teacher_unembed(pt)
        mets = []
        gcomp.reset_wire_counts()
        for i, b in enumerate(batches):
            ps, opt, m = rt.train_iteration(pt, ps, opt, b, i, w_t=w_t)
            mets.append([m[k] for k in ("loss", "ce", "kl", "grad_norm")])
        wire = gcomp.wire_counts()
        full, _ = rt.runtime.state()
    return mets, tree_leaves(full["student"]), wire


@contextlib.contextmanager
def _scaled_first_grad(factor):
    """The first gradient leaf of every microbatch scaled by ``factor`` as
    the runtime accumulates it: the planted fault."""
    accumulate = wl._accumulate

    def planted(acc, grads):
        grads = list(grads)
        grads[0] = grads[0] * factor
        return accumulate(acc, grads)

    wl._accumulate = planted
    try:
        yield
    finally:
        wl._accumulate = accumulate


def test_mesh_distill_equals_device_carving_bitwise(world1):
    t_cfg, s_cfg = _cfgs()
    gen = lm_batches(batch=B, seq_len=S, vocab=VOCAB, seed=0, device="cpu")
    batches = [next(gen) for _ in range(ITERS)]
    ref = _distill(t_cfg, s_cfg, batches, devices=["cpu", "cpu"])
    got = _distill(t_cfg, s_cfg, batches, ranks=[0, 0])
    for a, b in zip(got[0], ref[0]):
        for x, y in zip(a, b):
            assert torch.equal(x, y), (a, b)
    for x, y in zip(got[1], ref[1]):
        assert torch.equal(x, y)
    with _scaled_first_grad(0.99):
        bad = _distill(t_cfg, s_cfg, batches, ranks=[0, 0])
    assert not all(torch.equal(x, y) for x, y in zip(bad[1], ref[1]))
    comp = _distill(t_cfg, s_cfg, batches, ranks=[0, 0], compress="bf16")
    for a, b in zip(comp[0], ref[0]):
        assert abs(float(a[0]) - float(b[0])) <= 1e-3 * abs(float(b[0]))
    payload = sum(x.numel() for x in ref[1]) * 4 * ITERS
    assert comp[2]["bf16.bfloat16"] * 2 == payload


# --------------------------------------------------------------------------- #
# 4. the analysis passes on a mesh runtime
# --------------------------------------------------------------------------- #
def test_affinity_and_aliasing_on_mesh_runtime(world1):
    t_cfg, s_cfg = _cfgs()
    with dw.DistillRuntime(t_cfg, s_cfg, teacher_parallel=ParallelConfig(),
                           student_parallel=ParallelConfig(),
                           ranks=[0, 0]) as rt:
        rep = affinity.check_wiring(rt.runtime)
        assert rep.ok, rep
        params, opts = rt.runtime.init(0)
        assert donation.lint_state(params, opts, runtime=rt.runtime).ok
        shared = {"student": opts["student"]._replace(
            master=params["student"])}
        assert not donation.lint_state(params, shared).ok


# --------------------------------------------------------------------------- #
# 5. on a card: runtimes one after another hold reserved memory flat
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
def test_runtime_rebuilds_hold_reserved_memory_flat():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t_cfg, s_cfg = _cfgs()
    dev = torch.device("cuda", 0)
    batch = next(lm_batches(batch=B, seq_len=S, vocab=VOCAB, seed=0,
                            device="cpu"))
    reserved = []
    for _ in range(3):
        with dw.DistillRuntime(t_cfg, s_cfg, teacher_parallel=ParallelConfig(),
                               student_parallel=ParallelConfig(),
                               devices=[dev, dev]) as rt:
            pt, ps, opt = rt.init(0)
            rt.train_iteration(pt, ps, opt, batch, 0,
                               w_t=rt.teacher_unembed(pt))
            del pt, ps, opt
        gc.collect()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved(dev))
    assert max(reserved) <= reserved[0], reserved
