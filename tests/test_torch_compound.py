"""The port's compound runtime (``repro_torch.core.workload``) on the CPU.

1. One section: three iterations streamed with ``lookahead=1`` equal the
   serialized ``train_iteration`` trajectory bitwise (the port's copy of
   ``tests/test_workload.py``'s streaming test).  Bitwise comparisons run
   with ``torch.use_deterministic_algorithms``: the CPU backward of the
   embedding gather accumulates repeated tokens in a thread-dependent
   order and differs in the last bit from run to run otherwise.
2. The port's ``DistillRuntime`` (teacher and student sections on
   ``["cpu", "cpu"]``, each on its own worker thread) against the port's
   ``distill.workload.build_colocated_step`` from the same params on the
   same 3 batches: losses, ce, kl, grad norms and student params are
   bitwise equal.
3. The port's ``DistillRuntime`` against the JAX ``DistillRuntime`` on
   the reduced qwen pairing of ``tests/drivers/driver_distill_runtime.py``
   (dp = 1 each, ``impl="ref"``), float32, both started from the JAX
   run's initial params: per-iteration loss, ce, kl and grad norm and the
   student params after 3 iterations within atol = rtol = 2e-4 (the
   tolerance of ``tests/test_torch_distill.py`` for 3 colocated steps).
   The JAX side needs two devices, so it runs in a subprocess of this
   file (``python tests/test_torch_compound.py --jax-oracle out.npz``),
   which sets ``XLA_FLAGS`` before JAX is imported.
4. A toy workload with a trainable producer: ``bwd`` dispatches and the
   cotangent edges, against colocated autograd of the same composition.
"""
import os
import sys

if __name__ == "__main__":
    # the JAX oracle: two virtual CPU devices, set before JAX is imported
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import functools  # noqa: E402
import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import repro_torch.core.workload as wl  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import section_params_from_numpy  # noqa: E402
from repro_torch.core.types import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.distill import workload as dw  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import (ParamSpec, tree_leaves,  # noqa: E402
                                       tree_map)
from repro_torch.optim import adamw, schedules  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU2 = ["cpu", "cpu"]
# tests/test_torch_distill.py's tolerance for three colocated steps
TOL = dict(atol=2e-4, rtol=2e-4)
B, S, VOCAB, ITERS = 8, 32, 512, 3


def _np(x):
    return x.detach().float().numpy()


@pytest.fixture
def deterministic():
    """Deterministic kernels for a bitwise comparison, restored after."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _pair_cfgs(reduced):
    """The reduced qwen pairing of tests/drivers/driver_distill_runtime.py."""
    return (reduced("qwen2.5-32b").replace(dtype="float32", vocab_size=VOCAB),
            reduced("qwen1.5-0.5b").replace(dtype="float32",
                                            vocab_size=VOCAB))


# --------------------------------------------------------------------------- #
# 1. one section: streamed == serialized, bitwise
# --------------------------------------------------------------------------- #
def _lm_spec():
    cfg = get_reduced("qwen1.5-0.5b").replace(
        dtype="float32", num_layers=2, vocab_size=64, d_ff=128)

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


def test_streaming_lookahead_matches_serialized_trajectory(deterministic):
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, 64, (4, 8)).astype(np.int32),
                "labels": rng.integers(0, 64, (4, 8)).astype(np.int32)}
               for _ in range(3)]
    with wl.CompoundRuntime(_lm_spec(), devices=["cpu"],
                            lookahead=1) as rt:
        p, o = rt.init(0)            # the optimizer updates o in place:
        ref_losses = []              # the streamed run re-initialises
        for i, b in enumerate(batches):
            p, o, m = rt.train_iteration(p, o, b, i)
            ref_losses.append(m["loss"])
        p2, o2 = rt.init(0)
        rt.install(p2, o2)
        max_inflight = 0
        for i, b in enumerate(batches):
            rt.submit_iteration(b, i)
            max_inflight = max(max_inflight, rt.in_flight)
        ms = rt.drain()
        assert max_inflight == 2 and rt.in_flight == 0
        p3, _ = rt.state()
        for i in range(3):
            assert torch.equal(ms[i]["loss"], ref_losses[i]), i
        for a, b in zip(tree_leaves(p["lm"]), tree_leaves(p3["lm"])):
            assert torch.equal(a, b)
        assert ms[0]["n_tasks"] == {"lm": 3}       # mb0, mb1, upd


def test_train_iteration_rejects_inflight_stream():
    rng = np.random.default_rng(1)
    b = {"tokens": rng.integers(0, 64, (4, 8)).astype(np.int32),
         "labels": rng.integers(0, 64, (4, 8)).astype(np.int32)}
    with wl.CompoundRuntime(_lm_spec(), devices=["cpu"],
                            lookahead=2) as rt:
        p, o = rt.init(0)
        rt.install(p, o)
        rt.submit_iteration(b, 0)
        with pytest.raises(RuntimeError, match="serialized wrapper"):
            rt.train_iteration(p, o, b, 1)
        with pytest.raises(RuntimeError, match="quiescent"):
            rt.install(p, o)
        (m,) = rt.drain()
        assert torch.isfinite(m["loss"])


def test_entry_points_default_to_the_card():
    """With no device list the sections are carved from the visible cards;
    a host with none (or too few) refuses and says how to share one."""
    t_cfg, s_cfg = _pair_cfgs(get_reduced)
    if torch.cuda.device_count() >= 2:
        pytest.skip("enough cards to carve two sections")
    with pytest.raises(ValueError, match=r"cuda:0.*\* n_sections"):
        dw.DistillRuntime(t_cfg, s_cfg, teacher_parallel=ParallelConfig(),
                          student_parallel=ParallelConfig())


# --------------------------------------------------------------------------- #
# 2. DistillRuntime against the port's colocated step, bitwise
# --------------------------------------------------------------------------- #
def _batches():
    gen = lm_batches(batch=B, seq_len=S, vocab=VOCAB, seed=0, device="cpu")
    return [next(gen) for _ in range(ITERS)]


def test_distill_runtime_equals_colocated_step_bitwise(deterministic):
    t_cfg, s_cfg = _pair_cfgs(get_reduced)
    batches = _batches()
    with dw.DistillRuntime(t_cfg, s_cfg, teacher_parallel=ParallelConfig(),
                           student_parallel=ParallelConfig(), devices=CPU2,
                           lr=1e-3) as rt:
        pt, ps, opt = rt.init(0)
        ps0 = tree_map(torch.clone, ps)
        w_t = rt.teacher_unembed(pt)
        got = []
        for i, b in enumerate(batches):
            ps, opt, m = rt.train_iteration(pt, ps, opt, b, i, w_t=w_t)
            got.append([m[k] for k in ("loss", "ce", "kl", "grad_norm")])
            ex = m["execution"]
            assert ex.task_counts == {"teacher": 1, "student": 2}
            ends = {(e.section, e.tag): e.end for e in ex.timeline}
            assert ends[("teacher", "fwd0")] <= ends[("student", "mb0")]
            assert 0.0 < ex.utilization("student") <= 1.0
        assert rt.rt.queue.stats()["pushes"] == ITERS   # hidden only
    step = dw.build_colocated_step(
        t_cfg, s_cfg, ShapeConfig("d", "train", S, B), ParallelConfig(mbs=B),
        lr_schedule=functools.partial(schedules.constant, peak_lr=1e-3))
    pc = tree_map(lambda x: x.requires_grad_(), ps0)
    oc = adamw.init(pc)
    for i, b in enumerate(batches):
        pc, oc, m = step(pc, oc, pt, b, i)
        want = [m[k] for k in ("loss", "ce", "kl", "grad_norm")]
        for g, w in zip(got[i], want):
            assert torch.equal(g, w), (i, g, w)
    for a, b in zip(tree_leaves(ps), tree_leaves(pc)):
        assert torch.equal(a, b.detach())


# --------------------------------------------------------------------------- #
# 3. DistillRuntime against the JAX DistillRuntime
# --------------------------------------------------------------------------- #
def _flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _unflatten(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_tree(out: dict, tree, prefix: str) -> None:
    """A JAX param tree as float32 numpy leaves plus their dtype names."""
    for k, v in _flatten(tree, prefix).items():
        arr = np.asarray(v)
        out[k] = arr.astype(np.float32)
        out[f"dtype:{k}"] = np.asarray(str(arr.dtype))


def load_tree(npz, prefix: str):
    """Back to numpy leaves in their own dtypes (bf16 through ml_dtypes, as
    ``np.asarray`` of a JAX array gives them)."""
    import ml_dtypes
    flat = {}
    for k in npz.files:
        if k.startswith(prefix + "/"):
            dt = str(npz[f"dtype:{k}"])
            arr = npz[k]
            flat[k] = (arr.astype(ml_dtypes.bfloat16) if dt == "bfloat16"
                       else arr.astype(dt))
    return _unflatten(flat, prefix)


def jax_distill_oracle(path: str) -> None:
    """Three iterations of the JAX DistillRuntime on two virtual devices."""
    import jax
    from repro.configs import get_reduced as jreduced
    from repro.core.types import ParallelConfig as JParallel
    from repro.data.synthetic import lm_batches as jlm_batches
    from repro.distill.workload import DistillRuntime as JDistillRuntime

    assert len(jax.devices()) == 2, jax.devices()
    t_cfg, s_cfg = _pair_cfgs(jreduced)
    rt = JDistillRuntime(t_cfg, s_cfg, teacher_parallel=JParallel(),
                         student_parallel=JParallel(), impl="ref",
                         alpha=0.5, temperature=2.0, lr=1e-3)
    pt, ps, opt = rt.init(jax.random.PRNGKey(0))
    out = {}
    save_tree(out, pt, "init/teacher")
    save_tree(out, ps, "init/student")
    w_t = rt.teacher_unembed(pt)
    gen = jlm_batches(batch=B, seq_len=S, vocab=VOCAB, seed=0)
    mets = []
    for i in range(ITERS):
        batch = next(gen)
        out[f"tokens{i}"] = np.asarray(batch["tokens"])
        ps, opt, m = rt.train_iteration(pt, ps, opt, batch, i, w_t=w_t)
        mets.append([float(m[k]) for k in ("loss", "ce", "kl", "grad_norm")])
    out["metrics"] = np.asarray(mets, np.float64)
    save_tree(out, ps, "final/student")
    rt.shutdown()
    np.savez(path, **out)


def run_oracle(script: Path, tmp_path: Path) -> np.lib.npyio.NpzFile:
    """Run ``script --jax-oracle`` in a fresh process and load its output."""
    out = tmp_path / "oracle.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, str(script), "--jax-oracle",
                           str(out)], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return np.load(out)


@pytest.fixture(scope="module")
def jax_distill(tmp_path_factory):
    return run_oracle(Path(__file__), tmp_path_factory.mktemp("jax_distill"))


def test_distill_runtime_matches_jax_distill_runtime(jax_distill):
    t_cfg, s_cfg = _pair_cfgs(get_reduced)
    batches = _batches()
    for i, b in enumerate(batches):          # the same data on both sides
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      jax_distill[f"tokens{i}"])
    with dw.DistillRuntime(t_cfg, s_cfg, teacher_parallel=ParallelConfig(),
                           student_parallel=ParallelConfig(), devices=CPU2,
                           lr=1e-3) as rt:
        devs = {n: rt.rt.device(n) for n in ("teacher", "student")}
        params = section_params_from_numpy(
            {n: load_tree(jax_distill, f"init/{n}") for n in devs}, devs)
        params, opts = rt.runtime.place(params)
        pt, ps, opt = params["teacher"], params["student"], opts["student"]
        got = []
        for i, b in enumerate(batches):
            ps, opt, m = rt.train_iteration(pt, ps, opt, b, i)
            got.append([float(m[k]) for k in
                        ("loss", "ce", "kl", "grad_norm")])
    np.testing.assert_allclose(np.asarray(got), jax_distill["metrics"],
                               **TOL)
    want = load_tree(jax_distill, "final/student")
    flat_got, flat_want = _flatten(ps, ""), _flatten(want, "")
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        np.testing.assert_allclose(_np(flat_got[k]),
                                   np.asarray(flat_want[k], np.float32),
                                   err_msg=k, **TOL)


# --------------------------------------------------------------------------- #
# 4. a trainable producer: bwd dispatches and cotangent edges
# --------------------------------------------------------------------------- #
def _toy_spec():
    cfg = get_reduced("qwen1.5-0.5b").replace(dtype="float32")
    h = wl.Port("h", (wl.SEQ, 8), "float32")

    def prod_fn(p, x):
        return {"h": torch.tanh(x["x"] @ p["w"])}

    def crit_fn(p, x):
        err = x["prod.h"] @ p["v"] - x["y"]
        return (err * err).mean()

    prod = wl.SectionSpec(
        "prod", cfg, ParallelConfig(), prod_fn,
        {"w": ParamSpec((4, 8), (None, None), dtype=torch.float32)},
        inputs={"x": wl.Field((wl.SEQ, 4))}, emits=(h,), mode="fwd_bwd")
    crit = wl.SectionSpec(
        "crit", cfg, ParallelConfig(), crit_fn,
        {"v": ParamSpec((8, 3), (None, None), dtype=torch.float32)},
        inputs={"y": wl.Field((wl.SEQ, 3))},
        consumes=(wl.Consume("prod", h),), loss=True, critical=True)
    return wl.WorkloadSpec("toy", (prod, crit), seq_len=5, global_batch=4,
                           mbs=2), prod_fn, crit_fn


def test_trainable_producer_matches_colocated_autograd(deterministic):
    spec, prod_fn, crit_fn = _toy_spec()
    rng = np.random.default_rng(3)
    batches = [{"x": rng.standard_normal((4, 5, 4)).astype(np.float32),
                "y": rng.standard_normal((4, 5, 3)).astype(np.float32)}
               for _ in range(2)]
    cfg = adamw.AdamWConfig(clip_norm=0.5)     # the joint norm clips
    with wl.CompoundRuntime(spec, devices=CPU2, opt_cfg=cfg) as rt:
        params, opts = rt.init(0)
        init = {n: tree_map(torch.clone, p) for n, p in params.items()}
        got = []
        for i, b in enumerate(batches):
            params, opts, m = rt.train_iteration(params, opts, b, i,
                                                 return_grads=True)
            got.append(m)
            assert m["n_tasks"] == {"prod": 5, "crit": 3}  # fwd/bwd x2, upd
        # per iteration: 2 hidden + 2 cotangent pushes, 2 grad-norm vectors
        assert rt.rt.queue.stats()["pushes"] == 2 * 6

    # colocated: autograd through the whole composition per microbatch
    p = {n: tree_map(torch.clone, t) for n, t in init.items()}
    o = {n: adamw.init(t) for n, t in p.items()}
    for it, b in enumerate(batches):
        x, y = torch.from_numpy(b["x"]), torch.from_numpy(b["y"])
        acc = {n: None for n in p}
        loss_sum = torch.zeros(())
        for i in range(2):
            rows = slice(2 * i, 2 * i + 2)
            w = p["prod"]["w"].detach().requires_grad_()
            v = p["crit"]["v"].detach().requires_grad_()
            loss = crit_fn({"v": v}, {"prod.h": prod_fn({"w": w}, {
                "x": x[rows]})["h"], "y": y[rows]})
            gw, gv = torch.autograd.grad(loss, [w, v])
            for n, g in (("prod", gw), ("crit", gv)):
                acc[n] = (torch.zeros_like(g) if acc[n] is None
                          else acc[n]) + g
            loss_sum = loss_sum + loss.detach()
        grads = {"prod": {"w": acc["prod"] / 2}, "crit": {"v": acc["crit"] / 2}}
        ssq = np.concatenate([
            torch.stack([g.square().sum() for g in tree_leaves(grads[n])])
            .numpy() for n in sorted(grads)])
        gnorm = torch.sqrt(torch.from_numpy(ssq).sum())
        lr = schedules.constant(it, peak_lr=1e-3)
        for n in p:
            p[n], o[n], _ = adamw.update(grads[n], o[n], lr, cfg, gnorm=gnorm)
        m = got[it]
        assert torch.equal(m["loss"], loss_sum / 2)
        assert torch.equal(m["grad_norm"], gnorm)
        for n in p:
            for a, b2 in zip(tree_leaves(m["grads"][n]),
                             tree_leaves(grads[n])):
                assert torch.equal(a, b2), n
    for n in p:
        for a, b2 in zip(tree_leaves(params[n]), tree_leaves(p[n])):
            assert torch.equal(a, b2), n


def test_inactive_producer_feeds_exact_zeros():
    """A predicate that activates nothing: no producer dispatch, no
    message, and the consumer sees the port's exact-zero fill."""
    cfg = get_reduced("qwen1.5-0.5b").replace(dtype="float32")
    h = wl.Port("h", (wl.SEQ, 2), "float32")
    seen = []

    def crit_fn(p, x):
        seen.append(x["prod.h"].clone())
        return (p["v"] * x["y"]).sum() + x["prod.h"].sum()

    prod = wl.SectionSpec(
        "prod", cfg, ParallelConfig(), lambda p, x: {"h": x["y"] + 1.0}, {},
        inputs={"y": wl.Field((wl.SEQ, 2))}, emits=(h,), mode="fwd_only",
        activation=lambda b: b["flag"] > 0)
    crit = wl.SectionSpec(
        "crit", cfg, ParallelConfig(), crit_fn,
        {"v": ParamSpec((2,), (None,), dtype=torch.float32)},
        inputs={"y": wl.Field((wl.SEQ, 2))},
        consumes=(wl.Consume("prod", h),), loss=True, critical=True)
    spec = wl.WorkloadSpec("zero", (prod, crit), seq_len=3, global_batch=4,
                           mbs=2)
    batch = {"y": np.ones((4, 3, 2), np.float32),
             "flag": np.asarray([0, 0, 1, 0], np.int32)}
    with wl.CompoundRuntime(spec, devices=CPU2) as rt:
        params, opts = rt.init(0)
        plan = rt.plan_iteration(batch)
        act = plan.activation["prod"]
        assert len(act.active_mbs) == 1
        _, _, m = rt.train_iteration(params, opts, batch, 0, plan=plan)
        assert m["n_tasks"] == {"prod": 1, "crit": 3}
        assert rt.rt.queue.stats()["pushes"] == 1
        off = [i for i in range(2) if i not in act.active_mbs][0]
        assert torch.equal(seen[off], torch.zeros(2, 3, 2))
        on = seen[act.active_mbs[0]]
        assert torch.equal(on[0], torch.full((3, 2), 2.0))   # capacity row


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    jax_distill_oracle(sys.argv[2])
