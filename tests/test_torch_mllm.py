"""MLLM training on the port (``repro_torch.mllm.workload``), on the CPU in
float32, at the reduced pairing of ``tests/drivers/driver_mllm_runtime.py``:
the reduced pixtral-12b LM (vocab 256, vision_dim 32, K = 4 image slots)
and a 2-layer ViT (d_model 32, patch_dim 16, downsample 4), batch 16 x 32
in microbatches of 4, ``AdamWConfig(clip_norm=0.0)`` unless stated.

1. The port's ``build_colocated_step`` against the JAX
   ``build_colocated_step`` on a one-device ``section_mesh`` (its axes are
   Auto; ROADMAP.md, C0), 3 steps from the JAX init on the same
   microbatch composition: losses, grad norms and both sections' params
   within atol = rtol = 2e-4 (``tests/test_torch_distill.py``'s tolerance
   for 3 colocated steps).  The first batch's wavefront plan holds a
   microbatch whose one image sample sits at local index 0 beside padding
   rows that repeat index 0 with ``valid = 0``.
2. The port's ``MLLMRuntime`` on ``["cpu", "cpu"]`` against the port's
   colocated step, bitwise under ``torch.use_deterministic_algorithms``,
   on a mixed and on an all-text batch (where the vision section runs only
   its ``upd`` and the queue carries only the 2-push grad-norm
   rendezvous), and streamed (``lookahead=1``) against serialized.
3. The port's ``MLLMRuntime`` against the JAX ``MLLMRuntime`` (dp = 1 per
   section, two virtual devices, in a subprocess of this file: ``python
   tests/test_torch_mllm.py --jax-oracle out.npz``), 3 iterations on the
   JAX run's plans from its init, within 2e-4.  Not bitwise: on this JAX
   the JAX runtime and its own colocated oracle differ by ~1.5e-8
   (ROADMAP.md, C0).
4. Clipping active: the runtime's joint grad norm drives the same clip as
   the colocated step's.
"""
import os
import sys
import threading

if __name__ == "__main__":
    # the JAX oracle: two virtual CPU devices, set before JAX is imported
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import repro_torch.core.workload as wl  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.types import ParallelConfig  # noqa: E402
from repro_torch.data.synthetic import vlm_batches  # noqa: E402
from repro_torch.mllm import workload as mw  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.vlm import vit_config  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_compound import (TOL, _flatten, _np, load_tree,  # noqa: E402
                                 run_oracle, save_tree)

B, S, K, MBS, VOCAB, PD, ITERS = 16, 32, 4, 4, 256, 16, 3
ALL_TEXT = 1                 # the iteration whose batch holds no image
CPU2 = ["cpu", "cpu"]


def _cfgs(get_reduced_, vit_config_):
    """The reduced pairing of tests/drivers/driver_mllm_runtime.py."""
    lm = get_reduced_("pixtral-12b").replace(
        dtype="float32", vocab_size=VOCAB, vision_dim=32,
        max_image_tokens=K)
    vit = vit_config_(num_layers=2, d_model=32, num_heads=2, d_ff=64,
                      patch_dim=PD, downsample=4, out_dim=32,
                      name="vit-tiny").replace(dtype="float32")
    return vit, lm


def _batches(gen_fn, **kw):
    """Iterations 0 and 2 mixed (vlm_batches seed 0), iteration 1 all text
    (seed 1, vision ratio 0)."""
    mixed = gen_fn(batch=B, seq_len=S, vocab=VOCAB, vision_ratio=0.5,
                   image_tokens=K, patch_dim=PD, seed=0, **kw)
    text = gen_fn(batch=B, seq_len=S, vocab=VOCAB, vision_ratio=0.0,
                  image_tokens=K, patch_dim=PD, seed=1, **kw)
    return [next(mixed), next(text), next(mixed)]


def _dup_index_zero(plan) -> bool:
    """A microbatch whose only image sample sits at local index 0 while
    padding rows repeat index 0 (valid 0)."""
    return any(v[0] == 1 and v[1:].sum() == 0 and (i == 0).all()
               for i, v in zip(plan.vis_idx, plan.vis_valid))


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _jax_init():
    import jax
    from repro.configs import get_reduced as jreduced
    from repro.mllm.workload import init_compound_params as jinit
    from repro.models.vlm import vit_config as jvit
    vit, lm = _cfgs(jreduced, jvit)
    return jax.tree_util.tree_map(np.asarray,
                                  jinit(vit, lm, jax.random.PRNGKey(0)))


def _port_setup():
    vit, lm = _cfgs(get_reduced, vit_config)
    return vit, lm, _batches(vlm_batches, device="cpu")


def _clone(tree):
    return tree_map(torch.clone, tree)


# --------------------------------------------------------------------------- #
# 1. colocated step against the JAX colocated step
# --------------------------------------------------------------------------- #
def test_colocated_step_matches_jax_colocated_step():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jreduced
    from repro.core.types import ParallelConfig as JParallel
    from repro.data.synthetic import vlm_batches as jvlm_batches
    from repro.dist.sharding import section_mesh
    from repro.mllm import workload as jmw
    from repro.models.vlm import vit_config as jvit
    from repro.optim import adamw as jadamw

    jvit_cfg, jlm_cfg = _cfgs(jreduced, jvit)
    vit, lm, batches = _port_setup()
    jbatches = _batches(jvlm_batches)
    opt_cfg = adamw.AdamWConfig(clip_norm=0.0)
    init = _jax_init()
    with mw.MLLMRuntime(vit, lm, vit_parallel=ParallelConfig(),
                        lm_parallel=ParallelConfig(), global_batch=B,
                        seq_len=S, mbs=MBS, devices=CPU2) as rt:
        plans = [rt.plan_iteration(b["has_image"]) for b in batches]
    assert _dup_index_zero(plans[0]), plans[0].vis_idx
    assert plans[ALL_TEXT].image_mbs == ()

    mesh = section_mesh(jax.devices()[:1], JParallel(), "oracle")
    jstep, shard = jmw.build_colocated_step(
        jvit_cfg, jlm_cfg, mesh, mbs=MBS, seq_len=S, impl="ref",
        opt_cfg=jadamw.AdamWConfig(clip_norm=0.0))
    jp = jax.device_put(jax.tree_util.tree_map(jnp.asarray, init),
                        shard["params"])
    jo = jax.device_put(jadamw.init(jp), shard["opt"])
    step = mw.build_colocated_step(vit, lm, device="cpu", opt_cfg=opt_cfg)
    tp = params_from_numpy(init, device="cpu")
    to = adamw.init(tp)
    for i, (b, jb, plan) in enumerate(zip(batches, jbatches, plans)):
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      np.asarray(jb["tokens"]))
        jplan = jmw.build_plan(plan.order, np.asarray(jb["has_image"]), MBS)
        mine = mw.build_plan(plan.order, b["has_image"].numpy(), MBS)
        for got in (jplan, mine):
            assert got.image_mbs == plan.image_mbs
            np.testing.assert_array_equal(got.vis_idx, plan.vis_idx)
            np.testing.assert_array_equal(got.vis_valid, plan.vis_valid)
        jp, jo, jm = jstep(jp, jo, jmw.colocated_batch(jb, jplan),
                           jnp.int32(i))
        tp, to, tm = step(tp, to, mw.colocated_batch(b, plan), i)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       err_msg=f"{k} at step {i}", **TOL)
    want = _flatten(jax.tree_util.tree_map(np.asarray, jp), "")
    have = _flatten(tp, "")
    assert have.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(_np(have[k]), want[k], err_msg=k, **TOL)


# --------------------------------------------------------------------------- #
# 2. the runtime against the port's colocated step, bitwise
# --------------------------------------------------------------------------- #
def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_runtime_equals_colocated_step_bitwise(deterministic):
    vit, lm, batches = _port_setup()
    opt_cfg = adamw.AdamWConfig(clip_norm=0.0)
    init = mw.init_compound_params(vit, lm, seed=0, device="cpu")
    step = mw.build_colocated_step(vit, lm, device="cpu", opt_cfg=opt_cfg,
                                   return_grads=True)
    with mw.MLLMRuntime(vit, lm, vit_parallel=ParallelConfig(),
                        lm_parallel=ParallelConfig(), global_batch=B,
                        seq_len=S, mbs=MBS, devices=CPU2,
                        opt_cfg=opt_cfg) as rt:
        params, opts = rt.place(_clone(init))
        cp, co = _clone(init), adamw.init(init)
        plans, losses = [], []
        for i, b in enumerate(batches):
            plan = rt.plan_iteration(b["has_image"], reorder=True)
            fifo = rt.plan_iteration(b["has_image"], reorder=False)
            assert fifo.order == tuple(range(B))
            assert len(plan.image_mbs) <= len(fifo.image_mbs)
            pushes = rt.rt.queue.stats()["pushes"]
            params, opts, m = rt.train_iteration(params, opts, b, i,
                                                 plan=plan,
                                                 return_grads=True)
            cp, co, om = step(cp, co, mw.colocated_batch(b, plan), i)
            assert torch.equal(m["loss"], om["loss"]), i
            assert torch.equal(m["grad_norm"], om["grad_norm"]), i
            for sec in ("lm", "vit"):
                assert _equal_trees(m["grads"][sec], om["grads"][sec]), \
                    (i, sec)
                assert _equal_trees(params[sec], cp[sec]), (i, sec)
            ex, n_img = m["execution"], len(plan.image_mbs)
            assert m["n_vit_tasks"] == 2 * n_img
            assert set(ex.dispatch_order["vit"]) == (
                {f"fwd{j}" for j in plan.image_mbs}
                | {f"bwd{j}" for j in plan.image_mbs} | {"upd"})
            ends = {(e.section, e.tag): e.end for e in ex.timeline}
            starts = {(e.section, e.tag): e.start for e in ex.timeline}
            for j in plan.image_mbs:
                # the orders the runtime promises: the LM task pulls the
                # embedding, so the ViT's forward ends first; the ViT's
                # backward pulls the cotangent the LM task pushes before
                # it accumulates its own gradients, so the backward starts
                # (its start is stamped after that pull) once the LM task
                # has started, and may end before the LM task does
                assert ends[("vit", f"fwd{j}")] <= ends[("llm", f"mb{j}")]
                assert starts[("llm", f"mb{j}")] \
                    <= starts[("vit", f"bwd{j}")] <= ends[("vit", f"bwd{j}")]
            # embeddings and their cotangents, plus the grad-norm pair
            assert rt.rt.queue.stats()["pushes"] - pushes == 2 * n_img + 2
            plans.append(plan)
            losses.append(m["loss"])
            if i == ALL_TEXT:
                text_m = m
        assert _dup_index_zero(plans[0])
        # the all-text iteration: the vision section ran only its update
        # (exact-zero gradients; weight decay moves its weights), and the
        # queue carried only the grad-norm pair
        assert plans[ALL_TEXT].image_mbs == ()
        assert [e.tag for e in text_m["execution"].timeline
                if e.section == "vit"] == ["upd"]
        assert text_m["n_vit_tasks"] == 0

        # streamed (lookahead 1) equals serialized
        rt.lookahead = 1
        sp, so = rt.place(_clone(init))
        rt.install(sp, so)
        depth = 0
        for i, b in enumerate(batches):
            rt.submit_iteration(b, i, plan=plans[i])
            depth = max(depth, rt.in_flight)
        ms = rt.drain()
        assert depth == 2 and rt.in_flight == 0 and len(ms) == ITERS
        assert all(torch.equal(m["loss"], want)
                   for m, want in zip(ms, losses))
        sp, _ = rt.state()
    assert _equal_trees(sp, params)


# --------------------------------------------------------------------------- #
# 3. the runtime against the JAX MLLMRuntime
# --------------------------------------------------------------------------- #
def jax_mllm_oracle(path: str) -> None:
    """Three iterations of the JAX MLLMRuntime on two virtual devices."""
    import jax
    from repro.configs import get_reduced as jreduced
    from repro.core.types import ParallelConfig as JParallel
    from repro.data.synthetic import vlm_batches as jvlm_batches
    from repro.mllm.workload import MLLMRuntime as JMLLMRuntime
    from repro.models.vlm import vit_config as jvit
    from repro.optim import adamw as jadamw

    assert len(jax.devices()) == 2, jax.devices()
    vit, lm = _cfgs(jreduced, jvit)
    rt = JMLLMRuntime(vit, lm, vit_parallel=JParallel(),
                      lm_parallel=JParallel(), global_batch=B, seq_len=S,
                      mbs=MBS, impl="ref",
                      opt_cfg=jadamw.AdamWConfig(clip_norm=0.0))
    # One-device section meshes: the JAX runtime may trace a jit again on
    # its worker thread, reading the process-global activation hook that
    # the other section's concurrent trace may have set (ROADMAP.md, C6).
    # One lock around every jitted call of the runtime keeps traces one at
    # a time; nothing inside waits on the queue, and the arithmetic is
    # the runtime's own.
    crt, lock = rt._crt, threading.Lock()

    def one_at_a_time(fn):
        def call(*args, **kw):
            with lock:
                return fn(*args, **kw)
        return call

    for name in ("_fwd", "_bwd", "_update", "_ssq"):
        setattr(crt, name, {k: one_at_a_time(f)
                            for k, f in getattr(crt, name).items()})
    crt._grad = one_at_a_time(crt._grad)
    params_host = _jax_init()
    params, opts = rt.place(params_host)
    out = {}
    save_tree(out, params_host, "init")
    mets = []
    for i, batch in enumerate(_batches(jvlm_batches)):
        host = {k: np.asarray(v) for k, v in batch.items()}
        plan = rt.plan_iteration(host["has_image"], reorder=True)
        out[f"tokens{i}"] = host["tokens"]
        out[f"has_image{i}"] = host["has_image"]
        out[f"order{i}"] = np.asarray(plan.order)
        out[f"active{i}"] = np.asarray(plan.image_mbs, np.int64)
        out[f"idx{i}"], out[f"valid{i}"] = plan.vis_idx, plan.vis_valid
        params, opts, m = rt.train_iteration(params, opts, batch, i,
                                             plan=plan)
        out[f"vit_tasks{i}"] = np.asarray(m["n_vit_tasks"])
        mets.append([float(m["loss"]), float(m["grad_norm"])])
    out["metrics"] = np.asarray(mets, np.float64)
    save_tree(out, jax.tree_util.tree_map(np.asarray, params), "final")
    rt.shutdown()
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_mllm(tmp_path_factory):
    return run_oracle(Path(__file__), tmp_path_factory.mktemp("jax_mllm"))


def _plan(npz, i) -> mw.IterationPlan:
    act = wl.SectionActivation(tuple(int(x) for x in npz[f"active{i}"]),
                               npz[f"idx{i}"], npz[f"valid{i}"])
    return mw.IterationPlan(tuple(int(x) for x in npz[f"order{i}"]), MBS,
                            B // MBS, {"vit": act})


def test_runtime_matches_jax_mllm_runtime(jax_mllm):
    vit, lm, batches = _port_setup()
    for i, b in enumerate(batches):           # the same data on both sides
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      jax_mllm[f"tokens{i}"])
        np.testing.assert_array_equal(b["has_image"].numpy(),
                                      jax_mllm[f"has_image{i}"])
    init = params_from_numpy(load_tree(jax_mllm, "init"), device="cpu")
    got = []
    with mw.MLLMRuntime(vit, lm, vit_parallel=ParallelConfig(),
                        lm_parallel=ParallelConfig(), global_batch=B,
                        seq_len=S, mbs=MBS, devices=CPU2,
                        opt_cfg=adamw.AdamWConfig(clip_norm=0.0)) as rt:
        params, opts = rt.place(init)
        for i, b in enumerate(batches):
            plan = _plan(jax_mllm, i)
            # the port's planner makes the JAX run's plan
            mine = rt.plan_iteration(b["has_image"])
            assert mine.order == plan.order, i
            np.testing.assert_array_equal(mine.vis_idx, plan.vis_idx)
            params, opts, m = rt.train_iteration(params, opts, b, i,
                                                 plan=plan)
            assert m["n_vit_tasks"] == int(jax_mllm[f"vit_tasks{i}"])
            got.append([float(m["loss"]), float(m["grad_norm"])])
    assert _dup_index_zero(_plan(jax_mllm, 0))
    np.testing.assert_allclose(np.asarray(got), jax_mllm["metrics"], **TOL)
    want = _flatten(load_tree(jax_mllm, "final"), "")
    have = _flatten(params, "")
    assert have.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(_np(have[k]),
                                   np.asarray(want[k], np.float32),
                                   err_msg=k, **TOL)


# --------------------------------------------------------------------------- #
# 4. clipping active
# --------------------------------------------------------------------------- #
def test_clip_active_joint_grad_norm(deterministic):
    vit, lm, batches = _port_setup()
    clip = adamw.AdamWConfig(clip_norm=0.05)
    init = mw.init_compound_params(vit, lm, seed=3, device="cpu")
    with mw.MLLMRuntime(vit, lm, vit_parallel=ParallelConfig(),
                        lm_parallel=ParallelConfig(), global_batch=B,
                        seq_len=S, mbs=MBS, devices=CPU2,
                        opt_cfg=clip) as rt:
        params, opts = rt.place(_clone(init))
        plan = rt.plan_iteration(batches[0]["has_image"])
        params, _, m = rt.train_iteration(params, opts, batches[0], 0,
                                          plan=plan)
    step = mw.build_colocated_step(vit, lm, device="cpu", opt_cfg=clip)
    cp, _, om = step(_clone(init), adamw.init(init),
                     mw.colocated_batch(batches[0], plan), 0)
    assert float(m["grad_norm"]) > clip.clip_norm, \
        "clipping must fire for this check to mean anything"
    assert torch.equal(m["grad_norm"], om["grad_norm"])
    assert torch.equal(m["loss"], om["loss"])
    assert _equal_trees(params, cp)
    # and the clip changed the update: unclipped differs
    free = mw.build_colocated_step(vit, lm, device="cpu",
                                   opt_cfg=adamw.AdamWConfig(clip_norm=0.0))
    up, _, _ = free(_clone(init), adamw.init(init),
                    mw.colocated_batch(batches[0], plan), 0)
    assert not _equal_trees(up, cp)


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    jax_mllm_oracle(sys.argv[2])
