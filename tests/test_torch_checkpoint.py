"""The port's checkpointing (``repro_torch.checkpoint``) and the training
loop's checkpoint and resume, on the CPU, against the JAX package.

1. The port's counterpart of every case of ``tests/test_checkpoint.py``:
   round trip, retention, asynchronous save, atomic commit, dtype cast on
   restore, no spurious checkpoint when resuming a finished run, a missing
   leaf, the loop resuming, the straggler monitor.
2. The on-disk format both ways: a float32 and bfloat16 tree that the JAX
   ``Checkpointer`` wrote restores in the port bit for bit; a float32 tree
   the port wrote restores in JAX; the port writes the same bytes and
   manifest as JAX for the same bfloat16 tree.  JAX's own restore of a
   bfloat16 leaf raises (ROADMAP.md, C8), and the port restores that
   directory.
3. An asynchronous save, then an in-place update of every leaf: the
   checkpoint holds the values from before the update.
4. The loop's interruptions: SIGTERM and KeyboardInterrupt between steps
   write an emergency checkpoint of the steps done; a KeyboardInterrupt
   inside a step writes none (the in-place optimizer state may be torn).
5. A JAX training run of reduced qwen1.5-0.5b checkpointed at step 2
   resumes in the port: its steps 2-3 match JAX's uninterrupted steps
   within ``tests/test_torch_train.py``'s tolerance.
"""
import functools
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402,E501
from repro.data import synthetic as jdata  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.types import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.data import synthetic as tdata  # noqa: E402
from repro_torch.models.common import flatten_with_path, tree_map  # noqa: E402,E501
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.loop import StragglerMonitor, train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# tests/test_torch_train.py's tolerance and optimizer eps for trajectories
# of the port against JAX in float32
TOL = dict(atol=2e-4, rtol=2e-4)
OPT_EPS = 1e-3


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 4, generator=g),
                       "b": torch.randn(4, generator=g)},
            "opt": {"mu": torch.randn(8, 4, generator=g)}}


def _bits(x) -> np.ndarray:
    """A leaf's raw bits, from either framework."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x


def _assert_bitwise(port_tree, jax_tree):
    got = flatten_with_path(port_tree)
    want = [(".".join(str(getattr(k, "key", getattr(k, "idx",
                                                     getattr(k, "name", k))))
                      for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax_tree)[0]]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=p)


# --------------------------------------------------------------------- #
# 1. tests/test_checkpoint.py, ported
# --------------------------------------------------------------------- #
def test_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    tree = _tree()
    ck.save(10, tree)
    got = ck.restore(10, tree)
    for (pa, a), (pb, b) in zip(flatten_with_path(tree),
                                flatten_with_path(got)):
        assert pa == pb and torch.equal(a, b)


def test_latest_and_retention(tmp_path):
    ck = Checkpointer(tmp_path, keep_last_n=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s))
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_async_save_then_wait(tmp_path):
    ck = Checkpointer(tmp_path, async_save=True)
    ck.save(5, _tree())
    ck.wait()
    assert ck.latest_step() == 5
    assert ck.last_bytes == (32 + 4 + 32) * 4 and ck.last_write_s > 0


def test_atomic_no_partial_visible(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    ck.save(1, _tree())
    # a leftover tmp dir must be invisible to discovery
    (tmp_path / "step_00000002.tmp").mkdir()
    assert ck.all_steps() == [1]


def test_restore_casts_dtype(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    ck.save(1, {"w": torch.ones(4)})
    got = ck.restore(1, {"w": torch.empty(4, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], torch.ones(4, dtype=torch.bfloat16))


def test_restore_keeps_requires_grad_and_structure(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    tree = {"p": {"w": torch.ones(3, requires_grad=True)},
            "opt": tadamw.init({"w": torch.ones(3)})}
    ck.save(1, tree)
    got = ck.restore(1, tree)
    assert got["p"]["w"].requires_grad
    assert isinstance(got["opt"], tadamw.AdamWState)
    assert got["opt"].step.dtype == torch.int32
    assert [x["path"] for x in ck.manifest(1)["leaves"]] == [
        "opt.step", "opt.mu.w", "opt.nu.w", "opt.master.w", "p.w"]


def _const_step(p, o, batch, i):
    return p, o, {"loss": torch.tensor(1.0)}


def _forever(x=None):
    while True:
        yield x


def test_resume_at_num_steps_writes_no_spurious_checkpoint(tmp_path):
    params = {"w": torch.ones(2)}
    opt = {"mu": torch.zeros(2)}
    ck = Checkpointer(tmp_path, async_save=False)
    res = train(_const_step, params=params, opt_state=opt,
                batches=_forever({}), num_steps=3, checkpointer=ck,
                checkpoint_every=100, log_fn=lambda s: None)
    assert res.steps_run == 3 and res.final_step == 3
    assert ck.latest_step() == 3

    res2 = train(_const_step, params=params, opt_state=opt,
                 batches=_forever({}), num_steps=3, checkpointer=ck,
                 checkpoint_every=100, log_fn=lambda s: None)
    assert res2.resumed_from == 3
    assert res2.steps_run == 0
    assert res2.final_step == 3           # not num_steps + 1
    assert ck.all_steps() == [3], "no spurious num_steps+1 checkpoint"


def test_missing_leaf_raises(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    ck.save(1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="missing leaf b"):
        ck.restore(1, {"a": torch.zeros(2), "b": torch.zeros(2)})


def _adamw_step(params, opt, batch, idx):
    grads = {"w": params["w"] - batch}
    p, o, gn = tadamw.update(grads, opt, 0.1,
                             tadamw.AdamWConfig(weight_decay=0.0))
    return p, o, {"loss": (grads["w"] ** 2).sum(), "grad_norm": gn}


def test_train_loop_resumes(tmp_path):
    """The loop saves, and a fresh loop resumes at the right step."""
    params = {"w": torch.zeros(2)}
    ck = Checkpointer(tmp_path, async_save=False)
    r1 = train(_adamw_step, params=params, opt_state=tadamw.init(params),
               batches=_forever(torch.tensor([1.0, 2.0])), num_steps=5,
               checkpointer=ck, checkpoint_every=2, log_every=100,
               log_fn=lambda s: None)
    assert r1.final_step == 5 and ck.all_steps() == [2, 4, 5]
    # fresh state, same checkpointer -> resumes from step 5
    params2 = {"w": torch.zeros(2)}
    r2 = train(_adamw_step, params=params2, opt_state=tadamw.init(params2),
               batches=_forever(torch.tensor([1.0, 2.0])), num_steps=8,
               checkpointer=ck, checkpoint_every=100, log_every=100,
               log_fn=lambda s: None)
    assert r2.resumed_from == 5
    assert r2.steps_run == 3
    assert int(r2.opt_state.step) == 8


def test_straggler_monitor():
    mon = StragglerMonitor(factor=2.0)
    for _ in range(10):
        assert not mon.observe(0.1)
    assert mon.observe(0.5)
    assert mon.flagged == 1


# --------------------------------------------------------------------- #
# 2. the on-disk format, both ways
# --------------------------------------------------------------------- #
def _mixed_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"layers": {"w": rng.standard_normal((3, 5, 4)).astype(np.float32),
                       "scale": rng.standard_normal((3, 4)).astype(
                           np.float32)},
            "embed": rng.standard_normal((7, 4)).astype(np.float32)}


def _jax_mixed(np_tree):
    """The JAX side of a mixed tree: scale in bfloat16, the rest f32."""
    out = jax.tree_util.tree_map(jnp.asarray, np_tree)
    out["layers"]["scale"] = out["layers"]["scale"].astype(jnp.bfloat16)
    return {"params": out, "opt": jadamw.init(out)}


def _port_like(jax_tree):
    """A torch tree of the same structure, dtypes and values."""
    np_tree = jax.tree_util.tree_map(
        lambda x: np.array(x.astype(jnp.float32)), jax_tree["params"])
    params = params_from_numpy(np_tree, device="cpu")
    params["layers"]["scale"] = params["layers"]["scale"].to(torch.bfloat16)
    return {"params": params, "opt": tadamw.init(params)}


def test_jax_checkpoint_restores_in_the_port_bitwise(tmp_path):
    jtree = _jax_mixed(_mixed_np())
    JCheckpointer(tmp_path, async_save=False).save(3, jtree)
    ck = Checkpointer(tmp_path, async_save=False)
    target = tree_map(torch.zeros_like, _port_like(jtree)["params"])
    got = ck.restore(3, {"params": target,
                         "opt": tadamw.init(target)})
    assert got["params"]["layers"]["scale"].dtype == torch.bfloat16
    _assert_bitwise(got, jtree)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jtree = jax.tree_util.tree_map(jnp.asarray, _mixed_np(1))
    Checkpointer(tmp_path, async_save=False).save(
        4, params_from_numpy(_mixed_np(1), device="cpu"))
    got = JCheckpointer(tmp_path, async_save=False).restore(
        4, jax.tree_util.tree_map(jnp.zeros_like, jtree))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)), got, jtree)


def test_port_writes_the_jax_bytes_and_manifest(tmp_path):
    jtree = _jax_mixed(_mixed_np(2))
    JCheckpointer(tmp_path / "jax", async_save=False).save(5, jtree)
    Checkpointer(tmp_path / "port", async_save=False).save(
        5, _port_like(jtree))
    jdir, tdir = (tmp_path / w / "step_00000005" for w in ("jax", "port"))
    jm, tm = (json.loads((d / "manifest.json").read_text())
              for d in (jdir, tdir))
    assert jm.pop("time") and tm.pop("time")
    assert tm == jm
    assert any(x["dtype"] == "bfloat16" for x in tm["leaves"])
    for leaf in jm["leaves"]:
        assert ((tdir / leaf["file"]).read_bytes()
                == (jdir / leaf["file"]).read_bytes()), leaf["path"]


def test_c8_jax_cannot_restore_bf16_where_the_port_can(tmp_path):
    """ROADMAP.md, C8: numpy loads a bfloat16 leaf as raw 2-byte words, and
    the JAX restore's ``astype(bfloat16)`` has no cast from them."""
    jtree = _jax_mixed(_mixed_np(3))
    jck = JCheckpointer(tmp_path, async_save=False)
    jck.save(6, jtree)
    with pytest.raises(ValueError, match="cast"):
        jck.restore(6, jtree)
    port = _port_like(jtree)
    got = Checkpointer(tmp_path, async_save=False).restore(6, port)
    _assert_bitwise(got, jtree)


# --------------------------------------------------------------------- #
# 3. an asynchronous save against in-place updates
# --------------------------------------------------------------------- #
def test_async_save_then_in_place_update_keeps_the_old_values(tmp_path):
    g = torch.Generator().manual_seed(4)
    params = {"w": torch.randn(256, 256, generator=g),
              "s": torch.randn(64, generator=g).to(torch.bfloat16)}
    tree = {"params": params, "opt": tadamw.init(params)}
    before = tree_map(torch.clone, tree["params"])
    opt_before = [x.clone() for _, x in flatten_with_path(tree["opt"])]
    ck = Checkpointer(tmp_path, async_save=True)
    ck.save(1, tree)
    for _, x in flatten_with_path(tree):
        x.add_(1)                           # every leaf, at once
    ck.wait()
    got = ck.restore(1, tree)
    for k in before:
        assert torch.equal(got["params"][k], before[k])
    for (_, a), b in zip(flatten_with_path(got["opt"]), opt_before):
        assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# 4. interruptions
# --------------------------------------------------------------------- #
def _counting(stop_at, exc):
    i = 0
    while True:
        if i == stop_at:
            raise exc
        i += 1
        yield torch.tensor([1.0, 2.0])


def test_keyboard_interrupt_between_steps_saves_the_steps_done(tmp_path):
    params = {"w": torch.zeros(2)}
    ck = Checkpointer(tmp_path, async_save=True)
    res = train(_adamw_step, params=params, opt_state=tadamw.init(params),
                batches=_counting(3, KeyboardInterrupt), num_steps=10,
                checkpointer=ck, checkpoint_every=100, log_fn=lambda s: None)
    assert res.final_step == 3 and ck.all_steps() == [3]
    got = ck.restore(3, {"params": params, "opt": tadamw.init(params)})
    assert int(got["opt"].step) == 3


def test_keyboard_interrupt_inside_a_step_writes_no_checkpoint(tmp_path):
    params = {"w": torch.zeros(2)}
    calls = []

    def step(p, o, batch, i):
        calls.append(i)
        if i == 2:
            raise KeyboardInterrupt
        return _adamw_step(p, o, batch, i)

    logs = []
    ck = Checkpointer(tmp_path, async_save=True)
    res = train(step, params=params, opt_state=tadamw.init(params),
                batches=_forever(torch.tensor([1.0, 2.0])), num_steps=10,
                checkpointer=ck, checkpoint_every=2, log_fn=logs.append)
    assert calls == [0, 1, 2] and res.final_step == 2
    assert ck.all_steps() == [2]          # the periodic one, none after
    assert "no emergency checkpoint" in logs[-1]


def test_sigterm_finishes_the_step_and_saves():
    """In a process of its own, whose main thread takes the signal."""
    code = textwrap.dedent("""
        import signal, sys, tempfile, torch
        from repro_torch.checkpoint import Checkpointer
        from repro_torch.optim import adamw
        from repro_torch.train.loop import train

        def step(p, o, batch, i):
            g = {"w": p["w"] - batch}
            p, o, gn = adamw.update(g, o, 0.1)
            return p, o, {"loss": (g["w"] ** 2).sum(), "grad_norm": gn}

        def batches():
            i = 0
            while True:
                if i == 1:
                    signal.raise_signal(signal.SIGTERM)
                i += 1
                yield torch.tensor([1.0, 2.0])

        d = tempfile.mkdtemp()
        ck = Checkpointer(d)
        p = {"w": torch.zeros(2)}
        res = train(step, params=p, opt_state=adamw.init(p),
                    batches=batches(), num_steps=10, checkpointer=ck,
                    checkpoint_every=100, log_fn=print)
        print("RESULT", res.final_step, ck.all_steps(),
              signal.getsignal(signal.SIGTERM) is signal.SIG_DFL)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "SIGTERM — emergency checkpoint" in out.stdout
    assert "RESULT 2 [2] True" in out.stdout


# --------------------------------------------------------------------- #
# 5. a JAX run resumed in the port
# --------------------------------------------------------------------- #
def test_jax_run_checkpointed_at_step_2_resumes_in_the_port(tmp_path):
    name, B, S, seed = "qwen1.5-0.5b", 4, 16, 3
    jcfg = jcfgs.get_reduced(name).replace(dtype="float32")
    tcfg = tcfgs.get_reduced(name).replace(dtype="float32")
    jm = jbuild(jcfg)
    rng = np.random.default_rng(seed)
    jparams = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(0.05 * rng.standard_normal(x.shape),
                                  x.dtype), jm.init(jax.random.PRNGKey(seed)))
    sched = dict(peak_lr=1e-2, warmup_steps=1, total_steps=4)
    opt_cfg = jadamw.AdamWConfig(eps=OPT_EPS)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b),
                                         has_aux=True))
    update = jax.jit(lambda g, o, lr: jadamw.update(g, o, lr, opt_cfg))
    jopt = jadamw.init(jparams)
    jit = jdata.lm_batches(batch=B, seq_len=S, vocab=tcfg.vocab_size,
                           seed=7)
    jlosses = []
    for i in range(4):
        (loss, _), grads = grad_fn(jparams, next(jit))
        jparams, jopt, _ = update(
            grads, jopt, jsched.warmup_cosine(jnp.int32(i), **sched))
        jlosses.append(float(loss))
        if i == 1:
            JCheckpointer(tmp_path, async_save=False).save(
                2, {"params": jparams, "opt": jopt})

    # the port: a model of another seed, resumed from the JAX checkpoint
    # on the batches from index 2 on
    tm = tbuild(tcfg, device="cpu", seed=11)
    step = tstep.build_train_step(
        tm, ParallelConfig(mbs=B), ShapeConfig("t", "train", S, B),
        lr_schedule=functools.partial(tsched.warmup_cosine, **sched),
        opt_cfg=tadamw.AdamWConfig(eps=OPT_EPS))
    batches = tdata.lm_batches(batch=B, seq_len=S, vocab=tcfg.vocab_size,
                               seed=7, device="cpu")
    for _ in range(2):
        next(batches)
    params = tm.param_tree()
    res = train(step, params=params, opt_state=tadamw.init(params),
                batches=batches, num_steps=4,
                checkpointer=Checkpointer(tmp_path, async_save=False),
                checkpoint_every=100, log_fn=lambda s: None)
    assert res.resumed_from == 2 and res.steps_run == 2
    np.testing.assert_allclose(res.losses, jlosses[2:], **TOL)
    got = flatten_with_path(res.params)
    want = jax.tree_util.tree_leaves(jparams)
    assert len(got) == len(want)
    for (p, a), b in zip(got, want):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), **TOL,
                                   err_msg=p)
    assert int(res.opt_state.step) == int(jopt.step) == 4
