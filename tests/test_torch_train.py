"""The port's training half against the JAX package, on the CPU in float32.

* the blockwise flash backward (``kernels.flash_attention.flash_bwd``)
  against ``jax.vjp`` of ``repro.kernels.ref.flash_attention_jnp_lse``,
  with a nonzero lse cotangent, over ``tests/test_kernels_flash.py``'s
  sweep, and the autograd Functions' wiring with the plain forward standing
  in for the CUDA one;
* ``Model.loss`` and its gradients for reduced granite-3-8b and
  qwen1.5-0.5b;
* AdamW, the schedules, ``lm_batches`` and the micro-batch split;
* three steps of ``build_train_step`` against ``jax.value_and_grad`` of
  the same loss plus ``repro.optim.adamw.update`` and the schedule:
  per-step loss and grad norm, parameters after the last step;
* micro-batch accumulation equal to the full batch, the learning check of
  ``tests/test_system.py`` and the training CLI.

Inputs come from seeded numpy; weights are the JAX model's init plus
seeded noise, carried across with ``convert.params_from_numpy``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.train import step as jstep  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.types import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.data import synthetic as tdata  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.loop import train as ttrain  # noqa: E402

# float32 on both sides; the two frameworks sum matrix products and
# reductions in different orders, and gradients pass through a few layers
# of them: 2e-4 is tests/test_models_smoke.py's tolerance, far below what a
# wrong mask, sign or scale moves
TOL = dict(atol=2e-4, rtol=2e-4)
SHAPES = [(2, 128, 128, 4, 2, 16), (1, 256, 256, 8, 8, 32),
          (2, 128, 64, 4, 1, 16), (1, 64, 64, 6, 3, 8)]
MODES = [(True, 0), (False, 0), (True, 32)]
# Adam divides each gradient by its own root mean square, so on an element
# whose gradient is rounding noise (attention's key bias has an exact zero
# gradient: softmax ignores a constant shift) the two frameworks' noise
# becomes steps of +-lr in either direction.  Trajectory tests give both
# sides eps = 1e-3, which leaves steps on real gradients (|g| >> 1e-3)
# near lr and shrinks steps on noise-level ones to nothing.
OPT_EPS = 1e-3


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(port, jax_value, tol=TOL):
    np.testing.assert_allclose(_np(port), _np(jax_value), **tol)


def _close_trees(port_tree, jax_tree, tol=TOL):
    flat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    for path, leaf in flat:
        t = port_tree
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(_np(t), _np(leaf), err_msg=str(path),
                                   **tol)


# --------------------------------------------------------------------------- #
# flash attention backward
# --------------------------------------------------------------------------- #
def _flash_case(shape, causal, window, seed, q_offset=0, positions=None):
    B, S, T, H, KV, D = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, T, KV, D), dtype=np.float32)
    v = rng.standard_normal((B, T, KV, D), dtype=np.float32)
    vis = ref.visible_mask(
        S, T, causal=causal, window=window, q_offset=q_offset,
        kv_positions=None if positions is None
        else torch.from_numpy(positions)).any(dim=1).numpy()
    # cotangents are zero on rows with no visible key, where the JAX
    # versions' o is blocking-dependent (ROADMAP.md, C1)
    do = rng.standard_normal((B, S, H, D), dtype=np.float32) * vis[:, None,
                                                                   None]
    dlse = rng.standard_normal((B, S, H), dtype=np.float32) * vis[:, None]
    return q, k, v, do, dlse


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal,window", MODES)
def test_flash_bwd_matches_jax_vjp(shape, causal, window):
    q, k, v, do, dlse = _flash_case(shape, causal, window, seed=0)
    kw = dict(causal=causal, window=window)
    (o_j, lse_j), vjp = jax.vjp(
        lambda a, b, c: jref.flash_attention_jnp_lse(
            a, b, c, block_q=64, block_kv=64, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = ref.flash_attention_ref(tq, tk, tv, **kw)
    got = fa.flash_bwd(tq, tk, tv, o, lse, torch.from_numpy(do),
                       torch.from_numpy(dlse), block=48, **kw)
    for g, w in zip(got, want):
        _close(g, w, dict(atol=1e-4, rtol=1e-4))


@pytest.mark.parametrize("with_lse", [False, True])
def test_flash_bwd_kv_positions_and_q_offset(with_lse):
    shape = (1, 64, 128, 4, 2, 32)
    pos = np.random.default_rng(3).permutation(128).astype(np.int32)
    kw = dict(causal=True, window=24, q_offset=32)
    q, k, v, do, dlse = _flash_case(shape, True, 24, 1, 32, pos)
    if not with_lse:
        dlse = np.zeros_like(dlse)
    (_, _), vjp = jax.vjp(
        lambda a, b, c: jref.flash_attention_jnp_lse(
            a, b, c, kv_positions=jnp.asarray(pos), block_q=64, block_kv=64,
            **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tpos = torch.from_numpy(pos)
    o, lse = ref.flash_attention_ref(tq, tk, tv, kv_positions=tpos, **kw)
    got = fa.flash_bwd(tq, tk, tv, o, lse, torch.from_numpy(do),
                       torch.from_numpy(dlse) if with_lse else None,
                       kv_positions=tpos, block=32, **kw)
    for g, w in zip(got, want):
        _close(g, w, dict(atol=1e-4, rtol=1e-4))


@pytest.fixture
def plain_forward_on_cpu(monkeypatch):
    """The CUDA forward replaced by the plain version, so that the autograd
    Functions run on CPU tensors."""
    def fwd(q, k, v, **kw):
        assert not torch.is_grad_enabled()
        return ref.flash_attention_ref(q, k, v, **kw)
    monkeypatch.setattr(fa, "flash_fwd", fwd)


@pytest.mark.parametrize("causal,window", MODES)
def test_flash_functions_differentiate_like_the_plain_version(
        plain_forward_on_cpu, causal, window):
    q, k, v, do, dlse = _flash_case((2, 100, 100, 4, 2, 16), causal,
                                    window, seed=2)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tdo, tdlse = torch.from_numpy(do), torch.from_numpy(dlse)
    o, lse = fa.FlashAttentionLse.apply(*leaves, None, causal, window, None,
                                        0)
    got = torch.autograd.grad((o * tdo).sum() + (lse * tdlse).sum(), leaves)
    o_only = fa.FlashAttention.apply(*leaves, None, causal, window, None, 0)
    got_o = torch.autograd.grad((o_only * tdo).sum(), leaves)
    o_r, lse_r = ref.flash_attention_ref(*leaves, causal=causal,
                                         window=window)
    want = torch.autograd.grad((o_r * tdo).sum() + (lse_r * tdlse).sum(),
                               leaves, retain_graph=True)
    want_o = torch.autograd.grad((o_r * tdo).sum(), leaves)
    for g, w in zip(got + got_o, want + want_o):
        _close(g, w, dict(atol=1e-5, rtol=1e-5))


def test_flash_fwd_refuses_to_drop_a_gradient():
    q = torch.zeros(1, 8, 2, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="ops.flash_attention"):
        fa.flash_fwd(q, q.detach(), q.detach())


def test_cpu_attention_is_differentiable_through_ops():
    q, k, v, do, _ = _flash_case((1, 40, 40, 4, 2, 16), True, 8, seed=4)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=True, window=8)
    assert o.grad_fn is not None
    grads = torch.autograd.grad((o * torch.from_numpy(do)).sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# --------------------------------------------------------------------------- #
# the model's loss and gradients
# --------------------------------------------------------------------------- #
def _pair(name, seed=0, **over):
    """JAX model + params (init plus seeded noise) and the port's copy."""
    jcfg = jcfgs.get_reduced(name).replace(dtype="float32", **over)
    tcfg = tcfgs.get_reduced(name).replace(dtype="float32", **over)
    jm = jbuild(jcfg)
    rng = np.random.default_rng(seed)
    np_tree = jax.tree_util.tree_map(
        lambda x: (np.asarray(x, np.float32)
                   + 0.05 * rng.standard_normal(x.shape, dtype=np.float32)),
        jm.init(jax.random.PRNGKey(seed)))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    tm = tbuild(tcfg, params_from_numpy(np_tree, device="cpu"), device="cpu")
    return jm, jparams, tm


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32),
          "loss_mask": jnp.asarray(mask)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
          "loss_mask": torch.from_numpy(mask)}
    return jb, tb


@pytest.mark.parametrize("name", ["granite-3-8b", "qwen1.5-0.5b"])
@pytest.mark.parametrize("remat", [True, False])
def test_model_loss_and_grads_match_jax(name, remat):
    jm, jparams, tm = _pair(name, seed=1)
    jb, tb = _batch(tm.cfg, 2, 24, seed=2)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True)(jparams)
    params = tm.param_tree()
    loss, met = tm.loss(tb, remat=remat)
    grads = torch.autograd.grad(loss, tcm.tree_leaves(params))
    _close(loss, jloss)
    _close(met["ce"], jmet["ce"])
    _close_trees(tcm.tree_unflatten(params, grads), jgrads)


def test_bf16_gradients_keep_the_parameter_dtype():
    cfg = tcfgs.get_reduced("qwen1.5-0.5b").replace(dtype="bfloat16")
    tm = tbuild(cfg, device="cpu", seed=0)
    _, tb = _batch(cfg, 2, 16, seed=3)
    x = tm.param_tree()["embed"][tb["tokens"]].detach().requires_grad_()
    y = tcm.rms_norm(x, tm.param_tree()["final_norm"]["scale"], 1e-5)
    (gx,) = torch.autograd.grad(y.float().square().sum(), [x])
    assert gx.dtype == torch.bfloat16
    loss, _ = tm.loss(tb)
    params = tm.param_tree()
    grads = torch.autograd.grad(loss, tcm.tree_leaves(params))
    for g, p in zip(grads, tcm.tree_leaves(params)):
        assert g.dtype == p.dtype == torch.bfloat16


def test_serving_methods_stay_outside_autograd():
    _, _, tm = _pair("granite-3-8b")
    _, tb = _batch(tm.cfg, 1, 8, seed=4)
    assert all(p.requires_grad for p in tm.parameters())
    assert tm(tb).grad_fn is None
    logits, _ = tm.prefill({"tokens": tb["tokens"]})
    assert logits.grad_fn is None


# --------------------------------------------------------------------------- #
# optimizer, schedules, data, micro-batches
# --------------------------------------------------------------------------- #
def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 6)).astype(dtype),
            "b": {"c": rng.standard_normal((3,)).astype(dtype)}}


@pytest.mark.parametrize("clip", [1.0, 0.0, 100.0])
def test_adamw_matches_jax(clip):
    cfg_j = jadamw.AdamWConfig(clip_norm=clip)
    cfg_t = tadamw.AdamWConfig(clip_norm=clip)
    p0 = _tree(0)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = params_from_numpy(p0, device="cpu")
    js, ts = jadamw.init(jp), tadamw.init(tp)
    for i in range(3):
        g = jax.tree_util.tree_map(lambda x: x * (i + 1), _tree(10 + i))
        jp, js, jn = jadamw.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   js, jnp.float32(1e-2), cfg_j)
        tp, ts, tn = tadamw.update(params_from_numpy(g, device="cpu"), ts,
                                   torch.tensor(1e-2), cfg_t)
        _close(tn, jn, dict(atol=1e-6, rtol=1e-6))
    _close_trees(tp, jp, dict(atol=1e-6, rtol=1e-6))
    _close_trees(ts.master, js.master, dict(atol=1e-6, rtol=1e-6))
    assert int(ts.step) == int(js.step) == 3


def test_adamw_returns_params_in_the_grads_dtype_without_aliasing():
    p = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    st = tadamw.init(p)
    assert st.master["w"].dtype == torch.float32
    assert st.master["w"].data_ptr() != p["w"].data_ptr()
    new, st2, _ = tadamw.update({"w": torch.ones(4, 4, dtype=torch.bfloat16)},
                                st, 1e-3)
    assert new["w"].dtype == torch.bfloat16
    assert st2.master["w"] is st.master["w"]            # updated in place
    assert new["w"].data_ptr() != st.master["w"].data_ptr()


def test_adamw_gnorm_with_clipping_disabled_raises():
    p = {"w": torch.ones(2)}
    with pytest.raises(ValueError, match="clipping is disabled"):
        tadamw.update(p, tadamw.init(p), 1e-3,
                      tadamw.AdamWConfig(clip_norm=0.0),
                      gnorm=torch.tensor(1.0))


def test_schedules_match_jax():
    kw = dict(peak_lr=3e-3, warmup_steps=5, total_steps=40)
    for s in (0, 1, 4, 5, 6, 20, 39, 40, 50):
        _close(tsched.warmup_cosine(s, **kw),
               jsched.warmup_cosine(jnp.int32(s), **kw),
               dict(atol=1e-9, rtol=1e-6))
        _close(tsched.constant(s, peak_lr=3e-3),
               jsched.constant(jnp.int32(s), peak_lr=3e-3))


def test_lm_batches_match_jax_token_for_token():
    jit = jdata.lm_batches(batch=3, seq_len=17, vocab=101, seed=5)
    tit = tdata.lm_batches(batch=3, seq_len=17, vocab=101, seed=5,
                           device="cpu")
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        for k in ("tokens", "labels", "loss_mask"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_microbatch_split_and_count_match_jax():
    x = np.arange(8 * 3).reshape(8, 3)
    parts = tstep._split_microbatches({"x": torch.from_numpy(x)}, 4)
    want = jstep._split_microbatches({"x": jnp.asarray(x)}, 4, 1)["x"]
    for i, part in enumerate(parts):
        np.testing.assert_array_equal(part["x"].numpy(), np.asarray(want[i]))
    shape = ShapeConfig("t", "train", 16, 8)
    assert tstep.num_microbatches(shape, ParallelConfig(mbs=2)) == 4
    with pytest.raises(ValueError, match="multiple"):
        tstep.num_microbatches(shape, ParallelConfig(mbs=3))
    with pytest.raises(ValueError, match="cannot split"):
        tstep._split_microbatches({"x": torch.zeros(6, 2)}, 4)


@pytest.mark.parametrize("knob", [dict(dp=2), dict(tp=2), dict(pp=2),
                                  dict(cp=2), dict(grad_compress="int8")])
def test_multi_device_knobs_raise(knob):
    tm = tbuild(tcfgs.get_reduced("granite-3-8b").replace(dtype="float32"),
                device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        tstep.build_train_step(tm, ParallelConfig(**knob),
                               ShapeConfig("t", "train", 8, 2))


# --------------------------------------------------------------------------- #
# the train step against JAX
# --------------------------------------------------------------------------- #
def test_train_step_three_steps_match_jax():
    name = "qwen1.5-0.5b"
    jm, jparams, tm = _pair(name, seed=3)
    B, S = 4, 16
    sched = dict(peak_lr=1e-2, warmup_steps=1, total_steps=3)
    shape = ShapeConfig("t", "train", S, B)
    step = tstep.build_train_step(
        tm, ParallelConfig(mbs=B), shape,
        lr_schedule=functools.partial(tsched.warmup_cosine, **sched),
        opt_cfg=tadamw.AdamWConfig(eps=OPT_EPS))
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b),
                                         has_aux=True))
    params, opt = tm.param_tree(), tadamw.init(tm.param_tree())
    jopt = jadamw.init(jparams)
    jit = jdata.lm_batches(batch=B, seq_len=S, vocab=tm.cfg.vocab_size,
                           seed=7)
    tit = tdata.lm_batches(batch=B, seq_len=S, vocab=tm.cfg.vocab_size,
                           seed=7, device="cpu")
    for i in range(3):
        (jloss, _), jgrads = grad_fn(jparams, next(jit))
        jparams, jopt, jn = jadamw.update(
            jgrads, jopt, jsched.warmup_cosine(jnp.int32(i), **sched),
            jadamw.AdamWConfig(eps=OPT_EPS))
        params, opt, met = step(params, opt, next(tit), i)
        _close(met["loss"], jloss)
        _close(met["grad_norm"], jn)
    _close_trees(params, jparams)


def test_microbatch_accumulation_equals_full_batch():
    tcfg = tcfgs.get_reduced("qwen1.5-0.5b").replace(dtype="float32")
    shape = ShapeConfig("t", "train", 16, 8)
    _, tb = _batch(tcfg, 8, 16, seed=6)
    # the masked mean of each micro-batch averages to the full batch's only
    # when every micro-batch counts the same tokens (as in the JAX package)
    tb["loss_mask"] = torch.ones(8, 16)
    # every leaf in float32 (norm scales are bf16 by spec, as in the JAX
    # package), so that the comparison sees accumulation, not bf16 rounding
    init = tcm.tree_map(lambda x: x.float(), tcm.init_params(
        ttf.lm_specs(tcfg), torch.Generator().manual_seed(0), "cpu"))
    out = {}
    for mbs in (8, 2):
        tm = tbuild(tcfg, tcm.tree_map(torch.clone, init), device="cpu")
        step = tstep.build_train_step(
            tm, ParallelConfig(mbs=mbs), shape,
            lr_schedule=functools.partial(tsched.constant, peak_lr=1e-2),
            opt_cfg=tadamw.AdamWConfig(eps=OPT_EPS))
        params, _, met = step(tm.param_tree(), tadamw.init(tm.param_tree()),
                              tb, 0)
        out[mbs] = (params, met)
    # float32 accumulation of 4 micro-batch gradients vs one: summation
    # order only (the JAX oracle's 1e-3 over 24 layers; 2 layers here)
    _close(out[2][1]["loss"], out[8][1]["loss"], dict(atol=1e-5, rtol=1e-5))
    _close(out[2][1]["grad_norm"], out[8][1]["grad_norm"],
           dict(atol=1e-4, rtol=1e-4))
    for a, b in zip(tcm.tree_leaves(out[2][0]), tcm.tree_leaves(out[8][0])):
        _close(a, b, dict(atol=1e-5, rtol=1e-5))


def test_training_learns():
    """The port's tests/test_system.py::test_training_learns_on_single_
    device_mesh: 30 steps of a 2-layer qwen1.5-0.5b on lm_batches."""
    cfg = tcfgs.get_reduced("qwen1.5-0.5b").replace(
        dtype="float32", num_layers=2, vocab_size=64, d_ff=128)
    tm = tbuild(cfg, device="cpu", seed=0)
    step = tstep.build_train_step(
        tm, ParallelConfig(mbs=4), ShapeConfig("tiny", "train", 32, 8),
        lr_schedule=functools.partial(tsched.constant, peak_lr=3e-3))
    res = ttrain(step, params=tm.param_tree(),
                 opt_state=tadamw.init(tm.param_tree()),
                 batches=tdata.lm_batches(batch=8, seq_len=32, vocab=64,
                                          seed=0, device="cpu"),
                 num_steps=30, log_every=1000, log_fn=lambda s: None)
    first, last = np.mean(res.losses[:5]), np.mean(res.losses[-5:])
    assert last < first - 0.3, (first, last)
    assert res.steps_run == 30 and len(res.step_times) == 30


def test_train_cli_on_cpu(capsys):
    res = tlaunch.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device",
                        "cpu", "--steps", "3", "--batch", "4", "--seq", "16",
                        "--mbs", "2", "--seed", "1"])
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "flash kernel launches: 0" in out
    assert res.result.steps_run == 3 and res.mbs == 2
    assert all(np.isfinite(res.result.losses))
    with pytest.raises(NotImplementedError, match="A9"):
        tlaunch.main(["--reduced", "--arch", "qwen1.5-0.5b", "--device",
                      "cpu", "--ckpt-dir", "ckpt"])
    with pytest.raises(NotImplementedError, match="A6"):
        tlaunch.main(["--reduced", "--arch", "qwen1.5-0.5b", "--device",
                      "cpu", "--data", "2"])
    with pytest.raises(NotImplementedError, match="A9"):
        ttrain(None, params=None, opt_state=None, batches=iter(()),
               num_steps=1, checkpointer=object())
