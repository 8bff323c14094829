"""The port's MoE family (mixtral-8x22b, moonshot-v1-16b-a3b) against the
JAX package, on the CPU.

* ``models.moe.moe`` against ``repro.models.moe.moe`` (output and aux
  loss) in float32 and bfloat16, at a capacity that drops
  slots (``capacity_factor`` 0.5) and one that does not (8.0), and its
  gradients against ``jax.vjp`` in float32;
* ``moe(..., return_stats=True)``: the router statistics against the
  reference's, and the aux rebuilt from them against ``moe``'s;
* one MoE sub-layer (attention + experts): its output and aux, and with
  ``collect_stats`` its statistics;
* ``Model.forward`` and ``Model.loss`` with its aux term, and the loss's
  gradients, for the reduced mixtral and moonshot configs;
* prefill + decode against the JAX package's and against ``forward``
  (no-drop capacity, as ``tests/test_models_smoke.py``), and mixtral's
  rolling window cache;
* three train steps of reduced moonshot against ``jax.value_and_grad``
  plus ``repro.optim.adamw.update``;
* the serving and training entry points on the CPU.

Parameters are the JAX model's init plus seeded numpy noise, carried
across with ``convert.params_from_numpy``; the same numpy tokens go to
both sides.  Attention runs through each side's plain version.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.types import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.data import synthetic as tdata  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

NAMES = ["mixtral-8x22b", "moonshot-v1-16b-a3b"]
# moe() alone: float32 sums over d_model 128 / d_ff 256 in other orders
# stay near 1e-6; bf16 within two bf16 steps of the outputs' scale (both
# sides round the same f32 products to bf16, the K-sum in another order)
MOE_TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
           "bfloat16": dict(atol=2e-2, rtol=2e-2)}
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
# whole models through a few layers: tests/test_models_smoke.py's 2e-4
TOL = dict(atol=2e-4, rtol=2e-4)
# Adam's eps as in test_torch_train.py: steps on noise-level gradients
# shrink to nothing on both sides
OPT_EPS = 1e-3
# reduced mixtral (4 experts, top-2) and reduced moonshot widened to 16
# experts, top-6, nearer its published 64 and 6
VARIANTS = {"mixtral": ("mixtral-8x22b", {}),
            "moonshot-16e-top6": ("moonshot-v1-16b-a3b",
                                  dict(num_experts=16, experts_per_token=6))}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(port, want, tol=TOL):
    np.testing.assert_allclose(_np(port), _np(want), **tol)


def _close_trees(port_tree, jax_tree, tol=TOL):
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        t = port_tree
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(_np(t), _np(leaf), err_msg=str(path),
                                   **tol)


def _cfgs(name, **over):
    return (jcfgs.get_reduced(name).replace(**over),
            tcfgs.get_reduced(name).replace(**over))


def _pair(name, seed=0, **over):
    """JAX model + params (init plus seeded noise) and the port's copy, in
    float32."""
    jcfg, tcfg = _cfgs(name, dtype="float32", **over)
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


def _moe_inputs(variant, dtype, cf, seed, B=2, S=24):
    """Configs, numpy parameters and x for one moe() call."""
    name, over = VARIANTS[variant]
    jcfg, tcfg = _cfgs(name, dtype=dtype, capacity_factor=cf, **over)
    rng = np.random.default_rng(seed)
    p = {k: (rng.standard_normal(s.shape, dtype=np.float32)
             * s.shape[s.fan_in_dims[0]] ** -0.5)
         for k, s in jmoe.moe_specs(jcfg).items()}
    x = rng.standard_normal((B, S, jcfg.d_model), dtype=np.float32)
    return jcfg, tcfg, p, x


def _jax_tree(p, x, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jdt)
          for k, v in p.items()}
    return jp, jnp.asarray(x, jdt)


def _torch_tree(p, x, dtype):
    tdt = getattr(torch, dtype)
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "router" else tdt)
          for k, v in p.items()}
    return tp, torch.from_numpy(x).to(tdt)


def _dropped(tcfg, tp, tx) -> int:
    """Routed (token, k) slots past their expert's capacity."""
    _, _, idx = tmoe.route(tp, tx, tcfg)
    C = tmoe.capacity(tx.shape[1], tcfg)
    counts = torch.nn.functional.one_hot(idx, tcfg.num_experts).sum(
        dim=(1, 2))                                              # [B, E]
    return int((counts - C).clamp_min(0).sum())


# --------------------------------------------------------------------------- #
# moe() alone
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_moe_matches_jax(variant, dtype, cf):
    jcfg, tcfg, p, x = _moe_inputs(variant, dtype, cf, seed=0)
    jp, jx = _jax_tree(p, x, dtype)
    tp, tx = _torch_tree(p, x, dtype)
    jy, jaux = jax.jit(functools.partial(jmoe.moe, cfg=jcfg))(jp, jx)
    ty, taux = tmoe.moe(tp, tx, tcfg)
    assert ty.dtype == tx.dtype and taux.dtype == torch.float32 \
        and taux.shape == ()
    dropped = _dropped(tcfg, tp, tx)
    assert (dropped > 0) == (cf < 1), dropped       # cf 0.5 must drop
    tol = MOE_TOL[dtype]
    _close(ty, jy, tol)
    # f32 router on both; aux is built from frac (the routed indices) and
    # prob (the router's softmax), so it covers both
    _close(taux, jaux, MOE_TOL["float32"])


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_moe_grads_match_jax_vjp(variant, cf):
    jcfg, tcfg, p, x = _moe_inputs(variant, "float32", cf, seed=1)
    rng = np.random.default_rng(2)
    dy = rng.standard_normal(x.shape, dtype=np.float32)
    daux = np.float32(1.3)
    keys = sorted(p)

    @jax.jit
    def jf(x, leaves, cot):
        out, vjp = jax.vjp(
            lambda x, *ls: jmoe.moe(dict(zip(keys, ls)), x, jcfg), x,
            *leaves)
        return out, vjp(cot)

    (jy, jaux), jgrads = jf(jnp.asarray(x),
                            [jnp.asarray(p[k]) for k in keys],
                            (jnp.asarray(dy), jnp.asarray(daux)))
    leaves = [torch.from_numpy(x).requires_grad_()] + [
        torch.from_numpy(p[k]).requires_grad_() for k in keys]
    ty, taux = tmoe.moe(dict(zip(keys, leaves[1:])), leaves[0], tcfg)
    tgrads = torch.autograd.grad(
        (ty * torch.from_numpy(dy)).sum() + daux * taux, leaves)
    _close(ty, jy, MOE_TOL["float32"])
    assert _dropped(tcfg, {"router": torch.from_numpy(p["router"])},
                    torch.from_numpy(x)) > 0 or cf > 1
    for name, g, want in zip(["x"] + keys, tgrads, jgrads):
        np.testing.assert_allclose(_np(g), _np(want), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_moe_return_stats_matches_jax(variant, cf):
    """``moe(..., return_stats=True)``: the [2, E] router statistics
    (frac, prob) against the reference's, the aux rebuilt from them equal
    to ``moe``'s, and the sub-layer's ``collect_stats`` form."""
    jcfg, tcfg, p, x = _moe_inputs(variant, "float32", cf, seed=3)
    jp, jx = _jax_tree(p, x, "float32")
    tp, tx = _torch_tree(p, x, "float32")
    jy, jaux, jst = jax.jit(functools.partial(
        jmoe.moe, cfg=jcfg, return_stats=True))(jp, jx)
    ty, taux, tst = tmoe.moe(tp, tx, tcfg, return_stats=True)
    assert tst.dtype == torch.float32 and tuple(tst.shape) == (
        2, tcfg.num_experts)
    _close(ty, jy, MOE_TOL["float32"])
    _close(tst, jst, MOE_TOL["float32"])
    assert torch.equal(ty, tmoe.moe(tp, tx, tcfg)[0])
    rebuilt = ttf.aux_from_stats(tst, tcfg)
    assert abs(float(rebuilt) - float(taux)) <= 1e-6 * abs(float(taux))
    _close(taux, jaux, MOE_TOL["float32"])


def test_sublayer_matches_jax():
    """One attention + MoE sub-layer -> (x, aux), as the reference's
    ``_sublayer_fwd``; an MLP sub-layer's aux is None (the reference's
    constant 0)."""
    jm, jparams, tm = _pair("mixtral-8x22b", seed=4)
    jcfg, tcfg = jm.cfg, tm.cfg
    x = np.random.default_rng(5).standard_normal(
        (2, 20, tcfg.d_model), dtype=np.float32)
    jlp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["sub0"])
    tlp = tcm.tree_map(lambda a: a[0], tm.param_tree()["layers"]["sub0"])
    want = jax.jit(functools.partial(
        jtf._sublayer_fwd, cfg=jcfg, mixer="attn", ffn="moe", causal=True,
        segment_ids=None, impl="auto"))(jlp, jnp.asarray(x))
    got = ttf._sublayer_fwd(tlp, torch.from_numpy(x), tcfg, "attn", "moe",
                            None, True)
    assert len(got) == len(want) == 2 and float(want[1]) > 0
    for g, w in zip(got, want):
        _close(g, w)
    assert ttf._ffn({}, torch.from_numpy(x), tcfg, None)[1] is None
    want = jax.jit(functools.partial(
        jtf._sublayer_fwd, cfg=jcfg, mixer="attn", ffn="moe", causal=True,
        segment_ids=None, impl="auto", collect_stats=True))(
            jlp, jnp.asarray(x))
    got = ttf._sublayer_fwd(tlp, torch.from_numpy(x), tcfg, "attn", "moe",
                            None, True, True)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _close(g, w)


# --------------------------------------------------------------------------- #
# parameter trees and the model factory
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", NAMES)
def test_spec_tree_matches_jax_at_full_width(name):
    """Same keys, shapes and dtypes as the JAX tree at the published
    widths (specs only; nothing is allocated)."""
    jspecs = jbuild(jcfgs.get_config(name).replace(dtype="bfloat16")).specs()
    tspecs = ttf.lm_specs(tcfgs.get_config(name).replace(dtype="bfloat16"))
    flat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda s: hasattr(s, "fan_in_dims"))[0]
    seen = 0
    for path, js in flat:
        ts = tspecs
        for k in path:
            ts = ts[k.key]
        assert tuple(ts.shape) == tuple(js.shape), path
        assert str(ts.dtype)[6:] == jnp.dtype(js.dtype).name, path
        assert ts.fan_in_dims == js.fan_in_dims, path
        seen += 1
    assert seen == len(tcm.tree_leaves(tspecs))
    moe = tspecs["layers"]["sub0"]["moe"]
    cfg = tcfgs.get_config(name)
    assert moe["router"].dtype == torch.float32
    assert tuple(moe["w_down"].shape) == (cfg.num_layers, cfg.num_experts,
                                          cfg.d_ff, cfg.d_model)


@pytest.mark.parametrize("name", NAMES)
def test_build_model_builds_the_moe_family(name):
    tm = tbuild(tcfgs.get_reduced(name).replace(dtype="bfloat16"),
                device="cpu", seed=0)
    moe = tm.param_tree()["layers"]["sub0"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_gate"].dtype == moe["w_down"].dtype == torch.bfloat16


# --------------------------------------------------------------------------- #
# whole models
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("remat", [True, False])
def test_forward_loss_and_grads_match_jax(name, remat):
    """S = 48 passes reduced mixtral's 32-token window; the reduced
    configs keep capacity factor 1.25, which drops slots here."""
    jm, jparams, tm = _pair(name, seed=1)
    jb, tb = _batch(tm.cfg, 2, 48, seed=2)
    _close(tm({"tokens": tb["tokens"]}),
           jax.jit(jm.forward)(jparams, {"tokens": jb["tokens"]}))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True))(jparams)
    params = tm.param_tree()
    loss, met = tm.loss(tb, remat=remat)
    grads = torch.autograd.grad(loss, tcm.tree_leaves(params))
    assert float(met["aux"].detach()) > 0
    _close(loss, jloss)
    _close(met["ce"], jmet["ce"])
    _close(met["aux"], jmet["aux"])
    _close_trees(tcm.tree_unflatten(params, grads), jgrads)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_decode_match_jax_and_forward(name):
    """Prefill S-2 tokens then decode 2 == JAX's, and == the port's own
    forward: tests/test_models_smoke.py's setting (float32, capacity
    factor 8.0, so that no slot is dropped and every call routes alike)."""
    jm, jparams, tm = _pair(name, seed=3, capacity_factor=8.0)
    B, S = 2, 16
    tokens = np.random.default_rng(6).integers(0, tm.cfg.vocab_size, (B, S))
    full = tm({"tokens": torch.from_numpy(tokens)})
    jlog, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(
        tokens[:, :S - 2], jnp.int32)}, extra_cache=2)
    tlog, tcache = tm.prefill({"tokens": torch.from_numpy(tokens[:, :S - 2])},
                              extra_cache=2)
    _close(tlog, jlog)
    _close(tlog, full[:, S - 3])
    for pos in (S - 2, S - 1):
        jlog, jcache = jm.decode(
            jparams, jcache, jnp.asarray(tokens[:, pos:pos + 1], jnp.int32),
            jnp.int32(pos))
        tlog, tcache = tm.decode(tcache,
                                 torch.from_numpy(tokens[:, pos:pos + 1]), pos)
        _close(tlog, jlog)
        _close(tlog, full[:, pos])


def test_sliding_window_rolling_cache():
    """tests/test_models_smoke.py's case: reduced mixtral with an 8-slot
    rolling cache, decode after a 23-token prompt, against JAX and the
    port's forward."""
    jm, jparams, tm = _pair("mixtral-8x22b", seed=2, capacity_factor=8.0,
                            sliding_window=8)
    B, S = 1, 24
    tokens = np.random.default_rng(7).integers(0, tm.cfg.vocab_size, (B, S))
    full = tm({"tokens": torch.from_numpy(tokens)})
    _, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(
        tokens[:, :S - 1], jnp.int32)}, extra_cache=1)
    _, tcache = tm.prefill({"tokens": torch.from_numpy(tokens[:, :S - 1])},
                           extra_cache=1)
    assert tcache["sub0"]["k"].shape[2] == 8          # window-sized cache
    _close(tcache["sub0"]["k"], jcache["sub0"]["k"])
    _close(tcache["sub0"]["v"], jcache["sub0"]["v"])
    jlog, _ = jm.decode(jparams, jcache,
                        jnp.asarray(tokens[:, S - 1:], jnp.int32),
                        jnp.int32(S - 1))
    tlog, _ = tm.decode(tcache, torch.from_numpy(tokens[:, S - 1:]), S - 1)
    _close(tlog, jlog)
    _close(tlog, full[:, S - 1])


# --------------------------------------------------------------------------- #
# training and the entry points
# --------------------------------------------------------------------------- #
def test_train_step_three_steps_match_jax():
    """Reduced moonshot, batch 4 x 16 in microbatches of 2, at its own
    capacity factor 1.25."""
    jm, jparams, tm = _pair("moonshot-v1-16b-a3b", seed=5)
    B, S, mbs = 4, 16, 2
    sched = dict(peak_lr=1e-2, warmup_steps=1, total_steps=3)
    step = tstep.build_train_step(
        tm, ParallelConfig(mbs=mbs), ShapeConfig("t", "train", S, B),
        lr_schedule=functools.partial(tsched.warmup_cosine, **sched),
        opt_cfg=tadamw.AdamWConfig(eps=OPT_EPS))

    one = jax.jit(jax.value_and_grad(lambda p, mb: jm.loss(p, mb),
                                     has_aux=True))

    def grad_fn(p, b):
        # the reference's accumulation: the mean over the microbatches of
        # each one's loss, metrics and gradient
        outs = [one(p, jax.tree_util.tree_map(lambda x: x[i:i + mbs], b))
                for i in range(0, B, mbs)]
        return jax.tree_util.tree_map(lambda *xs: sum(xs) / len(xs), *outs)

    update = jax.jit(jadamw.update, static_argnums=3)
    params, opt = tm.param_tree(), tadamw.init(tm.param_tree())
    jopt = jadamw.init(jparams)
    jit = jdata.lm_batches(batch=B, seq_len=S, vocab=tm.cfg.vocab_size,
                           seed=7)
    tit = tdata.lm_batches(batch=B, seq_len=S, vocab=tm.cfg.vocab_size,
                           seed=7, device="cpu")
    for i in range(3):
        (jloss, jmet), jgrads = grad_fn(jparams, next(jit))
        jparams, jopt, jn = update(
            jgrads, jopt, jsched.warmup_cosine(jnp.int32(i), **sched),
            jadamw.AdamWConfig(eps=OPT_EPS))
        params, opt, met = step(params, opt, next(tit), i)
        _close(met["loss"], jloss)
        _close(met["aux"], jmet["aux"])
        _close(met["grad_norm"], jn)
    _close_trees(params, jparams)


def test_serve_entry_point_on_cpu(capsys):
    res = tserve.main(["--arch", "mixtral-8x22b", "--reduced", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "40", "--gen",
                       "4", "--seed", "1"])
    out = capsys.readouterr().out
    assert "arch=mixtral-8x22b" in out and "flash kernel launches: " \
        "prefill 0, decode 0" in out
    assert tuple(res.tokens.shape) == (2, 4) and res.logits_finite
    assert bool(((res.tokens >= 0) & (res.tokens < 512)).all())


def test_train_entry_point_on_cpu(capsys):
    res = tlaunch.main(["--arch", "moonshot-v1-16b-a3b", "--reduced",
                        "--device", "cpu", "--steps", "3", "--batch", "4",
                        "--seq", "16", "--mbs", "2", "--seed", "1"])
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "flash kernel launches: 0" in out
    assert res.result.steps_run == 3 and res.mbs == 2
    assert all(np.isfinite(res.result.losses))
