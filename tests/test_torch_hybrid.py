"""The port's hybrid family (jamba-v0.1-52b) against the JAX package, on
the CPU in float32.

Reduced jamba (``get_reduced``: one period of 8 layers, attention at
offset 4, Mamba-2 elsewhere with d_state 16 and heads of 32, 4 experts
top-2 on every second layer, d_model 128); parameters are the JAX model's
init plus seeded numpy noise, carried across with
``convert.params_from_numpy``; the same numpy tokens go to both sides.
Every comparison that runs the experts compares the routing first: each
MoE call's expert indices, recorded on both sides, must be equal before
the values are held within 2e-4 (``tests/test_models_smoke.py``'s
tolerance).  Checked: the spec tree at full width and the converted tree,
``Model.forward``, ``Model.loss`` and every leaf's gradient, prefill (at
the reference's capacity 1.25, which drops slots, and at no-drop capacity)
and two decode steps against JAX and against ``forward``, two train steps,
and the serving entry point.
"""
import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.types import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.data import synthetic as tdata  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

NAME = "jamba-v0.1-52b"
TOL = dict(atol=2e-4, rtol=2e-4)
OPT_EPS = 1e-3
# the published layout: one attention layer at offset 4 of each period of
# 8, the rest Mamba-2; MoE on the odd layers
KINDS = [("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"),
         ("mamba", "moe"), ("attn", "mlp"), ("mamba", "moe"),
         ("mamba", "mlp"), ("mamba", "moe")]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(port, want, tol=TOL):
    np.testing.assert_allclose(_np(port), _np(want), **tol)


def _close_trees(port_tree, jax_tree, tol=TOL):
    flat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert len(flat) == len(tcm.tree_leaves(port_tree))
    for path, leaf in flat:
        t = port_tree
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(_np(t), _np(leaf), err_msg=str(path),
                                   **tol)


def _pair(seed=0, **over):
    jcfg = jcfgs.get_reduced(NAME).replace(dtype="float32", **over)
    tcfg = tcfgs.get_reduced(NAME).replace(dtype="float32", **over)
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


@contextlib.contextmanager
def jax_routes():
    """The expert indices [B, S, K] of every JAX ``moe`` call inside the
    block (the reference's own top-k of its router logits), in call
    order."""
    seen, moe = [], jmoe.moe

    def spy(p, x, cfg, **kw):
        idx = jax.lax.top_k(x.astype(jnp.float32) @ p["router"],
                            cfg.experts_per_token)[1]
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), idx,
                           ordered=True)
        return moe(p, x, cfg, **kw)

    jmoe.moe = spy
    try:
        yield seen
    finally:
        jmoe.moe = moe


@contextlib.contextmanager
def port_routes():
    seen, route = [], tmoe.route

    def spy(*args, **kw):
        out = route(*args, **kw)
        seen.append(out[2].detach().numpy())
        return out

    tmoe.route = spy
    try:
        yield seen
    finally:
        tmoe.route = route


def _same_routes(port, ref, calls):
    assert len(port) == len(ref) == calls, (len(port), len(ref))
    for i, (a, b) in enumerate(zip(port, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"MoE call {i}")


# --------------------------------------------------------------------------- #
# parameter trees
# --------------------------------------------------------------------------- #
def test_spec_tree_matches_jax_at_full_width():
    cfg = tcfgs.get_config(NAME).replace(dtype="bfloat16")
    jspecs = jbuild(jcfgs.get_config(NAME).replace(dtype="bfloat16")).specs()
    tspecs = ttf.lm_specs(cfg)
    flat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda s: hasattr(s, "fan_in_dims"))[0]
    for path, js in flat:
        ts = tspecs
        for k in path:
            ts = ts[k.key]
        assert tuple(ts.shape) == tuple(js.shape), path
        assert str(ts.dtype)[6:] == jnp.dtype(js.dtype).name, path
        assert ts.fan_in_dims == js.fan_in_dims, path
    assert len(flat) == len(tcm.tree_leaves(tspecs))
    assert ttf.group_layout(cfg) == (KINDS, 4)
    layers = tspecs["layers"]
    assert set(layers) == {f"sub{j}" for j in range(8)}
    for j, (mixer, ffn) in enumerate(KINDS):
        assert set(layers[f"sub{j}"]) == {"norm1", mixer, "norm2", ffn}
    assert tuple(layers["sub0"]["mamba"]["in_proj"].shape) == (
        4, 4096, 2 * 8192 + 2 * 16 + 128)
    assert tuple(layers["sub4"]["attn"]["wk"].shape) == (4, 4096, 8, 128)
    assert tuple(layers["sub1"]["moe"]["w_down"].shape) == (4, 16, 14336,
                                                            4096)


def test_params_from_numpy_carries_the_hybrid_tree():
    """The JAX init in bf16 converted leaf for leaf, every sub-layer kind
    (sub0..sub7), with the float32 leaves (router, A_log, D, dt_bias,
    norm) kept float32."""
    jm = jbuild(jcfgs.get_reduced(NAME).replace(dtype="bfloat16"))
    np_tree = jax.tree_util.tree_map(np.asarray,
                                     jm.init(jax.random.PRNGKey(0)))
    tm = tbuild(tcfgs.get_reduced(NAME).replace(dtype="bfloat16"),
                params_from_numpy(np_tree, device="cpu"), device="cpu")
    got = tm.param_tree()
    for path, leaf in jax.tree_util.tree_flatten_with_path(np_tree)[0]:
        t = got
        for k in path:
            t = t[k.key]
        assert str(t.dtype)[6:] == np.asarray(leaf).dtype.name, path
        np.testing.assert_array_equal(_np(t), np.asarray(leaf, np.float32),
                                      err_msg=str(path))
    assert got["layers"]["sub1"]["moe"]["router"].dtype == torch.float32
    assert got["layers"]["sub0"]["mamba"]["A_log"].dtype == torch.float32


# --------------------------------------------------------------------------- #
# whole model
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_loss_case():
    """One JAX forward (with its routes), loss and gradient, shared by both
    remat cases (compiling the JAX loss's gradient takes most of the
    time)."""
    jm, jparams, tm = _pair(seed=1)
    jb, tb = _batch(tm.cfg, 2, 40, seed=2)
    with jax_routes() as jr:
        jlog = jm.forward(jparams, {"tokens": jb["tokens"]})
        jax.effects_barrier()
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True))(jparams)
    return tm, tb, jr, jlog, jloss, jmet, jgrads


@pytest.mark.parametrize("remat", [True, False])
def test_forward_loss_and_grads_match_jax(jax_loss_case, remat):
    """At the reference's capacity factor 1.25 (which drops slots here):
    the routes of forward's 4 MoE calls first, then the logits, the loss
    with its aux term, and the gradient of every leaf."""
    tm, tb, jr, jlog, jloss, jmet, jgrads = jax_loss_case
    with port_routes() as tr:
        tlog = tm({"tokens": tb["tokens"]})
    _same_routes(tr, jr, 4)
    _close(tlog, jlog)
    params = tm.param_tree()
    loss, met = tm.loss(tb, remat=remat)
    grads = torch.autograd.grad(loss, tcm.tree_leaves(params))
    assert float(met["aux"].detach()) > 0
    _close(loss, jloss)
    _close(met["ce"], jmet["ce"])
    _close(met["aux"], jmet["aux"])
    _close_trees(tcm.tree_unflatten(params, grads), jgrads)


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_prefill_decode_match_jax(cf):
    """Prefill S-2 tokens then two decode steps: routes, logits and the
    whole cache (attention k/v and Mamba conv/ssm states) against JAX's;
    at capacity 1.25 the prefill drops slots as the reference's does, at
    8.0 (no drop) the logits also equal the port's own forward."""
    jm, jparams, tm = _pair(seed=3, capacity_factor=cf)
    B, S = 2, 40
    tokens = np.random.default_rng(4).integers(0, tm.cfg.vocab_size, (B, S))
    if cf > 1.25:
        full = tm({"tokens": torch.from_numpy(tokens)})
    with jax_routes() as jr:
        jlog, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(
            tokens[:, :S - 2], jnp.int32)}, extra_cache=2)
        jax.effects_barrier()
    with port_routes() as tr:
        tlog, tcache = tm.prefill(
            {"tokens": torch.from_numpy(tokens[:, :S - 2])}, extra_cache=2)
    _same_routes(tr, jr, 4)
    C, E = tmoe.capacity(S - 2, tm.cfg), tm.cfg.num_experts
    dropped = sum(int(np.clip(np.stack([(r == e).sum(axis=(1, 2))
                                        for e in range(E)]) - C, 0, None)
                      .sum()) for r in tr)
    assert (dropped > 0) == (cf == 1.25), dropped
    _close(tlog, jlog)
    _close_trees(tcache, jcache)
    if cf > 1.25:
        _close(tlog, full[:, S - 3])
    for pos in (S - 2, S - 1):
        tok = tokens[:, pos:pos + 1]
        jlog, jcache = jm.decode(jparams, jcache, jnp.asarray(tok, jnp.int32),
                                 jnp.int32(pos))
        tlog, tcache = tm.decode(tcache, torch.from_numpy(tok), pos)
        _close(tlog, jlog)
        if cf > 1.25:
            _close(tlog, full[:, pos])
    _close_trees(tcache, jcache)


# --------------------------------------------------------------------------- #
# training and the entry point
# --------------------------------------------------------------------------- #
def test_train_step_two_steps_match_jax():
    """Batch 4 x 16 in microbatches of 2 at capacity 1.25."""
    jm, jparams, tm = _pair(seed=5)
    B, S, mbs = 4, 16, 2
    sched = dict(peak_lr=1e-2, warmup_steps=1, total_steps=2)
    step = tstep.build_train_step(
        tm, ParallelConfig(mbs=mbs), ShapeConfig("t", "train", S, B),
        lr_schedule=functools.partial(tsched.warmup_cosine, **sched),
        opt_cfg=tadamw.AdamWConfig(eps=OPT_EPS))
    one = jax.jit(jax.value_and_grad(lambda p, mb: jm.loss(p, mb),
                                     has_aux=True))

    def grad_fn(p, b):
        outs = [one(p, jax.tree_util.tree_map(lambda x: x[i:i + mbs], b))
                for i in range(0, B, mbs)]
        return jax.tree_util.tree_map(lambda *xs: sum(xs) / len(xs), *outs)

    update = jax.jit(jadamw.update, static_argnums=3)
    params, opt = tm.param_tree(), tadamw.init(tm.param_tree())
    jopt = jadamw.init(jparams)
    jit = jdata.lm_batches(batch=B, seq_len=S, vocab=tm.cfg.vocab_size,
                           seed=6)
    tit = tdata.lm_batches(batch=B, seq_len=S, vocab=tm.cfg.vocab_size,
                           seed=6, device="cpu")
    for i in range(2):
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
    res = tserve.main(["--arch", NAME, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "40", "--gen", "4",
                       "--seed", "1"])
    out = capsys.readouterr().out
    assert f"arch={NAME}" in out
    assert "flash kernel launches: prefill 0, decode 0" in out
    assert "ssd kernel launches: prefill 0, decode 0" in out
    assert tuple(res.tokens.shape) == (2, 4) and res.logits_finite
    assert bool(((res.tokens >= 0) & (res.tokens < 512)).all())
