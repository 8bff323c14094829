"""The port's Mamba-2 family (mamba2-130m) against the JAX package, on the
CPU in float32.

Reduced mamba2-130m (``get_reduced``: 2 layers, d_model 128, 8 SSD heads of
32, state 16); parameters are the JAX model's init plus seeded numpy noise,
carried across with ``convert.params_from_numpy``; the same numpy tokens
go to both sides.  Checked: the spec tree at full width, the converted and
initialised leaf dtypes, ``Model.forward``, ``Model.loss`` and its
gradients, prefill + decode against JAX and against ``forward``, the
serving entry point, three train steps against JAX, and learning through
``launch.train.run``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.models import mamba as jmb  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.types import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.data import synthetic as tdata  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import mamba as tmb  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

NAME = "mamba2-130m"
# float32 on both sides, sums in other orders through a few layers:
# tests/test_models_smoke.py's 2e-4
TOL = dict(atol=2e-4, rtol=2e-4)
# Adam's eps as in test_torch_train.py: steps on noise-level gradients
# shrink to nothing on both sides
OPT_EPS = 1e-3


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


def _pair(seed=0, **over):
    """JAX model + params (init plus seeded noise) and the port's copy."""
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


# --------------------------------------------------------------------------- #
# parameter trees
# --------------------------------------------------------------------------- #
def test_spec_tree_matches_jax_at_full_width():
    jm = jbuild(jcfgs.get_config(NAME))
    jshapes = jax.tree_util.tree_map(lambda s: (tuple(s.shape), s.dtype.name),
                                     jm.param_shapes())
    specs = ttf.lm_specs(tcfgs.get_config(NAME))
    tshapes = tcm.tree_map(lambda s: (tuple(s.shape),
                                      str(s.dtype).replace("torch.", "")),
                           specs)
    assert tshapes == jshapes
    n = sum(int(np.prod(s.shape)) for s in tcm.tree_leaves(specs))
    assert 128.5e6 < n < 129.5e6                  # mamba2-130m: 129.0M


@pytest.mark.parametrize("how", ["converted", "initialised"])
def test_leaf_dtypes_follow_the_specs_in_bf16(how):
    """The SSM's A_log, D, dt_bias and norm stay float32 in a bf16 model."""
    jcfg = jcfgs.get_reduced(NAME).replace(dtype="bfloat16")
    tcfg = tcfgs.get_reduced(NAME).replace(dtype="bfloat16")
    if how == "converted":
        np_tree = jax.tree_util.tree_map(
            np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
        tm = tbuild(tcfg, params_from_numpy(np_tree, device="cpu"),
                    device="cpu")
    else:
        tm = tbuild(tcfg, device="cpu", seed=0)
    specs = ttf.lm_specs(tcfg)
    got = tcm.tree_map(lambda x: x.dtype, tm.param_tree())
    assert got == tcm.tree_map(lambda s: s.dtype, specs)
    sub = got["layers"]["sub0"]["mamba"]
    assert {k for k, v in sub.items() if v == torch.float32} == {
        "A_log", "D", "dt_bias", "norm"}
    assert tm.param_tree()["layers"]["sub0"]["mamba"]["D"].eq(1).all()


def test_hybrid_family_matches_jax():
    """jamba (reduced: 7 Mamba-2 sub-layers at d_state 16 beside one
    attention sub-layer, MoE on every second) builds and its forward
    matches the JAX package's; tests/test_torch_hybrid.py holds the rest
    of the family."""
    name = "jamba-v0.1-52b"
    jcfg = jcfgs.get_reduced(name).replace(dtype="float32")
    jm = jbuild(jcfg)
    rng = np.random.default_rng(7)
    np_tree = jax.tree_util.tree_map(
        lambda x: (np.asarray(x, np.float32)
                   + 0.05 * rng.standard_normal(x.shape, dtype=np.float32)),
        jm.init(jax.random.PRNGKey(7)))
    tm = tbuild(tcfgs.get_reduced(name).replace(dtype="float32"),
                params_from_numpy(np_tree, device="cpu"), device="cpu")
    assert sum(1 for j in range(8) if "mamba" in
               tm.param_tree()["layers"][f"sub{j}"]) == 7
    jb, tb = _batch(tm.cfg, 2, 24, seed=8)
    _close(tm({"tokens": tb["tokens"]}),
           jm.forward(jax.tree_util.tree_map(jnp.asarray, np_tree),
                      {"tokens": jb["tokens"]}))


# --------------------------------------------------------------------------- #
# forward, loss, gradients
# --------------------------------------------------------------------------- #
def test_forward_matches_jax():
    jm, jparams, tm = _pair(seed=0)
    jb, tb = _batch(tm.cfg, 2, 24, seed=1)
    _close(tm({"tokens": tb["tokens"]}),
           jm.forward(jparams, {"tokens": jb["tokens"]}))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(remat):
    jm, jparams, tm = _pair(seed=1)
    jb, tb = _batch(tm.cfg, 2, 24, seed=2)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True)(jparams)
    params = tm.param_tree()
    loss, met = tm.loss(tb, remat=remat)
    grads = torch.autograd.grad(loss, tcm.tree_leaves(params))
    _close(loss, jloss)
    _close(met["ce"], jmet["ce"])
    _close_trees(tcm.tree_unflatten(params, grads), jgrads)


def test_block_pieces_match_jax():
    """The conv and the block with a cache written, leaf by leaf."""
    jm, jparams, tm = _pair(seed=2)
    cfg = tm.cfg
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, cfg.d_model), dtype=np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["layers"]["sub0"]["mamba"])
    tp = tcm.tree_map(lambda a: a[0].detach(),
                      tm.param_tree()["layers"]["sub0"]["mamba"])
    jout, jcache = jmb.mamba(jp, jnp.asarray(x), jm.cfg, return_cache=True)
    cache = tmb.new_cache(2, cfg, torch.float32, "cpu")
    out = tmb.mamba(tp, torch.from_numpy(x), cfg, cache=cache)
    _close(out, jout)
    _close(cache["conv"], jcache["conv"])
    _close(cache["ssm"], jcache["ssm"], dict(atol=1e-3, rtol=1e-3))
    jdec, jc2 = jmb.mamba_decode(jp, jnp.asarray(x[:, :1]), jcache, jm.cfg)
    dec, c2 = tmb.mamba_decode(tp, torch.from_numpy(x[:, :1]), cache, cfg)
    assert c2 is cache                                 # written in place
    _close(dec, jdec)
    _close(cache["conv"], jc2["conv"])
    _close(cache["ssm"], jc2["ssm"], dict(atol=1e-3, rtol=1e-3))


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def test_prefill_decode_matches_jax_and_forward():
    """tests/test_models_smoke.py::test_prefill_decode_matches_forward for
    mamba2-130m, held against JAX as well."""
    jm, jparams, tm = _pair(seed=3)
    B, S = 2, 16
    tokens = np.random.default_rng(4).integers(0, tm.cfg.vocab_size, (B, S))
    full = tm({"tokens": torch.from_numpy(tokens)})
    jlog, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(
        tokens[:, :S - 2], jnp.int32)}, extra_cache=2)
    tlog, tcache = tm.prefill({"tokens": torch.from_numpy(tokens[:, :S - 2])},
                              extra_cache=2)
    _close(tlog, jlog)
    _close(tlog, full[:, S - 3])
    for k in ("conv", "ssm"):
        assert tcache["sub0"][k].shape == jcache["sub0"][k].shape
        assert tcache["sub0"][k].dtype == torch.float32
    _close(tcache["sub0"]["ssm"], jcache["sub0"]["ssm"],
           dict(atol=1e-3, rtol=1e-3))
    for pos in (S - 2, S - 1):
        tok = tokens[:, pos:pos + 1]
        jlog, jcache = jm.decode(jparams, jcache, jnp.asarray(tok, jnp.int32),
                                 jnp.int32(pos))
        tlog, tcache = tm.decode(tcache, torch.from_numpy(tok), pos)
        _close(tlog, jlog)
        _close(tlog, full[:, pos])


def test_serve_entry_point_on_cpu(capsys):
    res = tserve.main(["--arch", NAME, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "20", "--gen", "4",
                       "--seed", "1"])
    out = capsys.readouterr().out
    assert "ssd kernel launches: prefill 0, decode 0" in out
    assert tuple(res.tokens.shape) == (2, 4) and res.logits_finite
    assert res.prefill_ssd_launches == res.decode_ssd_launches == 0


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
def test_train_step_three_steps_match_jax():
    jm, jparams, tm = _pair(seed=5)
    B, S = 4, 16
    sched = dict(peak_lr=1e-2, warmup_steps=1, total_steps=3)
    step = tstep.build_train_step(
        tm, ParallelConfig(mbs=B), ShapeConfig("t", "train", S, B),
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


def test_training_learns_through_the_entry_point():
    before = ssd.ssd_fwd.launches
    run = tlaunch.run(NAME, reduced=True, steps=100, batch=8, seq=32,
                      lr=3e-3, device="cpu", seed=0, log_every=1000)
    losses = run.result.losses
    assert all(np.isfinite(losses)) and run.result.steps_run == 100
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses
    assert run.ssd_launches == run.flash_launches == 0       # CPU
    assert ssd.ssd_fwd.launches == before
    assert "ssd kernel launches: 0" in run.summary()


def test_full_width_grads_are_finite_where_jax_is_nan():
    """ROADMAP.md C3 at the model level: mamba2-130m at full width (2
    layers, float32) from the JAX init, batch 1 x 256 at the default chunk
    of 128.  JAX's loss is finite and some of its gradients are not; the
    port's loss equals JAX's and all of its gradients are finite."""
    over = dict(num_layers=2, dtype="float32")
    jcfg = jcfgs.get_config(NAME).replace(**over)
    tcfg = tcfgs.get_config(NAME).replace(**over)
    jm = jbuild(jcfg)
    np_tree = jax.tree_util.tree_map(np.asarray,
                                     jm.init(jax.random.PRNGKey(0)))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    tm = tbuild(tcfg, params_from_numpy(np_tree, device="cpu",
                                        dtype=torch.float32), device="cpu")
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (1, 257))
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(toks[:, 1:])}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True)(jparams)
    assert np.isfinite(float(jloss))
    assert not all(bool(jnp.isfinite(g).all())
                   for g in jax.tree_util.tree_leaves(jgrads))
    params = tm.param_tree()
    loss, _ = tm.loss(tb)
    grads = torch.autograd.grad(loss, tcm.tree_leaves(params))
    _close(loss, jloss)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
