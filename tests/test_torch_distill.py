"""The port's distillation against the JAX package, on the CPU in float32.

* ``distill_kl_stats_ref`` (the plain version of the CUDA kernel) against
  ``repro.kernels.distill_kl._fwd_pass``, ``distill_kl_bwd_ref`` (the
  plain version of the backward kernel) against its ``_distill_kl_bwd``
  for each side, and the ``DistillKL`` Function's
  value and gradients against ``distill_kl_chunked_jnp`` and the
  full-materialisation oracle, over ``tests/test_kernels_distill_kl.py``'s
  parameters;
* ``distill_loss`` against JAX's on ``tests/test_equivalence.py``'s pair
  (reduced qwen2.5-32b teacher, reduced granite-3-8b student, vocab 512);
* three steps of ``build_colocated_step`` against ``jax.value_and_grad`` of
  JAX's ``distill_loss`` plus ``repro.optim.adamw.update`` and the
  schedule: per-step loss and grad norm, student parameters after the last
  step; the teacher is left unchanged.

Inputs come from seeded numpy; weights are the JAX models' init plus
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
from repro.distill import workload as jdw  # noqa: E402
from repro.kernels import distill_kl as jdk  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.types import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.data import synthetic as tdata  # noqa: E402
from repro_torch.distill import workload as tdw  # noqa: E402
from repro_torch.kernels import distill_kl as tdk  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402

# float32 on both sides, sums in different orders (the JAX package's own
# KL tests use 1e-5; the model-level comparisons pass through two models'
# layers, tests/test_models_smoke.py's 2e-4)
KL_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=2e-4, rtol=2e-4)
# see tests/test_torch_train.py: both sides take Adam eps 1e-3 in the
# trajectory test, so that noise-level gradients give no +-lr steps
OPT_EPS = 1e-3
KL_CASES = [(32, 16, 24, 128), (64, 8, 8, 256), (16, 32, 16, 96)]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(port, jax_value, tol=TOL):
    np.testing.assert_allclose(_np(port), _np(jax_value), **tol)


def _close_trees(port_tree, jax_tree, tol=TOL):
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        t = port_tree
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(_np(t), _np(leaf), err_msg=str(path),
                                   **tol)


def _kl_inputs(N, Ds, Dt, V, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, Ds), dtype=np.float32),
            rng.standard_normal((Ds, V), dtype=np.float32) * 0.2,
            rng.standard_normal((N, Dt), dtype=np.float32),
            rng.standard_normal((Dt, V), dtype=np.float32) * 0.2)


# --------------------------------------------------------------------------- #
# the KL
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("N,Ds,Dt,V", KL_CASES)
@pytest.mark.parametrize("T", [1.0, 2.0])
def test_stats_ref_matches_jax_fwd_pass(N, Ds, Dt, V, T):
    xs = _kl_inputs(N, Ds, Dt, V)
    want = jdk._fwd_pass(*(jnp.asarray(x) for x in xs), T, 32)
    got = ref.distill_kl_stats_ref(*(torch.from_numpy(x) for x in xs), T,
                                   block_v=40)         # ragged last block
    for g, w in zip(got, want):
        _close(g, w, KL_TOL)


@pytest.mark.parametrize("N,Ds,Dt,V", KL_CASES)
@pytest.mark.parametrize("T", [1.0, 2.0])
@pytest.mark.parametrize("masked", [False, True])
def test_distill_kl_value_and_grads_match_jax(N, Ds, Dt, V, T, masked):
    xs = _kl_inputs(N, Ds, Dt, V)
    mask = (np.arange(N) % 3 != 0) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    jx = tuple(jnp.asarray(x) for x in xs)
    kl_j, g_j = jax.value_and_grad(lambda *a: jdk.distill_kl_chunked_jnp(
        *a, mask=jmask, temperature=T, block_v=32), argnums=(0, 1, 2, 3))(*jx)
    oracle = jref.distill_kl_reference(*jx, mask=jmask, temperature=T)
    leaves = [torch.from_numpy(x).requires_grad_() for x in xs]
    kl = ops.distill_kl(*leaves, mask=None if mask is None
                        else torch.from_numpy(mask), temperature=T,
                        block_v=48)
    grads = torch.autograd.grad(kl, leaves)
    _close(kl, kl_j, KL_TOL)
    _close(kl, oracle, KL_TOL)
    for g, w in zip(grads, g_j):
        _close(g, w, dict(atol=1e-6, rtol=1e-5))


@functools.lru_cache(maxsize=None)
def _jax_bwd(N, Ds, Dt, V, T, masked, g):
    """The JAX forward's statistics and ``_distill_kl_bwd``'s four
    gradients at cotangent ``g`` on ``_kl_inputs(..., seed=1)``, as numpy
    (once for both sides)."""
    jx = tuple(jnp.asarray(x) for x in _kl_inputs(N, Ds, Dt, V, seed=1))
    mask = jnp.asarray(np.arange(N) % 3 != 0) if masked else None
    _, res = jdk._distill_kl_fwd(*jx, mask, T, 32)
    grads = jdk._distill_kl_bwd(T, 32, res, jnp.float32(g))[:4]
    return ([np.array(r) for r in res[5:]],
            [np.array(x) for x in grads])


@pytest.mark.parametrize("N,Ds,Dt,V", KL_CASES)
@pytest.mark.parametrize("T", [1.0, 2.0])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("side", ["student", "teacher"])
def test_bwd_ref_matches_jax_distill_kl_bwd(N, Ds, Dt, V, T, masked, side):
    """``ref.distill_kl_bwd_ref`` (the plain version of the backward
    kernel and its products) against the JAX rule ``_distill_kl_bwd`` on
    the same residuals and cotangent, one side's gradients at a time."""
    xs = _kl_inputs(N, Ds, Dt, V, seed=1)
    mask = (np.arange(N) % 3 != 0) if masked else None
    g = 1.7
    stats, want = _jax_bwd(N, Ds, Dt, V, T, masked, g)
    stats = [torch.from_numpy(x) for x in stats]
    tok_w = (torch.from_numpy(mask).float() if masked
             else torch.ones(N, dtype=torch.float32))
    tok_w = tok_w / tok_w.sum().clamp_min(1.0) * g / T
    needs = (side == "student",) * 2 + (side == "teacher",) * 2
    got = ref.distill_kl_bwd_ref(*(torch.from_numpy(x) for x in xs), *stats,
                                 tok_w, T, needs=needs, block_v=40)
    for need, gt, w in zip(needs, got, want):
        if need:
            _close(gt, w, dict(atol=1e-6, rtol=1e-5))
        else:
            assert gt is None


def test_distill_kl_reference_matches_jax():
    xs = _kl_inputs(24, 16, 12, 80, seed=3)
    mask = np.arange(24) % 4 != 0
    _close(ref.distill_kl_reference(*(torch.from_numpy(x) for x in xs),
                                    mask=torch.from_numpy(mask),
                                    temperature=1.5),
           jref.distill_kl_reference(*(jnp.asarray(x) for x in xs),
                                     mask=jnp.asarray(mask),
                                     temperature=1.5), KL_TOL)


def test_teacher_gradients_are_skipped_not_changed():
    """Detached teacher inputs: the student's gradients are those of the
    full backward, and the teacher's are never formed."""
    xs = [torch.from_numpy(x) for x in _kl_inputs(32, 16, 24, 128)]
    full = [x.clone().requires_grad_() for x in xs]
    g_full = torch.autograd.grad(ops.distill_kl(*full, temperature=2.0),
                                 full)
    hs, ws = (x.clone().requires_grad_() for x in xs[:2])
    kl = ops.distill_kl(hs, ws, xs[2], xs[3], temperature=2.0)
    g = torch.autograd.grad(kl, [hs, ws])
    for a, b in zip(g, g_full[:2]):
        assert torch.equal(a, b)


def test_kl_properties_and_tied_layout():
    hs, ws, ht, wt = (torch.from_numpy(x)
                      for x in _kl_inputs(16, 8, 8, 64))
    same = ops.distill_kl(hs, ws, hs, ws, temperature=1.0, block_v=16)
    assert abs(float(same)) < 1e-6
    assert float(ops.distill_kl(hs, ws, ht, wt, block_v=16)) >= 0.0
    # a tied unembedding passed as embed.T (a view) gives the same KL
    tied = ops.distill_kl(hs, ws.T.contiguous().T, ht, wt, block_v=16)
    _close(tied, ops.distill_kl(hs, ws, ht, wt, block_v=16), KL_TOL)


def test_cpu_kl_takes_the_plain_version_and_the_wrapper_refuses_cpu():
    xs = [torch.from_numpy(x) for x in _kl_inputs(16, 8, 8, 64)]
    before = tdk.distill_kl_fwd.launches
    ops.distill_kl(*xs)
    assert tdk.distill_kl_fwd.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tdk.distill_kl_fwd(*xs)


@pytest.mark.parametrize("N,V,sms", [(8192, 151936, 132), (70, 300, 4),
                                     (64, 64, 132), (10_000, 129, 132)])
def test_vocabulary_splits_cover_every_tile_once(N, V, sms):
    nsplit, per = tdk.splits(N, V, sms)
    ntiles = -(-V // tdk.BV)
    assert nsplit >= 1 and (nsplit - 1) * per < ntiles <= nsplit * per
    if N == 8192:
        assert nsplit * -(-N // tdk.BT) >= 4 * sms     # fills the card


# --------------------------------------------------------------------------- #
# the distillation loss and the colocated step
# --------------------------------------------------------------------------- #
def _model(name, seed, **over):
    jcfg = jcfgs.get_reduced(name).replace(dtype="float32", **over)
    tcfg = tcfgs.get_reduced(name).replace(dtype="float32", **over)
    rng = np.random.default_rng(seed)
    np_tree = jax.tree_util.tree_map(
        lambda x: (np.asarray(x, np.float32)
                   + 0.05 * rng.standard_normal(x.shape, dtype=np.float32)),
        jbuild(jcfg).init(jax.random.PRNGKey(seed)))
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, np_tree), tcfg,
            params_from_numpy(np_tree, device="cpu"))


@pytest.fixture(scope="module")
def pair():
    """tests/test_equivalence.py's pair: reduced qwen2.5-32b teacher,
    reduced granite-3-8b student, vocab 512."""
    return (_model("qwen2.5-32b", 1, vocab_size=512),
            _model("granite-3-8b", 2, vocab_size=512))


def test_distill_loss_matches_jax(pair):
    (jt_cfg, jt_p, tt_cfg, tt_p), (js_cfg, js_p, ts_cfg, ts_p) = pair
    rng = np.random.default_rng(0)
    B, S = 2, 16
    toks = rng.integers(0, 512, (B, S))
    labels = rng.integers(0, 512, (B, S))
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32),
          "loss_mask": jnp.asarray(mask)}
    tb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels),
          "loss_mask": torch.from_numpy(mask)}
    h_tj = jdw.teacher_hidden(jt_p, jt_cfg, jb["tokens"], impl="ref")
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jdw.distill_loss(p, js_cfg, jb, h_tj, jt_p["unembed"],
                                   alpha=0.5, temperature=2.0, impl="ref",
                                   kl_impl="ref"), has_aux=True)(js_p)
    h_t = tdw.teacher_hidden(tt_p, tt_cfg, tb["tokens"])
    assert h_t.grad_fn is None
    _close(h_t, h_tj)
    params = tcm.tree_map(lambda x: x.clone().requires_grad_(), ts_p)
    loss, met = tdw.distill_loss(params, ts_cfg, tb, h_t,
                                 tdw.teacher_unembedding(tt_p, tt_cfg),
                                 alpha=0.5, temperature=2.0)
    grads = torch.autograd.grad(loss, tcm.tree_leaves(params))
    _close(loss, jloss)
    for k in ("ce", "kl"):
        _close(met[k], jmet[k])
    _close_trees(tcm.tree_unflatten(params, grads), jgrads)


def test_colocated_step_three_steps_match_jax(pair):
    (jt_cfg, jt_p, tt_cfg, tt_p), (js_cfg, js_p, ts_cfg, ts_p) = pair
    B, S, alpha, T = 4, 16, 0.5, 2.0
    sched = dict(peak_lr=1e-2, warmup_steps=1, total_steps=3)
    step = tdw.build_colocated_step(
        tt_cfg, ts_cfg, ShapeConfig("t", "train", S, B),
        ParallelConfig(mbs=2), alpha=alpha, temperature=T,
        lr_schedule=functools.partial(tsched.warmup_cosine, **sched),
        opt_cfg=tadamw.AdamWConfig(eps=OPT_EPS))

    def jloss(p, b):
        h_t = jdw.teacher_hidden(jt_p, jt_cfg, b["tokens"], impl="ref")
        return jdw.distill_loss(p, js_cfg, b, h_t, jt_p["unembed"],
                                alpha=alpha, temperature=T, impl="ref",
                                kl_impl="ref")[0]

    grad_fn = jax.jit(jax.value_and_grad(jloss))
    jopt = jadamw.init(js_p)
    params = tcm.tree_map(lambda x: x.clone().requires_grad_(), ts_p)
    opt = tadamw.init(params)
    teacher = tcm.tree_map(torch.clone, tt_p)
    jit = jdata.lm_batches(batch=B, seq_len=S, vocab=512, seed=4)
    tit = tdata.lm_batches(batch=B, seq_len=S, vocab=512, seed=4,
                           device="cpu")
    for i in range(3):
        jb = next(jit)
        # two micro-batches of 2, accumulated as the JAX step does
        halves = [{k: v[j:j + 2] for k, v in jb.items()} for j in (0, 2)]
        outs = [grad_fn(js_p, h) for h in halves]
        jl = (outs[0][0] + outs[1][0]) / 2
        jg = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, outs[0][1],
                                    outs[1][1])
        js_p, jopt, jn = jadamw.update(
            jg, jopt, jsched.warmup_cosine(jnp.int32(i), **sched),
            jadamw.AdamWConfig(eps=OPT_EPS))
        params, opt, met = step(params, opt, teacher, next(tit), i)
        _close(met["loss"], jl)
        _close(met["grad_norm"], jn)
        assert float(met["kl"]) >= -1e-4
    _close_trees(params, js_p)
    for a, b in zip(tcm.tree_leaves(teacher), tcm.tree_leaves(tt_p)):
        assert torch.equal(a, b)                   # the teacher is frozen


def test_colocated_step_refuses_multi_device_knobs(pair):
    (_, _, tt_cfg, _), (_, _, ts_cfg, _) = pair
    with pytest.raises(NotImplementedError, match="A6"):
        tdw.build_colocated_step(tt_cfg, ts_cfg,
                                 ShapeConfig("t", "train", 8, 2),
                                 ParallelConfig(cp=2))
