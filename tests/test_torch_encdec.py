"""The port's encoder-decoder family (whisper-small) against the JAX
package, on the CPU in float32.

Reduced whisper-small (``get_reduced``: 2 encoder and 2 decoder layers,
d_model 128, 4 heads of 32, 16 frames of 32, vocabulary 512); parameters
are the JAX model's init plus seeded numpy noise, carried across with
``convert.params_from_numpy``; the same numpy tokens and frames go to both
sides.  Checked: the spec tree at full width and the converted tree,
``attention`` with ``kv_override`` (position-free, as the reference's
``rope=False``) and the cross-attention decode, ``encode``,
``decode_train``, ``Model.forward``, ``Model.loss`` and every leaf's gradient, prefill (logits and the whole
cache) and two decode steps against JAX and against ``forward``,
``audio_batches`` element for element, two train steps through
``build_train_step`` on ``audio_batches``, and the serving entry point
with frames.  Every family of ``ARCH_NAMES`` builds at its reduced config.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.types import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.data import synthetic as tdata  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

NAME = "whisper-small"
# float32 on both sides, sums in other orders through a few layers: the
# reference's own test_prefill_decode_matches_forward tolerance
# (tests/test_models_smoke.py)
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
    flat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert len(flat) == len(tcm.tree_leaves(port_tree))
    for path, leaf in flat:
        t = port_tree
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(_np(t), _np(leaf), err_msg=str(path),
                                   **tol)


def _pair(seed=0):
    """JAX model + params (init plus seeded noise) and the port's copy, in
    float32."""
    jcfg = jcfgs.get_reduced(NAME).replace(dtype="float32")
    tcfg = tcfgs.get_reduced(NAME).replace(dtype="float32")
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
    arrs = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)),
            "loss_mask": (rng.random((B, S)) < 0.8).astype(np.float32),
            "frames": rng.standard_normal(
                (B, cfg.frontend_frames, cfg.frontend_dim),
                dtype=np.float32)}
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else None)
          for k, v in arrs.items()}
    tb = {k: torch.from_numpy(v) for k, v in arrs.items()}
    return jb, tb


# --------------------------------------------------------------------------- #
# parameter trees and the model factory
# --------------------------------------------------------------------------- #
def test_spec_tree_matches_jax_at_full_width():
    """Same keys, shapes, dtypes and fan-in dims as the JAX tree at the
    published widths, layers stacked on axis 0 (specs only)."""
    cfg = tcfgs.get_config(NAME).replace(dtype="bfloat16")
    jspecs = jed.encdec_specs(jcfgs.get_config(NAME).replace(
        dtype="bfloat16"))
    tspecs = ted.encdec_specs(cfg)
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
    assert tuple(tspecs["enc_layers"]["attn"]["wq"].shape) == (12, 768, 12,
                                                               64)
    assert tuple(tspecs["dec_layers"]["cross_attn"]["wk"].shape) == (
        12, 768, 12, 64)
    assert tuple(tspecs["unembed"].shape) == (768, cfg.padded_vocab)


def test_params_from_numpy_carries_the_encdec_tree():
    """The JAX init in bf16, converted leaf for leaf: same keys, shapes and
    bits (frontend_proj, both stacks, the untied unembedding)."""
    jm = jbuild(jcfgs.get_reduced(NAME).replace(dtype="bfloat16"))
    np_tree = jax.tree_util.tree_map(np.asarray,
                                     jm.init(jax.random.PRNGKey(0)))
    tree = params_from_numpy(np_tree, device="cpu")
    tm = tbuild(tcfgs.get_reduced(NAME).replace(dtype="bfloat16"), tree,
                device="cpu")
    got = tm.param_tree()
    assert set(got) == {"frontend_proj", "enc_layers", "enc_norm", "embed",
                        "dec_layers", "final_norm", "unembed"}
    assert set(got["dec_layers"]) == {"norm1", "self_attn", "norm_c",
                                      "cross_attn", "norm2", "mlp"}
    for path, leaf in jax.tree_util.tree_flatten_with_path(np_tree)[0]:
        t = got
        for k in path:
            t = t[k.key]
        assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(_np(t),
                                      np.asarray(leaf, np.float32),
                                      err_msg=str(path))


@pytest.mark.parametrize("name", tcfgs.ARCH_NAMES)
def test_build_model_builds_every_arch(name):
    """No family is left to port: every arch builds at its reduced config
    on the CPU."""
    tm = tbuild(tcfgs.get_reduced(name), device="cpu", seed=0)
    specs = (ted.encdec_specs(tm.cfg) if tm.cfg.family == "audio"
             else tmodel.tf.lm_specs(tm.cfg))
    assert (tcm.tree_map(lambda x: tuple(x.shape), tm.param_tree())
            == tcm.tree_map(lambda s: tuple(s.shape), specs))


# --------------------------------------------------------------------------- #
# attention with kv_override
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("T", [16, 5])
def test_cross_attention_matches_jax(T):
    """``attention`` with ``kv_override`` (S = 12 queries over T keys, more
    or fewer than S), and the cross-attention decode (``_attend_full`` with
    no mask, q without RoPE) against the reference's, which passes
    ``rope=False`` there."""
    jm, jparams, tm = _pair(seed=1)
    cfg = tm.cfg
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, cfg.d_model), dtype=np.float32)
    k, v = (rng.standard_normal((2, T, cfg.num_kv_heads, cfg.hd),
                                dtype=np.float32) for _ in range(2))
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["dec_layers"]["cross_attn"])
    tp = tcm.tree_map(lambda a: a[0],
                      tm.param_tree()["dec_layers"]["cross_attn"])
    want = jatt.attention(jp, jnp.asarray(x), jm.cfg, causal=False,
                          kv_override=(jnp.asarray(k), jnp.asarray(v)),
                          rope=False)
    got = tatt.attention(tp, torch.from_numpy(x), cfg, causal=False,
                         kv_override=(torch.from_numpy(k),
                                      torch.from_numpy(v)))
    _close(got, want)
    want = jatt.attention_decode(jp, jnp.asarray(x[:, :1]), None, jm.cfg,
                                 pos=jnp.int32(7),
                                 kv_override=(jnp.asarray(k),
                                              jnp.asarray(v)))
    got = tatt.attention_decode(tp, torch.from_numpy(x[:, :1]), None, cfg,
                                pos=7, kv_override=(torch.from_numpy(k),
                                                    torch.from_numpy(v)))
    _close(got, want)


def test_cross_attention_is_position_free():
    """With ``kv_override`` neither q nor the keys carry positions:
    permuting the keys and values together leaves the output as it was,
    and the decode's output does not depend on ``pos``."""
    _, _, tm = _pair(seed=2)
    cfg = tm.cfg
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 10, cfg.d_model),
                                             dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal(
        (2, 16, cfg.num_kv_heads, cfg.hd), dtype=np.float32))
        for _ in range(2))
    perm = torch.from_numpy(rng.permutation(16))
    tp = tcm.tree_map(lambda a: a[0],
                      tm.param_tree()["dec_layers"]["cross_attn"])
    _close(tatt.attention(tp, x, cfg, causal=False,
                          kv_override=(k[:, perm], v[:, perm])),
           tatt.attention(tp, x, cfg, causal=False, kv_override=(k, v)))
    outs = [tatt.attention_decode(tp, x[:, :1], None, cfg, pos=pos,
                                  kv_override=(k, v)) for pos in (0, 300)]
    _close(outs[1], outs[0])


# --------------------------------------------------------------------------- #
# encoder, decoder, loss, gradients
# --------------------------------------------------------------------------- #
def test_encode_and_decode_train_match_jax():
    jm, jparams, tm = _pair(seed=3)
    jb, tb = _batch(tm.cfg, 2, 12, seed=4)
    jenc = jed.encode(jparams, jm.cfg, jb["frames"])
    tenc = ted.encode(tm.param_tree(), tm.cfg, tb["frames"])
    assert tuple(tenc.shape) == (2, tm.cfg.frontend_frames, tm.cfg.d_model)
    _close(tenc, jenc)
    _close(ted.decode_train(tm.param_tree(), tm.cfg, tb["tokens"], tenc),
           jed.decode_train(jparams, jm.cfg, jb["tokens"], jenc))
    _close(tm({"tokens": tb["tokens"], "frames": tb["frames"]}),
           jm.forward(jparams, {"tokens": jb["tokens"],
                                "frames": jb["frames"]}))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(remat):
    """The loss and the gradient of every leaf (the encoder's through all
    cross-attentions) against ``jax.value_and_grad``."""
    jm, jparams, tm = _pair(seed=5)
    jb, tb = _batch(tm.cfg, 2, 12, seed=6)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True))(jparams)
    params = tm.param_tree()
    loss, met = tm.loss(tb, remat=remat)
    grads = torch.autograd.grad(loss, tcm.tree_leaves(params))
    _close(loss, jloss)
    _close(met["ce"], jmet["ce"])
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    gtree = tcm.tree_unflatten(params, grads)
    assert float(gtree["enc_layers"]["attn"]["wq"].abs().max()) > 0
    _close_trees(gtree, jgrads)


def test_encoder_gradient_comes_from_every_cross_attention():
    """The encoder output's gradient is the sum over all decoder layers'
    cross-attentions: with remat it matches the run without, and zeroing
    one layer's cross-attention keys and values changes it."""
    _, _, tm = _pair(seed=7)
    _, tb = _batch(tm.cfg, 2, 12, seed=8)
    p = tm.param_tree()
    enc = ted.encode(p, tm.cfg, tb["frames"]).detach().requires_grad_()

    def enc_grad(params, remat):
        x = ted.decode_train(params, tm.cfg, tb["tokens"], enc, remat=remat)
        return torch.autograd.grad(x.square().sum(), enc)[0]

    g = enc_grad(p, True)
    _close(g, enc_grad(p, False), dict(atol=1e-6, rtol=1e-6))
    cut = tcm.tree_map(lambda x: x, p)
    cut["dec_layers"]["cross_attn"] = dict(cut["dec_layers"]["cross_attn"])
    for k in ("wk", "wv"):
        w = cut["dec_layers"]["cross_attn"][k].detach().clone()
        w[1] = 0
        cut["dec_layers"]["cross_attn"][k] = w
    assert float((enc_grad(cut, True) - g).abs().max()) > 1e-3


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def test_prefill_decode_match_jax_and_forward():
    """Prefill S-2 tokens, then two decode steps: logits and the whole
    cache tree (self cache of S + extra slots, the static cross cache)
    against JAX's, and the logits against the port's own forward."""
    jm, jparams, tm = _pair(seed=9)
    B, S = 2, 16
    jb, tb = _batch(tm.cfg, B, S, seed=10)
    full = tm({"tokens": tb["tokens"], "frames": tb["frames"]})
    jlog, jcache = jm.prefill(jparams, {"tokens": jb["tokens"][:, :S - 2],
                                        "frames": jb["frames"]},
                              extra_cache=2)
    tlog, tcache = tm.prefill({"tokens": tb["tokens"][:, :S - 2],
                               "frames": tb["frames"]}, extra_cache=2)
    L, F = tm.cfg.num_layers, tm.cfg.frontend_frames
    assert tuple(tcache["self"]["k"].shape) == (L, B, S, 4, 32)
    assert tuple(tcache["cross"]["v"].shape) == (L, B, F, 4, 32)
    _close(tlog, jlog)
    _close(tlog, full[:, S - 3])
    _close_trees(tcache, jcache)
    for pos in (S - 2, S - 1):
        jlog, jcache = jm.decode(jparams, jcache, jb["tokens"][:, pos:pos + 1],
                                 jnp.int32(pos))
        tlog, tcache2 = tm.decode(tcache, tb["tokens"][:, pos:pos + 1], pos)
        assert tcache2 is tcache                       # written in place
        _close(tlog, jlog)
        _close(tlog, full[:, pos])
    _close_trees(tcache, jcache)


def test_generate_with_frames_and_the_cli_refusal(capsys):
    """``generate`` serves whisper with frames on the CPU (no kernel
    launch); without them, and through the CLI, which passes tokens only,
    it raises a ValueError naming the frames."""
    tm = tbuild(tcfgs.get_reduced(NAME), device="cpu", seed=0)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, 512, (2, 6)))
    frames = torch.from_numpy(rng.standard_normal(
        (2, tm.cfg.frontend_frames, tm.cfg.frontend_dim), dtype=np.float32))
    before = fa.flash_fwd.launches
    res = tserve.generate(tm, prompts, 4, frames=frames)
    assert fa.flash_fwd.launches == before
    assert tuple(res.tokens.shape) == (2, 4) and res.logits_finite
    assert bool(((res.tokens >= 0) & (res.tokens < 512)).all())
    with pytest.raises(ValueError, match="frames"):
        tserve.generate(tm, prompts, 4)
    with pytest.raises(ValueError, match="frames"):
        tserve.main(["--arch", NAME, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "6", "--gen", "2"])


# --------------------------------------------------------------------------- #
# data and training
# --------------------------------------------------------------------------- #
def test_audio_batches_match_jax():
    """The same numpy draws in the same order: equal element for element
    (frames in bf16 on both sides)."""
    kw = dict(batch=3, seq_len=10, vocab=512, frames=16, frame_dim=32,
              seed=11)
    jit = jdata.audio_batches(**kw)
    tit = tdata.audio_batches(**kw, device="cpu")
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        assert set(jb) == set(tb)
        assert tb["frames"].dtype == torch.bfloat16
        for k in jb:
            np.testing.assert_array_equal(_np(tb[k]), _np(jb[k]), err_msg=k)


def test_train_step_two_steps_match_jax():
    """Two steps through ``build_train_step`` on ``audio_batches`` (batch
    4 in microbatches of 2, frames split with the tokens) against
    ``jax.value_and_grad`` plus ``repro.optim.adamw.update``."""
    jm, jparams, tm = _pair(seed=12)
    B, S, mbs = 4, 10, 2
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
    kw = dict(batch=B, seq_len=S, vocab=tm.cfg.vocab_size,
              frames=tm.cfg.frontend_frames, frame_dim=tm.cfg.frontend_dim,
              seed=13)
    jit = jdata.audio_batches(**kw)
    tit = tdata.audio_batches(**kw, device="cpu")
    for i in range(2):
        (jloss, jmet), jgrads = grad_fn(jparams, next(jit))
        jparams, jopt, jn = update(
            jgrads, jopt, jsched.warmup_cosine(jnp.int32(i), **sched),
            jadamw.AdamWConfig(eps=OPT_EPS))
        params, opt, met = step(params, opt, next(tit), i)
        _close(met["loss"], jloss)
        _close(met["grad_norm"], jn)
    _close_trees(params, jparams)
