"""The port's serving path against the JAX package, on the CPU in float32.

Parameters come from the JAX model's init plus seeded numpy noise (so
norm scales and biases are not trivially 1 and 0), converted leaf for leaf
with ``repro_torch.convert.params_from_numpy``; the same numpy tokens go
to both sides.  Tolerances are ``tests/test_models_smoke.py``'s 2e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
ARCHS = ["granite-3-8b", "qwen1.5-0.5b"]
DENSE = ["granite-20b", "qwen1.5-0.5b", "qwen2.5-32b", "granite-3-8b"]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, ref):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref),
                               **TOL)


def _noisy_params(jmodel, seed):
    """JAX init + seeded noise, as (jax tree, numpy tree)."""
    rng = np.random.default_rng(seed)
    params = jmodel.init(jax.random.PRNGKey(seed))
    np_tree = jax.tree_util.tree_map(
        lambda x: (np.asarray(x, np.float32)
                   + 0.05 * rng.standard_normal(x.shape, dtype=np.float32)),
        params)
    return jax.tree_util.tree_map(jnp.asarray, np_tree), np_tree


def _pair(name, seed=0, **over):
    jcfg = jcfgs.get_reduced(name).replace(dtype="float32", **over)
    tcfg = tcfgs.get_reduced(name).replace(dtype="float32", **over)
    jm = jbuild(jcfg)
    jparams, np_tree = _noisy_params(jm, seed)
    tm = tbuild(tcfg, params_from_numpy(np_tree, device="cpu"), device="cpu")
    return jm, jparams, tm, np_tree


# --------------------------------------------------------------------------- #
# configs and parameter trees
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", jcfgs.ARCH_NAMES)
def test_configs_match(name):
    assert tcfgs.ARCH_NAMES == jcfgs.ARCH_NAMES
    assert (dataclasses.asdict(tcfgs.get_config(name))
            == dataclasses.asdict(jcfgs.get_config(name)))
    assert (dataclasses.asdict(tcfgs.get_reduced(name))
            == dataclasses.asdict(jcfgs.get_reduced(name)))


@pytest.mark.parametrize("name", DENSE)
def test_spec_tree_matches_full_config(name):
    """Same keys and shapes as the JAX tree at the published widths (specs
    only; nothing is allocated)."""
    jshapes = jax.tree_util.tree_map(
        lambda s: tuple(s.shape), jbuild(jcfgs.get_config(name)).param_shapes())
    tshapes = tcm.tree_map(lambda s: tuple(s.shape),
                           ttf.lm_specs(tcfgs.get_config(name)))
    assert tshapes == jshapes


def test_init_params_truncated_and_seeded():
    cfg = tcfgs.get_reduced("granite-3-8b")
    specs = ttf.lm_specs(cfg)
    a = tcm.init_params(specs, torch.Generator().manual_seed(3), "cpu")
    b = tcm.init_params(specs, torch.Generator().manual_seed(3), "cpu")
    leaves, others = [], []
    tcm.tree_map(leaves.append, a)
    tcm.tree_map(others.append, b)
    assert len(leaves) == len(others) > 0
    assert all(torch.equal(x, y) for x, y in zip(leaves, others))
    wq = a["layers"]["sub0"]["attn"]["wq"].float()   # fan-in d_model
    std = cfg.d_model ** -0.5
    assert wq.abs().max() <= 2 * std * (1 + 1e-2)
    assert 0.7 * std < wq.std() < 1.0 * std          # truncation shrinks it
    assert torch.all(a["final_norm"]["scale"] == 1)


def test_build_model_rejects_other_families_and_bad_trees():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbuild(tcfgs.get_reduced("granite-3-8b").replace(family="retnet"),
               device="cpu")
    cfg = tcfgs.get_reduced("granite-3-8b").replace(dtype="float32")
    params = tcm.init_params(ttf.lm_specs(cfg), torch.Generator(), "cpu")
    del params["final_norm"]
    with pytest.raises(ValueError, match="specs"):
        tbuild(cfg, params, device="cpu")


def test_params_from_numpy_bfloat16_exact():
    x = jax.random.normal(jax.random.PRNGKey(0), (4, 8), jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(x)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x, np.float32))


# --------------------------------------------------------------------------- #
# building blocks
# --------------------------------------------------------------------------- #
def test_rms_norm_and_layer_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3
    w = rng.standard_normal(64, dtype=np.float32)
    b = rng.standard_normal(64, dtype=np.float32)
    _close(tcm.rms_norm(_t(x), _t(w), 1e-5),
           jcm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    _close(tcm.layer_norm(_t(x), _t(w), _t(b), 1e-5),
           jcm.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          1e-5))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32), dtype=np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    _close(tcm.apply_rope(_t(x), _t(pos), theta),
           jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(act):
    jcfg = jcfgs.get_reduced("granite-3-8b").replace(dtype="float32",
                                                     mlp_act=act)
    tcfg = tcfgs.get_reduced("granite-3-8b").replace(dtype="float32",
                                                     mlp_act=act)
    rng = np.random.default_rng(2)
    p = {k: rng.standard_normal(s.shape, dtype=np.float32) * 0.1
         for k, s in jmlp.mlp_specs(jcfg).items()}
    x = rng.standard_normal((2, 5, jcfg.d_model), dtype=np.float32)
    _close(tmlp.mlp({k: _t(v) for k, v in p.items()}, _t(x), tcfg),
           jmlp.mlp({k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x), jcfg))


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("window", [0, 4])
def test_attention_prefill_and_decode(name, window):
    jcfg = jcfgs.get_reduced(name).replace(dtype="float32",
                                           sliding_window=window)
    tcfg = tcfgs.get_reduced(name).replace(dtype="float32",
                                           sliding_window=window)
    rng = np.random.default_rng(3)
    p = {k: rng.standard_normal(s.shape, dtype=np.float32) * 0.1
         for k, s in jatt.attn_specs(jcfg).items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    B, S = 2, 12
    x = rng.standard_normal((B, S, jcfg.d_model), dtype=np.float32)
    clen = ttf.kv_cache_len(tcfg, S + 1)
    jo, jc = jatt.attention_prefill(jp, jnp.asarray(x), jcfg, cache_len=clen)
    to, tc = tatt.attention_prefill(tp, _t(x), tcfg, cache_len=clen)
    _close(to, jo)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    x1 = rng.standard_normal((B, 1, jcfg.d_model), dtype=np.float32)
    jo, jc = jatt.attention_decode(jp, jnp.asarray(x1), jc, jcfg,
                                   pos=jnp.int32(S))
    to, tc2 = tatt.attention_decode(tp, _t(x1), tc, tcfg, pos=S)
    assert tc2["k"] is tc["k"]                        # written in place
    _close(to, jo)
    _close(tc["k"], jc["k"])


# --------------------------------------------------------------------------- #
# whole model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_loss_match_jax(name):
    jm, jparams, tm, _ = _pair(name)
    rng = np.random.default_rng(5)
    B, S = 2, 32
    tokens = rng.integers(0, tm.cfg.vocab_size, (B, S))
    labels = rng.integers(0, tm.cfg.vocab_size, (B, S))
    _close(tm({"tokens": _t(tokens)}),
           jm.forward(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}))
    jloss, _ = jm.loss(jparams, {"tokens": jnp.asarray(tokens, jnp.int32),
                                 "labels": jnp.asarray(labels, jnp.int32),
                                 "loss_mask": jnp.ones((B, S))})
    tloss, tmet = tm.loss({"tokens": _t(tokens), "labels": _t(labels),
                           "loss_mask": torch.ones(B, S)})
    _close(tloss.detach(), jloss)
    _close(tmet["ce"].detach(), jloss)


def test_forward_with_segment_ids_matches_jax():
    """Packed sequences through ``lm_forward``'s ``batch["segment_ids"]``
    (ROADMAP.md, C4): the plain attention masks across segments as the
    JAX package does."""
    jm, jparams, tm, _ = _pair("qwen1.5-0.5b", seed=2)
    rng = np.random.default_rng(6)
    B, S = 2, 32
    tokens = rng.integers(0, tm.cfg.vocab_size, (B, S))
    seg = np.stack([np.repeat(np.arange(2), S // 2),
                    (np.arange(S) >= 5).astype(np.int64)
                    + (np.arange(S) >= 20)]).astype(np.int32)
    want = jm.forward(jparams, {"tokens": jnp.asarray(tokens, jnp.int32),
                                "segment_ids": jnp.asarray(seg)})
    got = tm({"tokens": _t(tokens), "segment_ids": _t(seg)})
    _close(got, want)
    assert not torch.allclose(got, tm({"tokens": _t(tokens)}), atol=1e-3)


def test_forward_with_padded_heads_and_vocab():
    """head_pad / vocab_pad change the layout, not the logits."""
    jm, jparams, tm, _ = _pair("granite-3-8b", seed=4, head_pad=2,
                               vocab_pad=3)
    tokens = np.random.default_rng(9).integers(0, tm.cfg.vocab_size, (2, 16))
    logits = tm({"tokens": _t(tokens)})
    assert logits.shape[-1] == tm.cfg.vocab_size + 3
    assert torch.all(logits[..., tm.cfg.vocab_size:] == -1e30)
    _close(logits, jm.forward(jparams,
                              {"tokens": jnp.asarray(tokens, jnp.int32)}))


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_match_jax_and_forward(name):
    """Prefill S-2 tokens then decode 2 == JAX's, and == the port's own
    forward (test_models_smoke.py's property)."""
    jm, jparams, tm, _ = _pair(name, seed=1)
    B, S = 2, 16
    tokens = np.random.default_rng(6).integers(0, tm.cfg.vocab_size, (B, S))
    full = tm({"tokens": _t(tokens)})
    jlog, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(
        tokens[:, :S - 2], jnp.int32)}, extra_cache=2)
    tlog, tcache = tm.prefill({"tokens": _t(tokens[:, :S - 2])},
                              extra_cache=2)
    _close(tlog, jlog)
    _close(tlog, full[:, S - 3].numpy())
    _close(tcache["sub0"]["k"], jcache["sub0"]["k"])
    for pos in (S - 2, S - 1):
        jlog, jcache = jm.decode(jparams, jcache,
                                 jnp.asarray(tokens[:, pos:pos + 1], jnp.int32),
                                 jnp.int32(pos))
        tlog, tcache = tm.decode(tcache, _t(tokens[:, pos:pos + 1]), pos)
        _close(tlog, jlog)
        _close(tlog, full[:, pos].numpy())


def test_sliding_window_rolling_cache():
    """Dense arch with an 8-slot rolling cache: decode after a 23-token
    prompt matches JAX and the port's forward."""
    jm, jparams, tm, _ = _pair("granite-3-8b", seed=2, sliding_window=8)
    B, S = 1, 24
    tokens = np.random.default_rng(7).integers(0, tm.cfg.vocab_size, (B, S))
    full = tm({"tokens": _t(tokens)})
    _, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(
        tokens[:, :S - 1], jnp.int32)}, extra_cache=1)
    _, tcache = tm.prefill({"tokens": _t(tokens[:, :S - 1])}, extra_cache=1)
    assert tcache["sub0"]["k"].shape[2] == 8          # window-sized cache
    _close(tcache["sub0"]["k"], jcache["sub0"]["k"])
    jlog, _ = jm.decode(jparams, jcache,
                        jnp.asarray(tokens[:, S - 1:], jnp.int32),
                        jnp.int32(S - 1))
    tlog, _ = tm.decode(tcache, _t(tokens[:, S - 1:]), S - 1)
    _close(tlog, jlog)
    _close(tlog, full[:, S - 1].numpy())


# --------------------------------------------------------------------------- #
# the serving entry point
# --------------------------------------------------------------------------- #
def test_generate_matches_jax_greedy_loop():
    jm, jparams, tm, _ = _pair("granite-3-8b", seed=3)
    B, S, gen = 2, 12, 5
    prompts = np.random.default_rng(8).integers(0, tm.cfg.vocab_size, (B, S))
    res = tserve.generate(tm, _t(prompts), gen)
    logits, cache = jm.prefill(jparams, {"tokens": jnp.asarray(
        prompts, jnp.int32)}, extra_cache=gen)
    out = [jnp.argmax(logits, -1)[:, None].astype(jnp.int32)]
    for i in range(gen - 1):
        logits, cache = jm.decode(jparams, cache, out[-1], jnp.int32(S + i))
        out.append(jnp.argmax(logits, -1)[:, None].astype(jnp.int32))
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.asarray(jnp.concatenate(out, axis=1)))
    assert res.logits_finite
    assert res.prefill_launches == 0 and res.decode_launches == 0   # CPU


def test_cli_end_to_end_cpu(capsys):
    res = tserve.main(["--arch", "granite-3-8b", "--reduced", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "16", "--gen",
                       "4", "--seed", "1"])
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode:" in out
    assert "flash kernel launches: prefill 0" in out
    assert tuple(res.tokens.shape) == (2, 4)
    assert bool(((res.tokens >= 0) & (res.tokens < 512)).all())
    assert res.logits_finite
    again = tserve.serve("granite-3-8b", reduced=True, batch=2, prompt_len=16,
                         gen=4, device="cpu", seed=1)
    assert torch.equal(again.tokens, res.tokens)      # seeded end to end
