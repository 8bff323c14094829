"""The port's vision pieces against the JAX package, on the CPU in float32.

* ``models.vlm.vit_encode`` (bidirectional attention through the plain
  flash version; JAX ``impl="ref"``): output and gradients;
* ``transformer.vision_scatter`` through ``embed_tokens`` of the reduced
  pixtral-12b with ``image_embeds``, including a sample with
  ``image_valid = 0``: embeddings and gradients;
* ``build_model`` on the ``vlm`` and ``vit`` families against the JAX
  ``Model.loss``;
* ``data.synthetic.vlm_batches`` draw for draw (seeds 0 and 1; patches
  bitwise after the bf16 cast);
* ``build_vlm_graph``, ``maybe_colocate_exclusive`` and ``vlm_compound``,
  structurally.

Inputs come from seeded numpy; weights are the JAX init plus seeded
noise, carried across with ``convert.params_from_numpy``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.configs import compound as jcomp  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core.types import ParallelConfig as JParallel  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models import vlm as jvlm  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.configs import compound as tcomp  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core.types import ParallelConfig as TParallel  # noqa: E402
from repro_torch.data import synthetic as tdata  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models import vlm as tvlm  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402

# one forward in float32: the frameworks sum matrix products and
# reductions in other orders; 2e-5 is far below a wrong mask or scale
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
# gradients pass back through every layer's products and the loss:
# tests/test_torch_train.py's 2e-4
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
VIT_KW = dict(num_layers=2, d_model=32, num_heads=2, d_ff=64, patch_dim=16,
              downsample=4, out_dim=32, name="vit-tiny")


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close_trees(port_tree, jax_tree, tol):
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        t = port_tree
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(_np(t), _np(leaf), err_msg=str(path),
                                   **tol)


def _noisy(tree, seed):
    """JAX init plus seeded noise, as numpy: the norm scales and zero
    biases move off their constants, so a wrong leaf shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x, np.float32)
                   + 0.05 * rng.standard_normal(x.shape, dtype=np.float32)),
        tree)


def _vit_pair(seed=0):
    jcfg = jvlm.vit_config(**VIT_KW).replace(dtype="float32")
    tcfg = tvlm.vit_config(**VIT_KW).replace(dtype="float32")
    np_tree = _noisy(jcm.init_params(jvlm.vit_specs(jcfg),
                                     jax.random.PRNGKey(seed)), seed)
    return jcfg, tcfg, np_tree


def test_vit_config_and_specs_match():
    j, t = jvlm.vit_config(out_dim=1024), tvlm.vit_config(out_dim=1024)
    assert t == t.replace() and vars(t) == vars(j)
    assert tvlm.downsample_factor(t) == jvlm.downsample_factor(j) == 4
    assert (t.mlp_act, t.norm_type, t.family) == ("swiglu", "rms", "vit")
    js = jax.tree_util.tree_map(lambda s: tuple(s.shape),
                                jvlm.vit_specs(j),
                                is_leaf=lambda x: isinstance(x, jcm.ParamSpec))
    ts = tcm.tree_map(lambda s: tuple(s.shape), tvlm.vit_specs(t))
    assert ts == js


@pytest.mark.parametrize("remat", [True, False])
def test_vit_encode_and_grads_match_jax(remat):
    jcfg, tcfg, np_tree = _vit_pair()
    rng = np.random.default_rng(1)
    P = 8 * tvlm.downsample_factor(tcfg)
    patches = rng.standard_normal((3, P, 16), dtype=np.float32)
    cot = rng.standard_normal((3, 8, 32), dtype=np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)

    def jloss(p):
        emb = jvlm.vit_encode(p, jcfg, jnp.asarray(patches), impl="ref",
                              remat=remat)
        return jnp.sum(emb * cot), emb

    (_, jemb), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = tcm.tree_map(lambda x: x.requires_grad_(),
                          params_from_numpy(np_tree, device="cpu"))
    emb = tvlm.vit_encode(params, tcfg, torch.from_numpy(patches),
                          remat=remat)
    assert tuple(emb.shape) == (3, 8, 32)
    np.testing.assert_allclose(_np(emb), np.asarray(jemb), **FWD_TOL)
    grads = torch.autograd.grad((emb * torch.from_numpy(cot)).sum(),
                                tcm.tree_leaves(params))
    _close_trees(tcm.tree_unflatten(params, grads), jgrads, GRAD_TOL)


def test_vit_attention_is_bidirectional():
    """The last patch changes every embedding (no causal mask)."""
    _, tcfg, np_tree = _vit_pair()
    params = params_from_numpy(np_tree, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 32, 16), dtype=np.float32))
    y = x.clone()
    y[:, -1] += 1.0
    a, b = (tvlm.vit_encode(params, tcfg, z) for z in (x, y))
    assert bool((a[:, 0] != b[:, 0]).any())


@pytest.mark.parametrize("causal", [True, False])
def test_attention_causal_matches_jax(causal):
    """``attention``'s ``causal`` keyword, as the reference takes it."""
    from repro.models import attention as jatt
    from repro_torch.models import attention as tatt
    jcfg = jcfgs.get_reduced("granite-3-8b").replace(dtype="float32")
    tcfg = tcfgs.get_reduced("granite-3-8b").replace(dtype="float32")
    np_tree = _noisy(jcm.init_params(jatt.attn_specs(jcfg),
                                     jax.random.PRNGKey(4)), 4)
    x = np.random.default_rng(5).standard_normal((2, 12, tcfg.d_model),
                                                 dtype=np.float32)
    want = jatt.attention(
        jax.tree_util.tree_map(jnp.asarray, np_tree), jnp.asarray(x), jcfg,
        causal=causal, impl="ref")
    got = tatt.attention(params_from_numpy(np_tree, device="cpu"),
                         torch.from_numpy(x), tcfg, causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD_TOL)


def _pixtral(family="vlm", **over):
    kw = dict(dtype="float32", vocab_size=128, max_image_tokens=4)
    kw.update(over)
    return (jcfgs.get_reduced("pixtral-12b").replace(family=family, **kw),
            tcfgs.get_reduced("pixtral-12b").replace(family=family, **kw))


def _vlm_batch(cfg, B, S, K, seed):
    """Tokens, labels, a loss mask and image slots; sample 1 carries no
    image (``image_valid`` 0), sample 0 its image at scattered slots."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)),
         "loss_mask": (rng.random((B, S)) < 0.8).astype(np.float32),
         "image_pos": np.stack([rng.permutation(S)[:K] for _ in range(B)]),
         "image_valid": np.ones((B, K), np.int32),
         "image_embeds": rng.standard_normal((B, K, cfg.vision_dim),
                                             dtype=np.float32)}
    b["image_valid"][1] = 0
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else v.dtype)
          for k, v in b.items()}
    return jb, {k: torch.from_numpy(v) for k, v in b.items()}


def test_vision_scatter_matches_jax():
    jcfg, tcfg = _pixtral()
    np_tree = _noisy(jbuild(jcfg).init(jax.random.PRNGKey(0)), 0)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    jb, tb = _vlm_batch(tcfg, 3, 16, 4, seed=3)
    rng = np.random.default_rng(4)
    cot = rng.standard_normal((3, 16, tcfg.d_model), dtype=np.float32)

    def jemb(p, e):
        x = jtf.embed_tokens(p, jcfg, dict(jb, image_embeds=e))
        return jnp.sum(x * cot), x

    (_, jx), (jg, jge) = jax.value_and_grad(jemb, argnums=(0, 1),
                                            has_aux=True)(
        jparams, jb["image_embeds"])
    params = tcm.tree_map(lambda x: x.requires_grad_(),
                          params_from_numpy(np_tree, device="cpu"))
    emb = tb["image_embeds"].requires_grad_()
    x = ttf.embed_tokens(params, tcfg, dict(tb, image_embeds=emb))
    np.testing.assert_allclose(_np(x), np.asarray(jx), **FWD_TOL)
    # the sample with no image keeps its token embeddings exactly
    np.testing.assert_array_equal(
        _np(x[1]), _np(params["embed"][tb["tokens"][1]]))
    want = {"embed": jg["embed"], "vision_proj": jg["vision_proj"]}
    leaves = [params["embed"], params["vision_proj"], emb]
    got = torch.autograd.grad((x * torch.from_numpy(cot)).sum(), leaves)
    _close_trees({"embed": got[0], "vision_proj": got[1]}, want, GRAD_TOL)
    np.testing.assert_allclose(_np(got[2]), np.asarray(jge), **GRAD_TOL)
    assert float(got[2][1].abs().max()) == 0.0


def test_build_model_vlm_matches_jax_loss():
    jcfg, tcfg = _pixtral()
    jm = jbuild(jcfg)
    np_tree = _noisy(jm.init(jax.random.PRNGKey(1)), 1)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    tm = tbuild(tcfg, params_from_numpy(np_tree, device="cpu"),
                device="cpu")
    assert "vision_proj" in tm.param_tree()
    jb, tb = _vlm_batch(tcfg, 2, 24, 4, seed=5)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True)(jparams)
    params = tm.param_tree()
    loss, met = tm.loss(tb)
    grads = torch.autograd.grad(loss, tcm.tree_leaves(params))
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), **GRAD_TOL)
    np.testing.assert_allclose(_np(met["ce"]), np.asarray(jmet["ce"]),
                               **GRAD_TOL)
    _close_trees(tcm.tree_unflatten(params, grads), jgrads, GRAD_TOL)
    # serving takes the same image slots in prefill
    logits, _ = tm.prefill({k: tb[k] for k in ("tokens", "image_embeds",
                                                "image_pos", "image_valid")})
    np.testing.assert_allclose(
        _np(logits), _np(tm(tb)[:, -1]), **FWD_TOL)


def test_build_model_vit_family_matches_jax_loss():
    """The ``vit`` family: encoder-only, bidirectional, CE alone."""
    jcfg, tcfg = _pixtral("vit")
    jm = jbuild(jcfg)
    np_tree = _noisy(jm.init(jax.random.PRNGKey(2)), 2)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    tm = tbuild(tcfg, params_from_numpy(np_tree, device="cpu"),
                device="cpu")
    jb, tb = _vlm_batch(tcfg, 2, 24, 4, seed=6)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True)(jparams)
    params = tm.param_tree()
    loss, met = tm.loss(tb)
    grads = torch.autograd.grad(loss, tcm.tree_leaves(params))
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), **GRAD_TOL)
    assert torch.equal(loss, met["ce"])
    _close_trees(tcm.tree_unflatten(params, grads), jgrads, GRAD_TOL)
    np.testing.assert_allclose(_np(tm(tb)), np.asarray(jm.forward(jparams,
                                                                  jb)),
                               **FWD_TOL)
    for call in (lambda: tm.prefill(tb), lambda: tm.decode({}, None, 0)):
        with pytest.raises(NotImplementedError, match="vit"):
            call()


@pytest.mark.parametrize("seed,ratio", [(0, 0.5), (1, 0.5), (1, 0.0)])
def test_vlm_batches_match_jax(seed, ratio):
    kw = dict(batch=6, seq_len=24, vocab=97, vision_ratio=ratio,
              image_tokens=4, patch_dim=8, seed=seed)
    jgen, tgen = jdata.vlm_batches(**kw), tdata.vlm_batches(device="cpu",
                                                             **kw)
    for _ in range(2):
        jb, tb = next(jgen), next(tgen)
        assert set(tb) == set(jb)
        for k in jb:
            want = np.asarray(jb[k])
            if k == "patches":
                assert tb[k].dtype == torch.bfloat16
                want = want.astype(np.float32)     # exact widening
            np.testing.assert_array_equal(_np(tb[k]) if k == "patches"
                                          else tb[k].numpy(), want,
                                          err_msg=k)
        if ratio == 0.0:
            assert int(tb["has_image"].sum()) == 0
    rng_j, rng_t = (np.random.default_rng(7) for _ in range(2))
    js = jdata.sample_modalities(rng_j, 5, vision_ratio=0.5, image_tokens=3)
    ts = tdata.sample_modalities(rng_t, 5, vision_ratio=0.5, image_tokens=3)
    assert [vars(s) for s in ts] == [vars(s) for s in js]


def _graph_view(g):
    secs = {n: (s.arch.name, s.trainable, s.critical, s.seq_scale,
                (s.parallel.dp, s.parallel.tp, s.parallel.pp, s.parallel.cp))
            for n, s in g.sections.items()}
    edges = [(e.src, e.dst, e.hidden_handoff, e.bytes_per_token, e.fanout)
             for e in g.edges]
    return secs, edges


@pytest.mark.parametrize("lm_name", ["qwen2.5-32b", "pixtral-12b"])
def test_vlm_compound_matches(lm_name):
    t, j = tcomp.vlm_compound(lm_name), jcomp.vlm_compound(lm_name)
    assert _graph_view(t) == _graph_view(j)
    assert t.sections["vit"].arch == tvlm.vit_config(
        out_dim=tcfgs.get_config(lm_name).d_model)


def test_build_vlm_graph_matches():
    lm_t, lm_j = tcfgs.get_config("pixtral-12b"), jcfgs.get_config(
        "pixtral-12b")
    vt, vj = tvlm.vit_config(out_dim=1024), jvlm.vit_config(out_dim=1024)
    t = tgraph.build_vlm_graph(vt, lm_t, vit_parallel=TParallel(), fanout=2)
    j = jgraph.build_vlm_graph(vj, lm_j, vit_parallel=JParallel(), fanout=2)
    assert _graph_view(t) == _graph_view(j)
    # the default ViT parallelism is the reference's cp = 2
    assert _graph_view(tgraph.build_vlm_graph(vt, lm_t)) == _graph_view(
        jgraph.build_vlm_graph(vj, lm_j))


def _omni(graph, types, parallel, vit, enc, lm):
    """ViT and a second encoder section, both feeding the LM."""
    g = graph.build_vlm_graph(vit, lm, vit_parallel=parallel())
    g.add(types.SectionConfig("enc", enc, parallel(), seq_scale=0.25))
    g.connect("enc", "llm", bytes_per_token=lm.d_model * 2)
    return g


@pytest.mark.parametrize("rate,enc,merged", [
    (0.01, dict(num_layers=20, name="audio-enc"), True),
    (0.2, dict(num_layers=20, name="audio-enc"), False),   # co-active
    (0.01, dict(num_layers=60, name="big-enc"), False)])   # 2.5x the size
def test_maybe_colocate_exclusive_matches(rate, enc, merged):
    from repro.core import types as jtypes
    from repro_torch.core import types as ttypes
    lm_t, lm_j = tcfgs.get_config("pixtral-12b"), jcfgs.get_config(
        "pixtral-12b")
    gt = _omni(tgraph, ttypes, TParallel, tvlm.vit_config(out_dim=1024),
               tvlm.vit_config(out_dim=1024, **enc), lm_t)
    gj = _omni(jgraph, jtypes, JParallel, jvlm.vit_config(out_dim=1024),
               jvlm.vit_config(out_dim=1024, **enc), lm_j)
    mt = tgraph.maybe_colocate_exclusive(gt, "vit", "enc",
                                         coactivation_rate=rate)
    mj = jgraph.maybe_colocate_exclusive(gj, "vit", "enc",
                                         coactivation_rate=rate)
    assert _graph_view(mt) == _graph_view(mj)
    assert ("vit+enc" in mt.sections) == merged
