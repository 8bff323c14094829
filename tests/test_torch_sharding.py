"""The port's sharding rules (``repro_torch.dist.sharding``) against the JAX
package's, exactly, on device-free meshes.

* The ten cases of ``tests/test_sharding.py``: each calls the JAX function
  on an ``AbstractMesh`` and the port's on the same ``{axis: size}``
  mapping, and the specs must be equal as tuples.
* Every leaf of every ``ARCH_NAMES`` config's parameter spec tree (full
  size) under ``spec_for`` with ``rules_for`` (and ``teacher=True``) and
  under ``zero_extend``, on meshes (data, model) (16, 16), (pod, data,
  model) (2, 16, 16), (data, pipe, seq, model) (2, 1, 1, 4) and (2, 2, 1, 2);
  the spec trees of both packages must have the same keys, shapes and
  logical axes.
* The batch, logits and cache spec fallbacks, ``head_pad_for``, and the
  counterpart of ``tests/test_equivalence.py::test_head_pad_is_numerics_
  neutral``; the block each mesh coordinate takes (``shard``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.models.common import ParamSpec as JSpec  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models.common import ParamSpec  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.models.model import model_specs  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x1x1x4": ((2, 1, 1, 4), ("data", "pipe", "seq", "model")),
    "2x2x1x2": ((2, 2, 1, 2), ("data", "pipe", "seq", "model")),
}


def _meshes(key):
    shape, axes = MESHES[key]
    return jshd.abstract_mesh(shape, axes), dict(zip(axes, shape))


def _pair(shape, axes):
    return JSpec(shape, axes), ParamSpec(shape, axes)


def _same(port, jax_spec):
    assert isinstance(port, shd.PartitionSpec)
    assert tuple(port) == tuple(jax_spec), (port, jax_spec)


# --------------------------------------------------------------------------- #
# the ten cases of tests/test_sharding.py
# --------------------------------------------------------------------------- #
JM, TM = _meshes("16x16")
JM3, TM3 = _meshes("2x16x16")


def test_dense_qkv_specs():
    for shape, axes in (((6144, 48, 128), ("embed", "heads", "head_dim")),
                        ((6144, 1, 128), ("embed", "kv_heads", "head_dim"))):
        j, t = _pair(shape, axes)
        _same(shd.spec_for(t, TM), jshd.spec_for(j, JM))
    assert tuple(shd.spec_for(ParamSpec((6144, 1, 128), (
        "embed", "kv_heads", "head_dim")), TM)) == ("data", None, None)


def test_embed_vocab_spec():
    for shape in ((49152, 6144), (49155, 6144)):
        j, t = _pair(shape, ("vocab", "embed"))
        _same(shd.spec_for(t, TM), jshd.spec_for(j, JM))
    assert tuple(shd.spec_for(ParamSpec((49155, 6144), ("vocab", "embed")),
                              TM)) == (None, "data")


def test_moe_expert_sharding_modes():
    for shape in ((64, 2048, 1408), (8, 6144, 16384)):
        j, t = _pair(shape, ("experts", "embed", "mlp"))
        _same(shd.spec_for(t, TM), jshd.spec_for(j, JM))


def test_no_mesh_axis_used_twice():
    j, t = _pair((64, 64), ("vocab", "heads"))
    spec = shd.spec_for(t, TM)
    _same(spec, jshd.spec_for(j, JM))
    flat = [a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))]
    assert len(flat) == len(set(flat))


def test_teacher_rules_drop_fsdp():
    t = shd.rules_for(tcfgs.get_config("granite-3-8b"), TM, teacher=True)
    j = jshd.rules_for(jcfgs.get_config("granite-3-8b"), JM, teacher=True)
    assert "embed" not in t and t == j


def test_zero_extension():
    j, t = _pair((4096, 32, 128), ("embed", "heads", "head_dim"))
    z = shd.zero_extend(t, shd.spec_for(t, TM3), TM3)
    _same(z, jshd.zero_extend(j, jshd.spec_for(j, JM3), JM3))
    assert "pod" in [a for e in z if e is not None
                     for a in (e if isinstance(e, tuple) else (e,))]


@pytest.mark.parametrize("name", ["qwen2.5-32b", "granite-20b",
                                  "whisper-small", "mamba2-130m"])
@pytest.mark.parametrize("tp", [1, 2, 16, 24])
def test_head_pad_for(name, tp):
    assert shd.head_pad_for(tcfgs.get_config(name), tp) == \
        jshd.head_pad_for(jcfgs.get_config(name), tp)


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("b,s", [(256, 4096), (1, 524288), (3, 5), (2, 7)])
def test_batch_spec_fallbacks(key, b, s):
    jm, tm = _meshes(key)
    _same(shd.batch_spec(tm, b, s), jshd.batch_spec(jm, b, s))
    _same(shd.dp_sharding(tm, 3), jshd.dp_sharding(jm, 3).spec)
    _same(shd.logits_sharding(tm, b, 64000),
          jshd.logits_sharding(jm, b, 64000).spec)


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("shape", [(128, 32768, 16, 128),
                                   (128, 32768, 1, 128), (3, 100, 6, 64)])
def test_kv_cache_spec_fallbacks(key, shape):
    jm, tm = _meshes(key)
    _same(shd.kv_cache_spec(tm, shape), jshd.kv_cache_spec(jm, shape))


def test_param_shardings_tree():
    cfg_t, cfg_j = tcfgs.get_config("granite-3-8b"), \
        jcfgs.get_config("granite-3-8b")
    tree = shd.param_shardings(model_specs(cfg_t), TM)
    want = jshd.param_shardings(jbuild(cfg_j).specs(), JM)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(tcm.tree_leaves(tree))
    for path, sharding in flat:
        node = tree
        for k in path:
            node = node[k.key]
        _same(node, sharding.spec)


# --------------------------------------------------------------------------- #
# every leaf of every config
# --------------------------------------------------------------------------- #
def _leaves_with_path(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JSpec))[0]


@pytest.mark.parametrize("name", jcfgs.ARCH_NAMES)
@pytest.mark.parametrize("key", list(MESHES))
def test_every_leaf_of_every_config(name, key):
    jm, tm = _meshes(key)
    cfg_j, cfg_t = jcfgs.get_config(name), tcfgs.get_config(name)
    jspecs, tspecs = jbuild(cfg_j).specs(), model_specs(cfg_t)
    rules = {teacher: (jshd.rules_for(cfg_j, jm, teacher=teacher),
                       shd.rules_for(cfg_t, tm, teacher=teacher))
             for teacher in (False, True)}
    for teacher, (jr, tr) in rules.items():
        assert tr == jr, (teacher, tr, jr)
    leaves = _leaves_with_path(jspecs)
    assert len(leaves) == len(tcm.tree_leaves(tspecs))
    for path, js in leaves:
        ts = tspecs
        for k in path:
            ts = ts[k.key]
        assert (tuple(ts.shape), tuple(ts.axes)) == (tuple(js.shape),
                                                     tuple(js.axes)), path
        for jr, tr in rules.values():
            base_t, base_j = shd.spec_for(ts, tm, tr), jshd.spec_for(js, jm,
                                                                      jr)
            _same(base_t, base_j)
            _same(shd.zero_extend(ts, base_t, tm),
                  jshd.zero_extend(js, base_j, jm))


def test_opt_state_shardings_tree():
    cfg = tcfgs.get_config("qwen1.5-0.5b")
    specs = model_specs(cfg)
    for zero in (True, False):
        o = shd.opt_state_shardings(specs, TM3, zero=zero)
        assert isinstance(o, AdamWState) and tuple(o.step) == ()
        want = jshd.opt_state_shardings(
            jbuild(jcfgs.get_config("qwen1.5-0.5b")).specs(), JM3, zero=zero)
        for path, s in jax.tree_util.tree_flatten_with_path(want.master)[0]:
            node = o.master
            for k in path:
                node = node[k.key]
            _same(node, s.spec)


@pytest.mark.parametrize("key", list(MESHES))
def test_data_and_cache_shardings(key):
    jm, tm = _meshes(key)
    batch = {"tokens": (32, 4096), "labels": (3, 4096), "odd": (3, 5),
             "patches": (32, 1024, 588)}
    want = jshd.data_shardings(jm, {k: jax.ShapeDtypeStruct(v, jnp.int32)
                                    for k, v in batch.items()})
    got = shd.data_shardings(tm, batch)
    for k in batch:
        _same(got[k], want[k].spec)
    cache = {"attn": {"k": (4, 128, 32768, 8, 128), "v": (128, 32768, 1,
                                                         128)},
             "mamba": {"conv": (4, 128, 3, 4096), "ssm": (128, 64, 64, 128)}}
    want = jshd.cache_shardings(jm, jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s, jnp.float32), cache,
        is_leaf=lambda x: isinstance(x, tuple)))
    got = shd.cache_shardings(tm, cache)
    for grp in cache:
        for k in cache[grp]:
            _same(got[grp][k], want[grp][k].spec)


def test_partition_spec_normalises_like_jax():
    for entries in ((("data",), None), ((), "model"),
                    (("pod", "data"), None, "model")):
        assert tuple(shd.P(*entries)) == tuple(JP(*entries))


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #
def test_shard_blocks_split_major_to_minor():
    """A dim over (data, model) splits data-major, as JAX lays it out; the
    blocks of every coordinate tile the tensor."""
    sizes = {"data": 2, "model": 3}
    x = torch.arange(12 * 5).reshape(12, 5)
    spec = shd.P(("data", "model"), None)
    blocks = {}
    for d in range(2):
        for m in range(3):
            blocks[d, m] = shd.shard(x, spec, sizes, {"data": d, "model": m})
            assert torch.equal(blocks[d, m], x[2 * (3 * d + m):
                                               2 * (3 * d + m) + 2])
    spec2 = shd.P("model", "data")
    with pytest.raises(ValueError, match="does not split"):
        shd.shard(x, spec2, sizes, {"data": 0, "model": 0})


def test_counted_here_needs_coordinate_zero_on_replicated_axes():
    class Mesh:
        mesh_dim_names = ("data", "model")

        def __init__(self, coord):
            self.coord = coord

        def get_coordinate(self):
            return self.coord

    assert shd.counted_here(shd.P("data", None), Mesh((1, 0)))
    assert not shd.counted_here(shd.P("data", None), Mesh((1, 1)))
    assert not shd.counted_here(shd.P(None, None), Mesh((1, 0)))


# --------------------------------------------------------------------------- #
# head padding is numerics-neutral
# --------------------------------------------------------------------------- #
def test_head_pad_is_numerics_neutral():
    """tests/test_equivalence.py's case on the port: the loss and every
    gradient equal bit for bit with and without 2 padded heads, and the
    loss equal to the JAX model's within float32 tolerance."""
    jcfg = jcfgs.get_reduced("qwen2.5-32b").replace(dtype="float32")
    cfg0 = tcfgs.get_reduced("qwen2.5-32b").replace(dtype="float32")
    cfg1 = cfg0.replace(head_pad=2)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                     jparams)
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 32)),
         "labels": rng.integers(0, jcfg.vocab_size, (2, 32)),
         "loss_mask": np.ones((2, 32), np.float32)}
    out = []
    for cfg in (cfg0, cfg1):
        tm = tbuild(cfg, params_from_numpy(np_tree, device="cpu"),
                    device="cpu")
        params = tm.param_tree()
        loss, _ = tm.loss({k: torch.from_numpy(v) for k, v in b.items()})
        out.append((loss, torch.autograd.grad(loss,
                                              tcm.tree_leaves(params))))
    assert float(out[0][0].detach()) == float(out[1][0].detach())
    assert max(float((a - c).abs().max())
               for a, c in zip(out[0][1], out[1][1])) == 0.0
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else v.dtype)
          for k, v in b.items()}
    jloss, _ = jbuild(jcfg.replace(head_pad=2)).loss(
        jax.tree_util.tree_map(jnp.asarray, np_tree), jb)
    np.testing.assert_allclose(float(out[1][0].detach()), float(jloss),
                               rtol=2e-4,
                               atol=2e-4)
