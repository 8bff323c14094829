"""The port's plain flash attention (``repro_torch.kernels.ref``) against
the JAX package's oracles: the naive ``mha_reference`` and the Pallas
kernel in interpret mode, over ``tests/test_kernels_flash.py``'s sweep.

The same numpy inputs (from a seed) go to both sides.  Outputs are
compared on rows with at least one visible key; on rows with none, the
port gives o = 0 and both sides give lse <= -1e29.  The CUDA kernel is
held against this plain version on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import (flash_attention,  # noqa: E402
                                           flash_attention_lse)
from repro_torch.kernels.ref import (flash_attention_ref,  # noqa: E402
                                     visible_mask)

SHAPES = [
    # B, S, T, H, KV, D
    (2, 128, 128, 4, 2, 16),      # GQA
    (1, 256, 256, 8, 8, 32),      # MHA
    (2, 128, 64, 4, 1, 16),       # MQA, cross lengths
    (1, 64, 64, 6, 3, 8),         # odd group
]
MODES = [(True, 0), (False, 0), (True, 32)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(shape, seed=0):
    B, S, T, H, KV, D = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), dtype=np.float32),
            rng.standard_normal((B, T, KV, D), dtype=np.float32),
            rng.standard_normal((B, T, KV, D), dtype=np.float32))


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _assert_close(o_port, lse_port, o_jax, lse_jax, vis, tol):
    o_port = o_port.float().numpy()
    lse_port = lse_port.numpy()
    o_jax = np.asarray(o_jax, np.float32)
    np.testing.assert_allclose(o_port[:, vis], o_jax[:, vis], atol=tol,
                               rtol=tol)
    if lse_jax is not None:
        lse_jax = np.asarray(lse_jax)
        np.testing.assert_allclose(lse_port[:, vis], lse_jax[:, vis],
                                   atol=1e-4, rtol=1e-5)
        assert np.all(lse_jax[:, ~vis] <= -1e29)
    assert np.all(o_port[:, ~vis] == 0)
    assert np.all(lse_port[:, ~vis] <= -1e29)


def _vis(shape, causal, window, q_offset=0, positions=None):
    B, S, T, H, KV, D = shape
    return visible_mask(S, T, causal=causal, window=window, q_offset=q_offset,
                        kv_positions=positions).any(dim=1).numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window", MODES)
def test_ref_matches_mha_reference(shape, dtype, causal, window):
    (jq, jk, jv), (q, k, v) = _both(_qkv(shape), dtype)
    o_jax = jref.mha_reference(jq, jk, jv, causal=causal, window=window)
    o, lse = flash_attention_ref(q, k, v, causal=causal, window=window)
    _assert_close(o, lse, o_jax, None, _vis(shape, causal, window),
                  DTYPES[dtype][2])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window", MODES)
def test_ref_matches_pallas_interpret(shape, dtype, causal, window):
    (jq, jk, jv), (q, k, v) = _both(_qkv(shape, seed=1), dtype)
    o_pl = flash_attention(jq, jk, jv, causal=causal, window=window,
                           interpret=True, block_q=64, block_kv=64)
    _, lse_pl = flash_attention_lse(jq, jk, jv, causal=causal, window=window,
                                    interpret=True, block_q=64, block_kv=64)
    o, lse = flash_attention_ref(q, k, v, causal=causal, window=window)
    _assert_close(o, lse, o_pl, lse_pl, _vis(shape, causal, window),
                  DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window", MODES)
def test_ref_kv_positions_and_q_offset(dtype, causal, window):
    """Permuted key positions with a shifted query window, as the CP path
    hands them to the kernel."""
    shape = (1, 64, 128, 4, 2, 32)
    (jq, jk, jv), (q, k, v) = _both(_qkv(shape, seed=2), dtype)
    pos = np.random.default_rng(3).permutation(128).astype(np.int32)
    kw = dict(causal=causal, window=window, q_offset=32)
    o_naive = jref.mha_reference(jq, jk, jv, kv_positions=jnp.asarray(pos),
                                 **kw)
    o_pl, lse_pl = flash_attention_lse(jq, jk, jv,
                                       kv_positions=jnp.asarray(pos),
                                       interpret=True, block_q=64,
                                       block_kv=64, **kw)
    o, lse = flash_attention_ref(q, k, v, kv_positions=torch.from_numpy(pos),
                                 **kw)
    vis = _vis(shape, causal, window, 32, torch.from_numpy(pos))
    tol = DTYPES[dtype][2]
    _assert_close(o, lse, o_naive, None, vis, tol)
    _assert_close(o, lse, o_pl, lse_pl, vis, tol)


def test_rows_without_visible_key():
    """Keys all in the causal future: o = 0 and lse <= -1e29 on every row
    (the JAX versions return a blocking-dependent o there)."""
    shape = (1, 32, 64, 2, 2, 8)
    _, (q, k, v) = _both(_qkv(shape, seed=4), "float32")
    pos = torch.arange(32, 96, dtype=torch.int32)
    o, lse = flash_attention_ref(q, k, v, causal=True, kv_positions=pos)
    assert torch.all(o == 0)
    assert torch.all(lse <= -1e29)


# --------------------------------------------------------------------------- #
# segment ids (packed sequences): the plain version's mask (ROADMAP.md, C4)
# --------------------------------------------------------------------------- #
def _segments(B, S, seed=0):
    """Per row, ascending segment ids with row-specific boundaries."""
    rng = np.random.default_rng(seed)
    out = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(1, S), 3, replace=False))
        out[b] = np.searchsorted(cuts, np.arange(S), side="right")
    return out


@pytest.mark.parametrize("seg_kind", ["thirds", "ragged"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 24)])
def test_segment_ids_match_jax_mha_reference(seg_kind, causal, window):
    """tests/test_kernels_flash.py:74's packed-sequence case (and ragged
    per-row boundaries), output and gradients."""
    import jax
    from repro_torch.kernels import ops
    B, S, H, KV, D = 2, 96, 4, 2, 16
    q, k, v = _qkv((B, S, S, H, KV, D))
    seg = (np.repeat(np.repeat(np.arange(3)[None], B, 0), S // 3, 1)
           .astype(np.int32) if seg_kind == "thirds" else _segments(B, S))
    jseg = jnp.asarray(seg)

    def f_jax(q, k, v):
        return jref.mha_reference(q, k, v, causal=causal, window=window,
                                  segment_q=jseg, segment_kv=jseg)

    jx = [jnp.asarray(a) for a in (q, k, v)]
    o_ref = f_jax(*jx)
    g_ref = jax.grad(lambda *a: jnp.sum(jnp.sin(f_jax(*a))),
                     argnums=(0, 1, 2))(*jx)
    tx = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tseg = torch.from_numpy(seg)
    o = ops.flash_attention(*tx, causal=causal, window=window,
                            segment_q=tseg, segment_kv=tseg)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref),
                               atol=2e-5, rtol=2e-5)
    g = torch.autograd.grad(torch.sin(o).sum(), tx)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)
    # the mask matters: without it the rows past the first boundary differ
    plain = ops.flash_attention(*(t.detach() for t in tx), causal=causal,
                                window=window)
    assert not torch.allclose(plain, o.detach(), atol=1e-3)


def test_segment_ids_need_both_sides():
    q = torch.zeros(1, 8, 2, 16)
    seg = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="both"):
        flash_attention_ref(q, q, q, segment_q=seg)
