"""The train step's plain regime with Megatron tensor parallelism
(``build_train_step(..., mesh=)`` on a ``model`` axis above 1), and the
MoE and hybrid families on more than one data rank (their router
statistics averaged over the data ranks before the aux is formed),
against the JAX package's ``build_train_step`` at the **same**
``ParallelConfig`` on ``section_mesh``, on the CPU.

Cases (``tests/torch_drivers/driver_pipeline.py tp_step``), one step each
from the same parameters and global batch (8 x 16, a loss mask with about
a fifth of its tokens off), at ``mbs=2``:

* (dp 2, tp 2): granite-3-8b reduced to 4 layers (attention and MLP
  sliced), granite-20b reduced (one KV head, repeated on both model
  ranks; a GELU MLP), mixtral reduced to 2 layers (the expert ``mlp`` dim
  sliced, router and gates whole);
* (dp 2, tp 4): granite-3-8b reduced to 4 layers, its 2 KV heads each
  repeated over the 2 model ranks of its query-head group;
* dp 2: mixtral reduced (2 layers) and jamba reduced (MoE every other
  layer among Mamba mixers).  The oracle is the JAX step at the same
  ``ParallelConfig``: the reference's aux is taken per micro-batch over
  that micro-batch's global rows, so a one-device step at another ``mbs``
  differs (8.97e-4 in the loss for mixtral);
* ``g_d2t2_planted``: granite at (dp 2, tp 2) with every gradient the
  model axis does not split summed over ``model`` as well (doubled), held
  to ``g_d2t2``'s oracle: it must miss the bounds;
* ``g_d2t4_planted``: granite at (dp 2, tp 4) with each repeated KV
  head's gradient taken from one of its 2 copies instead of their sum,
  held to ``g_d2t4``'s oracle: it must miss the bounds too.

Without ranks: a model rank's blocks at tp > KV hold ``H / tp`` query
heads and one KV head (``dist.pipeline.tp_rank_blocks``), and the ranks'
partial attention outputs and ``wk``/``wv`` gradients sum to the whole
sub-layer's.

Bounds: ``tests/drivers/driver_train_step_dist.py``'s, loss within 1e-5,
grad norm within 1e-3, every parameter within 1e-4.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import pytest  # noqa: E402

pytest.importorskip("torch")

import torch_step_util as su  # noqa: E402

CASES = su.dpl.TP_STEP_CASES
ORACLE = [c for c in CASES if not c[0].endswith("_planted")]


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    return su.run("tp_step", CASES, ORACLE, __file__,
                  tmp_path_factory.mktemp("tpstep"), parts=3)


@pytest.mark.parametrize("name", [c[0] for c in ORACLE])
def test_tp_and_router_stats_step_matches_jax_step(step_run, name):
    got, jx = step_run
    g = su.gaps(got, jx, name, name)
    assert su.within(g), g


def test_gradient_summed_over_model_misses_the_bounds(step_run):
    got, jx = step_run
    g = su.gaps(got, jx, "g_d2t2_planted", "g_d2t2")
    assert not su.within(g), g


def test_repeated_kv_gradient_from_one_copy_misses_the_bounds(step_run):
    got, jx = step_run
    g = su.gaps(got, jx, "g_d2t4_planted", "g_d2t4")
    assert not su.within(g), g


def test_rank_blocks_hold_their_heads_and_sum_to_the_sublayer():
    """At tp > KV each model rank's attention blocks hold ``H / tp`` query
    heads and the one KV head of their group, ``r // (tp / KV)``; the
    ranks' partial outputs (the row-parallel all-reduce) and their
    ``wk``/``wv`` gradients folded over each head's copies equal the whole
    sub-layer's."""
    import torch
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.dist import pipeline as pl
    from repro_torch.dist import sharding as shd
    from repro_torch.models import attention as att
    from repro_torch.models import common as cm

    cfg = get_config("granite-3-8b")              # H 32, KV 8, hd 128
    specs = att.attn_specs(cfg)
    meta = {k: torch.empty(s.shape, device="meta") for k, s in specs.items()}
    for r in (0, 7, 15):
        b = pl.tp_rank_blocks(cfg, meta, specs, 16, r)
        assert tuple(b["wq"].shape) == (4096, 2, 128)
        assert tuple(b["wk"].shape) == tuple(b["wv"].shape) == (4096, 1, 128)
        assert tuple(b["wo"].shape) == (2, 128, 4096)

    cfg = get_reduced("granite-3-8b").replace(dtype="float32")
    tp, rep = 4, 2                                # H 4, KV 2
    specs = att.attn_specs(cfg)
    p = cm.init_params(specs, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    go = torch.randn(2, 16, cfg.d_model, generator=gen)
    whole = {k: v.clone().requires_grad_() for k, v in p.items()}
    o = att.attention(whole, x, cfg)
    g_whole = torch.autograd.grad((o * go).sum(), [whole["wk"], whole["wv"]])
    parts, g_k, g_v = [], [], []
    for r in range(tp):
        b = {k: v.requires_grad_() for k, v in
             pl.tp_rank_blocks(cfg, p, specs, tp, r).items()}
        assert b["wq"].shape[1] == cfg.num_heads // tp
        assert b["wk"].shape[1] == 1
        torch.testing.assert_close(b["wk"][:, 0], p["wk"][:, r // rep])
        o_r = att.attention(b, x, cfg)
        gk, gv = torch.autograd.grad((o_r * go).sum(), [b["wk"], b["wv"]])
        parts.append(o_r.detach())
        g_k.append(gk)
        g_v.append(gv)
    torch.testing.assert_close(sum(parts), o.detach(), atol=1e-5, rtol=1e-5)
    for got, want in zip((g_k, g_v), g_whole):
        folded = shd.fold_repeats(torch.cat(got, dim=1), 1, rep)
        torch.testing.assert_close(folded, want, atol=1e-5, rtol=1e-5)


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    su.jax_steps(ORACLE[int(sys.argv[4])::int(sys.argv[5])], sys.argv[2],
                 sys.argv[3])
