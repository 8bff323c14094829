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
  sliced), granite-20b reduced (one KV head: attention whole; a GELU MLP),
  mixtral reduced to 2 layers (the expert ``mlp`` dim sliced, router and
  gates whole);
* dp 2: mixtral reduced (2 layers) and jamba reduced (MoE every other
  layer among Mamba mixers).  The oracle is the JAX step at the same
  ``ParallelConfig``: the reference's aux is taken per micro-batch over
  that micro-batch's global rows, so a one-device step at another ``mbs``
  differs (8.97e-4 in the loss for mixtral);
* ``g_d2t2_planted``: granite at (dp 2, tp 2) with every gradient the
  model axis does not split summed over ``model`` as well (doubled), held
  to ``g_d2t2``'s oracle: it must miss the bounds.

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
                  tmp_path_factory.mktemp("tpstep"), parts=2)


@pytest.mark.parametrize("name", [c[0] for c in ORACLE])
def test_tp_and_router_stats_step_matches_jax_step(step_run, name):
    got, jx = step_run
    g = su.gaps(got, jx, name, name)
    assert su.within(g), g


def test_gradient_summed_over_model_misses_the_bounds(step_run):
    got, jx = step_run
    g = su.gaps(got, jx, "g_d2t2_planted", "g_d2t2")
    assert not su.within(g), g


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    su.jax_steps(ORACLE[int(sys.argv[4])::int(sys.argv[5])], sys.argv[2],
                 sys.argv[3])
