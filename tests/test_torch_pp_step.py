"""The train step's pipeline regime (``build_train_step(..., mesh=)`` on a
mesh whose ``pipe`` axis is above 1) against the JAX package's
``build_train_step`` on ``section_mesh``, on the CPU, and the refusals
that stay.

Two cases on gloo ranks (``tests/torch_drivers/driver_pipeline.py
pp_step``), one step each from the same parameters and global batch (8 x
16, a loss mask with about a fifth of its tokens off):
``tests/drivers/driver_train_step_dist.py``'s pp2 step, granite-3-8b
reduced to 4 layers at ``ParallelConfig(dp=2, pp=2, mbs=2)``, and its
pp2tp2 step at ``(dp=2, pp=2, tp=2, mbs=2)`` (Megatron TP inside each
stage).  The JAX step runs on an 8-virtual-device host in a subprocess
while the ranks run (``python tests/test_torch_pp_step.py --jax-oracle
IN.npz OUT.npz 0 1``), with the driver's AdamW and tolerances: loss within
1e-5, grad norm within 1e-3, every parameter within 1e-4.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import repro_torch.configs as tcfgs  # noqa: E402
import torch_step_util as su  # noqa: E402
from repro_torch.core.types import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

CASES = su.dpl.PP_STEP_CASES


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    return su.run("pp_step", CASES, CASES, __file__,
                  tmp_path_factory.mktemp("ppstep"))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_pp_step_matches_jax_section_mesh_step(step_run, name):
    got, jx = step_run
    g = su.gaps(got, jx, name, name)
    assert su.within(g), g


def _mesh(**sizes):
    base = {"data": 1, "pipe": 1, "seq": 1, "model": 1}
    base.update(sizes)
    return base


def _build(arch, par, mesh, **over):
    cfg = tcfgs.get_reduced(arch).replace(dtype="float32", **over)
    return tstep.build_train_step(tbuild(cfg, device="cpu"), par,
                                  ShapeConfig("t", "train", 8, 8), mesh=mesh)


@pytest.mark.parametrize("arch,par,mesh,exc,match", [
    ("granite-3-8b", ParallelConfig(pp=2, cp=2), _mesh(pipe=2, seq=2),
     NotImplementedError, "pp x cp composition is not supported"),
    ("whisper-small", ParallelConfig(pp=2), _mesh(pipe=2),
     NotImplementedError, "encoder-decoder"),
    ("granite-3-8b", ParallelConfig(pp=2), _mesh(pipe=2),
     ValueError, "3 layer groups do not divide 2 pipeline stages"),
    ("granite-3-8b", ParallelConfig(pp=2, grad_compress="bf16"),
     _mesh(pipe=2), NotImplementedError, "dp-only mesh"),
    ("granite-3-8b", ParallelConfig(tp=2, grad_compress="int8"),
     _mesh(model=2), NotImplementedError, "dp-only mesh"),
])
def test_pp_step_refusals(arch, par, mesh, exc, match):
    over = dict(num_layers=3) if "layer groups" in match else {}
    with pytest.raises(exc, match=match):
        _build(arch, par, mesh, **over)


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    su.jax_steps(CASES[int(sys.argv[4])::int(sys.argv[5])], sys.argv[2],
                 sys.argv[3])
