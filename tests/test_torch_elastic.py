"""The port's elastic restore (``Checkpointer.restore(..., shardings=,
mesh=)``): its form of ``tests/drivers/driver_elastic_dryrun.py``'s
elastic part, which is red on this JAX (ROADMAP.md, C0).

A ZeRO state of the reduced qwen1.5-0.5b (bfloat16 parameters, float32
mu, nu and master, int32 step; one sharded step taken so that each holds
values) is saved by 4 gloo ranks (``data`` = 4) through the collective
save (``tests/torch_drivers/driver_elastic.py``), then:

* restored by 2 ranks under other specs, the optimizer state not extended
  on ``data`` = 2 and extended on ``model`` = 2, equal bit for bit to the
  full arrays once gathered (checked inside driver_elastic.py);
* restored on one device with no mesh, equal bit for bit;
* its files equal byte for byte to those a single-device save of the same
  full state writes.

The bfloat16 leaves are what the reference's restore cannot read (C8).

And the training loop under a process group
(``tests/torch_drivers/driver_loop.py``, 2 ranks): a SIGTERM on one rank
stops every rank after the same step, the collective checkpoint holds that
step, and a fresh run resumes from it on every rank, bit for bit equal to
a run that never stopped.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.common import flatten_with_path  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DRIVER = ROOT / "tests" / "torch_drivers" / "driver_elastic.py"
LOOP_DRIVER = ROOT / "tests" / "torch_drivers" / "driver_loop.py"
CFG = get_reduced("qwen1.5-0.5b")
B, S = 8, 16


def _run(*args, driver=DRIVER, name="elastic"):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(driver), *map(str, args)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert f"DRIVER_OK {name}" in proc.stdout, proc.stdout + proc.stderr


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    model = build_model(CFG, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    arrays = {f"params/{p.replace('.', '/')}": x.detach().float().numpy()
              for p, x in flatten_with_path(model.param_tree())}
    arrays.update({
        "batch/tokens": rng.integers(0, CFG.vocab_size, (B, S)),
        "batch/labels": rng.integers(0, CFG.vocab_size, (B, S)),
        "batch/loss_mask": (rng.random((B, S)) < 0.8).astype(np.float32)})
    np.savez(tmp / "in.npz", **arrays)
    ck = tmp / "ck"
    _run("save", 4, ck, tmp / "in.npz", tmp / "full.npz")
    return tmp, np.load(tmp / "full.npz")


def _target():
    """A single-device ``{"params", "opt"}`` tree of the model's shapes and
    dtypes."""
    m = build_model(CFG, device="cpu", seed=1)
    return {"params": m.param_tree(), "opt": adamw.init(m.param_tree())}


def _words(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def test_restore_on_two_ranks_under_other_specs(saved):
    tmp, _ = saved
    _run("restore", 2, tmp / "ck", tmp / "in.npz", tmp / "full.npz")


def test_restore_on_one_device_equals_the_full_arrays(saved):
    tmp, full = saved
    state = Checkpointer(tmp / "ck").restore(1, _target())
    flat = flatten_with_path(state)
    assert sorted(p for p, _ in flat) == sorted(full.files)
    assert any(x.dtype == torch.bfloat16 for _, x in flat)
    for p, x in flat:
        np.testing.assert_array_equal(_words(x), full[p], err_msg=p)
    assert int(state["opt"].step) == 1


def test_sharded_save_writes_the_single_device_files(saved):
    tmp, _ = saved
    state = Checkpointer(tmp / "ck").restore(1, _target())
    Checkpointer(tmp / "single", async_save=False).save(1, state)
    sharded = sorted((tmp / "ck" / "step_00000001").glob("*.npy"))
    single = sorted((tmp / "single" / "step_00000001").glob("*.npy"))
    assert [f.name for f in sharded] == [f.name for f in single]
    for a, b in zip(sharded, single):
        assert a.read_bytes() == b.read_bytes(), a.name
    ma = Checkpointer(tmp / "ck").manifest(1)
    mb = Checkpointer(tmp / "single").manifest(1)
    assert ma["leaves"] == mb["leaves"] and ma["step"] == mb["step"]


def test_sigterm_on_one_rank_saves_collectively_and_resumes(tmp_path):
    _run(2, tmp_path, driver=LOOP_DRIVER, name="loop")
