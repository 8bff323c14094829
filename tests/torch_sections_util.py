"""Helpers of the section-mesh tests (``tests/test_torch_sections*.py``):
run ``tests/torch_drivers/driver_sections.py`` on spawned gloo ranks and
load what its ranks wrote."""
import glob
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DRIVERS = ROOT / "tests" / "torch_drivers"
sys.path.insert(0, str(DRIVERS))

import driver_sections  # noqa: E402,F401  (the configurations)


def start(case: str, world: int, inputs: dict, tmp: Path):
    """Start the driver's ``case`` on ``world`` ranks with ``inputs`` as
    IN.npz; returns the process and the output prefix."""
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(DRIVERS)]))
    env.pop("XLA_FLAGS", None)
    prefix = tmp / "out"
    proc = subprocess.Popen(
        [sys.executable, str(DRIVERS / "driver_sections.py"), case,
         str(world), str(tmp / "in.npz"), str(prefix)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    return proc, prefix


def finish(proc, prefix, case: str, timeout: float = 300) -> dict:
    """Wait for the driver; ``{rank: npz}`` of what each rank wrote."""
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0 and f"DRIVER_OK sections {case}" in out, \
        out[-3000:] + err[-6000:]
    return {int(f.rsplit(".", 2)[-2]): np.load(f)
            for f in glob.glob(f"{prefix}.*.npz")}


def run(case: str, world: int, inputs: dict, tmp: Path) -> dict:
    return finish(*start(case, world, inputs, tmp), case)


def tree(npz, prefix: str) -> dict:
    """The nested dict of ``prefix``-ed arrays."""
    out: dict = {}
    for key in npz.files:
        if key.startswith(prefix):
            node = out
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = np.asarray(npz[key])
    return out


def flat(t, prefix: str = "") -> dict:
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.detach().float().numpy()
                               if hasattr(v, "detach") else np.asarray(v))
    return out


def flat_tensors(t, prefix: str = "") -> dict:
    """:func:`flat` keeping the tensors as they are."""
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(flat_tensors(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out
