"""Import hygiene and dispatch of the PyTorch port.

The port (``src/repro_torch``) and ``chip_smoke.py`` import neither JAX
nor anything of the JAX package ``repro``; CPU tensors reach the plain
version and never the CUDA kernel's wrapper.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(PKG.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


TRAINING_SLICE = ["repro_torch.kernels.distill_kl",
                  "repro_torch.optim.adamw", "repro_torch.optim.schedules",
                  "repro_torch.data.synthetic", "repro_torch.train.step",
                  "repro_torch.train.loop", "repro_torch.distill.workload",
                  "repro_torch.launch.train"]


MAMBA_SLICE = ["repro_torch.kernels.ssd_scan", "repro_torch.models.mamba"]


def test_module_list_covers_the_training_slice():
    assert set(TRAINING_SLICE) <= set(_modules())


def test_module_list_covers_the_mamba_slice():
    assert set(MAMBA_SLICE) <= set(_modules())


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import importlib, json, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\.|"
                        r"import repro\s*$|from repro\.|from repro import)",
                        re.MULTILINE)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    assert _FORBIDDEN.search(path.read_text()) is None


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((1, 40, 4, 16), (1, 40, 2, 16), (1, 40, 2, 16)))
    before = fa.flash_fwd.launches
    o = ops.flash_attention(q, k, v, causal=True, window=8)
    o_lse, lse = ops.flash_attention_lse(q, k, v, causal=True, window=8)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, causal=True, window=8)
    assert torch.equal(o, o_ref) and torch.equal(o_lse, o_ref)
    assert torch.equal(lse, lse_ref)
    assert fa.flash_fwd.launches == before


def test_kernel_wrapper_refuses_cpu_tensors_and_segments():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q, q, q)
    seg = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.flash_attention(q, q, q, segment_q=seg, segment_kv=seg)
