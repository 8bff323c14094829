"""Import hygiene and dispatch of the PyTorch port.

The port (``src/repro_torch``), ``chip_smoke.py``, the port's
multi-rank drivers (``tests/torch_drivers``) and its examples
(``examples/*_torch.py``) import neither JAX nor
anything of the JAX package ``repro``; CPU tensors reach the plain version
and never the CUDA kernel's wrapper.
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


COMPOUND_SLICE = ["repro_torch.core.graph", "repro_torch.core.simulator",
                  "repro_torch.core.scheduler", "repro_torch.core.cost_model",
                  "repro_torch.configs.compound", "repro_torch.analysis.core",
                  "repro_torch.analysis.deadlock",
                  "repro_torch.core.messages", "repro_torch.core.runtime",
                  "repro_torch.core.executor", "repro_torch.core.workload",
                  "repro_torch.distill.workload",
                  "repro_torch.distill.multi_teacher"]


MLLM_SLICE = ["repro_torch.models.vlm", "repro_torch.mllm",
              "repro_torch.mllm.workload", "repro_torch.models.attention",
              "repro_torch.models.transformer", "repro_torch.models.model",
              "repro_torch.data.synthetic", "repro_torch.core.graph",
              "repro_torch.configs.compound"]


MOE_SLICE = ["repro_torch.models.moe", "repro_torch.models.transformer",
             "repro_torch.models.model", "repro_torch.launch.serve",
             "repro_torch.launch.train"]


ENCDEC_SLICE = ["repro_torch.models.encdec", "repro_torch.models.attention",
                "repro_torch.models.model", "repro_torch.data.synthetic",
                "repro_torch.launch.serve"]


RESUME_SLICE = ["repro_torch.checkpoint", "repro_torch.checkpoint.checkpointer",
                "repro_torch.train.loop", "repro_torch.launch.train",
                "repro_torch.core.cost_model", "repro_torch.core.planner",
                "repro_torch.analysis", "repro_torch.analysis.affinity",
                "repro_torch.analysis.donation",
                "repro_torch.analysis.__main__", "repro_torch.core.executor",
                "repro_torch.core.runtime", "repro_torch.core.workload"]


DP_SLICE = ["repro_torch.dist", "repro_torch.dist.sharding",
            "repro_torch.optim.compression", "repro_torch.optim.adamw",
            "repro_torch.train.step", "repro_torch.train.loop",
            "repro_torch.checkpoint.checkpointer", "repro_torch.launch.train",
            "repro_torch.models.model"]

CP_SLICE = ["repro_torch.dist.context", "repro_torch.roofline",
            "repro_torch.roofline.analysis", "repro_torch.train.step",
            "repro_torch.core.workload", "repro_torch.models.attention"]

SERVING_SLICE = ["repro_torch.launch.dryrun", "repro_torch.launch.mesh",
                 "repro_torch.roofline.record",
                 "repro_torch.roofline.analysis",
                 "repro_torch.roofline.report",
                 "repro_torch.analysis.hlo_gates", "repro_torch.train.step",
                 "repro_torch.models.model", "repro_torch.optim.adamw"]

COMPOUND_DRYRUN_SLICE = ["repro_torch.launch.dryrun_compound",
                         "repro_torch.launch.dryrun",
                         "repro_torch.distill.workload",
                         "repro_torch.distill.multi_teacher",
                         "repro_torch.mllm.workload",
                         "repro_torch.train.step",
                         "repro_torch.dist.pipeline"]

DRIVERS = ROOT / "tests" / "torch_drivers"


def test_module_list_covers_the_compound_dryrun_slice():
    """The compound dry-run and the colocated steps' driver are among the
    modules and drivers the import checks below load."""
    assert set(COMPOUND_DRYRUN_SLICE) <= set(_modules())
    assert (DRIVERS / "driver_colocated.py").exists()


def test_module_list_covers_the_serving_and_dryrun_slice():
    assert set(SERVING_SLICE) <= set(_modules())
    assert {p.name for p in (PKG / "analysis" / "gates").glob("*.json")} \
        == {p.name for p in (ROOT / "src" / "repro" / "analysis" / "gates")
            .glob("*.json")}


def test_module_list_covers_the_cp_slice_and_its_examples():
    assert set(CP_SLICE) <= set(_modules())
    examples = {p.name for p in (ROOT / "examples").glob("*_torch.py")}
    assert {"multi_teacher_distillation_torch.py",
            "vlm_training_torch.py"} <= examples


def test_module_list_covers_the_dp_slice():
    assert set(DP_SLICE) <= set(_modules())


def test_module_list_covers_the_training_slice():
    assert set(TRAINING_SLICE) <= set(_modules())


def test_module_list_covers_the_mamba_slice():
    assert set(MAMBA_SLICE) <= set(_modules())


def test_module_list_covers_the_compound_runtime_slice():
    assert set(COMPOUND_SLICE) <= set(_modules())


def test_module_list_covers_the_mllm_slice():
    assert set(MLLM_SLICE) <= set(_modules())


def test_module_list_covers_the_moe_slice():
    assert set(MOE_SLICE) <= set(_modules())


def test_module_list_covers_the_encdec_slice():
    assert set(ENCDEC_SLICE) <= set(_modules())


def test_module_list_covers_the_resume_slice():
    assert set(RESUME_SLICE) <= set(_modules())


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
                         + [ROOT / "chip_smoke.py"]
                         + sorted(DRIVERS.glob("*.py"))
                         + sorted((ROOT / "examples").glob("*_torch.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    assert _FORBIDDEN.search(path.read_text()) is None


def test_the_port_drivers_import_no_jax_and_no_repro():
    """Each multi-rank driver, imported in a fresh process (its ``__main__``
    block does not run), leaves ``jax`` and ``repro`` out of
    ``sys.modules``."""
    names = sorted(p.stem for p in DRIVERS.glob("*.py"))
    assert {"dist_util", "driver_dp", "driver_compression",
            "driver_elastic", "driver_sections",
            "driver_context", "driver_colocated"} <= set(names)
    code = (
        "import importlib, json, sys\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(DRIVERS), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


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
    """The kernel's wrapper refuses CPU tensors; segment ids on CPU tensors
    take the plain version's segment mask (ROADMAP.md, C4), and on CUDA
    tensors ``ops`` raises (``chip_smoke.py`` checks that on the card)."""
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q, q, q)
    seg = torch.zeros(1, 8, dtype=torch.int32)
    before = fa.flash_fwd.launches
    o = ops.flash_attention(q, q, q, segment_q=seg, segment_kv=seg)
    assert torch.equal(o, ref.flash_attention_ref(
        q, q, q, segment_q=seg, segment_kv=seg)[0])
    assert fa.flash_fwd.launches == before
