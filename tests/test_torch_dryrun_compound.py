"""The port's compound dry-run (``repro_torch.launch.dryrun_compound``)
against the JAX package's (``repro.launch.dryrun_compound``) on the tiny
cells (``REPRO_DRYRUN_TINY``, ``REPRO_DRYRUN_DEVICES=8``,
``REPRO_DRYRUN_MESH=4,2``), on the CPU.

Each side runs in a subprocess of its own, side by side: the port's three
workloads as rank 0 of a fake process group of 8 ranks, which becomes that
process's default group; the JAX runners with 8 virtual devices and
``jax.make_mesh`` defaulting to Auto axes (set before ``repro`` is
imported; with Explicit axes the reference's distill and mllm runners
fail, ROADMAP C0).  Checks:

* ``workload``, ``n_microbatches``, ``mbs``, ``image_tokens``,
  ``vit_patches`` and ``model_flops`` are equal, and so are the file names;
* the per-device FLOPs are within 25 % of the JAX ``hlo.flops_per_device``
  (each ratio printed);
* ``argument_size_in_bytes`` differs by exactly the leaves
  :func:`_named_difference` names: both sides' steps take this device's
  block of the batch, the port's with int64 tokens, labels, image
  positions and indices where the reference's are int32, its step index is a
  Python int where the reference's distillation step takes an int32 (the
  MLLM and multi-teacher steps' constant schedule leaves it unused, and
  XLA drops it), and the multi-teacher step takes the teachers' whole
  trees, whose output-layer blocks it never reads (XLA drops them; the
  step reads ``w_a``/``w_b``);
* the KL kernel's op ``repro_torch::distill_kl_fwd`` is among the
  distill and multi-teacher records' ops (once a micro-batch and KL term),
  and so is its backward's, ``::distill_kl_bwd``, as often and with twice
  the forward's FLOPs (its flop formula at Ds = Dt); flash's among all
  three;
* ``--cp 2`` on a mesh whose model axis is 2 records the distillation
  step at cp x tp (each model rank's heads under ``cp_attention`` over
  its sequence group), and an MLLM batch that is not a multiple of
  ``--mbs`` raises the reference's ``ValueError``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FLOPS_REL = 0.25
WORKLOADS = ("distill", "mllm", "multi_teacher")
EQUAL = ("workload", "n_microbatches", "mbs", "image_tokens", "vit_patches",
         "model_flops")
DP, TP = 4, 2


def _args(workload: str, out: str, **kw):
    import argparse
    a = dict(workload=workload, teacher="granite-3-8b",
             student="granite-3-8b", arch="pixtral-12b", seq=4096,
             batch=256, mbs=None, cp=1, teacher2="granite-3-8b", out=out)
    a.update(kw)
    return argparse.Namespace(**a)


def _run(side: str, out: str) -> None:
    """Every workload's tiny cell on one side, records to ``out``."""
    os.environ.update(REPRO_DRYRUN_TINY="1", REPRO_DRYRUN_DEVICES="8",
                      REPRO_DRYRUN_MESH=f"{DP},{TP}")
    rec_dir = Path(out).parent / side
    if side == "jax":
        import jax
        from jax.sharding import AxisType
        make = jax.make_mesh
        jax.make_mesh = lambda shape, axes, **kw: make(
            shape, axes, **{"axis_types": (AxisType.Auto,) * len(axes),
                            **kw})
        from repro.launch import dryrun_compound as dc
    else:
        from repro_torch.launch import dryrun_compound as dc
    for w in WORKLOADS:
        if side == "jax":
            dc.WORKLOADS[w](_args(w, str(rec_dir)))
        else:
            dc.main(["--workload", w, "--out", str(rec_dir)])
    recs = {p.name: json.loads(p.read_text())
            for p in sorted(rec_dir.glob("*.json"))}
    if side == "torch":
        refused = {}
        for name, kw in (("cp2", dict(workload="distill", cp=2)),
                         ("mbs3", dict(workload="mllm", mbs=3))):
            try:
                dc.main(["--workload", kw.pop("workload"), "--out",
                         str(rec_dir / name)]
                        + [x for k, v in kw.items()
                           for x in (f"--{k}", str(v))])
                refused[name] = None
            except (NotImplementedError, ValueError) as e:
                refused[name] = [type(e).__name__, str(e)]
        recs["refused"] = refused
        recs["cp2"] = [json.loads(p.read_text())
                       for p in sorted((rec_dir / "cp2").glob("*.json"))]
    Path(out).write_text(json.dumps(recs))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_compound")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {side: subprocess.Popen(
        [sys.executable, __file__, side, str(tmp / f"{side}.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for side in ("torch", "jax")}
    out = {}
    for side, p in procs.items():
        so, se = p.communicate(timeout=420)
        assert p.returncode == 0, so[-3000:] + se[-6000:]
        out[side] = json.loads((tmp / f"{side}.json").read_text())
    return out["torch"], out["jax"]


def _named_difference(workload: str) -> int:
    """Port argument bytes minus the reference's, from the leaves that
    differ (see the module docstring)."""
    from repro_torch.configs import get_config, reduce_config
    B, S, mbs = 8, 128, 8
    n_mb = B // mbs
    if workload == "distill":
        # this device's block (int64 tokens, labels; f32 mask) against the
        # same block (int32) and an int32 step index
        return B // DP * S * (8 + 8 + 4) - (B // DP * S * (4 + 4 + 4) + 4)
    rows, local = n_mb * mbs, n_mb * mbs // DP
    lm = local * S * (8 + 8 + 4) - local * S * (4 + 4 + 4)
    if workload == "mllm":
        K = 8
        return (lm + local * K * (8 + 4) - local * K * (4 + 4)
                + rows * (8 - 4))                 # vis_idx int64, replicated
    cfg = reduce_config(get_config("granite-3-8b"))
    unembed = cfg.d_model * cfg.padded_vocab // TP * 2    # bf16 block
    return lm + rows * (8 - 4) + 2 * unembed             # b_idx; teachers


def _rec(records, side, workload):
    recs = records[0] if side == "torch" else records[1]
    [name] = [n for n in recs if n.startswith(f"compound_{workload}__")]
    return name, recs[name]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_compound_cell_matches_jax(records, workload):
    name, p = _rec(records, "torch", workload)
    ref_name, r = _rec(records, "jax", workload)
    assert name == ref_name
    for k in EQUAL:
        assert p.get(k) == r.get(k), (k, p.get(k), r.get(k))
    pa = p["memory"]["argument_size_in_bytes"]
    ra = r["memory"]["argument_size_in_bytes"]
    diff = _named_difference(workload)
    print(f"{workload}: argument bytes port {pa}, JAX {ra}, named "
          f"difference {diff}; parts {p['memory']['argument_parts']}")
    assert pa - ra == diff, (pa, ra, diff)
    ratio = p["hlo"]["flops_per_device"] / r["hlo"]["flops_per_device"]
    print(f"{workload}: FLOPs per device port "
          f"{p['hlo']['flops_per_device']:.4g}, JAX "
          f"{r['hlo']['flops_per_device']:.4g}, ratio {ratio:.3f}; useful "
          f"{p['useful_flops_ratio']:.3f} (JAX {r['useful_flops_ratio']:.3f})")
    assert abs(ratio - 1) <= FLOPS_REL, ratio
    assert p["memory"]["peak_bytes"] >= pa
    assert p["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert p["hlo"]["collective_bytes_per_device"]
    assert p["record_s"] > 0 and "compile_s" not in p


@pytest.mark.parametrize("workload,kl", [("distill", 2), ("mllm", 0),
                                         ("multi_teacher", 2)])
def test_kernel_ops_on_the_path(records, workload, kl):
    """distill: one KL a micro-batch (2 micro-batches of 1 row a data
    rank); multi-teacher: KL_a and KL_b of its one microbatch; the MLLM
    step has no KL.  Flash runs in every cell."""
    _, p = _rec(records, "torch", workload)
    ops = p["hlo"]["kernel_ops"]
    print(workload, ops)
    assert ops.get("repro_torch.distill_kl_fwd", 0) == kl
    assert ops.get("repro_torch.flash_fwd", 0) > 0


@pytest.mark.parametrize("workload,kl", [("distill", 2), ("mllm", 0),
                                         ("multi_teacher", 2)])
def test_kl_backward_op_on_the_path(records, workload, kl):
    """The KL's backward kernel op ``repro_torch::distill_kl_bwd`` runs
    once for each forward (the student's gradients; the teachers are
    detached), with its flop formula's count: 2 N V (Ds + Dt) + 4 N V Ds,
    twice the forward's where Ds = Dt (granite-3-8b on both sides)."""
    _, p = _rec(records, "torch", workload)
    ops, flops = p["hlo"]["kernel_ops"], p["hlo"]["kernel_flops"]
    assert ops.get("repro_torch.distill_kl_bwd", 0) == kl
    if kl:
        fwd = flops["repro_torch.distill_kl_fwd"]
        assert fwd > 0
        assert flops["repro_torch.distill_kl_bwd"] == 2 * fwd


def test_cp_with_a_model_axis_is_refused(records):
    # cp x tp records (it was refused until KV-head repetition and cp x
    # tp were ported); the bad micro-batch count is still refused
    refused = records[0]["refused"]
    assert refused["cp2"] is None
    [rec] = records[0]["cp2"]
    assert rec["hlo"]["flops_per_device"] > 0
    assert rec["hlo"]["kernel_ops"].get("repro_torch.flash_fwd", 0) > 0
    # one KL a micro-batch: 4 of one row on each of the 2 data ranks left
    assert rec["hlo"]["kernel_ops"].get("repro_torch.distill_kl_fwd") == 4
    assert refused["mbs3"] == [
        "ValueError", "--batch 8 is not a multiple of mbs=3: the "
        "microbatched step would lower for a different sample count than "
        "the reported model_flops"]


if __name__ == "__main__":
    _run(sys.argv[1], sys.argv[2])
