"""Build-time lint entry point: ``python -m repro_torch.analysis``.
Counterpart of ``python -m repro.analysis``.

Runs the passes that need no device and no runtime — dispatch-graph
deadlock (lookahead 0 and 1, so cross-iteration FIFO coupling is
covered), spec structure via ``WorkloadSpec.validate`` and the in-place
update signature — over every registered workload spec, built from
reduced configs — and the schema check of every committed gate file
(``analysis/gates/``).  Exit status 1 on any ERROR finding.  The gates
themselves need recorded steps (``roofline.record``) and run in
``tests/test_torch_gates.py``.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import Severity, check_spec, hlo_gates, lint_spec


def build_specs(which: str = "all"):
    """name -> WorkloadSpec for every registered declarative workload,
    built shape-reduced (spec construction only: no runtime, no device)."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.types import ParallelConfig
    from repro_torch.distill.multi_teacher import multi_teacher_spec
    from repro_torch.distill.workload import distill_spec
    from repro_torch.mllm.workload import mllm_spec
    from repro_torch.models.vlm import vit_config

    par = ParallelConfig(mbs=2)
    lm = reduce_config(get_config("granite-3-8b"))
    out = {}
    if which in ("all", "distill"):
        out["distill"] = distill_spec(
            lm, lm, teacher_parallel=par, student_parallel=par)
    if which in ("all", "multi_teacher"):
        out["multi_teacher"] = multi_teacher_spec(
            lm, lm, lm, ta_parallel=par, tb_parallel=par, s_parallel=par,
            global_batch=8, seq_len=64, mbs=2)
    if which in ("all", "mllm"):
        vlm_cfg = reduce_config(get_config("pixtral-12b")).replace(
            vision_dim=64, max_image_tokens=8)
        vit = vit_config(num_layers=2, d_model=64, num_heads=4, d_ff=128,
                         patch_dim=32, downsample=4,
                         out_dim=vlm_cfg.vision_dim)
        out["mllm"] = mllm_spec(
            vit, vlm_cfg, vit_parallel=par, lm_parallel=par,
            global_batch=8, seq_len=64, mbs=2)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis over the registered workload specs")
    ap.add_argument("--spec", default="all",
                    choices=("all", "distill", "multi_teacher", "mllm"))
    ap.add_argument("--n-mb", type=int, default=2)
    ap.add_argument("--min-severity", default="info",
                    choices=("info", "warning", "error"))
    ap.add_argument("--gates-dir", default=None,
                    help="override the gate-file directory "
                         "(default: repro_torch/analysis/gates/)")
    args = ap.parse_args(argv)
    min_sev = Severity[args.min_severity.upper()]
    failed = False

    for name, spec in sorted(build_specs(args.spec).items()):
        try:
            spec.validate()
        except (ValueError, AssertionError) as e:
            print(f"[ERROR] spec.validate ({name}): {e}")
            failed = True
            continue
        for lookahead in (0, 1):
            rep = check_spec(spec, n_mb=args.n_mb, lookahead=lookahead)
            rep.passname = f"deadlock:{name}@la{lookahead}"
            print(rep.render(min_severity=min_sev) or rep.summary())
            failed |= not rep.ok
        rep = lint_spec(spec, passname=f"donation:{name}")
        out = rep.render(min_severity=min_sev)
        if out:
            print(out)
        failed |= not rep.ok
    for path in hlo_gates.list_gates(args.gates_dir):
        try:
            gate = hlo_gates.load_gate(path)
        except (ValueError, KeyError) as e:
            print(f"[ERROR] hlo.gate-schema ({path.name}): {e}")
            failed = True
            continue
        if min_sev <= Severity.INFO:
            print(f"[INFO] hlo.gate-schema ({path.name}): "
                  f"{len(gate.checks)} checks over programs "
                  f"{list(gate.programs)}")
    print("ANALYSIS " + ("FAILED" if failed else "OK"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
