"""Trace the distill runtime's streamed iterations again and again and run
the affinity pass over each trace (ROADMAP.md, C10).

    python3 tools/affinity_probe.py [TRACES]          # on one card

Builds the kernels as ``chip_smoke.py`` does, then qwen1.5-0.5b
self-distillation on a ``CompoundRuntime`` with lookahead 1 (teacher and
student on their own worker threads and streams, bf16, 4 x 2048), and
traces two warm iterations TRACES times (default 12).  Prints, for each
trace, whether ``analysis.affinity.check_profile`` passed and its summary
line (kernels launched outside the sections, and the launch calls it
counted apart); for a failed trace, each kernel it gave to the main
thread with its launch call's thread, its operators and the host events
around it on that thread.  Ends with the number of traces flagged.
"""
import collections
import functools
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def report(prof, rep, affinity) -> None:
    """The kernels a failed trace gave to the main thread, with context."""
    from torch.autograd import DeviceType
    for f in rep.errors:
        print(f"  {f}")
    events = list(prof.events())
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    t_lo = min(e.time_range.start for e in events)
    calls = {e.id: e for e in cpu if affinity._LAUNCH.match(e.name)}
    ranged = {e.thread for e in cpu
              if e.name.startswith(affinity.TASK_RANGE)}
    backward = {e.thread for e in cpu
                if getattr(e, "fwd_thread", 0) not in (0, e.thread)}
    print("  host events by thread:",
          dict(collections.Counter(e.thread for e in cpu)))
    for e in events:
        call = calls.get(e.id) if e.device_type == DeviceType.CUDA else None
        if call is None or call.thread in ranged | backward \
                or any(affinity._enclosing(call)):
            continue
        t = call.time_range.start
        print(f"  kernel {e.name[:100]!r} on stream {e.device_resource_id}:"
              f" {call.name} on thread {call.thread} at {t - t_lo:.1f} us,"
              f" under {getattr(call.cpu_parent, 'name', None)}")
        for x in sorted((x for x in cpu if x.thread == call.thread
                         and x.time_range.start - 3000 <= t
                         <= x.time_range.end + 3000),
                        key=lambda x: x.time_range.start)[:12]:
            print(f"    {x.name[:60]} [{x.time_range.start - t_lo:.1f}, "
                  f"{x.time_range.end - t_lo:.1f}] us")


def main(traces: int) -> int:
    if not torch.cuda.is_available():
        print("affinity_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis import affinity
    from repro_torch.core import workload as wl
    from repro_torch.core.types import ParallelConfig
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.distill import workload as dw
    from repro_torch.launch.serve import resolve_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw, schedules
    print(cs.card())
    cs.phase_build()
    dev = torch.device("cuda", 0)
    cfg = resolve_config(cs.TRAIN_ARCH, dtype="bfloat16")
    teacher, student = (
        tree_map(lambda p: p.detach(),
                 build_model(cfg, device=dev, seed=s).param_tree())
        for s in (1, 0))
    gen = lm_batches(batch=cs.TRAIN_B, seq_len=cs.TRAIN_S,
                     vocab=cfg.vocab_size, seed=0, device="cpu")
    batches = [next(gen) for _ in range(4)]
    consts = {"student": {"w_t": dw.teacher_unembedding(teacher, cfg)}}
    spec = dw.distill_spec(cfg, cfg, teacher_parallel=ParallelConfig(),
                           student_parallel=ParallelConfig(), alpha=0.5,
                           temperature=2.0)
    flagged = 0
    with wl.CompoundRuntime(spec, devices=[dev, dev], lookahead=1,
                            lr_schedule=functools.partial(
                                schedules.constant, peak_lr=1e-4)) as crt:
        crt.install({"teacher": teacher, "student": student},
                    {"student": adamw.init(student)})
        for i in range(2):                       # warm up
            crt.submit_iteration(batches[i], i, consts=consts)
        crt.drain()
        it = 2
        for k in range(traces):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         experimental_config=affinity.profile_config()) \
                    as prof:
                for _ in range(2):
                    crt.submit_iteration(batches[2 + it % 2], it,
                                         consts=consts)
                    it += 1
                crt.drain()
            rep = affinity.check_profile(prof, crt)
            print(f"trace {k}: ok={rep.ok}; {rep.findings[-1].message}",
                  flush=True)
            if not rep.ok:
                flagged += 1
                report(prof, rep, affinity)
    print(f"affinity pass flagged {flagged} of {traces} traces")
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 12))
