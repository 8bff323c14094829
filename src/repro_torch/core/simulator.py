"""Event-driven timeline simulator for section execution (paper §3.4).
The port's own copy of ``repro/core/simulator.py``.

Each sample is the paper's 6-tuple
``(t_f_bc, t_f_c, t_f_ac, t_b_bc, t_b_c, t_b_ac)`` — execution time
before/within/after the *critical section*, forward and backward.

Resource mapping (VLM example: BC = ViT, C = LLM):

* ``bc`` resource executes  f_bc  (e.g. ViT fwd)  and  b_ac (ViT bwd)
* ``c``  resource executes  f_c  and  b_c          (critical section)
* ``ac`` resource executes  f_ac and  b_bc         (post-critical modules)

Per-sample dependency chain: f_bc → f_c → f_ac → b_bc → b_c → b_ac.
Execution policy: when a resource frees up it picks the *ready* task whose
(schedule position, phase) is smallest — greedy ready-first list scheduling,
which is what lets the critical section skip past samples whose upstream
work hasn't finished (the paper's no-stall property).

Zero-duration phases complete instantly and occupy no resource.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple


class Sample(NamedTuple):
    idx: int
    t_f_bc: float
    t_f_c: float
    t_f_ac: float
    t_b_bc: float
    t_b_c: float
    t_b_ac: float

    @property
    def tuple6(self):
        return (self.t_f_bc, self.t_f_c, self.t_f_ac,
                self.t_b_bc, self.t_b_c, self.t_b_ac)


PHASES = ("f_bc", "f_c", "f_ac", "b_bc", "b_c", "b_ac")
PHASE_RESOURCE = ("bc", "c", "ac", "ac", "c", "bc")


@dataclass
class SimResult:
    makespan: float
    critical_busy: float
    critical_idle: float          # idle inside the critical section's span
    resource_busy: Dict[str, float]
    timeline: Optional[List[Tuple[str, int, str, float, float]]] = None
    # timeline entries: (resource, sample_idx, phase, start, end)

    @property
    def critical_utilization(self) -> float:
        span = self.critical_busy + self.critical_idle
        return self.critical_busy / span if span > 0 else 1.0


def simulate(samples: Sequence[Sample], *, collect_timeline: bool = False,
             bc_concurrency: int = 1) -> SimResult:
    """Simulate one DP rank's schedule (sample order = schedule order).

    bc_concurrency: number of parallel executors for the bc resource
    (used when a producer section serves this rank exclusively)."""
    n = len(samples)
    durations = [s.tuple6 for s in samples]
    done_t = [[None] * 6 for _ in range(n)]          # completion times
    next_phase = [0] * n
    res_free = {"bc": [0.0] * bc_concurrency, "c": [0.0], "ac": [0.0]}
    busy = {"bc": 0.0, "c": 0.0, "ac": 0.0}
    c_start, c_end = math.inf, 0.0
    timeline: List[Tuple[str, int, str, float, float]] = []

    # ready time of sample i's phase p = completion of phase p-1 (or 0)
    def ready_time(i: int, p: int) -> float:
        return 0.0 if p == 0 else done_t[i][p - 1]

    # fast path: resolve all leading zero-duration phases
    def resolve_zeros(i: int):
        p = next_phase[i]
        while p < 6 and durations[i][p] == 0.0:
            done_t[i][p] = ready_time(i, p)
            p += 1
        next_phase[i] = p

    for i in range(n):
        resolve_zeros(i)

    remaining = sum(1 for i in range(n) if next_phase[i] < 6)
    while remaining:
        progressed = False
        # find, per resource, the smallest-(pos, phase) ready task
        for rname, frees in res_free.items():
            slot = min(range(len(frees)), key=lambda k: frees[k])
            t_free = frees[slot]
            best = None
            for i in range(n):
                p = next_phase[i]
                if p >= 6 or PHASE_RESOURCE[p] != rname:
                    continue
                rt = ready_time(i, p)
                key = (max(rt, t_free), i, p)
                if best is None or key < best[0:1] + best[1:3]:
                    best = (key[0], i, p, rt)
            if best is None:
                continue
            start, i, p, rt = best
            dur = durations[i][p]
            end = start + dur
            frees[slot] = end
            busy[rname] += dur
            done_t[i][p] = end
            next_phase[i] = p + 1
            resolve_zeros(i)
            if next_phase[i] >= 6:
                remaining -= 1
            if rname == "c":
                c_start = min(c_start, start)
                c_end = max(c_end, end)
            if collect_timeline:
                timeline.append((rname, samples[i].idx, PHASES[p], start,
                                 end))
            progressed = True
        if not progressed:      # pragma: no cover — deadlock guard
            raise RuntimeError("simulator made no progress")

    makespan = max((done_t[i][5] for i in range(n)), default=0.0)
    c_span_idle = (c_end - c_start - busy["c"]) if c_end > c_start else 0.0
    return SimResult(makespan, busy["c"], max(c_span_idle, 0.0), busy,
                     timeline if collect_timeline else None)


def makespan_of(samples: Sequence[Sample]) -> float:
    return simulate(samples).makespan


# --------------------------------------------------------------------------- #
# System-level: one producer (bc) section shared by `fanout` consumer ranks
# --------------------------------------------------------------------------- #
def simulate_fanout(per_rank: Sequence[Sequence[Sample]], *,
                    collect_timeline: bool = False) -> SimResult:
    """Simulate `fanout` consumer DP ranks sharing ONE bc producer rank.

    The bc resource serves all ranks' f_bc / b_ac tasks (round-robin merged
    by schedule position); each consumer rank has its own c and ac
    resources.  Returns the aggregate (max-makespan) result with critical
    stats summed over consumer ranks.
    """
    fanout = len(per_rank)
    tagged: List[Tuple[int, int, Sample]] = []   # (rank, pos, sample)
    for r, sched in enumerate(per_rank):
        for pos, s in enumerate(sched):
            tagged.append((r, pos, s))

    durations = {(r, p): per_rank[r][p].tuple6
                 for r, p, _ in tagged}
    done_t = {(r, p): [None] * 6 for r, p, _ in tagged}
    next_phase = {(r, p): 0 for r, p, _ in tagged}
    res_free: Dict[str, float] = {"bc": 0.0}
    for r in range(fanout):
        res_free[f"c{r}"] = 0.0
        res_free[f"ac{r}"] = 0.0
    busy = {k: 0.0 for k in res_free}
    c_bounds = {r: [math.inf, 0.0] for r in range(fanout)}
    timeline = []

    def resource_of(rank: int, phase: int) -> str:
        base = PHASE_RESOURCE[phase]
        return "bc" if base == "bc" else f"{base}{rank}"

    def ready_time(key, p):
        return 0.0 if p == 0 else done_t[key][p - 1]

    def resolve_zeros(key):
        p = next_phase[key]
        while p < 6 and durations[key][p] == 0.0:
            done_t[key][p] = ready_time(key, p)
            p += 1
        next_phase[key] = p

    for key in list(next_phase):
        resolve_zeros(key)
    remaining = sum(1 for k in next_phase if next_phase[k] < 6)

    while remaining:
        progressed = False
        for rname in res_free:
            t_free = res_free[rname]
            best = None
            for (r, pos), _ in ((k, None) for k in next_phase):
                p = next_phase[(r, pos)]
                if p >= 6 or resource_of(r, p) != rname:
                    continue
                rt = ready_time((r, pos), p)
                # merged round-robin priority for the shared bc resource
                key = (max(rt, t_free), pos, r, p)
                if best is None or key < best[0]:
                    best = (key, (r, pos), p)
            if best is None:
                continue
            (start, _, _, _), key, p = best
            dur = durations[key][p]
            end = start + dur
            res_free[rname] = end
            busy[rname] += dur
            done_t[key][p] = end
            next_phase[key] = p + 1
            resolve_zeros(key)
            if next_phase[key] >= 6:
                remaining -= 1
            if rname.startswith("c"):
                r = int(rname[1:])
                c_bounds[r][0] = min(c_bounds[r][0], start)
                c_bounds[r][1] = max(c_bounds[r][1], end)
            if collect_timeline:
                timeline.append((rname, per_rank[key[0]][key[1]].idx,
                                 PHASES[p], start, end))
            progressed = True
        if not progressed:      # pragma: no cover
            raise RuntimeError("simulator made no progress")

    makespan = max(done_t[k][5] for k in done_t)
    c_busy = sum(busy[f"c{r}"] for r in range(fanout))
    c_idle = sum(max(c_bounds[r][1] - c_bounds[r][0] - busy[f"c{r}"], 0.0)
                 for r in range(fanout) if c_bounds[r][1] > c_bounds[r][0])
    return SimResult(makespan, c_busy, c_idle, busy,
                     timeline if collect_timeline else None)
