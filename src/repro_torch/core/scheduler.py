"""Wavefront scheduling (paper §3.4, Algorithm 1).  The port's own copy
of ``repro/core/scheduler.py``: the same arithmetic in the same order, so
both packages give identical schedules on the same floats.

1. Sort samples ascending by ``t_f_bc`` (earliest to reach the critical
   section first); seed the result schedule with the top sample.
2. For each remaining sample, evaluate every insertion position by
   simulating the full multi-section timeline and commit the position
   minimizing makespan (first such position on ties).

Candidate evaluation is the hot path (the naive form re-runs the full
O(N²) simulator for every one of O(N²) candidates — O(N⁴) overall, §3.4
says scheduling must overlap GPU execution).  ``wavefront_schedule``
instead evaluates candidates with :func:`_greedy_makespan`, a
semantics-identical re-implementation of ``core.simulator.simulate`` that

* keeps per-resource *pending sets* instead of rescanning every sample's
  phase per dispatch, and
* **early-aborts** a candidate once a makespan lower bound (max
  completion dispatched so far; critical-resource free time + remaining
  critical work) reaches the best makespan already found for this
  insertion.  Positions are scanned left to right, so an aborted
  candidate can never win the (min makespan, min position) selection.

Most candidates die after a handful of dispatches, bringing the effective
cost to ~O(N²) on paper-like workloads.

**Equivalence contract** (vs :func:`wavefront_schedule_reference`, the
seed O(N⁴) form kept as the oracle): the per-candidate evaluator
:func:`_greedy_makespan` reproduces ``simulate`` dispatch-for-dispatch on
*every* input (fuzz-tested).  The early abort additionally relies on
float comparisons against the incumbent makespan, which on critical-
saturated schedules are exact *ties*; when the tied quantities were
accumulated without rounding (the case for cost-model-scale durations —
all repo workloads, benches and the acceptance fixtures; property-tested
on fixed seeds in ``tests/test_scheduler_fast.py`` and ``tests/test_torch_scheduler.py``) the schedule is
identical to the reference.  On adversarial float inputs an ulp of
accumulation drift can flip such a tie and the two algorithms may commit
different — equally scoring at decision time — insertions; the result is
still a valid Algorithm-1 schedule and never worse than FIFO.

Plus the two DP-level mechanisms from the paper:

* ``partition_global_batch`` — split the global batch across DP ranks
  balancing the distribution of activated sections (per-rank counts stay
  exactly equal — SPMD requires it).
* ``merge_fanout_schedules`` — round-robin interleave of ``fanout``
  consumer-rank schedules for the shared producer section.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.simulator import (PHASE_RESOURCE, Sample, SimResult,
                                  simulate)


@dataclass
class ScheduleResult:
    order: List[Sample]
    makespan: float
    fifo_makespan: float
    sim: SimResult
    elapsed_s: float

    @property
    def improvement(self) -> float:
        return (self.fifo_makespan - self.makespan) / self.fifo_makespan \
            if self.fifo_makespan else 0.0


# phase → resource id (0 = bc, 1 = c, 2 = ac); mirrors simulator semantics
_RES_ID = {"bc": 0, "c": 1, "ac": 2}
_PHASE_RES = tuple(_RES_ID[r] for r in PHASE_RESOURCE)


def _greedy_makespan(durations: Sequence[Tuple[float, ...]],
                     abort_above: float = math.inf) -> Optional[float]:
    """Makespan of ``core.simulator.simulate`` for a 6-tuple list —
    identical dispatch semantics (greedy ready-first per resource in
    bc/c/ac order, ties by schedule position), restructured around
    per-resource pending sets.

    Returns None as soon as a makespan lower bound reaches
    ``abort_above`` (the candidate cannot beat an already-found schedule).
    """
    n = len(durations)
    nxt = [0] * n                     # next phase per sample
    ready = [0.0] * n                 # completion time of previous phase
    pend: List[List[int]] = [[], [], []]
    free = [0.0, 0.0, 0.0]
    maxdone = 0.0
    crit_rem = 0.0
    for d in durations:
        crit_rem += d[1] + d[4]
    remaining = n

    def park(i: int) -> bool:
        """Skip zero-duration phases; en-queue sample on its next resource.
        Returns True when the sample finished."""
        p = nxt[i]
        d = durations[i]
        while p < 6 and d[p] == 0.0:
            p += 1
        nxt[i] = p
        if p >= 6:
            return True
        pend[_PHASE_RES[p]].append(i)
        return False

    for i in range(n):
        if park(i):
            remaining -= 1

    while remaining:
        progressed = False
        for r in (0, 1, 2):
            lst = pend[r]
            if not lst:
                continue
            t_free = free[r]
            best_j = 0
            best_i = lst[0]
            best_start = ready[best_i] if ready[best_i] > t_free else t_free
            for j in range(1, len(lst)):
                i = lst[j]
                st = ready[i] if ready[i] > t_free else t_free
                if st < best_start or (st == best_start and i < best_i):
                    best_start, best_j, best_i = st, j, i
            i = best_i
            p = nxt[i]
            dur = durations[i][p]
            end = best_start + dur
            free[r] = end
            ready[i] = end
            if r == 1:
                crit_rem -= dur
            if end > maxdone:
                maxdone = end
            lst[best_j] = lst[-1]
            lst.pop()
            nxt[i] = p + 1
            if park(i):
                remaining -= 1
            progressed = True
            # maxdone is produced by the exact arithmetic the full run
            # would perform for this dispatch prefix — always a sound
            # abort.  The critical-work bound (free[1] + crit_rem) fires
            # mostly at *exact equality* with the incumbent (critical-
            # saturated schedules); that is sound whenever the critical-
            # side arithmetic is exact, which holds for the per-sample
            # cost model's duration scale — but on arbitrary float soup
            # an ulp of accumulation drift can flip such a tie, so the
            # schedule is only guaranteed identical to the reference on
            # tie-stable inputs (see module docstring).
            bound = free[1] + crit_rem
            if maxdone > bound:
                bound = maxdone
            if bound >= abort_above:
                return None
        if not progressed:      # pragma: no cover — deadlock guard
            raise RuntimeError("scheduler simulation made no progress")
    return maxdone


def wavefront_schedule(samples: Sequence[Sample]) -> ScheduleResult:
    """Algorithm 1. Returns the reordered schedule plus quality metrics.

    Produces the same schedule as :func:`wavefront_schedule_reference`
    (the straightforward O(N⁴) form) at ~O(N²) effective cost on
    tie-stable inputs — see the module docstring for the pruning
    argument and the exact equivalence contract."""
    t0 = time.perf_counter()
    if not samples:
        return ScheduleResult([], 0.0, 0.0, simulate([]), 0.0)
    fifo = _greedy_makespan([s.tuple6 for s in samples])
    initial = sorted(samples, key=lambda s: s.t_f_bc)
    result: List[Sample] = [initial[0]]
    result_t6: List[Tuple[float, ...]] = [initial[0].tuple6]
    for s in initial[1:]:
        t6 = s.tuple6
        best_pos, best_mk = 0, math.inf
        for pos in range(len(result) + 1):
            cand = result_t6[:pos] + [t6] + result_t6[pos:]
            mk = _greedy_makespan(cand, abort_above=best_mk)
            if mk is not None and mk < best_mk:
                best_mk, best_pos = mk, pos
        result.insert(best_pos, s)
        result_t6.insert(best_pos, t6)
    final = simulate(result)
    # Beyond-paper guard (found by property testing): the greedy insertion
    # is a heuristic and can end *worse* than the incoming order on
    # adversarial inputs — keep whichever schedule is better, so the
    # scheduler is never-worse-than-FIFO by construction.
    if final.makespan > fifo:
        result = list(samples)
        final = simulate(result)
    return ScheduleResult(result, final.makespan, fifo, final,
                          time.perf_counter() - t0)


def wavefront_schedule_reference(samples: Sequence[Sample]
                                 ) -> ScheduleResult:
    """The seed O(N⁴) form of Algorithm 1 — one full ``simulate`` per
    insertion candidate.  Kept as the equivalence oracle for
    ``wavefront_schedule`` (tests assert identical schedules on the
    acceptance fixtures; see the module docstring for the contract)."""
    t0 = time.perf_counter()
    fifo = simulate(samples).makespan if samples else 0.0
    if not samples:
        return ScheduleResult([], 0.0, 0.0, simulate([]), 0.0)
    initial = sorted(samples, key=lambda s: s.t_f_bc)
    result: List[Sample] = [initial[0]]
    for s in initial[1:]:
        best_pos, best_mk = 0, float("inf")
        for pos in range(len(result) + 1):
            cand = result[:pos] + [s] + result[pos:]
            mk = simulate(cand).makespan
            if mk < best_mk:
                best_mk, best_pos = mk, pos
        result.insert(best_pos, s)
    final = simulate(result)
    if final.makespan > fifo:
        result = list(samples)
        final = simulate(result)
    return ScheduleResult(result, final.makespan, fifo, final,
                          time.perf_counter() - t0)


def partition_global_batch(samples: Sequence[Sample],
                           dp: int) -> List[List[Sample]]:
    """Balance activated-section load across DP ranks with equal counts.

    Greedy LPT on the non-critical work (t_f_bc + t_b_ac + t_f_ac + t_b_bc)
    subject to the per-rank capacity |batch|/dp."""
    n = len(samples)
    assert n % dp == 0, (n, dp)
    cap = n // dp
    order = sorted(samples,
                   key=lambda s: -(s.t_f_bc + s.t_b_ac + s.t_f_ac + s.t_b_bc))
    loads = [0.0] * dp
    counts = [0] * dp
    ranks: List[List[Sample]] = [[] for _ in range(dp)]
    for s in order:
        cand = [r for r in range(dp) if counts[r] < cap]
        r = min(cand, key=lambda r: (loads[r], counts[r]))
        ranks[r].append(s)
        loads[r] += s.t_f_bc + s.t_b_ac + s.t_f_ac + s.t_b_bc
        counts[r] += 1
    return ranks


def merge_fanout_schedules(per_rank: Sequence[Sequence[Sample]]
                           ) -> List[Tuple[int, Sample]]:
    """Round-robin interleave of consumer-rank schedules → the order in
    which the shared producer section processes samples.  Returns
    (consumer_rank, sample) pairs."""
    out: List[Tuple[int, Sample]] = []
    longest = max((len(r) for r in per_rank), default=0)
    for pos in range(longest):
        for r, sched in enumerate(per_rank):
            if pos < len(sched):
                out.append((r, sched[pos]))
    return out


def schedule_global_batch(samples: Sequence[Sample], dp: int
                          ) -> Tuple[List[List[Sample]],
                                     List[Tuple[int, Sample]]]:
    """Partition → per-rank Algorithm 1 → fanout merge (paper end-to-end)."""
    ranks = partition_global_batch(samples, dp)
    scheduled = [wavefront_schedule(r).order for r in ranks]
    merged = merge_fanout_schedules(scheduled)
    return scheduled, merged
