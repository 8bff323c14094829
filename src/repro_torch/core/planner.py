"""Two-stage section hyper-parameter optimization (paper §3.2).  The port's
own copy of ``repro/core/planner.py``, with no default device: every
function takes ``hw=`` (the port plans with
:data:`repro_torch.core.types.H100`).

The joint search over {C^s} = {DP, TP, PP, CP, mbs, fanout} per section is
combinatorial; Maestro's hierarchy makes it tractable:

* **Stage 1 (critical-first)**: fix the critical section's GPU budget
  (= the baseline allocation, as in the paper's evaluation) and pick the
  C^crit maximizing per-sample throughput subject to the per-GPU memory
  constraint.
* **Stage 2 (auxiliary-adaptive)**: for each auxiliary section, choose the
  *minimal* GPU count (and a fanout consistent with
  DP^aux × fanout = DP^crit for producers) such that its per-iteration time
  fully overlaps the critical section — no stalls, no backpressure.

Constraints enforced (paper eq. 2): Σ N^s ≤ N_GPUs; max memory ≤ HBM;
DP^fr × fanout = DP^sr on every edge.

The cost model's calibration constants are still the TPU's (ROADMAP.md,
A9): a plan for the H100 uses the card's peak rate and memory, and the
TPU's efficiency curve.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core import cost_model as cmdl
from repro_torch.core.graph import SectionGraph
from repro_torch.core.types import (ArchConfig, HardwareSpec, ParallelConfig,
                                    SectionConfig)


def _divisors_leq(n: int, cap: int) -> List[int]:
    return [d for d in range(1, min(n, cap) + 1) if n % d == 0]


def candidate_parallelisms(cfg: ArchConfig, n_gpus: int, *,
                           max_tp: int = 16, max_pp: int = 8,
                           max_cp: int = 16,
                           mbs_options=(1, 2, 4, 8, 16)
                           ) -> List[ParallelConfig]:
    """Hardware-valid C^s candidates on exactly n_gpus devices.

    TP must divide attention heads (or the SSM inner dim for attn-free
    archs); PP must divide the layer stack; CP divides the sequence (checked
    at use); DP = n_gpus / (tp·pp·cp)."""
    if cfg.num_heads:
        # TP divides the Q heads; KV heads are replicated when tp > kv
        tps = _divisors_leq(cfg.num_heads, max_tp)
    else:
        tps = _divisors_leq(cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim,
                            max_tp)
    pps = _divisors_leq(cfg.num_layers, max_pp)
    out = []
    for tp, pp in itertools.product(tps, pps):
        for cp in _divisors_leq(max_cp, max_cp):
            denom = tp * pp * cp
            if n_gpus % denom:
                continue
            dp = n_gpus // denom
            for mbs in mbs_options:
                out.append(ParallelConfig(dp=dp, tp=tp, pp=pp, cp=cp,
                                          mbs=mbs))
    return out


@dataclass
class SectionPlan:
    name: str
    parallel: ParallelConfig
    n_gpus: int
    t_iter: float                 # seconds per iteration on this section
    mem_per_gpu: float
    fanout: int = 1
    stalls_critical: bool = False  # True when overlap was not achievable


@dataclass
class Plan:
    sections: Dict[str, SectionPlan]
    total_gpus: int
    iter_time: float              # critical-path iteration time

    def summary(self) -> str:
        rows = [f"{n}: gpus={p.n_gpus} dp={p.parallel.dp} "
                f"tp={p.parallel.tp} pp={p.parallel.pp} cp={p.parallel.cp} "
                f"mbs={p.parallel.mbs} fanout={p.fanout} "
                f"t_iter={p.t_iter*1e3:.1f}ms mem={p.mem_per_gpu/2**30:.1f}GiB"
                + (" [STALLS CRITICAL]" if p.stalls_critical else "")
                for n, p in self.sections.items()]
        return "\n".join(rows)


def _iter_time(cfg: ArchConfig, parallel: ParallelConfig, seq_len: int,
               samples_per_iter: int, *, trainable: bool,
               hw: HardwareSpec) -> float:
    """Per-iteration wall time of a section processing samples_per_iter
    samples with dp-way data parallelism and grad-accum microbatching."""
    per_dp = max(samples_per_iter // max(parallel.dp, 1), 1)
    n_micro = max(per_dp // max(parallel.mbs, 1), 1)
    t_mb = cmdl.microbatch_time(cfg, parallel, seq_len,
                                forward_only=not trainable,
                                num_microbatches=n_micro, hw=hw)
    return n_micro * t_mb


def plan_critical(section: SectionConfig, n_gpus: int, seq_len: int,
                  global_batch: int, *, hw: HardwareSpec) -> SectionPlan:
    """Stage 1: best C^crit on a fixed GPU budget."""
    best: Optional[SectionPlan] = None
    for cand in candidate_parallelisms(section.arch, n_gpus):
        if global_batch % cand.dp:
            continue
        if not cmdl.fits(section.arch, cand, seq_len,
                         trainable=section.trainable, hw=hw):
            continue
        t = _iter_time(section.arch, cand, seq_len, global_batch,
                       trainable=section.trainable, hw=hw)
        if best is None or t < best.t_iter:
            best = SectionPlan(section.name, cand, n_gpus, t,
                               cmdl.memory_per_gpu(
                                   section.arch, cand, seq_len,
                                   trainable=section.trainable))
    if best is None:
        raise ValueError(
            f"no feasible config for critical section {section.name} on "
            f"{n_gpus} GPUs (memory?)")
    return best


def plan_auxiliary(section: SectionConfig, crit_plan: SectionPlan,
                   seq_len: int, samples_per_iter: int, *,
                   producer_edge_fanouts=(1, 2, 4, 8),
                   is_producer: bool, activation_rate: float = 1.0,
                   gpu_cap: Optional[int] = None,
                   hw: HardwareSpec) -> SectionPlan:
    """Stage 2: minimal GPUs such that t_aux ≤ t_crit (full overlap).

    activation_rate: fraction of samples activating this section
    (data-dependent sparsity shrinks its effective work).  If no budget up
    to ``gpu_cap`` (default 2×critical) achieves overlap, returns the
    least-stalling plan at the cap with ``stalls_critical=True``."""
    eff_samples = max(int(samples_per_iter * activation_rate), 1)
    budget = crit_plan.t_iter
    cap = gpu_cap or 2 * crit_plan.n_gpus
    ns = sorted({max(crit_plan.n_gpus // f, 1)
                 for f in (256, 128, 64, 32, 16, 8, 4, 2, 1)}
                | {crit_plan.n_gpus * m // 4 for m in (5, 6, 8)})
    ns = [n for n in ns if n <= cap]
    fallback = None
    for n in ns:
        best = None
        for cand in candidate_parallelisms(section.arch, n):
            if is_producer:
                fo = [f for f in producer_edge_fanouts
                      if cand.dp * f == crit_plan.parallel.dp]
                if not fo:
                    continue
                fanout = fo[0]
            else:
                fanout = 1
            if eff_samples % cand.dp:
                continue
            if not cmdl.fits(section.arch, cand, seq_len,
                             trainable=section.trainable, hw=hw):
                continue
            t = _iter_time(section.arch, cand, seq_len, eff_samples,
                           trainable=section.trainable, hw=hw)
            sp = SectionPlan(section.name, cand, n, t,
                             cmdl.memory_per_gpu(
                                 section.arch, cand, seq_len,
                                 trainable=section.trainable),
                             fanout=fanout,
                             stalls_critical=t > budget)
            if t <= budget and (best is None or t < best.t_iter):
                best = sp
            if fallback is None or t < fallback.t_iter:
                fallback = sp
        if best is not None:
            return best
    if fallback is not None:
        return fallback
    raise ValueError(f"no feasible config at all for auxiliary section "
                     f"{section.name} (memory?)")


def plan(graph: SectionGraph, *, critical_gpus: int, seq_len: int,
         global_batch: int, activation_rates: Optional[Dict[str, float]]
         = None, hw: HardwareSpec) -> Plan:
    """End-to-end two-stage planning for a section graph."""
    activation_rates = activation_rates or {}
    crit = graph.critical
    crit_plan = plan_critical(crit, critical_gpus,
                              int(seq_len * crit.seq_scale), global_batch,
                              hw=hw)
    plans = {crit.name: crit_plan}
    for name, sec in graph.sections.items():
        if name == crit.name:
            continue
        producer = any(e.dst == crit.name for e in graph.consumers_of(name))
        p = plan_auxiliary(sec, crit_plan, int(seq_len * sec.seq_scale),
                           global_batch, is_producer=producer,
                           activation_rate=activation_rates.get(name, 1.0),
                           hw=hw)
        plans[name] = p
    total = sum(p.n_gpus for p in plans.values())
    return Plan(plans, total, crit_plan.t_iter)
