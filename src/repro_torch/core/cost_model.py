"""Analytic per-section cost model.  The port's own copy of
``repro/core/cost_model.py``, with no default device: every call passes
``hw=`` (the port plans with :data:`repro_torch.core.types.H100`).

Used by (a) the two-stage planner (§3.2) to search per-section configs and
(b) the wavefront scheduler (§3.4) to build the per-sample 6-tuples.

Time model per microbatch of a section::

    t = t_overhead(C) + tokens * flops_per_token / (peak * mfu(C))

* ``t_overhead`` captures per-launch/per-microbatch fixed cost; its ratio to
  the marginal term is calibrated so a forward-only teacher gains 2.6×
  throughput from mbs 1→4 (paper Fig. 9).
* ``mfu(C)`` applies TP/CP communication penalties and the PP bubble
  (p−1)/(m+p−1).

Memory model per GPU (bytes)::

    params/(tp·pp[·dp if ZeRO])·bytes_param + opt_states + activations(mbs)

All constants are module-level and documented; tests pin the Fig. 9
calibration.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.simulator import Sample
from repro_torch.core.types import ArchConfig, HardwareSpec, ParallelConfig

# ---- calibration constants ------------------------------------------------ #
BASE_MFU = 0.55           # well-tuned dense matmul-bound section
TP_PENALTY = 0.04         # multiplicative loss per log2(tp) step
CP_PENALTY = 0.03
FWD_OVERHEAD_RATIO = 4.57  # t_overhead / marginal-cost-per-sample (Fig. 9:
#                            mbs 1→4 ⇒ 2.6× teacher throughput)
BWD_FLOPS_MULT = 2.0      # bwd ≈ 2× fwd
BYTES_PARAM = 2           # bf16
BYTES_OPT = 12            # fp32 master + m + v
BYTES_GRAD = 4            # fp32 accumulation
ACT_BYTES_PER_TOKEN_LAYER = 2.5   # remat: ~1 residual + norm stats, bf16


def flops_per_token_fwd(cfg: ArchConfig, seq_len: int) -> float:
    """Forward FLOPs per token: 2·N_active + attention quadratic term."""
    base = 2.0 * cfg.active_params()
    attn_layers = sum(1 for i in range(cfg.num_layers) if cfg.is_attn_layer(i))
    if attn_layers and cfg.num_heads:
        eff_ctx = seq_len / 2 if not cfg.sliding_window else min(
            cfg.sliding_window, seq_len / 2)
        base += 4.0 * attn_layers * eff_ctx * cfg.num_heads * cfg.hd
    if cfg.family == "ssm" or cfg.attn_period:
        ssm_layers = sum(1 for i in range(cfg.num_layers)
                         if not cfg.is_attn_layer(i))
        d_in = cfg.ssm_expand * cfg.d_model
        base += 2.0 * ssm_layers * d_in * cfg.ssm_state * 2
    return base


SHARD_WIDTH_KNEE = 64     # per-shard hidden width where MXU efficiency halves
# (a TPU constant, copied as it is: calibrating the knee, and the rest of
# these constants, for the H100 is planner work; ROADMAP.md, A9)


def mfu(parallel: ParallelConfig, *, num_microbatches: int = 1,
        forward_only: bool = False, d_model: int = 0) -> float:
    eff = BASE_MFU
    eff *= (1.0 - TP_PENALTY) ** math.log2(max(parallel.tp, 1))
    eff *= (1.0 - CP_PENALTY) ** math.log2(max(parallel.cp, 1))
    if d_model:
        # small-shard penalty: slicing a narrow model across a wide TP axis
        # starves the MXU (the paper's §2.1 uniform-config pathology for
        # the 0.4B ViT at the LLM's TP degree)
        w = d_model / max(parallel.tp, 1)
        eff *= w / (w + SHARD_WIDTH_KNEE)
    if parallel.pp > 1:
        m = max(num_microbatches, 1)
        bubble = (parallel.pp - 1) / (m + parallel.pp - 1)
        eff *= (1.0 - bubble)
    return eff


@dataclass(frozen=True)
class SectionCost:
    """Per-iteration cost of one section under a config."""
    t_fwd_sample: float          # seconds per sample, forward
    t_bwd_sample: float          # seconds per sample, backward (0 if frozen)
    mem_per_gpu: float           # bytes
    flops_fwd_sample: float


def microbatch_time(cfg: ArchConfig, parallel: ParallelConfig,
                    seq_len: int, *, forward_only: bool,
                    num_microbatches: int = 8,
                    hw: HardwareSpec) -> float:
    """Seconds for one microbatch (mbs samples) on this section's GPUs."""
    chips = parallel.tp * parallel.cp * parallel.pp
    f_tok = flops_per_token_fwd(cfg, seq_len)
    flops = f_tok * seq_len * parallel.mbs
    if not forward_only:
        flops *= (1.0 + BWD_FLOPS_MULT)
    eff = mfu(parallel, num_microbatches=num_microbatches,
              forward_only=forward_only, d_model=cfg.d_model)
    marginal = flops / (hw.peak_flops_bf16 * chips * eff)
    per_sample = marginal / max(parallel.mbs, 1)
    overhead = FWD_OVERHEAD_RATIO * per_sample * (1 if forward_only else 0.35)
    return overhead + marginal


def section_cost(cfg: ArchConfig, parallel: ParallelConfig, seq_len: int, *,
                 trainable: bool = True, num_microbatches: int = 8,
                 hw: HardwareSpec) -> SectionCost:
    t_mb_f = microbatch_time(cfg, parallel, seq_len, forward_only=True,
                             num_microbatches=num_microbatches, hw=hw)
    t_f = t_mb_f / max(parallel.mbs, 1)
    if trainable:
        t_mb_full = microbatch_time(cfg, parallel, seq_len,
                                    forward_only=False,
                                    num_microbatches=num_microbatches, hw=hw)
        t_full = t_mb_full / max(parallel.mbs, 1)
        t_b = t_full - t_f
    else:
        t_b = 0.0
    mem = memory_per_gpu(cfg, parallel, seq_len, trainable=trainable)
    return SectionCost(t_f, t_b, mem,
                       flops_per_token_fwd(cfg, seq_len) * seq_len)


def memory_per_gpu(cfg: ArchConfig, parallel: ParallelConfig, seq_len: int,
                   *, trainable: bool) -> float:
    n = cfg.total_params()
    shard = parallel.tp * parallel.pp
    zshard = shard * (parallel.dp if parallel.zero_opt else 1)
    # trainable sections use FSDP param sharding (embed dims → data axis,
    # matching dist/sharding.py) + ZeRO opt state + reduce-scattered grads;
    # frozen teachers keep params TP-sharded only (TEACHER_RULES)
    p_bytes = n * BYTES_PARAM / (zshard if trainable else shard)
    opt = 0.0
    if trainable:
        opt = n * (BYTES_OPT / zshard + BYTES_GRAD / zshard)
    act_layers = cfg.num_layers / parallel.pp
    act = (parallel.mbs * seq_len * cfg.d_model * act_layers
           * ACT_BYTES_PER_TOKEN_LAYER / (parallel.tp * parallel.cp))
    if trainable:
        act *= 2.0                   # fwd residuals + bwd workspace
    # logits workspace (fp32) for the loss
    logits = (parallel.mbs * seq_len * cfg.vocab_size * 4
              / (parallel.tp * parallel.cp)) if trainable else 0.0
    return p_bytes + opt + act + min(logits, 4e9)


def fits(cfg: ArchConfig, parallel: ParallelConfig, seq_len: int, *,
         trainable: bool, hw: HardwareSpec, reserve: float = 0.9) -> bool:
    """Whether the section's modelled memory per device stays within
    ``reserve`` of the device's memory."""
    return memory_per_gpu(cfg, parallel, seq_len, trainable=trainable) \
        <= hw.hbm_bytes * reserve


# --------------------------------------------------------------------------- #
# Scheduler 6-tuples (§3.4): cost-model durations per sample
# --------------------------------------------------------------------------- #
def sample_tuples(graph, activation: dict, seq_len: int, *,
                  n: Optional[int] = None, num_microbatches: int = 8,
                  hw: HardwareSpec):
    """Per-sample ``Sample`` 6-tuples for a section graph, durations from
    the analytic cost model — the executor feeds these to
    ``schedule_global_batch`` to decide the *realized* dispatch order.

    ``activation[name][i]`` — whether sample ``i`` activates section
    ``name`` (data-dependent activation; omitted sections are always
    active).  Sections upstream of the critical section contribute to the
    ``bc`` phases (fwd before / bwd after the critical section), strict
    downstream sections to ``ac``; a section's sequence length is
    ``seq_len * seq_scale``."""
    if n is None:
        n = max((len(v) for v in activation.values()), default=0)
    crit = graph.critical.name
    # transitive closure: everything with a path INTO the critical
    # section runs before it (a depth-2 producer still occupies the bc
    # resource), everything else is strict-downstream
    upstream = set()
    frontier = [crit]
    while frontier:
        node = frontier.pop()
        for e in graph.producers_of(node):
            if e.src not in upstream:
                upstream.add(e.src)
                frontier.append(e.src)
    costs = {}
    for name, sec in graph.sections.items():
        costs[name] = section_cost(
            sec.arch, sec.parallel, max(int(seq_len * sec.seq_scale), 1),
            trainable=sec.trainable, num_microbatches=num_microbatches,
            hw=hw)

    def active(name: str, i: int) -> bool:
        acts = activation.get(name)
        return True if acts is None else bool(acts[i])

    out = []
    for i in range(n):
        f_bc = b_ac = f_ac = b_bc = 0.0
        for name, sec in graph.sections.items():
            if name == crit or not active(name, i):
                continue
            c = costs[name]
            if name in upstream:
                f_bc += c.t_fwd_sample
                b_ac += c.t_bwd_sample
            else:
                f_ac += c.t_fwd_sample
                b_bc += c.t_bwd_sample
        cc = costs[crit]
        out.append(Sample(i, f_bc, cc.t_fwd_sample, f_ac, b_bc,
                          cc.t_bwd_sample, b_ac))
    return out
