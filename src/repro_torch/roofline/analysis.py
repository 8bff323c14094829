"""Roofline terms, ring-model collective wire bytes and per-width dot
FLOPs of a recorded step; the analytic wire model of context-parallel
attention.

Counterpart of ``repro/roofline/analysis.py``.  The reference reads the
compiled, post-SPMD HLO text of a step; the port reads a
:class:`~repro_torch.roofline.record.StepStats`, the record of one call
of the step on one rank (``roofline.record``).  On that record it keeps
the reference's functions and names: :func:`_ring_wire`,
:func:`collective_ops`, :func:`wire_bytes_by_dtype`,
:func:`total_wire_bytes`, :func:`collective_families`,
:func:`dot_flops_matching`, :func:`dot_flops_by_width` and
:func:`roofline_terms`, which takes the card's constants as ``hw=`` with
no default.  ``parse_hlo``, ``_trip_count``, ``analyze_hlo`` and the
instruction walk read HLO text and have no counterpart (a recorded
operation ran once: there are no while-loop multipliers).  Dtypes are
torch's names (``float32``, ``bfloat16``, ``int8``), where XLA's are
``f32``/``u16``/``s8``.

:func:`cp_attention_comm` is a copy: pure arithmetic over the head counts,
the sequence and the CP degree, which ``dist.context.resolve_cp_mode``
consults to pick between ``ulysses_mqa`` and ``allgather``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from repro_torch.roofline.record import CollectiveOp, StepStats


def _ring_wire(family: str, n: int, operand_bytes: float,
               result_bytes: float) -> float:
    """Per-device wire bytes of one collective on an n-way ring.

    all-reduce moves 2(n-1)/n of the payload (reduce-scatter +
    all-gather phases); all-gather / reduce-scatter / all-to-all move
    (n-1)/n of the *full* buffer (result for all-gather, operand
    otherwise); a point-to-point send, a broadcast and XLA's
    collective-permute ship their payload once."""
    if n <= 1:
        return 0.0
    if family == "all-reduce":
        return 2.0 * (n - 1) / n * operand_bytes
    if family == "all-gather":
        return (n - 1) / n * result_bytes
    if family in ("reduce-scatter", "all-to-all"):
        return (n - 1) / n * max(operand_bytes, result_bytes)
    return float(operand_bytes)     # send, broadcast, collective-permute


def collective_ops(rec: StepStats) -> List[CollectiveOp]:
    """Every collective the recorded step ran, with its ring wire bytes."""
    return list(rec.collectives)


def wire_bytes_by_dtype(rec: StepStats) -> Dict[str, float]:
    """Ring-model collective wire bytes per element dtype: the knob the
    compressed DP all-reduce turns (float32 -> bfloat16 -> int8)."""
    out: Dict[str, float] = {}
    for op in collective_ops(rec):
        out[op.dtype] = out.get(op.dtype, 0.0) + op.wire_bytes
    return out


def total_wire_bytes(rec: StepStats) -> float:
    return sum(wire_bytes_by_dtype(rec).values())


def dot_flops_matching(rec: StepStats, out_last_dim: int) -> float:
    """FLOPs of every matmul-class op whose OUTPUT last dim is
    ``out_last_dim``: a rank's shapes are its blocks, so matching on the
    local vocab-shard width isolates the unembed projection."""
    return sum(d.flops for d in rec.dots if d.width == out_last_dim)


def dot_flops_by_width(rec: StepStats) -> Dict[int, float]:
    """Matmul-class FLOPs keyed by OUTPUT last dim: the histogram the
    gates (``analysis.hlo_gates``) quote on failure."""
    out: Dict[int, float] = {}
    for d in rec.dots:
        out[d.width] = out.get(d.width, 0.0) + d.flops
    return out


def collective_families(rec: StepStats) -> Dict[str, float]:
    """Executed collective families -> total ring-model wire bytes; the
    'no unexpected all-gathers / silent replication' gates compare it
    against a regime's declared profile."""
    out: Dict[str, float] = {}
    for op in collective_ops(rec):
        out[op.family] = out.get(op.family, 0.0) + op.wire_bytes
    return out


def roofline_terms(stats: StepStats, *, hw) -> Dict[str, float]:
    """Three roofline terms in seconds on one device of ``hw`` (a
    ``core.types.HardwareSpec``; the port has no default): compute at the
    bf16 peak, the un-fused bytes over the memory rate, the ring wire
    bytes over one link direction."""
    compute_s = stats.flops / hw.peak_flops_bf16
    memory_s = stats.hbm_bytes / hw.hbm_bandwidth
    collective_s = total_wire_bytes(stats) / hw.ici_bandwidth
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda t: t[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dominant}


def cp_attention_comm(mode: str, *, H: int, KV: int, D: int, cp: int,
                      B: int = 1, S: Optional[int] = None,
                      itemsize: int = 4,
                      overlap_chunks: int = 1) -> Dict[str, float]:
    """Analytic per-device ring wire bytes of one ``cp_attention`` forward.

    Models the a2a chains the modes issue (backward transposes the same
    collectives, so relative ordering is unchanged):

    * ``ulysses``      — Q/K/V a2a in, O a2a out.  With ``overlap_chunks``
      = c > 1 the K/V a2as split into c per-chunk a2as: per-collective
      payload shrinks ÷c while total wire bytes stay constant (that is the
      overlap lever — smaller messages pipeline behind chunk flash
      compute).
    * ``ulysses_mqa``  — KV heads replicated ×(cp / gcd(KV, cp)) so they
      head-shard, then plain ulysses a2as.
    * ``allgather``    — K and V all-gathered to the full sequence.

    Per device, in units of (cp−1)/cp · B·S·D·itemsize:
    ulysses = (2H + 2KV)/cp; ulysses_mqa = 2H/cp + 2KV/gcd(KV, cp);
    allgather = 2KV.  ulysses_mqa beats allgather iff
    H/(cp·KV) + 1/gcd(KV, cp) < 1 — a GQA-at-large-cp win; for pure MQA
    (KV = 1) it never wins, which is why mode="auto" consults this model
    instead of always preferring a2a.
    """
    S = cp if S is None else S
    if S % cp:
        raise ValueError(f"S={S} must divide cp={cp}")
    sc = S // cp                      # local sequence shard
    f = (cp - 1) / cp
    unit = float(B * D * itemsize)
    qo_payload = sc * H * unit        # local [B, S/cp, H, D] buffer
    if mode == "ulysses":
        if H % cp or KV % cp:
            raise ValueError(f"ulysses needs H%cp==0 and KV%cp==0 "
                             f"(H={H}, KV={KV}, cp={cp})")
        c = max(int(overlap_chunks), 1)
        if sc % c:
            raise ValueError(f"overlap_chunks={c} must divide S/cp={sc}")
        kv_payload = sc * KV * unit / c
        return {"wire_bytes": f * (2 * qo_payload + 2 * sc * KV * unit),
                "collectives": 2 + 2 * c,
                "max_payload_bytes": max(qo_payload, kv_payload),
                "min_payload_bytes": min(qo_payload, kv_payload)}
    if mode == "ulysses_mqa":
        r = cp // math.gcd(KV, cp)
        kv_r = KV * r
        if H % cp or (H % KV) or (H // KV) % r:
            raise ValueError(f"ulysses_mqa infeasible for H={H}, KV={KV}, "
                             f"cp={cp} (needs H%cp==0 and r=cp/gcd | H/KV)")
        kv_payload = sc * kv_r * unit
        return {"wire_bytes": f * (2 * qo_payload + 2 * kv_payload),
                "collectives": 4,
                "max_payload_bytes": max(qo_payload, kv_payload),
                "min_payload_bytes": min(qo_payload, kv_payload)}
    if mode == "allgather":
        kv_payload = S * KV * unit    # gathered full-sequence K (or V)
        return {"wire_bytes": f * 2 * kv_payload,
                "collectives": 2,
                "max_payload_bytes": kv_payload,
                "min_payload_bytes": kv_payload}
    raise ValueError(f"unknown cp_attention mode {mode!r}")
