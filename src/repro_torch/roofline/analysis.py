"""Analytic wire model of context-parallel attention.

Counterpart of ``repro/roofline/analysis.py::cp_attention_comm``, copied:
it is pure arithmetic over the head counts, the sequence and the CP
degree, and ``dist.context.resolve_cp_mode`` consults it to pick between
``ulysses_mqa`` and ``allgather``.  The rest of the reference module (HLO
parsing, roofline terms) reads compiled XLA programs and is ROADMAP.md,
A6.5.
"""
from __future__ import annotations

import math
from typing import Dict, Optional


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
