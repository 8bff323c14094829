"""Declarative sharding/efficiency gates over recorded steps (analysis
pass ``hlo``).

Counterpart of ``repro/analysis/hlo_gates.py``, whose name, schema and
eight check kinds it keeps.  The reference evaluates a gate against the
compiled post-SPMD HLO texts of a set of programs; the port evaluates it
against :class:`~repro_torch.roofline.record.StepStats`, the record of one
call of each program on one rank (``roofline.record``: every collective
with its family, payload dtype, bytes and group size, and every
matmul-class op with its output width and FLOPs).  A gate file (JSON, one
per claim/regime under ``repro_torch/analysis/gates/``) declares the
expected dot-FLOP and collective profile of a set of recorded steps, and
one engine evaluates any gate against any program dict.

The port's gate files hold the port's own values: its collectives are the
ones its steps issue (a reduce-scatter of gradients into ZeRO blocks,
``send``/``recv`` between pipeline stages and a ``broadcast`` of the final
hidden, where XLA's programs have all-reduces and collective-permutes),
and its dtypes are torch's names (``float32``, ``bfloat16``, ``int8``,
where XLA ships bitcast ``u16`` and ``s8``).  Each file's
``description`` says what it changed from the reference's gate and why.

Gate file schema::

    {"name": "...", "description": "...",
     "symbols": {"pp": 4, "vocab": 1024},      # numeric, overridable
     "programs": ["masked", "vp"],             # recorded steps the gate needs
     "checks": [ {"kind": ..., "id": ..., ...}, ... ]}

Check kinds (value/width/target fields take a number or a ``*``/``/``
expression over symbols, e.g. ``"vocab/pp"`` or ``"0.05*pp"``):

* ``dot_flops`` -- FLOPs of matmul-class ops whose output last dim ==
  ``width`` in ``program``, compared ``op`` ``value``.
* ``dot_flops_ratio`` -- ratio of two such measurements (optionally
  ``num_scale``/``den_scale`` for per-sample normalization) within
  ``rtol`` of ``target``.
* ``wire_total_ratio`` -- total ring-model collective wire bytes of
  ``program`` over ``den_program``, compared ``op`` ``value``.
* ``wire_dtype`` -- wire bytes of element dtype ``dtype`` in
  ``program``, compared ``op`` ``value``.
* ``family_dtype_wire`` -- wire bytes of one collective family at one
  dtype; with ``den_program`` the measurement is the ratio against the
  same family+dtype there.
* ``collectives_subset`` -- the families executed by ``program`` must be
  within ``allowed`` (the regime's declared collective profile: an
  unexpected all-gather = silent replication).
* ``collective_count`` -- number of executed collectives of ``family``
  (all families when omitted) in ``program``, compared ``op`` ``value``.
* ``collective_payload_ratio`` -- ``agg`` (``min``/``max``) over the
  per-op payload bytes of ``family`` collectives in ``num_program``,
  divided by the same aggregate in ``den_program``, within ``rtol`` of
  ``target``.

Every check yields a Finding (ERROR on failure, INFO with the measured
value on pass) and its measurement is returned keyed by the check id.
"""
from __future__ import annotations

import json
import pathlib
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis.core import AnalysisReport, Severity, register
from repro_torch.roofline import analysis as ra
from repro_torch.roofline.record import StepStats

GATES_DIR = pathlib.Path(__file__).parent / "gates"

_OPS = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

_KINDS = ("dot_flops", "dot_flops_ratio", "wire_total_ratio",
          "wire_dtype", "family_dtype_wire", "collectives_subset",
          "collective_count", "collective_payload_ratio")

_EXPR_RE = re.compile(r"^\s*[\w.]+(\s*[*/]\s*[\w.]+)*\s*$")


@dataclass(frozen=True)
class Gate:
    name: str
    description: str
    symbols: Dict[str, float]
    programs: Tuple[str, ...]
    checks: Tuple[Dict[str, Any], ...]


def resolve(expr: Any, symbols: Dict[str, float]) -> float:
    """Resolve a numeric field: a number, a symbol name, or a left-
    associative ``*``/``/`` chain over symbols and numbers."""
    if isinstance(expr, (int, float)):
        return float(expr)
    if not isinstance(expr, str) or not _EXPR_RE.match(expr):
        raise ValueError(f"unresolvable gate expression {expr!r}")
    tokens = re.split(r"([*/])", expr.replace(" ", ""))

    def atom(tok: str) -> float:
        if tok in symbols:
            return float(symbols[tok])
        try:
            return float(tok)
        except ValueError:
            raise ValueError(
                f"unknown symbol {tok!r} in gate expression {expr!r} "
                f"(have {sorted(symbols)})") from None
    val = atom(tokens[0])
    for op, tok in zip(tokens[1::2], tokens[2::2]):
        val = val * atom(tok) if op == "*" else val / atom(tok)
    return val


def validate_gate(raw: Dict[str, Any], source: str = "<gate>") -> None:
    """Schema check, raising ValueError — run by ``--lint`` over every
    committed gate file so a malformed gate fails fast, not mid-CI."""
    for key in ("name", "description", "programs", "checks"):
        if key not in raw:
            raise ValueError(f"{source}: gate is missing {key!r}")
    symbols = dict(raw.get("symbols", {}))
    for k, v in symbols.items():
        if not isinstance(v, (int, float)):
            raise ValueError(f"{source}: symbol {k!r} is not numeric")
    programs = set(raw["programs"])
    for i, chk in enumerate(raw["checks"]):
        where = f"{source}: checks[{i}]"
        kind = chk.get("kind")
        if kind not in _KINDS:
            raise ValueError(f"{where}: unknown kind {kind!r} "
                             f"(expected one of {_KINDS})")
        refs = [chk.get("program"), chk.get("num_program"),
                chk.get("den_program")]
        for p in refs:
            if p is not None and p not in programs:
                raise ValueError(
                    f"{where}: references program {p!r} not declared in "
                    f"programs {sorted(programs)}")
        if kind in ("dot_flops", "wire_dtype", "family_dtype_wire",
                    "wire_total_ratio", "collective_count"):
            if chk.get("op") not in _OPS:
                raise ValueError(f"{where}: op {chk.get('op')!r} not in "
                                 f"{sorted(_OPS)}")
            resolve(chk.get("value", None), symbols)
        if kind == "collective_payload_ratio":
            resolve(chk.get("target", None), symbols)
            if chk.get("agg", "min") not in ("min", "max"):
                raise ValueError(f"{where}: agg {chk.get('agg')!r} must "
                                 "be 'min' or 'max'")
            if not isinstance(chk.get("family"), str):
                raise ValueError(f"{where}: collective_payload_ratio "
                                 "needs a 'family' string")
        if kind == "dot_flops":
            resolve(chk.get("width", None), symbols)
        if kind == "dot_flops_ratio":
            resolve(chk.get("target", None), symbols)
            resolve(chk.get("num_width", None), symbols)
            resolve(chk.get("den_width", None), symbols)
            for s in ("num_scale", "den_scale"):
                if s in chk:
                    resolve(chk[s], symbols)
        if kind == "collectives_subset" and not isinstance(
                chk.get("allowed"), list):
            raise ValueError(f"{where}: collectives_subset needs an "
                             "'allowed' family list")


def load_gate(path) -> Gate:
    raw = json.loads(pathlib.Path(path).read_text())
    validate_gate(raw, source=str(path))
    return Gate(raw["name"], raw["description"],
                {k: float(v) for k, v in raw.get("symbols", {}).items()},
                tuple(raw["programs"]), tuple(raw["checks"]))


def list_gates(directory=None) -> List[pathlib.Path]:
    d = pathlib.Path(directory) if directory else GATES_DIR
    return sorted(d.glob("*.json"))


@register("hlo")
def evaluate(gate: Gate, programs: Dict[str, StepStats], *,
             symbols: Optional[Dict[str, float]] = None
             ) -> Tuple[AnalysisReport, Dict[str, float]]:
    """Evaluate one gate against named recorded steps
    (``roofline.record``).  ``symbols`` overrides the gate's symbol table
    (so one gate serves both the bench config and a driver's reduced
    config).  Returns (report, measurements by check id)."""
    syms = {**gate.symbols, **(symbols or {})}
    rep = AnalysisReport(f"hlo:{gate.name}")
    measured: Dict[str, float] = {}
    for i, chk in enumerate(gate.checks):
        cid = chk.get("id", f"{chk['kind']}#{i}")
        subject = f"{gate.name}/{cid}"
        needed = [p for p in (chk.get("program"), chk.get("num_program"),
                              chk.get("den_program")) if p is not None]
        missing = [p for p in needed if p not in programs]
        if missing:
            rep.add(Severity.ERROR, "hlo.missing-program", subject,
                    f"gate needs program(s) {missing} but the caller "
                    f"supplied {sorted(programs)}")
            continue
        kind = chk["kind"]
        note = chk.get("note", "")
        if kind == "dot_flops":
            width = int(resolve(chk["width"], syms))
            val = ra.dot_flops_matching(programs[chk["program"]], width)
            measured[cid] = val
            want = resolve(chk["value"], syms)
            if _OPS[chk["op"]](val, want):
                rep.add(Severity.INFO, "hlo.dot_flops", subject,
                        f"dot FLOPs at width {width}: {val:.4g} "
                        f"{chk['op']} {want:.4g}")
            else:
                hist = ra.dot_flops_by_width(programs[chk["program"]])
                rep.add(Severity.ERROR, "hlo.dot_flops", subject,
                        f"dot FLOPs at width {width} = {val:.4g}, "
                        f"expected {chk['op']} {want:.4g}"
                        + (f" ({note})" if note else "")
                        + f"; width histogram: "
                        f"{ {k: round(v, 3) for k, v in sorted(hist.items())} }")
        elif kind == "dot_flops_ratio":
            nw = int(resolve(chk["num_width"], syms))
            dw = int(resolve(chk["den_width"], syms))
            num = ra.dot_flops_matching(programs[chk["num_program"]], nw)
            den = ra.dot_flops_matching(programs[chk["den_program"]], dw)
            num *= resolve(chk.get("num_scale", 1), syms)
            den *= resolve(chk.get("den_scale", 1), syms)
            target = resolve(chk["target"], syms)
            rtol = float(chk.get("rtol", 0.1))
            if den == 0:
                rep.add(Severity.ERROR, "hlo.dot_flops_ratio", subject,
                        f"denominator dots at width {dw} measure 0 FLOPs"
                        f" in {chk['den_program']!r}")
                continue
            ratio = num / den
            measured[cid] = ratio
            if (1 - rtol) * target <= ratio <= (1 + rtol) * target:
                rep.add(Severity.INFO, "hlo.dot_flops_ratio", subject,
                        f"ratio {ratio:.3f} within ±{rtol:.0%} of "
                        f"{target:g}")
            else:
                rep.add(Severity.ERROR, "hlo.dot_flops_ratio", subject,
                        f"ratio {ratio:.3f} outside ±{rtol:.0%} of "
                        f"target {target:g}"
                        + (f" ({note})" if note else ""))
        elif kind == "wire_total_ratio":
            num = sum(ra.wire_bytes_by_dtype(
                programs[chk["num_program"]]).values())
            den = sum(ra.wire_bytes_by_dtype(
                programs[chk["den_program"]]).values())
            if den == 0:
                rep.add(Severity.ERROR, "hlo.wire_total_ratio", subject,
                        f"baseline {chk['den_program']!r} has no "
                        "collective wire bytes")
                continue
            ratio = num / den
            measured[cid] = ratio
            want = resolve(chk["value"], syms)
            sev = (Severity.INFO if _OPS[chk["op"]](ratio, want)
                   else Severity.ERROR)
            rep.add(sev, "hlo.wire_total_ratio", subject,
                    f"wire ratio {ratio:.3f} vs {chk['op']} {want:g}"
                    + (f" ({note})" if note and sev else ""))
        elif kind == "wire_dtype":
            wires = ra.wire_bytes_by_dtype(programs[chk["program"]])
            val = wires.get(chk["dtype"], 0.0)
            measured[cid] = val
            want = resolve(chk["value"], syms)
            if _OPS[chk["op"]](val, want):
                rep.add(Severity.INFO, "hlo.wire_dtype", subject,
                        f"{chk['dtype']} wire bytes {val:.4g} "
                        f"{chk['op']} {want:g}")
            else:
                rep.add(Severity.ERROR, "hlo.wire_dtype", subject,
                        f"{chk['dtype']} wire bytes = {val:.4g}, "
                        f"expected {chk['op']} {want:g}"
                        + (f" ({note})" if note else "")
                        + f"; by dtype: "
                        f"{ {k: round(v) for k, v in sorted(wires.items())} }")
        elif kind == "family_dtype_wire":
            def fam_wire(rec):
                return sum(op.wire_bytes for op in ra.collective_ops(rec)
                           if op.family == chk["family"]
                           and op.dtype == chk["dtype"])
            val = fam_wire(programs[chk["program"]])
            if "den_program" in chk:
                den = fam_wire(programs[chk["den_program"]])
                if den == 0:
                    rep.add(Severity.ERROR, "hlo.family_dtype_wire",
                            subject,
                            f"baseline {chk['den_program']!r} has no "
                            f"{chk['family']} {chk['dtype']} wire bytes")
                    continue
                val = val / den
            measured[cid] = val
            want = resolve(chk["value"], syms)
            sev = (Severity.INFO if _OPS[chk["op"]](val, want)
                   else Severity.ERROR)
            rep.add(sev, "hlo.family_dtype_wire", subject,
                    f"{chk['family']}/{chk['dtype']}"
                    + ("-ratio" if "den_program" in chk else "")
                    + f" = {val:.4g} vs {chk['op']} {want:g}"
                    + (f" ({note})" if note and sev == Severity.ERROR
                       else ""))
        elif kind == "collective_count":
            fam = chk.get("family")
            ops = [op for op in ra.collective_ops(programs[chk["program"]])
                   if fam is None or op.family == fam]
            val = sum(op.count for op in ops)
            measured[cid] = val
            want = resolve(chk["value"], syms)
            label = fam or "all-families"
            if _OPS[chk["op"]](val, want):
                rep.add(Severity.INFO, "hlo.collective_count", subject,
                        f"{label} count {val:g} {chk['op']} {want:g}")
            else:
                by_fam = {}
                for op in ra.collective_ops(programs[chk["program"]]):
                    by_fam[op.family] = by_fam.get(op.family, 0) + op.count
                rep.add(Severity.ERROR, "hlo.collective_count", subject,
                        f"{label} count = {val:g}, expected {chk['op']} "
                        f"{want:g}" + (f" ({note})" if note else "")
                        + f"; by family: {by_fam}")
        elif kind == "collective_payload_ratio":
            fam = chk["family"]
            agg = min if chk.get("agg", "min") == "min" else max

            def fam_payload(rec):
                sizes = [op.payload_bytes
                         for op in ra.collective_ops(rec)
                         if op.family == fam]
                return agg(sizes) if sizes else None
            num = fam_payload(programs[chk["num_program"]])
            den = fam_payload(programs[chk["den_program"]])
            if num is None or den is None or den == 0:
                rep.add(Severity.ERROR, "hlo.collective_payload_ratio",
                        subject,
                        f"no {fam} collectives to compare "
                        f"(num={num}, den={den})")
                continue
            ratio = num / den
            measured[cid] = ratio
            target = resolve(chk["target"], syms)
            rtol = float(chk.get("rtol", 0.1))
            if (1 - rtol) * target <= ratio <= (1 + rtol) * target:
                rep.add(Severity.INFO, "hlo.collective_payload_ratio",
                        subject,
                        f"{chk.get('agg', 'min')} {fam} payload ratio "
                        f"{ratio:.3f} within ±{rtol:.0%} of {target:g}")
            else:
                rep.add(Severity.ERROR, "hlo.collective_payload_ratio",
                        subject,
                        f"{chk.get('agg', 'min')} {fam} payload ratio "
                        f"{ratio:.3f} outside ±{rtol:.0%} of "
                        f"target {target:g} (num={num:g} B, den={den:g} B)"
                        + (f" ({note})" if note else ""))
        elif kind == "collectives_subset":
            fams = ra.collective_families(programs[chk["program"]])
            extra = sorted(set(fams) - set(chk["allowed"]))
            measured[cid] = float(len(extra))
            if extra:
                rep.add(Severity.ERROR, "hlo.collectives_subset", subject,
                        f"unexpected collective families {extra} "
                        f"(allowed {sorted(chk['allowed'])}; wire bytes "
                        f"{ {k: round(v) for k, v in sorted(fams.items())} })"
                        " — an undeclared all-gather usually means "
                        "silent replication")
            else:
                rep.add(Severity.INFO, "hlo.collectives_subset", subject,
                        f"families {sorted(fams)} ⊆ "
                        f"{sorted(chk['allowed'])}")
    return rep, measured


def evaluate_file(path, programs: Dict[str, StepStats], *,
                  symbols: Optional[Dict[str, float]] = None
                  ) -> Tuple[AnalysisReport, Dict[str, float]]:
    return evaluate(load_gate(path), programs, symbols=symbols)
