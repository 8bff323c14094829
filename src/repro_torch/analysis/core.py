"""Common core of the static-analysis suite: findings, reports, passes.
The port's own copy of ``repro/analysis/core.py``.

* :class:`Finding` — one diagnosed fact, with a severity, a stable
  ``check`` identifier (``"deadlock.cycle"``, ...), the subject it names
  (a section, an edge) and a human message.
* :class:`AnalysisReport` — an ordered list of findings plus helpers to
  partition by severity and to ``raise_on_error`` with a message that
  quotes every error finding (``WorkloadSpec.validate`` uses this).
* :data:`PASSES` — the registry mapping pass names to callables.

The port has the JAX package's ``deadlock``, ``donation``, ``affinity``
and ``hlo`` passes, the middle two recast for in-place updates and CUDA
streams and the last for recorded steps in place of compiled HLO.

Severity model:

* ``ERROR`` — a proven invariant violation (the workload deadlocks).
  Integration points raise.
* ``WARNING`` — suspicious but not proven fatal (a key pushed twice on
  one edge).
* ``INFO`` — a checked fact recorded for the report.  Never fails
  anything.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class Severity(enum.IntEnum):
    """Ordered so ``max(findings)`` is the report verdict."""
    INFO = 0
    WARNING = 1
    ERROR = 2


@dataclass(frozen=True)
class Finding:
    """One diagnosed fact about the workload / runtime / compiled HLO."""
    severity: Severity
    check: str                 # stable id, e.g. "deadlock.cycle"
    subject: str               # what it names: section, edge, gate id
    message: str

    def __str__(self) -> str:
        return (f"[{self.severity.name}] {self.check} ({self.subject}): "
                f"{self.message}")


@dataclass
class AnalysisReport:
    """Findings of one pass (or a merge of several)."""
    passname: str
    findings: List[Finding] = field(default_factory=list)

    def add(self, severity: Severity, check: str, subject: str,
            message: str) -> Finding:
        f = Finding(severity, check, subject, message)
        self.findings.append(f)
        return f

    def extend(self, other: "AnalysisReport") -> None:
        self.findings.extend(other.findings)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == Severity.ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == Severity.WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def summary(self) -> str:
        n = {s: 0 for s in Severity}
        for f in self.findings:
            n[f.severity] += 1
        return (f"{self.passname}: {n[Severity.ERROR]} error(s), "
                f"{n[Severity.WARNING]} warning(s), "
                f"{n[Severity.INFO]} info")

    def render(self, *, min_severity: Severity = Severity.INFO) -> str:
        lines = [self.summary()]
        lines += [f"  {f}" for f in self.findings
                  if f.severity >= min_severity]
        return "\n".join(lines)

    def raise_on_error(self, exc_type=ValueError,
                       prefix: Optional[str] = None) -> None:
        """Raise ``exc_type`` quoting every ERROR finding (no-op when
        clean) — the build-time gate used by ``WorkloadSpec.validate``."""
        errs = self.errors
        if not errs:
            return
        head = prefix or f"{self.passname} failed"
        body = "\n".join(f"  {f}" for f in errs)
        raise exc_type(f"{head}:\n{body}")


#: pass registry: name -> callable returning an AnalysisReport.  The
#: callables take pass-specific arguments.
PASSES: Dict[str, Callable[..., AnalysisReport]] = {}


def register(name: str):
    """Decorator: register an analysis pass under ``name``."""
    def deco(fn):
        PASSES[name] = fn
        return fn
    return deco
