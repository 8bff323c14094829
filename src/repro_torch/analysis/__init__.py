"""Static-analysis passes over the compound runtime (the port's
counterpart of ``repro.analysis``):

* ``deadlock`` — the dispatch graph a :class:`WorkloadSpec` compiles to is
  acyclic;
* ``donation`` — no state tree shares memory where the in-place AdamW
  update would corrupt it (caught at ``install()``);
* ``affinity`` — one live worker thread and one CUDA stream of its own a
  section (statically, over a dispatch trace, and over a profiler trace).

* ``hlo`` — declarative gates (``hlo_gates``, files under ``gates/``) on
  the collective and matmul profile of recorded steps
  (``roofline.record``), the port's counterpart of the JAX package's
  gates on compiled HLO.

``python -m repro_torch.analysis`` runs the build-time passes over the
registered workload specs."""
from repro_torch.analysis.core import (AnalysisReport, Finding, PASSES,
                                       Severity, register)
from repro_torch.analysis.affinity import (check_profile, check_trace,
                                           check_wiring, tracking)
from repro_torch.analysis.deadlock import (check_events, check_spec,
                                           model_events)
from repro_torch.analysis.donation import (AliasedStateError, lint_spec,
                                           lint_state, lint_step_fn)
from repro_torch.analysis import hlo_gates

__all__ = [
    "AnalysisReport", "Finding", "PASSES", "Severity", "register",
    "check_profile", "check_trace", "check_wiring", "tracking",
    "check_events", "check_spec", "model_events",
    "AliasedStateError", "lint_spec", "lint_state", "lint_step_fn",
    "hlo_gates",
]
