"""Static-analysis passes over the compound runtime (the port's
counterpart of ``repro.analysis``):

* ``deadlock`` — the dispatch graph a :class:`WorkloadSpec` compiles to is
  acyclic;
* ``donation`` — no state tree shares memory where the in-place AdamW
  update would corrupt it (caught at ``install()``);
* ``affinity`` — one live worker thread and one CUDA stream of its own a
  section (statically, over a dispatch trace, and over a profiler trace).

``python -m repro_torch.analysis`` runs the build-time passes over the
registered workload specs.  The JAX package's ``hlo`` gates check
compiled collective programs and wait for the multi-device regimes
(ROADMAP.md, A6)."""
from repro_torch.analysis.core import (AnalysisReport, Finding, PASSES,
                                       Severity, register)
from repro_torch.analysis.affinity import (check_profile, check_trace,
                                           check_wiring, tracking)
from repro_torch.analysis.deadlock import (check_events, check_spec,
                                           model_events)
from repro_torch.analysis.donation import (AliasedStateError, lint_spec,
                                           lint_state, lint_step_fn)

__all__ = [
    "AnalysisReport", "Finding", "PASSES", "Severity", "register",
    "check_profile", "check_trace", "check_wiring", "tracking",
    "check_events", "check_spec", "model_events",
    "AliasedStateError", "lint_spec", "lint_state", "lint_step_fn",
]
