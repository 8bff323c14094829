"""Static-analysis passes over the compound runtime's workload specs (the
port's counterpart of ``repro.analysis``): ``deadlock`` proves the
dispatch graph a :class:`WorkloadSpec` compiles to acyclic."""
from repro_torch.analysis.core import (AnalysisReport, Finding, PASSES,
                                       Severity, register)
from repro_torch.analysis.deadlock import (check_events, check_spec,
                                           model_events)

__all__ = [
    "AnalysisReport", "Finding", "PASSES", "Severity", "register",
    "check_events", "check_spec", "model_events",
]
