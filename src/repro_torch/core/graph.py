"""Section graph construction (paper §3.1).  The port's own copy of
``repro/core/graph.py``.

A :class:`SectionGraph` is a DAG of :class:`SectionConfig` nodes with
data-flow edges.  Construction rules:

* one section per logically independent component (default);
* **KD output-layer colocation**: the teacher's final output layer is
  colocated with the student section, so only hidden states (d_model) cross
  the boundary instead of logits (vocab ≫ d_model) — realized by the
  ``hidden_handoff`` edge attribute + the chunked-vocab ``distill_kl``
  kernel on the student side;
* **mutually-exclusive encoder colocation**: modality encoders of similar
  size that are (almost) never active on the same sample share a section.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.types import ArchConfig, ParallelConfig, SectionConfig


@dataclass(frozen=True)
class Edge:
    src: str
    dst: str
    hidden_handoff: bool = False     # transfer hidden states, not logits
    bytes_per_token: int = 0         # cross-section traffic estimate
    fanout: int = 1                  # DP^src * fanout = DP^dst


@dataclass
class SectionGraph:
    sections: Dict[str, SectionConfig] = field(default_factory=dict)
    edges: List[Edge] = field(default_factory=list)

    def add(self, section: SectionConfig) -> "SectionGraph":
        assert section.name not in self.sections, section.name
        self.sections[section.name] = section
        return self

    def connect(self, src: str, dst: str, **kw) -> "SectionGraph":
        assert src in self.sections and dst in self.sections
        self.edges.append(Edge(src, dst, **kw))
        return self

    @property
    def critical(self) -> SectionConfig:
        crits = [s for s in self.sections.values() if s.critical]
        assert len(crits) == 1, "exactly one critical section required"
        return crits[0]

    def producers_of(self, name: str) -> List[Edge]:
        return [e for e in self.edges if e.dst == name]

    def consumers_of(self, name: str) -> List[Edge]:
        return [e for e in self.edges if e.src == name]

    def validate(self) -> None:
        names = set(self.sections)
        for e in self.edges:
            assert e.src in names and e.dst in names
        # acyclic check (Kahn)
        indeg = {n: 0 for n in names}
        for e in self.edges:
            indeg[e.dst] += 1
        order, queue = [], [n for n in names if indeg[n] == 0]
        while queue:
            n = queue.pop()
            order.append(n)
            for e in self.consumers_of(n):
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    queue.append(e.dst)
        assert len(order) == len(names), "section graph has a cycle"
        _ = self.critical


# --------------------------------------------------------------------------- #
# Construction rules
# --------------------------------------------------------------------------- #
def build_distill_graph(teacher: ArchConfig, student: ArchConfig, *,
                        fanout: int = 1,
                        teacher_parallel: Optional[ParallelConfig] = None,
                        student_parallel: Optional[ParallelConfig] = None
                        ) -> SectionGraph:
    """KD: frozen teacher (forward-only) → trainable student (critical).

    Per §3.1 the teacher's output layer is colocated with the student:
    the edge carries hidden states (d_model · bytes), not logits
    (vocab · bytes) — a vocab/d_model ≈ 62× traffic reduction for
    Qwen3.5-scale vocabularies."""
    g = SectionGraph()
    g.add(SectionConfig("teacher", teacher,
                        teacher_parallel or ParallelConfig(),
                        trainable=False))
    g.add(SectionConfig("student", student,
                        student_parallel or ParallelConfig(),
                        trainable=True, critical=True))
    g.connect("teacher", "student", hidden_handoff=True,
              bytes_per_token=teacher.d_model * 2, fanout=fanout)
    g.validate()
    return g


def build_vlm_graph(vit: ArchConfig, lm: ArchConfig, *, fanout: int = 1,
                    vit_parallel: Optional[ParallelConfig] = None,
                    lm_parallel: Optional[ParallelConfig] = None
                    ) -> SectionGraph:
    """VLM: ViT encoder section (CP-heavy, long visual-token sequences) →
    LLM backbone (critical).  The default ViT ``cp=2`` is the paper's; it
    runs on section meshes (``ranks=``, ROADMAP.md A6.3), and a runtime
    carved by devices, one device a section, takes ``vit_parallel``."""
    g = SectionGraph()
    g.add(SectionConfig("vit", vit,
                        vit_parallel or ParallelConfig(cp=2),
                        trainable=True))
    g.add(SectionConfig("llm", lm, lm_parallel or ParallelConfig(),
                        trainable=True, critical=True))
    g.connect("vit", "llm", bytes_per_token=lm.d_model * 2, fanout=fanout)
    g.validate()
    return g


def maybe_colocate_exclusive(g: SectionGraph, a: str, b: str, *,
                             coactivation_rate: float,
                             size_ratio_tol: float = 2.0,
                             rate_tol: float = 0.05) -> SectionGraph:
    """§3.1 omni-modal rule: encoders that are (almost) mutually exclusive
    and of comparable size share one section (resource-fragmentation fix).

    Returns a new graph with `a`+`b` merged when the rule applies."""
    sa, sb = g.sections[a], g.sections[b]
    ratio = max(sa.arch.total_params(), sb.arch.total_params()) / max(
        min(sa.arch.total_params(), sb.arch.total_params()), 1)
    if coactivation_rate > rate_tol or ratio > size_ratio_tol:
        return g
    merged = SectionConfig(f"{a}+{b}", sa.arch, sa.parallel,
                           trainable=sa.trainable or sb.trainable,
                           critical=sa.critical or sb.critical,
                           seq_scale=max(sa.seq_scale, sb.seq_scale))
    out = SectionGraph()
    out.add(merged)
    for name, s in g.sections.items():
        if name not in (a, b):
            out.add(s)
    for e in g.edges:
        src = merged.name if e.src in (a, b) else e.src
        dst = merged.name if e.dst in (a, b) else e.dst
        if src != dst:
            out.connect(src, dst, hidden_handoff=e.hidden_handoff,
                        bytes_per_token=e.bytes_per_token, fanout=e.fanout)
    out.validate()
    return out
