"""Compound-workload configurations (the paper's own workload shapes),
pairing assigned archs into Maestro section graphs.  The port's own copy
of ``repro/configs/compound.py``.

These are *workloads*, not single archs: each entry builds a SectionGraph
via the §3.1 construction rules.
"""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.core.graph import (SectionGraph, build_distill_graph,
                                    build_vlm_graph)
from repro_torch.models.vlm import vit_config


def vlm_compound(lm_name: str = "qwen2.5-32b") -> SectionGraph:
    """ViT encoder section (CP-heavy) → LM backbone (critical)."""
    lm = get_config(lm_name)
    vit = vit_config(out_dim=lm.d_model)
    g = build_vlm_graph(vit, lm)
    g.sections["vit"] = g.sections["vit"].replace(seq_scale=0.5)
    return g


def distill_compound(teacher_name: str = "mixtral-8x22b",
                     student_name: str = "moonshot-v1-16b-a3b",
                     fanout: int = 1) -> SectionGraph:
    """Frozen teacher → trainable student with output-layer colocation."""
    return build_distill_graph(get_config(teacher_name),
                               get_config(student_name), fanout=fanout)


def self_distill_compound(name: str = "granite-3-8b") -> SectionGraph:
    cfg = get_config(name)
    return build_distill_graph(cfg, cfg)


COMPOUND = {
    "vlm_compound": vlm_compound,
    "distill_compound": distill_compound,
    "self_distill_compound": self_distill_compound,
}
