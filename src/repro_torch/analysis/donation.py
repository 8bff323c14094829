"""In-place state aliasing linter (analysis pass ``donation``).
Counterpart of ``repro/analysis/donation.py``.

The JAX package donates each section's optimizer state to its update
jit and lints the state trees for the hazards of donation.  The port has
no donation, but its AdamW writes ``mu``, ``nu`` and ``master`` in place
(``optim/adamw.py``), which has the same hazards: a tensor that two
trajectories share is advanced twice a step, and an optimizer leaf that
aliases a parameter overwrites it.  So this pass reports, as ERRORs that
name the tree and the leaf path:

* **self-alias** — two leaves of one tree that share memory (one tensor
  reached twice, or overlapping views of one storage);
* **cross-section alias** — a leaf of one section's optimizer state that
  shares memory with any leaf of another section's parameters or state:
  one section's ``upd`` task would write the other's tensors;
* **params alias** — an optimizer leaf (``master``, ``mu``, ``nu``) that
  shares memory with the section's own parameters (``adamw.init`` copies
  for exactly this reason).

Memory is shared when two tensors' byte ranges in one storage overlap
(``untyped_storage().data_ptr()`` plus offset and strides, per device).
The JAX package's ``reuse`` check (a donated, deleted buffer handed back)
has no counterpart: a PyTorch tensor is not deleted under its holder.

``CompoundRuntime.install`` raises :class:`AliasedStateError` on any
ERROR.  The runtime's update signature (which task updates which state
in place) is reported as INFO.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.analysis.core import AnalysisReport, Severity, register
from repro_torch.models.common import flatten_with_path


class AliasedStateError(ValueError):
    """State handed to ``CompoundRuntime.install`` shares memory where an
    in-place update would corrupt it."""


def _span(t: torch.Tensor):
    """(device, first byte, one past the last byte) of a tensor's memory,
    or None for a tensor without any."""
    if t.is_meta or t.numel() == 0:
        return None
    item = t.element_size()
    start = t.untyped_storage().data_ptr() + t.storage_offset() * item
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return str(t.device), start, start + (last + 1) * item


def _spans(tree, label: str) -> List[Tuple[Tuple, str]]:
    out = []
    for path, leaf in flatten_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            sp = _span(leaf)
            if sp is not None:
                out.append((sp, f"{label}.{path}" if path else label))
    return out


def _overlaps(spans) -> List[Tuple[str, str]]:
    """Every pair of labels whose spans overlap on one device."""
    pairs = []
    live: List[Tuple[Tuple, str]] = []
    for sp, label in sorted(spans):
        live = [(s, lab) for s, lab in live if s[0] == sp[0] and s[2] > sp[1]]
        pairs += [(lab, label) for _, lab in live]
        live.append((sp, label))
    return pairs


def _tree_of(label: str) -> str:
    return label.split(".", 1)[0]


def _signature(runtime) -> Dict[str, str]:
    return {name: "upd task: AdamW updates mu, nu, master and step of "
                  "its optimizer state in place"
            for name in getattr(runtime, "_trainable", [])}


@register("donation")
def lint_state(params: Dict[str, Any], opts: Dict[str, Any], *,
               runtime=None, passname: str = "donation") -> AnalysisReport:
    """Lint per-section state trees about to enter the in-place update
    trajectory.  ``runtime`` (a ``CompoundRuntime``) is optional and only
    adds the update-signature INFO findings."""
    rep = AnalysisReport(passname)
    if runtime is not None:
        for name, sig in sorted(_signature(runtime).items()):
            rep.add(Severity.INFO, "donation.signature", name, sig)
    trees = {f"{what}[{name}]": tree
             for what, group in (("params", params), ("opts", opts))
             for name, tree in group.items()}
    # (1) one tree reaching the same memory twice
    for label, tree in trees.items():
        for a, b in _overlaps(_spans(tree, label)):
            rep.add(Severity.ERROR, "donation.self-alias", label,
                    f"{a} and {b} share memory: an in-place update of one "
                    "writes the other")
    # (2) an optimizer state sharing memory with another section's trees,
    # (3) or with its own section's parameters
    spans = [s for label, tree in trees.items() for s in _spans(tree, label)]
    for a, b in _overlaps(spans):
        ta, tb = _tree_of(a), _tree_of(b)
        if ta == tb:
            continue                       # reported by (1)
        if not ta.startswith("opts[") and tb.startswith("opts["):
            a, b, ta, tb = b, a, tb, ta
        if not ta.startswith("opts["):
            continue                       # params are never written in place
        sec_a, sec_b = ta[5:-1], tb[tb.index("[") + 1:-1]
        if sec_a != sec_b:
            rep.add(Severity.ERROR, "donation.cross-section-alias", a,
                    f"shares memory with {b}: section {sec_a!r}'s in-place "
                    f"update would write section {sec_b!r}'s state")
        else:
            rep.add(Severity.ERROR, "donation.params-alias", a,
                    f"optimizer state leaf shares memory with {b}: the "
                    "in-place update would overwrite the live parameters "
                    "(adamw.init copies for exactly this reason)")
    return rep


def lint_spec(spec, passname: str = "donation") -> AnalysisReport:
    """The in-place update signature a :class:`WorkloadSpec` implies:
    which sections' ``upd`` tasks the generic runtime will run.  Pure
    INFO, without building a runtime (used by the CLI)."""
    rep = AnalysisReport(passname)
    for s in spec.sections:
        rep.add(Severity.INFO, "donation.signature", s.name,
                "upd task: AdamW updates its optimizer state in place"
                if s.trainable else "fwd_only: no in-place update")
    return rep


def lint_step_fn(step_fn, passname: str = "donation") -> AnalysisReport:
    """Lint a built train step's in-place metadata
    (``train.step.build_train_step`` attaches ``_in_place``, the indices
    of the arguments it updates in place): INFO when declared, WARNING
    for a step with no declaration, whose callers cannot know which
    arguments it writes."""
    rep = AnalysisReport(passname)
    args = getattr(step_fn, "_in_place", None)
    label = getattr(step_fn, "_in_place_label", type(step_fn).__name__)
    if args is None:
        rep.add(Severity.WARNING, "donation.undeclared", label,
                "step carries no _in_place metadata — aliasing hazards of "
                "its arguments cannot be linted")
    else:
        rep.add(Severity.INFO, "donation.signature", label,
                f"updates argnums {tuple(args)} in place")
    return rep
