"""Declarative section-centric workload API (paper §3 end to end).
Counterpart of ``repro/core/workload.py``.

A compound workload *is* its section graph: each section carries its own
parallelism ``C^s``, execution mode and data-dependent activation, and
everything else — section devices, per-section workers and streams,
AdamW with a shared joint grad-norm, wavefront-ordered dispatch, the
realized timeline — is generic machinery:

* :class:`SectionSpec` — one section: arch + param specs + a plain
  ``fn(params, inputs) -> {port: tensor}`` (producer) or ``-> loss``
  (the critical loss section), a :class:`ParallelConfig`, mode
  (``fwd_bwd`` / ``fwd_only``), an optional per-sample activation
  predicate, and typed emit/consume ports.
* :class:`WorkloadSpec` — the sections plus the cross-section edges
  (implied by ``consumes``); validated at spec-compile time (port-type
  mismatches, cycles, cotangent routing, the dispatch-graph deadlock
  proof) before any device work.
* :class:`CompoundRuntime` — ONE generic runtime that runs any
  ``WorkloadSpec`` disaggregated; ``DistillRuntime`` and multi-teacher
  distillation are declarations on it.

Execution model (the JAX package's, in PyTorch):

* per microbatch, producer sections run ``fwd`` tasks on their own
  devices, recorded by no autograd (emitted ports pushed through the
  MessageQueue); the critical section computes loss + grads w.r.t. its
  params and any consumed ports from trainable producers with
  ``torch.autograd.grad`` (cotangents pushed back); trainable producers
  run ``bwd`` tasks that recompute their forward under autograd on their
  own worker and take the vector-Jacobian product with the pulled
  cotangent (the JAX package recomputes too);
* gradients accumulate into float32 zero-seeded lists in microbatch
  dispatch order, are divided by ``n_mb`` once, and per-section AdamW
  updates share one joint grad-norm across all trainable sections (the
  colocated clipping semantics — ``adamw.update(gnorm=)``);
* each trainable section's grad-finalize + AdamW update runs as an
  ``upd`` Dispatch on *that section's own worker*: the joint grad-norm is
  a small cross-worker rendezvous of per-leaf sum-of-squares vectors
  through the MessageQueue (pushed to every peer before any is pulled),
  reduced on the host in sorted section order, and per-section worker
  FIFO serializes ``upd(i)`` before that section's ``fwd(i+1)`` with no
  global barrier between iterations;
* iterations stream: ``install()`` adopts params/opts as runtime state,
  ``submit_iteration()`` enqueues one global batch onto the section
  streams (traffic scoped under a monotonic ``s<i>/`` namespace, evicted
  at retirement), ``retire()`` drains the oldest; ``lookahead`` bounds
  how many iterations may be in flight (0 ⇒ fully serialized);
  ``train_iteration()`` is the serialized wrapper;
* a section with an activation predicate simply emits no Dispatch for a
  microbatch none of whose samples activate it, and its consumers
  substitute the port's exact-zero fill.

Devices and streams (ROADMAP.md, port conventions): sections run on the
devices carved from ``devices=`` (one card named once per section shares
it; ``["cpu"] * n`` runs on the host), each from its own worker thread
and, on a card, its own CUDA stream.  What the main thread writes for an
iteration — its batch slices, consts, installed state — is ordered
before every section stream that reads it by an event recorded at
submit; cross-section tensors carry their producer stream's event
through the queue.  The optimizer updates in place (``optim/adamw.py``),
so ``train_iteration(params, opts, ...)`` advances the caller's
optimizer-state tensors.

Section meshes (``ranks=``): each section runs on its own ranks of the
default process group, one process a rank, with its own data degree
(paper: "each section independently configures its parallelism strategy,
micro-batch size, and data-parallel degree").  A rank runs only its
sections' tasks, on its rows of each microbatch (the reference is one
controller over every mesh; the port is MPMD):

* parameters and optimizer state rest as blocks under
  ``dist.sharding.param_shardings``/``opt_state_shardings`` (ZeRO), and
  each section's first task of an iteration gathers the full parameters;
* the critical section's loss on a rank is weighted by its share of the
  microbatch's mask total (1.0 on one data rank), so losses, gradients and
  cotangents sum over the data ranks to the global mean's; a loss whose
  terms are means over other masks weights them itself
  (``SectionSpec.loss_share``);
* ``upd`` reduce-scatters the float32 accumulators into the optimizer
  blocks (or, with ``grad_compress``, runs ``ef_compress_tree(...,
  mean=False)`` with a residual carried per section), runs AdamW on the
  blocks and all-gathers the new parameter blocks;
* the joint grad norm: each section's per-leaf sums of squares reduced
  over its ranks with each element counted once, exchanged between the
  trainable sections' origins and ranks, summed in sorted-section order —
  bitwise the colocated threshold on one rank;
* a port crosses to another section's ranks point to point: each producer
  rank sends its fragment to every consumer rank whose rows and sequence
  positions it overlaps, and cotangents go back the same way
  (``_Exchange``);
* a section whose ``seq`` axis is above 1 (``cp``) runs its tasks under
  ``dist.context.cp_attention_impl``: each of its ranks holds its data
  rows and its sequence columns -- dim 1 of every input, consumed port and
  emitted port, split evenly over ``seq``, but for an input or a consumed
  port declared whole (``seq_split=False``: every sequence rank takes it
  all, and the port's cotangent sums over them) -- and its gradients are
  summed over the data and sequence ranks (parameters are replicated over
  ``seq``);
* a section whose ``model`` axis is above 1 (``tp``) runs its tasks
  under Megatron tensor parallelism (``train.step.model_context``): each
  of its ranks gathers its heads and ``d_ff`` slices of the layer weights
  and every other leaf whole, and the ranks of one data and sequence
  coordinate hold the same rows, so only the one at model coordinate 0
  sends a port or a cotangent, to every model coordinate of the peer.
A ``pipe`` axis above 1 raises, as in the reference.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import affinity, donation
from repro_torch.analysis import deadlock as _deadlock
from repro_torch.core import cost_model as cmdl
from repro_torch.core.executor import Dispatch, mark_start, order_samples
from repro_torch.core.graph import SectionGraph
from repro_torch.core.messages import adopt
from repro_torch.core.runtime import MaestroRuntime
from repro_torch.core.scheduler import ScheduleResult
from repro_torch.core.types import (H100, ArchConfig, ParallelConfig,
                                    SectionConfig)
from repro_torch.dist import sharding as shd
from repro_torch.models import common as cm
from repro_torch.models.common import (tree_leaves, tree_like, tree_map,
                                       tree_unflatten)
from repro_torch.optim import adamw, schedules
from repro_torch.optim import compression as gcomp

#: symbolic sequence-length dim in Field / Port shapes, resolved to the
#: workload's seq_len at build time (static dims stay ints)
SEQ = "S"

_log = logging.getLogger("repro_torch.workload")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int32": torch.int32,
           "int64": torch.int64}


def _torch_dtype(dt) -> torch.dtype:
    return _DTYPES[dt] if isinstance(dt, str) else dt


def _resolve_shape(shape: Tuple, seq_len: Optional[int]) -> Tuple[int, ...]:
    out = []
    for d in shape:
        if d == SEQ:
            assert seq_len is not None, \
                "symbolic 'S' dim used but no seq_len bound yet"
            out.append(int(seq_len))
        else:
            out.append(int(d))
    return tuple(out)


@dataclass(frozen=True)
class Field:
    """One per-sample batch input of a section: shape WITHOUT the batch
    dim (entries int or the symbol :data:`SEQ`).  A section at cp > 1
    splits dim 1 over its sequence ranks; ``seq_split=False`` gives every
    sequence rank the whole of it (image slots that index the whole
    sequence)."""
    shape: Tuple
    dtype: Any = "float32"
    seq_split: bool = True


@dataclass(frozen=True)
class Port:
    """A typed cross-section tensor: per-sample shape + dtype.  The same
    ``Port`` object (or an equal one) must appear in the producer's
    ``emits`` and the consumer's ``consumes`` — a mismatch raises at
    spec-compile time."""
    name: str
    shape: Tuple
    dtype: Any = "float32"


@dataclass(frozen=True)
class Consume:
    """Consumer-side declaration of a cross-section edge: the producing
    section plus the *expected* :class:`Port` type.  ``seq_split=False``:
    a consumer at cp > 1 takes the port whole on each sequence rank (the
    MLLM's image embeddings), and the port's cotangent is the sum of the
    sequence ranks' cotangents."""
    section: str
    port: Port
    seq_split: bool = True

    @property
    def key(self) -> str:
        return f"{self.section}.{self.port.name}"


@dataclass(frozen=True)
class SectionSpec:
    """One section of a compound workload.

    ``fn(params, inputs) -> {port_name: tensor}`` for producers, or a
    scalar loss (``loss=True``; ``(loss, aux_scalars)`` with
    ``loss_aux=True``) for the critical section.  ``inputs`` holds, per
    microbatch of capacity ``mbs``, on the section's device:

    * every declared batch :class:`Field` ``[mbs, ...]`` — gathered to
      the activated samples (capacity layout, padded with sample 0) when
      the section has an ``activation`` predicate, sliced contiguously
      otherwise;
    * ``"act_valid"`` ``[mbs]`` float32 when the section has a predicate;
    * each consumed port under ``"<section>.<port>"``, plus
      ``"<section>.act_idx"`` (int64) / ``"<section>.act_valid"`` when
      that producer has a predicate (for scattering capacity rows back to
      sample slots);
    * every declared const under its name;
    * ``"loss_share"`` on section meshes when the section declares
      ``loss_share=True`` (see below).

    On section meshes the critical loss runs on each data rank's rows, so
    each rank's loss must be its share of the microbatch's global value.
    By default the runtime weights the whole loss by the rank's share of
    ``loss_mask`` (of the rows, without one), which is right for a mean
    over that mask.  A loss with a term that is a mean over another mask
    declares ``loss_share=True`` and weights its terms itself:
    ``inputs["loss_share"](*masks)`` returns, per mask, this rank's sum
    over the sum across the section's data ranks (exactly 1.0 on one data
    rank, 0 where the total is 0), and the fn multiplies each mean term by
    its mask's share.  Without meshes the key is absent and the fn takes
    its means as they are.
    """
    name: str
    arch: ArchConfig
    parallel: ParallelConfig
    fn: Callable[..., Any]
    params: Any                               # tree of ParamSpec
    inputs: Mapping[str, Field] = field(default_factory=dict)
    emits: Tuple[Port, ...] = ()
    consumes: Tuple[Consume, ...] = ()
    mode: str = "fwd_bwd"                     # "fwd_bwd" | "fwd_only"
    loss: bool = False
    loss_aux: bool = False
    activation: Optional[Callable[[Dict[str, np.ndarray]], np.ndarray]] = None
    critical: bool = False
    seq_len: Optional[int] = None             # section sequence length
    consts: Mapping[str, Field] = field(default_factory=dict)
    loss_share: bool = False

    @property
    def trainable(self) -> bool:
        return self.mode == "fwd_bwd"


@dataclass(frozen=True)
class WorkloadSpec:
    """A compound workload: sections + the edges implied by their
    ``consumes``.  ``global_batch`` / ``seq_len`` / ``mbs`` may be left
    ``None`` for shape-polymorphic workloads — the runtime then binds
    them from the first batch (``mbs=None`` ⇒ one microbatch per
    iteration)."""
    name: str
    sections: Tuple[SectionSpec, ...]
    seq_len: Optional[int] = None
    global_batch: Optional[int] = None
    mbs: Optional[int] = None

    def section(self, name: str) -> SectionSpec:
        for s in self.sections:
            if s.name == name:
                return s
        raise KeyError(name)

    @property
    def critical(self) -> SectionSpec:
        crits = [s for s in self.sections if s.critical]
        assert len(crits) == 1
        return crits[0]

    # ------------------------------------------------------------------ #
    def consumers_of(self, section: str, port: str) -> List[str]:
        return [s.name for s in self.sections
                if any(c.section == section and c.port.name == port
                       for c in s.consumes)]

    def topo_order(self) -> List[str]:
        """Section names, producers before consumers (Kahn)."""
        indeg = {s.name: 0 for s in self.sections}
        for s in self.sections:
            indeg[s.name] = len(s.consumes)
        order, ready = [], [n for n, d in sorted(indeg.items())
                            if d == 0]
        while ready:
            n = ready.pop(0)
            order.append(n)
            for s in self.sections:
                if any(c.section == n for c in s.consumes):
                    indeg[s.name] -= sum(
                        1 for c in s.consumes if c.section == n)
                    if indeg[s.name] == 0:
                        ready.append(s.name)
        if len(order) != len(self.sections):
            raise ValueError(
                f"workload {self.name!r}: section graph has a cycle "
                f"(resolved {order} of {[s.name for s in self.sections]})")
        return order

    # ------------------------------------------------------------------ #
    def validate(self) -> None:
        """Spec-compile-time checks: raise here, before any device is
        carved or any tensor made."""
        names = [s.name for s in self.sections]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate section names: {names}")
        crits = [s for s in self.sections if s.critical]
        if len(crits) != 1:
            raise ValueError(
                f"workload {self.name!r}: exactly one critical section "
                f"required, got {[s.name for s in crits]}")
        crit = crits[0]
        if not crit.loss or crit.mode != "fwd_bwd":
            raise ValueError(
                f"critical section {crit.name!r} must be a fwd_bwd loss "
                "section (loss=True)")
        if crit.activation is not None:
            raise ValueError(
                f"critical section {crit.name!r} cannot carry an "
                "activation predicate: the loss runs on every microbatch")
        by_name = {s.name: s for s in self.sections}
        for s in self.sections:
            if s.mode not in ("fwd_bwd", "fwd_only"):
                raise ValueError(
                    f"section {s.name!r}: unknown mode {s.mode!r}")
            if s.loss and s.mode == "fwd_only":
                raise ValueError(
                    f"section {s.name!r}: a loss section cannot be "
                    "fwd_only")
            if s.loss and not s.critical:
                raise ValueError(
                    f"section {s.name!r}: loss sections must be the "
                    "critical section")
            if not s.loss and not s.emits:
                raise ValueError(
                    f"section {s.name!r}: a non-loss section must emit "
                    "at least one port")
            pnames = [p.name for p in s.emits]
            if len(set(pnames)) != len(pnames):
                raise ValueError(
                    f"section {s.name!r}: duplicate emitted port names "
                    f"{pnames}")
            for c in s.consumes:
                if c.section == s.name:
                    raise ValueError(
                        f"section {s.name!r} consumes its own port "
                        f"{c.port.name!r}")
                src = by_name.get(c.section)
                if src is None:
                    raise ValueError(
                        f"section {s.name!r} consumes from unknown "
                        f"section {c.section!r}")
                emitted = {p.name: p for p in src.emits}
                if c.port.name not in emitted:
                    raise ValueError(
                        f"section {s.name!r} consumes port "
                        f"{c.port.name!r} which {c.section!r} does not "
                        f"emit (emits {sorted(emitted)})")
                got = emitted[c.port.name]
                if (tuple(got.shape) != tuple(c.port.shape)
                        or _torch_dtype(got.dtype)
                        != _torch_dtype(c.port.dtype)):
                    raise ValueError(
                        f"port type mismatch on edge {c.section!r} -> "
                        f"{s.name!r}: producer emits "
                        f"{c.port.name!r}{tuple(got.shape)}:{got.dtype} "
                        f"but consumer expects "
                        f"{tuple(c.port.shape)}:{c.port.dtype}")
            if len({(c.section, c.seq_split) for c in s.consumes}) != len(
                    {c.section for c in s.consumes}):
                raise ValueError(
                    f"section {s.name!r}: the ports it consumes from one "
                    "section must agree on seq_split (whole or split over "
                    "its sequence ranks)")
        # cotangent routing: a trainable producer's port must have exactly
        # one consumer (the bwd task pulls ONE cotangent per port), and
        # that consumer must itself be fwd_bwd — a fwd_only consumer
        # never pushes a cotangent back, so the producer's bwd task would
        # deadlock waiting on it
        for s in self.sections:
            if not s.trainable or s.critical:
                continue
            for p in s.emits:
                cons = self.consumers_of(s.name, p.name)
                if len(cons) != 1:
                    raise ValueError(
                        f"trainable section {s.name!r} port {p.name!r} "
                        f"must have exactly one consumer (cotangent "
                        f"routing), got {cons}")
                if by_name[cons[0]].mode != "fwd_bwd":
                    raise ValueError(
                        f"trainable section {s.name!r} port {p.name!r} "
                        f"is consumed by fwd_only section {cons[0]!r}, "
                        "which can never return a cotangent — the "
                        "producer's bwd task would deadlock; make the "
                        "consumer fwd_bwd or freeze the producer")
        if (self.global_batch is not None and self.mbs is not None
                and self.global_batch % self.mbs):
            raise ValueError(
                f"global_batch={self.global_batch} is not a multiple of "
                f"mbs={self.mbs}")
        self.topo_order()
        # dispatch-graph deadlock proof (repro_torch.analysis.deadlock):
        # the blocking-pull order submit_iteration will emit — incl. the
        # grad-norm rendezvous and lookahead cross-iteration FIFO
        # coupling — must be acyclic with every pull satisfiable
        _deadlock.check_spec(self, n_mb=2, lookahead=1).raise_on_error(
            ValueError,
            f"workload {self.name!r}: dispatch-graph deadlock analysis "
            "failed")

    # ------------------------------------------------------------------ #
    def to_graph(self) -> SectionGraph:
        """The cost-model / carving view of this workload."""
        g = SectionGraph()
        base_seq = self.seq_len
        for s in self.sections:
            scale = 1.0
            if s.seq_len is not None and base_seq:
                scale = s.seq_len / max(base_seq, 1)
            g.add(SectionConfig(s.name, s.arch, s.parallel,
                                trainable=s.trainable, critical=s.critical,
                                seq_scale=scale))
        for s in self.sections:
            for c in s.consumes:
                port = c.port
                width = int(port.shape[-1]) if port.shape and \
                    port.shape[-1] != SEQ else 1
                bpt = width * _torch_dtype(port.dtype).itemsize
                src_dp = self.section(c.section).parallel.dp
                fanout = (s.parallel.dp // src_dp
                          if src_dp and s.parallel.dp % src_dp == 0 else 1)
                g.connect(c.section, s.name, bytes_per_token=bpt,
                          fanout=fanout)
        g.validate()
        return g


# --------------------------------------------------------------------------- #
# Per-section parallelism validation
# --------------------------------------------------------------------------- #
#: ParallelConfig knob -> the JAX package's section-mesh axis it sizes
_AXES = (("dp", "data"), ("pp", "pipe"), ("cp", "seq"), ("tp", "model"))


def validate_section_parallel(name: str, arch: ArchConfig,
                              parallel: ParallelConfig, mesh=None) -> str:
    """ONE validation path for a section's ``C^s``.

    With ``mesh`` (the section's ``DeviceMesh``, or its ``{axis: size}``
    shape) it routes through ``train.step.parallel_regime``, the dispatch
    the sharded step uses: dp > 1, cp > 1, tp > 1 and ``grad_compress``
    run, cp x tp too; a ``pipe`` axis above 1 raises as in the reference (a
    section fn cannot be stage-partitioned), and so do the families the cp
    regime refuses.  Without one the
    section runs on one device (the plain regime), and every knob that
    needs a mesh raises, naming the section and the mesh axis it would
    size.  Returns the regime (``"plain"`` or ``"cp"``)."""
    if mesh is not None:
        from repro_torch.train.step import (_check_pp_cp_support,
                                            parallel_regime)
        try:
            regime = parallel_regime(mesh, parallel)
        except (ValueError, NotImplementedError) as e:
            raise type(e)(f"section {name!r}: {e}") from None
        if regime == "pp":
            raise NotImplementedError(
                f"section {name!r}: pipeline parallelism (mesh axis "
                f"{shd.AXIS_PIPE!r}={parallel.pp}) is not supported for "
                "declarative workload sections -- a section fn cannot be "
                "stage-partitioned by build_pp_loss; use dp/tp/cp for this "
                "section")
        try:
            _check_pp_cp_support(arch, regime)
        except NotImplementedError as e:
            raise NotImplementedError(f"section {name!r}: {e}") from None
        compress = parallel.grad_compress or "none"
        if compress not in gcomp.METHODS:
            raise ValueError(
                f"section {name!r}: grad_compress={compress!r}: expected "
                f"one of {gcomp.METHODS}")
        return regime
    multi = [f"{k}={getattr(parallel, k)} (mesh axis {axis!r})"
             for k, axis in _AXES if getattr(parallel, k) != 1]
    if multi:
        raise NotImplementedError(
            f"section {name!r} ({arch.name}): {', '.join(multi)} needs a "
            "section mesh: carve the runtime by ranks= (ROADMAP.md, A6.2; "
            "context and tensor parallel sections run there, A6.3 and "
            "A6.4)")
    if (parallel.grad_compress or "none") != "none":
        raise NotImplementedError(
            f"section {name!r}: grad_compress={parallel.grad_compress!r} "
            "compresses the data-parallel reduction of a section mesh: "
            "carve the runtime by ranks= (ROADMAP.md, A6.2)")
    return "plain"


def _mesh_sizes(parallel: ParallelConfig) -> Dict[str, int]:
    """The ``{axis: size}`` shape of the section mesh ``parallel`` asks
    for (``dist.sharding.section_mesh``'s axes)."""
    return {"data": parallel.dp, "pipe": parallel.pp, "seq": parallel.cp,
            "model": parallel.tp}


# --------------------------------------------------------------------------- #
# Iteration plan: wavefront order + per-section data-dependent activation
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class SectionActivation:
    """Which microbatches activate a section, and per-microbatch local
    indices/validity of the activating samples (capacity layout)."""
    active_mbs: Tuple[int, ...]
    idx: np.ndarray                   # [n_mb, mbs] int32 local indices
    valid: np.ndarray                 # [n_mb, mbs] f32, 1.0 = real sample


def build_activation(order: Sequence[int], flags: np.ndarray,
                     mbs: int) -> SectionActivation:
    """Per-microbatch activation layout of one section given the sample
    dispatch ``order`` and per-sample ``flags`` (original indexing)."""
    n = len(order)
    assert n % mbs == 0, (n, mbs)
    n_mb = n // mbs
    ordered = np.asarray(flags).astype(bool)[list(order)]
    idx = np.zeros((n_mb, mbs), np.int32)
    valid = np.zeros((n_mb, mbs), np.float32)
    active: List[int] = []
    for i in range(n_mb):
        loc = np.where(ordered[i * mbs:(i + 1) * mbs])[0]
        idx[i, :len(loc)] = loc
        valid[i, :len(loc)] = 1.0
        if len(loc):
            active.append(i)
    return SectionActivation(tuple(active), idx, valid)


def rows_capacity(idx: torch.Tensor, valid: torch.Tensor, lo: int,
                  n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One microbatch's capacity layout (``idx``, ``valid`` [m], from
    :func:`build_activation`) as a rank holding the microbatch's rows
    ``[lo, lo + n)`` sees it: the activated rows among its own first, in
    sample order, with indices local to its rows, padded to ``n`` rows with
    index 0 and ``valid = 0`` (the layout itself when the rank holds every
    row).  Tensor operations only: no host synchronisation, and fake
    tensors pass."""
    mine = (valid > 0) & (idx >= lo) & (idx < lo + n)
    order = torch.sort((~mine).to(torch.int8), stable=True).indices[:n]
    take = mine.index_select(0, order)
    local = idx.index_select(0, order) - lo
    return local * take, take.to(valid.dtype)


@dataclass(frozen=True)
class IterationPlan:
    """Host-side dispatch plan for one global batch."""
    order: Tuple[int, ...]
    mbs: int
    n_mb: int
    activation: Dict[str, SectionActivation]
    schedule: Optional[ScheduleResult] = None

    def section(self, name: str) -> Optional[SectionActivation]:
        """Section ``name``'s activation layout, None for a section that
        runs on every microbatch."""
        return self.activation.get(name)


# --------------------------------------------------------------------------- #
# The one generic compound runtime
# --------------------------------------------------------------------------- #
def _host_batch(batch) -> Dict[str, torch.Tensor]:
    """The batch as CPU tensors (numpy arrays and device tensors alike)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu()
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
    return out


def _numpy_view(host: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """numpy views of the host batch, for activation predicates."""
    return {k: v.numpy() for k, v in host.items()
            if v.dtype != torch.bfloat16}


def _grad_leaves(tree):
    """Leaves of ``tree`` as fresh autograd leaves sharing its storage."""
    return tree_map(lambda x: x.detach().requires_grad_(), tree)


def _grads(outputs, inputs, grad_outputs=None):
    """``torch.autograd.grad`` with a zero gradient (not None) for every
    input the outputs do not depend on."""
    pairs = [(o, g) for o, g in zip(outputs, grad_outputs or
                                    [None] * len(outputs))
             if o.requires_grad]
    got = [None] * len(inputs)
    if pairs:
        got = torch.autograd.grad(
            [o for o, _ in pairs], inputs,
            None if grad_outputs is None else [g for _, g in pairs],
            allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(got, inputs)]


def _accumulate(acc: Optional[List[torch.Tensor]], grads):
    """f32 zero-seeded accumulation in dispatch order (seeding with the
    raw param-dtype grad would double-round)."""
    with torch.no_grad():
        if acc is None:
            acc = [torch.zeros(g.shape, dtype=torch.float32,
                               device=g.device) for g in grads]
        for a, g in zip(acc, grads):
            a.add_(g.float())
    return acc


class _Inflight:
    """Host-side record of one submitted-not-yet-retired iteration."""

    __slots__ = ("seq", "scope", "step_idx", "plan", "return_grads",
                 "ctx", "acc", "crit_acc", "ready", "full")

    def __init__(self, seq: int, scope: str, step_idx, plan: IterationPlan,
                 return_grads: bool, trainable: Sequence[str]):
        self.seq = seq
        self.scope = scope
        self.step_idx = step_idx
        self.plan = plan
        self.return_grads = return_grads
        self.ctx: Dict[Tuple[str, int], Any] = {}
        self.acc: Dict[str, Dict[str, Any]] = {n: {"g": None}
                                               for n in trainable}
        self.crit_acc: Dict[str, Any] = {"loss": None, "aux": None}
        # device -> event on the main thread's stream after everything it
        # wrote for this iteration
        self.ready: Dict[torch.device, Any] = {}
        # section -> its full parameters, gathered from the blocks by the
        # section's first task of the iteration (section meshes)
        self.full: Dict[str, Any] = {}


class _Exchange:
    """One iteration's traffic with sections on other ranks (section
    meshes): which rows and sequence positions each rank holds, which
    ranks exchange what, in which order, and the sends and receives
    themselves.

    A section of data degree ``dp`` splits each microbatch of ``m`` rows
    into ``dp`` contiguous blocks, block ``d`` on its data rank ``d``; at
    context degree ``cp`` it also splits dim 1 of each port (length ``L``)
    into ``cp`` contiguous blocks, block ``c`` on its sequence rank ``c``.
    A producer's rows are its capacity rows when it has an activation
    predicate (valid rows first, in sample order), else the samples.  A
    consumer rank ``(r, b)`` needs the producer rows :meth:`need` names
    (always one contiguous range) and its own columns; each producer rank
    ``(q, a)`` sends its whole fragment to every consumer rank whose
    rectangle it overlaps (:meth:`pairs`), and a consumer rank sends each
    such producer rank the cotangent of that fragment, fragment-shaped.
    :meth:`messages` lists every send in its sender's order, so that a
    receiver posts its receives in that order (:meth:`expect`).  Where
    neither side splits the sequence, no column is sliced.  The ranks of a
    section at one data and sequence coordinate (its model ranks) hold the
    same rows: the one at model coordinate 0 sends, to every model rank of
    the peer."""

    def __init__(self, rt: "CompoundRuntime", plan: IterationPlan,
                 disp: Dict[str, set], it: str, timeout: float):
        self.rt, self.plan, self.disp = rt, plan, disp
        self.it, self.timeout = it, timeout
        self.m = plan.mbs
        self.q = rt.rt.queue

    # ---- rows and columns -------------------------------------------- #
    def own(self, name: str, d: int) -> Tuple[int, int]:
        n = self.m // self.rt._dp[name]
        return d * n, (d + 1) * n

    def cols(self, name: str, c: int, length: int) -> Tuple[int, int]:
        """Sequence rank ``c``'s positions ``[a, b)`` of a dim-1 length."""
        n = length // self.rt._cp[name]
        return c * n, (c + 1) * n

    def need(self, src: str, dst: str, i: int, r: int) -> Tuple[int, int]:
        """The producer rows ``[a, b)`` consumer data rank ``r`` takes."""
        act = self.plan.activation.get(src)
        lo, hi = self.own(dst, r)
        if act is None:
            return lo, hi
        if self.rt._dp[dst] == 1:
            return 0, self.m                 # the capacity layout as it is
        valid = act.valid[i] > 0
        rows = np.nonzero(valid & (act.idx[i] >= lo) & (act.idx[i] < hi))[0]
        if not len(rows):
            return 0, 0
        return int(rows[0]), int(rows[-1]) + 1

    def _whole(self, src: str, dst: str) -> bool:
        """Whether consumer ``dst`` takes ``src``'s ports whole on each of
        its sequence ranks (``Consume.seq_split=False``)."""
        return (src, dst) in self.rt._whole

    def _split(self, src: str, dst: str) -> bool:
        return self.rt._cp[src] > 1 or (self.rt._cp[dst] > 1
                                        and not self._whole(src, dst))

    def _dst_cols(self, src: str, dst: str, c: int,
                  length: int) -> Tuple[int, int]:
        """Consumer sequence rank ``c``'s positions of a port of ``src``
        of dim-1 length ``length``: all of them where it takes the port
        whole."""
        if self._whole(src, dst):
            return 0, length
        return self.cols(dst, c, length)

    def pairs(self, src: str, dst: str, i: int) -> List[Tuple[int, ...]]:
        """``(q, a, r, b)``: producer rank ``(q, a)`` and consumer rank
        ``(r, b)`` (data, sequence coordinates) whose rows and columns
        overlap (every column, for a consumer that takes the port
        whole)."""
        cp_s, cp_d = self.rt._cp[src], self.rt._cp[dst]
        whole = self._whole(src, dst)
        out = []
        for r in range(self.rt._dp[dst]):
            a, b = self.need(src, dst, i, r)
            for q in range(self.rt._dp[src]):
                q0, q1 = self.own(src, q)
                if max(a, q0) >= min(b, q1):
                    continue
                # columns overlap on a common grid of cp_s * cp_d blocks
                for sa in range(cp_s):
                    for sb in range(cp_d):
                        if whole or max(sa * cp_d, sb * cp_s) < min(
                                (sa + 1) * cp_d, (sb + 1) * cp_s):
                            out.append((q, sa, r, sb))
        return sorted(out)

    def local_capacity(self, src: str, dst: str, act: SectionActivation):
        """The capacity layout (``act_idx``, ``act_valid`` [n_mb, rows])
        of activated producer ``src`` as consumer ``dst`` sees it on this
        rank: the whole layout on one data rank, else the rows of its own
        samples, first, with indices local to its rows."""
        rt = self.rt
        if rt._dp[dst] == 1:
            return act.idx, act.valid
        n = self.m // rt._dp[dst]
        lo = rt._me[dst] * n
        idx = np.zeros((len(act.idx), n), np.int32)
        valid = np.zeros((len(act.idx), n), np.float32)
        for i in range(len(act.idx)):
            a, b = self.need(src, dst, i, rt._me[dst])
            idx[i, :b - a] = act.idx[i, a:b] - lo
            valid[i, :b - a] = 1.0
        return idx, valid

    # ---- the send order ---------------------------------------------- #
    def _shape(self, port: Port, name: str) -> Tuple[int, ...]:
        """One rank's fragment of ``port`` in section ``name``."""
        shp = _resolve_shape(tuple(port.shape), self.rt.S)
        if self.rt._cp[name] > 1:
            shp = (shp[0] // self.rt._cp[name],) + shp[1:]
        return (self.m // self.rt._dp[name],) + shp

    def messages(self, name: str):
        """Every message section ``name``'s ranks send in this iteration,
        in each rank's send order (its dispatch order): tuples ``(dst,
        key, sender's rank, receiver's rank, shape, dtype)``.  The senders
        below follow the same loops."""
        rt, disp, it = self.rt, self.disp, self.it
        s = rt.spec.section(name)

        def cts(i):
            for c in s.consumes:
                if c.key in rt._ct_keys(s) and i in disp[c.section]:
                    for q, a, r, b in self.pairs(c.section, name, i):
                        for m in range(rt._tp[c.section]):
                            yield (c.section, f"{it}/ct.{c.key}.{i}",
                                   rt._rank(name, r, b),
                                   rt._rank(c.section, q, a, m),
                                   self._shape(c.port, c.section),
                                   _torch_dtype(c.port.dtype))

        if name != rt._crit:
            for i in sorted(disp[name]):
                for p in s.emits:
                    for cname in rt.spec.consumers_of(name, p.name):
                        if i not in disp.get(cname, ()):
                            continue
                        for q, a, r, b in self.pairs(name, cname, i):
                            for m in range(rt._tp[cname]):
                                yield (cname, f"{it}/{name}.{p.name}.{i}",
                                       rt._rank(name, q, a),
                                       rt._rank(cname, r, b, m),
                                       self._shape(p, name),
                                       _torch_dtype(p.dtype))
        else:
            for i in range(self.plan.n_mb):
                yield from cts(i)
        if s.trainable and name != rt._crit:
            for i in sorted(disp[name]):
                yield from cts(i)
        if s.trainable:
            n_leaves = len(tree_leaves(s.params))
            for peer in rt._trainable:
                if peer != name:
                    for r in rt._ranks[peer]:
                        yield (peer, f"{it}/gnorm.{name}",
                               rt._ranks[name][0], r, (n_leaves,),
                               torch.float32)

    def expect(self) -> None:
        """Post this iteration's receives from sections on other ranks,
        in their senders' order."""
        rt = self.rt
        for name in rt._topo:
            if name in rt._device:
                continue
            for dst, key, src_r, dst_r, shape, dtype in self.messages(name):
                if dst in rt._device and dst_r == rt._rank_me:
                    self.q.expect(name, dst, key, src_r, shape, dtype)

    # ---- sends and receives ------------------------------------------ #
    def send_port(self, src: str, dst: str, key: str, i: int, value):
        """A producer rank's fragment to every consumer rank whose rows
        and columns it overlaps; the producer's origin counts the key
        once."""
        rt = self.rt
        me = (rt._me[src], rt._seq[src])
        for q, a, r, b in self.pairs(src, dst, i):
            if (q, a) == me and rt._mod[src] == 0:
                for m in range(rt._tp[dst]):
                    self.q.send(src, dst, key, value,
                                rank=rt._rank(dst, r, b, m))
        if rt._origin[src]:
            self.q.count_push(value)

    def recv_port(self, src: str, dst: str, ckey: str, i: int):
        """This rank's rows and columns of port ``ckey`` that ``src``'s
        ranks sent."""
        rt = self.rt
        me = (rt._me[dst], rt._seq[dst])
        senders = [(q, a) for q, a, r, b in self.pairs(src, dst, i)
                   if (r, b) == me]
        got = self.q.recv(src, dst, f"{self.it}/{ckey}.{i}",
                          [rt._rank(src, q, a) for q, a in senders],
                          timeout=self.timeout)
        shp, dt = rt._port_zero[dst][ckey]
        if not senders:
            return torch.zeros(shp, dtype=dt, device=rt._device[dst])
        qs = sorted({q for q, _ in senders})
        seqs = sorted({a for _, a in senders})
        rows = [torch.cat([got[rt._rank(src, q, a)] for a in seqs], dim=1)
                if len(seqs) > 1 else got[rt._rank(src, q, seqs[0])]
                for q in qs]
        frags = torch.cat(rows) if len(rows) > 1 else rows[0]
        a, b = self.need(src, dst, i, me[0])
        x = frags.narrow(0, a - self.own(src, qs[0])[0], b - a)
        if self._split(src, dst):
            length = frags.shape[1] * rt._cp[src] // len(seqs)
            c0, c1 = self._dst_cols(src, dst, me[1], length)
            x = x.narrow(1, c0 - self.cols(src, seqs[0], length)[0],
                         c1 - c0)
        if x.shape[0] < shp[0]:          # a consumer's capacity rows
            x = torch.cat([x, x.new_zeros((shp[0] - x.shape[0],)
                                          + tuple(x.shape[1:]))])
        return x

    def send_ct(self, name: str, c: Consume, i: int, g):
        """A consumer rank's cotangent of its rows and columns back to
        each producer rank whose fragment they overlap, fragment-shaped
        (zero outside the overlap)."""
        rt = self.rt
        me = (rt._me[name], rt._seq[name])
        key = f"{self.it}/ct.{c.key}.{i}"
        a, b = self.need(c.section, name, i, me[0])
        split = self._split(c.section, name)
        if split:
            length = g.shape[1] * (1 if self._whole(c.section, name)
                                   else rt._cp[name])
            m0, m1 = self._dst_cols(c.section, name, me[1], length)
        for q, sa, r, sb in self.pairs(c.section, name, i):
            if (r, sb) != me or rt._mod[name] != 0:
                continue
            q0, q1 = self.own(c.section, q)
            lo, hi = max(a, q0), min(b, q1)
            part = g.narrow(0, lo - a, hi - lo)
            shape = (q1 - q0,) + tuple(g.shape[1:])
            dst = (slice(lo - q0, hi - q0),)
            if split:
                p0, p1 = self.cols(c.section, sa, length)
                c0, c1 = max(m0, p0), min(m1, p1)
                part = part.narrow(1, c0 - m0, c1 - c0)
                shape = shape[:1] + (p1 - p0,) + shape[2:]
                dst = dst + (slice(c0 - p0, c1 - p0),)
            if tuple(part.shape) != shape:
                full = part.new_zeros(shape)
                full[dst] = part
                part = full
            for m in range(rt._tp[c.section]):
                self.q.send(name, c.section, key, part,
                            rank=rt._rank(c.section, q, sa, m))
        if rt._origin[name]:
            self.q.count_push(g)

    def recv_ct(self, name: str, p: Port, consumer: str, i: int):
        """The cotangent of this rank's fragment of ``p``: the sum of what
        the overlapping consumer ranks sent (zero where none did)."""
        rt = self.rt
        me = (rt._me[name], rt._seq[name])
        rs = [(r, b) for q, a, r, b in self.pairs(name, consumer, i)
              if (q, a) == me]
        got = self.q.recv(consumer, name, f"{self.it}/ct.{name}.{p.name}.{i}",
                          [rt._rank(consumer, r, b) for r, b in rs],
                          timeout=self.timeout)
        if not rs:
            return torch.zeros(self._shape(p, name),
                               dtype=_torch_dtype(p.dtype),
                               device=rt._device[name])
        parts = [got[rt._rank(consumer, r, b)] for r, b in rs]
        out = parts[0]
        for x in parts[1:]:
            out = out + x
        return out


class CompoundRuntime:
    """Run a :class:`WorkloadSpec` disaggregated on the compound executor.
    See the module docstring for the execution model.

    ``devices``: the device list the sections are carved from, in spec
    order (default: every visible card; name one card once per section
    to share it).  ``ranks``: carve section meshes over the default
    process group instead, each section taking the next
    ``parallel.devices`` ranks (see the module docstring, "Section
    meshes").  The cost model plans the wavefront order for the H100."""

    def __init__(self, spec: WorkloadSpec, *, devices=None, ranks=None,
                 lr_schedule=None,
                 opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                 lookahead: int = 0):
        spec.validate()
        self._mesh_mode = ranks is not None
        self._regime = {
            s.name: validate_section_parallel(
                s.name, s.arch, s.parallel,
                _mesh_sizes(s.parallel) if self._mesh_mode else None)
            for s in spec.sections}
        self.spec = spec
        self.opt_cfg = opt_cfg
        self.lr_fn = lr_schedule or functools.partial(schedules.constant,
                                                      peak_lr=1e-3)
        self.graph = spec.to_graph()
        self._compress = self._compressed_sections() if self._mesh_mode \
            else {}
        self.rt = MaestroRuntime(self.graph, devices, ranks=ranks)
        # section-stream affinity (repro_torch.analysis.affinity): one
        # live worker a local section, each on a CUDA stream of its own
        wiring = affinity.check_wiring(self.rt)
        if not wiring.ok:
            self.rt.shutdown()
        wiring.raise_on_error(
            RuntimeError,
            f"workload {spec.name!r}: section-stream affinity check failed")
        self.executor = self.rt.executor()
        self.last_execution = None
        #: cross-iteration pipelining depth: how many iterations beyond
        #: the oldest may be in flight at once (0 ⇒ serialized)
        self.lookahead = int(lookahead)
        self._session = self.executor.session()
        self._it_seq = 0
        self._inflight: "collections.deque[_Inflight]" = collections.deque()
        self._retired: "collections.deque[dict]" = collections.deque()
        self._params: Dict[str, Any] = {}
        self._opts: Dict[str, Any] = {}
        #: per compressed section: this rank's error-feedback residual,
        #: zero at the first install(), then carried by its upd task
        self._ef: Dict[str, Any] = {}
        self._installed = False
        self._topo = spec.topo_order()
        self._crit = spec.critical.name
        self._trainable = [s.name for s in spec.sections if s.trainable]
        self._local = list(self.rt.local_sections)
        self._device = {n: self.rt.device(n) for n in self._local}
        # per section: its ranks in mesh order (data major, then seq), its
        # data and context degrees, this rank's data and sequence
        # coordinates and whether it is the section's origin (one device a
        # section, rank 0 of its own, without meshes); the attention its
        # tasks run under
        self._ranks: Dict[str, List[int]] = {}
        self._dp: Dict[str, int] = {}
        self._cp: Dict[str, int] = {}
        self._tp: Dict[str, int] = {}
        self._me: Dict[str, int] = {}
        self._seq: Dict[str, int] = {}
        self._mod: Dict[str, int] = {}
        self._origin: Dict[str, bool] = {}
        self._attn: Dict[str, Any] = {}
        self._p_spec: Dict[str, Any] = {}
        self._c_spec: Dict[str, Any] = {}
        self._o_spec: Dict[str, Any] = {}
        self._rank_me = torch.distributed.get_rank() if self._mesh_mode \
            else 0
        # (producer, consumer) edges whose ports the consumer takes whole
        # on each of its sequence ranks (Consume.seq_split=False)
        self._whole = {(c.section, s.name) for s in spec.sections
                       for c in s.consumes if not c.seq_split}
        for s in spec.sections:
            self._attn[s.name] = contextlib.nullcontext
            if not self._mesh_mode:
                self._dp[s.name], self._me[s.name] = 1, 0
                self._cp[s.name], self._seq[s.name] = 1, 0
                self._tp[s.name], self._mod[s.name] = 1, 0
                self._origin[s.name] = True
                continue
            mesh = self.rt.mesh(s.name)
            self._ranks[s.name] = [int(r) for r in mesh.mesh.flatten()]
            self._dp[s.name], self._cp[s.name] = s.parallel.dp, s.parallel.cp
            self._tp[s.name] = s.parallel.tp
            coord = mesh.get_coordinate()
            if coord is not None:
                c = dict(zip(mesh.mesh_dim_names, coord))
                self._me[s.name] = int(c[shd.AXIS_DATA])
                self._seq[s.name] = int(c[shd.AXIS_SEQ])
                self._mod[s.name] = int(c[shd.AXIS_MODEL])
                self._origin[s.name] = all(int(x) == 0 for x in coord)
                from repro_torch.train.step import model_context
                self._attn[s.name], self._c_spec[s.name] = model_context(
                    s.arch, s.params, mesh, self._regime[s.name],
                    s.parallel, section=s.name)
            rules = shd.rules_for(s.arch, mesh, teacher=not s.trainable)
            self._p_spec[s.name] = shd.param_shardings(s.params, mesh, rules)
            if s.trainable:
                self._o_spec[s.name] = shd.opt_state_shardings(
                    s.params, mesh, rules)
        self._built: Optional[Tuple[int, int, int]] = None
        if spec.global_batch is not None and spec.seq_len is not None:
            self._build(spec.global_batch, spec.seq_len,
                        spec.mbs or spec.global_batch)

    def _rank(self, name: str, d: int, c: int = 0, m: int = 0) -> int:
        """The rank at data coordinate ``d``, sequence coordinate ``c`` and
        model coordinate ``m`` of section ``name``'s mesh."""
        return self._ranks[name][(d * self._cp[name] + c) * self._tp[name]
                                 + m]

    def _compressed_sections(self) -> Dict[str, str]:
        """The sections whose data-parallel reduction is compressed, and
        how (the reference's refusals)."""
        out = {}
        by = {x.name: x for x in self.spec.sections}
        for s in self.spec.sections:
            method = s.parallel.grad_compress or "none"
            if method == "none":
                continue
            if not s.trainable:
                raise ValueError(
                    f"section {s.name!r}: grad_compress on a fwd_only "
                    "section — frozen sections produce no gradients")
            if s.parallel.cp > 1 or s.parallel.tp > 1:
                raise NotImplementedError(
                    f"section {s.name!r}: grad_compress requires the plain "
                    "regime on a dp-only mesh — the compressed all-reduce "
                    "runs over the data axis alone and cannot take the cp "
                    "regime's sum over the seq axis or compose with tp")
            for c in s.consumes:
                if by[c.section].activation is not None:
                    raise NotImplementedError(
                        f"section {s.name!r}: grad_compress on a consumer "
                        f"of activation-predicated section {c.section!r} is "
                        "refused, as in the reference")
            out[s.name] = method
        return out

    # ------------------------------------------------------------------ #
    # params / optimizer state
    # ------------------------------------------------------------------ #
    @property
    def local_sections(self) -> List[str]:
        """The sections this process runs (all of them without meshes)."""
        return list(self._local)

    def init(self, seed: int = 0):
        """Init + place every local section's params (section ``i`` of the
        spec from a ``torch.Generator`` seeded ``seed + i`` on its device)
        and matching optimizer states for the trainable ones."""
        params = {}
        for i, s in enumerate(self.spec.sections):
            if s.name not in self._device:
                continue
            dev = self._device[s.name]
            gen = torch.Generator(device=dev).manual_seed(seed + i)
            params[s.name] = cm.init_params(s.params, gen, dev)
        return self.place(params)

    def place(self, params: Dict[str, Any]):
        """Move per-section param trees onto their sections' devices (a
        tree already there is taken as it is, not copied) and build
        matching optimizer states.  On section meshes the trees are full
        and this rank keeps its blocks (``dist.sharding.shard_tree`` under
        the section's parameter and ZeRO optimizer-state specs); sections
        not on this rank are left out."""
        placed, opts = {}, {}
        for n in params:
            if n not in self._device:
                continue
            full = tree_map(lambda x, d=self._device[n]: x.detach().to(d),
                            params[n])
            if not self._mesh_mode:
                placed[n] = full
                if n in self._trainable:
                    opts[n] = adamw.init(full)
                continue
            mesh = self.rt.mesh(n)
            placed[n] = shd.shard_tree(full, tree_like(full,
                                                       self._p_spec[n]), mesh)
            if n in self._trainable:
                opts[n] = adamw.init(shd.shard_tree(
                    full, tree_like(full, self._o_spec[n].master), mesh))
        return placed, opts

    # ------------------------------------------------------------------ #
    # shape binding
    # ------------------------------------------------------------------ #
    def _ensure_built(self, host: Dict[str, torch.Tensor]) -> None:
        B = None
        for s in self.spec.sections:
            for k in s.inputs:
                B = len(host[k])
                break
            if B is not None:
                break
        assert B is not None, "no section declares batch inputs"
        S = self.spec.seq_len
        if S is None:
            for s in self.spec.sections:
                for k, f in s.inputs.items():
                    if SEQ in tuple(f.shape):
                        S = int(host[k].shape[1 + tuple(f.shape).index(SEQ)])
                        break
                if S is not None:
                    break
        mbs = self.spec.mbs or B
        if self._built != (B, S or 0, mbs):
            self._build(B, S, mbs)

    def _build(self, global_batch: int, seq_len: Optional[int],
               mbs: int) -> None:
        assert global_batch % mbs == 0, (global_batch, mbs)
        if getattr(self, "_inflight", None):
            raise RuntimeError(
                "cannot rebind workload shapes with iterations in "
                "flight — drain() first")
        for s in self.spec.sections:
            if mbs % self._dp[s.name]:
                raise ValueError(
                    f"section {s.name!r}: the microbatch size ({mbs}) must "
                    f"divide its data axis ({self._dp[s.name]}) so that "
                    "every data rank owns a real slice of it")
            cp = self._cp[s.name]
            if cp == 1:
                continue
            sec_seq = s.seq_len if s.seq_len is not None else seq_len
            if sec_seq is None or sec_seq % cp:
                raise ValueError(
                    f"section {s.name!r}: sequence length {sec_seq} does "
                    f"not divide the mesh {shd.AXIS_SEQ!r} axis ({cp})")
            # every tensor a cp section's rank holds is split on dim 1,
            # but for those declared whole (seq_split=False)
            shapes = [(f"input {k!r}", f.shape) for k, f in s.inputs.items()
                      if f.seq_split]
            shapes += [(f"port {c.key!r}", c.port.shape) for c in s.consumes
                       if c.seq_split]
            shapes += [(f"port {p.name!r}", p.shape) for p in s.emits]
            for what, shp in shapes:
                dims = _resolve_shape(tuple(shp), seq_len)
                if not dims or dims[0] % cp:
                    raise ValueError(
                        f"section {s.name!r}: {what} of shape {dims} has no "
                        f"dim 1 that splits over the mesh "
                        f"{shd.AXIS_SEQ!r} axis ({cp})")
        self.B, self.S, self.mbs = global_batch, seq_len, mbs
        self.n_mb = global_batch // mbs

        def local(name, shape, split=True):
            dims = _resolve_shape(tuple(shape), seq_len)
            if self._cp[name] > 1 and split:
                dims = (dims[0] // self._cp[name],) + dims[1:]
            return (mbs // self._dp[name],) + dims
        # the exact-zero fill a consumer takes for an inactive producer,
        # at this rank's rows and columns
        self._port_zero: Dict[str, Dict[str, Tuple[Tuple[int, ...],
                                                   torch.dtype]]] = {
            s.name: {c.key: (local(s.name, c.port.shape, c.seq_split),
                             _torch_dtype(c.port.dtype))
                     for c in s.consumes}
            for s in self.spec.sections}
        self._built = (global_batch, seq_len or 0, mbs)

    # consumed keys whose cotangents matter (src is a trainable producer)
    def _ct_keys(self, s: SectionSpec) -> List[str]:
        by_name = {x.name: x for x in self.spec.sections}
        return [c.key for c in s.consumes
                if by_name[c.section].trainable]

    # ------------------------------------------------------------------ #
    # planning
    # ------------------------------------------------------------------ #
    def plan_iteration(self, host, *, reorder: bool = True) -> IterationPlan:
        """Activation predicates → cost-model 6-tuples → wavefront (or
        FIFO) sample order → per-section capacity layouts.  ``host`` is
        the batch (numpy arrays or tensors).  Every rank computes the same
        plan from the same batch."""
        assert self._built is not None, "runtime not shape-bound yet"
        view = _numpy_view(_host_batch(host))
        flags: Dict[str, np.ndarray] = {}
        n = None
        for s in self.spec.sections:
            if s.activation is not None:
                f = np.asarray(s.activation(view)).astype(bool)
                flags[s.name] = f
                n = len(f)
        if n is None:
            n = self.B
        assert n == self.B, (n, self.B)
        if not flags:
            # homogeneous batch: every order ties — skip the scheduler
            reorder = False
        samples = cmdl.sample_tuples(self.graph, flags, self.S or 1, n=n,
                                     hw=H100)
        order, sched = order_samples(samples, reorder=reorder)
        activation = {name: build_activation(order, f, self.mbs)
                      for name, f in flags.items()}
        return IterationPlan(tuple(order), self.mbs, self.n_mb,
                             activation, sched)

    def _dispatched(self, plan: IterationPlan) -> Dict[str, set]:
        """Effective per-microbatch dispatch sets: a producer runs on mb
        ``i`` iff its predicate activates AND some consumer of it is
        dispatched on ``i`` (work nobody pulls is never submitted)."""
        disp: Dict[str, set] = {self._crit: set(range(plan.n_mb))}
        for name in reversed(self._topo):
            if name == self._crit:
                continue
            s = self.spec.section(name)
            avail: set = set()
            for p in s.emits:
                for c in self.spec.consumers_of(name, p.name):
                    avail |= disp.get(c, set())
            act = plan.activation.get(name)
            mine = (set(act.active_mbs) if act is not None
                    else set(range(plan.n_mb)))
            disp[name] = mine & avail
        return disp

    # ------------------------------------------------------------------ #
    # streaming state: install / state
    # ------------------------------------------------------------------ #
    def install(self, params: Dict[str, Any],
                opts: Dict[str, Any]) -> None:
        """Adopt per-section params (every local section) and optimizer
        states (at least every local trainable section) as the runtime's
        streaming state: blocks on section meshes, as :meth:`place` gives
        them.  Worker-side ``upd`` tasks advance this state (the optimizer
        state in place); read it back with :meth:`state` or
        :meth:`blocks`.  Requires a quiescent runtime (nothing in
        flight)."""
        if self._inflight:
            raise RuntimeError(
                "install() requires a quiescent runtime — retire()/"
                "drain() the in-flight iterations first")
        params = {n: t for n, t in params.items() if n in self._device}
        opts = {n: t for n, t in opts.items() if n in self._device}
        missing = set(self._local) - set(params)
        if missing:
            raise ValueError(f"install: missing params for sections "
                             f"{sorted(missing)}")
        missing_o = {n for n in self._trainable if n in self._device} - set(
            opts)
        if missing_o:
            raise ValueError(f"install: missing optimizer state for "
                             f"trainable sections {sorted(missing_o)}")
        # aliasing lint (repro_torch.analysis.donation): the upd tasks
        # write each optimizer state in place, so state that shares memory
        # with another section's, or with its own parameters, would be
        # corrupted silently; refuse it here with a named error
        donation.lint_state(params, opts, runtime=self).raise_on_error(
            donation.AliasedStateError, "install: aliasing lint failed")
        for name in self._device:
            stream = self.rt.workers[name].stream
            if stream is None:
                continue
            # the section's stream reads (and frees) what the main thread
            # allocated: its memory must not return to the main stream's
            # pool while that stream's work is queued
            for x in tree_leaves(params[name]) + tree_leaves(
                    opts.get(name, {})):
                if isinstance(x, torch.Tensor) and x.is_cuda:
                    x.record_stream(stream)
        for name in self._compress:
            if name in self._device and name not in self._ef:
                self._ef[name] = tree_map(
                    lambda sp, d=self._device[name]: torch.zeros(
                        tuple(sp.shape), dtype=torch.float32, device=d),
                    tree_like(params[name], self.spec.section(name).params))
        self._params = dict(params)
        self._opts = dict(opts)
        self._installed = True

    def blocks(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """The current (params, opts) streaming state as held: this rank's
        blocks of its local sections on section meshes.  Only consistent
        across sections when nothing is in flight."""
        return dict(self._params), dict(self._opts)

    def state(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Snapshot of the current (params, opts) streaming state as full
        trees of the local sections.  On section meshes it gathers them
        (collective over each local section's ranks: all of them call it).
        Only consistent across sections when nothing is in flight."""
        if not self._mesh_mode:
            return self.blocks()
        params, opts = {}, {}
        for n, blocks in self._params.items():
            mesh = self.rt.mesh(n)
            with torch.no_grad():
                params[n] = shd.gather_tree(
                    blocks, tree_like(blocks, self._p_spec[n]), mesh)
                if n in self._opts:
                    o = self._opts[n]
                    sp = tree_like(o.master, self._o_spec[n].master)
                    opts[n] = adamw.AdamWState(
                        o.step, *(shd.gather_tree(t, sp, mesh)
                                  for t in (o.mu, o.nu, o.master)))
        return params, opts

    def transfer(self, src: str, dst: str, key: str, value, shape,
                 dtype) -> Optional[torch.Tensor]:
        """Hand a tensor that section ``src`` holds (``value``, None where
        ``src`` is not local) to every rank of section ``dst``: returns it
        on this rank's device where ``dst`` is local, else None.  On
        section meshes ``src``'s origin sends it point to point; every
        rank calls this, with nothing in flight."""
        if self._inflight:
            raise RuntimeError("transfer() requires a quiescent runtime")
        if dst not in self._device:
            if self._mesh_mode and src in self._device \
                    and self._origin[src]:
                for r in self._ranks[dst]:
                    self.rt.queue.send(src, dst, key, value, rank=r)
            return None
        if src in self._device:
            return value.to(self._device[dst])
        q = self.rt.queue
        origin = self._ranks[src][0]
        q.expect(src, dst, key, origin, tuple(shape), _torch_dtype(dtype))
        return q.recv(src, dst, key, [origin])[origin]

    def full_leaf(self, name: str, tree: Dict[str, Any], key: str
                  ) -> torch.Tensor:
        """Leaf ``key`` of section ``name``'s parameter tree whole: on
        section meshes gathered from this rank's blocks (every rank of the
        section calls this), else the leaf itself."""
        if not self._mesh_mode:
            return tree[key]
        with torch.no_grad():
            return shd.gather(tree[key], self._p_spec[name][key],
                              self.rt.mesh(name))

    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    # ------------------------------------------------------------------ #
    # section meshes: this rank's view of an iteration
    # ------------------------------------------------------------------ #
    def _row_axes(self, name: str) -> Tuple[str, ...]:
        """The axes over which section ``name``'s ranks hold different
        rows or columns, and its losses and gradients sum: data, and seq
        for a cp section.  Its model ranks hold the same ones."""
        return (shd.AXIS_DATA,) + ((shd.AXIS_SEQ,) if self._cp[name] > 1
                                   else ())
    def _full_params(self, name: str, rec: _Inflight):
        """The section's parameters for this iteration: its tree without
        meshes, else gathered once from the blocks by the first task that
        asks (every rank of the section runs the same tasks in the same
        order, so the gathers pair up) -- whole leaves, or this rank's
        tensor-parallel slices of them (``_c_spec``)."""
        if not self._mesh_mode:
            return self._params[name]
        full = rec.full.get(name)
        if full is None:
            blocks = self._params[name]
            mesh = self.rt.mesh(name)
            with torch.no_grad():
                full = tree_unflatten(blocks, [
                    shd.reshard(x, p, c, mesh) for x, p, c in zip(
                        tree_leaves(blocks),
                        tree_leaves(tree_like(blocks, self._p_spec[name])),
                        tree_leaves(tree_like(blocks, self._c_spec[name])))])
            rec.full[name] = full
        return full

    def _loss_weights(self, host, plan: IterationPlan) -> List[float]:
        """Per microbatch: the critical section's share of the mask total
        on this rank, n_local / n_all (exactly 1.0 on one rank).  Its loss
        is a mean over ``loss_mask`` (or over every token), so the weighted
        losses and gradients sum over the data and sequence ranks to the
        global mean's."""
        s = self.spec.critical
        m, lo = plan.mbs, self._me[s.name] * (plan.mbs // self._dp[s.name])
        hi = lo + plan.mbs // self._dp[s.name]
        order = np.asarray(plan.order)
        if "loss_mask" in s.inputs:
            mask = host["loss_mask"].double().numpy()[order]
        else:
            mask = np.ones((len(order), self._cp[s.name]))
        n = mask.shape[1] // self._cp[s.name]
        cols = slice(self._seq[s.name] * n, (self._seq[s.name] + 1) * n)
        out = []
        for i in range(plan.n_mb):
            mb = mask[i * m:(i + 1) * m].reshape(m, -1)
            total, mine = float(mb.sum()), float(mb[lo:hi, cols].sum())
            out.append(1.0 if mine == total else mine / total)
        return out

    def _loss_share(self, name: str):
        """``inputs["loss_share"]`` of a critical section that weights its
        own terms: per mask, this rank's sum over the sum across the
        section's data ranks (one all-reduce a call, on the calling
        worker's stream; every data rank calls it in the same order)."""
        mesh = self.rt.mesh(name)

        def share(*masks: torch.Tensor) -> torch.Tensor:
            with torch.no_grad():
                local = torch.stack([m.float().sum() for m in masks])
                total = shd.all_reduce_axes(local.clone(), mesh,
                                            self._row_axes(name))
                return local / torch.where(total > 0, total,
                                           torch.ones_like(total))
        return share

    # ------------------------------------------------------------------ #
    # one training iteration on the executor (streaming)
    # ------------------------------------------------------------------ #
    def submit_iteration(self, batch, step_idx, *,
                         reorder: bool = True,
                         plan: Optional[IterationPlan] = None,
                         consts: Optional[Dict[str, Dict[str, Any]]] = None,
                         return_grads: bool = False,
                         timeout: float = 300.0) -> int:
        """Enqueue one global-batch iteration onto the section streams
        and return its sequence number.  All tasks — including each
        trainable section's grad-finalize + AdamW ``upd`` — run on the
        section workers; the main thread only moves the iteration's
        inputs and consts onto the sections' devices and blocks beyond
        that only at the ``lookahead`` gate (when more than ``lookahead``
        iterations are already in flight, the oldest is retired first and
        its metrics buffered for the next :meth:`retire`).  On section
        meshes every rank submits the same batch; each dispatches its
        local sections' tasks on its rows."""
        assert self._installed, \
            "call install(params, opts) before submit_iteration()"
        while len(self._inflight) > self.lookahead:
            self._retired.append(self._retire_oldest(timeout=timeout))
        host = _host_batch(batch)
        self._ensure_built(host)
        if plan is None:
            plan = self.plan_iteration(host, reorder=reorder)
        assert plan.mbs == self.mbs and plan.n_mb == self.n_mb, \
            (plan.mbs, plan.n_mb, self.mbs, self.n_mb)
        by_name = {s.name: s for s in self.spec.sections}
        disp = self._dispatched(plan)
        m = plan.mbs
        q = self.rt.queue
        rec = _Inflight(self._it_seq, f"s{self._it_seq}", step_idx, plan,
                        return_grads, self._trainable)
        self._it_seq += 1
        it = rec.scope     # iteration-scoped tag namespace (evicted on
        #                    retirement: cross-iteration prefetch cannot
        #                    alias message keys across iterations)
        mesh_mode = self._mesh_mode
        ex = _Exchange(self, plan, disp, it, timeout)
        if mesh_mode:
            ex.expect()
            crit = self.spec.critical
            weights = share = None
            if crit.name in self._device:
                if crit.loss_share:
                    share = self._loss_share(crit.name)
                else:
                    weights = self._loss_weights(host, plan)

        # ---- main thread: every local section's inputs on its device --- #
        order_t = torch.as_tensor(plan.order, dtype=torch.int64)
        on_device: Dict[Tuple[str, torch.device], torch.Tensor] = {}

        def ordered(k: str, dev: torch.device) -> torch.Tensor:
            if (k, dev) not in on_device:
                on_device[(k, dev)] = host[k].index_select(
                    0, order_t).to(dev)
            return on_device[(k, dev)]

        prepared: Dict[str, Dict[int, Dict[str, Any]]] = {}
        for s in self.spec.sections:
            if s.name not in self._device:
                continue
            dev = self._device[s.name]
            mine = slice(*ex.own(s.name, self._me[s.name]))
            cp, sq = self._cp[s.name], self._seq[s.name]
            given = (consts or {}).get(s.name, {})
            missing = set(s.consts) - set(given)
            if missing:
                raise ValueError(
                    f"section {s.name!r}: missing consts "
                    f"{sorted(missing)}")
            placed_consts = {k: torch.as_tensor(given[k]).to(dev)
                             for k in s.consts}
            act = plan.activation.get(s.name)
            if act is not None:
                act_idx = torch.as_tensor(act.idx, dtype=torch.int64,
                                          device=dev)
                act_valid = torch.as_tensor(act.valid, device=dev)
            cons_act = {}
            for c in s.consumes:
                sa = plan.activation.get(c.section)
                if sa is not None:
                    idx, valid = ex.local_capacity(c.section, s.name, sa)
                    cons_act[c.section] = (
                        torch.as_tensor(idx, dtype=torch.int64, device=dev),
                        torch.as_tensor(valid, device=dev))
            per_mb: Dict[int, Dict[str, Any]] = {}
            for i in sorted(disp[s.name]):
                mb_rows = slice(i * m, (i + 1) * m)
                out = {}
                for k in s.inputs:
                    v = ordered(k, dev)[mb_rows]
                    if act is not None:
                        v = v.index_select(0, act_idx[i])
                    v = v[mine]
                    if cp > 1 and s.inputs[k].seq_split:
                        n = v.shape[1] // cp
                        v = v[:, sq * n:(sq + 1) * n]
                    out[k] = v
                if act is not None:
                    out["act_valid"] = act_valid[i][mine]
                for src, (idx_t, valid_t) in cons_act.items():
                    out[f"{src}.act_idx"] = idx_t[i]
                    out[f"{src}.act_valid"] = valid_t[i]
                out.update(placed_consts)
                per_mb[i] = out
            prepared[s.name] = per_mb
        for dev in set(self._device.values()):
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                rec.ready[dev] = ev

        def mb_inputs(s: SectionSpec, i: int) -> Dict[str, Any]:
            """The main thread's tensors for (section, mb), marked as in
            use by the calling worker's stream (which waited for them)."""
            return {k: adopt(v) for k, v in prepared[s.name][i].items()}

        def wait_main(name: str) -> None:
            ev = rec.ready.get(self._device[name])
            if ev is not None:
                torch.cuda.current_stream(self._device[name]).wait_event(ev)

        def pull_consumed(s: SectionSpec, i: int) -> Dict[str, Any]:
            dev = self._device[s.name]
            pulled, stalled = {}, False
            for c in s.consumes:
                key = f"{it}/{c.key}.{i}"
                if i not in disp.get(c.section, ()):
                    # inactive producer: the port's contribution is the
                    # exact zero a colocated step computes
                    shp, dt = self._port_zero[s.name][c.key]
                    pulled[c.key] = torch.zeros(shp, dtype=dt, device=dev)
                    continue
                if c.section in self._device:
                    pulled[c.key] = q.pull(c.section, s.name, key,
                                           device=dev, timeout=timeout)
                else:
                    pulled[c.key] = ex.recv_port(c.section, s.name, c.key, i)
                stalled = True
            if stalled:
                mark_start()      # dependency wait is idle, not busy
            return pulled

        def push_port(s: SectionSpec, cname: str, key: str, i: int, value):
            """A producer's port to consumer ``cname``, in process or to
            its ranks."""
            if cname in self._device:
                q.push(s.name, cname, key, value)
            else:
                ex.send_port(s.name, cname, key, i, value)

        def push_ct(s: SectionSpec, c: Consume, i: int, g):
            """A consumer's cotangent back to producer ``c.section``."""
            if c.section in self._device:
                q.push(s.name, c.section, f"{it}/ct.{c.key}.{i}", g)
            else:
                ex.send_ct(s.name, c, i, g)

        def pull_ct(s: SectionSpec, p: Port, consumer: str, i: int):
            if consumer in self._device:
                return q.pull(consumer, s.name,
                              f"{it}/ct.{s.name}.{p.name}.{i}",
                              device=self._device[s.name], timeout=timeout)
            return ex.recv_ct(s.name, p, consumer, i)

        def fwd_task(s: SectionSpec, i: int):
            def fn():
                pulled = pull_consumed(s, i)
                inputs = {**mb_inputs(s, i), **pulled}
                with torch.no_grad(), self._attn[s.name]():
                    out = s.fn(self._full_params(s.name, rec), inputs)
                if s.trainable:
                    rec.ctx[(s.name, i)] = inputs
                for p in s.emits:
                    for cname in self.spec.consumers_of(s.name, p.name):
                        if i in disp.get(cname, ()):
                            push_port(s, cname,
                                      f"{it}/{s.name}.{p.name}.{i}", i,
                                      out[p.name])
                return out
            return fn

        def crit_task(i: int):
            s = by_name[self._crit]
            ct_keys = self._ct_keys(s)

            def fn():
                pulled = pull_consumed(s, i)
                rest = {**mb_inputs(s, i),
                        **{k: v for k, v in pulled.items()
                           if k not in ct_keys}}
                params = _grad_leaves(self._full_params(s.name, rec))
                p_leaves = tree_leaves(params)
                cts = {k: pulled[k].detach().requires_grad_()
                       for k in ct_keys}
                if mesh_mode and share is not None:
                    rest["loss_share"] = share
                with self._attn[s.name]():
                    val = s.fn(params, {**rest, **cts})
                loss, aux = (val if s.loss_aux else (val, None))
                if mesh_mode and weights is not None:
                    # this rank's share of the microbatch's global mean
                    loss = loss * weights[i]
                    if aux is not None:
                        aux = {k: v * weights[i] for k, v in aux.items()}
                grads = _grads([loss], p_leaves + list(cts.values()))
                g_p, g_c = grads[:len(p_leaves)], dict(
                    zip(cts, grads[len(p_leaves):]))
                for c in s.consumes:
                    if c.key in g_c and i in disp.get(c.section, ()):
                        push_ct(s, c, i, g_c[c.key])
                loss = loss.detach()
                a = rec.crit_acc
                a["loss"] = (torch.zeros((), dtype=torch.float32,
                                         device=loss.device)
                             if a["loss"] is None else a["loss"]) + loss
                if aux is not None:
                    aux = {k: v.detach() for k, v in aux.items()}
                    a["aux"] = aux if a["aux"] is None else {
                        k: a["aux"][k] + v for k, v in aux.items()}
                rec.acc[s.name]["g"] = _accumulate(rec.acc[s.name]["g"],
                                                   g_p)
                return loss
            return fn

        def bwd_task(s: SectionSpec, i: int):
            ct_keys = self._ct_keys(s)

            def fn():
                cts = {}
                for p in s.emits:
                    consumer = self.spec.consumers_of(s.name, p.name)[0]
                    cts[p.name] = pull_ct(s, p, consumer, i)
                mark_start()
                inputs = rec.ctx.pop((s.name, i))
                # the vjp recomputes the forward under autograd, here on
                # the producer's worker and stream
                params = _grad_leaves(self._full_params(s.name, rec))
                p_leaves = tree_leaves(params)
                cin = {k: inputs[k].detach().requires_grad_()
                       for k in ct_keys}
                with self._attn[s.name]():
                    out = s.fn(params, {**inputs, **cin})
                names = list(cts)
                grads = _grads([out[n] for n in names],
                               p_leaves + list(cin.values()),
                               [cts[n] for n in names])
                g_p = grads[:len(p_leaves)]
                g_c = dict(zip(cin, grads[len(p_leaves):]))
                for c in s.consumes:
                    if c.key in g_c and i in disp.get(c.section, ()):
                        push_ct(s, c, i, g_c[c.key])
                rec.acc[s.name]["g"] = _accumulate(rec.acc[s.name]["g"],
                                                   g_p)
                return True
            return fn

        n_mb = plan.n_mb
        trainable = list(self._trainable)

        def exchange_norms(name: str, vec: torch.Tensor) -> Dict[str, Any]:
            """Joint grad-norm rendezvous: every trainable section hands
            its per-leaf sum-of-squares vector to every peer BEFORE taking
            any (pushes never block → no wait cycle), then all of them
            reduce the identical host vector in sorted-section order —
            bitwise the one global clip threshold of a colocated step.  A
            peer on other ranks gets it from the section's origin."""
            peers = [n for n in trainable if n != name]
            for p in peers:
                key = f"{it}/gnorm.{name}"
                if p in self._device:
                    q.push(name, p, key, vec)
                elif self._origin[name]:
                    for r in self._ranks[p]:
                        q.send(name, p, key, vec, rank=r)
                    q.count_push(vec)
            vecs = {name: vec.cpu().numpy()}
            for p in peers:
                key = f"{it}/gnorm.{p}"
                if p in self._device:
                    got = q.pull(p, name, key, timeout=timeout)
                else:
                    origin = self._ranks[p][0]
                    got = q.recv(p, name, key, [origin],
                                 timeout=timeout)[origin]
                vecs[p] = got.cpu().numpy()
            if peers:
                mark_start()   # rendezvous wait is idle, not busy
            return vecs

        def finalize_plain(name: str, g):
            """Device carving: the f32 accumulators → mean gradients in
            the parameters' dtypes, and their per-leaf sums of squares."""
            leaves = tree_leaves(self._params[name])
            if g is None:      # section never dispatched: zero
                g = [torch.zeros(x.shape, dtype=torch.float32,
                                 device=x.device) for x in leaves]
            gs = [(a / n_mb).to(x.dtype) for a, x in zip(g, leaves)]
            return gs, torch.stack([x.float().square().sum() for x in gs])

        def finalize_mesh(name: str, g):
            """Section meshes: the f32 accumulators reduced over the data
            ranks into this rank's optimizer-state blocks (compressed when
            the section asks), and per-leaf sums of squares over the
            section with each element counted once."""
            blocks = self._params[name]
            leaves = tree_leaves(blocks)
            mesh = self.rt.mesh(name)
            o_list = tree_leaves(tree_like(blocks,
                                           self._o_spec[name].master))
            pspecs = tree_leaves(tree_like(blocks,
                                           self.spec.section(name).params))
            dev = self._device[name]
            have = tree_leaves(tree_like(blocks, self._c_spec[name]))
            if g is None:
                g = [torch.zeros(tuple(sp.shape), dtype=torch.float32,
                                 device=dev) for sp in pspecs]
                have = [None] * len(g)
            if name in self._compress:
                red, ef = gcomp.ef_compress_tree(
                    tree_unflatten(blocks, [a / n_mb for a in g]),
                    gcomp.ErrorFeedback(self._ef[name]),
                    mesh.get_group(shd.AXIS_DATA), self._compress[name],
                    mean=False)
                self._ef[name] = ef.residual
                gs = [shd.shard(r.to(x.dtype), o, mesh) for r, o, x in
                      zip(tree_leaves(red), o_list, leaves)]
            else:
                # parameters are replicated over seq: a cp section's
                # gradients sum over its sequence ranks too
                gs = [(shd.reduce_to(a, o, mesh, self._row_axes(name),
                                     have=h) / n_mb).to(x.dtype)
                      for a, o, x, h in zip(g, o_list, leaves, have)]
            vec = torch.stack([
                x.float().square().sum() if shd.counted_here(o, mesh)
                else torch.zeros((), dtype=torch.float32, device=dev)
                for x, o in zip(gs, o_list)])
            shd.all_reduce_mesh(vec, mesh)
            return gs, vec

        def upd_task(name: str):
            def fn():
                rec.full.pop(name, None)       # the gathered parameters
                params = self._params[name]
                with torch.no_grad():
                    g = rec.acc[name]["g"]
                    # the f32 accumulators (4 bytes a parameter) are not
                    # read again: free them before the update's temporaries
                    rec.acc[name]["g"] = None
                    gs, vec = (finalize_mesh if mesh_mode
                               else finalize_plain)(name, g)
                    del g
                    vecs = exchange_norms(name, vec)
                    gnorm = torch.sqrt(torch.from_numpy(np.concatenate(
                        [vecs[n] for n in sorted(vecs)])).sum()).to(
                            self._device[name])
                grads = tree_unflatten(params, gs)
                lr = self.lr_fn(rec.step_idx)
                if self.opt_cfg.clip_norm > 0:
                    p2, o2, _ = adamw.update(grads, self._opts[name], lr,
                                             self.opt_cfg, gnorm=gnorm)
                else:
                    p2, o2, _ = adamw.update(grads, self._opts[name], lr,
                                             self.opt_cfg)
                out = {"grad_norm": gnorm, "lr": lr}
                if mesh_mode:
                    mesh = self.rt.mesh(name)
                    specs = tree_leaves(tree_like(params, self._p_spec[name]))
                    o_sp = tree_leaves(tree_like(
                        params, self._o_spec[name].master))
                    with torch.no_grad():
                        p2 = tree_unflatten(params, [
                            shd.reshard(x, o, sp, mesh) for x, o, sp in
                            zip(tree_leaves(p2), o_sp, specs)])
                        if rec.return_grads:
                            grads = tree_unflatten(params, [
                                shd.gather(x, o, mesh) for x, o in
                                zip(gs, o_sp)])
                self._params[name], self._opts[name] = p2, o2
                if rec.return_grads:
                    out["grads"] = grads
                if name == self._crit:
                    a = rec.crit_acc
                    keys = sorted(a["aux"] or {})
                    packed = torch.stack(
                        [a["loss"]] + [a["aux"][k].float() for k in keys])
                    if mesh_mode:
                        shd.all_reduce_axes(packed, self.rt.mesh(name),
                                            self._row_axes(name))
                    vals = [(v / n_mb).float() for v in packed.unbind(0)]
                    out["loss"] = vals[0]
                    if a["aux"] is not None:
                        out["aux"] = dict(zip(keys, vals[1:]))
                return out
            return fn

        def on_stream(name: str, fn):
            """Order the task after the main thread's writes."""
            def run():
                wait_main(name)
                return fn()
            return run

        dispatches: List[Dispatch] = []
        for name in self._topo:
            if name == self._crit:
                continue
            s = by_name[name]
            for i in sorted(disp[name]):
                dispatches.append(Dispatch(name, f"fwd{i}", on_stream(
                    name, fwd_task(s, i))))
        for i in range(plan.n_mb):
            dispatches.append(Dispatch(self._crit, f"mb{i}", on_stream(
                self._crit, crit_task(i))))
        for name in reversed(self._topo):
            s = by_name[name]
            if name == self._crit or not s.trainable:
                continue
            for i in sorted(disp[name]):
                dispatches.append(Dispatch(name, f"bwd{i}", on_stream(
                    name, bwd_task(s, i))))
        # grad-finalize + AdamW run on each trainable section's OWN worker:
        # the per-section FIFO serializes update(i) before that section's
        # fwd(i+1) while other sections stream ahead independently
        for name in self._topo:
            if by_name[name].trainable:
                dispatches.append(Dispatch(name, "upd", on_stream(
                    name, upd_task(name))))
        # a rank dispatches its local sections' tasks only (the executor
        # drops the others)
        self._session.submit(rec.seq, dispatches)
        self._inflight.append(rec)
        return rec.seq

    # ------------------------------------------------------------------ #
    # retirement: collect one iteration's metrics
    # ------------------------------------------------------------------ #
    def _retire_oldest(self, *, timeout: float = 300.0) -> dict:
        rec = self._inflight.popleft()
        try:
            execution = self._session.retire(rec.seq, timeout=timeout)
        finally:
            rec.full.clear()
            if self.rt.queue.transport is not None:
                self.rt.queue.transport.settle(rec.scope)
            leftovers = self.rt.queue.evict_scope(rec.scope)
            if leftovers:
                _log.warning(
                    "iteration %s retired with undrained messages "
                    "(producer pushed, no consumer pulled): %s",
                    rec.step_idx, leftovers)
        self.last_execution = execution
        upd = {n: execution.results[(n, "upd")] for n in self._trainable
               if n in self._device}
        metrics = {"lr": self.lr_fn(rec.step_idx), "execution": execution,
                   "plan": rec.plan, "n_tasks": execution.task_counts}
        # the critical section's metrics where it runs; the joint grad
        # norm from any local trainable section (every one has it)
        first = upd.get(self._crit) or next(iter(upd.values()), None)
        if first is not None:
            metrics.update(grad_norm=first["grad_norm"], lr=first["lr"])
        crit = upd.get(self._crit)
        if crit is not None:
            metrics["loss"] = crit["loss"]
            for k, v in crit.get("aux", {}).items():
                metrics[k] = v
        if rec.return_grads:
            metrics["grads"] = {n: u["grads"] for n, u in upd.items()}
        return metrics

    def retire(self, *, timeout: float = 300.0) -> dict:
        """Block until the oldest outstanding iteration completes and
        return its metrics dict (loss / joint grad_norm / lr / aux
        scalars / realized ``execution`` timeline / ``plan`` /
        per-section ``n_tasks``).  Iterations auto-retired by the
        lookahead gate are returned first, in order.  On section meshes a
        rank reports what its sections computed: the loss where the
        critical section runs, the grad norm where a trainable one does."""
        if self._retired:
            return self._retired.popleft()
        if not self._inflight:
            raise RuntimeError("retire(): no iteration in flight")
        return self._retire_oldest(timeout=timeout)

    def drain(self, *, timeout: float = 300.0) -> List[dict]:
        """Retire every outstanding iteration (oldest first); returns
        their metrics in submission order.  Leaves the runtime quiescent
        — required before ``install()`` or shape rebinding."""
        out = []
        while self._retired:
            out.append(self._retired.popleft())
        while self._inflight:
            out.append(self._retire_oldest(timeout=timeout))
        return out

    # ------------------------------------------------------------------ #
    # serialized compatibility wrapper
    # ------------------------------------------------------------------ #
    def train_iteration(self, params, opts, batch, step_idx, *,
                        reorder: bool = True,
                        plan: Optional[IterationPlan] = None,
                        consts: Optional[Dict[str, Dict[str, Any]]] = None,
                        return_grads: bool = False,
                        timeout: float = 300.0):
        """One serialized global-batch iteration: ``install`` the given
        state, ``submit_iteration``, ``retire``, and return ``(params,
        opts, metrics)`` as :meth:`blocks` holds them.  Exactly the
        streaming path at lookahead depth 0 — there is no second execution
        mode.  ``opts``' tensors are updated in place."""
        if self._inflight or self._retired:
            raise RuntimeError(
                "train_iteration() is the serialized wrapper; it cannot "
                "interleave with in-flight submit_iteration()/retire() "
                "streams — drain() first")
        self.install(params, opts)
        self.submit_iteration(batch, step_idx, reorder=reorder, plan=plan,
                              consts=consts, return_grads=return_grads,
                              timeout=timeout)
        metrics = self.retire(timeout=timeout)
        new_params, new_opts = self.blocks()
        return new_params, new_opts, metrics

    # ------------------------------------------------------------------ #
    def shutdown(self):
        self.rt.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
