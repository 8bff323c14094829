"""A recorded step: what one call of a step does on this rank, in place of
the compiled HLO text the reference's roofline and gates read.

:class:`StepRecorder` is a ``TorchDispatchMode``.  Around one call of a
step (``with StepRecorder(args) as rec: out = step(*args)``, then
``rec.finish(out)``) it logs every aten and ``c10d`` operation the call
dispatches:

* every collective (``c10d.allreduce_``, ``allgather_``,
  ``reduce_scatter_``, ``alltoall_base_``, ``send``, ``recv_``,
  ``broadcast_``, ...) as a :class:`CollectiveOp`: its family in the
  reference's names (``all-reduce``, ``all-gather``, ``reduce-scatter``,
  ``all-to-all``) or the port's own (``send``, ``recv``, ``broadcast``),
  the element dtype of its payload (``float32``, ``bfloat16``, ``int8``,
  ...), the payload and result bytes and the size of its process group,
  with the ring model's wire bytes (``roofline.analysis._ring_wire``);
* every operation in PyTorch's flop registry (``torch.utils.flop_counter``:
  ``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions and the port's
  kernel ops ``repro_torch::flash_fwd``, ``::flash_bwd``,
  ``::distill_kl_fwd``, ``::ssd_fwd`` and ``::ssd_bwd``, which register
  their own counts) as a matmul-class op
  with its output's last dim and FLOPs, and so are ``matmul`` and
  two-operand ``einsum``, which reach the mode whole under inference mode;
* an element count of every pointwise operation (one FLOP an output
  element, as the reference counts an HLO elementwise op) and of every
  reduction (one an input element), and the transcendental ones apart;
* the bytes each non-view operation reads and writes, un-fused;
* peak live device bytes: the step's arguments (every storage reachable
  from ``args``), plus the storages the call creates, held live while any
  tensor in Python or C++ (autograd's saved tensors included) still
  points at them (``StorageWeakRef``), sampled after every operation.  The
  reference's ``memory_analysis`` fields follow from that:
  ``argument_size_in_bytes``, ``output_size_in_bytes`` (the result's
  storages), ``alias_size_in_bytes`` (the result's storages that are
  arguments: a cache written in place) and ``temp_size_in_bytes`` (the
  created peak less the created outputs), so that ``argument + temp +
  output - alias`` is the predicted peak.

Run under ``FakeTensorMode`` on fake meta tensors and a fake process group
(``launch.dryrun``), nothing is allocated or sent: the kernel ops give
their shape functions' outputs and the collectives return at once.  A
storage freed inside one operation (a kernel's scratch) is not seen.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

#: ``c10d`` op name -> the family the gates name it by
FAMILIES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "send", "recv_": "recv", "recv_any_source_": "recv",
    "broadcast_": "broadcast", "reduce_": "reduce",
    "gather_": "gather", "scatter_": "scatter",
}

_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "pow",
                   "softplus", "silu", "gelu", "_softmax", "_log_softmax",
                   "logsumexp"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp",
               "var", "std", "prod", "norm", "linalg_vector_norm",
               "_softmax", "_log_softmax", "cumsum", "argmax", "any", "all"}


@dataclass
class CollectiveOp:
    """One collective with its ring-model wire cost (the reference's
    fields; ``count`` is 1: a recorded op ran once)."""
    family: str
    dtype: str
    group_size: int
    payload_bytes: float        # per-device buffer the op moves
    wire_bytes: float           # ring model: bytes on the wire per device
    count: float = 1.0


@dataclass
class DotOp:
    """One matmul-class op: its output's last dim and its FLOPs."""
    op: str
    width: int
    flops: float


@dataclass
class StepStats:
    """The recorded step: the port's counterpart of ``HloStats`` (per
    device, since a rank's tensors are its blocks)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    transcendental: float = 0.0
    collectives: List[CollectiveOp] = field(default_factory=list)
    dots: List[DotOp] = field(default_factory=list)
    memory: Dict[str, int] = field(default_factory=dict)
    kernel_bytes: float = 0.0   # the bytes the repro_torch kernel ops move
    ops: int = 0

    def to_json(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "transcendental": self.transcendental,
                "kernel_bytes": self.kernel_bytes, "ops": self.ops,
                "memory": dict(self.memory),
                "collectives": [vars(c) for c in self.collectives],
                "dots": [vars(d) for d in self.dots]}

    @classmethod
    def from_json(cls, d: dict) -> "StepStats":
        return cls(flops=d["flops"], hbm_bytes=d["hbm_bytes"],
                   transcendental=d["transcendental"],
                   kernel_bytes=d.get("kernel_bytes", 0.0),
                   ops=d.get("ops", 0), memory=dict(d["memory"]),
                   collectives=[CollectiveOp(**c) for c in d["collectives"]],
                   dots=[DotOp(**x) for x in d["dots"]])


def dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _storage(x: torch.Tensor):
    st = x.untyped_storage()
    return StorageWeakRef(st), st.nbytes()


def _matmul_flops(a, b, out) -> float:
    """``aten.matmul``, which reaches a dispatch mode whole under
    inference mode (it is decomposed into ``mm``/``bmm`` only where
    autograd records): 2 K per output element."""
    return 2.0 * out.numel() * a.shape[-1]


def _einsum_flops(eq: str, ops) -> float:
    """``aten.einsum`` (whole under inference mode, as ``matmul``): 2 x the
    product of every index's size, for two operands."""
    lhs = eq.replace(" ", "").split("->")[0].split(",")
    size = {}
    for term, x in zip(lhs, ops):
        for ch, n in zip(term, x.shape):
            size[ch] = n
    n = 1
    for v in size.values():
        n *= v
    return 2.0 * n if len(ops) == 2 else 0.0


#: ops whose FLOPs PyTorch's registry does not count (see above)
_COMPOSITE_FLOPS = {
    "matmul": lambda args, out: _matmul_flops(args[0], args[1], out),
    "einsum": lambda args, out: _einsum_flops(args[0], args[1]),
}


def _group_size(args) -> int:
    from torch._C._distributed_c10d import ProcessGroup
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a).size()
            except (RuntimeError, TypeError):
                continue
    return 1


def _collective(name: str, args) -> CollectiveOp:
    from repro_torch.roofline.analysis import _ring_wire
    family = FAMILIES[name]
    n = _group_size(args)
    lists = [a for a in args if isinstance(a, (list, tuple))]
    flat = [a for a in args if isinstance(a, torch.Tensor)]
    if name in ("allgather_", "reduce_scatter_", "alltoall_"):
        outs, ins = _tensors(lists[0]), _tensors(lists[1])
    elif name in ("_allgather_base_", "_reduce_scatter_base_",
                  "alltoall_base_"):
        outs, ins = [flat[0]], [flat[1]]
    else:
        ins = _tensors(lists[0]) if lists else flat[:1]
        outs = ins
    operand = float(sum(_nbytes(x) for x in ins))
    result = float(sum(_nbytes(x) for x in outs))
    wire = _ring_wire(family, n, operand, result)
    if family == "recv":
        wire = 0.0             # counted once, at the sender
    dtype = dtype_name(ins[0].dtype) if ins else "?"
    return CollectiveOp(family, dtype, n, max(operand, result), wire)


class StepRecorder(TorchDispatchMode):
    """Records one call of a step (see the module docstring).  ``args``:
    everything the step is given (its storages are the arguments)."""

    def __init__(self, args=()):
        super().__init__()
        self.stats = StepStats()
        self._args: Dict[int, int] = {}
        for x in _tensors(args):
            ref, n = _storage(x)
            self._args.setdefault(ref.cdata, n)
        self._live: Dict[int, tuple] = {}
        self._est = 0
        self.peak = 0
        self._since_prune = 0

    # ---- memory ------------------------------------------------------- #
    def _prune(self) -> None:
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self._est -= self._live.pop(k)[1]
        self._since_prune = 0

    def _track(self, outs) -> None:
        for x in outs:
            ref, n = _storage(x)
            if ref.cdata in self._args or ref.cdata in self._live:
                continue
            self._live[ref.cdata] = (ref, n)
            self._est += n
        self._since_prune += 1
        if self._est > self.peak or self._since_prune >= 512:
            self._prune()
            self.peak = max(self.peak, self._est)

    # ---- dispatch ----------------------------------------------------- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        st = self.stats
        st.ops += 1
        name = func._overloadpacket.__name__
        if func.namespace == "c10d" and name in FAMILIES:
            st.collectives.append(_collective(name, args))
        out = func(*args, **kwargs)
        outs = _tensors(out)
        packet = func._overloadpacket
        if packet in flop_registry or name in _COMPOSITE_FLOPS:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out)
                      if packet in flop_registry
                      else _COMPOSITE_FLOPS[name](args, outs[0]))
            st.flops += f
            if outs and outs[0].dim():
                st.dots.append(DotOp(str(packet), int(outs[0].shape[-1]), f))
        elif torch.Tag.pointwise in func.tags:
            n = sum(x.numel() for x in outs)
            st.flops += n
            if name in _TRANSCENDENTAL:
                st.transcendental += n
        elif name in _REDUCTIONS:
            ins = _tensors((args, kwargs))
            n = ins[0].numel() if ins else 0
            st.flops += n
            if name in _TRANSCENDENTAL:
                st.transcendental += n
        if func.namespace != "c10d" and not func.is_view:
            moved = sum(_nbytes(x) for x in _tensors((args, kwargs))) \
                + sum(_nbytes(x) for x in outs)
            st.hbm_bytes += moved
            if func.namespace == "repro_torch":
                st.kernel_bytes += moved
        self._track(outs)
        return out

    def finish(self, out) -> StepStats:
        """Close the record on the step's result ``out``: the memory
        fields (see the module docstring)."""
        self._prune()
        args = sum(self._args.values())
        seen, created, alias = set(), 0, 0
        for x in _tensors(out):
            ref, n = _storage(x)
            if ref.cdata in seen:
                continue
            seen.add(ref.cdata)
            if ref.cdata in self._args:
                alias += n
            else:
                created += n
        self.stats.memory = {
            "argument_size_in_bytes": int(args),
            "output_size_in_bytes": int(created + alias),
            "alias_size_in_bytes": int(alias),
            "temp_size_in_bytes": int(max(self.peak - created, 0)),
            "peak_bytes": int(args + self.peak)}
        return self.stats


def record(step, *args, **kwargs):
    """-> (``step(*args, **kwargs)``, its :class:`StepStats`)."""
    with StepRecorder((args, kwargs)) as rec:
        out = step(*args, **kwargs)
    return out, rec.finish(out)
