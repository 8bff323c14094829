"""Logical-axis sharding rules (the paper's C^s -> physical mesh mapping).

Counterpart of ``repro/dist/sharding.py``.  Every model defines its
parameters as a :class:`~repro_torch.models.common.ParamSpec` tree with
*logical* axis names (``embed``, ``heads``, ``vocab``, ``experts``, ...).
This module is where those names meet mesh axes, under the reference's
axis contract:

==========  =======================================================
mesh axis   meaning
==========  =======================================================
``pod``     slow inter-pod interconnect; outermost data axis
``data``    data parallelism / FSDP parameter sharding
``pipe``    pipeline stages (``ParallelConfig.pp``)
``seq``     context parallelism (``ParallelConfig.cp``)
``model``   tensor parallelism (``ParallelConfig.tp``)
==========  =======================================================

The rule functions are pure: they take a mesh as a
``torch.distributed.device_mesh.DeviceMesh`` or as a plain ``{axis: size}``
mapping in axis order (a ``pod`` axis included), and return a
:class:`PartitionSpec`, a tuple whose entries are ``None``, a mesh-axis
name or a tuple of names, equal as a tuple to the reference's.  The
reference's ``NamedSharding`` trees become trees of specs.

The port runs one process per rank.  A rank holds, of each leaf, the block
its mesh coordinate selects (:func:`shard`); a dim sharded over a tuple of
axes is split major to minor, the first axis outermost, as in JAX.
:func:`gather`, :func:`reduce_to` and :func:`reshard` move blocks with
``torch.distributed`` collectives over the mesh's per-axis process groups,
one leaf at a time.  They use only calls that exist, without a deprecation
warning, in every PyTorch build the port runs on (``all_gather`` and
``reduce_scatter`` with tensor lists, ``all_reduce``).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.types import ArchConfig, ParallelConfig
from repro_torch.models.common import ParamSpec, tree_map

# --------------------------------------------------------------------------- #
# Axis-naming contract
# --------------------------------------------------------------------------- #
AXIS_POD = "pod"
AXIS_DATA = "data"
AXIS_PIPE = "pipe"
AXIS_SEQ = "seq"
AXIS_MODEL = "model"

#: mesh axes that carry data parallelism, outermost first
DP_AXES = (AXIS_POD, AXIS_DATA)

#: mesh axes eligible for ZeRO optimizer-state extension
ZERO_AXES = (AXIS_POD, AXIS_DATA, AXIS_MODEL)

#: the axes of a section mesh, in :func:`section_mesh`'s order
SECTION_AXES = (AXIS_DATA, AXIS_PIPE, AXIS_SEQ, AXIS_MODEL)

#: logical param axis -> mesh-axis candidates, tried in order
DEFAULT_RULES = {
    "embed": (AXIS_DATA,),          # FSDP: weights sharded over data
    "heads": (AXIS_MODEL,),
    "kv_heads": (AXIS_MODEL,),
    "vocab": (AXIS_MODEL,),
    "experts": (AXIS_MODEL,),       # expert parallelism when E % tp == 0
    "mlp": (AXIS_MODEL,),           # per-expert / dense MLP TP otherwise
    "d_inner": (AXIS_MODEL,),       # mamba inner-dim TP
}


class PartitionSpec(tuple):
    """One entry per dim: ``None`` (replicated), a mesh-axis name, or a
    tuple of names (the dim split over their product, the first outermost).
    A one-name tuple is stored as the name and an empty one as ``None``, as
    JAX's ``PartitionSpec`` normalises them."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class Repeated(str):
    """A spec entry of a compute block: the dim's entries each repeated
    ``times`` times in a row (``jnp.repeat``), the result split over the
    mesh axis this string names.  Tensor parallelism slices a GQA layer's
    ``kv_heads`` so when the ``model`` axis exceeds the KV heads: each of
    the ``tp / KV`` ranks of a query-head group gets that group's KV head.
    Everywhere else it is the axis name; :func:`shard`, :func:`reshard`
    (into it) and :func:`reduce_to` (``have``: the gradient of a repeated
    entry is the sum over its copies) know the repeat."""

    def __new__(cls, axis: str, times: int):
        s = super().__new__(cls, axis)
        s.times = int(times)
        return s

    def __getnewargs__(self):
        return str(self), self.times

    def __repr__(self) -> str:
        return f"Repeated({str.__repr__(self)}, {self.times})"


def fold_repeats(x: torch.Tensor, d: int, times: int) -> torch.Tensor:
    """The gradient of ``repeat_interleave(times, dim=d)``: each run of
    ``times`` entries of dim ``d`` summed into one."""
    return x.unflatten(d, (-1, times)).sum(d + 1)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def mesh_shape(mesh) -> dict:
    """``{axis: size}`` in axis order, of a ``DeviceMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a mesh for the sharding rules needs dim names")
    return dict(zip(names, mesh.mesh.shape))


# --------------------------------------------------------------------------- #
# Rules
# --------------------------------------------------------------------------- #
def rules_for(cfg: ArchConfig, mesh, *, teacher: bool = False) -> dict:
    """Sharding rules for one section of this arch on this mesh.

    ``teacher=True`` (a forward-only frozen section) drops the FSDP rule
    (``embed`` -> data): it has no optimizer state to amortise the per-step
    all-gather against.  On a mesh with a ``pipe`` axis above 1 the stacked
    ``layers`` dim maps onto it, and so does ``vocab`` when the padded
    vocabulary divides it."""
    rules = dict(DEFAULT_RULES)
    if teacher:
        del rules["embed"]
    pp = mesh_shape(mesh).get(AXIS_PIPE, 1)
    if pp > 1:
        rules["layers"] = (AXIS_PIPE,)
        if cfg.padded_vocab % pp == 0:
            rules["vocab"] = (AXIS_PIPE,) + DEFAULT_RULES["vocab"]
    return rules


def _candidates(rules: dict, name) -> Tuple[str, ...]:
    cand = rules.get(name, ())
    if cand is None:
        return ()
    if isinstance(cand, str):
        return (cand,)
    return tuple(cand)


def spec_for(spec: ParamSpec, mesh, rules: Optional[dict] = None
             ) -> PartitionSpec:
    """Spec for one parameter: greedy left-to-right assignment, no mesh
    axis used twice, an axis that does not divide the dim -> replicated."""
    rules = DEFAULT_RULES if rules is None else rules
    axis_sizes = mesh_shape(mesh)
    used: set = set()
    entries = []
    for dim, name in zip(spec.shape, spec.axes):
        entry = None
        for ax in _candidates(rules, name):
            if ax in axis_sizes and ax not in used \
                    and dim % axis_sizes[ax] == 0:
                entry = ax
                used.add(ax)
                break
        entries.append(entry)
    return P(*entries)


def zero_extend(spec: ParamSpec, base: PartitionSpec, mesh) -> PartitionSpec:
    """Extend a parameter's spec over free mesh axes (ZeRO: optimizer state
    sharded where the weight is replicated).  The stacked ``layers`` dim is
    never extended.  An added axis goes after the dim's existing ones."""
    axis_sizes = mesh_shape(mesh)
    entries = [base[i] if i < len(base) else None
               for i in range(len(spec.shape))]
    used = {a for e in entries for a in _axes(e)}
    for ax in axis_sizes:
        if ax in used or ax not in ZERO_AXES:
            continue
        n = axis_sizes[ax]
        for i, (dim, name) in enumerate(zip(spec.shape, spec.axes)):
            if name == "layers":
                continue
            cur_t = _axes(entries[i])
            prod = n
            for a in cur_t:
                prod *= axis_sizes[a]
            if dim % prod == 0:
                entries[i] = cur_t + (ax,)
                used.add(ax)
                break
    return P(*entries)


# --------------------------------------------------------------------------- #
# Spec trees
# --------------------------------------------------------------------------- #
def param_shardings(specs, mesh, rules: Optional[dict] = None):
    """Spec tree for a ParamSpec tree."""
    return tree_map(lambda s: spec_for(s, mesh, rules), specs)


def opt_state_shardings(specs, mesh, rules: Optional[dict] = None, *,
                        zero: bool = True):
    """``AdamWState``-shaped spec tree: ``mu``/``nu``/``master`` get the
    parameter's spec, extended over free mesh axes when ``zero``; ``step``
    is replicated."""
    from repro_torch.optim.adamw import AdamWState

    def one(s: ParamSpec):
        base = spec_for(s, mesh, rules)
        return zero_extend(s, base, mesh) if zero else base

    tree = tree_map(one, specs)
    return AdamWState(step=replicated(mesh), mu=tree, nu=tree, master=tree)


def replicated(mesh) -> PartitionSpec:
    return P()


# --------------------------------------------------------------------------- #
# Data-parallel helpers
# --------------------------------------------------------------------------- #
def dp_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes carrying data parallelism, outermost first."""
    return tuple(a for a in mesh_shape(mesh) if a in DP_AXES)


def axis_size(mesh, axes) -> int:
    """Product of mesh-axis sizes; axes may be a name, a tuple, or None."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def batch_spec(mesh, batch: int, seq_len: int) -> PartitionSpec:
    """[B, S] activation spec: batch over the dp axes; a B=1 long decode
    shards the sequence instead; replicated when neither divides."""
    dp = dp_axes(mesh)
    n = axis_size(mesh, dp)
    if not dp:
        return P(None, None)
    if batch % n == 0:
        return P(dp, None)
    if seq_len % n == 0:
        return P(None, dp)
    return P(None, None)


#: the reference's three layouts of a global batch on a mesh
#: (:func:`batch_spec`): rows over the data axes, else the sequence over
#: them, else the whole batch on every data rank
BATCH_LAYOUTS = ("rows", "sequence", "replicated")


def batch_layout(mesh, batch: int, seq_len: int) -> str:
    """Which of :data:`BATCH_LAYOUTS` :func:`batch_spec` gives a global
    batch of ``batch`` x ``seq_len`` tokens on ``mesh``."""
    spec = batch_spec(mesh, batch, seq_len)
    if spec[0] is not None:
        return "rows"
    return "sequence" if spec[1] is not None else "replicated"


def axes_group(mesh, axes: Sequence[str]) -> tuple:
    """(process group, size, this rank's index) of the ranks of ``mesh``
    that differ from this one only on ``axes``, indexed major to minor as a
    dim split over the tuple is.  The group is one axis's own where at most
    one of ``axes`` is above 1, else that of the flattened sub-mesh, which
    creates a process group: every rank of the world calls this together
    then."""
    sizes, coord = mesh_shape(mesh), coordinate(mesh)
    n, idx = 1, 0
    for a in axes:
        n, idx = n * sizes[a], idx * sizes[a] + coord[a]
    live = [a for a in axes if sizes[a] > 1]
    if len(live) > 1:
        return mesh[tuple(axes)]._flatten().get_group(), n, idx
    return mesh.get_group(live[0] if live else axes[0]), n, idx


def dp_sharding(mesh, ndim: int = 2) -> PartitionSpec:
    """Dim 0 (batch) over the dp axes, every other dim replicated: the
    cross-section handoff layout."""
    dp = dp_axes(mesh)
    return P(dp if dp else None, *([None] * (ndim - 1)))


def logits_sharding(mesh, batch: int, vocab: int) -> PartitionSpec:
    """[B, V] logits: batch over dp, vocab over model, each dim replicated
    where its axis does not divide it."""
    dp = dp_axes(mesh)
    b_ax = dp if dp and batch % axis_size(mesh, dp) == 0 else None
    sizes = mesh_shape(mesh)
    m = sizes.get(AXIS_MODEL, 1)
    v_ax = AXIS_MODEL if AXIS_MODEL in sizes and vocab % m == 0 else None
    return P(b_ax, v_ax)


def _shape(leaf) -> tuple:
    return tuple(leaf) if isinstance(leaf, (tuple, list)) \
        else tuple(leaf.shape)


def data_shardings(mesh, batch_specs) -> dict:
    """Spec tree for a batch (tensors, or shapes as tuples): dim 0 over the
    dp axes when it divides, else dim 1, else replicated.  On a mesh with a
    ``seq`` axis above 1, dim 1 is also split over ``seq`` when free and
    divisible."""
    dp = dp_axes(mesh)
    n = axis_size(mesh, dp)
    cp = mesh_shape(mesh).get(AXIS_SEQ, 1)

    def one(leaf):
        shape = _shape(leaf)
        entries = [None] * len(shape)
        if dp and len(shape) >= 1 and shape[0] % n == 0:
            entries[0] = dp
        elif dp and len(shape) >= 2 and shape[1] % n == 0:
            entries[1] = dp
        if cp > 1 and len(shape) >= 2 and entries[1] is None \
                and shape[1] % cp == 0:
            entries[1] = AXIS_SEQ
        return P(*entries)

    return tree_map(one, batch_specs)


# --------------------------------------------------------------------------- #
# Decode-cache specs (read by train.step's sharded serving builders)
# --------------------------------------------------------------------------- #
def kv_cache_spec(mesh, shape: Tuple[int, ...], kind: str = "attn"
                  ) -> PartitionSpec:
    """Spec for one [B, C, KV, hd] KV-cache buffer.  KV heads over
    ``model`` when divisible; a kv=1 (MQA) cache splits the *sequence* over
    ``model`` instead (flash-decoding split)."""
    B, C, KV, _ = shape
    dp = dp_axes(mesh)
    b_ax = dp if dp and B % axis_size(mesh, dp) == 0 else None
    sizes = mesh_shape(mesh)
    m = sizes.get(AXIS_MODEL, 1)
    if AXIS_MODEL in sizes and KV % m == 0:
        return P(b_ax, None, AXIS_MODEL, None)
    if AXIS_MODEL in sizes and C % m == 0:
        return P(b_ax, AXIS_MODEL, None, None)
    return P(b_ax, None, None, None)


def _ssm_cache_spec(mesh, shape: Tuple[int, ...], key: str) -> PartitionSpec:
    """Mamba cache leaves ``conv`` [B, W, ch] and ``ssm`` [B, nh, hd, n],
    possibly with leading stacked dims: batch over dp, channels or heads
    over model."""
    lead = len(shape) - (3 if key == "conv" else 4)
    shape = shape[lead:]
    dp = dp_axes(mesh)
    b_ax = dp if dp and shape[0] % axis_size(mesh, dp) == 0 else None
    sizes = mesh_shape(mesh)
    m = sizes.get(AXIS_MODEL, 1)
    has_m = AXIS_MODEL in sizes
    if key == "conv":
        ch_ax = AXIS_MODEL if has_m and shape[2] % m == 0 else None
        tail = (b_ax, None, ch_ax)
    else:
        h_ax = AXIS_MODEL if has_m and shape[1] % m == 0 else None
        tail = (b_ax, h_ax, None, None)
    return P(*((None,) * lead + tail))


def cache_shardings(mesh, cache_specs):
    """Spec tree for a decode cache (tensors, or shapes as tuples, in nested
    dicts and lists).  A leaf's kind comes from its nearest dict key
    (``conv``/``ssm``: Mamba-2, anything else: attention); leading stacked
    dims are replicated."""
    def one(leaf, key):
        shape = _shape(leaf)
        if key in ("conv", "ssm"):
            return _ssm_cache_spec(mesh, shape, key)
        lead = len(shape) - 4
        return P(*((None,) * lead + tuple(kv_cache_spec(mesh, shape[lead:]))))

    def walk(t, key):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, list) or (isinstance(t, tuple)
                                   and not all(isinstance(d, int) for d in t)):
            return type(t)(walk(v, key) for v in t)
        return one(t, key)

    return walk(cache_specs, None)


# --------------------------------------------------------------------------- #
# Physical-layout helpers
# --------------------------------------------------------------------------- #
def head_pad_for(cfg: ArchConfig, tp: int) -> int:
    """Zero Q-heads to append so (H + pad) divides the TP axis while
    keeping whole KV groups ((H + pad) % KV == 0).  0 when there is no
    attention or H already divides."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if H == 0 or tp <= 1 or H % tp == 0:
        return 0
    Hp = H + 1
    while Hp % tp or (KV and Hp % KV):
        Hp += 1
    return Hp - H


def section_mesh(ranks: Sequence[int], parallel: ParallelConfig,
                 name: str = "", *, device_type: Optional[str] = None):
    """The ``DeviceMesh`` of one section: ``ParallelConfig(dp, tp, pp, cp)``
    maps onto axes ``(data, pipe, seq, model)`` of sizes (dp, pp, cp, tp)
    over ``ranks``, given in ascending order.  The default process group
    must be initialised; building the mesh creates a process group per
    axis, which is collective over every rank of the world, so every rank
    calls this with the same arguments, including ranks outside the
    section.  ``device_type`` defaults to ``cuda`` under NCCL and ``cpu``
    otherwise."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = list(ranks)
    if len(ranks) != parallel.devices:
        raise ValueError(f"section {name!r}: {len(ranks)} ranks for "
                         f"{parallel.devices} devices")
    if ranks != sorted(set(ranks)):
        raise ValueError(f"section {name!r}: ranks {ranks} must be distinct "
                         "and ascending, so that each axis group orders its "
                         "ranks as the mesh's coordinates do")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(
        parallel.dp, parallel.pp, parallel.cp, parallel.tp)
    return DeviceMesh(device_type, grid, mesh_dim_names=SECTION_AXES)


# --------------------------------------------------------------------------- #
# Moving blocks: one leaf at a time, over the mesh's axis groups
# --------------------------------------------------------------------------- #
def coordinate(mesh) -> dict:
    """This rank's ``{axis: index}`` in ``mesh``; raises for a rank outside
    it."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def is_origin(mesh) -> bool:
    """Whether this rank sits at the mesh's origin, the rank that logs and
    writes for all of them."""
    return all(i == 0 for i in coordinate(mesh).values())


def _block(entry, sizes: dict, coord: dict) -> Tuple[int, int]:
    """(number of blocks, this rank's block) of a dim split by ``entry``."""
    n, idx = 1, 0
    for a in _axes(entry):
        n *= sizes[a]
        idx = idx * sizes[a] + coord[a]
    return n, idx


def shard(x: torch.Tensor, spec: PartitionSpec, mesh,
          coord: Optional[dict] = None) -> torch.Tensor:
    """The block of ``x`` that ``spec`` gives the rank at ``coord`` (default:
    this rank), as a contiguous tensor; raises when a dim does not divide.
    ``mesh`` may be a mapping when ``coord`` is given."""
    sizes = mesh_shape(mesh)
    coord = coordinate(mesh) if coord is None else coord
    x = x.detach()
    for d, entry in enumerate(spec):
        n, idx = _block(entry, sizes, coord)
        if isinstance(entry, Repeated):
            x = _repeated_block(x, d, entry.times, n, idx)
            continue
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"into {n} blocks for {spec}")
        size = x.shape[d] // n
        x = x.narrow(d, idx * size, size)
    return x.contiguous()


def _repeated_block(x: torch.Tensor, d: int, times: int, n: int,
                    idx: int) -> torch.Tensor:
    """Block ``idx`` of ``n`` of dim ``d`` of ``x.repeat_interleave(times,
    dim=d)``, repeating only the entries the block covers."""
    total = x.shape[d] * times
    if total % n:
        raise ValueError(f"dim {d} of {tuple(x.shape)} repeated {times} "
                         f"times does not split into {n} blocks")
    b = total // n
    lo, hi = idx * b // times, ((idx + 1) * b - 1) // times + 1
    y = x.narrow(d, lo, hi - lo).repeat_interleave(times, dim=d)
    return y.narrow(d, idx * b - lo * times, b)


def shard_tree(tree, specs, mesh, coord: Optional[dict] = None):
    """:func:`shard` over a tree and its spec tree (``AdamWState`` too)."""
    return _zip_map(lambda x, s: shard(x, s, mesh, coord), tree, specs)


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, getattr(tree, k), getattr(specs, k))
                            for k in tree._fields))
    return fn(tree, specs)


def _all_gather_dim(x: torch.Tensor, d: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=d)


def _reduce_scatter_dim(x: torch.Tensor, d: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[d] % n:
        raise ValueError(f"dim {d} of {tuple(x.shape)} does not split into "
                         f"{n} blocks")
    parts = [c.contiguous() for c in x.chunk(n, dim=d)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def gather(x: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """The full tensor from each rank's block under ``spec``: an all-gather
    over each axis of each split dim, the innermost axis first."""
    for d, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            x = _all_gather_dim(x, d, mesh.get_group(a))
    return x


def gather_tree(tree, specs, mesh):
    return _zip_map(lambda x, s: gather(x, s, mesh), tree, specs)


def reshard(x: torch.Tensor, src: PartitionSpec, dst: PartitionSpec,
            mesh) -> torch.Tensor:
    """A block under ``src`` -> the block under ``dst``.  On a dim whose
    ``dst`` axes lead its ``src`` axes (a parameter's spec against its
    ZeRO extension), an all-gather over each extra axis, innermost first;
    on any other dim, an
    all-gather over every ``src`` axis and, once every dim is gathered,
    this rank's slice under ``dst``.  An all-None ``dst`` is
    :func:`gather`; a ``dst`` with a :class:`Repeated` entry gathers the
    whole leaf and takes the block :func:`shard` gives."""
    if not any(_axes(e) for e in dst):
        return gather(x, src, mesh)
    if any(isinstance(e, Repeated) for e in dst):
        return shard(gather(x, src, mesh), dst, mesh)
    sizes, coord = mesh_shape(mesh), coordinate(mesh)
    sliced = []
    for d in range(len(src)):
        s_ax = _axes(src[d])
        d_ax = _axes(dst[d] if d < len(dst) else None)
        keep = d_ax if s_ax[:len(d_ax)] == d_ax else ()
        for a in reversed(s_ax[len(keep):]):
            x = _all_gather_dim(x, d, mesh.get_group(a))
        if keep != d_ax:
            sliced.append(d)
    for d in sliced:
        n, idx = _block(dst[d], sizes, coord)
        size = x.shape[d] // n
        x = x.narrow(d, idx * size, size)
    return x.contiguous()


def reduce_to(x: torch.Tensor, spec: PartitionSpec, mesh,
              axes: Sequence[str],
              have: Optional[PartitionSpec] = None) -> torch.Tensor:
    """Sum ``x``, a full-size tensor that each rank holds a part of, over
    the mesh ``axes`` and keep this rank's block under ``spec``: a
    reduce-scatter over each of ``axes`` that splits a dim (its outermost
    axis first), an all-reduce over the others.  A split over an axis not
    in ``axes`` is a plain slice.

    ``have``: ``x`` is this rank's block under that spec instead (the
    blocks a tensor-parallel or pipeline stage body computes with, whose
    axes are not in ``axes``).  A dim whose ``have`` axes lead its
    ``spec`` axes stays as it is; every other is all-gathered first.  A
    :class:`Repeated` dim of ``have`` is all-gathered and each entry's
    copies summed (:func:`fold_repeats`): the copies' ranks share the
    entry, so its gradient is their sum over that axis, and every rank
    then holds the whole of it."""
    sizes, coord = mesh_shape(mesh), coordinate(mesh)
    done = []
    for d, entry in enumerate(spec):
        h_entry = have[d] if have is not None and d < len(have) else None
        h = _axes(h_entry)
        if set(h) & set(axes):
            raise ValueError(f"{have} splits dim {d} over a summed axis of "
                             f"{tuple(axes)}")
        if isinstance(h_entry, Repeated) or _axes(entry)[:len(h)] != h:
            for a in reversed(h):
                x = _all_gather_dim(x, d, mesh.get_group(a))
            if isinstance(h_entry, Repeated):
                x = fold_repeats(x, d, h_entry.times)
            h = ()
        done.append(h)
    in_spec = set()
    for d, entry in enumerate(spec):
        for a in _axes(entry)[len(done[d]):]:
            if a in axes:
                x = _reduce_scatter_dim(x, d, mesh.get_group(a))
                in_spec.add(a)
            elif sizes[a] > 1:
                size = x.shape[d] // sizes[a]
                x = x.narrow(d, coord[a] * size, size).contiguous()
    for a in axes:
        if a not in in_spec:
            dist.all_reduce(x, group=mesh.get_group(a))
    return x


def all_reduce_axes(x: torch.Tensor, mesh, axes: Sequence[str],
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``x`` in place over the mesh ``axes``, one after another."""
    for a in axes:
        dist.all_reduce(x, op=op, group=mesh.get_group(a))
    return x


def all_reduce_mesh(x: torch.Tensor, mesh, op=dist.ReduceOp.SUM
                    ) -> torch.Tensor:
    """Reduce ``x`` in place over every rank of ``mesh``, one axis after
    another (no process group spans a section's ranks otherwise)."""
    for a in mesh.mesh_dim_names:
        dist.all_reduce(x, op=op, group=mesh.get_group(a))
    return x


def counted_here(spec: PartitionSpec, mesh) -> bool:
    """Whether this rank's block of a leaf under ``spec`` counts in a sum
    over the mesh that must see each element once: a block replicated over
    an axis counts at that axis's coordinate 0 only."""
    used = {a for e in spec for a in _axes(e)}
    return all(i == 0 for a, i in coordinate(mesh).items() if a not in used)
