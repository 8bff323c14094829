"""Distributed-parallelism layer: the sharding rules and the axis contract.

Counterpart of ``repro/dist``.  :mod:`repro_torch.dist.sharding` holds the
``pod/data/pipe/seq/model`` axis contract, the logical-axis rules, the spec
trees the sharded train step rests its parameters and optimizer state on,
and ``section_mesh``, which builds a ``torch.distributed`` ``DeviceMesh``
with those axis names.  :mod:`repro_torch.dist.context` holds context
parallel attention over the ``seq`` axis, and
:mod:`repro_torch.dist.pipeline` the GPipe loss over the ``pipe`` axis and
Megatron tensor parallelism over ``model``.

The port runs one process per rank: each rank holds its own shard of each
leaf as a plain tensor, and the step builders move shards with explicit
collectives over the mesh's process groups.
"""
from repro_torch.dist import sharding  # noqa: F401
