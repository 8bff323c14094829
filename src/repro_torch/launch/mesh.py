"""Production mesh builders (counterpart of ``repro/launch/mesh.py``).

Each returns a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group, which must be initialised: NCCL ranks on
cards, gloo ranks on the CPU, or the fake group of a dry-run
(``launch.dryrun``: one process stands for one rank of a world of
``REPRO_DRYRUN_DEVICES``).  Building a mesh creates a process group per
axis, collective over the world, so every rank calls the same builder.
Axis names follow ``dist.sharding``'s contract; the step builders read a
2- or 3-dim ``(pod,) data, model`` mesh as pipe = seq = 1.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _device_type() -> str:
    """``cpu`` on a gloo world, ``cuda`` on NCCL and on a dry-run's fake
    world, which stands for cards."""
    return "cpu" if dist.get_backend() == "gloo" else "cuda"


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A mesh of ``shape`` named ``axes`` over ranks ``0..prod(shape)-1``;
    raises when the world has another number of ranks."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(
            f"a {shape} mesh needs {n} ranks, the world has "
            f"{dist.get_world_size()} (a dry-run's is REPRO_DRYRUN_DEVICES)")
    return DeviceMesh(_device_type(),
                      torch.arange(n, dtype=torch.int64).reshape(shape),
                      mesh_dim_names=axes)


def production_dims(*, multi_pod: bool = False, pp: int = 1,
                    cp: int = 1) -> Tuple[tuple, tuple]:
    """(shape, axis names) of the production mesh: (data 16, model 16),
    with a ``pod`` axis of 2 in front when ``multi_pod``; ``pp``/``cp`` >
    1 carve ``pipe``/``seq`` axes out of the data axis (same device
    count), so the dry-run runs the same PP/CP step a section mesh does."""
    if pp == 1 and cp == 1:
        return (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                else ((16, 16), ("data", "model")))
    if 16 % (pp * cp):
        raise ValueError(f"pp={pp} x cp={cp} must divide the data axis 16")
    shape = (16 // (pp * cp), pp, cp, 16)
    axes = ("data", "pipe", "seq", "model")
    if multi_pod:
        return (2,) + shape, ("pod",) + axes
    return shape, axes


def env_dims(var: str = "REPRO_DRYRUN_MESH") -> Optional[Tuple[tuple,
                                                              tuple]]:
    """(shape, axis names) from a comma-separated dims environment
    variable, or None when it is unset: 2/3 dims name ``(pod,) data,
    model``, 4/5 dims ``(pod,) data, pipe, seq, model``."""
    spec = os.environ.get(var)
    if not spec:
        return None
    dims = tuple(int(x) for x in spec.split(","))
    names = (("pod", "data", "pipe", "seq", "model") if len(dims) > 3
             else ("pod", "data", "model"))
    return dims, names[-len(dims):]


def make_production_mesh(*, multi_pod: bool = False, pp: int = 1,
                         cp: int = 1):
    """The production mesh (:func:`production_dims`)."""
    return make_mesh(*production_dims(multi_pod=multi_pod, pp=pp, cp=cp))


def mesh_from_env(var: str = "REPRO_DRYRUN_MESH"):
    """The mesh of :func:`env_dims`, or None when ``var`` is unset."""
    dims = env_dims(var)
    return None if dims is None else make_mesh(*dims)


def make_host_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh over the first ``data * model`` ranks of the
    world."""
    n = dist.get_world_size()
    if data * model > n:
        raise ValueError(f"data={data} x model={model} exceeds {n} ranks")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(_device_type(),
                      torch.arange(data * model,
                                   dtype=torch.int64).reshape(data, model),
                      mesh_dim_names=("data", "model"))
