"""Helpers of the port's multi-rank drivers: spawn gloo ranks on one host,
and carry trees through ``.npz`` files.

A driver runs ``spawn(fn, world, *args)``: ``world`` processes, started by
the ``spawn`` method, each calling ``fn(rank, world, store, *args)`` after
joining a gloo process group through a ``FileStore`` in a fresh temporary
directory (no port, so several drivers can run at once).  Each rank runs
on one thread.
"""
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, store, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args) -> None:
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; raises when
    a rank fails."""
    tmp = tempfile.mkdtemp(prefix="torch_driver_")
    try:
        mp.spawn(_entry, args=(world, os.path.join(tmp, "store"), fn, args),
                 nprocs=world, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def nest(arrays, prefix: str) -> dict:
    """The nested dict of the ``prefix``-ed keys of an npz mapping, whose
    remaining key parts are joined by ``/``."""
    out: dict = {}
    for key in arrays.keys():
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(arrays[key])
    return out


def flat(tree, prefix: str) -> dict:
    """A nested dict of tensors or arrays -> ``{prefix + path: float32
    array}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.detach().float().numpy()
                               if isinstance(v, torch.Tensor)
                               else np.asarray(v, np.float32))
    return out
