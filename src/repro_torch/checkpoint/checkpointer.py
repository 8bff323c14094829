"""Checkpointing: atomic commit, asynchronous writes, retention.
Counterpart of ``repro/checkpoint/checkpointer.py``, with its on-disk
layout, so that either package restores what the other wrote:

* a checkpoint is a directory ``step_NNNNNNNN`` holding one ``.npy`` file
  per leaf and ``manifest.json`` (``step``, ``metadata``, ``time`` and
  ``leaves``: each leaf's ``path``, ``file``, ``shape`` and ``dtype``);
* a leaf's path joins its keys with ``.`` as the JAX package's
  ``tree_flatten_with_path`` names them: dict keys in sorted order,
  ``AdamWState`` fields by name (``opt.master.layers.wq``), list and tuple
  items by index; its file is the path with ``/`` replaced by ``_``;
* writes go to ``step_NNNNNNNN.tmp`` and the directory is renamed when
  the manifest is written, so a crash never leaves a partial checkpoint
  that :meth:`Checkpointer.all_steps` would report;
* only the newest ``keep_last_n`` checkpoints are kept.

numpy has no bfloat16.  A bfloat16 leaf is written as its raw 2-byte
words under the descriptor ``'<V2'`` with manifest dtype ``"bfloat16"``:
the bytes the JAX package writes for an ml_dtypes bfloat16 array.  On
restore the words are viewed as ``torch.bfloat16`` again.

:meth:`Checkpointer.save` copies every leaf to host memory before it
returns (a CUDA leaf into pinned memory, waited for with an event on the
current stream) and hands only those copies to the writer thread.  The
port's AdamW updates its state in place, so the next step may overwrite
a leaf as soon as ``save`` returns.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed

from repro_torch.dist import sharding as shd
from repro_torch.models.common import flatten_with_path

BF16_DESCR = "<V2"


def _with_specs(tree, specs, prefix: Tuple[str, ...] = ()):
    """(path, leaf, spec) in :func:`flatten_with_path`'s order, ``specs``
    walked alongside ``tree`` with each ``PartitionSpec`` a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _with_specs(tree[k], specs[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for k in tree._fields
                for x in _with_specs(getattr(tree, k), getattr(specs, k),
                                     prefix + (k,))]
    return [(".".join(prefix), tree, specs)]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves, in flattening order, taken
    from the iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, k), leaves)
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _host_copies(leaves) -> List[Tuple[np.ndarray, str]]:
    """Each leaf as (a numpy array that nothing else writes, manifest
    dtype).  CUDA tensors are copied into pinned memory on the current
    stream, and the copies are waited for before this returns."""
    hosts, devices = [], set()
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                devices.add(t.device)
            else:
                h = t.clone()
            hosts.append(h)
        else:
            hosts.append(np.array(leaf))
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()
    out = []
    for h in hosts:
        if isinstance(h, np.ndarray):
            out.append((h, str(h.dtype)))
        elif h.dtype == torch.bfloat16:
            out.append((h.view(torch.int16).numpy(), "bfloat16"))
        else:
            out.append((h.numpy(), str(h.numpy().dtype)))
    return out


def _write_npy(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = BF16_DESCR
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        arr.tofile(f)


def _read_leaf(path: Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    """Saves and restores trees of tensors under ``directory``.

    After each save, ``last_copy_s`` is the time to copy the leaves to
    host memory (``save`` waits for it), and ``last_write_s`` and
    ``last_bytes`` the time and bytes of the writes; after each restore,
    ``last_restore_s`` its time."""

    def __init__(self, directory, *, keep_last_n: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last_n = keep_last_n
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[str] = None
        self._mesh = None               # the mesh of an unfinished save
        self.last_copy_s = self.last_write_s = self.last_restore_s = 0.0
        self.last_bytes = 0

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: Any, *, metadata: Optional[dict] = None,
             block: bool = False, shardings: Any = None,
             mesh=None) -> None:
        """Write ``tree`` as checkpoint ``step``.  With ``shardings`` and
        ``mesh`` the leaves are this rank's blocks: every rank of the mesh
        must call ``save`` (and :meth:`wait`), and the mesh's origin
        writes."""
        self.wait()                     # one in-flight save at a time
        t0 = time.perf_counter()
        if shardings is None:
            flat = flatten_with_path(tree)
            names, leaves = [p for p, _ in flat], (x for _, x in flat)
        else:
            self._mesh = mesh
            flat = _with_specs(tree, shardings)
            names = [p for p, _, _ in flat]
            leaves = (shd.gather(x, s, mesh) for _, x, s in flat)
            if not shd.is_origin(mesh):
                for _ in leaves:        # take part in every gather
                    pass
                self.last_copy_s = time.perf_counter() - t0
                if block or not self.async_save:
                    self.wait()
                return
        host = list(zip(names, _host_copies(leaves)))
        self.last_copy_s = time.perf_counter() - t0

        def _write():
            try:
                t1 = time.perf_counter()
                tmp = self.dir / f"step_{step:08d}.tmp"
                final = self.dir / f"step_{step:08d}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                manifest = {"step": step, "metadata": metadata or {},
                            "time": time.time(), "leaves": []}
                nbytes = 0
                for name, (arr, dtype) in host:
                    fn = name.replace("/", "_") + ".npy"
                    _write_npy(tmp / fn, arr, dtype)
                    nbytes += arr.nbytes
                    manifest["leaves"].append(
                        {"path": name, "file": fn,
                         "shape": list(arr.shape), "dtype": dtype})
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                if final.exists():
                    shutil.rmtree(final)
                os.replace(tmp, final)           # atomic commit
                self._retain()
                self.last_write_s = time.perf_counter() - t1
                self.last_bytes = nbytes
            except Exception as e:              # reported by wait()
                self._error = repr(e)

        if self.async_save and not block:
            self._thread = threading.Thread(target=_write, daemon=True,
                                            name=f"checkpoint-{step}")
            self._thread.start()
        else:
            _write()
            self.wait()

    def wait(self) -> None:
        """Block until the in-flight save is on disk; raise its error.
        After a sharded save this is collective: no rank of the mesh
        returns before the origin's write has ended, and every rank raises
        when it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            failed = torch.tensor([1.0 if err else 0.0],
                                  device=mesh.device_type)
            shd.all_reduce_mesh(failed, mesh, torch.distributed.ReduceOp.MAX)
            if failed.item() and not err:
                err = "on the mesh's origin"
        if err:
            raise RuntimeError(f"checkpoint save failed: {err}")

    # ------------------------------------------------------------------ #
    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last_n]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not p.is_dir():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------ #
    def restore(self, step: Optional[int], target: Any, shardings: Any = None,
                mesh=None) -> Any:
        """A tree shaped like ``target`` holding checkpoint ``step``'s
        values (the latest when ``step`` is None).  Each tensor leaf of
        ``target`` gives its restored leaf's dtype, device and
        ``requires_grad``; any other leaf comes back as a CPU tensor of the
        saved dtype.  A leaf the checkpoint lacks raises ``KeyError``.

        With ``shardings`` (a spec tree shaped like ``target``) and
        ``mesh``, each leaf is this rank's block of the saved one under its
        spec on ``mesh``, whatever mesh wrote it."""
        t0 = time.perf_counter()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        files = {leaf["path"]: leaf for leaf in self.manifest(step)["leaves"]}
        flat = ([(p, x, None) for p, x in flatten_with_path(target)]
                if shardings is None else _with_specs(target, shardings))
        out = []
        for name, leaf, spec in flat:
            if name not in files:
                raise KeyError(f"checkpoint {step} missing leaf {name}")
            t = _read_leaf(d / files[name]["file"], files[name]["dtype"])
            if spec is not None:
                t = shd.shard(t, spec, mesh)
            if isinstance(leaf, torch.Tensor):
                if tuple(t.shape) != tuple(leaf.shape):
                    raise ValueError(
                        f"checkpoint {step} leaf {name}: {tuple(t.shape)} "
                        f"where the target holds {tuple(leaf.shape)}")
                t = t.to(device=leaf.device, dtype=leaf.dtype)
                if leaf.requires_grad:
                    t.requires_grad_()
            out.append(t)
        tree = _rebuild(target, iter(out))
        self.last_restore_s = time.perf_counter() - t0
        return tree

    def manifest(self, step: int) -> dict:
        d = self.dir / f"step_{step:08d}"
        return json.loads((d / "manifest.json").read_text())
