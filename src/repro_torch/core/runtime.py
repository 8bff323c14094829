"""Disaggregated Maestro runtime: sections on their own devices, each run
by its own worker thread.  Counterpart of ``repro/core/runtime.py``.

Each section owns a device list carved from the caller's
(``carve_sections``), runs its tasks from a worker thread, and exchanges
tensors through the :class:`MessageQueue` (§3.3) in the order produced by
the wavefront scheduler (§3.4).

A device list may name one card more than once: every section then runs
on that card, each from its own thread and on its own CUDA stream, which
its worker makes current inside its thread (PyTorch's current stream is
per thread).  This is how a compound workload runs on one H100; on the
CPU the sections share the host.  ``repro_torch.analysis.affinity``
checks that wiring: each worker marks its thread in ``worker_section``.

Carved by ``ranks`` instead, the sections run on section meshes over
``torch.distributed``, one process a rank (the reference is one controller
over every mesh; the port is MPMD): every rank builds every section's
mesh, keeps a worker only for the sections it belongs to, and runs only
their tasks.  ``gpu_counts`` (the planner's ``{section: n_gpus}``, as in
the reference) sizes each section's mesh, its ``tp`` widened or narrowed
to the count (:func:`section_parallel`).
"""
from __future__ import annotations

import queue
import threading
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.analysis.affinity import worker_section
from repro_torch.core.graph import SectionGraph
from repro_torch.core.messages import MessageQueue, PeerTransport


def visible_devices() -> List[torch.device]:
    """Every CUDA card this process sees (none on a CPU-only host)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def section_parallel(name: str, par, n: int):
    """The effective ParallelConfig of section ``name`` on ``n`` devices,
    the reference's rule: ``par`` itself where ``n`` is its device count,
    else ``par`` with ``tp`` widened or narrowed to ``n / (dp pp cp)``;
    raises where that is not integral."""
    base = par.dp * par.pp * par.cp
    if n % base:
        raise ValueError(
            f"section {name!r}: {n} devices do not factor into "
            f"dp×pp×cp={par.dp}×{par.pp}×{par.cp} (tp must be integral)")
    return par if n == par.devices else par.replace(tp=n // base)


def _effective(graph: SectionGraph,
               gpu_counts: Optional[Dict[str, int]]) -> Dict[str, Any]:
    """Each section's :func:`section_parallel` on its planned count."""
    counts = gpu_counts or {}
    return {name: section_parallel(name, sec.parallel,
                                   counts.get(name, sec.parallel.devices))
            for name, sec in graph.sections.items()}


def carve_sections(graph: SectionGraph, devices: Optional[Sequence] = None,
                   *, ranks: Optional[Sequence[int]] = None,
                   gpu_counts: Optional[Dict[str, int]] = None):
    """Without ``ranks``: give each section, in graph order, the next device
    of the list, as the JAX package carves its meshes, and return
    ``{section: device}``.  Every section runs on one device: a section
    whose ParallelConfig asks for more raises (its ranks are the way to
    several devices).  ``devices=None`` means every visible card.  A list
    may name one device more than once (``[torch.device("cuda:0")] * 2``
    runs two sections on one card, ``["cpu"] * 2`` on the host).

    With ``ranks`` (process ranks of the default group): give each section,
    in graph order, the next ``parallel.devices`` ranks and return
    ``(meshes, parallels)`` as the reference does, each mesh built by
    ``dist.sharding.section_mesh``.

    ``gpu_counts`` (``{section: devices}``, the planner's
    ``{name: sp.n_gpus for name, sp in plan(...).sections.items()}``)
    overrides a section's ``parallel.devices``, as in the reference: the
    extra or missing devices widen or narrow its ``tp``
    (:func:`section_parallel`), and the effective ParallelConfigs are the
    ones returned (and, without ``ranks``, checked to need one device
    each).  Building a mesh is collective over the
    world, so every rank carves every section.  A rank may sit in two
    sections only on a one-rank world (the card's case: each section then
    runs from its own thread); otherwise overlapping ranges raise
    ``ValueError``, and so does a list too short for every section."""
    parallels = _effective(graph, gpu_counts)
    if ranks is None:
        return _carve_devices(graph, devices, parallels)
    from repro_torch.dist.sharding import section_mesh

    ranks = [int(r) for r in ranks]
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else None)
    owner: Dict[int, str] = {}
    slices: Dict[str, List[int]] = {}
    off = 0
    for name in graph.sections:
        n = parallels[name].devices
        if off + n > len(ranks):
            raise ValueError(
                f"section {name!r}: needs ranks [{off}, {off + n}) of the "
                f"list but only {len(ranks)} are given")
        mine = ranks[off:off + n]
        for r in mine:
            if world is not None and not 0 <= r < world:
                raise ValueError(f"section {name!r}: rank {r} is outside "
                                 f"the world of {world}")
            if r in owner and world != 1:
                raise ValueError(
                    f"rank {r} is in sections {owner[r]!r} and {name!r}: "
                    "section ranks may overlap only on a one-rank world")
            owner.setdefault(r, name)
        slices[name] = mine
        off += n
    meshes = {name: section_mesh(slices[name], parallels[name], name)
              for name in graph.sections}
    return meshes, parallels


def _carve_devices(graph: SectionGraph, devices: Optional[Sequence],
                   parallels: Dict[str, Any]) -> Dict[str, torch.device]:
    devices = [torch.device(d) for d in
               (devices if devices is not None else visible_devices())]
    out: Dict[str, torch.device] = {}
    for off, name in enumerate(graph.sections):
        if parallels[name].devices != 1:
            raise NotImplementedError(
                f"section {name!r}: {parallels[name].devices} devices need "
                "section meshes: carve it by ranks= (ROADMAP.md, A6.2)")
        if off >= len(devices):
            raise ValueError(
                f"section {name!r}: needs device {off} but only "
                f"{len(devices)} are available — provide more devices; to "
                "run several sections on one card, name it once per section "
                "(devices=[torch.device('cuda:0')] * n_sections)")
        out[name] = devices[off]
    return out


#: runtimes of this process whose workers hold CUDA streams
_live_cuda = 0
_live_lock = threading.Lock()


def release_blas_workspaces() -> None:
    """Free the cuBLAS workspaces of this process.  PyTorch keeps one for
    every (cuBLAS handle, stream) pair that has run a GEMM, for the life of
    the process; a worker's stream is new with each runtime, so without
    this every runtime built after another leaves its workers' workspaces
    behind, each pinning the cached segment it sits in.  A workspace that
    is still needed is made again at the next GEMM on its stream."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()


def rank_device() -> torch.device:
    """This rank's device under the default process group: its current
    card under NCCL, the host otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclass
class Task:
    tag: str
    fn: Callable
    args: tuple
    #: optional result route: when set, ``sink((tag, out_or_TaskError))``
    #: is called on the worker thread instead of ``results.put``
    sink: Optional[Callable] = None


@dataclass(frozen=True)
class TaskError:
    """Failure of ONE task: rides the result queue in that task's slot."""
    tag: str
    traceback: str


class SectionWorker:
    """One worker thread per section; executes tasks FIFO.

    On a CUDA ``device`` the worker owns one ``torch.cuda.Stream`` and
    makes it (and the device) current inside its own thread, so every
    kernel its tasks launch, and autograd's backward of what they
    recorded, runs on that stream.  A failing task produces a
    :class:`TaskError` *result* (attached to the failing tag); subsequent
    tasks keep executing and draining normally."""

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = torch.device(device) if device is not None else None
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device is not None
                       and self.device.type == "cuda" else None)
        self.inbox: "queue.Queue[Optional[Task]]" = queue.Queue()
        self.results: "queue.Queue" = queue.Queue()
        self.error: Optional[str] = None        # last failure (diagnostics)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"section-{name}")
        self._thread.start()

    def _run(self):
        # mark this thread as the section's one launching thread, so the
        # affinity pass can attribute dispatch execution precisely
        worker_section.name = self.name
        if self.stream is not None:
            torch.cuda.set_device(self.device)
            torch.cuda.set_stream(self.stream)
        while True:
            task = self.inbox.get()
            if task is None:
                return
            deliver = task.sink or self.results.put
            try:
                out = task.fn(*task.args)
                deliver((task.tag, out))
            except Exception:
                tb = traceback.format_exc()
                self.error = tb
                deliver((task.tag, TaskError(task.tag, tb)))

    def submit(self, tag: str, fn: Callable, *args,
               sink: Optional[Callable] = None) -> None:
        self.inbox.put(Task(tag, fn, args, sink))

    def drain(self, n: int, timeout: float = 120.0,
              expect=None) -> Dict[str, Any]:
        """Collect ``n`` results.  With ``expect`` (a set of tags),
        results outside it are discarded instead of counted."""
        exp = None if expect is None else set(expect)
        out = {}
        while len(out) < n:
            try:
                tag, val = self.results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"section {self.name}: {n - len(out)}/{n} tasks still "
                    f"outstanding after {timeout}s (got {sorted(out)})")
            if exp is not None and tag not in exp:
                continue                     # stale result; drop it
            if isinstance(val, TaskError):
                raise RuntimeError(
                    f"section {self.name} task {val.tag!r} failed:\n"
                    f"{val.traceback}")
            out[tag] = val
        return out

    def stop(self):
        self.inbox.put(None)
        self._thread.join(timeout=10)


class MaestroRuntime:
    """Wires sections, their devices, workers and the message queue
    together.

    Without ``ranks`` every section is local and runs on its carved
    device.  With ``ranks`` the sections run on section meshes over the
    default process group (one process a rank): this rank keeps a worker
    for each section whose mesh holds it (``local_sections``), on its own
    device (:func:`rank_device`), and the message queue carries tensors to
    sections on other ranks point to point.  ``gpu_counts``: the devices of
    each section, from the planner (:func:`carve_sections`); ``parallel``
    gives the effective ParallelConfig each section was carved with."""

    def __init__(self, graph: SectionGraph,
                 devices: Optional[Sequence] = None, *,
                 ranks: Optional[Sequence[int]] = None,
                 gpu_counts: Optional[Dict[str, int]] = None):
        graph.validate()
        self.graph = graph
        if ranks is None:
            self.meshes = None
            self.parallels = _effective(graph, gpu_counts)
            self.section_devices = carve_sections(graph, devices,
                                                  gpu_counts=gpu_counts)
            self.local_sections = list(graph.sections)
            self.queue = MessageQueue()
        else:
            self.meshes, self.parallels = carve_sections(
                graph, ranks=ranks, gpu_counts=gpu_counts)
            self.local_sections = [n for n, m in self.meshes.items()
                                   if m.get_coordinate() is not None]
            dev = rank_device()
            self.section_devices = {n: dev for n in self.local_sections}
            self.queue = MessageQueue(transport=PeerTransport(dev))
        self.workers = {name: SectionWorker(name, self.device(name))
                        for name in self.local_sections}
        #: the cards this runtime's workers run on
        self._cards = sorted({w.device.index or 0
                              for w in self.workers.values()
                              if w.device is not None
                              and w.device.type == "cuda"})
        self._closed = False
        if self._cards:
            global _live_cuda
            with _live_lock:
                _live_cuda += 1

    def device(self, section: str) -> torch.device:
        """The device the section runs on (a local section's)."""
        return self.section_devices[section]

    def mesh(self, section: str):
        """The section's ``DeviceMesh`` (a runtime carved by ranks)."""
        if self.meshes is None:
            raise ValueError("this runtime was carved by devices, not ranks: "
                             "its sections have no meshes")
        return self.meshes[section]

    def parallel(self, section: str):
        """The section's effective ParallelConfig (its ``tp`` widened or
        narrowed by ``gpu_counts``)."""
        return self.parallels[section]

    def build_train_step(self, section: str, model, shape, **kw):
        """``train.step.build_train_step`` on the section's mesh and
        ParallelConfig (a runtime carved by ranks)."""
        if self.meshes is None:
            raise NotImplementedError(
                f"MaestroRuntime.build_train_step({section!r}): a train step "
                "on a section's ranks needs its mesh: carve the runtime by "
                "ranks= (ROADMAP.md, A6.2)")
        from repro_torch.train import step as step_mod
        return step_mod.build_train_step(model, self.parallel(section),
                                         shape, mesh=self.mesh(section),
                                         **kw)

    def executor(self):
        """A :class:`repro_torch.core.executor.CompoundExecutor` over this
        runtime's workers and message queue."""
        from repro_torch.core.executor import CompoundExecutor
        return CompoundExecutor(graph=self.graph, runtime=self)

    def shutdown(self):
        """Stop the workers and close the queue.  The last runtime of the
        process with CUDA workers to shut down also releases the cuBLAS
        workspaces (:func:`release_blas_workspaces`) once its streams'
        work is done; runtimes still alive would race it for them."""
        if self._closed:
            return
        self._closed = True
        for w in self.workers.values():
            w.stop()
        self.queue.close()
        if self._cards:
            global _live_cuda
            for card in self._cards:
                torch.cuda.synchronize(card)
            with _live_lock:
                _live_cuda -= 1
                if _live_cuda == 0:
                    release_blas_workspaces()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
