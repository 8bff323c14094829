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
"""
from __future__ import annotations

import queue
import threading
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.analysis.affinity import worker_section
from repro_torch.core.graph import SectionGraph
from repro_torch.core.messages import MessageQueue


def visible_devices() -> List[torch.device]:
    """Every CUDA card this process sees (none on a CPU-only host)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def carve_sections(graph: SectionGraph, devices: Optional[Sequence] = None
                   ) -> Dict[str, torch.device]:
    """Give each section, in graph order, the next device of the list, as
    the JAX package carves its meshes.  Every section runs on one device:
    a section whose ParallelConfig asks for more raises (the multi-device
    sections are ROADMAP.md, A6).

    ``devices=None`` means every visible card.  A list may name one device
    more than once (``[torch.device("cuda:0")] * 2`` runs two sections on
    one card, ``["cpu"] * 2`` on the host)."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else visible_devices())]
    out: Dict[str, torch.device] = {}
    for off, (name, sec) in enumerate(graph.sections.items()):
        if sec.parallel.devices != 1:
            raise NotImplementedError(
                f"section {name!r}: {sec.parallel.devices} devices need the "
                "multi-device regimes, which are not ported yet; see "
                "ROADMAP.md, A6")
        if off >= len(devices):
            raise ValueError(
                f"section {name!r}: needs device {off} but only "
                f"{len(devices)} are available — provide more devices; to "
                "run several sections on one card, name it once per section "
                "(devices=[torch.device('cuda:0')] * n_sections)")
        out[name] = devices[off]
    return out


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
    together."""

    def __init__(self, graph: SectionGraph,
                 devices: Optional[Sequence] = None):
        graph.validate()
        self.graph = graph
        self.section_devices = carve_sections(graph, devices)
        self.queue = MessageQueue()
        self.workers = {name: SectionWorker(name, self.device(name))
                        for name in graph.sections}

    def device(self, section: str) -> torch.device:
        """The device the section runs on."""
        return self.section_devices[section]

    def build_train_step(self, section: str, model, shape, **kw):
        raise NotImplementedError(
            f"MaestroRuntime.build_train_step({section!r}): a train step on "
            "a section's carved device group needs the multi-device "
            "regimes, which are not ported yet; see ROADMAP.md, A6")

    def executor(self):
        """A :class:`repro_torch.core.executor.CompoundExecutor` over this
        runtime's workers and message queue."""
        from repro_torch.core.executor import CompoundExecutor
        return CompoundExecutor(graph=self.graph, runtime=self)

    def shutdown(self):
        for w in self.workers.values():
            w.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
