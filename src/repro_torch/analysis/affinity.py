"""Section-stream affinity checker (analysis pass ``affinity``).
Counterpart of ``repro/analysis/affinity.py``.

The JAX package's rule is one launching thread per section mesh, with the
meshes disjoint (XLA CPU deadlocks when two threads interleave collective
launches on one device set).  The port shares one card between sections
by design (ROADMAP.md, "Sections on one card"): each section runs from its
own worker thread on its own CUDA stream, and the ordering between
sections is the events the message queue records and waits on.  This pass
checks that invariant from three directions:

* **static wiring** (:func:`check_wiring`) — every section has exactly one
  live worker thread, named ``section-<name>``; on a card each worker owns
  a ``torch.cuda.Stream`` distinct from every other section's and from
  the device's default stream;
* **dispatch trace** (:func:`tracking` / :func:`record` /
  :func:`check_trace`) — a record, taken inside the executor's task
  wrapper, of which thread ran each dispatch: every dispatch of a section
  ran on that section's own worker (``SectionWorker._run`` marks its
  thread in :data:`worker_section`);
* **profiler trace** (:func:`check_profile`) — every kernel launched for
  a section ran on that section's stream, and no kernel the main thread
  launched (the batch copies, ordered by the submit event) ran on a
  section's stream.  The executor opens :func:`task_range` around each
  task; a kernel belongs to the section whose range encloses the operator
  that launched it, or, for a backward operator run by autograd's device
  thread, to the section whose thread ran its forward.
"""
from __future__ import annotations

import collections
import contextlib
import re
import threading
from typing import Dict, List, Optional, Set, Tuple

import torch
from torch.autograd import DeviceType

from repro_torch.analysis.core import AnalysisReport, Severity, register

# ---------------------------------------------------------------------------
# dispatch-trace mode: enabled by the `tracking()` context manager; the
# executor's task wrapper calls `record()` per executed dispatch (a
# no-op when tracing is off — one truthiness check on the hot path).
# ---------------------------------------------------------------------------
_trace_lock = threading.Lock()
_trace: Optional[List[Tuple[str, str, Optional[str]]]] = None

#: thread-local marker set by SectionWorker._run: which section's worker
#: this thread is (None on the main thread / foreign threads)
worker_section = threading.local()

#: prefix of the profiler range the executor opens around each task
TASK_RANGE = "section:"


def task_range(section: str):
    """The ``torch.profiler`` range around one task of ``section``, which
    :func:`check_profile` reads; a null context while no profiler
    records, so an untraced task pays one check.  (The profiler's own
    ``torch.autograd._profiler_enabled()`` is per thread: it reads False
    on a worker thread while the main thread's profiler records it.)"""
    if not torch.autograd.profiler._is_profiler_enabled:
        return contextlib.nullcontext()
    return torch.profiler.record_function(TASK_RANGE + section)


def profile_config():
    """The ``experimental_config`` of a ``torch.profiler.profile`` whose
    trace :func:`check_profile` reads: it records the operators of every
    thread (the section workers, and autograd's device threads running
    their backward), where by default only the profiling thread's are."""
    from torch._C._profiler import _ExperimentalConfig
    return _ExperimentalConfig(profile_all_threads=True)


def record(section: str) -> None:
    """Record one executed dispatch: (section, thread name, owning
    worker section).  Called by the executor wrapper; no-op unless
    :func:`tracking` is active."""
    if _trace is None:
        return
    t = threading.current_thread()
    owner = getattr(worker_section, "name", None)
    with _trace_lock:
        if _trace is not None:
            _trace.append((section, t.name, owner))


@contextlib.contextmanager
def tracking():
    """Enable the dispatch trace; yields the live trace list."""
    global _trace
    with _trace_lock:
        prev, _trace = _trace, []
        trace = _trace
    try:
        yield trace
    finally:
        with _trace_lock:
            _trace = prev


def check_trace(trace: List[Tuple[str, str, Optional[str]]]
                ) -> AnalysisReport:
    """Verify every recorded dispatch of a section ran on that section's
    own worker thread."""
    rep = AnalysisReport("affinity")
    by_section: Dict[str, Set[Tuple[str, Optional[str]]]] = {}
    for section, thread, owner in trace:
        by_section.setdefault(section, set()).add((thread, owner))
    for section, launchers in sorted(by_section.items()):
        bad = [(t, o) for t, o in launchers if o != section]
        if bad:
            who = ", ".join(
                f"thread {t!r}" + (f" (worker of {o!r})" if o else
                                   " (not a section worker)")
                for t, o in sorted(bad, key=repr))
            rep.add(Severity.ERROR, "affinity.foreign-thread", section,
                    f"dispatches of section {section!r} executed on "
                    f"{who} — a section's tasks must run on its own "
                    "SectionWorker, whose thread holds the section's "
                    "stream as its current stream")
        if len(launchers) > 1:
            rep.add(Severity.ERROR, "affinity.multiple-threads", section,
                    f"dispatches of section {section!r} executed on "
                    f"{len(launchers)} distinct threads "
                    f"({sorted(t for t, _ in launchers)})")
        if not bad and len(launchers) == 1:
            rep.add(Severity.INFO, "affinity.trace", section,
                    f"{sum(1 for s, _, _ in trace if s == section)} "
                    f"dispatches, all on {next(iter(launchers))[0]!r}")
    return rep


# ---------------------------------------------------------------------------
# static wiring check
# ---------------------------------------------------------------------------
def _stream_key(stream):
    return getattr(stream, "cuda_stream", id(stream))


@register("affinity")
def check_wiring(runtime) -> AnalysisReport:
    """Static affinity check over a runtime's wiring: one live worker a
    section, named ``section-<name>``, and on a card one stream a worker,
    shared with no other section and not the device's default stream.
    ``runtime`` needs ``section_devices`` (section -> device) and
    ``workers`` (section -> SectionWorker-like, with ``stream`` and
    ``_thread``); ``MaestroRuntime`` and ``CompoundRuntime`` (via ``.rt``)
    qualify."""
    rt = getattr(runtime, "rt", runtime)
    rep = AnalysisReport("affinity")
    devices = getattr(rt, "section_devices", {})
    workers = getattr(rt, "workers", {})
    owned: Dict[object, str] = {}
    n_streams = 0
    for name, dev in devices.items():
        w = workers.get(name)
        if w is None:
            rep.add(Severity.ERROR, "affinity.no-worker", name,
                    f"section {name!r} has a device but no worker thread "
                    "— its tasks would launch from arbitrary threads")
            continue
        th = getattr(w, "_thread", None)
        if th is not None and not th.is_alive():
            rep.add(Severity.ERROR, "affinity.dead-worker", name,
                    f"section {name!r}'s worker thread is not alive")
        if th is not None and th.name != f"section-{name}":
            rep.add(Severity.ERROR, "affinity.thread-name", name,
                    f"section {name!r}'s worker thread is named "
                    f"{th.name!r}, not 'section-{name}'")
        stream = getattr(w, "stream", None)
        if stream is None:
            if torch.device(dev).type == "cuda":
                rep.add(Severity.ERROR, "affinity.no-stream", name,
                        f"section {name!r} runs on {dev} without a stream "
                        "of its own: its kernels would queue behind every "
                        "other section's")
            continue
        n_streams += 1
        key = _stream_key(stream)
        if (torch.device(dev).type == "cuda"
                and key == torch.cuda.default_stream(dev).cuda_stream):
            rep.add(Severity.ERROR, "affinity.default-stream", name,
                    f"section {name!r}'s stream is {dev}'s default stream, "
                    "which the main thread's copies use")
        if key in owned:
            rep.add(Severity.ERROR, "affinity.shared-stream",
                    f"{owned[key]}|{name}",
                    f"sections {owned[key]!r} and {name!r} share one "
                    "stream: each would wait on the other's kernels, and "
                    "the events the message queue records would order "
                    "nothing between them")
        else:
            owned[key] = name
    for name in workers:
        if name not in devices:
            rep.add(Severity.WARNING, "affinity.no-device", name,
                    f"worker {name!r} has no section device — nothing to "
                    "check")
    if rep.ok:
        rep.add(Severity.INFO, "affinity.wiring", "runtime",
                f"{len(devices)} sections, one live worker each, "
                f"{n_streams} on streams of their own")
    return rep


# ---------------------------------------------------------------------------
# profiler-trace check
# ---------------------------------------------------------------------------
# a CUDA API call (cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, ...): the profiler gives it the id of the device work
# it launched, and nests it under the operator that made it
_LAUNCH = re.compile(r"^cu(da)?[A-Z]")
# the span the profiler records when CUPTI asks it for a fresh activity
# buffer in the middle of recording a launch: it files that one launch
# call, with no operator above it, under its own thread (ROADMAP.md, C10)
_BUFFER_REQUEST = "Activity Buffer Request"


def _enclosing(call) -> Tuple[Optional[str], int]:
    """(the task range enclosing a launch on its own thread, or None; the
    forward thread of the innermost enclosing backward node, or 0)."""
    fwd, e = 0, call
    while e is not None:
        if e.name.startswith(TASK_RANGE):
            return e.name[len(TASK_RANGE):], fwd
        if not fwd and getattr(e, "fwd_thread", 0) not in (0, e.thread):
            fwd = e.fwd_thread
        e = e.cpu_parent
    return None, fwd


def check_profile(prof, runtime) -> AnalysisReport:
    """Check a ``torch.profiler`` trace of a runtime's iterations: every
    kernel (and copy) a section launched ran on one stream, that section's
    alone, and no kernel the main thread launched ran on a section's
    stream.  ``prof`` is a finished ``torch.profiler.profile`` taken with
    ``experimental_config=profile_config()`` (or anything whose
    ``events()`` gives such ``FunctionEvent``s); ``runtime`` names the
    sections.

    A kernel is matched to its launch call by id; the call belongs to the
    task range enclosing it on its thread, or, in a backward node run by
    autograd's device thread, to the section whose worker thread ran the
    node's forward (``fwd_thread``), or to the section whose task ranges
    ran on its thread; else to the main thread.  A launch call with no
    operator above it whose thread's next event is the profiler's
    activity buffer request was filed under the profiler's thread, not
    its launcher's: it is counted apart."""
    rt = getattr(runtime, "rt", runtime)
    sections = set(getattr(rt, "workers", {}))
    rep = AnalysisReport("affinity")
    events = list(prof.events())
    calls = {e.id: e for e in events
             if e.device_type == DeviceType.CPU and _LAUNCH.match(e.name)}
    ran = {e.name[len(TASK_RANGE):] for e in events
           if e.device_type == DeviceType.CPU
           and e.name.startswith(TASK_RANGE)}
    found = []                 # (stream, kernel, call, range, fwd thread)
    unlinked = 0
    for e in events:
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        call = calls.get(e.id)
        if call is None:
            unlinked += 1
            continue
        found.append([e.device_resource_id, e.name, call,
                      *_enclosing(call)])
    # a launch call the profiler did not nest (its interval overlaps its
    # operator's only partly, the two clocks being aligned after the
    # fact): the innermost operator of its thread whose interval holds
    # the call's start stands in for its parent
    loose = [f for f in found if f[3] is None and not f[4]
             and f[2].cpu_parent is None]
    if loose:
        by_thread = collections.defaultdict(list)
        for e in events:
            if e.device_type == DeviceType.CPU and not _LAUNCH.match(e.name):
                by_thread[e.thread].append(e)
        for f in loose:
            t = f[2].time_range.start
            around = [e for e in by_thread[f[2].thread]
                      if e.time_range.start <= t < e.time_range.end]
            if around:
                f[3:] = _enclosing(min(around, key=lambda e: e.time_range
                                       .end - e.time_range.start))
    # the worker threads: those on which a task range enclosed a launch
    section_threads = {call.thread: name for _, _, call, name, _ in found
                       if name is not None}
    # autograd's device threads, which run backward nodes for whichever
    # section recorded them: a launch there that reaches no node is not
    # the main thread's
    backward_threads = {e.thread for e in events
                        if e.device_type == DeviceType.CPU
                        and getattr(e, "fwd_thread", 0) not in (0, e.thread)}

    def buffered(call) -> bool:
        t = call.time_range.start
        after = [e for e in events if e.device_type == DeviceType.CPU
                 and e.thread == call.thread and e is not call
                 and e.time_range.start >= t]
        return bool(after) and min(
            after, key=lambda e: e.time_range.start).name == _BUFFER_REQUEST

    # (owner, stream) -> kernel count, and the first such kernel with the
    # chain of operators that launched it; owner None is the main thread
    launched: Dict[Tuple[Optional[str], int], int] = collections.Counter()
    example: Dict[Tuple[Optional[str], int], str] = {}
    unresolved = refiled = 0
    for sid, kernel, call, name, fwd in found:
        owner = name or section_threads.get(fwd) \
            or section_threads.get(call.thread)
        if owner is None and call.thread in backward_threads:
            unresolved += 1
            continue
        if owner is None and call.cpu_parent is None and buffered(call):
            refiled += 1
            continue
        key = (owner if owner in sections else None, sid)
        launched[key] += 1
        example.setdefault(key, f"{kernel[:60]} from {_chain(call)}")
    streams: Dict[Optional[str], Dict[int, int]] = {}
    for (owner, sid), n in launched.items():
        streams.setdefault(owner, {})[sid] = n
    if unlinked and not found:
        rep.add(Severity.ERROR, "affinity.unlinked", "trace",
                f"none of the trace's {unlinked} kernels matches a launch "
                "call: the trace cannot attribute them")
    if launched and sections and not ran:
        rep.add(Severity.ERROR, "affinity.no-task-ranges", "trace",
                "the trace holds kernels but no task range: take it with "
                "experimental_config=affinity.profile_config(), which "
                "records the worker threads' operators")
    home: Dict[str, int] = {}
    for name in sorted(sections):
        mine = streams.get(name, {})
        if not mine:
            if name in ran and launched:
                rep.add(Severity.ERROR, "affinity.unattributed", name,
                        f"section {name!r} ran tasks in the trace but no "
                        "kernel is attributed to it: the trace cannot show "
                        "its stream")
            continue
        home[name] = max(mine, key=mine.get)
        if len(mine) > 1:
            odd = min(mine, key=mine.get)
            rep.add(Severity.ERROR, "affinity.foreign-stream", name,
                    f"section {name!r} launched kernels on {len(mine)} "
                    f"streams ({_per_stream(mine)}): all of a section's "
                    f"kernels run on its own stream; on stream {odd}: "
                    f"{example[(name, odd)]}")
    by_stream: Dict[int, List[str]] = {}
    for name, sid in home.items():
        by_stream.setdefault(sid, []).append(name)
    for sid, names in sorted(by_stream.items()):
        if len(names) > 1:
            rep.add(Severity.ERROR, "affinity.shared-stream", "|".join(names),
                    f"sections {names} ran their kernels on one stream "
                    f"({sid})")
    main = streams.get(None, {})
    for sid, n in sorted(main.items()):
        if sid in by_stream:
            rep.add(Severity.ERROR, "affinity.main-on-section-stream",
                    "|".join(by_stream[sid]),
                    f"{n} kernels launched outside every section ran on "
                    f"stream {sid}, the stream of {by_stream[sid]}: the "
                    "main thread's work is ordered before a section's by "
                    "the submit event, not by sharing its stream; first: "
                    f"{example[(None, sid)]}")
    if rep.ok:
        for name, sid in sorted(home.items()):
            rep.add(Severity.INFO, "affinity.profile", name,
                    f"{streams[name][sid]} kernels, all on stream {sid}")
        rep.add(Severity.INFO, "affinity.profile", "main",
                f"{sum(main.values())} kernels launched outside the "
                f"sections, on streams {sorted(main)}; {unlinked} without "
                f"a launch call in the trace, {unresolved} launched by "
                f"autograd outside any backward node, {refiled} filed by "
                "the profiler beside an activity buffer request")
    return rep


def _chain(call) -> str:
    """A launch call's enclosing operators, innermost first."""
    out, e = [], call
    while e is not None and len(out) < 8:
        fwd = getattr(e, "fwd_thread", 0)
        out.append(f"{e.name[:40]} (thread {e.thread}"
                   + (f", forward on {fwd})" if fwd else ")"))
        e = e.cpu_parent
    return " < ".join(out)


def _per_stream(per_stream: Dict[int, int]) -> str:
    return ", ".join(f"stream {s}: {n}" for s, n in sorted(per_stream.items()))
