"""Compound executor: runs a :class:`SectionGraph` end to end (§3.3–§3.4).
Counterpart of ``repro/core/executor.py``.

This is the layer that turns the wavefront scheduler from a planning
artifact into the thing that *executes* training:

* each section runs its steps on its own device from its
  :class:`~repro_torch.core.runtime.SectionWorker` thread (and, on a
  card, its own CUDA stream);
* cross-section tensors flow through the :class:`MessageQueue` — a
  blocking ``pull`` *is* the cross-section data dependency, so dispatching
  every task up front in schedule order is deadlock-free whenever the
  per-section orders are mutually consistent (which the wavefront merge
  guarantees: it only permutes samples, never inverts an edge);
* the *dispatch order* per section comes from
  :func:`repro_torch.core.scheduler.schedule_global_batch` (cost-model
  durations) — or FIFO when reordering is disabled — so reordering
  actually happens at runtime, not just in the simulator;
* every task's realized ``(start, end)`` wall time is recorded: on a card
  the task's end synchronises its section's own stream before ``end`` is
  stamped (other sections' streams run on), so benches report *executed*
  makespan / section utilization rather than simulated ones;
* each task records itself for the affinity pass
  (:func:`repro_torch.analysis.affinity.record`, a no-op unless a dispatch
  trace is on) and runs inside the profiler range
  :func:`~repro_torch.analysis.affinity.task_range`, which
  ``check_profile`` reads.

Data-dependent activation is expressed by simply not emitting a dispatch:
a sample (or microbatch) that does not activate a section produces no task
for that section's worker.

On section meshes (a runtime carved by ranks) every rank computes the
same plan and submits the same dispatch list; the executor keeps the
dispatches of the sections this rank runs, so each section's dispatch
order and timeline are its own, as on one process.

Cross-iteration streaming (:class:`StreamSession`): dispatches carry an
iteration index, workers consume one continuous per-section FIFO stream
spanning iterations, and results drain asynchronously (event-driven, no
polling) into per-iteration :class:`ExecutionResult`s — iteration ``i+1``'s
tasks for a section may start the moment that section's own ``i`` tasks
finish, without waiting for the other sections' tails.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import affinity
from repro_torch.core.graph import SectionGraph
from repro_torch.core.messages import MessageQueue
from repro_torch.core.runtime import SectionWorker, TaskError
from repro_torch.core.scheduler import (ScheduleResult,
                                        merge_fanout_schedules,
                                        partition_global_batch,
                                        wavefront_schedule)
from repro_torch.core.simulator import Sample

_log = logging.getLogger("repro_torch.executor")


@dataclass(frozen=True)
class Dispatch:
    """One unit of section work: ``fn`` runs on ``section``'s worker
    thread; cross-section inputs/outputs move through the MessageQueue
    inside ``fn`` (a blocking pull realizes the dependency edge)."""
    section: str
    tag: str
    fn: Callable[[], Any]


@dataclass(frozen=True)
class TimelineEvent:
    section: str
    tag: str
    start: float          # seconds since ExecutionResult.t0
    end: float


@dataclass
class ExecutionResult:
    """Realized execution of one dispatch list."""
    results: Dict[Tuple[str, str], Any]
    timeline: List[TimelineEvent]
    t0: float
    dispatch_order: Dict[str, List[str]]    # per-section submitted order

    @property
    def makespan(self) -> float:
        if not self.timeline:
            return 0.0
        return max(e.end for e in self.timeline) - min(
            e.start for e in self.timeline)

    @property
    def task_counts(self) -> Dict[str, int]:
        """Submitted tasks per section (dispatch-list view — includes
        tasks whose realized events are still being merged)."""
        return {name: len(tags)
                for name, tags in self.dispatch_order.items()}

    @property
    def completion_order(self) -> List[Tuple[str, str]]:
        return [(e.section, e.tag)
                for e in sorted(self.timeline, key=lambda e: e.end)]

    def section_events(self, section: str) -> List[TimelineEvent]:
        return [e for e in self.timeline if e.section == section]

    def busy(self, section: str) -> float:
        return sum(e.end - e.start for e in self.section_events(section))

    def utilization(self, section: str) -> float:
        """Busy fraction of the section's realized span (first start →
        last end) — the executed analogue of SimResult.critical_utilization
        (idle inside the span = stalls the scheduler failed to hide)."""
        ev = self.section_events(section)
        if not ev:
            return 1.0
        span = max(e.end for e in ev) - min(e.start for e in ev)
        return self.busy(section) / span if span > 0 else 1.0


def _block(value, stream):
    """Wait for the section's own stream (a card's) so the task's end time
    is realized; nothing on the CPU, where the work is done on return.  An
    asynchronous CUDA error surfacing here propagates — the worker
    attaches it to THIS task instead of returning a poisoned result."""
    if stream is not None:
        stream.synchronize()
    return value


_task_local = threading.local()


def mark_start():
    """Re-stamp the current task's realized start time.

    Call right after a blocking dependency wait (a MessageQueue pull) so
    the stall is recorded as section *idle* rather than busy — without
    this, a consumer that waits inside its task window reads ~100%
    utilization no matter how badly the schedule stalls it."""
    slot = getattr(_task_local, "slot", None)
    if slot is not None:
        slot["start"] = time.perf_counter()


class _IterationState:
    """In-flight bookkeeping of one submitted iteration."""

    __slots__ = ("seq", "t0", "order", "n_expected", "done", "results",
                 "events", "error", "aborted")

    def __init__(self, seq: int, t0: float, order: Dict[str, List[str]]):
        self.seq = seq
        self.t0 = t0
        self.order = order                  # section -> tags (FIFO order)
        self.n_expected = sum(len(t) for t in order.values())
        self.done: set = set()              # completed (section, tag)
        self.results: Dict[Tuple[str, str], Any] = {}
        self.events: List[TimelineEvent] = []
        self.error: Optional[Tuple[str, str, TaskError]] = None
        self.aborted = False


class StreamSession:
    """Streaming view over an executor's workers: iteration-indexed
    submits feed one continuous per-section FIFO stream, results drain
    event-driven into per-iteration :class:`ExecutionResult`s.

    ``submit(i, dispatches)`` enqueues iteration ``i``'s tasks behind
    whatever is already streaming — per-section worker FIFO serializes a
    section's own iterations while different sections overlap freely.
    ``retire(i)`` blocks (on a condition variable, not a poll) until
    iteration ``i`` completes and returns its realized execution.  Every
    result is routed to its iteration through a per-task sink, so a
    leftover from an aborted iteration can never satisfy — or silently
    poison — another iteration's drain; a straggling :class:`TaskError`
    that lands after its iteration was already aborted is *logged*
    rather than dropped."""

    def __init__(self, executor: "CompoundExecutor"):
        self.ex = executor
        self._cv = threading.Condition()
        self._iters: Dict[int, _IterationState] = {}
        self._pending: List[int] = []       # submitted, not yet retired
        self._last_seq: Optional[int] = None

    # ------------------------------------------------------------------ #
    def submit(self, iteration: int,
               dispatches: Sequence[Dispatch]) -> None:
        """Enqueue one iteration's dispatch list onto the section
        streams (per-section FIFO in list order)."""
        per_section: Dict[str, List[Dispatch]] = {}
        for d in dispatches:
            if d.section in self.ex.remote:
                continue        # another rank runs that section's tasks
            assert d.section in self.ex.workers, d.section
            per_section.setdefault(d.section, []).append(d)
        for name, lst in per_section.items():
            tags = [d.tag for d in lst]
            assert len(set(tags)) == len(tags), \
                f"duplicate dispatch tags for section {name}: {tags}"
        with self._cv:
            assert self._last_seq is None or iteration > self._last_seq, \
                (f"iteration indices must be strictly increasing: got "
                 f"{iteration} after {self._last_seq}")
            assert iteration not in self._iters, iteration
            self._last_seq = iteration
            st = _IterationState(
                iteration, time.perf_counter(),
                {n: [d.tag for d in lst]
                 for n, lst in per_section.items()})
            self._iters[iteration] = st
            self._pending.append(iteration)
        for name, lst in per_section.items():
            w = self.ex.workers[name]
            for d in lst:
                w.submit(f"i{iteration}:{d.tag}", self._timed(st, d),
                         sink=self._sink(st, d))

    @property
    def in_flight(self) -> int:
        with self._cv:
            return len(self._pending)

    # ------------------------------------------------------------------ #
    def _timed(self, st: _IterationState, d: Dispatch):
        stream = self.ex.workers[d.section].stream

        def timed():
            _task_local.slot = {"start": time.perf_counter()}
            affinity.record(d.section)
            with affinity.task_range(d.section):
                return _block(d.fn(), stream)
        return timed

    def _sink(self, st: _IterationState, d: Dispatch):
        def deliver(item):
            _tag, out = item
            end = time.perf_counter()
            slot = getattr(_task_local, "slot", None) or {"start": end}
            _task_local.slot = None
            with self._cv:
                st.events.append(TimelineEvent(
                    d.section, d.tag, slot["start"] - st.t0,
                    end - st.t0))
                st.results[(d.section, d.tag)] = out
                st.done.add((d.section, d.tag))
                if isinstance(out, TaskError):
                    if st.aborted:
                        # a poisoned task completing after its iteration
                        # already aborted is logged, not dropped
                        _log.warning(
                            "stale TaskError after iteration %d aborted: "
                            "section %s task %r failed:\n%s", st.seq,
                            d.section, d.tag, out.traceback)
                    elif st.error is None:
                        st.error = (d.section, d.tag, out)
                self._cv.notify_all()
        return deliver

    # ------------------------------------------------------------------ #
    def retire(self, iteration: Optional[int] = None, *,
               timeout: float = 300.0) -> ExecutionResult:
        """Wait (event-driven) for one iteration to complete and return
        its realized execution.  Defaults to the oldest in flight.  A
        failed task raises that task's traceback immediately — without
        waiting for the rest of the iteration."""
        with self._cv:
            if iteration is None:
                if not self._pending:
                    raise RuntimeError(
                        "stream session: no iteration in flight")
                iteration = self._pending[0]
            st = self._iters.get(iteration)
            if st is None:
                raise KeyError(
                    f"iteration {iteration} is not in flight")
            deadline = time.monotonic() + timeout
            while True:
                if st.error is not None:
                    st.aborted = True
                    self._pending.remove(iteration)
                    del self._iters[iteration]
                    name, tag, err = st.error
                    raise RuntimeError(
                        f"section {name} task {tag!r} failed:\n"
                        f"{err.traceback}")
                if len(st.done) == st.n_expected:
                    self._pending.remove(iteration)
                    del self._iters[iteration]
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(timeout=remaining):
                    left: Dict[str, List[str]] = {}
                    for name, tags in st.order.items():
                        open_tags = [t for t in tags
                                     if (name, t) not in st.done]
                        if open_tags:
                            left[name] = open_tags
                    raise TimeoutError(
                        f"executor: tasks still outstanding after "
                        f"{timeout}s: {left}")
        events = sorted(st.events, key=lambda e: (e.start, e.end))
        return ExecutionResult(dict(st.results), events, st.t0,
                               dict(st.order))


class CompoundExecutor:
    """Generic section-graph executor over workers + message queue.

    Construct from a :class:`~repro_torch.core.runtime.MaestroRuntime`
    (shares its workers/queue/devices) or standalone from section names
    (tests / host-side orchestration; the workers then run on the
    host)."""

    def __init__(self, graph: Optional[SectionGraph] = None, *,
                 runtime=None, sections: Optional[Sequence[str]] = None,
                 queue: Optional[MessageQueue] = None):
        self.graph = graph if graph is not None else (
            runtime.graph if runtime is not None else None)
        #: sections whose tasks run on other ranks (section meshes): their
        #: dispatches are dropped here, so every rank can submit the same
        #: iteration plan
        self.remote: set = set()
        if runtime is not None:
            self.workers = runtime.workers
            self.queue = runtime.queue
            self._owns_workers = False
            self.remote = set(runtime.graph.sections) - set(
                runtime.local_sections)
        else:
            names = list(sections if sections is not None
                         else self.graph.sections)
            self.workers = {n: SectionWorker(n) for n in names}
            self.queue = queue if queue is not None else MessageQueue()
            self._owns_workers = True

    def session(self) -> StreamSession:
        """A new cross-iteration streaming session over this executor's
        workers (see :class:`StreamSession`)."""
        return StreamSession(self)

    # ------------------------------------------------------------------ #
    def run(self, dispatches: Sequence[Dispatch], *,
            timeout: float = 300.0) -> ExecutionResult:
        """Execute the dispatch list: per-section FIFO in list order,
        sections concurrent, dependencies resolved by blocking queue
        pulls inside the dispatch fns.  Returns the realized execution.

        One-shot convenience over :class:`StreamSession` (submit a single
        iteration, retire it) — sink routing guarantees a stale result
        from an earlier aborted run can never satisfy this run's drain."""
        s = StreamSession(self)
        s.submit(0, dispatches)
        return s.retire(0, timeout=timeout)

    def shutdown(self):
        if self._owns_workers:
            for w in self.workers.values():
                w.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


# --------------------------------------------------------------------------- #
# Schedule-driven dispatch order (Algorithm 1 at execution time)
# --------------------------------------------------------------------------- #
def order_samples(samples: Sequence[Sample], *, reorder: bool = True
                  ) -> Tuple[List[int], Optional[ScheduleResult]]:
    """The per-iteration sample dispatch order: wavefront (Algorithm 1 on
    cost-model 6-tuples) when ``reorder``, else FIFO.  Returns the
    permutation (original sample indices in dispatch order) and the
    ScheduleResult (None for FIFO)."""
    if not reorder:
        return list(range(len(samples))), None
    res = wavefront_schedule(samples)
    return [s.idx for s in res.order], res


def order_global_batch(samples: Sequence[Sample], dp: int, *,
                       reorder: bool = True
                       ) -> Tuple[List[List[int]], List[Tuple[int, int]]]:
    """DP>1 composition: partition the global batch over ``dp`` consumer
    ranks balancing activated-section load, Algorithm 1 per rank, fanout
    merge for the shared producer.  Returns (per-rank sample orders, the
    producer's merged ``(rank, sample_idx)`` order)."""
    if not reorder:
        n = len(samples)
        assert n % dp == 0, (n, dp)
        per = n // dp
        ranks = [list(range(r * per, (r + 1) * per)) for r in range(dp)]
        merged = merge_fanout_schedules(
            [[samples[i] for i in rank] for rank in ranks])
        return ranks, [(r, s.idx) for r, s in merged]
    parts = partition_global_batch(samples, dp)
    scheduled = [wavefront_schedule(p).order for p in parts]
    merged = merge_fanout_schedules(scheduled)
    return ([[s.idx for s in sched] for sched in scheduled],
            [(r, s.idx) for r, s in merged])


def chunk_microbatches(order: Sequence[int], mbs: int) -> List[List[int]]:
    """Contiguous microbatches of the dispatch order (the executed
    analogue of the shard-major microbatch layout: reordering decides
    *which samples share a microbatch*)."""
    assert len(order) % mbs == 0, (len(order), mbs)
    return [list(order[i:i + mbs]) for i in range(0, len(order), mbs)]
