"""Dispatch-graph deadlock detector (analysis pass ``deadlock``).  The
port's own copy of ``repro/analysis/deadlock.py``: pure graph logic over
a :class:`~repro_torch.core.workload.WorkloadSpec`.

The streaming runtime's only synchronization primitive is the blocking
``MessageQueue.pull`` — a pull *is* the cross-section dependency edge,
and a deadlock is a wait cycle through pulls and per-section worker
FIFOs.  This pass proves, statically from a :class:`WorkloadSpec`, that
the dispatch order ``CompoundRuntime.submit_iteration`` emits can never
enter such a cycle — or reports the cycle, naming every section and
queue edge on it, *before* anything hangs in ``drain()``.

The model mirrors ``submit_iteration`` exactly:

* every section's tasks for one iteration, in per-section FIFO stream
  order — producers ``fwd0..fwdN-1`` (+ ``bwd0..bwdN-1`` when
  trainable), the critical section ``mb0..mbN-1``, then ``upd`` for
  every trainable section;
* each task is an ordered list of *events*: blocking ``pull``\\ s and
  non-blocking ``push``\\ es with the exact queue keys the runtime uses
  (``<scope>/<src>.<port>.<i>``, cotangents ``<scope>/ct.*``, and the
  grad-norm rendezvous ``<scope>/gnorm.<section>`` — pushed to every
  peer BEFORE any peer's vector is pulled, the push-before-pull pattern
  whose deadlock-freedom this pass now machine-checks);
* with ``lookahead > 0`` two consecutive iteration scopes are chained
  onto the same per-section streams, so cross-iteration FIFO coupling
  (``upd(i)`` before ``fwd(i+1)``) is part of the proof obligation.

Wait-graph semantics: an event depends on its predecessor in its
section stream (worker FIFO), and a ``pull`` additionally depends on
the matching ``push`` event.  Pushes never block, so this graph is
acyclic **iff** the workload cannot deadlock under any task timing; a
``pull`` with no matching ``push`` anywhere is a guaranteed hang and is
reported as its own error.

Activation predicates are modeled as all-active: the runtime gates the
push and the pull of an edge on the *same* dispatched-set membership
(``_dispatched``), so skipping a microbatch removes push/pull pairs
symmetrically and can only delete edges from the all-active graph —
never add one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.core import AnalysisReport, Severity, register


@dataclass(frozen=True)
class Event:
    """One queue operation of one task: ``kind`` is ``"pull"`` or
    ``"push"``; ``src``/``dst`` the channel; ``key`` the scoped queue
    key.  ``section``/``task`` locate it on its worker stream."""
    section: str
    task: str
    kind: str
    src: str
    dst: str
    key: str

    def label(self) -> str:
        return (f"{self.section}:{self.task} {self.kind}"
                f"[{self.src}->{self.dst} {self.key}]")


def model_events(spec, n_mb: int, scopes: Sequence[str]
                 ) -> Dict[str, List[Event]]:
    """Per-section event streams (worker FIFO order) for ``scopes``
    consecutive iteration scopes of ``spec`` — the static mirror of
    ``CompoundRuntime.submit_iteration``."""
    by_name = {s.name: s for s in spec.sections}
    crits = [s.name for s in spec.sections if s.critical]
    crit = crits[0] if len(crits) == 1 else None
    trainable = [s.name for s in spec.sections if s.trainable]
    chains: Dict[str, List[Event]] = {s.name: [] for s in spec.sections}

    def pulls_consumed(s, it: str, i: int, task: str) -> List[Event]:
        return [Event(s.name, task, "pull", c.section, s.name,
                      f"{it}/{c.key}.{i}") for c in s.consumes]

    def ct_pushes(s, it: str, i: int, task: str) -> List[Event]:
        return [Event(s.name, task, "push", s.name, c.section,
                      f"{it}/ct.{c.key}.{i}") for c in s.consumes
                if by_name[c.section].trainable]

    for it in scopes:
        # producers' fwd tasks (pull consumed ports, push emitted ports)
        for s in spec.sections:
            if s.name == crit:
                continue
            for i in range(n_mb):
                tag = f"fwd{i}"
                ev = pulls_consumed(s, it, i, tag)
                for p in s.emits:
                    for cname in spec.consumers_of(s.name, p.name):
                        ev.append(Event(s.name, tag, "push", s.name,
                                        cname,
                                        f"{it}/{s.name}.{p.name}.{i}"))
                chains[s.name].extend(ev)
        # critical section's loss+grad tasks (pull ports, push cotangents)
        if crit is not None:
            s = by_name[crit]
            for i in range(n_mb):
                tag = f"mb{i}"
                chains[crit].extend(pulls_consumed(s, it, i, tag))
                chains[crit].extend(ct_pushes(s, it, i, tag))
        # trainable producers' bwd tasks (pull own cotangent, push
        # cotangents for their consumed trainable ports)
        for s in spec.sections:
            if s.name == crit or not s.trainable:
                continue
            for i in range(n_mb):
                tag = f"bwd{i}"
                for p in s.emits:
                    cons = spec.consumers_of(s.name, p.name)
                    for cname in cons[:1]:   # bwd pulls ONE cotangent
                        chains[s.name].append(Event(
                            s.name, tag, "pull", cname, s.name,
                            f"{it}/ct.{s.name}.{p.name}.{i}"))
                chains[s.name].extend(ct_pushes(s, it, i, tag))
        # grad-norm rendezvous: push to every peer BEFORE pulling any
        for name in trainable:
            peers = [n for n in trainable if n != name]
            chains[name].extend(
                Event(name, "upd", "push", name, p, f"{it}/gnorm.{name}")
                for p in peers)
            chains[name].extend(
                Event(name, "upd", "pull", p, name, f"{it}/gnorm.{p}")
                for p in peers)
    return chains


def check_events(chains: Dict[str, List[Event]],
                 passname: str = "deadlock") -> AnalysisReport:
    """Generic wait-graph check over per-section event streams: FIFO
    edges within each stream, push→pull edges across them.  Reports
    unsatisfiable pulls and wait cycles (each named edge by edge)."""
    rep = AnalysisReport(passname)
    events: List[Event] = []
    index: Dict[int, int] = {}
    for chain in chains.values():
        for ev in chain:
            index[id(ev)] = len(events)
            events.append(ev)
    n = len(events)
    adj: List[List[int]] = [[] for _ in range(n)]
    # worker-FIFO edges: an event waits for its stream predecessor
    for chain in chains.values():
        for a, b in zip(chain, chain[1:]):
            adj[index[id(a)]].append(index[id(b)])
    # push → pull matching on (src, dst, key)
    pushes: Dict[Tuple[str, str, str], List[int]] = {}
    for i, ev in enumerate(events):
        if ev.kind == "push":
            pushes.setdefault((ev.src, ev.dst, ev.key), []).append(i)
    for key, idxs in pushes.items():
        if len(idxs) > 1:
            rep.add(Severity.WARNING, "deadlock.duplicate-push",
                    f"{key[0]}->{key[1]}",
                    f"key {key[2]!r} is pushed {len(idxs)} times on one "
                    "edge — the queue would overwrite fragments")
    for i, ev in enumerate(events):
        if ev.kind != "pull":
            continue
        match = pushes.get((ev.src, ev.dst, ev.key))
        if not match:
            rep.add(Severity.ERROR, "deadlock.unsatisfied-pull",
                    f"{ev.src}->{ev.dst}",
                    f"{ev.label()} has no matching push anywhere in the "
                    f"dispatch graph — section {ev.section!r} would hang "
                    "in drain() waiting on this edge")
            continue
        for j in match:
            adj[j].append(i)
    # cycle detection (iterative DFS, first cycle reported in full)
    WHITE, GREY, BLACK = 0, 1, 2
    color = [WHITE] * n
    parent = [-1] * n
    cycle: List[int] = []
    for root in range(n):
        if color[root] != WHITE or cycle:
            continue
        stack = [(root, iter(adj[root]))]
        color[root] = GREY
        while stack and not cycle:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if color[nxt] == WHITE:
                    color[nxt] = GREY
                    parent[nxt] = node
                    stack.append((nxt, iter(adj[nxt])))
                    advanced = True
                    break
                if color[nxt] == GREY:       # back edge: wait cycle
                    path = [node]
                    cur = node
                    while cur != nxt and parent[cur] != -1:
                        cur = parent[cur]
                        path.append(cur)
                    cycle = path[::-1]       # nxt ... node (wraps to nxt)
                    break
            if not advanced and not cycle:
                color[node] = BLACK
                stack.pop()
    if cycle:
        labels = [events[i].label() for i in cycle]
        secs = sorted({events[i].section for i in cycle})
        rep.add(Severity.ERROR, "deadlock.cycle",
                ",".join(secs),
                "dispatch graph has a wait cycle (blocking pulls + "
                "worker FIFO): " + " -> ".join(labels + [labels[0]]))
    return rep


@register("deadlock")
def check_spec(spec, *, n_mb: int = 2, lookahead: int = 0
               ) -> AnalysisReport:
    """Prove the blocking-pull order of ``spec`` acyclic per iteration
    scope (two chained scopes when ``lookahead > 0``).  ``n_mb=2``
    covers cross-microbatch FIFO coupling; larger values model the same
    edges repeated."""
    rep = AnalysisReport("deadlock")
    names = [s.name for s in spec.sections]
    if len(set(names)) != len(names):
        rep.add(Severity.ERROR, "deadlock.structure", spec.name,
                f"duplicate section names {names} — cannot model "
                "dispatch streams")
        return rep
    crits = [s.name for s in spec.sections if s.critical]
    if len(crits) != 1:
        rep.add(Severity.ERROR, "deadlock.structure", spec.name,
                f"expected exactly one critical section, got {crits}")
        return rep
    known = set(names)
    for s in spec.sections:
        for c in s.consumes:
            if c.section not in known:
                rep.add(Severity.ERROR, "deadlock.structure",
                        f"{c.section}->{s.name}",
                        f"section {s.name!r} consumes from unknown "
                        f"section {c.section!r}")
    if not rep.ok:
        return rep
    scopes = ["s0", "s1"] if lookahead > 0 else ["s0"]
    chains = model_events(spec, max(int(n_mb), 1), scopes)
    rep.extend(check_events(chains))
    return rep
