"""Asynchronous, asymmetric M-to-N message queue for cross-section tensors
(paper §3.3), on torch tensors.  Counterpart of ``repro/core/messages.py``.

* CPU subchannel (metadata) → an in-process, thread-safe queue of
  :class:`Meta` records (tensor name, global shape/dtype, shard index,
  sender's position in its group).
* GPU subchannel (one-sided data) → the tensor itself.  ``push`` hands
  the tensor over without waiting for the device: on CUDA it records a
  ``torch.cuda.Event`` on the producer's current stream (the section's
  own stream, on its worker thread), and ``pull``, on the consumer's
  thread, makes the consumer's current stream wait for that event and
  marks the tensor as used by that stream (``record_stream``), so the
  caching allocator cannot hand its memory back to the producer's stream
  while the consumer still reads it.

``push`` transmits a (possibly fragmented) tensor to a destination
section; ``pull`` dequeues it, joining fragments pushed by several
senders (the M-to-N pattern) and moving the result onto the consumer's
device (``reshard``).

Iteration scopes: a key of the form ``"<scope>/<rest>"`` belongs to tag
namespace ``<scope>`` (the streaming runtime scopes every iteration's
traffic under a monotonic ``s<i>/`` prefix).  ``evict_scope`` retires a
namespace when its iteration retires: leftover messages are dropped
(and reported) and later push/pull against the retired scope raise.
Keys without a ``/`` are unscoped and never evicted.

Between processes (sections carved by ranks, one process a rank) the
tensors travel point to point over the default process group
(:class:`PeerTransport`).  NCCL matches a receive with the sends of its
peer in the order they were issued and ignores tags; gloo matches tags.
So the receiving rank posts its receives in the order the sending rank
pushes, which both compute from the same iteration plan (``expect``), and
buffers what arrives by key: ``pull`` may ask for any key in any order on
either backend.  A send never blocks its thread (``isend``).
"""
from __future__ import annotations

import collections
import logging
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_log = logging.getLogger("repro_torch.messages")


class StaleScopeError(RuntimeError):
    """A push or pull targeted an iteration scope that was already
    retired by ``evict_scope``."""


class PullTimeout(TimeoutError):
    """A blocking ``pull`` exhausted its timeout.  The message names the
    producing section, the iteration scope being waited on, and the keys
    that ARE buffered on the edge."""


@dataclass(frozen=True)
class Meta:
    key: str                      # logical tensor name (+ microbatch tag)
    src_section: str
    global_shape: Tuple[int, ...]
    dtype: Any
    frag_index: Tuple[slice, ...]   # where this fragment sits globally
    frag_rank: int                  # sender's position in its group
    frag_count: int                 # senders contributing to this tensor
    seq: int = 0                    # FIFO sequence number


class _Channel:
    """One (src_section → dst_section) point-to-point channel, metadata
    indexed per key (``metas[key][frag_rank]``)."""

    def __init__(self):
        self.metas: Dict[str, Dict[int, Meta]] = {}
        # (key, rank) -> (tensor, the producer stream's event or None)
        self.data: Dict[Tuple[str, int], Tuple[Any, Any]] = {}
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)


def _nbytes(v) -> int:
    return int(v.numel()) * v.element_size()


def _ready_event(value):
    """An event on the producer's current stream after ``value`` was
    written (CUDA tensors), else None."""
    if isinstance(value, torch.Tensor) and value.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(value.device))
        return ev
    return None


def adopt(value, event=None):
    """Make ``value`` safe to read on the calling thread's current stream:
    wait for ``event`` (the producer's) and record the tensor as in use
    by that stream.  CPU tensors pass through."""
    if isinstance(value, torch.Tensor) and value.is_cuda:
        stream = torch.cuda.current_stream(value.device)
        if event is not None:
            stream.wait_event(event)
        value.record_stream(stream)
    return value


class MessageQueue:
    """M-to-N cross-section transfer with the move onto the consumer's
    device."""

    def __init__(self, transport: Optional["PeerTransport"] = None):
        self._channels: Dict[Tuple[str, str], _Channel] = {}
        self._lock = threading.Lock()
        self._seq = 0
        self._retired_scopes: set = set()
        self.bytes_pushed = 0
        self.pushes = 0
        #: the point-to-point path to sections on other ranks (None: every
        #: section is in this process)
        self.transport = transport

    def _channel(self, src: str, dst: str) -> _Channel:
        with self._lock:
            if (src, dst) not in self._channels:
                self._channels[(src, dst)] = _Channel()
            return self._channels[(src, dst)]

    @staticmethod
    def _scope(key: str) -> Optional[str]:
        return _scope_of(key)

    def _check_scope(self, op: str, src: str, dst: str, key: str) -> None:
        sc = self._scope(key)
        if sc is not None:
            with self._lock:
                retired = sc in self._retired_scopes
            if retired:
                raise StaleScopeError(
                    f"{op}({src}->{dst}, {key}): iteration scope {sc!r} "
                    "is already retired — cross-iteration traffic may "
                    "not alias a retired namespace")

    # ------------------------------------------------------------------ #
    def push(self, src: str, dst: str, key: str, value: torch.Tensor, *,
             frag_index: Optional[Tuple[slice, ...]] = None,
             frag_rank: int = 0, frag_count: int = 1,
             global_shape: Optional[Tuple[int, ...]] = None) -> None:
        """One-sided send: enqueue metadata, hand over the tensor (with an
        event on the producer's stream when it lives on a card).

        For M-to-N, each of the ``frag_count`` senders pushes its fragment
        with its ``frag_index`` into the global tensor."""
        self._check_scope("push", src, dst, key)
        ch = self._channel(src, dst)
        gshape = tuple(global_shape or value.shape)
        fidx = frag_index or tuple(slice(0, d) for d in gshape)
        ev = _ready_event(value)
        with self._lock:
            seq = self._seq
            self._seq += 1
        meta = Meta(key, src, gshape, value.dtype, fidx, frag_rank,
                    frag_count, seq)
        with ch.cv:
            ch.data[(key, frag_rank)] = (value, ev)
            ch.metas.setdefault(key, {})[frag_rank] = meta
            self.bytes_pushed += _nbytes(value)
            self.pushes += 1
            ch.cv.notify_all()

    # ------------------------------------------------------------------ #
    def pull(self, src: str, dst: str, key: str, *,
             device: Optional[torch.device] = None,
             timeout: Optional[float] = 30.0) -> torch.Tensor:
        """Dequeue ``key``; join all fragments; move to ``device``.

        Runs on the consumer's thread: its current stream waits for each
        fragment's producer event before anything reads the fragment.
        Fragments that tile the global tensor contiguously along axis 0
        are joined with ``torch.cat``; other layouts are assembled into a
        zero tensor by slice assignment."""
        self._check_scope("pull", src, dst, key)
        ch = self._channel(src, dst)
        # absolute deadline: wakeups for OTHER keys on the channel must
        # not restart the clock
        deadline = None if timeout is None or timeout < 0 else (
            time.monotonic() + timeout)
        with ch.cv:
            while True:
                metas = ch.metas.get(key, {})
                need = (next(iter(metas.values())).frag_count if metas
                        else 1)
                if len(metas) >= need:
                    metas = dict(metas)
                    frags = {r: ch.data.pop((key, r)) for r in metas}
                    del ch.metas[key]
                    break
                remaining = None if deadline is None else (
                    deadline - time.monotonic())
                if remaining is not None and remaining <= 0 or \
                        not ch.cv.wait(timeout=remaining):
                    pending = sorted(ch.metas)
                    sc = self._scope(key)
                    scope_note = ("" if sc is None else
                                  f" into iteration scope {sc!r}")
                    raise PullTimeout(
                        f"pull({src}->{dst}, {key}): "
                        f"{len(metas)}/{need} fragments after {timeout}s "
                        f"— producer section {src!r} never pushed "
                        f"{key!r}{scope_note}; pending keys on this "
                        f"edge: {pending}")
        frags = {r: adopt(v, ev) for r, (v, ev) in frags.items()}
        out = _assemble(frags, metas)
        if device is not None:
            out = reshard(out, device)
        return out

    # ------------------------------------------------------------------ #
    # sections on other ranks
    # ------------------------------------------------------------------ #
    def send(self, src: str, dst: str, key: str, value: torch.Tensor, *,
             rank: int) -> None:
        """Send one fragment of ``key`` to section ``dst``'s ``rank``.  The
        transport counts fragments and bytes on the wire; the key itself
        counts as a push only through :meth:`count_push`."""
        self._check_scope("push", src, dst, key)
        self.transport.send(rank, (src, dst, key), value)

    def count_push(self, value: torch.Tensor) -> None:
        """Count one logical message (a key) whose fragments went out by
        :meth:`send`: the sending section's origin calls it once a key, so
        ``stats()["pushes"]`` counts messages as the one-process queue
        does."""
        with self._lock:
            self.pushes += 1
            self.bytes_pushed += _nbytes(value)

    def recv(self, src: str, dst: str, key: str, ranks: Sequence[int], *,
             timeout: Optional[float] = 30.0) -> Dict[int, torch.Tensor]:
        """The fragments of ``key`` that section ``src``'s ``ranks`` sent
        here, by rank.  Receives from each rank in the order that rank
        sends (see :meth:`expect`), buffering what is not ``key``."""
        self._check_scope("pull", src, dst, key)
        wid = (src, dst, key)
        try:
            return {r: self.transport.recv(r, wid, timeout=timeout)
                    for r in ranks}
        except PullTimeout as e:
            sc = self._scope(key)
            scope_note = "" if sc is None else f" into iteration scope {sc!r}"
            raise PullTimeout(
                f"pull({src}->{dst}, {key}): producer section {src!r} never "
                f"sent {key!r}{scope_note}: {e}") from None

    def expect(self, src: str, dst: str, key: str, rank: int,
               shape: Tuple[int, ...], dtype) -> None:
        """Register one message that ``rank`` will send here, in that
        rank's send order."""
        self.transport.expect(rank, (src, dst, key), shape, dtype)

    def close(self) -> None:
        """Wait (briefly) for this rank's sends to complete."""
        if self.transport is not None:
            self.transport.close()

    # ------------------------------------------------------------------ #
    def evict_scope(self, scope: str) -> Dict[str, List[str]]:
        """Retire an iteration's tag namespace: drop every leftover
        message whose key lives under ``scope + "/"`` and refuse future
        push/pull against it.  Returns ``{"src->dst": [evicted keys]}``
        (normally empty)."""
        with self._lock:
            self._retired_scopes.add(scope)
            channels = list(self._channels.items())
        evicted: Dict[str, List[str]] = {}
        for (src, dst), ch in channels:
            with ch.cv:
                keys = [k for k in ch.metas if self._scope(k) == scope]
                for k in keys:
                    for r in list(ch.metas[k]):
                        ch.data.pop((k, r), None)
                    del ch.metas[k]
                if keys:
                    evicted[f"{src}->{dst}"] = sorted(keys)
                    ch.cv.notify_all()
        if self.transport is not None:
            for src, dst, key in self.transport.evict(scope):
                evicted.setdefault(f"{src}->{dst}", []).append(key)
        for edge, keys in sorted(evicted.items()):
            _log.warning(
                "evict_scope(%r): dropped %d leftover message(s) on %s: "
                "%s — a producer pushed something no consumer ever "
                "pulled", scope, len(keys), edge, keys)
        return evicted

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        """Totals plus a per-edge view: buffered-key depth, the pending
        key set, and the buffered bytes on each ``src->dst`` channel."""
        with self._lock:
            channels = list(self._channels.items())
        edges = {}
        for (src, dst), ch in channels:
            with ch.cv:
                pending = sorted(ch.metas)
                nbytes = sum(_nbytes(v) for v, _ in ch.data.values())
            edges[f"{src}->{dst}"] = {"depth": len(pending),
                                      "pending": pending,
                                      "bytes": int(nbytes)}
        out = {"pushes": self.pushes, "bytes_pushed": self.bytes_pushed,
               "channels": len(self._channels), "edges": edges}
        if self.transport is not None:
            out.update(fragments=self.transport.fragments,
                       wire_bytes=self.transport.wire_bytes)
        return out


# --------------------------------------------------------------------------- #
# Point-to-point transport between ranks
# --------------------------------------------------------------------------- #
def _scope_of(key: str) -> Optional[str]:
    """The iteration scope of a key (``"<scope>/<rest>"``), or None."""
    return key.split("/", 1)[0] if "/" in key else None


def _tag(wid: Tuple[str, str, str]) -> int:
    """gloo's tag of a message ``(src, dst, key)``: the same on both ranks,
    distinct per key (NCCL ignores it)."""
    return zlib.crc32("\x00".join(wid).encode()) & 0x7FFFFFFF


def _completes(work, timeout: Optional[float]) -> bool:
    """Wait for ``work``; False when it has not completed within
    ``timeout`` seconds (None or negative: waits for ever).  gloo answers a
    ``wait(timeout)`` that runs out by closing the connection to the peer,
    and its point-to-point work reports completion only once waited on, so
    the wait runs on a helper thread.  Under NCCL the wait must run on the
    calling thread (it orders that thread's current stream)."""
    if timeout is None or timeout < 0 or dist.get_backend() == "nccl":
        work.wait()
        return True
    done, failed = threading.Event(), []

    def run():
        try:
            work.wait()
        except Exception as e:          # surfaced on the caller's thread
            failed.append(e)
        finally:
            done.set()

    threading.Thread(target=run, daemon=True).start()
    if not done.wait(timeout):
        return False
    if failed:
        raise failed[0]
    return True


@dataclass(frozen=True)
class _Expected:
    wid: Tuple[str, str, str]
    shape: Tuple[int, ...]
    dtype: Any


class PeerTransport:
    """Tensors between this rank and others over the default process group.

    ``send`` posts an ``isend`` and keeps it (and its tensor) until
    :meth:`settle` waits for it (the runtime settles an iteration's sends
    when it retires the iteration).  The receiving side registers, per
    sending rank, the messages that rank will send in its order
    (``expect``); ``recv(rank, wid)`` receives that rank's messages in
    order until ``wid`` has come, buffering the others."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.fragments = 0
        self.wire_bytes = 0
        self._expected: Dict[int, "collections.deque[_Expected]"] = (
            collections.defaultdict(collections.deque))
        self._got: Dict[Tuple[int, Tuple[str, str, str]], torch.Tensor] = {}
        self._sent: List[Tuple[str, Any, torch.Tensor]] = []
        self._retired: set = set()
        self._lock = threading.Lock()
        self._peer_locks: Dict[int, threading.Lock] = (
            collections.defaultdict(threading.Lock))

    def send(self, rank: int, wid, value: torch.Tensor) -> None:
        value = value.detach().contiguous()
        work = dist.isend(value, dst=rank, tag=_tag(wid))
        with self._lock:
            self.fragments += 1
            self.wire_bytes += _nbytes(value)
            self._sent.append((_scope_of(wid[2]), work, value, wid, rank))

    def settle(self, scope: Optional[str] = None) -> None:
        """Wait for the sends under ``scope`` (every send: None): each
        completes once its receiver has taken it."""
        with self._lock:
            done = [x for x in self._sent if scope in (None, x[0])]
            self._sent = [x for x in self._sent if x[0] != scope
                          and scope is not None]
        for _, work, *_ in done:
            work.wait()

    def expect(self, rank: int, wid, shape, dtype) -> None:
        with self._lock:
            self._expected[rank].append(_Expected(wid, tuple(shape), dtype))

    def recv(self, rank: int, wid, *, timeout: Optional[float] = 30.0
             ) -> torch.Tensor:
        with self._peer_locks[rank]:
            while (rank, wid) not in self._got:
                with self._lock:
                    if not self._expected[rank]:
                        raise RuntimeError(
                            f"rank {dist.get_rank()}: {wid} from rank {rank} "
                            "was never expected (no send of it is planned)")
                    e = self._expected[rank].popleft()
                buf = torch.empty(e.shape, dtype=e.dtype, device=self.device)
                work = dist.irecv(buf, src=rank, tag=_tag(e.wid))
                if not _completes(work, timeout):
                    buffered = sorted(k for r, k in self._got if r == rank)
                    raise PullTimeout(
                        f"nothing from rank {rank} after {timeout}s while "
                        f"receiving {e.wid}; buffered from it: {buffered}")
                with self._lock:
                    if _scope_of(e.wid[2]) not in self._retired:
                        self._got[(rank, e.wid)] = buf
            with self._lock:
                return self._got.pop((rank, wid))

    def evict(self, scope: str) -> List[Tuple[str, str, str]]:
        """Drop what was received under ``scope`` and never pulled; what
        is still to come under it is received and dropped in turn, so the
        order of later messages holds."""
        with self._lock:
            self._retired.add(scope)
            gone = [k for k in self._got if _scope_of(k[1][2]) == scope]
            for k in gone:
                del self._got[k]
        return [k[1] for k in gone]

    def close(self, timeout: float = 30.0) -> None:
        with self._lock:
            sent, self._sent = self._sent, []
        for _, work, _, wid, rank in sent:
            if not _completes(work, timeout):   # a peer that never received
                _log.warning("send of %s to rank %d not received by close",
                             wid, rank)


def _axis0_contiguous(metas: Dict[int, Meta]) -> Optional[List[int]]:
    """Rank order in which the fragments tile the global tensor
    contiguously along axis 0 (full slices elsewhere), or None."""
    gshape = next(iter(metas.values())).global_shape
    if not gshape:
        return None
    by_start = []
    for r, m in metas.items():
        idx = m.frag_index
        if len(idx) != len(gshape):
            return None
        for d, sl in enumerate(idx[1:], start=1):
            if (sl.start or 0) != 0 or sl.stop != gshape[d] \
                    or sl.step not in (None, 1):
                return None
        sl0 = idx[0]
        if sl0.step not in (None, 1):
            return None
        by_start.append((sl0.start or 0, sl0.stop, r))
    by_start.sort()
    pos = 0
    order = []
    for start, stop, r in by_start:
        if start != pos:
            return None
        pos = stop
        order.append(r)
    return order if pos == gshape[0] else None


def _assemble(frags: Dict[int, torch.Tensor], metas: Dict[int, Meta]):
    m0 = next(iter(metas.values()))
    if len(frags) == 1:
        (r0, only), = frags.items()
        if tuple(only.shape) == tuple(metas[r0].global_shape):
            return only
    order = _axis0_contiguous(metas)
    if order is not None:
        return torch.cat([frags[r] for r in order], dim=0)
    # arbitrary fragment layout: slice-assign into zeros on the device of
    # the first fragment
    first = next(iter(frags.values()))
    buf = torch.zeros(m0.global_shape, dtype=m0.dtype, device=first.device)
    for r, t in frags.items():
        buf[metas[r].frag_index] = t.to(first.device)
    return buf


def reshard(value: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Move a tensor onto the consumer's device (a no-op when it is
    there already): the port's counterpart of the JAX package's
    ``device_put`` onto another section's mesh.  The copy runs on the
    calling thread's current stream."""
    return value.to(device)
