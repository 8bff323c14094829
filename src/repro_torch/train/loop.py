"""Training loop: checkpoint and resume, straggler detection, metrics.

Counterpart of ``repro/train/loop.py``:

* periodic asynchronous checkpoints of ``{"params", "opt"}`` and a resume
  from the latest checkpoint on start;
* an emergency checkpoint on SIGTERM (the step in progress finishes
  first) or KeyboardInterrupt between steps;
* per-step wall time against the rolling median (``StragglerMonitor``).

The step's metrics are read back each step (``float(loss)``), which waits
for the device, so a step's time is the time of its work.  The port's
AdamW updates the optimizer state in place, so a KeyboardInterrupt that
lands inside ``step_fn`` may leave it half updated: no emergency
checkpoint is written then, and the last periodic one stands.  The
final checkpoint is written only when a step ran, and not again when the
last periodic one already holds that step.  A resumed run takes its
batches from ``batches`` as given: the JAX package's launcher, like this
port's, restarts the data stream at its first batch (ROADMAP.md, C9).

Under a process group (``mesh=`` and ``shardings=``, the sharded step's
spec trees) every rank runs every step and takes part in every save's
gathers; only the rank at the mesh's origin logs and writes.  The ranks
agree on the checkpoint to resume from, and a SIGTERM on any rank stops
all of them after the same step: each step ends with one all-reduce of a
flag, and the save that follows is collective.
"""
from __future__ import annotations

import signal
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, List, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.dist import sharding as shd
from repro_torch.models.common import tree_leaves


@dataclass
class StragglerMonitor:
    factor: float = 2.0
    window: int = 32
    times: List[float] = field(default_factory=list)
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) >= 8:
            med = statistics.median(self.times)
            if dt > self.factor * med:
                self.flagged += 1
                return True
        return False


@dataclass
class TrainResult:
    steps_run: int
    final_step: int
    losses: List[float]
    step_times: List[float]
    stragglers: int
    grad_norms: List[float] = field(default_factory=list)
    params: Any = None          # the parameters after the last step
    opt_state: Any = None
    resumed_from: Optional[int] = None


def train(step_fn: Callable, *, params, opt_state, batches: Iterator,
          num_steps: int, checkpointer: Optional[Checkpointer] = None,
          checkpoint_every: int = 50, log_every: int = 10,
          straggler_factor: float = 2.0,
          log_fn: Callable[[str], None] = print, mesh=None,
          shardings: Optional[dict] = None) -> TrainResult:
    """Run steps up to ``num_steps`` of ``step_fn(params, opt, batch,
    step_idx)``, resuming from the latest checkpoint when there is one.
    ``mesh`` and ``shardings`` (``{"params", "opt"}`` spec trees) make the
    run one rank of a sharded run (see the module docstring)."""
    if mesh is not None and not shd.is_origin(mesh):
        log_fn = _quiet
    device = tree_leaves(params)[0].device

    def agreed(value: float, op) -> float:
        """``value`` reduced over the mesh's ranks (itself without one)."""
        if mesh is None:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=device)
        return float(shd.all_reduce_mesh(t, mesh, op)[0])

    ck_kw = dict(shardings=shardings, mesh=mesh)
    start_step = 0
    resumed = None
    if checkpointer is not None:
        latest = checkpointer.latest_step()
        latest = int(agreed(-1 if latest is None else latest,
                            dist.ReduceOp.MIN))
        if latest >= 0:
            state = checkpointer.restore(
                latest, {"params": params, "opt": opt_state}, **ck_kw)
            params, opt_state = state["params"], state["opt"]
            start_step = resumed = latest
            log_fn(f"resumed from step {latest}")

    mon = StragglerMonitor(factor=straggler_factor)
    losses: List[float] = []
    gnorms: List[float] = []
    times: List[float] = []
    interrupted = {"flag": False}

    def _sigterm(signum, frame):
        interrupted["flag"] = True

    old = None
    try:
        old = signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:                       # not the main thread
        pass

    done = start_step                        # steps completed
    saved = None                             # step of the last save
    torn = False                             # interrupted inside step_fn
    try:
        for step in range(start_step, num_steps):
            batch = next(batches)
            t0 = time.perf_counter()
            torn = True
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 step)
            torn = False
            done = step + 1
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            gnorm = float(metrics.get("grad_norm", 0.0))
            times.append(dt)
            losses.append(loss)
            gnorms.append(gnorm)
            if mon.observe(dt):
                log_fn(f"[straggler] step {step}: {dt*1e3:.0f}ms "
                       f"(median {statistics.median(mon.times)*1e3:.0f}ms)")
            if step % log_every == 0:
                log_fn(f"step {step}: loss={loss:.4f} gnorm={gnorm:.3f} "
                       f"{dt*1e3:.0f}ms")
            if checkpointer is not None and done % checkpoint_every == 0:
                checkpointer.save(done, {"params": params, "opt": opt_state},
                                  **ck_kw)
                saved = done
            if mesh is not None:
                interrupted["flag"] = agreed(
                    float(interrupted["flag"]),
                    dist.ReduceOp.MAX) > 0
            if interrupted["flag"]:
                log_fn("SIGTERM — emergency checkpoint")
                break
    except KeyboardInterrupt:
        log_fn("interrupted inside a step: its optimizer state may be half "
               "updated, so no emergency checkpoint" if torn else
               "interrupted — emergency checkpoint")
    finally:
        if checkpointer is not None:
            if done > start_step and not torn and saved != done:
                checkpointer.save(done, {"params": params,
                                         "opt": opt_state}, block=True,
                                  **ck_kw)
            checkpointer.wait()
        if old is not None:
            signal.signal(signal.SIGTERM, old)

    return TrainResult(len(losses), done, losses, times, mon.flagged,
                       gnorms, params, opt_state, resumed)


def _quiet(msg: str) -> None:
    """The log of a rank that is not the mesh's origin."""
