"""Training loop: straggler detection and per-step metrics.

Counterpart of ``repro/train/loop.py``.  Checkpoint and restart arrive
with the checkpointer (ROADMAP.md, A9): passing a ``checkpointer`` raises.
The step's metrics are read back each step (``float(loss)``), which waits
for the device, so a step's time is the time of its work.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, List


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


def train(step_fn: Callable, *, params, opt_state, batches: Iterator,
          num_steps: int, checkpointer=None, checkpoint_every: int = 50,
          log_every: int = 10, straggler_factor: float = 2.0,
          log_fn: Callable[[str], None] = print) -> TrainResult:
    """Run ``num_steps`` of ``step_fn(params, opt, batch, step_idx)``."""
    if checkpointer is not None:
        raise NotImplementedError(
            "checkpointing is not ported yet; see ROADMAP.md, A9")
    mon = StragglerMonitor(factor=straggler_factor)
    losses: List[float] = []
    gnorms: List[float] = []
    times: List[float] = []
    for step in range(num_steps):
        batch = next(batches)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
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
    return TrainResult(len(losses), num_steps, losses, times, mon.flagged,
                       gnorms, params, opt_state)
