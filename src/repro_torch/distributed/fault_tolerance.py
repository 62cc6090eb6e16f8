"""Fault tolerance and straggler mitigation.

The contract:

* **Deterministic resume** — the data pipeline is a pure function of
  (step, host); together with the checkpointed (params, opt_state) a
  restarted job replays bit-identically (tested with injected crashes).
* **Atomic checkpoints** — see checkpoint.py; a mid-write crash leaves the
  previous step intact.
* **Straggler watchdog** — per-step wall time is tracked with an EMA; a
  step exceeding ``threshold x`` EMA is flagged, and the re-slice action
  is a callback.

A port of ``repro.distributed.fault_tolerance``. A step's time given to
the watchdog includes the card's work: the runner synchronizes the
metrics' device before it stops the clock (the reference's
``jax.block_until_ready``). Resuming onto a different device count
(``elastic.reshard``) waits for placement over several devices
(ROADMAP.md, still to port #5).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from .checkpoint import Checkpointer

__all__ = ["StragglerPolicy", "TrainingRunner"]


@dataclasses.dataclass
class StragglerPolicy:
    """Per-step time is tracked with an EMA; a step over ``threshold x``
    the EMA is flagged (``flagged``, ``on_straggler``) and kept out of the
    EMA. The first ``grace_steps`` steps are ignored (warm-up, builds)."""

    threshold: float = 2.5       # x EMA before a step is "straggling"
    ema_decay: float = 0.9
    grace_steps: int = 3         # ignore warmup/compile steps
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def __post_init__(self):
        self._ema: Optional[float] = None
        self._seen = 0
        self.flagged: list = []

    def observe(self, step: int, dt: float) -> bool:
        self._seen += 1
        if self._seen <= self.grace_steps:
            return False
        if self._ema is None:
            self._ema = dt
            return False
        straggling = dt > self.threshold * self._ema
        if straggling:
            self.flagged.append((step, dt, self._ema))
            if self.on_straggler:
                self.on_straggler(step, dt, self._ema)
        else:
            self._ema = (self.ema_decay * self._ema
                         + (1 - self.ema_decay) * dt)
        return straggling


def _block_until_ready(metrics: dict) -> None:
    """Wait for the work behind the metrics' tensors on their devices."""
    for dev in {v.device for v in metrics.values()
                if isinstance(v, torch.Tensor) and v.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class TrainingRunner:
    """Checkpoint/restart training loop with watchdog + deterministic data.

    ``step_fn(state, batch) -> (state, metrics)`` must be pure;
    ``data_fn(step) -> batch`` must be stateless (pure function of step).
    """

    def __init__(self, step_fn: Callable, data_fn: Callable,
                 ckpt: Checkpointer, *, ckpt_every: int = 50,
                 straggler: Optional[StragglerPolicy] = None):
        self.step_fn = step_fn
        self.data_fn = data_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.straggler = straggler or StragglerPolicy()

    def resume_or_init(self, init_state) -> tuple:
        latest = self.ckpt.latest_step()
        if latest is None:
            return init_state, 0
        return self.ckpt.restore(init_state, latest)

    def run(self, init_state, num_steps: int,
            fail_at: Optional[int] = None) -> tuple:
        """Run to ``num_steps`` (global step count), resuming from the
        latest checkpoint. ``fail_at`` injects a crash (for tests).
        Returns (state, one dict of float metrics a step run)."""
        state, start = self.resume_or_init(init_state)
        history = []
        for step in range(start, num_steps):
            if fail_at is not None and step == fail_at:
                self.ckpt.wait()
                raise RuntimeError(f"injected failure at step {step}")
            batch = self.data_fn(step)
            t0 = time.monotonic()
            state, metrics = self.step_fn(state, batch)
            _block_until_ready(metrics)
            self.straggler.observe(step, time.monotonic() - t0)
            history.append({k: float(v) for k, v in metrics.items()})
            if (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, state)
        self.ckpt.wait()
        return state, history
