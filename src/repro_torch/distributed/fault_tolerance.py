"""Straggler mitigation: the watchdog the distributed tile driver feeds.

Only ``StragglerPolicy`` of the reference's
``distributed/fault_tolerance.py`` is ported here; checkpointed training
(``TrainingRunner``) comes with the dense LM stack (ROADMAP.md, still to
port #8).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


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
