"""Autoscaler — replica count control from the replicas' metrics, with
hysteresis.

The loop reads the `EngineMetrics` each replica scheduler already keeps
(queue depth, occupancy, tick wall times) over a trailing window and
returns +1 (add a replica), -1 (drain one) or 0 (hold). Three mechanisms
keep it from flapping:

  * separate watermarks: scale up on sustained queue pressure (mean
    queued per live slot > queue_high, or p95 tick time above
    ``p95_tick_high_ms`` when set); scale down only when the queue is
    empty across the window and occupancy sits below occ_low;
  * cooldowns: after any scale event, no up-decision for ``cooldown_up``
    ticks and no down-decision for ``cooldown_down`` ticks;
  * a full window: a replica younger than ``window`` ticks holds every
    decision.

The autoscaler only decides; the `Router` applies it (spawning a replica,
or marking the least-loaded one draining, so that it finishes its queued
and in-flight work before it retires).

``p95_tick_high_ms`` reads wall tick times, so a fleet that uses it no
longer replays the same in ticks on every machine; it is off (0) by
default.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    window: int = 8                 # trailing ticks averaged a signal
    queue_high: float = 2.0         # mean queued per live slot → scale up
    occ_low: float = 0.5            # mean occupancy floor for scale-down
    p95_tick_high_ms: float = 0.0   # optional wall-time signal (0 = off)
    cooldown_up: int = 8            # ticks after any event before next up
    cooldown_down: int = 24         # ticks after any event before next down


class Autoscaler:
    def __init__(self, config: AutoscalerConfig = AutoscalerConfig()):
        self.config = config
        self._last_event = -10**9

    def decide(self, tick: int, schedulers: Sequence) -> int:
        """+1 / -1 / 0 given the live (not draining) replicas'
        schedulers, from each one's EngineMetrics trailing window."""
        cfg = self.config
        n = len(schedulers)
        if n == 0:
            return +1
        w = cfg.window
        depth = occ = slots = 0.0
        p95 = 0.0
        for sched in schedulers:
            m = sched.metrics
            if len(m.queue_depth) < w:           # young replica: wait
                return 0
            depth += sum(m.queue_depth[-w:]) / w
            occ += sum(m.occupancy[-w:]) / w
            slots += m.capacity
            if cfg.p95_tick_high_ms > 0:
                p95 = max(p95, float(np.quantile(m.tick_s[-w:], 0.95)) * 1e3)
        queue_per_slot = depth / max(slots, 1.0)
        overload = queue_per_slot > cfg.queue_high or (
            cfg.p95_tick_high_ms > 0 and p95 > cfg.p95_tick_high_ms)
        if (overload and n < cfg.max_replicas
                and tick - self._last_event >= cfg.cooldown_up):
            self._last_event = tick
            return +1
        idle = depth == 0.0 and (occ / n) < cfg.occ_low
        if (idle and n > cfg.min_replicas
                and tick - self._last_event >= cfg.cooldown_down):
            self._last_event = tick
            return -1
        return 0
