"""FleetMetrics — the roll-up above each replica's `EngineMetrics`.

One FleetMetrics is the ``result_sink`` of every replica scheduler of a
`Router`: results stream through it (counts, SLO attainment, end-to-end
latency in ticks) instead of piling up as `ServeResult` objects, so a
million-request replay holds O(1) a request. Per-tick fleet state (live
replicas, total queued) and the autoscaler's scale events land here too,
and `summary()` gives the whole story: fleet latency p50/p95, drops by
cause, attainment and the replica timeline.

Drops are split three ways: "rejected" (bounded queue full at submit),
"expired" (admission deadline passed while queued) and "expired_inflight"
(completion deadline overran in a slot). The two expiries differ
structurally: an admission expiry never held a slot (n_ticks == 0), an
in-flight one did (n_ticks >= 1).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.api import ServeResult

_COMPLETED = ("ok", "stop", "length")


@dataclasses.dataclass
class FleetMetrics:
    """Fleet-wide accounting. ``slo_ticks`` is the end-to-end (wait +
    service) budget a completion must meet to count as attained; None
    turns attainment off (it reports 0.0)."""
    slo_ticks: Optional[int] = None
    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    expired: int = 0
    expired_inflight: int = 0
    slo_met: int = 0
    latency_ticks: List[int] = dataclasses.field(default_factory=list)
    # (tick, live replicas) change points: a constant fleet has one entry
    replica_timeline: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    scale_events: List[dict] = dataclasses.field(default_factory=list)
    queued_peak: int = 0
    ticks: int = 0

    # -- result sink (every replica Scheduler's result_sink) -----------------
    def on_result(self, res: ServeResult) -> None:
        self.submitted += 1
        if res.finish_reason in _COMPLETED:
            self.completed += 1
            lat = res.wait_ticks + res.n_ticks
            self.latency_ticks.append(lat)
            if self.slo_ticks is not None and lat <= self.slo_ticks:
                self.slo_met += 1
        elif res.finish_reason == "rejected":
            self.rejected += 1
        elif res.n_ticks > 0:          # held a slot: completion-deadline drop
            self.expired_inflight += 1
        else:                          # expired in the wait queue
            self.expired += 1

    # -- fleet state (recorded by Router.tick) -------------------------------
    def record_tick(self, tick: int, n_live: int, queued: int) -> None:
        self.ticks = tick + 1
        self.queued_peak = max(self.queued_peak, queued)
        if (not self.replica_timeline
                or self.replica_timeline[-1][1] != n_live):
            self.replica_timeline.append((tick, n_live))

    def record_scale(self, tick: int, action: str, replica: int,
                     n_live: int) -> None:
        self.scale_events.append({"tick": tick, "action": action,
                                  "replica": replica, "n_live": n_live})

    # -- roll-up -------------------------------------------------------------
    @property
    def dropped(self) -> int:
        return self.rejected + self.expired + self.expired_inflight

    @property
    def lost(self) -> int:
        """Requests submitted but never surfaced as any result: the
        conservation gap, 0 when completed + every drop = submitted."""
        return self.submitted - self.completed - self.dropped

    def summary(self) -> dict:
        # a window that completes nothing falls back to 0.0 for every ratio
        # and quantile: NaN-free, as EngineMetrics.summary
        lat = (np.asarray(self.latency_ticks) if self.latency_ticks
               else np.zeros(1))
        replicas = [n for _, n in self.replica_timeline] or [0]
        return {
            "ticks": self.ticks,
            "requests_submitted": self.submitted,
            "requests_completed": self.completed,
            "requests_lost": self.lost,
            "drops_by_cause": {"rejected": self.rejected,
                               "expired_admission": self.expired,
                               "expired_inflight": self.expired_inflight},
            "slo_ticks": self.slo_ticks,
            "slo_attainment": (self.slo_met / self.submitted
                               if self.submitted else 0.0),
            "latency_p50_ticks": float(np.quantile(lat, 0.50)),
            "latency_p95_ticks": float(np.quantile(lat, 0.95)),
            "queued_peak": self.queued_peak,
            "replicas_min": min(replicas),
            "replicas_max": max(replicas),
            "replicas_final": replicas[-1],
            "scale_events": self.scale_events,
            "replica_timeline": [[t, n] for t, n in self.replica_timeline],
        }
