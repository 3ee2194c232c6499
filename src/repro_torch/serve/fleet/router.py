"""Router — the fleet tier above `serve.Scheduler`.

A Router fronts N replicas. Each wraps its own backend (from
``backend_factory``) behind its own Scheduler slot pool, so everything one
scheduler guarantees (paged admission, EDF within priority, deadline
expiry, slot conservation) holds per replica; the Router adds dispatch,
elasticity and fleet accounting:

  dispatch   `submit` routes each request to the live replica with the
             least wait-queue depth (in the request's bucket first, for a
             bucketed backend); ties go to the replica whose earliest
             queued admission deadline leaves the most slack on that
             replica's own clock, then to the lowest replica id. The order
             is a pure function of the requests, so a fixed seed replays
             the same fleet schedule.
  tick       one fleet tick = one scheduler tick on every replica (live
             and draining, in id order), then retirement of drained
             replicas, then one autoscaler decision, then fleet metrics.
  scale up   a fresh replica from ``backend_factory`` takes traffic from
             the next submit on.
  scale down the least-loaded live replica is marked draining: it takes no
             new requests but ticks until its wait queue and slot pool are
             empty, then retires. Scale-down never strands queued or
             in-flight work, and its EngineMetrics stay in ``retired``.

Replicas of a `DetectionBackend` come from its `spawn`, which shares the
bucket's CUDA graph: every replica's dispatch copies into the same static
input, replays, and copies out of the same static output, all in order on
one stream, so no replica can overwrite another's batch in flight.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.serve.api import ServeRequest, ServeResult
from repro_torch.serve.fleet.autoscaler import Autoscaler
from repro_torch.serve.fleet.metrics import FleetMetrics
from repro_torch.serve.scheduler import Scheduler


class Replica:
    __slots__ = ("rid", "sched", "draining", "born_tick")

    def __init__(self, rid: int, sched: Scheduler, born_tick: int):
        self.rid = rid
        self.sched = sched
        self.draining = False
        self.born_tick = born_tick


class Router:
    def __init__(self, backend_factory: Callable[[], object], *,
                 replicas: int = 1,
                 max_queue: Optional[int] = None,
                 autoscaler: Optional[Autoscaler] = None,
                 metrics: Optional[FleetMetrics] = None,
                 keep_results: bool = False):
        """``max_queue`` bounds each replica's wait queue (None: no
        bound). ``keep_results`` also keeps every ServeResult on
        ``results`` (a real fleet's payload checks need them; a
        million-request replay must not hold them)."""
        self._factory = backend_factory
        self._max_queue = max_queue
        self.autoscaler = autoscaler
        self.metrics = metrics or FleetMetrics()
        self.keep_results = keep_results
        self.results: List[ServeResult] = []
        self.replicas: Dict[int, Replica] = {}
        self.retired: Dict[int, Scheduler] = {}
        self.tick_no = 0
        self._next_rid = 0
        for _ in range(replicas):
            self._add_replica()

    # -- elasticity ----------------------------------------------------------
    def _sink(self, res: ServeResult) -> None:
        self.metrics.on_result(res)
        if self.keep_results:
            self.results.append(res)

    def _add_replica(self) -> Replica:
        rep = Replica(self._next_rid,
                      Scheduler(self._factory(), max_queue=self._max_queue,
                                result_sink=self._sink),
                      self.tick_no)
        self.replicas[rep.rid] = rep
        self._next_rid += 1
        return rep

    def live(self) -> List[Replica]:
        return [r for r in self.replicas.values() if not r.draining]

    @property
    def n_live(self) -> int:
        return len(self.live())

    def total_queued(self) -> int:
        return sum(r.sched.queued for r in self.replicas.values())

    def total_active(self) -> int:
        return sum(len(r.sched.active) for r in self.replicas.values())

    # -- dispatch ------------------------------------------------------------
    def _route_key(self, rep: Replica, req: Optional[ServeRequest] = None):
        # (bucket depth, queue depth, -slack, replica id). Slack is taken
        # on the replica's own tick clock: deadlines are absolute in each
        # scheduler's time, and a replica spawned at fleet tick t runs t
        # ticks behind the fleet. A non-bucketed backend's bucket depth is
        # its queue depth.
        depth = rep.sched.queued
        bucket_of = getattr(rep.sched.backend, "bucket_of", None)
        if req is not None and bucket_of is not None:
            depth = rep.sched.queued_in_bucket(bucket_of(req))
        slack = rep.sched.earliest_deadline() - rep.sched.metrics.ticks
        return (depth, rep.sched.queued, -slack, rep.rid)

    def submit(self, req: ServeRequest) -> bool:
        target = min(self.live(), key=lambda rep: self._route_key(rep, req))
        return target.sched.submit(req)

    # -- one fleet tick ------------------------------------------------------
    def tick(self) -> None:
        for rep in list(self.replicas.values()):
            rep.sched.tick()
        self._retire_drained()
        if self.autoscaler is not None:
            self._apply_scale(self.autoscaler.decide(
                self.tick_no, [r.sched for r in self.live()]))
        self.metrics.record_tick(self.tick_no, self.n_live,
                                 self.total_queued())
        self.tick_no += 1

    def _retire_drained(self) -> None:
        for rep in [r for r in self.replicas.values() if r.draining]:
            sched = rep.sched
            if not sched.queued and not sched.active and not sched.queue:
                del self.replicas[rep.rid]
                self.retired[rep.rid] = sched
                self.metrics.record_scale(self.tick_no, "retired", rep.rid,
                                          self.n_live)

    def _apply_scale(self, delta: int) -> None:
        if delta > 0:
            rep = self._add_replica()
            self.metrics.record_scale(self.tick_no, "up", rep.rid,
                                      self.n_live)
        elif delta < 0:
            live = self.live()
            if len(live) <= 1:
                return                 # never drain the last live replica
            victim = min(live, key=lambda r: (r.sched.queued,
                                              len(r.sched.active), -r.rid))
            victim.draining = True
            self.metrics.record_scale(self.tick_no, "down", victim.rid,
                                      self.n_live)

    # -- driving -------------------------------------------------------------
    @property
    def busy(self) -> bool:
        return any(r.sched.queue or r.sched.active
                   for r in self.replicas.values())

    def run(self, requests=None) -> List[ServeResult]:
        """Submits ``requests``, then ticks until the fleet drains. Returns
        the kept results (empty unless ``keep_results``; FleetMetrics is
        the record either way)."""
        for req in requests or ():
            self.submit(req)
        self.drain()
        return self.results

    def drain(self, guard: int = 10**7) -> None:
        while self.busy:
            self.tick()
            guard -= 1
            if guard <= 0:
                raise RuntimeError("fleet failed to drain")

    def schedulers(self) -> List[Scheduler]:
        """Every replica's scheduler, live, draining and retired, by id."""
        every = {rid: rep.sched for rid, rep in self.replicas.items()}
        every.update(self.retired)
        return [every[rid] for rid in sorted(every)]

    def engine_summaries(self) -> Dict[int, dict]:
        """Each replica's EngineMetrics summary, retired ones included."""
        out = {rid: rep.sched.metrics.summary()
               for rid, rep in self.replicas.items()}
        out.update({rid: sched.metrics.summary()
                    for rid, sched in self.retired.items()})
        return out
