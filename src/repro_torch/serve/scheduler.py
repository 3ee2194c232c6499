"""Request scheduler — paged admission, deadlines, priorities, metrics.

One `tick` = admit (expire overdue waiters, then fill free slots from the
bounded wait queue — at most `backend.admit_width` requests globally and
`backend.bucket_admit_width` per resolution bucket, one batched
backend.admit call) → backend.step (one fused compute tick; a K-deep
streaming backend dispatches tick t here and surfaces its results up to
K-1 ticks later, in dispatch order) → harvest (ingest kind-tagged
emissions in order, finish requests on stop-token / max_new /
final-payload / bulk finish, drop in-flight work that overran its
completion deadline, recycle slots).

Admission order is **(priority, deadline, arrival-seq)**: the queue pops the
smallest triple, so lower `ServeRequest.priority` classes admit strictly
first, and *within* one class ordering stays EDF with FIFO tie-break —
deadline-free priority-0 traffic is byte-identical to the pre-priority
scheduler. The wait queue is bounded (`max_queue`): a submit into a full
queue is rejected immediately (finish_reason "rejected"); a waiter whose
admission deadline passes before a slot frees expires (finish_reason
"expired"); an admitted request that overruns
`ServeRequest.completion_deadline_ticks` is dropped at harvest (finish
reason "expired", counted separately as `expired_inflight` — its slot
recycles, late backend emissions for it are ignored). A burst is always
fully accounted: completed + rejected + expired + expired_inflight =
submitted.

Because priority reorders the admission heap, deadline expiry runs off a
*separate* min-heap keyed by absolute deadline with lazy deletion: both
heaps hold only (key..., seq) and `_waiting[seq]` is the single source of
liveness — admitting or expiring a seq removes it from `_waiting`, and
stale heap entries are skipped (and pruned from the head) when popped.

Invariants:
  * a slot is in exactly one of {free, active} between ticks;
  * every waiting request's seq is in `_waiting` and on the admission heap;
  * emissions for one slot are ingested in emission order, and everything
    after the finishing emission is dropped (a fused decode tick may
    overrun a request's stop condition by one token);
  * the wait queue drains to empty whenever the backend has capacity and
    requests have no (or generous) deadlines.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import time
from typing import Callable, Dict, List, Optional

from repro_torch.serve.api import (Backend, EngineMetrics, ServeRequest,
                             ServeResult)

_NO_DEADLINE = float("inf")


@dataclasses.dataclass
class _Active:
    req: ServeRequest
    tokens: List[int] = dataclasses.field(default_factory=list)
    payload: Optional[dict] = None
    admitted_tick: int = 0
    wait_ticks: int = 0
    complete_by: float = _NO_DEADLINE   # last tick index allowed to finish


class Scheduler:
    def __init__(self, backend: Backend, *,
                 max_queue: Optional[int] = None,
                 metrics: Optional[EngineMetrics] = None,
                 result_sink: Optional[Callable[[ServeResult], None]] = None):
        self.backend = backend
        self.metrics = metrics or EngineMetrics(capacity=backend.capacity)
        self.metrics.capacity = backend.capacity
        # admission heap of (priority, abs_deadline, seq); expiry heap of
        # (abs_deadline, seq); _waiting[seq] = (req, submit_tick) is liveness
        self.queue: List[tuple] = []
        self._deadlines: List[tuple] = []
        self._waiting: Dict[int, tuple] = {}
        self.max_queue = max_queue
        self.free: List[int] = list(range(backend.capacity))
        self.active: Dict[int, _Active] = {}
        # results accumulate here unless a sink consumes them (the fleet
        # router streams millions of results through FleetMetrics without
        # holding them all live)
        self.results: List[ServeResult] = []
        self._sink = result_sink
        self._seq = 0
        # syncs already on the backend's counters (e.g. a warmup pass) are
        # not this scheduler's to credit
        self._synced = getattr(backend, "host_syncs", 0)
        self._synced_bytes = getattr(backend, "host_sync_bytes", 0)
        self._completion_synced = getattr(backend, "completion_syncs", 0)

    # -- introspection (the fleet router routes on these) --------------------
    @property
    def queued(self) -> int:
        """Live wait-queue depth (stale heap entries excluded)."""
        return len(self._waiting)

    def queued_in_bucket(self, bucket) -> int:
        """Live wait-queue depth restricted to one resolution bucket — the
        fleet router's per-bucket depth signal. Falls back to the global
        depth when the backend is not bucketed."""
        bucket_of = getattr(self.backend, "bucket_of", None)
        if bucket_of is None:
            return len(self._waiting)
        return sum(1 for req, _ in self._waiting.values()
                   if bucket_of(req) == bucket)

    def earliest_deadline(self) -> float:
        """Earliest absolute admission deadline still waiting (inf when the
        queue holds no deadlined request) — the router's slack signal."""
        while self._deadlines and self._deadlines[0][1] not in self._waiting:
            heapq.heappop(self._deadlines)
        return self._deadlines[0][0] if self._deadlines else _NO_DEADLINE

    def _emit_result(self, res: ServeResult) -> None:
        if self._sink is not None:
            self._sink(res)
        else:
            self.results.append(res)

    # -- submission ----------------------------------------------------------
    def submit(self, req: ServeRequest) -> bool:
        """Queue a request. Returns False (and surfaces a "rejected" result)
        when the bounded wait queue is full."""
        self.metrics.submitted += 1
        if self.max_queue is not None and len(self._waiting) >= self.max_queue:
            self.metrics.rejected += 1
            self._emit_result(ServeResult(
                rid=req.rid, finish_reason="rejected",
                deadline_met=(False if req.deadline_ticks is not None
                              else None)))
            return False
        dl = (_NO_DEADLINE if req.deadline_ticks is None
              else self.metrics.ticks + req.deadline_ticks)
        seq = self._seq
        self._seq += 1
        heapq.heappush(self.queue, (getattr(req, "priority", 0), dl, seq))
        self._waiting[seq] = (req, self.metrics.ticks)
        if dl != _NO_DEADLINE:
            heapq.heappush(self._deadlines, (dl, seq))
        return True

    # -- one scheduling tick -------------------------------------------------
    def _expire_overdue(self) -> None:
        """Drop waiters whose admission deadline has already passed — the
        expiry heap orders by absolute deadline, so overdue entries are at
        its front regardless of priority reordering on the admission heap."""
        while self._deadlines and self._deadlines[0][0] < self.metrics.ticks:
            _, seq = heapq.heappop(self._deadlines)
            entry = self._waiting.pop(seq, None)
            if entry is None:                      # already admitted
                continue
            req, submitted = entry
            self.metrics.expired += 1
            self._emit_result(ServeResult(
                rid=req.rid, finish_reason="expired",
                wait_ticks=self.metrics.ticks - submitted,
                deadline_met=False))
        # keep `self.queue` truthiness meaning "live work waits": once
        # nothing is live the stale heap tail must not wedge drain loops
        while self.queue and self.queue[0][2] not in self._waiting:
            heapq.heappop(self.queue)

    def admit(self) -> int:
        """Fill free slots from the wait queue — at most `admit_width`
        requests (paged admission; a K-deep backend keeps its device batch
        width while holding (K-1+buckets)× slots) — in one batched
        backend.admit call. Returns the number admitted.

        Per-bucket accounting: a bucketed backend (one exposing
        ``bucket_of`` + ``bucket_admit_width``) admits at most
        ``bucket_admit_width`` requests *per bucket* per tick. A request
        whose bucket page is already full this tick is DEFERRED — left
        waiting, re-pushed with its original heap key — instead of ending
        the scan, so a starved bucket is never silently blocked behind a
        full sibling bucket (tests/test_serve_kdeep.py regression)."""
        self._expire_overdue()
        width = getattr(self.backend, "admit_width", None) \
            or self.backend.capacity
        bucket_of = getattr(self.backend, "bucket_of", None)
        bucket_width = getattr(self.backend, "bucket_admit_width", None)
        per_bucket: collections.Counter = collections.Counter()
        deferred: List[tuple] = []
        batch = []
        while self.queue and self.free and len(batch) < width:
            item = heapq.heappop(self.queue)
            seq = item[2]
            entry = self._waiting.get(seq)
            if entry is None:                      # stale (expired) entry
                continue
            req, submitted = entry
            cd = getattr(req, "completion_deadline_ticks", None)
            complete_by = (_NO_DEADLINE if cd is None else submitted + cd - 1)
            if complete_by < self.metrics.ticks:
                # completion already impossible (even a 1-tick service
                # misses): expire from the queue instead of burning a slot
                del self._waiting[seq]
                self.metrics.expired += 1
                self._emit_result(ServeResult(
                    rid=req.rid, finish_reason="expired",
                    wait_ticks=self.metrics.ticks - submitted,
                    deadline_met=False))
                continue
            if bucket_of is not None and bucket_width:
                b = bucket_of(req)
                if per_bucket[b] >= bucket_width:
                    deferred.append(item)          # full page: bucket waits,
                    continue                       # siblings keep admitting
                per_bucket[b] += 1
            del self._waiting[seq]
            slot = self.free.pop(0)
            batch.append((slot, req))
            self.active[slot] = _Active(
                req, admitted_tick=self.metrics.ticks,
                wait_ticks=self.metrics.ticks - submitted,
                complete_by=complete_by)
        for item in deferred:                      # original keys: ordering
            heapq.heappush(self.queue, item)       # is stable across ticks
        if batch:
            self.backend.admit(batch)
        return len(batch)

    def step_harvest(self, t0: Optional[float] = None) -> None:
        """One backend compute tick + emission ingest / completion. ``t0``
        lets tick() charge admission (batched prefill) to this tick's
        latency, so tick times are end to end."""
        if t0 is None:
            t0 = time.perf_counter()
        active_now = len(self.active)
        self.backend.step()
        tokens = images = 0
        for slot, ems in sorted(self.backend.harvest().items()):
            rec = self.active.get(slot)
            if rec is None:
                continue
            finish = None
            for em in ems:
                if em.kind == "tokens":         # bulk (device-side done-mask)
                    rec.tokens.extend(int(t) for t in em.payload)
                    tokens += len(em.payload)
                    if em.final:
                        finish = em.finish or "ok"
                        break
                    continue
                if em.kind != "token":          # payload wire (raw_head /
                    if em.final:                # detections / compose)
                        rec.payload = em.payload
                        images += 1
                        finish = em.finish or "ok"
                        break
                    continue
                tok = int(em.payload)
                rec.tokens.append(tok)
                tokens += 1
                sp = rec.req.sampling
                if tok in sp.stop_tokens:
                    finish = "stop"
                    break
                if len(rec.tokens) >= sp.max_new:
                    finish = "length"
                    break
            if finish:
                self._finish(slot, finish)
        # drop in-flight work that overran its completion deadline: it can
        # no longer finish inside its budget, so the slot recycles now and
        # any late backend emissions for it are ignored at harvest
        overrun = [slot for slot, rec in self.active.items()
                   if self.metrics.ticks >= rec.complete_by]
        for slot in overrun:
            self._drop_inflight(slot)
        # credit this tick's blocking device→host transfers (backends keep
        # running counters; the scheduler snapshots the step-path delta)
        syncs = getattr(self.backend, "host_syncs", None)
        if syncs is not None:
            self.metrics.host_syncs += syncs - self._synced
            self._synced = syncs
        sbytes = getattr(self.backend, "host_sync_bytes", None)
        if sbytes is not None:
            self.metrics.host_sync_bytes += sbytes - self._synced_bytes
            self._synced_bytes = sbytes
        csyncs = getattr(self.backend, "completion_syncs", None)
        if csyncs is not None:
            self.metrics.completion_syncs += csyncs - self._completion_synced
            self._completion_synced = csyncs
        self.metrics.record_tick(time.perf_counter() - t0, active_now,
                                 tokens=tokens, images=images,
                                 queued=len(self._waiting))

    def tick(self) -> None:
        t0 = time.perf_counter()
        self.admit()
        self.step_harvest(t0=t0)

    # -- driving -------------------------------------------------------------
    def run(self, requests=None) -> List[ServeResult]:
        """Serve until queue and pool drain; returns completion-ordered
        results (also kept on self.results unless a result_sink consumes
        them)."""
        for req in requests or ():
            self.submit(req)
        start = len(self.results)
        while self.queue or self.active:
            self.tick()
        return self.results[start:]

    def _finish(self, slot: int, reason: str) -> None:
        rec = self.active.pop(slot)
        dl = rec.req.deadline_ticks
        n_ticks = self.metrics.ticks - rec.admitted_tick + 1
        self._emit_result(ServeResult(
            rid=rec.req.rid, finish_reason=reason, tokens=rec.tokens,
            detections=rec.payload,
            n_ticks=n_ticks,
            wait_ticks=rec.wait_ticks,
            deadline_met=(None if dl is None else rec.wait_ticks <= dl)))
        self.metrics.completed += 1
        self.metrics.latency_ticks.append(rec.wait_ticks + n_ticks)
        self.backend.release(slot)
        self.free.append(slot)

    def _drop_inflight(self, slot: int) -> None:
        """Completion-deadline overrun: surface "expired" at harvest, count
        it as expired_inflight (NOT completed), recycle the slot."""
        rec = self.active.pop(slot)
        self._emit_result(ServeResult(
            rid=rec.req.rid, finish_reason="expired", tokens=rec.tokens,
            n_ticks=self.metrics.ticks - rec.admitted_tick + 1,
            wait_ticks=rec.wait_ticks,
            deadline_met=False))
        self.metrics.expired_inflight += 1
        self.backend.release(slot)
        self.free.append(slot)
