"""Serving API — one backend-agnostic, streaming request lifecycle.

A request enters as a `ServeRequest` (token prompt for LM decode, image for
W1A8 detection), waits in the scheduler's bounded queue, is assigned a pool
slot, flows through a `Backend` (admit / step / harvest), and leaves as a
`ServeResult`. The scheduler owns queueing, deadlines, stop conditions and
metrics; backends own only the model computation — so LM decode and YOLO
detection serve through the same loop (DESIGN.md §10–§11).

Backend protocol (one decode/inference tick per `step`):

    admit(assignments)   stage [(slot, request), ...] into the pool —
                         batched multi-row prefill for LMs, image staging
                         for detection. May already produce emissions.
    step()               advance every active slot by one fused tick. A
                         streaming backend may *dispatch* tick t's compute
                         here and only surface its results at tick t+1
                         (double buffering — harvest order still per slot).
    harvest()            drain {slot: [Emission, ...]} produced since the
                         last harvest, in emission order.
    release(slot)        scheduler returns a finished slot to the pool.

Optional backend attributes the scheduler honours:

    admit_width          max requests admitted per tick (paged admission;
                         default: capacity). A double-buffered backend
                         exposes capacity = 2·width so one batch can be in
                         flight while the next is staged.
    host_syncs           running count of blocking device→host transfers
                         on the per-tick step/harvest path (one batched
                         transfer event = 1). The scheduler snapshots the
                         delta into EngineMetrics each tick.
    completion_syncs     transfers that only happen when a request
                         finishes (e.g. the bulk token fetch of the
                         done-mask decode path) — boundary cost, kept out
                         of the steady-state per-tick number.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode controls (LM workloads; detection ignores them)."""
    max_new: int = 16
    temperature: float = 0.0          # 0 → greedy
    stop_tokens: Tuple[int, ...] = ()  # emitting any of these ends the request


@dataclasses.dataclass
class ServeRequest:
    rid: int
    prompt: Optional[Sequence[int]] = None      # LM workloads
    image: Optional[Any] = None                 # detection workloads
    # Static image geometry (H, W, C) — the bucketed multi-resolution
    # scheduler packs per-bucket batches off this field WITHOUT touching
    # the (possibly device-resident) pixels. Auto-filled from `image` at
    # construction when omitted.
    image_shape: Optional[Tuple[int, ...]] = None
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    # Admission deadline, in scheduler ticks from submission: the request
    # must reach a pool slot within this many ticks or it expires in the
    # wait queue (finish_reason "expired"). None → wait forever (FIFO).
    deadline_ticks: Optional[int] = None
    # Completion deadline, in scheduler ticks from submission: once admitted,
    # the request must COMPLETE within this many ticks of its submit or the
    # scheduler drops the in-flight work at harvest (finish_reason "expired",
    # counted separately as expired_inflight). None → run to completion.
    completion_deadline_ticks: Optional[int] = None
    # Priority class: admission pops (priority, deadline, arrival-seq), so
    # LOWER numbers admit first; within one class ordering stays EDF with
    # FIFO tie-break. Default 0 keeps pre-priority traffic byte-identical.
    priority: int = 0

    def __post_init__(self) -> None:
        if self.image_shape is None and self.image is not None:
            self.image_shape = tuple(int(d) for d in np.shape(self.image))


@dataclasses.dataclass
class ServeResult:
    rid: int
    finish_reason: str              # "length"|"stop"|"ok"|"expired"|"rejected"
    tokens: List[int] = dataclasses.field(default_factory=list)
    detections: Optional[dict] = None           # boxes / scores / classes / raw
    n_ticks: int = 0                            # scheduler ticks slot was held
    wait_ticks: int = 0                         # ticks spent in the wait queue
    deadline_met: Optional[bool] = None         # None when no deadline was set


# The emission payload union — one `kind` tag per wire variant instead of
# parallel optional attributes (DESIGN.md §15):
#   "token"       payload: int            one host-checked LM decode token
#   "tokens"      payload: Tuple[int,...] bulk sequence (device done-mask)
#   "raw_head"    payload: dict           raw (G,G,75) head + NMS'd dets
#   "detections"  payload: dict           compact device-NMS detection set
#   "compose"     payload: dict           detect→LM hand-off (serve.compose)
EMISSION_KINDS = ("token", "tokens", "raw_head", "detections", "compose")


@dataclasses.dataclass
class Emission:
    """One unit of backend output for a slot: a `kind` tag plus the typed
    `payload` for that kind (see EMISSION_KINDS above).

    Host-side-checked LM decode emits one ``kind="token"`` per tick; a
    device-side-done backend instead emits nothing per tick and, when its
    done-mask lights up, one **bulk** ``kind="tokens"`` emission carrying
    the whole sequence plus the backend-decided `finish` reason — the async
    emission state of the streaming path (DESIGN.md §11). Detection emits a
    final ``"raw_head"`` (verification wire) or ``"detections"`` (compact
    device-NMS wire) payload dict — the dict is the wire format, so fleet
    bit-exactness checks compare it structurally, unchanged by this tag.
    `final=True` completes the request regardless of its sampling params.
    """
    kind: str = "token"
    payload: Any = None
    finish: Optional[str] = None                # backend-decided reason
    final: bool = False

    def __post_init__(self) -> None:
        if self.kind not in EMISSION_KINDS:
            raise ValueError(
                f"Emission.kind must be one of {EMISSION_KINDS}, "
                f"got {self.kind!r}")


class Backend(Protocol):
    capacity: int

    def admit(self, assignments: Sequence[Tuple[int, ServeRequest]]) -> None:
        ...

    def step(self) -> None:
        ...

    def harvest(self) -> Dict[int, List[Emission]]:
        ...

    def release(self, slot: int) -> None:
        ...


@dataclasses.dataclass
class EngineMetrics:
    """Throughput / latency / occupancy / host-sync accounting, recorded per
    tick by the scheduler and summarised by launch/serve."""
    capacity: int = 0
    ticks: int = 0
    tokens: int = 0
    images: int = 0
    submitted: int = 0
    completed: int = 0
    rejected: int = 0                 # bounded wait queue was full at submit
    expired: int = 0                  # admission deadline passed while queued
    expired_inflight: int = 0         # completion deadline overran in a slot
    host_syncs: int = 0               # per-tick step/harvest-path transfers
    host_sync_bytes: int = 0          # bytes over those transfers
    completion_syncs: int = 0         # request-completion transfers
    tick_s: List[float] = dataclasses.field(default_factory=list)
    occupancy: List[float] = dataclasses.field(default_factory=list)
    queue_depth: List[int] = dataclasses.field(default_factory=list)
    # end-to-end ticks (wait + service) per COMPLETED request — the per-
    # replica latency distribution the fleet SLO roll-up consumes
    latency_ticks: List[int] = dataclasses.field(default_factory=list)

    def record_tick(self, dt: float, active: int, *,
                    tokens: int = 0, images: int = 0,
                    queued: int = 0) -> None:
        self.ticks += 1
        self.tokens += tokens
        self.images += images
        self.tick_s.append(float(dt))
        self.occupancy.append(active / max(self.capacity, 1))
        self.queue_depth.append(int(queued))

    def summary(self) -> dict:
        wall = float(sum(self.tick_s))
        # An all-rejected (or never-ticked) window has NO recorded tick
        # latencies and NO completed requests: every quantile/mean below
        # must fall back to 0.0 instead of dividing by (or quantiling over)
        # an empty window — the summary is NaN-free by contract (regression:
        # tests/test_fleet.py::test_summary_nan_free_on_all_rejected_window).
        lat = np.asarray(self.tick_s) if self.tick_s else np.zeros(1)
        req_lat = (np.asarray(self.latency_ticks) if self.latency_ticks
                   else np.zeros(1))
        return {
            "ticks": self.ticks,
            "wall_s": wall,
            "requests_completed": self.completed,
            "requests_rejected": self.rejected,
            "requests_expired": self.expired,
            "requests_expired_inflight": self.expired_inflight,
            "requests_dropped": (self.rejected + self.expired
                                 + self.expired_inflight),
            "tokens": self.tokens,
            "images": self.images,
            "tok_per_s": self.tokens / wall if wall > 0 else 0.0,
            "img_per_s": self.images / wall if wall > 0 else 0.0,
            "tick_p50_ms": 1e3 * float(np.quantile(lat, 0.50)),
            "tick_p95_ms": 1e3 * float(np.quantile(lat, 0.95)),
            "latency_p50_ticks": float(np.quantile(req_lat, 0.50)),
            "latency_p95_ticks": float(np.quantile(req_lat, 0.95)),
            "batch_occupancy": (float(np.mean(self.occupancy))
                                if self.occupancy else 0.0),
            "host_syncs": self.host_syncs,
            "completion_syncs": self.completion_syncs,
            "host_syncs_per_tick": (self.host_syncs / self.ticks
                                    if self.ticks else 0.0),
            "host_sync_bytes_per_tick": (self.host_sync_bytes / self.ticks
                                         if self.ticks else 0.0),
            # per-sync payload width: comparable across overlap on/off and
            # across tick counts (drain ticks sync nothing)
            "host_sync_bytes_per_sync": (self.host_sync_bytes
                                         / self.host_syncs
                                         if self.host_syncs else 0.0),
            "queue_depth_max": (max(self.queue_depth)
                                if self.queue_depth else 0),
            "queue_depth_mean": (float(np.mean(self.queue_depth))
                                 if self.queue_depth else 0.0),
        }
