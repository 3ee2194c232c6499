"""Fleet-scale serving: a `Router` of N backend replicas, each its own
`Scheduler` slot pool, with least-queue-depth dispatch (deadline-slack
tie-break), an `Autoscaler` with hysteresis, and a `FleetMetrics` roll-up
(fleet p50/p95 in ticks, drops by cause, scale events, replica timeline).
`launch/traffic.py` replays seeded traces through this tier: millions of
requests through the pure-Python `ModelBackend`, and a shorter stream
through real `DetectionBackend` replicas on the card."""
from repro_torch.serve.fleet.autoscaler import (Autoscaler,  # noqa: F401
                                                AutoscalerConfig)
from repro_torch.serve.fleet.metrics import FleetMetrics  # noqa: F401
from repro_torch.serve.fleet.model import ModelBackend  # noqa: F401
from repro_torch.serve.fleet.router import Replica, Router  # noqa: F401
