"""ModelBackend — the pure-Python replica model for fleet-scale replay.

A stand-in for `DetectionBackend` with the same scheduler-visible contract
(capacity / admit_width / admit / step / harvest / release): a fixed
device batch width, every admitted request completing ``service_ticks``
after admission with one final payload emission. With ``depth=K`` it
mirrors the K-deep `DetectionBackend` pool: K×width slots but width
admissions a tick, so batch t computes while the next batches stage, and
steady throughput is ``depth·width/service_ticks`` requests a tick. One
tick of this backend models one fixed-width detector dispatch whose wall
cost is carried out of band (``tick_ms``, calibrated from a serve record
by `launch.traffic.calibrate`), so a million-request replay runs at pure
Python speed while SLO accounting stays in scheduler ticks, the unit the
real fleet shares.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.serve.api import Emission, ServeRequest


class ModelBackend:
    def __init__(self, width: int = 2, service_ticks: int = 1,
                 tick_ms: float = 0.0, *, depth: int = 1):
        self.depth = max(int(depth), 1)
        self.capacity = self.depth * width
        self.admit_width = width
        self.service_ticks = max(int(service_ticks), 1)
        self.tick_ms = float(tick_ms)      # modelled wall cost a tick
        self._rows: Dict[int, int] = {}    # slot -> ticks left
        self._ems: Dict[int, List[Emission]] = {}

    def admit(self, assignments: Sequence[Tuple[int, ServeRequest]]) -> None:
        for slot, _ in assignments:
            self._rows[slot] = self.service_ticks

    def step(self) -> None:
        for slot in self._rows:
            self._rows[slot] -= 1
            if self._rows[slot] <= 0:
                self._ems.setdefault(slot, []).append(
                    Emission(kind="detections", payload=None, final=True))

    def harvest(self) -> Dict[int, List[Emission]]:
        out, self._ems = self._ems, {}
        return out

    def release(self, slot: int) -> None:
        self._rows.pop(slot, None)
        self._ems.pop(slot, None)
