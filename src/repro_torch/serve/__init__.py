"""Detection serving: `ServeRequest` → `Scheduler` → `DetectionBackend`
(admit / step / harvest) → `ServeResult`."""
from repro_torch.serve.api import (EMISSION_KINDS, Backend, Emission,  # noqa: F401
                                   EngineMetrics, SamplingParams,
                                   ServeRequest, ServeResult)
from repro_torch.serve.backends import (DetectionBackend,  # noqa: F401
                                        DispatchWindow)
from repro_torch.serve.scheduler import Scheduler  # noqa: F401
