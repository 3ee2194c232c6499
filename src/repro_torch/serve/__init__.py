"""Serving: `ServeRequest` → `Scheduler` → `Backend` (admit / step /
harvest) → `ServeResult`, for W1A8 detection (`DetectionBackend`) and LM
decode (`LMBackend`, with the ring caches, prefill / decode steps and
packed-W1A8 deployment beside it); above one backend, the fleet tier
(`serve.fleet`: `Router`, `Autoscaler`, `FleetMetrics`, `ModelBackend`)
and the detect→LM pipeline (`serve.compose`)."""
from repro_torch.serve.api import (EMISSION_KINDS, Backend, Emission,  # noqa: F401
                                   EngineMetrics, SamplingParams,
                                   ServeRequest, ServeResult)
from repro_torch.serve.backends import (DetectionBackend,  # noqa: F401
                                        DispatchWindow, LMBackend)
from repro_torch.serve.cache import (cache_bytes, init_cache,  # noqa: F401
                                     merge_rows)
from repro_torch.serve.engine import (decode_step, generate,  # noqa: F401
                                      prefill)
from repro_torch.serve.packed import (deploy_lm,  # noqa: F401
                                      packed_param_bytes)
from repro_torch.serve.scheduler import Scheduler  # noqa: F401
from repro_torch.serve.compose import (ComposePipeline,  # noqa: F401
                                       ComposeRequest, ComposeResult,
                                       detections_to_prompt)
from repro_torch.serve.fleet import (Autoscaler,  # noqa: F401
                                     AutoscalerConfig, FleetMetrics,
                                     ModelBackend, Replica, Router)
