"""Detect→LM composition: two workload classes on one tick loop.

A `ComposeRequest` carries an image and LM sampling params. Stage 1 serves
the image through a detection `Scheduler`; when its final detection
emission completes, the detections are templated into an LM prompt
("describe what was detected": a describe token, a count token, then one
token per detected class) and handed off as a ``kind="compose"``
`Emission`, which the pipeline re-admits to the LM `Scheduler` as a
stage-2 `ServeRequest` on the same tick loop. The detect scheduler ticks
first, so a detection finishing at tick t starts LM prefill at tick t.

Conservation: every submitted ComposeRequest surfaces exactly one
`ComposeResult`. A stage-1 rejection or expiry short-circuits with a
``detect_*`` finish reason; a stage-2 failure keeps the detections and
reports the LM's reason. After a drain ``lost == 0`` and no rid repeats.

On the card both backends share the device and the current stream: the
detector's graph replays and the LM's eager decode are ordered on it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.api import Emission, SamplingParams, ServeRequest
from repro_torch.serve.scheduler import Scheduler

# Reserved prompt-template token ids (folded into the LM vocab below).
_TOK_DESCRIBE = 1          # "describe what was detected"
_TOK_COUNT0 = 2            # count tokens start here; classes follow


def detections_to_prompt(payload: Optional[dict], *, vocab: int,
                         max_classes: int = 8) -> Tuple[int, ...]:
    """The detection → prompt template.

    Takes either detection wire: the compact device-NMS form (boxes /
    scores / classes / valid) or the raw-head form (scores > 0 mark live
    rows). Returns LM token ids [DESCRIBE, COUNT(n), CLS(c_0), ...,
    CLS(c_{k-1})] with k ≤ max_classes, every id folded into [1, vocab),
    so the same detections always give the same prompt.
    """
    if vocab < 4:
        raise ValueError(f"vocab too small for the template: {vocab}")
    if payload is None:
        n, classes = 0, []
    elif "valid" in payload:
        n = int(payload["valid"])
        classes = [int(c) for c in np.asarray(payload["classes"])[:n]]
    else:
        scores = np.asarray(payload["scores"]).reshape(-1)
        keep = np.flatnonzero(scores > 0)
        n = int(keep.size)
        classes = [int(c) for c in np.asarray(
            payload["classes"]).reshape(-1)[keep]]
    span = vocab - 1                    # ids land in [1, vocab)
    toks = [_TOK_DESCRIBE, 1 + (_TOK_COUNT0 - 1 + n) % span]
    toks += [1 + (_TOK_COUNT0 + int(c)) % span
             for c in classes[:max_classes]]
    return tuple(toks)


@dataclasses.dataclass
class ComposeRequest:
    rid: int
    image: Any
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    deadline_ticks: Optional[int] = None
    priority: int = 0


@dataclasses.dataclass
class ComposeResult:
    rid: int
    finish_reason: str          # LM reason, or "detect_<reason>"
    detections: Optional[dict] = None
    prompt: Tuple[int, ...] = ()
    tokens: List[int] = dataclasses.field(default_factory=list)
    detect_ticks: int = 0       # stage-1 ticks, wait included
    lm_ticks: int = 0           # stage-2 ticks, wait included


class ComposePipeline:
    """Two schedulers, one tick loop: detection feeding LM description.

    ``detect_backend`` and ``lm_backend`` are ordinary serve backends;
    each gets its own Scheduler (slot pool, deadlines, metrics) and both
    tick once a pipeline tick, detect first. ``handoffs`` keeps the
    ``kind="compose"`` emissions in hand-off order.
    """

    def __init__(self, detect_backend, lm_backend, *, vocab: int,
                 max_queue: Optional[int] = None,
                 max_classes: int = 8):
        self.vocab = int(vocab)
        self.max_classes = int(max_classes)
        self.detect = Scheduler(detect_backend, max_queue=max_queue,
                                result_sink=self._on_detect)
        self.lm = Scheduler(lm_backend, max_queue=max_queue,
                            result_sink=self._on_lm)
        self._meta: Dict[int, ComposeRequest] = {}   # rid → stage-1 request
        self._stage1: Dict[int, dict] = {}           # rid → hand-off record
        self.handoffs: List[Emission] = []
        self.results: List[ComposeResult] = []
        self.submitted = 0
        self.tick_no = 0

    # -- stage sinks ---------------------------------------------------------
    def _on_detect(self, res) -> None:
        meta = self._meta.pop(res.rid)
        if res.finish_reason != "ok":
            # stage 1 produced no payload: surface the short-circuit now,
            # so the request is still conserved
            self.results.append(ComposeResult(
                rid=res.rid, finish_reason=f"detect_{res.finish_reason}",
                detections=res.detections,
                detect_ticks=res.wait_ticks + res.n_ticks))
            return
        prompt = detections_to_prompt(res.detections, vocab=self.vocab,
                                      max_classes=self.max_classes)
        self.handoffs.append(Emission(
            kind="compose", final=True,
            payload={"prompt": prompt, "detections": res.detections}))
        self._stage1[res.rid] = {
            "detections": res.detections, "prompt": prompt,
            "detect_ticks": res.wait_ticks + res.n_ticks}
        # the LM scheduler ticks after the detect one, so this request can
        # prefill this tick
        self.lm.submit(ServeRequest(
            rid=res.rid, prompt=list(prompt), sampling=meta.sampling,
            priority=meta.priority))

    def _on_lm(self, res) -> None:
        rec = self._stage1.pop(res.rid)
        self.results.append(ComposeResult(
            rid=res.rid, finish_reason=res.finish_reason,
            detections=rec["detections"], prompt=rec["prompt"],
            tokens=list(res.tokens),
            detect_ticks=rec["detect_ticks"],
            lm_ticks=res.wait_ticks + res.n_ticks))

    # -- driving -------------------------------------------------------------
    def submit(self, req: ComposeRequest) -> bool:
        self.submitted += 1
        self._meta[req.rid] = req
        return self.detect.submit(ServeRequest(
            rid=req.rid, image=req.image,
            deadline_ticks=req.deadline_ticks, priority=req.priority))

    def tick(self) -> None:
        self.detect.tick()
        self.lm.tick()
        self.tick_no += 1

    @property
    def busy(self) -> bool:
        return bool(self.detect.queue or self.detect.active
                    or self.lm.queue or self.lm.active)

    def run(self, requests=None, guard: int = 10**6) -> List[ComposeResult]:
        for req in requests or ():
            self.submit(req)
        while self.busy:
            self.tick()
            guard -= 1
            if guard <= 0:
                raise RuntimeError("compose pipeline failed to drain")
        return self.results

    @property
    def lost(self) -> int:
        """Requests submitted but never surfaced (0 after a drain)."""
        return self.submitted - len(self.results)

    def summary(self) -> dict:
        rids = [r.rid for r in self.results]
        return {
            "submitted": self.submitted,
            "completed": len(self.results),
            "lost": self.lost,
            "duplicated": len(rids) - len(set(rids)),
            "handoffs": len(self.handoffs),
            "ticks": self.tick_no,
            "detect": self.detect.metrics.summary(),
            "lm": self.lm.metrics.summary(),
        }
