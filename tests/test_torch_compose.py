"""Port parity, detect→LM composition and real fleets (CPU).

`detections_to_prompt` is held to the reference's on both wires. The
pipelines are compared on fixed detection payloads (a stub detect backend
emitting the score-separated fixture's kept sets, since untrained heads
tie at the NMS threshold) feeding the reduced chatglm3-6b with the
reference's init, greedy: results, hand-off order and conservation equal.
The port's real `DetectionBackend` at bucket 64 then runs compose, a
1- and a 2-replica fleet (payloads bit for bit equal) and the launchers'
fleet and compose workloads.
"""
import argparse
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import nms_fixtures, traffic  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import detection, yolo  # noqa: E402
from repro_torch.models.transformer import init_lm_params  # noqa: E402
from repro_torch.serve import (ComposePipeline, ComposeRequest,  # noqa: E402
                               DetectionBackend, LMBackend, SamplingParams,
                               detections_to_prompt)
from repro_torch.serve import api  # noqa: E402

ARCH = "chatglm3-6b"


def test_detections_to_prompt_matches_reference():
    compact = {"valid": 2, "classes": np.array([3, 7, 0]),
               "scores": np.array([0.9, 0.8, 0.0])}
    raw = {"scores": np.array([0.5, 0.0, 0.25]),
           "classes": np.array([3, 9, 7])}
    many = {"valid": 11, "classes": np.arange(40, 51),
            "scores": np.ones(11)}
    for payload in (compact, raw, many, None):
        for vocab in (4, 5, 64, 65024):
            for k in (0, 3, 8):
                got = detections_to_prompt(payload, vocab=vocab,
                                           max_classes=k)
                want = jserve.detections_to_prompt(payload, vocab=vocab,
                                                   max_classes=k)
                assert got == want and isinstance(got, tuple)
                assert all(1 <= t < vocab for t in got)
    p = detections_to_prompt(compact, vocab=64)
    assert p[0] == 1 and len(p) == 4
    assert detections_to_prompt(raw, vocab=64) == p
    assert detections_to_prompt(None, vocab=64)[1] != p[1]
    for vocab in (3, 0):
        with pytest.raises(ValueError, match="vocab too small"):
            detections_to_prompt(None, vocab=vocab)
        with pytest.raises(ValueError, match="vocab too small"):
            jserve.detections_to_prompt(None, vocab=vocab)


def _payloads():
    """Fixed payloads from the score-separated fixture's kept set: the
    compact wire keeping its first k detections (k = 0..6), and the raw
    wire (scores > 0 mark live rows) of the same sets."""
    raw, peaks = nms_fixtures.separated_head()
    boxes, scores, classes = detection.postprocess(torch.from_numpy(raw))
    b, s, c, valid = (t.numpy() for t in detection.compact_detections(
        boxes, scores, classes))
    assert int(valid[0]) == len(peaks)
    out = []
    for k in range(len(peaks) + 1):
        keep = np.arange(s.shape[1]) < k
        out.append({"boxes": np.where(keep[:, None], b[0], 0)
                    .astype(np.float32),
                    "scores": np.where(keep, s[0], 0).astype(np.float32),
                    "classes": np.where(keep, c[0], 0).astype(np.int32),
                    "valid": k})
        out.append({key: out[-1][key] for key in
                    ("boxes", "scores", "classes")})
    return out


class StubDetect:
    """A detect backend emitting fixed payloads: width admissions a tick,
    ``depth × width`` slots, each request's payload ``service`` ticks after
    admission (payload rid % len)."""

    def __init__(self, emission_cls, payloads, width=2, depth=2, service=2):
        self.capacity, self.admit_width = depth * width, width
        self._emission, self._payloads = emission_cls, payloads
        self._service = service
        self._rows, self._ems = {}, {}

    def admit(self, assignments):
        for slot, req in assignments:
            self._rows[slot] = [req.rid, self._service]

    def step(self):
        for slot, row in self._rows.items():
            row[1] -= 1
            if row[1] == 0:
                payload = self._payloads[row[0] % len(self._payloads)]
                self._ems[slot] = [self._emission(
                    kind="detections", payload=payload, final=True)]

    def harvest(self):
        out, self._ems = self._ems, {}
        return out

    def release(self, slot):
        self._rows.pop(slot, None)
        self._ems.pop(slot, None)


def _run_pipeline(pipe_cls, req_cls, sp, backend, payloads):
    pipe = pipe_cls(backend[0], backend[1], vocab=backend[2], max_queue=6)
    reqs = [req_cls(rid=i, image=np.zeros((1,)), sampling=sp,
                    deadline_ticks=(1 if i % 5 == 4 else None))
            for i in range(14)]
    results = pipe.run(reqs)
    summary = pipe.summary()
    return {"results": [(r.rid, r.finish_reason, tuple(r.prompt), r.tokens,
                         r.detect_ticks, r.lm_ticks) for r in results],
            "handoffs": [(h.kind, h.payload["prompt"])
                         for h in pipe.handoffs],
            "summary": {k: summary[k] for k in (
                "submitted", "completed", "lost", "duplicated", "handoffs",
                "ticks")}}


def test_compose_pipeline_matches_reference_on_fixed_payloads():
    payloads = _payloads()
    jcfg = jconfigs.get_reduced(ARCH)
    cfg = configs.get_reduced(ARCH)
    jp = jtransformer.init_lm_params(jax.random.PRNGKey(1), jcfg)
    p = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     device="cpu")
    want = _run_pipeline(
        jserve.ComposePipeline, jserve.ComposeRequest,
        japi.SamplingParams(max_new=4),
        (StubDetect(japi.Emission, payloads),
         jserve.LMBackend(jcfg, jp, slots=2, max_len=32, seed=0),
         jcfg.vocab_size), payloads)
    got = _run_pipeline(
        ComposePipeline, ComposeRequest, SamplingParams(max_new=4),
        (StubDetect(api.Emission, payloads),
         LMBackend(cfg, p, slots=2, max_len=32, seed=0, device="cpu"),
         cfg.vocab_size), payloads)
    assert got == want
    s = got["summary"]
    assert s["lost"] == 0 and s["duplicated"] == 0 and s["submitted"] == 14
    reasons = {why for _, why, *_ in got["results"]}
    assert "length" in reasons and reasons & {"detect_rejected",
                                              "detect_expired"}
    assert len(got["handoffs"]) == sum(
        why in ("length", "stop") for _, why, *_ in got["results"])


@pytest.fixture(scope="module")
def cpu_detector():
    imgs = launch.make_images(8, 3, size=64)
    _, art = yolo.build_detector(3, imgs[:1].astype(np.float32) / 256.0,
                                 device="cpu")
    return art, imgs


def test_compose_with_real_detector_conserves_requests(cpu_detector):
    art, imgs = cpu_detector
    cfg = configs.get_reduced(ARCH)
    params = init_lm_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    detect = DetectionBackend(art, slots=2, depth=2, device_nms=True,
                              device="cpu")
    lm = LMBackend(cfg, params, slots=2, max_len=32, seed=0, device="cpu")
    pipe = ComposePipeline(detect, lm, vocab=cfg.vocab_size)
    results = pipe.run([ComposeRequest(rid=i, image=imgs[i],
                                       sampling=SamplingParams(max_new=4))
                        for i in range(4)])
    s = pipe.summary()
    assert s["lost"] == 0 and s["duplicated"] == 0
    assert s["handoffs"] == len(results) == 4
    assert all(h.kind == "compose" for h in pipe.handoffs)
    for r in results:
        assert r.finish_reason in ("length", "stop") and r.tokens
        assert r.prompt == detections_to_prompt(r.detections,
                                                vocab=cfg.vocab_size)
        assert r.detect_ticks >= 1 and r.lm_ticks >= 1


def test_real_fleet_payloads_equal_one_replica(cpu_detector):
    art, _ = cpu_detector
    template = DetectionBackend(art, slots=2, depth=2, device_nms=True,
                                device="cpu")
    template.warmup()
    one, s1, _, d1 = traffic._run_real_fleet(template, 1, 12, 5, 64)
    two, s2, _, d2 = traffic._run_real_fleet(template, 2, 12, 5, 64)
    assert sorted(one) == sorted(two) == list(range(12))
    launch.check_bit_exact(two, one, "2 replicas vs 1")
    assert s1["requests_lost"] == s2["requests_lost"] == 0
    assert s2["replicas_max"] == 2
    assert d1 == 6 and d2 >= 6               # one dispatch a full batch


def test_launcher_fleet_and_compose_on_the_cpu(tmp_path):
    out = tmp_path / "serve.json"
    base = ["--device", "cpu", "--buckets", "64", "--slots", "2"]
    rec = launch.main(["--workload", "detect", "--requests", "8",
                       "--replicas", "2", "--autoscale", "--out",
                       str(out)] + base)
    fleet = rec["fleet"]
    assert fleet["requests_completed"] == 8 and fleet["requests_lost"] == 0
    assert fleet["replicas_min"] == 2 and fleet["autoscale"]
    assert fleet["dispatches"] >= 4
    comp = launch.main(["--workload", "compose", "--reduced", "--arch",
                        ARCH, "--requests", "3", "--max-new", "4",
                        "--max-len", "32", "--out", str(out)] + base)
    assert comp["lost"] == comp["duplicated"] == 0
    assert comp["handoffs"] == comp["completed"] == 3
    saved = json.loads(out.read_text())
    assert set(saved) == {"detect", "compose"}
    assert saved["detect"]["device"] == "cpu"
    assert saved["detect"]["fleet"]["requests_lost"] == 0
    # traffic calibrates from that record; its real mode writes its own
    assert traffic.calibrate(str(out))["width"] == 2
    fleet_out = tmp_path / "fleet.json"
    real = traffic.main(["--mode", "real", "--device", "cpu", "--bucket",
                         "64", "--requests", "6", "--out", str(fleet_out)])
    assert real["device"] == "cpu" and real["fleet"]["requests_lost"] == 0
    assert set(json.loads(fleet_out.read_text())) == {"real"}


def test_run_compose_takes_params(cpu_detector):
    cfg = configs.get_reduced(ARCH)
    params = init_lm_params(cfg, torch.Generator().manual_seed(9),
                            device="cpu")
    args = argparse.Namespace(
        device="cpu", requests=2, buckets="64", seed=0, slots=2, depth=2,
        profile="tuned", arch=ARCH, reduced=True, max_new=3, max_len=32,
        temperature=0.0, stop_token=[])
    a = launch.run_compose(args, params=params)
    b = launch.run_compose(args, params=params)
    assert a["tokens_by_rid"] == b["tokens_by_rid"]
    assert a["prompts_by_rid"] == b["prompts_by_rid"]
