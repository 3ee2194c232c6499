"""Port parity, serving: decode/NMS kept sets, the dispatch window's
harvest order, and the port's `DetectionBackend` on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import detection as jdetection  # noqa: E402
from repro.serve import DispatchWindow as JDispatchWindow  # noqa: E402
from repro.serve import Scheduler as JScheduler  # noqa: E402
from repro.serve import ServeRequest as JServeRequest  # noqa: E402
from repro.serve.api import Emission as JEmission  # noqa: E402
from repro_torch.launch import nms_fixtures  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import detection, yolo  # noqa: E402
from repro_torch.serve import (DetectionBackend, DispatchWindow,  # noqa: E402
                               Scheduler, ServeRequest)
from repro_torch.serve.api import Emission  # noqa: E402


def test_decode_nms_compact_kept_sets_identical():
    # the score-separated head of tests/test_serve_detect.py
    raw, peaks = nms_fixtures.separated_head()
    jb, js, jc = jdetection.postprocess(jnp.asarray(raw))
    tb, ts, tc = detection.postprocess(torch.from_numpy(raw))
    assert tc.dtype == torch.int32
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    want = jdetection.detections_to_list(jb[0], js[0], jc[0])
    got = detection.detections_to_list(tb[0], ts[0], tc[0])
    assert len(got) == len(want) == len(peaks)
    assert [d["class_id"] for d in got] == [d["class_id"] for d in want]
    jcompact = jdetection.compact_detections(jb[0], js[0], jc[0])
    tcompact = detection.compact_detections(tb, ts, tc)
    assert int(tcompact[3][0]) == int(jcompact[3]) == len(peaks)
    for t, j in zip(tcompact[:3], jcompact[:3]):
        assert str(t.dtype).split(".")[-1] == str(np.asarray(j).dtype)
        np.testing.assert_allclose(t[0].numpy().astype(np.float32),
                                   np.asarray(j).astype(np.float32),
                                   atol=1e-3)
    dec, jdec = detection.decode_head(torch.from_numpy(raw)), \
        jdetection.decode_head(jnp.asarray(raw))
    for leaf in ("boxes", "scores"):
        np.testing.assert_allclose(dec[leaf].numpy(), np.asarray(jdec[leaf]),
                                   rtol=1e-6, atol=1e-7)


class _WindowedMock:
    """Backend driving a dispatch window through a real Scheduler: admitted
    rows stage, step() dispatches them and harvests due batches, each row
    emits one final payload at its batch's harvest."""

    def __init__(self, window_cls, emission_cls, slots, depth):
        self.capacity = depth * slots
        self.admit_width = slots
        self._emission = emission_cls
        self._rows, self._staged, self._due = {}, [], []
        self._window = window_cls(depth)

    def admit(self, assignments):
        for slot, req in assignments:
            self._rows[slot] = req.rid
            self._staged.append(slot)

    def step(self):
        pushed = bool(self._staged)
        if pushed:
            self._window.push(list(self._staged))
            self._staged = []
        self._due = self._window.pop_due(pushed=pushed)

    def harvest(self):
        out = {slot: [self._emission(kind="detections",
                                     payload={"rid": self._rows[slot]},
                                     final=True)]
               for batch in self._due for slot in batch}
        self._due = []
        return out

    def release(self, slot):
        self._rows.pop(slot, None)


def _harvest_trace(window_cls, emission_cls, sched_cls, req_cls, trace,
                   depth):
    sched = sched_cls(_WindowedMock(window_cls, emission_cls, 2, depth))
    got, tick = [], [0]
    sched._sink = lambda res: got.append((tick[0], res.rid))
    arrivals = {t: list(rids) for t, rids in trace.items()}
    for t in range(10_000):
        tick[0] = t
        for rid in arrivals.pop(t, []):
            assert sched.submit(req_cls(rid=rid))
        sched.tick()
        if not arrivals and not (sched.queue or sched.active):
            return got
    raise AssertionError("scheduler failed to drain")


TRACES = {
    "burst": {0: list(range(12))},
    "drip": {t: [t] for t in range(0, 16, 3)},
    "drain+burst": {0: [0, 1, 2, 3, 4], 20: [5, 6, 7, 8, 9, 10]},
}


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(TRACES))
def test_harvest_order_matches_reference(name, depth):
    want = _harvest_trace(JDispatchWindow, JEmission, JScheduler,
                          JServeRequest, TRACES[name], depth)
    got = _harvest_trace(DispatchWindow, Emission, Scheduler, ServeRequest,
                         TRACES[name], depth)
    assert got == want
    assert sorted(rid for _, rid in got) == sorted(
        rid for rids in TRACES[name].values() for rid in rids)


@pytest.fixture(scope="module")
def cpu_detector():
    imgs = launch.make_images(4, 0, size=64)
    params, art = yolo.build_detector(0, imgs[:1].astype(np.float32) / 256.0,
                                      device="cpu")
    return params, art, imgs


def test_backend_depth2_payloads_equal_depth1(cpu_detector):
    params, art, imgs = cpu_detector
    backend = DetectionBackend(art, slots=2, device="cpu")
    assert backend.buckets == (64,)
    single, s1 = launch.serve(backend.spawn(depth=1), imgs)
    double, s2 = launch.serve(backend.spawn(depth=2), imgs)
    launch.check_bit_exact(double, single, "depth=2")
    assert s1["requests_completed"] == s2["requests_completed"] == 4
    assert s2["ticks"] == s1["ticks"] + 1           # the drain tick
    # the static payload accounting matches what one dispatch carries
    payload = single[0]
    per_image = sum(np.asarray(payload[k]).nbytes
                    for k in ("raw", "boxes", "scores", "classes"))
    assert s1["host_sync_bytes_per_sync"] == 2 * per_image
    assert payload["raw"].shape == (2, 2, 75)
    launch.check_alignment(params, imgs, single, "cpu")
    nms = DetectionBackend(art, slots=2, depth=2, device="cpu",
                           device_nms=True)
    compact, _ = launch.serve(nms, imgs)
    launch.check_nms_wire(compact, single)
