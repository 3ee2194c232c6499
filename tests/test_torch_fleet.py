"""Port parity, fleet tier: `Router`, `ModelBackend`, `Autoscaler` and
`FleetMetrics` against the reference's on the same scenarios and seeded
traces, and the traffic harness's replay, traces and gate (CPU).

The fleet is pure Python over the `Scheduler`: every schedule is a
function of the requests, so results are compared exactly, in order,
except the wall-clock fields of the per-replica summaries (tick times,
rates) and ``replay_seconds``.
"""
import json
import math
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import traffic as jtraffic  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve import fleet as jfleet  # noqa: E402
from repro.serve.scheduler import Scheduler as JScheduler  # noqa: E402
from repro_torch.launch import traffic  # noqa: E402
from repro_torch.serve import api, fleet  # noqa: E402
from repro_torch.serve.scheduler import Scheduler  # noqa: E402

from test_fleet import (ScriptedScaler, _random_fleet_trace,  # noqa: E402
                        reference_fleet_trace)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = types.SimpleNamespace(
    Router=jfleet.Router, ModelBackend=jfleet.ModelBackend,
    Autoscaler=jfleet.Autoscaler, AutoscalerConfig=jfleet.AutoscalerConfig,
    FleetMetrics=jfleet.FleetMetrics, Scheduler=JScheduler,
    ServeRequest=japi.ServeRequest, ServeResult=japi.ServeResult,
    SamplingParams=japi.SamplingParams)
PORT = types.SimpleNamespace(
    Router=fleet.Router, ModelBackend=fleet.ModelBackend,
    Autoscaler=fleet.Autoscaler, AutoscalerConfig=fleet.AutoscalerConfig,
    FleetMetrics=fleet.FleetMetrics, Scheduler=Scheduler,
    ServeRequest=api.ServeRequest, ServeResult=api.ServeResult,
    SamplingParams=api.SamplingParams)
# EngineMetrics.summary fields read from wall-clock tick times
WALL = ("wall_s", "tok_per_s", "img_per_s", "tick_p50_ms", "tick_p95_ms")
# the reference's committed serve record gives its calibration: width 2,
# depth 2, 2-tick service, a 143 ms tick, so --slo-ms 5000 is 35 ticks
REF_SERVE_BENCH = ROOT / "benchmarks" / "results" / "BENCH_serve.json"


def _req(pkg, rid, dl=None, prio=0, cd=None):
    return pkg.ServeRequest(rid=rid, sampling=pkg.SamplingParams(),
                            deadline_ticks=dl, priority=prio,
                            completion_deadline_ticks=cd)


def _results(results):
    return [(r.rid, r.finish_reason, r.n_ticks, r.wait_ticks, r.deadline_met)
            for r in results]


def _engine(summaries):
    return {rid: {k: v for k, v in s.items() if k not in WALL}
            for rid, s in summaries.items()}


def _router_state(router):
    return {"results": _results(router.results),
            "summary": router.metrics.summary(),
            "engines": _engine(router.engine_summaries()),
            "live": sorted(r.rid for r in router.live()),
            "retired": sorted(router.retired)}


def _drain(sched, guard=1000):
    while sched.queue or sched.active:
        sched.tick()
        guard -= 1
        assert guard > 0, "failed to drain"


# ---------------------------------------------------------------------------
# (a) tests/test_fleet.py's scenarios, each through both packages
# ---------------------------------------------------------------------------

def least_depth_slack_tiebreak(pkg):
    router = pkg.Router(lambda: pkg.ModelBackend(1, 5), replicas=2,
                        keep_results=True)
    router.submit(_req(pkg, 0, dl=2))
    router.submit(_req(pkg, 1, dl=9))
    depths = [[r.sched.queued for r in router.replicas.values()]]
    router.submit(_req(pkg, 2))
    depths.append([r.sched.queued for r in router.replicas.values()])
    assert depths == [[1, 1], [1, 2]]
    router.drain()
    return {"depths": depths, **_router_state(router)}


def drain_then_retire(pkg):
    router = pkg.Router(lambda: pkg.ModelBackend(1, 3), replicas=2,
                        autoscaler=ScriptedScaler({0: -1}),
                        keep_results=True)
    for rid in range(6):
        router.submit(_req(pkg, rid))
    router.drain()
    assert sorted(r.rid for r in router.results) == list(range(6))
    assert len(router.retired) == 1 and router.n_live == 1
    assert [e["action"] for e in router.metrics.scale_events] \
        == ["down", "retired"]
    return _router_state(router)


def last_live_replica(pkg):
    router = pkg.Router(lambda: pkg.ModelBackend(1, 1), replicas=1,
                        autoscaler=ScriptedScaler({0: -1, 1: -1}),
                        keep_results=True)
    router.submit(_req(pkg, 0))
    router.drain()
    for _ in range(3):
        router.tick()
    assert router.n_live == 1 and not router.metrics.scale_events
    return _router_state(router)


def scale_up_timeline(pkg):
    router = pkg.Router(lambda: pkg.ModelBackend(1, 2), replicas=1,
                        autoscaler=ScriptedScaler({1: +1}),
                        keep_results=True)
    for rid in range(8):
        router.submit(_req(pkg, rid))
        router.tick()
    router.drain()
    summary = router.metrics.summary()
    assert summary["replicas_max"] == 2 and summary["replicas_min"] == 1
    assert all(s["requests_completed"] > 0
               for s in router.engine_summaries().values())
    return _router_state(router)


def _stub_replica(depths, occs, capacity=2):
    return types.SimpleNamespace(metrics=types.SimpleNamespace(
        queue_depth=list(depths), occupancy=list(occs), tick_s=[0.0] * 8,
        capacity=capacity))


def watermarks_and_cooldowns(pkg):
    auto = pkg.Autoscaler(pkg.AutoscalerConfig(
        min_replicas=1, max_replicas=3, window=4, queue_high=2.0,
        occ_low=0.5, cooldown_up=5, cooldown_down=10))
    hot = [_stub_replica([9] * 8, [1.0] * 8)]
    idle = [_stub_replica([0] * 8, [0.0] * 8)] * 2
    calls = [(0, [_stub_replica([99] * 2, [1.0] * 2)]), (10, hot), (12, hot),
             (15, hot), (30, [_stub_replica([9] * 8, [1.0] * 8)] * 3),
             (20, idle), (25, idle),
             (50, [_stub_replica([0] * 8, [0.0] * 8)]),
             (80, [_stub_replica([0] * 8, [1.0] * 8)] * 2)]
    decisions = [auto.decide(t, reps) for t, reps in calls]
    assert decisions == [0, +1, 0, +1, 0, 0, -1, 0, 0]
    return decisions


def completion_deadline_inflight(pkg):
    sched = pkg.Scheduler(pkg.ModelBackend(1, service_ticks=5))
    sched.submit(_req(pkg, 0, cd=3))
    sched.submit(_req(pkg, 1))
    _drain(sched)
    by = {r.rid: r for r in sched.results}
    assert by[0].finish_reason == "expired" and by[0].n_ticks == 3
    assert sched.metrics.expired_inflight == 1
    return _results(sched.results), _engine({0: sched.metrics.summary()})


def completion_deadline_hopeless(pkg):
    sched = pkg.Scheduler(pkg.ModelBackend(1, service_ticks=10))
    sched.submit(_req(pkg, 0))
    sched.submit(_req(pkg, 1, cd=3))
    _drain(sched)
    by = {r.rid: r for r in sched.results}
    assert by[1].finish_reason == "expired" and by[1].n_ticks == 0
    return _results(sched.results), _engine({0: sched.metrics.summary()})


def completion_deadline_boundary(pkg):
    sched = pkg.Scheduler(pkg.ModelBackend(1, service_ticks=3))
    sched.submit(_req(pkg, 0, cd=3))
    _drain(sched)
    assert sched.results[0].finish_reason == "ok"
    return _results(sched.results), _engine({0: sched.metrics.summary()})


def priority_order(pkg):
    sched = pkg.Scheduler(pkg.ModelBackend(1, service_ticks=1))
    for rid, prio, dl in ((0, 1, None), (1, 1, None), (2, 0, None),
                          (3, 0, 1)):
        sched.submit(_req(pkg, rid, prio=prio, dl=dl))
    _drain(sched)
    assert [r.rid for r in sched.results] == [3, 2, 0, 1]
    return _results(sched.results)


def starvation_bound(pkg):
    sched = pkg.Scheduler(pkg.ModelBackend(1, service_ticks=1))
    sched.submit(_req(pkg, 100, prio=1, cd=6))
    sched.submit(_req(pkg, 101, prio=1))
    for rid in range(10):
        sched.submit(_req(pkg, rid, prio=0))
        sched.tick()
    _drain(sched)
    by = {r.rid: r for r in sched.results}
    assert by[100].finish_reason == "expired" and by[100].n_ticks == 0
    assert by[101].finish_reason == "ok"
    return _results(sched.results)


def nan_free_summary(pkg):
    sched = pkg.Scheduler(pkg.ModelBackend(1, service_ticks=1), max_queue=0)
    accepted = [sched.submit(_req(pkg, rid)) for rid in range(4)]
    before = sched.metrics.summary()
    sched.tick()
    after = _engine({0: sched.metrics.summary()})[0]
    fm = pkg.FleetMetrics(slo_ticks=4)
    empty = fm.summary()
    for rid in range(3):
        fm.on_result(pkg.ServeResult(rid=rid, finish_reason="rejected"))
    rejected = fm.summary()
    for summary in (before, after, empty, rejected):
        for key, val in summary.items():
            assert not isinstance(val, float) or math.isfinite(val), key
    assert rejected["slo_attainment"] == 0.0
    return accepted, _engine({0: before})[0], after, empty, rejected


def drop_cause_classification(pkg):
    fm = pkg.FleetMetrics(slo_ticks=4)
    for kw in (dict(rid=0, finish_reason="ok", wait_ticks=1, n_ticks=2),
               dict(rid=1, finish_reason="ok", wait_ticks=9, n_ticks=2),
               dict(rid=2, finish_reason="rejected"),
               dict(rid=3, finish_reason="expired"),
               dict(rid=4, finish_reason="expired", n_ticks=2)):
        fm.on_result(pkg.ServeResult(**kw))
    summary = fm.summary()
    assert summary["drops_by_cause"] == {"rejected": 1,
                                         "expired_admission": 1,
                                         "expired_inflight": 1}
    assert summary["slo_attainment"] == 1 / 5 and fm.lost == 0
    return summary


SCENARIOS = (least_depth_slack_tiebreak, drain_then_retire,
             last_live_replica, scale_up_timeline, watermarks_and_cooldowns,
             completion_deadline_inflight, completion_deadline_hopeless,
             completion_deadline_boundary, priority_order, starvation_bound,
             nan_free_summary, drop_cause_classification)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_fleet_scenario_matches_reference(scenario):
    assert scenario(PORT) == scenario(REF)


# ---------------------------------------------------------------------------
# (b) the seeded random traces of tests/test_fleet.py
# ---------------------------------------------------------------------------

def _trace_run(pkg, n_replicas, width, service, trace, max_queue, script):
    router = pkg.Router(lambda: pkg.ModelBackend(width, service),
                        replicas=n_replicas, max_queue=max_queue,
                        autoscaler=ScriptedScaler(script),
                        metrics=pkg.FleetMetrics(slo_ticks=6),
                        keep_results=True)
    for idle, burst in trace:
        for _ in range(idle):
            router.tick()
        for rid, dl, prio in burst:
            router.submit(_req(pkg, rid, dl=dl, prio=prio))
    router.drain(guard=10_000)
    every = [r.sched for r in router.replicas.values()]
    assert all(not s.queued and not s.active
               for s in every + list(router.retired.values()))
    return _router_state(router)


def test_fleet_random_traces_match_reference():
    """The 40 seeded traces (deadlines, priorities, bounded queues,
    scripted scale events): the port's fleet gives the reference Router's
    results, summaries and replica timeline, and the fleet oracle's
    (rid, reason) stream."""
    for seed in range(40):
        n, w, s, trace, mq, script = _random_fleet_trace(
            np.random.default_rng(seed))
        got = _trace_run(PORT, n, w, s, trace, mq, script)
        want = _trace_run(REF, n, w, s, trace, mq, script)
        assert got == want, seed
        assert got["summary"]["requests_lost"] == 0
        oracle = reference_fleet_trace(n, w, s, trace, max_queue=mq,
                                       scale_script=script)
        assert [(rid, why) for rid, why, *_ in got["results"]] == oracle


# ---------------------------------------------------------------------------
# (c)–(e) the traffic harness
# ---------------------------------------------------------------------------

def _ref_cal():
    cal = jtraffic.calibrate(str(REF_SERVE_BENCH))
    assert (cal["width"], cal["service_ticks"], cal["depth"]) == (2, 2, 2)
    return cal


@pytest.mark.parametrize("kind", traffic.TRACES)
def test_replay_model_matches_reference(kind):
    """Each trace at 1, 2 and 4 replicas and autoscaled 1→4, some 2000
    requests a cell at the reference's calibration: every field but the
    replay's wall seconds equal."""
    cal = _ref_cal()
    slo = traffic.slo_ticks_of(cal, 5000.0)
    assert slo == max(int(round(5000.0 / cal["tick_ms"])), 4) == 35
    cells = [(n, False, 4) for n in traffic.FIXED_REPLICAS] + [(1, True, 4)]
    for n, auto, top in cells:
        kw = dict(n_requests=2000, seed=0, cal=cal, slo_ticks=slo,
                  autoscale=auto, max_replicas=top)
        got = traffic.replay_model(kind, n, **kw)
        want = jtraffic.replay_model(kind, n, **kw)
        got.pop("replay_seconds")
        want.pop("replay_seconds")
        assert got == want, (kind, n, auto)
        assert got["requests_lost"] == 0


@pytest.mark.parametrize("kind", traffic.TRACES)
def test_gen_trace_arrivals_match_reference(kind):
    for ref_rate in (2.0, 8.0):
        got = traffic.gen_trace(kind, 5000, ref_rate,
                                np.random.default_rng([3, 1]))
        want = jtraffic.gen_trace(kind, 5000, ref_rate,
                                  np.random.default_rng([3, 1]))
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="unknown trace"):
        traffic.gen_trace("spiky", 10, 1.0, np.random.default_rng(0))


def test_gate_fails_on_attainment_drop_and_lost_request():
    committed = {"steady": {"replicas_2": {"slo_attainment": 0.9}}}

    def record(attainment, lost=0):
        return {"steady": {"replicas_2": {"slo_attainment": attainment,
                                          "requests_lost": lost}}}
    traffic._gate(committed, record(0.9 * 0.95))       # at the floor
    traffic._gate({}, record(0.1))                     # nothing committed
    with pytest.raises(AssertionError, match="attainment"):
        traffic._gate(committed, record(0.9 * 0.95 - 1e-6))
    with pytest.raises(AssertionError, match="lost"):
        traffic._gate(committed, record(1.0, lost=1))
    with pytest.raises(AssertionError, match="lost"):
        traffic._gate({}, record(1.0, lost=1))


def test_calibrate_reads_the_detect_record(tmp_path):
    path = tmp_path / "serve.json"
    assert traffic.calibrate(str(path))["tick_ms"] == 200.0   # no record
    path.write_text(json.dumps({"detect": {
        "slots": 4, "tick_p50_ms": 0.5, "depth": 2,
        "device": "NVIDIA H100 80GB HBM3, 700.00 W"}}))
    cal = traffic.calibrate(str(path))
    assert (cal["width"], cal["tick_ms"], cal["depth"]) == (4, 0.5, 2)
    assert cal["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert traffic.slo_ticks_of(cal, 5000.0) == 10000


def test_committed_fleet_record_passes_its_gate():
    """One cell of the committed fleet record, replayed at its own
    calibration on the CPU: the replay is a function of the trace, so the
    gate holds and the cell comes out equal, but for wall seconds."""
    committed = json.loads(pathlib.Path(traffic.DEFAULT_OUT).read_text())
    model = committed["model"]
    cfg = model["config"]
    assert cfg["card"] and "H100" in cfg["card"]
    assert "H100" in committed["real"]["device"]
    cal = {k: cfg[k] for k in ("width", "tick_ms", "service_ticks", "depth")}
    assert cfg["slo_ticks"] == traffic.slo_ticks_of(cal, cfg["slo_ms"])
    cell = traffic.replay_model("steady", 2,
                                n_requests=cfg["requests_per_cell"],
                                seed=cfg["seed"], cal=cal,
                                slo_ticks=cfg["slo_ticks"])
    traffic._gate(model, {"steady": {"replicas_2": cell}})
    want = dict(model["steady"]["replicas_2"])
    for rec in (cell, want):
        rec.pop("replay_seconds")
    assert cell == want
