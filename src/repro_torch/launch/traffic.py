"""Fleet traffic harness: ``python -m repro_torch.launch.traffic --mode
{model,real}``.

Replays seeded synthetic traffic through the fleet tier (`serve.fleet`:
Router → replica Schedulers → Autoscaler), two ways:

  model — the pure-Python replay: `ModelBackend` replicas whose step cost
          is calibrated from the serve record's detect entry
          (``--serve-bench``, written by ``launch.serve --out``: device
          batch width = ``slots``, wall cost a tick = ``tick_p50_ms``), so
          SLO accounting runs in scheduler ticks, the unit the real fleet
          shares, at millions of requests a few minutes. Sweeps steady,
          diurnal and burst traces at 1, 2 and 4 fixed replicas and one
          autoscaled (1→4) run a trace, and records attainment, drops by
          cause and the replica timeline under ``model`` in ``--out``.
          Every cell asserts that no request is lost (completed + every
          drop cause = submitted).
  real  — the same idea through real `DetectionBackend` replicas on the
          card (device-NMS wire, depth 2, one CUDA graph shared by every
          `spawn`): the same seeded stream through a 1-replica fleet and an
          N-replica fleet must complete the same request ids with payloads
          bit for bit equal, since routing and scale must never change what
          a request computes. Recorded under ``real``, with img/s of both.

The calibration and the SLO in ticks that follows from it are printed.
The card's tick is far shorter than the ``--slo-ms`` default assumes, so
the SLO is many thousand ticks there; the defaults stay the reference's.

Traces (Poisson arrivals a tick from ``np.random.default_rng([seed,
trace index])``; rates relative to a 2-replica fleet's capacity):
  steady   0.85× reference capacity, constant;
  diurnal  0.85× mean with a ±0.80× two-period sinusoid (trough ~0.05,
           peak ~1.65: overloads 2 replicas, fits 4);
  burst    0.60× base with a 1/400 chance a tick of a 25-tick 6× spike.

Request mix: 90% priority 0 (admission deadline 2×SLO, completion deadline
2×SLO), 10% priority 1 background (no admission deadline, completion
deadline 4×SLO). Attainment counts completions within ``slo_ticks`` end to
end over all submissions.

``--gate-bench`` reads the committed record at ``--out`` before it is
overwritten and fails when any model cell's attainment drops below
committed × 0.95 or a cell loses a request. The replay is deterministic
in ticks, so the gate holds the scheduler's semantics, not machine speed.

Records carry the card's name and power limit (the serve record's, for the
model replay). Default paths lie in the port's ``results/`` directory.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np

from repro_torch.device import card_name, resolve_device
from repro_torch.launch.serve import (check_bit_exact,
                                      launch_counts, write_record)
from repro_torch.models import yolo
from repro_torch.serve import (Autoscaler, AutoscalerConfig,
                               DetectionBackend, FleetMetrics, ModelBackend,
                               Router, SamplingParams, ServeRequest)

RESULTS = pathlib.Path(__file__).resolve().parents[1] / "results"
DEFAULT_OUT = str(RESULTS / "BENCH_fleet_cuda.json")
SERVE_BENCH = str(RESULTS / "BENCH_serve_cuda.json")
TRACES = ("steady", "diurnal", "burst")
FIXED_REPLICAS = (1, 2, 4)
REF_REPLICAS = 2          # trace rates are sized against this fleet


def calibrate(serve_bench: str) -> dict:
    """The replica's step-cost model from a serve record's detect entry.

    The detect record runs a K-deep dispatch window, so the model replica
    mirrors it: depth×width slots, width admissions a tick, 2-tick service;
    steady throughput is width requests a tick. Without a readable record
    the defaults (width 2, 200 ms, depth 2) stand."""
    width, tick_ms, depth, card = 2, 200.0, 2, None
    p = pathlib.Path(serve_bench)
    if p.exists():
        try:
            rec = json.loads(p.read_text()).get("detect", {})
            width = int(rec.get("slots", width))
            tick_ms = float(rec.get("tick_p50_ms", tick_ms))
            depth = max(int(rec.get("depth", depth)), 1)
            card = rec.get("device")
        except (json.JSONDecodeError, TypeError, ValueError):
            pass
    return {"width": width, "tick_ms": tick_ms, "service_ticks": 2,
            "depth": depth, "source": p.name, "card": card}


def gen_trace(kind: str, n_requests: int, ref_rate: float,
              rng: np.random.Generator) -> np.ndarray:
    """Arrival counts a tick; Σ ≈ n_requests."""
    if kind == "steady":
        mean = 0.85 * ref_rate
        ticks = max(int(round(n_requests / mean)), 1)
        rate = np.full(ticks, mean)
    elif kind == "diurnal":
        mean = 0.85 * ref_rate
        ticks = max(int(round(n_requests / mean)), 1)
        t = np.arange(ticks)
        rate = ref_rate * (0.85 + 0.80 * np.sin(2 * np.pi * 2 * t / ticks))
        rate = np.clip(rate, 0.05, None)
    elif kind == "burst":
        base, spike_p, spike_len, spike_mult = 0.60, 1 / 400, 25, 6.0
        mean = base * ref_rate * (1 + spike_p * spike_len * spike_mult)
        ticks = max(int(round(n_requests / mean)), 1)
        rate = np.full(ticks, base * ref_rate)
        starts = np.flatnonzero(rng.random(ticks) < spike_p)
        for s in starts:
            rate[s:s + spike_len] = spike_mult * base * ref_rate
    else:
        raise ValueError(f"unknown trace kind {kind!r}")
    return rng.poisson(rate).astype(np.int64)


def replay_model(kind: str, n_replicas: int, *, n_requests: int, seed: int,
                 cal: dict, slo_ticks: int, autoscale: bool = False,
                 max_replicas: int = 4) -> dict:
    width, service = cal["width"], cal["service_ticks"]
    depth = max(int(cal["depth"]), 1)
    # a replica's steady throughput: capacity / service ticks
    ref_rate = REF_REPLICAS * depth * width / service
    # Python's str hash is randomised per process: the seed must not use it
    rng = np.random.default_rng([seed, TRACES.index(kind)])
    arrivals = gen_trace(kind, n_requests, ref_rate, rng)
    total = int(arrivals.sum())
    background = rng.random(total) < 0.10

    scaler = None
    if autoscale:
        scaler = Autoscaler(AutoscalerConfig(
            min_replicas=n_replicas, max_replicas=max_replicas,
            window=8, queue_high=2.0, occ_low=0.35,
            cooldown_up=8, cooldown_down=48))
    metrics = FleetMetrics(slo_ticks=slo_ticks)
    # a queue bound under which waits can overrun the admission deadline,
    # so both expiry causes (not only rejection) show in the drops
    router = Router(lambda: ModelBackend(width, service, depth=depth),
                    replicas=n_replicas, max_queue=4 * width * slo_ticks,
                    autoscaler=scaler, metrics=metrics)
    sp = SamplingParams()              # shared: requests carry no LM state
    rid = 0
    t0 = time.perf_counter()
    for n_arr in arrivals:
        for _ in range(int(n_arr)):
            if background[rid]:
                req = ServeRequest(rid=rid, sampling=sp, priority=1,
                                   completion_deadline_ticks=4 * slo_ticks)
            else:
                req = ServeRequest(rid=rid, sampling=sp,
                                   deadline_ticks=2 * slo_ticks,
                                   completion_deadline_ticks=2 * slo_ticks)
            router.submit(req)
            rid += 1
        router.tick()
    router.drain()
    elapsed = time.perf_counter() - t0
    if rid != total or metrics.lost:
        raise AssertionError(f"{kind} x{n_replicas}: lost requests: "
                             f"{metrics.summary()}")
    summary = metrics.summary()
    n_events = len(summary.pop("scale_events"))
    return {"trace": kind, "replicas": n_replicas,
            "autoscale": bool(autoscale),
            "trace_ticks": int(len(arrivals)),
            "replay_seconds": round(elapsed, 3),
            "n_scale_events": n_events,
            "simulated_wall_s": round(summary["ticks"] * cal["tick_ms"]
                                      / 1e3, 1),
            **summary}


def slo_ticks_of(cal: dict, slo_ms: float) -> int:
    return max(int(round(slo_ms / cal["tick_ms"])), 4)


def run_model(args) -> dict:
    cal = calibrate(args.serve_bench)
    slo_ticks = slo_ticks_of(cal, args.slo_ms)
    print(f"[model] calibration {cal}: --slo-ms {args.slo_ms} is "
          f"{slo_ticks} ticks", flush=True)
    record = {"config": {**cal, "slo_ms": args.slo_ms,
                         "slo_ticks": slo_ticks,
                         "requests_per_cell": args.requests,
                         "seed": args.seed}}
    total = 0
    t0 = time.perf_counter()
    for kind in TRACES:
        cells = {}
        for n in FIXED_REPLICAS:
            cell = replay_model(kind, n, n_requests=args.requests,
                                seed=args.seed, cal=cal, slo_ticks=slo_ticks)
            cells[f"replicas_{n}"] = cell
            total += cell["requests_submitted"]
            print(f"[model] {kind:8s} x{n}: "
                  f"{cell['requests_submitted']} reqs, "
                  f"attainment {cell['slo_attainment']:.3f}, drops "
                  f"{cell['drops_by_cause']} ({cell['replay_seconds']}s)",
                  flush=True)
        cell = replay_model(kind, 1, n_requests=args.requests,
                            seed=args.seed, cal=cal, slo_ticks=slo_ticks,
                            autoscale=True, max_replicas=4)
        cells["autoscale_1to4"] = cell
        total += cell["requests_submitted"]
        print(f"[model] {kind:8s} auto(1→4): attainment "
              f"{cell['slo_attainment']:.3f}, replicas "
              f"{cell['replicas_min']}→{cell['replicas_max']} "
              f"({cell['n_scale_events']} scale events, "
              f"{cell['replay_seconds']}s)", flush=True)
        record[kind] = cells
    elapsed = time.perf_counter() - t0
    record["total_requests"] = total
    record["harness_seconds"] = round(elapsed, 1)
    print(f"[model] replayed {total} requests in {elapsed:.1f}s", flush=True)
    if args.max_seconds:
        # 10x the requests a cell: at the default 100000 the floor is 1e6
        # replayed requests, and it scales down for shorter runs
        floor = 10 * args.requests
        if total < floor:
            raise AssertionError(f"replayed only {total} requests (need >= "
                                 f"{floor})")
        if elapsed >= args.max_seconds:
            raise AssertionError(f"replay took {elapsed:.1f}s (budget "
                                 f"{args.max_seconds}s)")
    return record


# ---------------------------------------------------------------------------
# Real mode: a shorter stream through DetectionBackend replicas
# ---------------------------------------------------------------------------

def _image(seed: int, rid: int, size: int) -> np.ndarray:
    """A uint8 image for each rid, made when submitted, so a long stream
    never holds all its images."""
    rng = np.random.default_rng([seed, rid])
    return rng.integers(0, 256, (size, size, 3), np.uint8)


def _run_real_fleet(template, n_replicas: int, n_req: int, seed: int,
                    size: int) -> tuple:
    """``n_req`` requests through a Router of ``template.spawn`` replicas,
    keeping some 2 batches queued a replica; (payloads by rid, fleet
    summary, seconds, dispatches summed over the replicas)."""
    metrics = FleetMetrics()
    router = Router(template.spawn, replicas=n_replicas, keep_results=True,
                    metrics=metrics)
    width = template.admit_width
    rid = 0
    t0 = time.perf_counter()
    while rid < n_req or router.busy:
        while rid < n_req and router.total_queued() < 2 * n_replicas * width:
            router.submit(ServeRequest(rid=rid,
                                       image=_image(seed, rid, size)))
            rid += 1
        router.tick()
    elapsed = time.perf_counter() - t0
    if metrics.lost or metrics.dropped:
        raise AssertionError(f"requests lost or dropped: {metrics.summary()}")
    payloads = {r.rid: r.detections for r in router.results}
    if len(payloads) != n_req:
        raise AssertionError(f"{len(payloads)} of {n_req} requests completed")
    dispatches = sum(s.backend.host_syncs for s in router.schedulers())
    return payloads, metrics.summary(), elapsed, dispatches


def run_real(args) -> dict:
    dev = resolve_device(args.device)
    n_req, size = args.requests, args.bucket
    _, art = yolo.build_detector(
        args.seed, _image(args.seed, 0, size)[None].astype(np.float32)
        / 256.0, device=dev)
    template = DetectionBackend(art, slots=args.slots, depth=2,
                                device_nms=True, profile=args.profile,
                                device=dev)
    template.warmup()                  # one capture serves every spawn()

    before = launch_counts()
    single, single_summary, t1, d1 = _run_real_fleet(template, 1, n_req,
                                                     args.seed, size)
    fleet, fleet_summary, tn, dn = _run_real_fleet(template, args.replicas,
                                                   n_req, args.seed, size)
    launches = {k: n - before[k] for k, n in launch_counts().items()}
    if not set(fleet) == set(single) == set(range(n_req)):
        raise AssertionError("the fleet completed another request-id set "
                             "than one replica")
    check_bit_exact(fleet, single, f"{args.replicas}-replica fleet vs one")
    print(f"[real] {n_req} requests at {size}: 1-replica {n_req / t1:.2f} "
          f"img/s, {args.replicas}-replica {n_req / tn:.2f} img/s; "
          f"completed sets equal, payloads bit-exact", flush=True)
    return {"device": card_name(dev), "requests": n_req,
            "replicas": args.replicas, "slots": args.slots, "depth": 2,
            "bucket": size, "profile": args.profile,
            "equivalence": "completed-id sets equal, payloads bit-exact "
                           "vs 1-replica fleet",
            "img_per_s_single": n_req / t1,
            "img_per_s_fleet": n_req / tn,
            "dispatches_single": d1, "dispatches_fleet": dn,
            "launches": launches,
            "configs": [c.to_dict() for c in template.configs(size)],
            "fleet": fleet_summary, "single": single_summary}


# ---------------------------------------------------------------------------

def _gate(committed: dict, record: dict) -> None:
    """Fails when a model cell lost a request or its attainment fell below
    committed × 0.95."""
    for kind in TRACES:
        for cell_name, cell in record.get(kind, {}).items():
            if cell["requests_lost"]:
                raise AssertionError(f"{kind}/{cell_name}: "
                                     f"{cell['requests_lost']} lost")
            old = committed.get(kind, {}).get(cell_name, {})
            floor = old.get("slo_attainment")
            if floor is None:
                continue
            got = cell["slo_attainment"]
            if got < floor * 0.95 - 1e-12:
                raise AssertionError(f"{kind}/{cell_name}: attainment "
                                     f"{got:.4f} < committed {floor:.4f} "
                                     f"x 0.95")
            print(f"[gate] {kind}/{cell_name}: {got:.4f} >= "
                  f"{floor:.4f} x 0.95 OK")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("model", "real"), default="model")
    ap.add_argument("--requests", type=int, default=None,
                    help="model: requests a cell (default 100000, 12 "
                         "cells); real: total requests (default 2048)")
    ap.add_argument("--replicas", type=int, default=2,
                    help="fleet width for the real run")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--profile", choices=("tuned", "default"),
                    default="tuned")
    ap.add_argument("--bucket", type=int, default=320,
                    help="real: the image size")
    ap.add_argument("--slo-ms", type=float, default=5000.0,
                    help="end-to-end completion SLO (converted to ticks "
                         "by the calibrated tick cost)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="real: torch device (default: the card)")
    ap.add_argument("--serve-bench", default=SERVE_BENCH)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--max-seconds", type=float, default=0.0,
                    help="model: assert >= 10x --requests replayed under "
                         "this wall budget (0 = no assert)")
    ap.add_argument("--gate-bench", action="store_true",
                    help="model: fail when a cell loses requests or its "
                         "attainment < committed x 0.95")
    args = ap.parse_args(argv)
    if args.requests is None:
        args.requests = 100_000 if args.mode == "model" else 2048

    committed = {}
    if args.gate_bench:
        p = pathlib.Path(args.out)
        if p.exists():
            try:
                committed = json.loads(p.read_text()).get("model", {})
            except json.JSONDecodeError:
                committed = {}

    if args.mode == "model":
        record = run_model(args)
        if args.gate_bench:
            if committed:
                _gate(committed, record)
            else:
                print(f"[gate] no committed model record in {args.out}: "
                      f"this run records, the next enforces")
        write_record(args.out, "model", record)
    else:
        record = run_real(args)
        write_record(args.out, "real", record)
    return record


if __name__ == "__main__":
    main()
