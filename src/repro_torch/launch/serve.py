"""Serving launcher: ``python -m repro_torch.launch.serve --workload
{detect,multires,lm,compose}``.

The detection workloads build the detector from a numpy seed and serve
random uint8 images through the `Scheduler` and `DetectionBackend` under
``--profile`` ("tuned": the port's autotune table, popcount layers
included; "default": the dot kernels on the unfused pool route).

  lm       — continuous-batched decode of an LM arch (``--arch``, default
             granite-20b as the reference's; ``--reduced`` for its small
             variant) from a seeded random init through `LMBackend`.
             ``--packed`` deploys 1-bit W1A8 weights (`deploy_lm`) and
             decodes with them: every projection is one launch of the
             popcount matmul. A warm pass, then the host-checked path and
             the device done-mask path over the same request stream, whose
             tokens must be equal. The record is the done-mask run's, with
             the host-checked one under ``baseline_host_check``, and
             ``kernel_launches_per_decode_step`` by kernel.

  detect   — one bucket (``--buckets``, default 320). The raw-head wire at
             depth 1 and at ``--depth``, and the device-NMS wire over the
             depth sweep K ∈ {1, 2, 4, 8, --depth}, each K's completions in
             dispatch order and its payloads bit-exact with K = 1; the
             headline record is the ``--depth`` run, the curve sits under
             ``depth_sweep``. ``--burst 4x`` makes the stream at least
             4 × slots requests, all submitted at once, and checks zero
             drops and at most one host sync a tick. ``--replicas N`` (and
             ``--autoscale``, N to 2N replicas) also routes the same stream
             through a fleet `Router` of N ``spawn(depth=--depth)``
             replicas of the device-NMS backend, sharing its CUDA graph:
             nothing lost or dropped, the same completed ids, payloads bit
             for bit those of the single-scheduler run; the fleet's
             `FleetMetrics.summary()` goes under ``fleet``.
  multires — ``--buckets`` (default 256,320) in round robin through ONE
             scheduler, one CUDA graph per bucket sharing the packed
             weights. Each bucket's raw heads must equal, bit for bit, the
             same bucket's requests served alone; the device-NMS wire then
             gives a per-bucket saturation curve over K ∈ {1, 2, 4, 8}.
  compose  — the detect→LM pipeline (`serve.compose`): the device-NMS
             `DetectionBackend` at ``--buckets`` (default 320) feeds an
             `LMBackend` serving ``--arch`` in float mode from a seeded
             init (seed + 1); each detection templates into a prompt and
             re-admits to the LM on the same tick loop. Checks nothing lost
             or duplicated, every result finished by length or stop, every
             prompt the template of its detections, one hand-off a request.

The detection workloads check:

  * every request completes and none is dropped;
  * depth-K payloads are bit-exact with depth 1, on both wires;
  * the device-NMS detection set equals the raw-wire set;
  * the served raw head lies within the `core.verify` envelope
    (max_abs < 0.02, within_1lsb == 1 at lsb 0.02) of the float forward.

On the card every dispatch is one CUDA graph replay per bucket and wire
(`DetectionBackend`). The record carries each bucket's resolved configs
and, for detect, the kernel launches of the raw-wire depth-K serve and its
dispatch count (and of the fleet run, summed over its replicas), and the
card's name and power limit. Prints one JSON summary line. ``--out
[PATH]`` also writes the record into a JSON file, merged under the
workload's key (default path: ``results/BENCH_serve_cuda.json`` in this
package, the record `launch.traffic` calibrates from).

Not ported: the reference's ``--gate-bench``, which fails one run whose
img/s falls below the committed record × 0.95. On the card, launcher runs
of one commit spread by 28–35% in img/s, so a gate on one run would fire
on noise; a gate on the median of several runs belongs to a benchmark
harness.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

import numpy as np
import torch

from repro_torch.core import verify
from repro_torch.device import resolve_device
from repro_torch.kernels.w1a8_conv import fused_pool
from repro_torch.kernels.w1a8_conv import ops as conv_ops
from repro_torch.kernels.w1a8_int import ops as int_ops
from repro_torch.kernels.w1a8_matmul import ops as mm_ops
from repro_torch.models import detection, yolo
from repro_torch import configs
from repro_torch.models.transformer import init_lm_params
from repro_torch.serve import (Autoscaler, AutoscalerConfig,
                               ComposePipeline, ComposeRequest,
                               DetectionBackend, FleetMetrics, LMBackend,
                               Router, SamplingParams, Scheduler,
                               ServeRequest, deploy_lm,
                               detections_to_prompt, packed_param_bytes)

DEFAULT_OUT = str(pathlib.Path(__file__).resolve().parents[1] / "results"
                  / "BENCH_serve_cuda.json")

# Every CUDA kernel entry point of the port, by name: each counts its own
# launches, through graph replays too. A dispatch runs, per W1A8 layer, the
# kernel of its resolved config (`DetectionBackend.configs`), and the
# post-processing kernel (`detect_postprocess`); `w1a8_matmul_int` and
# `detect_nms` (the same kernel on decoded boxes) are called directly, and
# the integer PE (`w1a8_int_pe`) runs the integer forward, one launch a
# layer (`yolo.yolo_forward_int`).
KERNELS = {"w1a8_conv3x3_pool2": fused_pool.KERNEL,
           "w1a8_conv3x3": conv_ops.KERNEL, "w1a8_matmul": mm_ops.KERNEL,
           "w1a8_conv3x3_pool2_popcount": fused_pool.POPCOUNT_KERNEL,
           "w1a8_conv3x3_popcount": conv_ops.POPCOUNT_KERNEL,
           "w1a8_matmul_popcount": mm_ops.POPCOUNT_KERNEL,
           "w1a8_matmul_int": mm_ops.INT_KERNEL,
           "detect_nms": detection.NMS_KERNEL,
           "detect_postprocess": detection.POSTPROCESS_KERNEL,
           "w1a8_int_pe": int_ops.KERNEL}


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def make_images(n: int, seed: int, size: int = yolo.INPUT_SIZE) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, size, size, 3), np.uint8)


def serve(backend, images, rids=None, *, ordered: bool = True) -> tuple:
    """Requests ``rids`` (default all) of ``images`` through one Scheduler,
    submitted at once; (results by rid, summary). Raises unless every
    request completed, none dropped, and (``ordered``) in dispatch
    order."""
    rids = list(range(len(images)) if rids is None else rids)
    sched = Scheduler(backend, max_queue=max(len(rids), 1))
    results = sched.run([ServeRequest(rid=i, image=images[i]) for i in rids])
    summary = sched.metrics.summary()
    if summary["requests_dropped"] or summary["requests_completed"] != len(
            rids) or sorted(r.rid for r in results) != sorted(rids):
        raise AssertionError(f"requests dropped: {summary}")
    if ordered and [r.rid for r in results] != rids:
        raise AssertionError("completions left dispatch order")
    return {r.rid: r.detections for r in results}, summary


def _parse_burst(burst: str, slots: int) -> int:
    """'4x' → 4·slots requests submitted as one burst; '' → none."""
    if not burst:
        return 0
    mult = burst[:-1] if burst.endswith(("x", "X")) else burst
    return int(mult) * slots


def check_bit_exact(got: dict, want: dict, what: str) -> None:
    for rid, payload in want.items():
        for field, value in payload.items():
            if not np.array_equal(np.asarray(got[rid][field]),
                                  np.asarray(value)):
                raise AssertionError(f"{what}: rid {rid} field {field!r} "
                                     f"diverged")


def check_nms_wire(device_nms: dict, raw_wire: dict) -> None:
    """The compact fp16/int8 wire carries the raw wire's detection set."""
    for rid, d in device_nms.items():
        got = detection.detections_to_list(d["boxes"], d["scores"],
                                           d["classes"])
        ref = detection.detections_to_list(raw_wire[rid]["boxes"],
                                           raw_wire[rid]["scores"],
                                           raw_wire[rid]["classes"])
        if not len(got) == len(ref) == d["valid"]:
            raise AssertionError(f"rid {rid}: {len(got)} device-NMS "
                                 f"detections vs {len(ref)} raw-wire")
        for g in got:
            for j, e in enumerate(ref):
                iou = float(detection.iou_cxcywh(
                    torch.tensor(g["box_cxcywh"]),
                    torch.tensor(e["box_cxcywh"])))
                if (g["class_id"] == e["class_id"] and iou > 0.9
                        and abs(g["score"] - e["score"]) < 0.01):
                    ref.pop(j)
                    break
            else:
                raise AssertionError(f"rid {rid}: device-NMS detection "
                                     f"unmatched: {g}")


def check_alignment(params: dict, images, raw_wire: dict, device,
                    rids=None) -> verify.AlignmentReport:
    """Served raw heads of ``rids`` (default all; one image size) vs the
    float forward, paper §6.3 statistics."""
    rids = list(range(len(images)) if rids is None else rids)
    chunks = []
    for i in range(0, len(rids), 64):            # bounds the float forward
        batch = np.stack([images[r] for r in rids[i:i + 64]])
        imgs = torch.from_numpy(batch).to(device).to(torch.float32) / 256.0
        with torch.no_grad():
            chunks.append(yolo.yolo_forward_float(params, imgs).cpu().numpy())
    ref = np.concatenate(chunks)
    got = np.stack([raw_wire[r]["raw"] for r in rids])
    rep = verify.compare("serve_detect_raw", got, ref, lsb=0.02)
    if not (rep.max_abs < 0.02 and rep.within_1lsb == 1.0):
        raise AssertionError(f"raw head outside the envelope: {rep.row()}")
    return rep


def card_name(dev) -> str:
    """The card's name and power limit, as nvidia-smi gives them ("cpu"
    on the CPU)."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, check=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)


def _configs(backend) -> dict:
    """Each bucket's resolved configs, in layer order, as dicts."""
    return {str(b): [c.to_dict() for c in backend.configs(b)]
            for b in backend.buckets}


SWEEP_KEYS = ("img_per_s", "tick_p50_ms", "tick_p95_ms", "ticks", "wall_s",
              "host_syncs_per_tick", "batch_occupancy")


def depth_sweep(backend, images, depths, rids=None) -> tuple:
    """``images`` through ``backend.spawn(depth=K)`` for each K, each run
    in dispatch order and bit-exact with the first K's;
    (payloads by K, summaries by K)."""
    payloads, summaries = {}, {}
    for k in depths:
        payloads[k], summaries[k] = serve(backend.spawn(depth=k), images,
                                          rids)
        check_bit_exact(payloads[k], payloads[depths[0]],
                        f"depth={k} vs depth={depths[0]}")
    return payloads, summaries


def _alignment(rep: verify.AlignmentReport) -> dict:
    return {"max_abs": rep.max_abs, "mean_abs": rep.mean_abs,
            "within_1lsb": rep.within_1lsb}


def run_detect(args) -> dict:
    dev = resolve_device(args.device)
    size = _buckets(args, "320")[0]
    burst = _parse_burst(args.burst, args.slots)
    n_req = max(args.requests, burst)
    imgs_u8 = make_images(n_req, args.seed, size)
    params, art = yolo.build_detector(
        args.seed, imgs_u8[:1].astype(np.float32) / 256.0, device=dev)
    kw = dict(slots=args.slots, depth=1, profile=args.profile, device=dev)
    raw_t = DetectionBackend(art, **kw)
    dn_t = DetectionBackend(art, device_nms=True, **kw)
    raw_t.warmup()
    dn_t.warmup()
    raw_1, _ = serve(raw_t.spawn(depth=1), imgs_u8)
    counted = raw_t.spawn(depth=args.depth)
    before = launch_counts()
    raw_k, raw_summary = serve(counted, imgs_u8)
    launches = {k: n - before[k] for k, n in launch_counts().items()}
    check_bit_exact(raw_k, raw_1, f"raw wire depth={args.depth}")
    depths = sorted({1, 2, 4, 8, args.depth})
    dn, summaries = depth_sweep(dn_t, imgs_u8, depths)
    summary = summaries[args.depth]
    check_nms_wire(dn[args.depth], raw_1)
    rep = check_alignment(params, imgs_u8, raw_1, dev)
    if burst and summary["host_syncs_per_tick"] > 1.0:
        raise AssertionError(f"burst: {summary['host_syncs_per_tick']} "
                             f"host syncs a tick")
    fleet = None
    if args.replicas > 1 or args.autoscale:
        fleet = serve_fleet(dn_t.spawn(depth=args.depth), imgs_u8,
                            dn[args.depth], args.replicas, args.autoscale)
    return {
        "workload": "detect", "device": card_name(dev),
        "profile": args.profile,
        "bucket": size, "slots": args.slots, "depth": args.depth,
        "requests": n_req, "burst": args.burst or None,
        "nms": "device", "wire": "fp16 boxes+scores, int8 classes, "
                                 "int32 valid",
        "checks": ["zero drops", "depth-K bit-exact with depth 1, completions "
                   "in dispatch order", "device-NMS set equals raw-wire set",
                   "raw head within verify envelope"]
        + (["at most one host sync a tick"] if burst else []),
        "alignment": _alignment(rep),
        "configs": _configs(raw_t),
        **{k: summary[k] for k in ("img_per_s", "wall_s", "ticks",
                                   "tick_p50_ms", "tick_p95_ms",
                                   "host_syncs_per_tick", "queue_depth_max",
                                   "host_sync_bytes_per_sync")},
        "depth_sweep": {str(k): {key: summaries[k][key] for key in SWEEP_KEYS}
                        for k in depths},
        "raw_wire": {k: raw_summary[k] for k in
                     ("img_per_s", "wall_s", "tick_p50_ms", "tick_p95_ms",
                      "host_sync_bytes_per_sync")},
        "raw_wire_dispatches": counted.host_syncs,
        "raw_wire_launches": launches,
        **({"fleet": fleet} if fleet else {}),
    }


def serve_fleet(template, images, want: dict, replicas: int,
                autoscale: bool) -> dict:
    """``images`` through a `Router` of ``replicas`` ``template.spawn``
    replicas (an `Autoscaler` from ``replicas`` to twice as many with
    ``autoscale``), all submitted at once: nothing lost or dropped, the
    completed ids and every payload bit for bit those of ``want``. Returns
    the fleet's summary with its dispatches, summed over its replicas, and
    the kernel launches they made."""
    scaler = None
    if autoscale:
        scaler = Autoscaler(AutoscalerConfig(min_replicas=replicas,
                                             max_replicas=2 * replicas))
    router = Router(template.spawn, replicas=replicas, autoscaler=scaler,
                    metrics=FleetMetrics(), keep_results=True)
    before = launch_counts()
    results = router.run([ServeRequest(rid=i, image=images[i])
                          for i in range(len(images))])
    launches = {k: n - before[k] for k, n in launch_counts().items()}
    if router.metrics.lost or router.metrics.dropped:
        raise AssertionError(f"fleet lost or dropped requests: "
                             f"{router.metrics.summary()}")
    got = {r.rid: r.detections for r in results}
    if sorted(got) != sorted(want):
        raise AssertionError("the fleet completed another request-id set "
                             "than the single scheduler")
    check_bit_exact(got, want, "fleet vs single scheduler")
    return {"replicas": replicas, "autoscale": bool(autoscale),
            "equivalence": "completed-id sets equal, payloads bit-exact "
                           "vs single-scheduler run",
            "dispatches": sum(s.backend.host_syncs
                              for s in router.schedulers()),
            "launches": launches,
            "replica_summaries": {str(k): {key: v[key] for key in (
                "requests_completed", "ticks", "img_per_s", "wall_s")}
                for k, v in router.engine_summaries().items()},
            **router.metrics.summary()}


def run_multires(args) -> dict:
    """Mixed sizes through one scheduler: per-bucket graphs sharing the
    packed weights, each bucket's raw heads bit-exact with the bucket
    served alone."""
    dev = resolve_device(args.device)
    buckets = _buckets(args, "256,320")
    if len(buckets) < 2:
        raise ValueError("--workload multires needs >= 2 --buckets")
    n_req = max(args.requests, len(buckets))
    rng = np.random.default_rng(args.seed)
    # round-robin bucket assignment: mixed-size traffic through one queue
    sizes = [buckets[i % len(buckets)] for i in range(n_req)]
    imgs = [rng.integers(0, 256, (s, s, 3), np.uint8) for s in sizes]
    params, art = yolo.build_detector(
        args.seed, imgs[0][None].astype(np.float32) / 256.0,
        buckets=buckets, device=dev)
    kw = dict(slots=args.slots, depth=args.depth, profile=args.profile,
              device=dev)
    raw_t = DetectionBackend(art, **kw)
    dn_t = DetectionBackend(art, device_nms=True, **kw)
    raw_t.warmup()                    # captures every bucket's graph
    dn_t.warmup()
    mixed, mixed_summary = serve(raw_t.spawn(), imgs, ordered=False)
    dn_mixed, summary = serve(dn_t.spawn(), imgs, ordered=False)
    by_bucket = {b: [i for i in range(n_req) if sizes[i] == b]
                 for b in buckets}
    saturation, alignment = {}, {}
    for b, rids in by_bucket.items():
        g = b // 32
        for r in rids:                # the grid follows the request's bucket
            if mixed[r]["raw"].shape != (g, g, 75):
                raise AssertionError(f"rid {r}: raw head "
                                     f"{mixed[r]['raw'].shape} at {b}")
        alone, _ = serve(raw_t.spawn(depth=1), imgs, rids)
        check_bit_exact({r: mixed[r] for r in rids}, alone,
                        f"bucket {b} mixed vs alone")
        dn, summaries = depth_sweep(dn_t, imgs, (1, 2, 4, 8), rids)
        check_bit_exact({r: dn_mixed[r] for r in rids}, dn[1],
                        f"bucket {b} device-NMS mixed vs alone")
        check_nms_wire(dn[1], alone)
        alignment[str(b)] = _alignment(check_alignment(params, imgs, alone,
                                                       dev, rids))
        saturation[str(b)] = {str(k): {key: summ[key] for key in SWEEP_KEYS}
                              for k, summ in summaries.items()}
    return {
        "workload": "multires", "device": card_name(dev),
        "profile": args.profile, "buckets": list(buckets),
        "slots": args.slots, "depth": args.depth, "requests": n_req,
        "requests_per_bucket": {str(b): len(r) for b, r in by_bucket.items()},
        "nms": "device",
        "checks": ["zero drops", "per-bucket raw heads bit-exact with the "
                   "bucket served alone", "depth-K bit-exact with depth 1, "
                   "completions in dispatch order", "device-NMS set equals "
                   "raw-wire set", "raw head within verify envelope"],
        "alignment": alignment,
        "configs": _configs(raw_t),
        **{k: summary[k] for k in ("img_per_s", "wall_s", "ticks",
                                   "tick_p50_ms", "tick_p95_ms")},
        "saturation": saturation,
        "raw_wire": {k: mixed_summary[k] for k in
                     ("img_per_s", "wall_s", "tick_p50_ms", "tick_p95_ms")},
    }


def lm_requests(n: int, sampling: SamplingParams) -> list:
    """The reference launcher's stream: prompt [2 + i, 11, 7 + i % 3]."""
    return [ServeRequest(rid=i, prompt=[2 + i, 11, 7 + i % 3],
                         sampling=sampling) for i in range(n)]


def run_lm(args, params=None) -> dict:
    """``params``: float params to serve in place of the seeded init
    (deployed first under ``--packed``)."""
    dev = resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        params = init_lm_params(cfg, gen, device=dev)
    mode, acct = "float", None
    if args.packed:
        params = deploy_lm(params)
        acct = packed_param_bytes(params)
        print(f"[packed] {acct['packed_bytes'] / 1e6:.1f} MB "
              f"(bf16-equivalent {acct['bf16_equivalent_bytes'] / 1e6:.1f} "
              f"MB, {acct['ratio']:.1f}x smaller)", flush=True)
        mode = "w1a8_eval"
    sp = SamplingParams(max_new=args.max_new, temperature=args.temperature,
                        stop_tokens=tuple(args.stop_token))

    def serve(done_mask: bool):
        backend = LMBackend(cfg, params, slots=args.slots,
                            max_len=args.max_len, mode=mode, seed=args.seed,
                            done_mask=done_mask, device=dev)
        # a warm pass on a throwaway scheduler, so both modes' numbers are
        # steady-state; it draws from the backend's generator in both
        # modes alike, so the measured tokens stay comparable
        Scheduler(backend).run(lm_requests(args.requests, sp))
        backend.decode_steps = 0
        backend.decode_launches.clear()
        sched = Scheduler(backend)
        results = sched.run(lm_requests(args.requests, sp))
        summary = sched.metrics.summary()
        summary["kernel_launches_per_decode_step"] = {
            k: n / backend.decode_steps
            for k, n in backend.decode_launches.items()}
        summary["decode_steps"] = backend.decode_steps
        return results, summary

    host_results, host_summary = serve(done_mask=False)
    dm_results, summary = serve(done_mask=True)
    host_toks = {r.rid: r.tokens for r in host_results}
    dm_toks = {r.rid: r.tokens for r in dm_results}
    if dm_toks != host_toks:
        raise AssertionError("done-mask decode diverged from host check")
    print(f"served {len(dm_results)} requests, {summary['tokens']} tokens in "
          f"{summary['wall_s']:.2f}s ({summary['tok_per_s']:.1f} tok/s, "
          f"p50 tick {summary['tick_p50_ms']:.1f} ms, "
          f"occupancy {summary['batch_occupancy']:.2f}); "
          f"per-tick sync {summary['host_sync_bytes_per_tick']:.0f} B "
          f"done-mask vs {host_summary['host_sync_bytes_per_tick']:.0f} B "
          f"token-row host-checked", flush=True)
    return {"workload": "lm", "device": card_name(dev), "arch": args.arch,
            "reduced": args.reduced, "packed": args.packed,
            "packed_bytes": acct, "slots": args.slots,
            "max_new": args.max_new, "max_len": args.max_len,
            "requests": args.requests,
            "termination": "device_done_mask",
            "sync_wire": "per-slot bool bitmask/tick + bulk tokens at "
                         "finish",
            "checks": ["done-mask tokens equal host-checked tokens"],
            "tokens_by_rid": {str(r): t for r, t in sorted(dm_toks.items())},
            **summary,
            "baseline_host_check": {
                "termination": "host_token_check",
                "sync_wire": "token row/tick", **host_summary}}


def run_compose(args, params=None) -> dict:
    """Detect→LM on one tick loop, nothing lost or duplicated. ``params``:
    float LM params to serve in place of the seeded init."""
    dev = resolve_device(args.device)
    n_req = args.requests
    bucket = _buckets(args, "320")[0]
    imgs = make_images(n_req, args.seed, bucket)
    _, art = yolo.build_detector(
        args.seed, imgs[:1].astype(np.float32) / 256.0, buckets=(bucket,),
        device=dev)
    detect = DetectionBackend(art, slots=args.slots, depth=args.depth,
                              profile=args.profile, device_nms=True,
                              device=dev)
    detect.warmup()
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 1)
        params = init_lm_params(cfg, gen, device=dev)
    lm = LMBackend(cfg, params, slots=args.slots, max_len=args.max_len,
                   seed=args.seed, device=dev)
    sp = SamplingParams(max_new=args.max_new, temperature=args.temperature,
                        stop_tokens=tuple(args.stop_token))
    pipe = ComposePipeline(detect, lm, vocab=cfg.vocab_size)
    before = launch_counts()
    t0 = time.perf_counter()
    results = pipe.run([ComposeRequest(rid=i, image=imgs[i], sampling=sp)
                        for i in range(n_req)])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {k: n - before[k] for k, n in launch_counts().items()}
    summary = pipe.summary()
    counts = {k: summary[k] for k in ("submitted", "completed", "lost",
                                      "duplicated", "handoffs", "ticks")}
    if counts["lost"] or counts["duplicated"] or len(results) != n_req:
        raise AssertionError(f"compose lost or duplicated requests: "
                             f"{counts}")
    for r in results:
        if r.finish_reason not in ("length", "stop") or not r.tokens:
            raise AssertionError(f"rid {r.rid}: {r.finish_reason}, "
                                 f"{len(r.tokens)} tokens")
        if r.prompt != detections_to_prompt(r.detections,
                                            vocab=cfg.vocab_size):
            raise AssertionError(f"rid {r.rid}: the prompt is not the "
                                 f"template of its detections")
    if len(pipe.handoffs) != n_req or any(h.kind != "compose"
                                          for h in pipe.handoffs):
        raise AssertionError(f"{len(pipe.handoffs)} hand-offs for {n_req} "
                             f"requests")
    print(f"[compose] {n_req} detect→LM requests in {summary['ticks']} "
          f"ticks, {wall:.2f} s: 0 lost, 0 duplicated; prompts "
          f"{[list(r.prompt) for r in results[:3]]}...", flush=True)
    return {"workload": "compose", "device": card_name(dev),
            "arch": args.arch, "reduced": args.reduced, "mode": "float",
            "profile": args.profile, "bucket": bucket, "slots": args.slots,
            "depth": args.depth, "requests": n_req,
            "max_new": args.max_new, "max_len": args.max_len,
            "prompt_template": "describe-token, count-token, class tokens",
            "checks": ["0 lost, 0 duplicated", "every result length or "
                       "stop", "prompt equals detections_to_prompt",
                       "one compose hand-off a request"],
            **counts, "wall_s": wall,
            "detect_dispatches": detect.host_syncs,
            "launches": launches,
            "configs": _configs(detect),
            "prompts_by_rid": {str(r.rid): list(r.prompt) for r in results},
            "tokens_by_rid": {str(r.rid): r.tokens for r in results},
            "detect": summary["detect"], "lm": summary["lm"]}


def write_record(path: str, workload: str, record: dict) -> None:
    """Merges ``record`` into the JSON file at ``path`` under
    ``workload``."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    data = {}
    if p.exists():
        try:
            data = json.loads(p.read_text())
        except json.JSONDecodeError:
            data = {}
    data[workload] = record
    p.write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")
    print(f"[bench] wrote {path} [{workload}]", flush=True)


def _buckets(args, default: str) -> tuple:
    return tuple(int(b) for b in (args.buckets or default).split(","))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload",
                    choices=("detect", "multires", "lm", "compose"),
                    default="detect")
    ap.add_argument("--profile", choices=yolo.PROFILES, default="tuned",
                    help="kernel configs: the autotune table's (tuned) or "
                         "the dot heuristic's (default)")
    ap.add_argument("--buckets", default="",
                    help="image sizes, multiples of 32 (detect, compose: "
                         "one, default 320; multires: >= 2, default "
                         "256,320)")
    ap.add_argument("--burst", default="",
                    help="detect: e.g. 4x submits >= 4·slots requests as "
                         "one burst; checks zero drops and <= 1 host sync "
                         "a tick")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="detect: also serve the stream through a fleet "
                         "Router of N replicas, payloads bit-exact with "
                         "the single scheduler's")
    ap.add_argument("--autoscale", action="store_true",
                    help="detect: attach an Autoscaler (--replicas to "
                         "2x --replicas) to the fleet run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out", nargs="?", const=DEFAULT_OUT, default=None,
                    help="also merge the record into this JSON file, "
                         "under the workload's key (bare --out: "
                         "results/BENCH_serve_cuda.json in the package)")
    lm = ap.add_argument_group("lm and compose workloads")
    lm.add_argument("--arch", default="granite-20b",
                    choices=configs.DENSE)
    lm.add_argument("--reduced", action="store_true",
                    help="the arch's small variant")
    lm.add_argument("--max-new", type=int, default=16)
    lm.add_argument("--max-len", type=int, default=128)
    lm.add_argument("--packed", action="store_true",
                    help="serve 1-bit W1A8 weights (deploy_lm)")
    lm.add_argument("--temperature", type=float, default=0.0)
    lm.add_argument("--stop-token", type=int, action="append", default=[])
    args = ap.parse_args(argv)
    run = {"detect": run_detect, "multires": run_multires,
           "lm": run_lm, "compose": run_compose}[args.workload]
    record = run(args)
    if args.out:
        write_record(args.out, args.workload, record)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
