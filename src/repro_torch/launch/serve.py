"""Serving launcher: ``python -m repro_torch.launch.serve --workload detect``.

Builds the detector from a numpy seed, serves random 320×320 uint8 images
through the `Scheduler` and `DetectionBackend` on the raw-head wire and on
the device-NMS wire, each at depth 1 and at ``--depth``, and checks:

  * every request completes and none is dropped;
  * depth-K payloads are bit-exact with depth 1, on both wires;
  * the device-NMS detection set equals the raw-wire set;
  * the served raw head lies within the `core.verify` envelope
    (max_abs < 0.02, within_1lsb == 1 at lsb 0.02) of the float forward.

On the card every dispatch is one CUDA graph replay per bucket and wire
(`DetectionBackend`). The summary also carries the kernel launches of the
raw-wire depth-K serve and its dispatch count. Prints one JSON summary
line; writes no file.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.core import verify
from repro_torch.device import resolve_device
from repro_torch.kernels.w1a8_conv import fused_pool
from repro_torch.kernels.w1a8_conv import ops as conv_ops
from repro_torch.kernels.w1a8_matmul import ops as mm_ops
from repro_torch.models import detection, yolo
from repro_torch.serve import DetectionBackend, Scheduler, ServeRequest

# Every CUDA kernel entry point of the port, by name: each counts its own
# launches, through graph replays too. The launcher serves through the
# three dot kernels and the post-processing kernel (`detect_postprocess`);
# the popcount forward runs the three popcount kernels, and
# `w1a8_matmul_int` and `detect_nms` (the same kernel on decoded boxes) are
# called directly.
KERNELS = {"w1a8_conv3x3_pool2": fused_pool.KERNEL,
           "w1a8_conv3x3": conv_ops.KERNEL, "w1a8_matmul": mm_ops.KERNEL,
           "w1a8_conv3x3_pool2_popcount": fused_pool.POPCOUNT_KERNEL,
           "w1a8_conv3x3_popcount": conv_ops.POPCOUNT_KERNEL,
           "w1a8_matmul_popcount": mm_ops.POPCOUNT_KERNEL,
           "w1a8_matmul_int": mm_ops.INT_KERNEL,
           "detect_nms": detection.NMS_KERNEL,
           "detect_postprocess": detection.POSTPROCESS_KERNEL}


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def make_images(n: int, seed: int, size: int = yolo.INPUT_SIZE) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, size, size, 3), np.uint8)


def serve(backend, imgs_u8: np.ndarray) -> tuple:
    """All images through one Scheduler; (results by rid, summary).
    Raises unless every request completed in dispatch order, none dropped."""
    n = len(imgs_u8)
    sched = Scheduler(backend, max_queue=max(n, 1))
    results = sched.run([ServeRequest(rid=i, image=imgs_u8[i])
                         for i in range(n)])
    summary = sched.metrics.summary()
    if summary["requests_dropped"] or summary["requests_completed"] != n:
        raise AssertionError(f"requests dropped: {summary}")
    if [r.rid for r in results] != list(range(n)):
        raise AssertionError("completions left dispatch order")
    return {r.rid: r.detections for r in results}, summary


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


def check_alignment(params: dict, imgs_u8: np.ndarray, raw_wire: dict,
                    device) -> verify.AlignmentReport:
    """Served raw heads vs the float forward, paper §6.3 statistics."""
    chunks = []
    for i in range(0, len(imgs_u8), 64):         # bounds the float forward
        imgs = torch.from_numpy(imgs_u8[i:i + 64]).to(device) \
            .to(torch.float32) / 256.0
        with torch.no_grad():
            chunks.append(yolo.yolo_forward_float(params, imgs).cpu().numpy())
    ref = np.concatenate(chunks)
    got = np.stack([raw_wire[i]["raw"] for i in range(len(imgs_u8))])
    rep = verify.compare("serve_detect_raw", got, ref, lsb=0.02)
    if not (rep.max_abs < 0.02 and rep.within_1lsb == 1.0):
        raise AssertionError(f"raw head outside the envelope: {rep.row()}")
    return rep


def run_detect(args) -> dict:
    dev = resolve_device(args.device)
    imgs_u8 = make_images(args.requests, args.seed)
    params, art = yolo.build_detector(
        args.seed, imgs_u8[:1].astype(np.float32) / 256.0, device=dev)
    raw_t = DetectionBackend(art, slots=args.slots, depth=1, device=dev)
    dn_t = DetectionBackend(art, slots=args.slots, depth=1, device=dev,
                            device_nms=True)
    raw_t.warmup()
    dn_t.warmup()
    raw_1, _ = serve(raw_t.spawn(depth=1), imgs_u8)
    counted = raw_t.spawn(depth=args.depth)
    before = launch_counts()
    raw_k, raw_summary = serve(counted, imgs_u8)
    launches = {k: n - before[k] for k, n in launch_counts().items()}
    dn_1, _ = serve(dn_t.spawn(depth=1), imgs_u8)
    dn_k, summary = serve(dn_t.spawn(depth=args.depth), imgs_u8)
    check_bit_exact(raw_k, raw_1, f"raw wire depth={args.depth}")
    check_bit_exact(dn_k, dn_1, f"device-NMS wire depth={args.depth}")
    check_nms_wire(dn_k, raw_1)
    rep = check_alignment(params, imgs_u8, raw_1, dev)
    return {
        "workload": "detect",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "slots": args.slots, "depth": args.depth, "requests": args.requests,
        "nms": "device", "wire": "fp16 boxes+scores, int8 classes, "
                                 "int32 valid",
        "checks": ["zero drops", "depth-K bit-exact with depth 1",
                   "device-NMS set equals raw-wire set",
                   "raw head within verify envelope"],
        "alignment": {"max_abs": rep.max_abs, "mean_abs": rep.mean_abs,
                      "within_1lsb": rep.within_1lsb},
        **{k: summary[k] for k in ("img_per_s", "wall_s", "ticks",
                                   "tick_p50_ms", "tick_p95_ms",
                                   "host_sync_bytes_per_sync")},
        "raw_wire": {k: raw_summary[k] for k in
                     ("img_per_s", "wall_s", "tick_p50_ms", "tick_p95_ms",
                      "host_sync_bytes_per_sync")},
        "raw_wire_dispatches": counted.host_syncs,
        "raw_wire_launches": launches,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("detect",), default="detect")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    record = run_detect(args)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
