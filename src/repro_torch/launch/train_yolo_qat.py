"""The paper's offline workflow end to end: QAT-train the W1A8 detector on
the synthetic detection set, deploy it to the integer datapath, check
integer-vs-float alignment (the Table 6 final-raw row) and run decode +
NMS on the integer head.

    PYTHONPATH=src python -m repro_torch.launch.train_yolo_qat
        [--steps 60] [--batch 2] [--seed 0] [--device cpu]

Runs on the card unless ``--device cpu``: calibrates on batch 0, trains
with AdamW(1e-3), judges training on one held-out batch (its loss before
and after), deploys (`yolo.deploy_yolo`), runs `yolo.yolo_forward_int` on a
test batch, compares it with the float forward (`verify.compare`, LSB
0.02) and post-processes it (`detection.postprocess`). Prints the
reference example's lines (``examples/train_yolo_qat.py``), then one JSON
line: the loss at each logged step, the held-out loss before and after, ms
per train step (CUDA events around each step on the card, the host clock
on the CPU; the first step, which warms up, left out) and images per
second from it, peak device memory, and the alignment row. On the card a
step is one CUDA graph replay (`train.yolo_qat.make_yolo_train_step`):
the first step's ms include its warm steps and its capture.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from repro_torch.core import verify
from repro_torch.data import pipeline as data
from repro_torch.device import full_f32, resolve_device
from repro_torch.models import detection, yolo
from repro_torch.optim import adamw
from repro_torch.train.loop import StepTimer
from repro_torch.train.yolo_qat import make_yolo_train_step, yolo_loss

HELD_OUT_STEP = 999     # the batch that judges training, like for like
TEST_STEP = 9999        # the batch the deployed artifact is checked on
LR = 1e-3
LOG_EVERY = 10


def held_out_loss(params: dict, batch: tuple) -> torch.Tensor:
    img, boxes, classes = batch
    with torch.no_grad(), full_f32():
        return yolo_loss(params, img, data.yolo_target(boxes, classes))


def train(steps: int, batch: int, seed: int = 0, device=None) -> tuple:
    """Calibrate on batch 0, then ``steps`` AdamW QAT steps, one new batch
    each. Returns (trained params, dataset, record)."""
    dev = resolve_device(device)
    ds = data.make_detection_dataset(batch, seed)
    img0, _, _ = data.detection_batch(ds, 0, device=dev)
    params = yolo.calibrate_yolo(yolo.init_yolo_params(seed, device=dev),
                                 img0)
    opt = adamw(LR)
    step = make_yolo_train_step(opt)
    state = opt[0](params)
    held_out = data.detection_batch(ds, HELD_OUT_STEP, device=dev)
    loss_before = float(held_out_loss(params, held_out))

    print(f"QAT training the W1A8 detector ({steps} steps, batch {batch}, "
          f"{dev})…", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    timer, logged = StepTimer(dev), []
    t0 = time.perf_counter()
    for i in range(steps):
        img, boxes, classes = data.detection_batch(ds, i, device=dev)
        with timer:
            params, state, m = step(params, state, img, boxes, classes)
        if i % LOG_EVERY == 0 or i == steps - 1:
            logged.append((i, float(m["loss"])))
            print(f"  step {i:3d} loss {logged[-1][1]:8.4f}", flush=True)
    wall_s = time.perf_counter() - t0
    print(f"trained in {wall_s:.0f}s", flush=True)
    ms = timer.ms()
    timed = ms[1:] if len(ms) > 1 else ms
    ms_step = statistics.median(timed)
    record = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "steps": steps, "batch": batch, "seed": seed, "lr": LR,
        "loss": logged,
        "held_out_loss_before": loss_before,
        "held_out_loss_after": float(held_out_loss(params, held_out)),
        "clock": "cuda events" if dev.type == "cuda" else "host",
        "ms_per_step": ms_step, "ms_per_step_mean": statistics.mean(timed),
        "first_step_ms": ms[0], "img_per_s": batch / (ms_step / 1e3),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "wall_s": wall_s}
    return params, ds, record


def deploy_and_check(params: dict, ds, device) -> tuple:
    """Deploy the trained params, run the integer forward on the test batch
    and compare it with the float forward. Returns (the alignment report,
    the int head as float32 on the device, the batch's classes)."""
    dev = resolve_device(device)
    art = yolo.deploy_yolo(params)
    img, _, classes = data.detection_batch(ds, TEST_STEP, device=dev)
    # torch.round and jnp.round both round half to even
    img_u8 = torch.clamp(torch.round(img * 256.0), 0, 255).to(torch.uint8)
    with torch.no_grad():
        out_f = yolo.yolo_forward_float(params, img)
        raw_i = yolo.yolo_forward_int(art, img_u8, device=dev)
    rep = verify.compare("final_raw (trained)",
                         raw_i.cpu().numpy() / 2.0 ** 15,
                         out_f.double().cpu().numpy(), lsb=0.02)
    return rep, raw_i.to(torch.float32) / 2.0 ** 15, classes


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params, ds, record = train(args.steps, args.batch, args.seed, dev)

    print("\nparameter extraction → fixed point → integer datapath (§4)…")
    rep, raw, classes = deploy_and_check(params, ds, dev)
    print(rep.row())
    print("paper Table 6 reference: corr=0.999964, mean_abs=0.020027")

    print("\ndetection head decode + NMS on the integer output…")
    b, s, c = detection.postprocess(raw, score_thresh=0.05, max_out=8)
    kept = int(torch.sum(s[0] > 0))
    print(f"{kept} boxes after NMS; ground truth had "
          f"{int(torch.sum(classes[0] >= 0))}")
    for j in range(min(kept, 4)):
        print(f"  box cxcywh={np.round(b[0, j].cpu().numpy(), 3)} "
              f"score={float(s[0, j]):.3f} class={int(c[0, j])}")
    print("\ne2e OK")
    record.update({
        "final_raw": {"max_abs": rep.max_abs, "mean_abs": rep.mean_abs,
                      "corr": rep.corr, "within_1lsb": rep.within_1lsb},
        "kept_boxes": kept, "detections_shape": list(b.shape)})
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
