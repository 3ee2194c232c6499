"""Where a detection dispatch spends its time on the card:
``python -m repro_torch.launch.profile [--dispatches 8 --slots 4 --seed 0
--profile tuned]``.

Serves ``dispatches × slots`` random 320×320 images through the
`DetectionBackend` (depth 2, raw-head wire, under ``--profile``; on the
card one CUDA graph replay a dispatch) with `torch.profiler` tracing the
CPU and the card, after one warm-up pass, and prints one JSON line:

  * ``configs``: the W1A8 layers' resolved configs at 320, and
    ``launches_per_dispatch`` of the port's kernels;
  * ``device_busy_ms``: the union of the traced device intervals (and
    per dispatch);
  * ``wall_ms``: the host clock over the same window, ended by a
    synchronize; ``device_idle_share`` = 1 − busy / wall;
  * ``groups``: device ms per dispatch for each W1A8 kernel, dot and
    popcount, the post-processing kernel (decode and NMS), cuDNN (conv1 /
    conv11), and everything else (conv1's epilogue, casts, copies);
  * per dispatch: ``host_api_calls`` (the CUDA runtime calls the host
    made, by name: graph launches, kernel launches, copies),
    ``device_kernels`` and ``device_copies`` (traced device records);
  * ``top``: the kernels with the most device time, with their counts;
  * ``trace_lost``: where the trace holds fewer records of a port kernel
    than its launch count says ran in the window, both numbers (empty
    when none was lost); each loss is also written to stderr.

Fails when the trace holds no device activity.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time

import numpy as np
import torch

from repro_torch.launch.serve import launch_counts, make_images, serve
from repro_torch.models import yolo
from repro_torch.serve import DetectionBackend

# (group, a substring of its device kernels' names): the port's kernels,
# no name a substring of another; a dispatch post-processes through
# csrc/detect_nms.cu's detect_postprocess
GROUPS = (("w1a8_conv3x3_pool2", "conv3x3_pool2_kernel"),
          ("w1a8_conv3x3", "conv3x3_kernel"),
          ("w1a8_matmul", "matmul_kernel"),
          ("w1a8_conv3x3_pool2_popcount", "conv3x3_pool2_popcount_kernel"),
          ("w1a8_conv3x3_popcount", "conv3x3_popcount_kernel"),
          ("w1a8_matmul_popcount", "matmul_popcount_kernel"),
          ("detect_postprocess", "nms_kernel"))


def port_group(name: str):
    """The port kernel's group a device record's name belongs to, or None."""
    for group, key in GROUPS:
        if key in name:
            return group
    return None


def _group(name: str) -> str:
    group = port_group(name)
    if group is not None:
        return group
    if "cudnn" in name.lower() or "conv" in name.lower():
        return "cudnn_conv"
    return "other"


def union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_dispatches(*, dispatches: int = 8, slots: int = 4,
                       seed: int = 0, profile: str = "tuned") -> dict:
    """The record described above, for the backend under ``profile``."""
    dev = torch.device("cuda")
    imgs = make_images(dispatches * slots, seed)
    _, art = yolo.build_detector(
        seed, imgs[:1].astype(np.float32) / 256.0, device=dev)
    backend = DetectionBackend(art, slots=slots, depth=2, profile=profile,
                               device=dev)
    backend.warmup()
    serve(backend.spawn(), imgs)                  # warm pass, not traced
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = launch_counts()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        serve(backend.spawn(), imgs)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    launched = {k: n - before[k] for k, n in launch_counts().items()}
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise RuntimeError("the trace holds no device activity")
    per_name = collections.defaultdict(lambda: [0.0, 0])
    per_group = collections.defaultdict(float)
    traced = collections.Counter()
    copies = 0
    for e in events:
        us = e.time_range.elapsed_us()
        per_name[e.name][0] += us
        per_name[e.name][1] += 1
        per_group[_group(e.name)] += us
        traced[_group(e.name)] += 1
        copies += e.name.startswith(("Memcpy", "Memset"))
    host_api = collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CPU
        and e.name.startswith("cuda"))
    busy_us = union_us((e.time_range.start, e.time_range.end)
                        for e in events)
    n = dispatches
    lost = {g: {"traced": traced[g], "launched": launched[g]}
            for g, _ in GROUPS if traced[g] < launched[g]}
    for g, counts in lost.items():
        print(f"profile: the trace lost records of {g}: {counts}",
              file=sys.stderr)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "card": torch.cuda.get_device_name(0), "profile": profile,
        "dispatches": n, "slots": slots,
        "configs": [f"{c.accum} rows={c.rows} fused={c.fused} ({c.source})"
                    for c in backend.configs(yolo.INPUT_SIZE)],
        "launches_per_dispatch": {k: v / n for k, v in launched.items()
                                  if v},
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "wall_ms_per_dispatch": wall_us / 1e3 / n,
        "device_busy_ms_per_dispatch": busy_us / 1e3 / n,
        "groups": {g: us / 1e3 / n for g, us in sorted(per_group.items())},
        "host_api_calls": {name: c / n
                           for name, c in sorted(host_api.items())},
        "device_kernels": (len(events) - copies) / n,
        "device_copies": copies / n,
        "device_launches_per_dispatch": len(events) / n,
        "top": [{"name": name[:80], "ms_per_dispatch": us / 1e3 / n,
                 "count": cnt} for name, (us, cnt) in top],
        "trace_lost": lost,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dispatches", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", choices=yolo.PROFILES, default="tuned")
    args = ap.parse_args(argv)
    record = profile_dispatches(dispatches=args.dispatches, slots=args.slots,
                                seed=args.seed, profile=args.profile)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
