"""Device time of the conv kernels on the tensor cores, dot and popcount,
for each warp tile, at every 3×3 layer shape of the 320×320 detector with
B = 4.

    PYTHONPATH=src python -m repro_torch.launch.tile_sweep

For each layer and accum mode the kernel the fused-pool route runs there
(the fused conv+pool kernel at pool layers, the conv kernel elsewhere) is
timed once per warp tile (wm, wn) with the rest of the geometry as
`geometry.conv_launch` picks it, and marked with the tile the geometry's
heuristic chooses. A time is
the device time per call: the union of the calls' traced device intervals
(torch.profiler) over 20 calls, divided by 20. Prints one JSON object with
the card's name and power limit. Needs the card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess

import numpy as np
import torch

from repro_torch.kernels.config import ACCUMS, KernelConfig
from repro_torch.kernels.w1a8_conv import fused_pool, geometry
from repro_torch.kernels.w1a8_conv import ops as conv_ops
from repro_torch.launch.profile import union_us
from repro_torch.models import yolo

TILES = ((2, 4), (2, 2), (2, 1), (1, 4), (1, 2), (1, 1))


@contextlib.contextmanager
def only_tile(tile):
    """Makes `geometry.conv_launch` pick `tile` whatever the shape."""
    saved = geometry.WARP_TILES, geometry.WARPS_PER_SM
    geometry.WARP_TILES, geometry.WARPS_PER_SM = (tile,), 0
    try:
        yield
    finally:
        geometry.WARP_TILES, geometry.WARPS_PER_SM = saved


def device_ms(fn, n: int = 20, tries: int = 5) -> float:
    """Device ms per call of ``fn``. Each call launches one kernel, so a
    trace with fewer device events than calls has lost some, as one now
    and then does; it is taken again, up to ``tries`` times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        spans = [(e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(spans) >= n:
            return union_us(spans) / 1e3 / n
    raise RuntimeError(f"{tries} traces lost device activity")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(args.seed)
    sizes = yolo.spatial_sizes(yolo.INPUT_SIZE)
    layers = []
    for spec in yolo.YOLO_LAYERS:
        if spec.kind != "w1a8" or spec.ksize != 3:
            continue
        b, h, cin, cout = args.batch, sizes[spec.name], spec.cin, spec.cout
        a = torch.from_numpy(rng.integers(0, 256, (b, h, h, cin),
                                          dtype=np.uint8)).to(dev)
        w = torch.from_numpy(rng.standard_normal((3, 3, cin, cout))
                             .astype(np.float32)).to(dev)
        mul, div, bias = (torch.from_numpy(x.astype(np.float32)).to(dev)
                          for x in (rng.uniform(0.01, 0.1, cin),
                                    rng.uniform(0.5, 1.5, cout),
                                    rng.standard_normal(cout)))
        wp = conv_ops.conv_pack_weights(w)
        for accum in ACCUMS:
            # popcount contracts the codes as they are (Mul_prev folded)
            m = mul if accum == "dot" else None
            cfg = KernelConfig(op="conv3x3", accum=accum)
            step = float(conv_ops.w1a8_conv3x3(a, wp, m, div, bias, cin=cin,
                                               config=cfg)
                         .abs().max()) / 255.0
            suffix = "" if accum == "dot" else "_popcount"
            if spec.pool:
                kernel = "w1a8_conv3x3_pool2" + suffix
                run = lambda: fused_pool.w1a8_conv3x3_pool2(  # noqa: E731
                    a, wp, m, div, bias, cin=cin, out_step=step, accum=accum)
            else:
                kernel = "w1a8_conv3x3" + suffix
                qcfg = cfg.replace(out_step=step)
                run = lambda: conv_ops.w1a8_conv3x3(  # noqa: E731
                    a, wp, m, div, bias, cin=cin, config=qcfg)
            picked = geometry.conv_launch(b, h, h, cin, cout, 1, spec.pool,
                                          accum)
            times = {}
            for tile in TILES:
                with only_tile(tile):
                    times[f"{tile[0]}x{tile[1]}"] = device_ms(run)
            rec = {"layer": spec.name, "kernel": kernel,
                   "shape": [b, h, h, cin, cout],
                   "picked": f"{picked.wm}x{picked.wn}", "device_ms": times}
            print(json.dumps(rec), flush=True)
            layers.append(rec)
    record = {"card": card, "layers": layers}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
