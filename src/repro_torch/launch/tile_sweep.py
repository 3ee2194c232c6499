"""Device time of the kernels on the tensor cores, dot and popcount, for
each warp tile, at every W1A8 layer shape of the 320×320 detector with
B = 4: the convs at the 3×3 layers, the matmuls at conv9, there also at
B = 8, 16, 32 and 64 (the launcher's ``--slots``; M = 100·B); and the
integer PE (``csrc/w1a8_int_pe.cu``) at each of its warp tiles on every
layer of the integer forward, on a deployed artifact's constants and
digit planes, its 1×1 layers also on the M = B·H·W outputs in rows of
16 (`sweep_1x1`).

    PYTHONPATH=src python -m repro_torch.launch.tile_sweep
    PYTHONPATH=src python -m repro_torch.launch.tile_sweep --decode

For each layer and accum mode the kernel the fused-pool route runs there
(the fused conv+pool kernel at pool layers, the conv kernel elsewhere, the
matmul at conv9) is timed once per warp tile (wm, wn), with the rest
of the geometry as `w1a8_conv.geometry.conv_launch` or
`w1a8_matmul.geometry.matmul_launch` picks it, and marked with the tile
the geometry's heuristic chooses (for the integer PE,
`w1a8_int.geometry.pe_launch`). A time is
the device time per call: the union of the calls' traced device intervals
(torch.profiler) over 20 calls, divided by 20. Prints one JSON object with
the card's name and power limit. Needs the card.

``--decode`` sweeps the popcount matmul's decode route instead
(`sweep_decode`): at the LM decode shapes (chatglm3-6b's projections at
M = 4 and its tensor-parallel blocks at |model| 16) every K split the
decode kernel takes, (cw, kw, cs) as `only_decode_split` forces it, each
held bit for bit against the PR-15 tile; and at (K, N) = (4096, 13696)
for M = 1 to 32 the route `decode_launch` picks against the PR-15 tile
(`pr15_route`), timed in turns (PR 15, decode, decode, PR 15): the
crossover that sets `geometry.DECODE_MAX_M`; likewise at M = 4, N = 4096
for K = 128 to 2048, the crossover that sets `geometry.DECODE_MIN_K`.
These times are device ms from CUDA-graph replays of 20 calls
(`graph_ms`).
"""
from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from repro_torch.device import card_name
from repro_torch.kernels.config import ACCUMS, KernelConfig
from repro_torch.kernels.w1a8_conv import fused_pool, geometry
from repro_torch.kernels.w1a8_conv import ops as conv_ops
from repro_torch.kernels.w1a8_int import geometry as int_geometry
from repro_torch.kernels.w1a8_int import ops as int_ops
from repro_torch.kernels.w1a8_matmul import geometry as mm_geometry
from repro_torch.kernels.w1a8_matmul import ops as mm_ops
from repro_torch.launch.profile import union_us
from repro_torch.models import yolo

TILES = ((2, 4), (2, 2), (2, 1), (1, 4), (1, 2), (1, 1))
MATMUL_BATCHES = (8, 16, 32, 64)  # conv9's batches besides --batch


@contextlib.contextmanager
def only_tile(tile):
    """Makes `geometry.conv_launch` pick `tile` whatever the shape."""
    saved = geometry.WARP_TILES, geometry.WARPS_PER_SM
    geometry.WARP_TILES, geometry.WARPS_PER_SM = (tile,), 0
    try:
        yield
    finally:
        geometry.WARP_TILES, geometry.WARPS_PER_SM = saved


@contextlib.contextmanager
def only_matmul_tile(tile):
    """Makes `matmul_launch` pick warp tile `tile` whatever the shape and
    route."""
    saved = mm_geometry.WARP_TILES
    mm_geometry.WARP_TILES = {accum: (tile,) for accum in saved}
    try:
        yield
    finally:
        mm_geometry.WARP_TILES = saved


def sweep_matmul(rng, m: int, k: int, n: int, dev, layer: str) -> list:
    """Both matmuls at (m, k, n), requantized as on the forward path, once
    per warp tile its route's kernel builds; one record per accum mode, its
    times keyed "{wm}x{wn}"."""
    a = torch.from_numpy(rng.integers(0, 256, (m, k), dtype=np.uint8)).to(dev)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    mul, div, bias = (torch.from_numpy(x.astype(np.float32)).to(dev)
                      for x in (rng.uniform(0.01, 0.1, k),
                                rng.uniform(0.5, 1.5, n),
                                rng.standard_normal(n)))
    wp = mm_ops.w1a8_pack_weights(w).to(dev)
    records = []
    for accum in ACCUMS:
        g = mm_geometry.matmul_launch(m, n, accum)
        m_prev = mul if accum == "dot" else None
        cfg = KernelConfig(op="matmul", accum=accum)
        step = float(mm_ops.w1a8_matmul(a, wp, m_prev, div, bias, k=k,
                                        config=cfg).abs().max()) / 255.0
        qcfg = cfg.replace(out_step=step)
        run = lambda: mm_ops.w1a8_matmul(  # noqa: E731
            a, wp, m_prev, div, bias, k=k, config=qcfg)
        times = {}
        for tile in mm_geometry.WARP_TILES[accum]:
            with only_matmul_tile(tile):
                times[f"{tile[0]}x{tile[1]}"] = device_ms(run)
        suffix = "" if accum == "dot" else "_popcount"
        records.append({"layer": layer, "kernel": "w1a8_matmul" + suffix,
                        "shape": [m, k, n],
                        "picked": f"{g.wm}x{g.wn}",
                        "device_ms": times})
    return records


@contextlib.contextmanager
def pr15_route():
    """Makes the popcount matmul take the PR-15 tile (`matmul_launch`) at
    every M, and the grouped entry at every cap."""
    saved = mm_geometry.DECODE_MAX_M
    mm_geometry.DECODE_MAX_M = 0
    try:
        yield
    finally:
        mm_geometry.DECODE_MAX_M = saved


@contextlib.contextmanager
def only_decode_split(cw: int, kw: int, cs: int):
    """Makes the popcount matmul take the decode route at any K and
    `decode_launch` split K as (cw, kw, cs) wherever the shape has the
    spans and columns for it (fewer where it has not)."""
    names = ("DECODE_COL_WARPS", "DECODE_K_WARPS", "DECODE_MAX_CLUSTER",
             "DECODE_MIN_SPANS", "DECODE_MIN_WARPS", "SMS", "DECODE_MIN_K")
    saved = [getattr(mm_geometry, name) for name in names]
    for name, v in zip(names, (cw, kw, cs, 1, 1 << 30, 1 << 30, 1)):
        setattr(mm_geometry, name, v)
    try:
        yield
    finally:
        for name, v in zip(names, saved):
            setattr(mm_geometry, name, v)


@contextlib.contextmanager
def decode_any_k():
    """Makes the popcount matmul take the decode route at any K of M ≤
    DECODE_MAX_M, split as `decode_launch` picks it."""
    saved = mm_geometry.DECODE_MIN_K
    mm_geometry.DECODE_MIN_K = 1
    try:
        yield
    finally:
        mm_geometry.DECODE_MIN_K = saved


# (what, M, K, N): chatglm3-6b's packed projections at M = 4 (decode) and
# their blocks at |model| 16 (PR 29's tensor-parallel layout)
DECODE_SHAPES = (("qkv wq, wo", 4, 4096, 4096), ("wk, wv", 4, 4096, 256),
                 ("up, gate", 4, 4096, 13696), ("down", 4, 13696, 4096),
                 ("tp wk, wv", 4, 4096, 16), ("tp wo", 4, 256, 4096),
                 ("tp up, gate", 4, 4096, 856))
DECODE_SPLITS = tuple((cw, kw, cs) for cw in (1, 2) for kw in (1, 2, 4, 8)
                      for cs in (1, 2, 4, 8) if cw * kw <= 8)
CROSSOVER = (4096, 13696, tuple(range(1, 33)))
K_CROSSOVER = (4, 4096, (128, 256, 384, 512, 768, 1024, 2048))


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device ms per call of ``fn``: CUDA events around replays of one
    CUDA graph of ``n`` calls (median of ``reps``)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return sorted(times)[reps // 2]


def _decode_operands(rng, m: int, k: int, n: int, dev):
    a = torch.from_numpy(rng.integers(0, 256, (m, k), dtype=np.uint8)).to(dev)
    w = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, (-(-k // 32), n)
                                      ).astype(np.int32)).to(dev)
    div = torch.from_numpy(rng.uniform(1e-4, 1e-3, n).astype(np.float32)
                           ).to(dev)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    cfg = KernelConfig(op="matmul", accum="popcount")
    return lambda: mm_ops.w1a8_matmul(a, w, None, div, bias, k=k, config=cfg)


def sweep_decode(rng, dev) -> dict:
    """The decode route's K splits at DECODE_SHAPES and its crossover with
    the PR-15 tile at CROSSOVER; each split and route held bit for bit
    against the PR-15 tile's result."""
    shapes = []
    for what, m, k, n in DECODE_SHAPES:
        run = _decode_operands(rng, m, k, n, dev)
        with pr15_route():
            want = run()
            pr15 = graph_ms(run)
        times, seen = {}, set()
        for split in DECODE_SPLITS:
            with only_decode_split(*split):
                d = mm_geometry.decode_launch(m, k, n)
                key = f"{d.cw}x{d.kw}x{d.cs}"
                if key in seen:
                    continue
                seen.add(key)
                if not torch.equal(run(), want):
                    raise AssertionError(f"decode split {key} at "
                                         f"{(m, k, n)} differs from PR 15's")
                times[key] = graph_ms(run)
        d = mm_geometry.decode_launch(m, k, n)
        rec = {"what": what, "shape": [m, k, n],
               "picked": f"{d.cw}x{d.kw}x{d.cs}",
               "picked_ms": graph_ms(run), "pr15_ms": pr15,
               "best": min(times, key=times.get), "device_ms": times}
        print(json.dumps(rec), flush=True)
        shapes.append(rec)
    k, n, ms = CROSSOVER
    crossover = []
    for m in ms:
        run = _decode_operands(rng, m, k, n, dev)
        if m > 16:
            with pr15_route():
                rec = {"m": m, "pr15_ms": [graph_ms(run), graph_ms(run)]}
            crossover.append(rec)
            print(json.dumps(rec), flush=True)
            continue
        with pr15_route():
            want = run()
            old = [graph_ms(run)]
        if not torch.equal(run(), want):
            raise AssertionError(f"decode route at M = {m} differs")
        new = [graph_ms(run), graph_ms(run)]
        with pr15_route():
            old.append(graph_ms(run))
        rec = {"m": m, "shape": [m, k, n], "pr15_ms": old, "decode_ms": new}
        crossover.append(rec)
        print(json.dumps(rec), flush=True)
    m, n, ks = K_CROSSOVER
    k_crossover = []
    for k in ks:
        run = _decode_operands(rng, m, k, n, dev)
        with pr15_route():
            want = run()
            old = [graph_ms(run)]
        with decode_any_k():
            if not torch.equal(run(), want):
                raise AssertionError(f"decode route at K = {k} differs")
            new = [graph_ms(run), graph_ms(run)]
        with pr15_route():
            old.append(graph_ms(run))
        rec = {"k": k, "shape": [m, k, n], "pr15_ms": old, "decode_ms": new}
        k_crossover.append(rec)
        print(json.dumps(rec), flush=True)
    return {"shapes": shapes, "crossover": crossover,
            "k_crossover": k_crossover}


@contextlib.contextmanager
def only_int_tile(tile):
    """Makes `pe_launch` pick warp tile `tile` whatever the shape."""
    saved = int_geometry.WARP_TILES, int_geometry.NARROW
    int_geometry.WARP_TILES, int_geometry.NARROW = (tile,), 0
    try:
        with only_tile(tile):
            yield
    finally:
        int_geometry.WARP_TILES, int_geometry.NARROW = saved


def matmul_pe_launch(kind: int, b: int, h: int, w: int, cin: int,
                     cout: int, ksize: int, pool: bool,
                     planes: int) -> int_geometry.PeLaunch:
    """The integer PE's launch of a 1×1 layer viewed as (1, M/16, 16, Cin)
    with the popcount matmul's block (`matmul_launch` at M = h·w, N =
    Cout): one row of 16 outputs, its block N and threads, its warp
    tile."""
    mm = mm_geometry.matmul_launch(b * h * w, cout, "popcount")
    if ksize != 1 or pool or b != 1 or w != mm.bm:
        raise ValueError(f"not a 1×1 layer in rows of {mm.bm}: "
                         f"{(b, h, w, ksize, pool)}")
    row_px = geometry.conv_launch(b, h, w, cin, cout, 1, False,
                                  "popcount").row_px
    return int_geometry.PeLaunch(
        grid=(mm.grid[1], h, 1), threads=mm.threads,
        smem=int_geometry.pe_smem(kind, 1, cin, mm.bn, planes, 1, row_px),
        rows=1, bn=mm.bn, wm=mm.wm, wn=mm.wn, row_px=row_px)


@contextlib.contextmanager
def matmul_geometry():
    """Makes the integer PE's wrappers launch with `matmul_pe_launch`."""
    saved = int_ops.pe_launch
    int_ops.pe_launch = matmul_pe_launch
    try:
        yield
    finally:
        int_ops.pe_launch = saved


def sweep_1x1(entry: dict, x: torch.Tensor) -> dict:
    """A 1×1 layer's device ms under three geometries: the conv tile on
    its (B, H, W) plane as `pe_launch` picks it, the same rule on the
    (1, M/16, 16) view of the M = B·H·W outputs, and `matmul_pe_launch` on
    that view. Each output is held bit for bit against the first's."""
    b, h, w, cin = x.shape
    flat = x.reshape(1, b * h * w // 16, 16, cin)
    want = yolo.int_layer(entry, x).reshape(1, b * h * w // 16, 16, -1)
    runs = {"conv tile": lambda: yolo.int_layer(entry, x),
            "rows of 16": lambda: yolo.int_layer(entry, flat)}
    with matmul_geometry():
        got = yolo.int_layer(entry, flat)
    if not torch.equal(yolo.int_layer(entry, flat), want) or not \
            torch.equal(got, want):
        raise AssertionError(f"{entry['spec'].name}: a 1×1 geometry "
                             f"differs from the conv tile's")
    times = {name: device_ms(run) for name, run in runs.items()}
    with matmul_geometry():
        times["matmul_launch"] = device_ms(lambda: yolo.int_layer(entry,
                                                                  flat))
    return times


def sweep_int_pe(rng, batch: int, dev) -> list:
    """Every layer of `yolo_forward_int` at 320×320 (a calibrated,
    deployed artifact; random codes), once per warp tile the integer PE
    builds, the 1×1 layers also under `sweep_1x1`'s geometries; one record
    per layer, its times keyed "{wm}x{wn}" (and "geometries_1x1")."""
    img = torch.from_numpy(rng.integers(0, 256, (batch, 320, 320, 3),
                                        dtype=np.uint8)).to(dev)
    with torch.no_grad():
        params = yolo.calibrate_yolo(yolo.init_yolo_params(0, device=dev),
                                     img.to(torch.float32) / 256.0)
        art = yolo.deploy_yolo(params)
    sizes = yolo.spatial_sizes(yolo.INPUT_SIZE)
    kinds = {"conv1": int_geometry.CONV1, "conv11": int_geometry.HEAD}
    records = []
    for entry in art["layers"]:
        spec = entry["spec"]
        h = sizes[spec.name]
        x = torch.from_numpy(rng.integers(0, 256, (batch, h, h, spec.cin),
                                          dtype=np.uint8)).to(dev)
        planes = int(entry["planes"].shape[0])
        picked = int_geometry.pe_launch(
            kinds.get(spec.name, int_geometry.W1A8), batch, h, h, spec.cin,
            spec.cout, spec.ksize, spec.pool, planes)
        times = {}
        for tile in int_geometry.WARP_TILES:
            with only_int_tile(tile):
                times[f"{tile[0]}x{tile[1]}"] = device_ms(
                    lambda: yolo.int_layer(entry, x))
        rec = {"layer": spec.name, "kernel": "w1a8_int_pe",
               "shape": [batch, h, h, spec.cin, spec.cout],
               "planes": planes, "picked": f"{picked.wm}x{picked.wn}",
               "device_ms": times}
        if spec.ksize == 1 and batch * h * h % 16 == 0:
            rec["geometries_1x1"] = sweep_1x1(entry, x)
        records.append(rec)
    return records


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
    ap.add_argument("--decode", action="store_true",
                    help="sweep the popcount matmul's decode route alone")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    card = card_name(dev)
    rng = np.random.default_rng(args.seed)
    if args.decode:
        record = {"card": card, **sweep_decode(rng, dev)}
        print(json.dumps(record))
        return record
    sizes = yolo.spatial_sizes(yolo.INPUT_SIZE)
    layers = []
    for spec in yolo.YOLO_LAYERS:
        if spec.kind != "w1a8":
            continue
        b, h, cin, cout = args.batch, sizes[spec.name], spec.cin, spec.cout
        if spec.ksize == 1:
            for mb in (b,) + MATMUL_BATCHES:
                for rec in sweep_matmul(rng, mb * h * h, cin, cout, dev,
                                        spec.name):
                    print(json.dumps(rec), flush=True)
                    layers.append(rec)
            continue
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
    for rec in sweep_int_pe(rng, args.batch, dev):
        print(json.dumps(rec), flush=True)
        layers.append(rec)
    record = {"card": card, "layers": layers}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
