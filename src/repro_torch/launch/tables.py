"""The paper's tables on the port, as ``name,value,notes`` CSV rows:

    PYTHONPATH=src python -m repro_torch.launch.tables
        [--only complexity|memory|alignment|kernels|roofline] [--device cpu]

Table 5 (``complexity``: parameters and GFLOPs from the Table 1
structure), Table 2 (``memory``: per-layer line buffers and packed weight
bytes), Table 6 (``alignment``: `launch/alignment.py`'s rows at 320,
seed 42, on the card unless ``--device cpu``), the kernel suite
(``kernels``: the W1A8 linear's float path, packed plain path and the
popcount kernel timed at the reference's two shapes, CUDA-event µs on the
card, host µs with ``--device cpu``, beside the H100 bound) and Table 7
(``roofline``: a row per cell of the port's ``results/dryrun.json`` with
``results/costs.json``'s roofline, `launch/dryrun.py`, `launch/costs.py`).
The first two equal the reference's ``benchmarks/complexity.py`` and
``benchmarks/memory_table.py`` row for row; the last two are the
counterparts of ``benchmarks/kernel_bench.py`` and
``benchmarks/roofline.py``. A suite that raises prints an
``<suite>.ERROR`` row and the runner exits 1. It writes no file.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from repro_torch.device import card_name, resolve_device
from repro_torch.launch import alignment
from repro_torch.launch.mesh import HW
from repro_torch.models import yolo

PAPER = {"params_m": 0.74, "gflops": 0.098, "map50": 39.6}


def complexity() -> list:
    """Table 5: the paper's 0.74 M params and 0.098 GFLOPs (its
    full-precision-op convention) from the Table 1 structure, and both
    other conventions."""
    counts = yolo.count_params()
    g = yolo.count_gflops()
    rel_p = abs(counts["total"] / 1e6 - PAPER["params_m"]) / PAPER["params_m"]
    rel_g = abs(g["paper_gflops"] - PAPER["gflops"]) / PAPER["gflops"]
    return [
        ("yolo_w1a8.params_total", counts["total"],
         f"paper 0.74M; rel err {rel_p:.3%}"),
        ("yolo_w1a8.gflops_paper_conv", round(g["paper_gflops"], 5),
         f"paper 0.098; rel err {rel_g:.3%}"),
        ("yolo_w1a8.gflops_total", round(g["total_gflops"], 4),
         "binary MACs at face value"),
        ("yolo_w1a8.gflops_binary_div64",
         round(g["binary_discount64_gflops"], 4), "XNOR-discount convention"),
        ("yolo_w1a8.map50_note", "n/a",
         "VOC2007 unavailable offline; mAP untestable — structural "
         "claims above verified instead")]


def memory() -> list:
    """Table 2: per layer, the streaming line buffers (2 rows of the input
    plane) and the weight bytes (1 bit a W1A8 weight, 16-bit fixed point
    for conv1 and conv11)."""
    rows, total_w = [], 0
    sizes = yolo.spatial_sizes()
    for s in yolo.YOLO_LAYERS:
        hw = sizes[s.name]
        line_buf = 2 * hw * s.cin
        bits = 1 if s.kind == "w1a8" else 16
        w_bytes = s.ksize ** 2 * s.cin * s.cout * bits // 8
        total_w += w_bytes
        rows.append((f"storage.{s.name}.line_buffer_kb",
                     round(line_buf / 1024, 2),
                     f"{s.cin}ch × {hw}px × 2 rows"))
        rows.append((f"storage.{s.name}.weights_kb", round(w_bytes / 1024, 2),
                     f"{s.kind} {s.ksize}x{s.ksize} {s.cin}->{s.cout}"))
    rows.append(("storage.total_packed_weights_kb", round(total_w / 1024, 1),
                 "fits the XC7Z020 4.9Mb BRAM budget with room for buffers"))
    return rows


KERNEL_SHAPES = ((256, 4096, 4096), (64, 1152, 128))   # (M, K, N)
CUDA_ITERS, CPU_ITERS = 20, 2     # timed calls a row, after a warm one


def _us(fn, dev: torch.device) -> float:
    """µs a call: CUDA events over CUDA_ITERS back-to-back calls on the
    card (after one warm call), the host clock over CPU_ITERS on the
    CPU."""
    fn()
    if dev.type == "cuda":
        iters = CUDA_ITERS
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters * 1e3
    iters = CPU_ITERS
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def kernels(device=None, shapes=KERNEL_SHAPES) -> list:
    """The kernel suite: a W1A8 linear at each (M, K, N), its float eval
    path (`core.w1a8.w1a8_linear_float_ref`), its packed plain path
    (`w1a8_linear_infer`, as the reference times it) and the popcount
    matmul (`kernels.w1a8_matmul.ops.w1a8_matmul`: the kernel on the card,
    its plain version on the CPU), in µs; the H100 bound in place of the
    reference's v5e model: the larger of 2·M·N·K at the int8 peak and the
    packed weights' bytes at the HBM rate, with the bf16-weight bound
    beside it. Rows are labelled ``cuda`` on the card, ``cpu`` else."""
    from repro_torch.core import w1a8
    from repro_torch.kernels.config import KernelConfig
    from repro_torch.kernels.w1a8_matmul.ops import w1a8_matmul
    dev = resolve_device(device)
    label, card = dev.type, card_name(dev)
    popcount = KernelConfig(op="matmul", accum="popcount")
    rows = []
    for (m, k, n) in shapes:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        p = w1a8.init_w1a8_linear(gen, k, n, device=dev)
        x = torch.rand((m, k), generator=gen, device=dev) * 2.0
        d = w1a8.deploy_w1a8_linear(p)
        a = torch.clamp(torch.round(x / d["mul_prev"]), 0, 255).to(
            torch.uint8)
        with torch.no_grad():
            us_ref = _us(lambda: w1a8.w1a8_linear_float_ref(p, x), dev)
            us_pkd = _us(lambda: w1a8.w1a8_linear_infer(d, a), dev)
            us_pop = _us(lambda: w1a8_matmul(
                a, d["w_packed"], d["mul_prev"], d["div_post"], d["bias"],
                k=k, config=popcount), dev)
        flops = 2 * m * k * n
        t_bf16 = max(flops / HW["peak_flops_bf16"],
                     k * n * 2 / HW["hbm_bw"]) * 1e6
        t_pkd = max(flops / HW["peak_ops_int8"],
                    k * n / 8 / HW["hbm_bw"]) * 1e6
        tag = f"kernel.w1a8_matmul.{m}x{k}x{n}"
        rows += [
            (f"{tag}.{label}_ref_us", round(us_ref, 1),
             f"float eval path ({card})"),
            (f"{tag}.{label}_packed_us", round(us_pkd, 1),
             f"1-bit deployed path, plain torch ({card})"),
            (f"{tag}.{label}_popcount_us", round(us_pop, 1),
             ("popcount kernel" if label == "cuda" else
              "popcount plain version") + f" ({card})"),
            (f"{tag}.h100_bound_us", round(t_pkd, 5),
             f"{HW['name']}; bf16-weight bound {t_bf16:.3f}us → "
             f"{t_bf16 / t_pkd:.1f}x")]
    return rows


def _load(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return json.load(f)


def roofline(results_dir=None) -> list:
    """Table 7: a row per cell of the port's dry run, its value the costs
    record's roofline fraction where there is one; the note its trace
    time, per-device peak beside the reference layout's bytes, whether it
    fits the card and the roofline terms; then ``Nok/Nskip/Nerr``."""
    from repro_torch.launch.dryrun import RESULTS_DIR
    results_dir = results_dir or RESULTS_DIR
    dry = _load(os.path.join(results_dir, "dryrun.json"))
    costs = {(r["arch"], r["shape"], r["mesh"]): r
             for r in _load(os.path.join(results_dir, "costs.json"))}
    rows = []
    ok = sk = er = 0
    for r in dry:
        tag = f"dryrun.{r['arch']}.{r['shape']}.{r['mesh']}"
        if r.get("status") == "ok":
            ok += 1
            gb = r["memory"]["peak_bytes"] / 2 ** 30
            ref = r.get("reference_layout_bytes", 0) / 2 ** 30
            note = (f"trace {r.get('trace_s')}s; {gb:.1f} GiB/device "
                    f"(reference layout {ref:.1f}); fits {r['fits']}")
            c = costs.get((r["arch"], r["shape"], r["mesh"]))
            if c and c.get("status") == "ok":
                rl = c["roofline"]
                note += (f"; comp {rl['t_compute_s']:.3g}s mem "
                         f"{rl['t_memory_s']:.3g}s coll "
                         f"{rl['t_collective_s']:.3g}s → {rl['bottleneck']}")
                rows.append((tag, round(rl.get("roofline_fraction") or 0, 4),
                             note))
            else:
                rows.append((tag, "ok", note))
        elif r.get("status") == "skipped":
            sk += 1
            rows.append((tag, "skipped", r.get("reason", "")[:60]))
        else:
            er += 1
            rows.append((tag, "ERROR", r.get("error", "")[:80]))
    rows.append(("dryrun.summary", f"{ok}ok/{sk}skip/{er}err",
                 f"{HW['name']}; launch/dryrun.py, launch/costs.py"))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    choices=("complexity", "memory", "alignment", "kernels",
                             "roofline"))
    ap.add_argument("--device", default=None,
                    help="Table 6's and the kernel suite's device; "
                         "default: the card")
    args = ap.parse_args(argv)
    suites = {
        "complexity": complexity,                               # Table 5
        "memory": memory,                                       # Table 2
        "alignment": lambda: alignment.run(device=args.device),  # Table 6
        "kernels": lambda: kernels(args.device),
        "roofline": roofline,                                   # Table 7
    }
    print("name,value,notes")
    failures = 0
    for name, fn in suites.items():
        if args.only and name != args.only:
            continue
        try:
            for tag, value, note in fn():
                print(f"{tag},{value},\"{note}\"", flush=True)
        except Exception as e:                              # noqa: BLE001
            failures += 1
            print(f"{name}.ERROR,{type(e).__name__},\"{e}\"", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
