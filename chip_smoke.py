#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Prints the card's name and power limit (nvidia-smi), builds the three
   CUDA kernels from ``src/repro_torch/csrc`` with nvcc (in parallel) and
   prints the build seconds and each kernel's register use.
2. Holds each kernel against its plain PyTorch version on the card, at
   every W1A8 layer shape of the 320×320 detector with B = 4: f32 outputs
   within 6e-3·max|y|, uint8 codes within 1 LSB, the fused conv+pool kernel
   equal to the conv kernel plus a 2×2 max exactly, and results unchanged
   by the row blocking. Times each kernel, its plain version and one
   PyTorch library call (CUDA events).
3. Drives the main path through the serving launcher
   (``repro_torch.launch.serve``: 16 random 320×320 uint8 images,
   `slots=4`, `depth=2`), with every launch count set to 0 just before and
   read just after. The launcher checks zero drops, depth-K payloads
   bit-exact with depth 1 on both wires, the device-NMS set equal to the
   raw-wire set, and the raw head within the `core.verify` envelope of the
   float forward; this script checks launches = dispatches × (4, 4, 1) for
   (conv3x3_pool2, conv3x3, matmul) on its raw-wire depth-2 serve.
4. Prints one ``{"kernels": [...]}`` line, and as the last line
   ``{"ok": true, "device": {...}}``.

Sixteen requests make four dispatches: enough for the checks, too few for
a rate. Throughput and tick latency come from a longer launcher run
(``python -m repro_torch.launch.serve --requests 512``).

Needs one card and the repository around it: without CUDA, or alone in a
directory, it exits non-zero and prints no result. Writes the per-layer
record to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
BATCH = 4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "w1a8_conv3x3_pool2": ("src/repro_torch/csrc/w1a8_conv3x3_pool2.cu",
                           "src/repro/kernels/w1a8_conv/fused_pool.py:72"),
    "w1a8_conv3x3": ("src/repro_torch/csrc/w1a8_conv3x3.cu",
                     "src/repro/kernels/w1a8_conv/kernel.py:80"),
    "w1a8_matmul": ("src/repro_torch/csrc/w1a8_matmul.cu",
                    "src/repro/kernels/w1a8_matmul/kernel.py:168"),
}
PER_DISPATCH = {"w1a8_conv3x3_pool2": 4, "w1a8_conv3x3": 4, "w1a8_matmul": 1}


def cuda_ms(torch, fn, reps: int = 7, n: int = 20) -> float:
    """Median over `reps` of the mean time of `n` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def bound(nbytes: int, ops: int) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def layer_operands(torch, np, rng, b, h, cin, cout, dev, *, ksize=3):
    a = torch.from_numpy(rng.integers(0, 256, (b, h, h, cin),
                                      dtype=np.uint8)).to(dev)
    w = rng.standard_normal((ksize * ksize * cin, cout)).astype(np.float32)
    mul = rng.uniform(0.01, 0.1, cin).astype(np.float32)
    div = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return a, torch.from_numpy(w).to(dev), *(torch.from_numpy(x).to(dev)
                                             for x in (mul, div, bias))


def check_kernels(torch, np, dev) -> tuple:
    """Phase 2: every kernel against its plain version at the main path's
    shapes. Returns the per-layer records and, per kernel, the worst codes
    difference and f32 error over every call that launched it."""
    import torch.nn.functional as F
    from repro_torch.core import packing
    from repro_torch.kernels.config import KernelConfig
    from repro_torch.kernels.w1a8_conv import fused_pool
    from repro_torch.kernels.w1a8_conv import ops as conv_ops
    from repro_torch.kernels.w1a8_conv import ref as conv_ref
    from repro_torch.kernels.w1a8_matmul import ops as mm_ops
    from repro_torch.kernels.w1a8_matmul import ref as mm_ref
    from repro_torch.models import yolo

    rng = np.random.default_rng(SEED)
    sizes = yolo.spatial_sizes(yolo.INPUT_SIZE)
    layers = []
    errs = {name: {"codes": 0, "f32": None} for name in KERNELS}

    def note(kernel, got, want):
        e = errs[kernel]
        if got.dtype == torch.uint8:
            d = int((got.int() - want.int()).abs().max())
            e["codes"] = max(e["codes"], d)
        else:
            d = float((got - want).abs().max())
            e["f32"] = d if e["f32"] is None else max(e["f32"], d)
        return d
    for spec in yolo.YOLO_LAYERS:
        if spec.kind != "w1a8":
            continue
        h, cin, cout = sizes[spec.name], spec.cin, spec.cout
        a, w, mul, div, bias = layer_operands(torch, np, rng, BATCH, h, cin,
                                              cout, dev, ksize=spec.ksize)
        rec = {"layer": spec.name, "shape": [BATCH, h, h, cin, cout]}
        if spec.ksize == 1:
            rec["kernel"] = "w1a8_matmul"
            a2 = a.reshape(-1, cin)
            wp = mm_ops.w1a8_pack_weights(w)
            y_ref = mm_ref.w1a8_matmul_ref(a2, wp, cin, mul, div, bias)
            y = mm_ops.w1a8_matmul(a2, wp, mul, div, bias, k=cin)
            step = float(y_ref.abs().max()) / 255.0
            cfg = KernelConfig(op="matmul", out_step=step)
            q = mm_ops.w1a8_matmul(a2, wp, mul, div, bias, k=cin, config=cfg)
            q_ref = mm_ref.w1a8_matmul_ref(a2, wp, cin, mul, div, bias, step)
            m = a2.shape[0]
            nbytes = (m * cin + wp.numel() * 4 + 4 * cin + 8 * cout
                      + m * cout)
            ops = 2 * m * cin * cout
            run = lambda: mm_ops.w1a8_matmul(a2, wp, mul, div, bias,  # noqa: E731
                                             k=cin, config=cfg)
            plain = lambda: mm_ref.w1a8_matmul_ref(  # noqa: E731
                a2, wp, cin, mul, div, bias, step)
            a_bf = mm_ref.bf16_prologue(a2, mul).to(torch.bfloat16)
            s_bf = packing.unpack_signs(wp, cin, dtype=torch.bfloat16)
            library = lambda: torch.matmul(a_bf, s_bf)  # noqa: E731
        else:
            wp = conv_ops.conv_pack_weights(w.reshape(3, 3, cin, cout))
            y_ref = conv_ref.w1a8_conv3x3_ref(a, wp, cin, mul, div, bias)
            y = conv_ops.w1a8_conv3x3(a, wp, mul, div, bias, cin=cin)
            step = float(y_ref.abs().max()) / 255.0
            cfg = KernelConfig(op="conv3x3", out_step=step)
            q = conv_ops.w1a8_conv3x3(a, wp, mul, div, bias, cin=cin,
                                      config=cfg)
            q_ref = conv_ref.w1a8_conv3x3_ref(a, wp, cin, mul, div, bias,
                                              step)
            q_rows = conv_ops.w1a8_conv3x3(a, wp, mul, div, bias, cin=cin,
                                           config=cfg.replace(rows=2))
            if not torch.equal(q_rows, q):
                raise AssertionError(f"{spec.name}: conv3x3 rows=2 differs")
            ops = 2 * BATCH * h * h * 9 * cin * cout
            a_bf = mm_ref.bf16_prologue(a, mul).to(torch.bfloat16) \
                .permute(0, 3, 1, 2).contiguous()
            w_bf = torch.where(w >= 0, 1.0, -1.0).reshape(3, 3, cin, cout) \
                .permute(3, 2, 0, 1).contiguous().to(torch.bfloat16)
            library = lambda: F.conv2d(a_bf, w_bf, padding=1)  # noqa: E731
            in_bytes = a.numel() + wp.numel() * 4 + 4 * cin + 8 * cout
            if spec.pool:
                rec["kernel"] = "w1a8_conv3x3_pool2"
                p = fused_pool.w1a8_conv3x3_pool2(a, wp, mul, div, bias,
                                                  cin=cin, out_step=step)
                p_ref = conv_ref.w1a8_conv3x3_pool2_ref(a, wp, cin, mul, div,
                                                        bias, step)
                if not torch.equal(p, conv_ref.maxpool2_codes(q)):
                    raise AssertionError(
                        f"{spec.name}: fused pool != conv3x3 kernel + max")
                p_rows = fused_pool.w1a8_conv3x3_pool2(
                    a, wp, mul, div, bias, cin=cin, out_step=step, rows=2)
                if not torch.equal(p_rows, p):
                    raise AssertionError(f"{spec.name}: pool rows=2 differs")
                rec["pool_codes_max_diff"] = note(rec["kernel"], p, p_ref)
                nbytes = in_bytes + p.numel()
                run = lambda: fused_pool.w1a8_conv3x3_pool2(  # noqa: E731
                    a, wp, mul, div, bias, cin=cin, out_step=step)
                plain = lambda: conv_ref.w1a8_conv3x3_pool2_ref(  # noqa: E731
                    a, wp, cin, mul, div, bias, step)
            else:
                rec["kernel"] = "w1a8_conv3x3"
                nbytes = in_bytes + q.numel()
                run = lambda: conv_ops.w1a8_conv3x3(  # noqa: E731
                    a, wp, mul, div, bias, cin=cin, config=cfg)
                plain = lambda: conv_ref.w1a8_conv3x3_ref(  # noqa: E731
                    a, wp, cin, mul, div, bias, step)
        torch.cuda.synchronize()
        base = "w1a8_matmul" if spec.ksize == 1 else "w1a8_conv3x3"
        scale = float(y_ref.abs().max())
        rec["f32_max_abs_err"] = note(base, y, y_ref)
        rec["f32_tol"] = 6e-3 * scale
        rec["codes_max_diff"] = note(base, q, q_ref)
        rec["codes_identical"] = float((q == q_ref).float().mean())
        if rec["f32_max_abs_err"] > rec["f32_tol"]:
            raise AssertionError(f"{spec.name}: f32 error {rec}")
        if rec["codes_max_diff"] > 1 or rec.get("pool_codes_max_diff", 0) > 1:
            raise AssertionError(f"{spec.name}: codes differ by > 1 LSB {rec}")
        rec["ms"] = cuda_ms(torch, run)
        rec["plain_ms"] = cuda_ms(torch, plain, reps=3, n=3)
        rec["library_ms"] = cuda_ms(torch, library)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops)
        rec["bytes"], rec["ops"] = nbytes, ops
        print(f"[check] {spec.name} {rec['kernel']} {rec['shape']}: codes "
              f"max diff {rec['codes_max_diff']} "
              f"({100 * rec['codes_identical']:.3f}% identical), f32 err "
              f"{rec['f32_max_abs_err']:.3g} <= {rec['f32_tol']:.3g}; "
              f"{rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, library "
              f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.5f} "
              f"by {rec['bound_by']})", flush=True)
        layers.append(rec)
    return layers, errs


def drive_main_path() -> tuple:
    """Phase 3: the serving launcher, with every launch count zeroed just
    before and read just after; returns (its record, the counts)."""
    from repro_torch.launch import serve as launch

    for k in launch.KERNELS.values():
        k.launches = 0
    record = launch.main(["--workload", "detect", "--requests", "16",
                          "--slots", "4", "--depth", "2"])
    launches = launch.launch_counts()
    dispatches = record["raw_wire_dispatches"]
    for name, per in PER_DISPATCH.items():
        n = record["raw_wire_launches"][name]
        if n != dispatches * per or launches[name] == 0:
            raise AssertionError(f"{name}: {n} launches for {dispatches} "
                                 f"dispatches, want {per} each")
    print(f"[serve] 16 requests, 0 dropped, checks passed; raw-wire depth-2 "
          f"serve: {dispatches} dispatches, launches "
          f"{record['raw_wire_launches']}; all launches {launches}",
          flush=True)
    return record, launches


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    secs = _build.build_all()
    print(f"[build] {len(_build.SOURCES)} kernels built with nvcc in "
          f"{secs:.1f} s", flush=True)
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}")

    t0 = time.perf_counter()
    layers, errs = check_kernels(torch, np, dev)
    print(f"[check] {len(layers)} layer shapes in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    record, launches = drive_main_path()

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rows = [r for r in layers if r["kernel"] == name]
        t_ops = sum(r["ops"] / BF16_OPS_PER_S for r in rows)
        t_bytes = sum(r["bytes"] / HBM_BYTES_PER_S for r in rows)
        e = errs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_per_dispatch": PER_DISPATCH[name],
            # f32 error where the kernel has an f32 output; the pool
            # kernel writes codes only, so its error is in codes
            "max_abs_err": e["f32"] if e["f32"] is not None else e["codes"],
            "max_codes_diff": e["codes"], "max_f32_err": e["f32"],
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": sum(r["library_ms"] for r in rows),
            "layers": [r["layer"] for r in rows]})
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "layers": layers, "kernels": kernels,
         "launcher": record}, indent=1))
    print(json.dumps({"kernels": kernels, "img_per_s": record["img_per_s"],
                      "requests": record["requests"], "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
