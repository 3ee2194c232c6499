"""Autotune of the W1A8 kernels on the card:
``python -m repro_torch.launch.autotune --batch 4``.

Counterpart of ``repro/launch/autotune.py``. For every (op, layer shape,
accum) cell of the 320×320 detector's W1A8 layers
(`models.yolo.yolo_layer_cells` at ``--batch``, the launcher's
``--slots``) it sweeps the launch configs (`candidates`), holds each one
bit-exact against its accum mode's default config and times it, and
keeps the winner in ``kernels/AUTOTUNE_cuda.json``, keyed by
`kernels.config.device_key`, which `kernels.config.resolve` and
`resolve_tuned` read when serving. Beside it, ``kernels/BENCH_cuda.json``
holds each cell's roofline accounting on the H100's peaks and the tuned
speedup over the default. Both headers carry the card's name and power
limit (nvidia-smi) and the sweep's batch.

What differs from the reference, and why:

* Times are device times: the union of the traced device intervals
  (torch.profiler, as ``launch/tile_sweep.py``) over 20 calls, over 20. A
  wrapper's host cost is several times a kernel's device time, and served
  dispatches are CUDA graph replays, which pay none of it. A trace that
  holds fewer records of the port's kernels than the calls launched is
  taken again. On CPU tensors, which only the tests use, a time is the
  host clock's.
* Conv cells are timed at the sweep's batch (the key stays batch-free).
  A ``rows`` whose staging does not fit a block's shared memory
  (`w1a8_conv.geometry.conv_launch` raises) is skipped and recorded.
  An unfused candidate at a pool cell is timed as serving runs it: the
  conv kernel and the 2×2 max.
* A matmul cell has one candidate per accum mode, the default: its warp
  tile follows from M (`w1a8_matmul.geometry`, settled by
  ``launch/tile_sweep.py``). Its timed entries let `resolve_tuned` choose
  the accum mode.

    python -m repro_torch.launch.autotune --batch 4     # sweep, write both
    python -m repro_torch.launch.autotune --bench --reduced --gate-bench

``--bench`` re-times the committed winners against their defaults (no
sweep) and rewrites their BENCH entries; ``--gate-bench`` fails when a
cell's speedup falls below the committed one by more than ``--band``.
With ``--device cpu`` (a rehearsal) both files go to ``build/autotune/``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from repro_torch.device import card_name, resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels import config as kc
from repro_torch.kernels.config import KernelConfig
from repro_torch.kernels.w1a8_conv import geometry
from repro_torch.kernels.w1a8_conv import ops as conv_ops
from repro_torch.kernels.w1a8_matmul import ops as mm_ops
from repro_torch.launch.profile import port_group, union_us
from repro_torch.models import yolo

AUTOTUNE_OUT = kc.DEFAULT_TABLE
BENCH_OUT = AUTOTUNE_OUT.with_name("BENCH_cuda.json")
REHEARSAL_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "autotune"

# H100 SXM (NVIDIA's data sheet): HBM3 bytes/s, dense tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"dot": 989e12, "popcount": 1979e12}  # bf16, int8

# Reduced cells: every op and both accum modes, keys as in the full table.
REDUCED_MAX_H = 40
CANONICAL_M = 0.05     # the operands' uniform activation step
CALLS = 20             # calls per trace


# ---------------------------------------------------------------------------
# Cells + candidates
# ---------------------------------------------------------------------------

def yolo_cells(batch: int = 1) -> list:
    """Deduped structural cells [(op, dims)] over the YOLO layers."""
    seen, cells = set(), []
    for _, op, dims in yolo.yolo_layer_cells(batch):
        if (op, dims) not in seen:
            seen.add((op, dims))
            cells.append((op, dims))
    return cells


def _divisors_leq(n: int, cap: int) -> list:
    return [d for d in range(1, min(n, cap) + 1) if n % d == 0]


def candidates(op: str, dims, accum: str) -> list:
    """Candidate KernelConfigs for one cell, the default first: a conv's
    row blockings (divisors ≤ 16 of its output rows, pooled rows at a pool
    cell), over both pool routes at a pool cell; a matmul's default
    only."""
    base = KernelConfig(op=op, accum=accum, out_step=1.0)
    out = [base]
    if op != "matmul":
        h = dims[0] if op == "conv3x3" else dims[0] // 2
        routes = (True, False) if op == "conv3x3_pool" else (True,)
        for fused in routes:
            for r in _divisors_leq(h, 16):
                out.append(base.replace(fused=fused, rows=r))
    return list(dict.fromkeys(out))     # dedup, the default stays first


def _cand_key(cfg: KernelConfig) -> str:
    return json.dumps(cfg.to_dict(), sort_keys=True)


def select_winner(measurements: list) -> tuple:
    """(t, config) winner from [(t, config)]: the least time, ties broken
    on the config's canonical JSON, so the choice is deterministic."""
    return min(measurements, key=lambda m: (m[0], _cand_key(m[1])))


def launch_error(op: str, dims, batch: int, cfg: KernelConfig):
    """Why the card cannot launch ``cfg`` at this cell (the conv geometry's
    refusal, e.g. too much shared memory), or None."""
    if op == "matmul":
        return None
    h, w, cin, cout = dims
    try:
        geometry.conv_launch(batch, h, w, cin, cout, cfg.rows,
                             op == "conv3x3_pool" and cfg.fused, cfg.accum)
    except ValueError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def _operands(op: str, dims, batch: int, device, seed: int = 0) -> dict:
    """Seeded operands for one cell, made with numpy and moved to
    ``device``: codes, sign words, a uniform Mul_prev (so one set serves
    both accum modes), Div scaled to keep the codes off their clips, and a
    bias. Popcount takes the step folded into Div, as the forward does."""
    rng = np.random.default_rng(seed)
    if op == "matmul":
        m, k, n = dims
        a = rng.integers(0, 256, (m, k), np.uint8)
        w = rng.standard_normal((k, n)).astype(np.float32)
        wp = mm_ops.w1a8_pack_weights(torch.from_numpy(w))
        kw, kdim, taps = {"k": k}, k, k
    else:
        h, w_, cin, n = dims
        a = rng.integers(0, 256, (batch, h, w_, cin), np.uint8)
        w = rng.standard_normal((3, 3, cin, n)).astype(np.float32)
        wp = conv_ops.conv_pack_weights(torch.from_numpy(w))
        kw, kdim, taps = {"cin": cin}, cin, 9 * cin
    # a sum of `taps` ±code·m terms spreads as about 150·m·√taps
    div = (rng.uniform(0.5, 2.0, n) * 16 / np.sqrt(taps)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    t = {name: torch.from_numpy(x).to(device) for name, x in
         (("a", a), ("div", div), ("bias", bias))}
    t["wp"] = wp.to(device)
    t["mul"] = torch.full((kdim,), CANONICAL_M, device=device)
    t["div_folded"] = t["div"] * torch.tensor(CANONICAL_M, device=device)
    t["kw"] = kw
    return t


def _call(op: str, operands: dict, cfg: KernelConfig) -> torch.Tensor:
    fn = {"matmul": mm_ops.w1a8_matmul,
          "conv3x3": conv_ops.w1a8_conv3x3,
          "conv3x3_pool": conv_ops.w1a8_conv3x3_pool}[op]
    dot = cfg.accum == "dot"
    return fn(operands["a"], operands["wp"], operands["mul"] if dot else None,
              operands["div"] if dot else operands["div_folded"],
              operands["bias"], config=cfg, **operands["kw"])


def _port_launches() -> int:
    return sum(k.launches for k in _build.KERNELS if k.share_of is None)


def _time_us(fn, on_card: bool, tries: int = 5) -> float:
    """µs per call of ``fn``: on the card its device time over CALLS calls
    (torch.profiler), retaken when the trace lost records of the port's
    kernels; on the CPU the host clock."""
    if not on_card:
        t0 = time.perf_counter()
        fn()
        return 1e6 * (time.perf_counter() - t0)
    for _ in range(tries):
        before = _port_launches()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        launched = _port_launches() - before
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        traced = sum(port_group(e.name) is not None for e in events)
        if traced >= launched and len(events) >= CALLS:
            return union_us((e.time_range.start, e.time_range.end)
                            for e in events) / CALLS
    raise RuntimeError(f"{tries} traces lost device records")


def _warm(op: str, operands: dict, cfg: KernelConfig) -> bool:
    _call(op, operands, cfg)
    on_card = operands["a"].is_cuda
    if on_card:
        torch.cuda.synchronize()
    return on_card


def time_config(op: str, operands: dict, cfg: KernelConfig,
                iters: int = 3) -> float:
    """Least µs per call over ``iters`` timings, after a warm call."""
    on_card = _warm(op, operands, cfg)
    return min(_time_us(lambda: _call(op, operands, cfg), on_card)
               for _ in range(iters))


def time_pair(op: str, operands: dict, cfg_a: KernelConfig,
              cfg_b: KernelConfig, iters: int = 5) -> tuple:
    """Least µs per call of two configs, timed in turns (a, b, a, b, …)
    so that a passing disturbance reaches both; the ratio is what ranks
    candidates."""
    on_card = _warm(op, operands, cfg_a)
    _warm(op, operands, cfg_b)
    best_a = best_b = float("inf")
    for _ in range(iters):
        best_a = min(best_a, _time_us(lambda: _call(op, operands, cfg_a),
                                      on_card))
        best_b = min(best_b, _time_us(lambda: _call(op, operands, cfg_b),
                                      on_card))
    return best_a, best_b


def roofline(op: str, dims, accum: str, batch: int = 1) -> dict:
    """Bytes and operations of one cell's call, and the least time the
    H100 could take for them: each input read once (uint8 codes, packed
    sign words, f32 epilogue vectors), each output written once (uint8
    codes; a quarter at a pool cell), 2 operations a MAC at the dense peak
    of the mode's type (bf16 for dot, int8 for popcount)."""
    if op == "matmul":
        m, k, n = dims
        ops = 2 * m * k * n
        nbytes = m * k + 4 * -(-k // 32) * n + 4 * (k + 2 * n) + m * n
    else:
        h, w, cin, cout = dims
        ops = 2 * 9 * cin * cout * h * w * batch
        out = batch * h * w * cout // (4 if op == "conv3x3_pool" else 1)
        nbytes = (batch * h * w * cin + 4 * -(-9 * cin // 32) * cout
                  + 4 * (cin + 2 * cout) + out)
    t_ops = ops / PEAK_OPS_PER_S[accum]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"ops": int(ops), "bytes": int(nbytes),
            "ops_per_byte": round(ops / nbytes, 2),
            "t_model_us_h100": 1e6 * max(t_ops, t_bytes),
            "bound": "operations" if t_ops >= t_bytes else "bytes"}


# ---------------------------------------------------------------------------
# Sweep and bench runs
# ---------------------------------------------------------------------------

def sweep_cell(op: str, dims, accum: str, *, batch: int = 1, iters: int = 3,
               device=None) -> dict:
    """Sweeps one cell; returns its table entry. Every candidate is held
    bit-exact against the default before it is timed, in turns with the
    default (`time_pair`), and ranked by its time over the default's."""
    dev = resolve_device(device)
    operands = _operands(op, dims, batch, dev)
    cands = candidates(op, dims, accum)
    if launch_error(op, dims, batch, cands[0]):
        raise ValueError(f"{op}/{dims}: the default config cannot launch")
    ref = _call(op, operands, cands[0])
    measured = [(1.0, cands[0])]
    pair_us, skipped = {}, []
    for cfg in cands[1:]:
        why = launch_error(op, dims, batch, cfg)
        if why is not None:
            skipped.append({"rows": cfg.rows, "fused": cfg.fused,
                            "reason": why})
            continue
        if not torch.equal(_call(op, operands, cfg), ref):
            raise AssertionError(f"candidate not bit-exact: "
                                 f"{op}/{dims}/{accum} {cfg}")
        t_def, t_cand = time_pair(op, operands, cands[0], cfg,
                                  max(iters, 5))
        measured.append((t_cand / t_def, cfg))
        pair_us[_cand_key(cfg)] = (t_def, t_cand)
    ratio, best = select_winner(measured)
    if _cand_key(best) in pair_us:
        t_default, t_best = pair_us[_cand_key(best)]
    else:       # the default won: one config, one timing
        t_default = t_best = time_config(op, operands, cands[0],
                                         max(iters, 5))
    return {"op": op, "dims": list(dims), "accum": accum,
            "config": best.replace(source="table").to_dict(),
            "t_us": t_best, "t_default_us": t_default,
            "speedup_vs_default": 1.0 / ratio,
            "candidates_tried": len(cands) - len(skipped),
            "skipped": skipped, "batch": batch, "iters": iters}


def bench_cell(op: str, dims, accum: str, entry: dict, *, batch: int = 1,
               iters: int = 3, device=None) -> dict:
    """Re-times one committed winner against the default (no sweep);
    returns its BENCH entry."""
    dev = resolve_device(device)
    operands = _operands(op, dims, batch, dev)
    default = candidates(op, dims, accum)[0]
    tuned = KernelConfig.from_dict(entry["config"])
    if tuned == default:        # source is provenance, not compared
        t_default = t_tuned = time_config(op, operands, default, iters)
    else:
        if not torch.equal(_call(op, operands, tuned),
                           _call(op, operands, default)):
            raise AssertionError(f"committed winner not bit-exact: "
                                 f"{op}/{dims}/{accum} {tuned}")
        t_default, t_tuned = time_pair(op, operands, default, tuned,
                                       max(iters, 5))
    return _bench(op, dims, accum, batch, t_tuned, t_default)


def _bench(op, dims, accum, batch, t_us, t_default_us) -> dict:
    rec = {"t_us": t_us, "t_default_us": t_default_us,
           "speedup_vs_default": t_default_us / t_us,
           **roofline(op, dims, accum, batch)}
    rec["roofline_frac"] = rec["t_model_us_h100"] / max(t_us, 1e-9)
    return rec


def _is_reduced(op: str, dims) -> bool:
    return op == "matmul" or dims[0] <= REDUCED_MAX_H


def write_json(path: pathlib.Path, header: dict, entries: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({**header, "entries": entries}, indent=1,
                               sort_keys=True) + "\n")


def _read_entries(path: pathlib.Path) -> dict:
    return (json.loads(path.read_text()).get("entries", {})
            if path.exists() else {})


def run(args) -> int:
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    table_out = AUTOTUNE_OUT if on_card else REHEARSAL_DIR / AUTOTUNE_OUT.name
    bench_out = BENCH_OUT if on_card else REHEARSAL_DIR / BENCH_OUT.name
    key_dev = kc.device_key() if on_card else "cpu"
    cells = yolo_cells(batch=args.batch)
    if args.reduced:
        cells = [(op, dims) for op, dims in cells if _is_reduced(op, dims)]
    committed_bench = _read_entries(bench_out)
    table = _read_entries(table_out)
    header = {"version": 1, "device": key_dev, "card": card_name(dev),
              "batch": args.batch}
    print(header["card"], flush=True)

    bench, failures = {}, []
    for op, dims in cells:
        for accum in kc.ACCUMS:
            key = kc.shape_key(op, dims, accum, key_dev)
            if args.bench:
                entry = table.get(key)
                if entry is None:
                    print(f"[skip] no committed entry for {key}")
                    continue
                bench[key] = bench_cell(op, dims, accum, entry,
                                        batch=args.batch, iters=args.iters,
                                        device=dev)
            else:
                entry = sweep_cell(op, dims, accum, batch=args.batch,
                                   iters=args.iters, device=dev)
                table[key] = entry
                bench[key] = _bench(op, dims, accum, args.batch,
                                    entry["t_us"], entry["t_default_us"])
            b = bench[key]
            cfg = table[key]["config"]
            print(f"{key}: rows={cfg['rows']} fused={cfg['fused']} "
                  f"{b['t_us']:.3f} us vs default {b['t_default_us']:.3f} us "
                  f"({b['speedup_vs_default']:.3f}x), {b['ops_per_byte']} "
                  f"ops/B, bound by {b['bound']}, roofline fraction "
                  f"{b['roofline_frac']:.4f}", flush=True)
            old = committed_bench.get(key)
            if args.gate_bench and old is not None:
                new_s, old_s = b["speedup_vs_default"], \
                    old["speedup_vs_default"]
                if new_s < old_s * (1 - args.band) and new_s < 1 - args.band:
                    failures.append(f"{key}: speedup {new_s:.3f} < committed "
                                    f"{old_s:.3f} beyond the "
                                    f"{args.band:.0%} band")
    if not args.bench:
        write_json(table_out, header, table)
        print(f"wrote {table_out} ({len(table)} entries)")
    merged = {**committed_bench, **bench}
    write_json(bench_out, {**header, "roofline": {
        "hbm_bytes_per_s": HBM_BYTES_PER_S,
        "peak_ops_per_s": PEAK_OPS_PER_S,
        "note": "H100 SXM data-sheet peaks (dense bf16 for dot, int8 for "
                "popcount); times are device times per call"}}, merged)
    print(f"wrote {bench_out} ({len(merged)} entries)")
    if failures:
        print("PERF GATE FAILED:\n  " + "\n  ".join(failures))
        return 1
    if args.gate_bench:
        print(f"perf gate OK ({len(bench)} cells within the "
              f"{args.band:.0%} band)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", action="store_true",
                    help="re-time the committed winners only (no sweep)")
    ap.add_argument("--reduced", action="store_true",
                    help=f"cells with conv h <= {REDUCED_MAX_H} and the "
                         f"matmul only")
    ap.add_argument("--gate-bench", action="store_true",
                    help="fail when a cell's speedup_vs_default falls "
                         "beyond --band below the committed BENCH entry")
    ap.add_argument("--band", type=float, default=0.25,
                    help="noise band of --gate-bench (default 0.25)")
    ap.add_argument("--batch", type=int, default=4,
                    help="images per call: the launcher's --slots")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
