"""The paper's tables on the port, as ``name,value,notes`` CSV rows:

    PYTHONPATH=src python -m repro_torch.launch.tables
        [--only complexity|memory|alignment] [--device cpu]

Table 5 (``complexity``: parameters and GFLOPs from the Table 1
structure), Table 2 (``memory``: per-layer line buffers and packed weight
bytes) and Table 6 (``alignment``: `launch/alignment.py`'s rows at 320,
seed 42, on the card unless ``--device cpu``). The first two equal the
reference's ``benchmarks/complexity.py`` and ``benchmarks/memory_table.py``
row for row. A suite that raises prints an ``<suite>.ERROR`` row and the
runner exits 1. It writes no file. The reference's kernel and roofline
suites are not ported.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.launch import alignment
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    choices=("complexity", "memory", "alignment"))
    ap.add_argument("--device", default=None,
                    help="Table 6's device; default: the card")
    args = ap.parse_args(argv)
    suites = {
        "complexity": complexity,                               # Table 5
        "memory": memory,                                       # Table 2
        "alignment": lambda: alignment.run(device=args.device),  # Table 6
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
