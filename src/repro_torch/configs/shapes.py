"""Assigned input-shape sets (LM family): 4 shapes × 10 archs = 40 cells.

``train_*``  lowers train_step;  ``prefill_*`` lowers a forward pass;
``decode_*`` / ``long_*`` lower serve_step (one new token against a KV/SSM
cache of the given length). long_500k runs only for architectures with
bounded-state decode (SSM / hybrid / SWA) — skips recorded per cell.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# Architectures whose decode state stays bounded at 500k context:
# SSM (mamba2), hybrid (jamba), sliding-window (mixtral, window 4096).
LONG_OK = {"mamba2-1.3b", "jamba-1.5-large-398b", "mixtral-8x7b"}


def applicable_shapes(arch_name: str) -> list:
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and arch_name not in LONG_OK:
            continue
        out.append(s)
    return out


def skip_reason(arch_name: str, shape_name: str) -> str:
    if shape_name == "long_500k" and arch_name not in LONG_OK:
        return ("pure full-attention architecture: 500k global-attention "
                "decode has unbounded KV state (DESIGN.md §5)")
    return ""
