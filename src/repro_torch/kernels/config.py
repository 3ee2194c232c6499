"""KernelConfig — one frozen launch-config object for the W1A8 kernels.

Counterpart of ``repro/kernels/config.py``. Resolution turns an (op, layer
shape, accum, device) cell into a concrete config: the exact autotune-table
entry, else the heuristic default. The port keeps its own table
(`DEFAULT_TABLE`); none has been measured yet, so every cell resolves to
``accum="dot"``, ``fused=True``, ``rows=1``. The reference's nearest-shape
fallback comes back with the table. Configs are resolved once per bucket
and batch width (`models.yolo.kernel_configs`), never per forward.

Whether a call runs a CUDA kernel or its plain PyTorch version is decided
by the device of the tensors it is given, never by the config.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, Optional, Sequence

OPS = ("matmul", "conv3x3", "conv3x3_pool")
ACCUMS = ("dot", "popcount")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Launch configuration for one W1A8 kernel call.

    ``rows`` is the conv row-blocking factor: output rows (pooled rows for
    the fused kernels) one block produces; the last block of a layer may
    hold fewer. ``fused`` routes ``w1a8_conv3x3_pool`` through the fused
    conv+pool kernel (True) or the conv kernel followed by a 2×2 max
    (False). All validation happens here.
    """

    op: str = "matmul"
    accum: str = "dot"
    out_step: Optional[float] = None
    rows: int = 1
    fused: bool = True

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"op must be one of {OPS}, got {self.op!r}")
        if self.accum not in ACCUMS:
            raise ValueError(
                f"accum must be one of {ACCUMS}, got {self.accum!r}")
        if self.rows < 1:
            raise ValueError(f"rows must be ≥ 1, got {self.rows}")

    def replace(self, **kw) -> "KernelConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "KernelConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


# Shape keys: conv3x3 / conv3x3_pool dims are (h, w, cin, cout) of the input
# plane; matmul dims are (m, k, n) with batch folded into m.

def device_key() -> str:
    import torch
    kind = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu")
    return str(kind).strip().lower().replace(" ", "-")


def shape_key(op: str, dims: Sequence[int], accum: str,
              device: Optional[str] = None) -> str:
    dev = device if device is not None else device_key()
    return f"{op}/{'x'.join(str(int(d)) for d in dims)}/{accum}/{dev}"


# The port's own table: the reference's table was tuned for another target.
DEFAULT_TABLE = pathlib.Path(__file__).resolve().parent / "AUTOTUNE_cuda.json"

_table_cache: Dict[str, dict] = {}


def load_table() -> dict:
    """entries dict (key → record) from the port's table; {} if absent."""
    ck = str(DEFAULT_TABLE)
    if ck not in _table_cache:
        try:
            with open(DEFAULT_TABLE) as f:
                _table_cache[ck] = json.load(f).get("entries", {})
        except (OSError, json.JSONDecodeError):
            _table_cache[ck] = {}
    return _table_cache[ck]


def resolve(op: str, dims: Sequence[int], *, accum: str = "dot",
            device: Optional[str] = None,
            table: Optional[dict] = None) -> KernelConfig:
    """The table's entry for the exact cell, else the heuristic default."""
    dev = device if device is not None else device_key()
    entries = table if table is not None else load_table()
    hit = entries.get(shape_key(op, dims, accum, dev))
    if hit is not None:
        return KernelConfig.from_dict(hit["config"])
    return KernelConfig(op=op, accum=accum)


def resolve_tuned(op: str, dims: Sequence[int], *,
                  device: Optional[str] = None,
                  table: Optional[dict] = None) -> KernelConfig:
    """The accum mode with the lower timed entry for the cell (dot when
    the table times neither), then its resolved config."""
    dev = device if device is not None else device_key()
    entries = table if table is not None else load_table()
    timed = []
    for acc in ACCUMS:
        rec = entries.get(shape_key(op, dims, acc, dev))
        if rec is not None and "t_us" in rec:
            timed.append((rec["t_us"], acc))
    accum = min(timed)[1] if timed else "dot"
    return resolve(op, dims, accum=accum, device=dev, table=entries)
