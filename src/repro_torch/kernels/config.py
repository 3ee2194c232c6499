"""KernelConfig — one frozen launch-config object for the W1A8 kernels.

Counterpart of ``repro/kernels/config.py``. Resolution turns an (op, layer
shape, accum, device) cell into a concrete config:

    exact autotune-table hit  →  nearest-shape fallback  →  heuristic

The port's table is ``kernels/AUTOTUNE_cuda.json`` beside this module,
swept on the card by ``python -m repro_torch.launch.autotune`` and keyed by
`device_key`; ``REPRO_TORCH_AUTOTUNE_TABLE`` names another file (the
port's own name for the reference's ``REPRO_AUTOTUNE_TABLE``). Every
table winner is bit-exact with the heuristic default of its accum mode
(row blocking and the pool route change the launch, not the sums; the
sweep asserts it), so resolution is a speed decision only. Configs are
resolved once per bucket and batch width (`models.yolo.kernel_configs`),
never per forward.

Whether a call runs a CUDA kernel or its plain PyTorch version is decided
by the device of the tensors it is given, never by the config.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
from typing import Dict, Optional, Sequence, Tuple

OPS = ("matmul", "conv3x3", "conv3x3_pool")
ACCUMS = ("dot", "popcount")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Launch configuration for one W1A8 kernel call.

    ``rows`` is the conv row-blocking factor: output rows (pooled rows for
    the fused kernels) one block produces; the last block of a layer may
    hold fewer. ``fused`` routes ``w1a8_conv3x3_pool`` through the fused
    conv+pool kernel (True) or the conv kernel followed by a 2×2 max
    (False). ``source`` says where the config came from ("table",
    "nearest", "heuristic", a profile's name or "manual"); it is
    provenance only, so two configs that launch alike compare and hash
    equal. All validation happens here.
    """

    op: str = "matmul"
    accum: str = "dot"
    out_step: Optional[float] = None
    rows: int = 1
    fused: bool = True
    source: str = dataclasses.field(default="manual", compare=False)

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

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KernelConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


# Shape keys: conv3x3 / conv3x3_pool dims are (h, w, cin, cout) of the input
# plane; matmul dims are (m, k, n) with batch folded into m.

def device_key() -> str:
    """The card's name in key form (``nvidia-h100-80gb-hbm3``), or "cpu"."""
    import torch
    kind = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu")
    return str(kind).strip().lower().replace(" ", "-")


def shape_key(op: str, dims: Sequence[int], accum: str,
              device: Optional[str] = None) -> str:
    dev = device if device is not None else device_key()
    return f"{op}/{'x'.join(str(int(d)) for d in dims)}/{accum}/{dev}"


def parse_key(key: str) -> Tuple[str, Tuple[int, ...], str, str]:
    op, dims, accum, dev = key.split("/", 3)
    return op, tuple(int(d) for d in dims.split("x")), accum, dev


# The port's own table: the reference's was tuned for another target.
DEFAULT_TABLE = pathlib.Path(__file__).resolve().parent / "AUTOTUNE_cuda.json"
TABLE_ENV = "REPRO_TORCH_AUTOTUNE_TABLE"

_table_cache: Dict[str, dict] = {}


def table_path() -> pathlib.Path:
    return pathlib.Path(os.environ.get(TABLE_ENV, str(DEFAULT_TABLE)))


def load_table(path: Optional[os.PathLike] = None) -> dict:
    """entries dict (key → record) from the autotune table; {} if absent."""
    p = pathlib.Path(path) if path is not None else table_path()
    ck = str(p)
    if ck not in _table_cache:
        try:
            with open(p) as f:
                _table_cache[ck] = json.load(f).get("entries", {})
        except (OSError, json.JSONDecodeError):
            _table_cache[ck] = {}
    return _table_cache[ck]


def clear_table_cache() -> None:
    _table_cache.clear()


def _shape_distance(a: Sequence[int], b: Sequence[int]) -> float:
    if len(a) != len(b):
        return math.inf
    return sum(abs(math.log(max(x, 1) / max(y, 1))) for x, y in zip(a, b))


def resolve(op: str, dims: Sequence[int], *, accum: str = "dot",
            device: Optional[str] = None,
            table: Optional[dict] = None) -> KernelConfig:
    """Table lookup → nearest-shape fallback → heuristic default.

    Nearest-shape: among entries of the same (op, accum, device), the
    least log-space distance over dims; ties break on the smaller key, so
    resolution is deterministic.
    """
    dev = device if device is not None else device_key()
    entries = table if table is not None else load_table()
    hit = entries.get(shape_key(op, dims, accum, dev))
    if hit is not None:
        return KernelConfig.from_dict({**hit["config"], "source": "table"})
    best = None
    for k, rec in entries.items():
        try:
            kop, kdims, kaccum, kdev = parse_key(k)
        except ValueError:
            continue
        if (kop, kaccum, kdev) != (op, accum, dev):
            continue
        d = _shape_distance(dims, kdims)
        if best is None or (d, k) < (best[0], best[1]):
            best = (d, k, rec)
    if best is not None and math.isfinite(best[0]):
        return KernelConfig.from_dict({**best[2]["config"],
                                       "source": "nearest"})
    return KernelConfig(op=op, accum=accum, source="heuristic")


def resolve_tuned(op: str, dims: Sequence[int], *,
                  allow_popcount: bool = True,
                  device: Optional[str] = None,
                  table: Optional[dict] = None) -> KernelConfig:
    """The accum mode with the lower timed exact entry for the cell (dot
    when the table times neither; ``allow_popcount=False`` keeps to dot),
    then that mode's resolved config."""
    dev = device if device is not None else device_key()
    entries = table if table is not None else load_table()
    accums = ACCUMS if allow_popcount else ("dot",)
    timed = []
    for acc in accums:
        rec = entries.get(shape_key(op, dims, acc, dev))
        if rec is not None and "t_us" in rec:
            timed.append((rec["t_us"], acc))
    accum = min(timed)[1] if timed else "dot"
    return resolve(op, dims, accum=accum, device=dev, table=entries)
