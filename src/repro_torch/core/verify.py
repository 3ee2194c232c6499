"""Layer-wise numerical alignment — the paper's §6.3 verification methodology.

The paper validates the RTL datapath against ONNX Runtime node-by-node with
max-abs error, mean-abs error, correlation, and %-of-outputs-within-1-LSB
(Table 6). Here the roles are:
    "RTL"  → the deployed packed path through the CUDA kernels
    "ONNX" → the float reference model (plain versions / float yolo)
and the same four statistics are produced per comparison point.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AlignmentReport:
    name: str
    max_abs: float
    mean_abs: float
    corr: float
    within_1lsb: float  # fraction in [0,1]; LSB defined by `lsb` arg
    n: int

    def row(self) -> str:
        return (f"{self.name:<28s} max_abs={self.max_abs:.6g} "
                f"mean_abs={self.mean_abs:.6g} corr={self.corr:.6f} "
                f"within_1LSB={100.0 * self.within_1lsb:.4f}%")


def compare(name: str, test: np.ndarray, ref: np.ndarray,
            lsb: float = 1.0) -> AlignmentReport:
    """Table-6 statistics for one verification target."""
    t = np.asarray(test, np.float64).ravel()
    r = np.asarray(ref, np.float64).ravel()
    assert t.shape == r.shape, (t.shape, r.shape)
    diff = np.abs(t - r)
    denom = float(np.std(t) * np.std(r))
    corr = float(np.mean((t - t.mean()) * (r - r.mean())) / denom) if denom > 0 else 1.0
    return AlignmentReport(
        name=name,
        max_abs=float(diff.max()) if t.size else 0.0,
        mean_abs=float(diff.mean()) if t.size else 0.0,
        corr=corr,
        within_1lsb=float(np.mean(diff <= lsb + 1e-12)),
        n=t.size,
    )


def print_table(reports) -> str:
    lines = ["verification target            statistics",
             "-" * 78]
    lines += [r.row() for r in reports]
    out = "\n".join(lines)
    print(out)
    return out
