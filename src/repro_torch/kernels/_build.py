"""Build the CUDA kernels with nvcc and load them with ctypes.

Each source in ``csrc/`` becomes one shared library with a plain C entry
point (no PyTorch headers, so a build takes seconds). The libraries go to
``build/repro_torch/<hash>/`` at the repository root, keyed by a hash of
every source and the flags, and are built at first use: all missing sources
at once, one nvcc process each, started together. Importing this module
builds nothing.

Every wrapper also has a shape-only path: a tensor that holds no data (a
`FakeTensor` under ``FakeTensorMode``, or one on ``meta``; `shape_only`)
launches nothing and runs no plain version; the wrapper returns an empty
result of the kernel's shape and dtype. Whichever path a call takes, it
reports its work to the active `WATCHERS` (``launch.dryrun``'s counters)
through `work`: 2·M·N·K operations of the kernel's class and the bytes of
its operands and result, with the plain version's own ops hidden from the
watchers, so a traced step and a run step count alike.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence

from torch._subclasses.fake_tensor import FakeTensor

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("w1a8_matmul.cu", "w1a8_conv3x3.cu", "w1a8_conv3x3_pool2.cu",
           "w1a8_matmul_popcount.cu", "w1a8_conv3x3_popcount.cu",
           "w1a8_conv3x3_pool2_popcount.cu", "w1a8_matmul_int.cu",
           "detect_nms.cu", "w1a8_int_pe.cu")
# No --use_fast_math: the requant and the NMS IoU divide with IEEE
# rounding, as the reference does. -Xptxas -v writes registers and spills
# to the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
KERNELS: List["Kernel"] = []   # every Kernel made, in order


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build_dir() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def library_path(source: str) -> pathlib.Path:
    return build_dir() / (pathlib.Path(source).stem + ".so")


def build_all(sources: Sequence[str] = SOURCES) -> float:
    """Compiles every source whose library is missing, all in parallel.
    Returns the seconds spent; raises with nvcc's output on a failure."""
    t0 = time.perf_counter()
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        lib = library_path(src)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, lib, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for src, lib, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{src} (exit {rc}):\n"
                          + lib.with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(source: str) -> str:
    p = library_path(source).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def _load(source: str) -> ctypes.CDLL:
    with _lock:
        if source not in _libs:
            if not library_path(source).exists():
                build_all()
            _libs[source] = ctypes.CDLL(str(library_path(source)))
        return _libs[source]


class Kernel:
    """One CUDA kernel's C entry point and its launch count.

    ``launches`` is a plain int: one is added each time the kernel is
    launched and reports no error, and nowhere else, so a run can show
    that its main path went through the kernel. A call inside a CUDA graph
    capture (`capturing`) launches nothing until the graph replays it, so
    there the count moves with the replays instead. A route of another
    entry's wrapper (``share_of``) adds its launches to that entry's count
    as well: its own count is the route's share.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 share_of: "Kernel" = None):
        self.source, self.symbol = source, symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.share_of = share_of
        self._fn = None
        KERNELS.append(self)

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} launch failed with CUDA error {err}")
        self.launches += 1
        if self.share_of is not None:
            self.share_of.launches += 1


class Captured:
    """The launches one CUDA graph capture recorded, by kernel."""

    def __init__(self):
        self.counts: Dict[Kernel, int] = {}

    def replayed(self) -> None:
        """Credits one replay of the graph, which has reported no error,
        with every launch the capture recorded."""
        for kernel, n in self.counts.items():
            kernel.launches += n


class Graph:
    """A captured CUDA graph and the launches its capture recorded
    (`capturing`): each replay credits them to the kernels' counts."""

    def __init__(self, graph, launches: Captured):
        self.graph, self.launches = graph, launches

    def replay(self) -> None:
        self.graph.replay()
        self.launches.replayed()


@contextlib.contextmanager
def capturing():
    """Wraps a CUDA graph capture: yields a `Captured` that holds, on exit,
    the launches each kernel recorded inside, and leaves every count as it
    found it, since a recorded launch runs only when the graph replays."""
    before = [(k, k.launches) for k in KERNELS]
    captured = Captured()
    try:
        yield captured
    finally:
        for kernel, n in before:
            if kernel.launches != n:
                captured.counts[kernel] = kernel.launches - n
            kernel.launches = n


# Objects with ``kernel(name, flops, kind, nbytes)``, told of every wrapper
# call; `hidden` is True inside one.
WATCHERS: list = []
_depth = 0


def shape_only(t) -> bool:
    """True for a tensor that holds no data: fake or on ``meta``."""
    return t.is_meta or isinstance(t, FakeTensor)


def hidden() -> bool:
    """True while a wrapper's own work runs (its plain version's ops are
    not the watchers' to count)."""
    return _depth > 0


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


@contextlib.contextmanager
def work(name: str, flops: int, kind: str, in_bytes: int):
    """One wrapper call: the watchers get ``flops`` of ``kind`` (``int8``:
    popcount and int8 tensor-core sums; ``bf16``: the dot kernels; ``none``:
    no contraction) and the bytes of its inputs plus the result the body
    yields into the list it is given; the ops inside are hidden."""
    global _depth
    out: list = []
    _depth += 1
    try:
        yield out
    finally:
        _depth -= 1
    for w in WATCHERS:
        w.kernel(name, flops, kind, in_bytes + nbytes(*out))


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
