#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Prints the card's name and power limit (nvidia-smi), builds the nine
   CUDA kernels from ``src/repro_torch/csrc`` with nvcc (in parallel) and
   prints the build seconds, each kernel's register use and spills and the
   count of tensor-core instructions (HMMA, HGMMA, IMMA) in each library's
   SASS (cuobjdump); the three dot libraries must hold HMMA, the three
   popcount ones, the int matmul's and the integer PE's IMMA, and no
   library may spill a register.
2. Holds each dot kernel against its plain PyTorch version on the card, at
   every W1A8 layer shape of the 320×320 detector with B = 4 and at one
   shape off its grid (B = 2, 18×18, Cin 24, Cout 40: Cin % 16 != 0, Cout
   % 32 != 0): f32 outputs within 6e-3·max|y|, uint8 codes within 1 LSB,
   the fused conv+pool kernel equal to the conv kernel plus a 2×2 max
   exactly, and results unchanged by the row blocking. The dot matmul also
   at three shapes off the grid, MATMUL_OFF_GRID (ragged M, N and K); at
   every matmul shape the rows of a call on a prefix of M, on
   ``a2[1:]`` and on a copy whose rows are not 16-byte aligned equal the
   full call's bit for bit (`row_checks`). Times each kernel,
   its plain version and one PyTorch library call at the layer shapes:
   the CUDA-event time of back-to-back calls and, for the kernel and the
   library call, the device time from torch.profiler (the union of the
   call's device intervals), which leaves out the host's cost.
3. The same for the binary domain, at every layer shape and the popcount
   convs also at the shape off the grid: each popcount kernel equal to its
   plain version (f32 outputs and codes), unchanged by `rows` 2, 3 and 4
   (each shape has a ragged last block under one of them), the fused
   popcount pool equal to the popcount conv plus a 2×2 max, and each
   popcount kernel bit-exact with the dot kernel of the layer under
   canonical operands (mul ≡ 1, div·m). The popcount matmul also at
   MATMUL_OFF_GRID, with the same row checks; at every matmul shape the int
   kernel equals its plain version and the popcount matmul's sum under
   div ≡ 1, bias ≡ 0, with the same row checks. Times each as in phase 2
   at the layer shapes (the int kernel beside ``torch._int_mm``), and
   prints each layer's device ms; then the device time of a one-element
   ``torch.add`` (the smallest launch, a floor for the kernels' times).
4. Checks that the committed autotune table
   (``src/repro_torch/kernels/AUTOTUNE_cuda.json``) holds its 22 entries
   for this card's `device_key` (else it fails, naming the key and the
   autotune command, so tuned serving never quietly equals dot) and holds
   each winner bit-exact against its accum mode's default config on the
   sweep's operands. Then drives the main path through the serving
   launcher (``repro_torch.launch.serve``: 16 random 320×320 uint8
   images, `slots=4`, `depth=2`) under ``--profile tuned`` and ``--profile
   default``, with every launch count set to 0 just before each run and
   read just after. Each dispatch is one CUDA graph replay per bucket and
   wire, and each replay adds its captured launches to the counts. The
   launcher checks zero drops, depth-K payloads bit-exact with depth 1 on
   both wires (the device-NMS wire over K ∈ {1, 2, 4, 8}), the device-NMS
   set equal to the raw-wire set, and the raw head within the
   `core.verify` envelope of the float forward; this script checks that
   the raw-wire depth-2 serve's launches equal its dispatches times the
   launches `per_dispatch` derives from the backend's resolved configs at
   320 (`DetectionBackend.configs`), and prints those configs per layer.
   It drives ``--workload multires --buckets 256,320`` on 16 requests
   (each bucket's raw heads bit-exact with the bucket served alone; at
   256 no entry is exact, so tuned serves the nearest entries' dot
   configs), counted the same way, each bucket's kernels launched, and
   profiles 8 dispatches under each profile (`launch.profile`): device
   busy, device records and idle share per dispatch.
5. Drives the popcount forward, ``yolo_forward_kernel(accum="popcount")``,
   at full width (B = 4, 320×320) on a per-channel artifact, once per pool
   route, with every launch count zeroed before and read after: launches
   (4, 4, 1) for (conv3x3_pool2_popcount, conv3x3_popcount,
   matmul_popcount) on the fused route and (0, 8, 1) on the unfused one,
   the two raw heads bit-identical and within the `core.verify` envelope of
   the float forward; once the dot forward on the fused route, counted the
   same way (4, 4, 1) for the three dot kernels, its raw head in the same
   envelope. On a per-tensor artifact the popcount and dot raw
   heads differ by less than 0.02. Then the int path: one
   `w1a8_matmul_int` call at conv9's shape on the detector's conv9 sign
   words, counted the same way and checked against the integer product.
   Prints each route's ms per forward beside the dot forward's: the
   CUDA-event time of back-to-back forwards, and from torch.profiler the
   device busy time, which excludes the host's gaps between launches.
6. The post-processing kernel (``csrc/detect_nms.cu``) and the graphs: a
   graph replay of each wire's backend equals a direct eager ``_forward``
   on the same images bit for bit, each replay launches
   ``detect_postprocess`` once and ``detect_nms`` never, and a profile of
   one dispatch gives its device records and busy ms. Both entry points,
   ``postprocess`` on the raw head and ``nms`` on ``decode_head``'s boxes,
   equal ``decode_head`` + ``nms_plain`` run on the card bit for bit: on
   the heads that replay served at 320 (and the served detections equal
   them), on a batch at 256 (G = 8, 192 boxes), on the score-separated
   fixture and on every head of ``launch/nms_fixtures.HEADS``; ``nms`` also
   on the tie fixture at both thresholds. Times the kernel, ``nms`` on the
   decoded heads, ``decode_head`` and the plain pair at the served shape
   (B = 4, 300 boxes, 20 classes) and counts the tiles of 32 ranks the
   sweep visited; no single PyTorch call computes greedy NMS.
7. The integer PE (``csrc/w1a8_int_pe.cu``, the integer golden datapath's
   one kernel, on the int8 tensor cores over signed digit planes): each of
   its entry points (W1A8, conv1, head) bit for bit against its plain
   version on the card at every layer shape of the 320 path at B = 1 and
   4 (the deployed artifact's constants and planes, random codes), off the
   grid (B = 2, 18×18, Cin 3, 16, 24, 48 and 128, ragged Cout) for every
   kind, ksize and pool it takes, with random m, mult, shift (0 included)
   and int40 biases, on overflow operands (m_raw ≈ 2^17, codes 255, every
   sign +1 at K = 1152: |acc| > 3e10, past int32, 3 planes), on m_raw of
   1 to 10 planes (INT64_MIN the tenth; numpy's int64 sum wraps from 8 on)
   at the W1A8 kind pooled and not and at the head, and on a head with
   negative values on rounding ties; times each layer at B = 4 (as in
   phase 2, beside ``F.conv2d`` in float64 on codes·m_raw, exact here) and
   prints its plane count and its device ms before the redesign (the
   int64 CUDA-core PE's, from PERF.md).
   Then drives ``yolo_forward_int`` at B = 4, 320×320 with every launch
   count zeroed before and read after: one integer PE launch per layer
   (11) and no other kernel, the int64 raw head equal to the plain
   version's on the CPU, inside the envelope of
   ``tests/test_yolo.py::test_int_pipeline_alignment`` (max_abs < 0.02,
   mean_abs < 0.002, 100% within 1 LSB of 0.02) against the float
   forward; prints its CUDA-event and device ms per forward and
   ``launch/alignment.py``'s rows (the paper's Table 6 checkpoints at 320).
8. Prints one ``{"kernels": [...]}`` line with all nine sources (each
   kernel's launches summed over the driven paths, and by path: the three
   launcher runs, phase 5's forwards and int call, phase 7's integer
   forward, phase 9's QAT pipeline, phase 10's LM serve and int call,
   phase 11's launcher fleet, real traffic and compose runs; the two
   matmuls also their numbers at the LM shapes, under ``lm``), and as the
   last line ``{"ok": true, "device": {...}}``.
9. Runs before phase 8's line: the paper's offline workflow (QAT, deploy,
   integer forward, Table 6, decode + NMS). One QAT train step at B = 2,
   320×320, on the card against the same step on the CPU from the same
   params and batch, with cuDNN's TF32 flag at its default outside the
   trainer: loss and gradient norm within rtol 1e-4, each gradient leaf
   within 1e-3·max|g| (codes that round across a tie on one side only
   forced to the CPU's, `train.ties`), which a TF32 backward would miss
   (its error is printed). Then ``launch/train_yolo_qat.train``: 30
   AdamW steps at B = 16, 320×320; the held-out loss must fall; ms a
   step (CUDA events), img/s, peak memory, and device busy ms and idle
   share a step (torch.profiler). On the trained params, each with every
   launch count zeroed before and read after: ``yolo_forward_int`` on 4
   test images (11 integer PE launches and no other kernel, bit-exact
   with the plain version, in ``tests/test_system.py``'s envelope of the
   float head: corr > 0.99, mean_abs < 0.01, 100% within 1 LSB),
   ``postprocess`` on that head (one ``detect_postprocess`` launch, bit
   for bit with ``decode_head`` + ``nms_plain`` on the card) and
   ``launch/alignment.py``'s Table 6 rows (the launches the kernel
   path's tuned configs give, and 12 integer PE launches).

10. Runs before phase 8's line: the LM stack's dense family. The popcount
   matmul, called as a packed projection calls it (one step broadcast to
   (K,), whose fold is the identity), and the int matmul through
   ``core/w1a8.py::w1a8_linear_infer_int``, each bit for bit against its
   plain version on the card at chatglm3-6b's shapes: decode (M = 4) and
   prefill (M = 4 × 3) at every (K, N) of a layer's projections, and
   (37, 13696, 2061) off the grid, with the row checks there; timed as in
   phase 3 beside f32 ``torch.matmul`` on codes·step and the unpacked ±1
   (the reference's arithmetic), the bound from K·N/8 + M·K + 4·M·N bytes.
   Then chatglm3-6b at full width from a seeded init on the card,
   deployed and served through the launcher's ``run_lm`` (packed, 8
   requests, 16 new tokens, slots 4, max_len 128) with every launch count
   zeroed before and read after: done-mask tokens equal to host-checked
   ones, and per decode step exactly one popcount matmul launch a packed
   projection (7 × 28 = 196, derived from the config) and no other
   kernel. The packed prefill logits against the unpacked ``w1a8_eval``
   prefill on the card, tie codes forced (`train.ties`): within
   LM_TOL·max|logit|, greedy tokens equal wherever the top-2 gap exceeds
   that. One ``w1a8_linear_infer_int`` call, counted the same way (one int
   matmul launch), its sums equal to an int64 product on the CPU. Prints
   tok/s, tick p50/p95, the decode step's CUDA-event ms, device busy ms,
   idle share (torch.profiler) and bound, and peak memory, with the card's
   name and power limit.

11. Runs before phase 8's line: the serving tiers above one backend, each
   with every launch count zeroed just before and read just after. (a) The
   launcher's ``detect`` at 320, tuned, ``--requests 512 --replicas 2
   --autoscale --out`` (a file under ``build/``): the launcher checks the
   fleet's payloads bit-exact with the single-scheduler device-NMS run, 0
   lost and 0 dropped; here each kernel's launches in the fleet run equal
   the dispatches summed over the replicas times `per_dispatch`. (b)
   ``launch.traffic --mode real`` at 320, 2 replicas, 256 requests: equal
   completed sets and payloads bit-exact with one replica, launches equal
   to both runs' dispatches times `per_dispatch`; prints img/s of each.
   (c) ``traffic.run_model`` at 2000 requests a cell, calibrated from
   (a)'s record: 0 lost in all 12 cells; prints the calibration and the
   SLO in ticks. (d) The launcher's ``run_compose`` at 320 with
   chatglm3-6b at full width on phase 10's f32 params (float mode, 8
   requests, 16 greedy tokens, slots 4): 0 lost, 0 duplicated, 8 hand-offs,
   prompts equal to the template, detect launches equal to its
   dispatches times `per_dispatch`; prints ticks, wall s and peak memory.

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
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
CANONICAL_M = 0.05             # the uniform step of the canonical operands
OFF_GRID = (2, 18, 18, 24, 40)  # (B, H, W, Cin, Cout) off the detector's grid
# (M, K, N) off the grid: ragged M, N and K; K % 16 != 0 (byte gathers),
# K % 32 == 16 (a half-filled last span of 16-byte loads)
MATMUL_OFF_GRID = ((5, 70, 12), (33, 200, 64), (40, 176, 40))
ROWS = (2, 3, 4)               # popcount row blockings; each shape has a
                               # ragged last block under one of them
TENSOR_CORE_OPS = ("HMMA", "HGMMA", "IMMA")

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "w1a8_conv3x3_pool2": ("src/repro_torch/csrc/w1a8_conv3x3_pool2.cu",
                           "src/repro/kernels/w1a8_conv/fused_pool.py:72"),
    "w1a8_conv3x3": ("src/repro_torch/csrc/w1a8_conv3x3.cu",
                     "src/repro/kernels/w1a8_conv/kernel.py:80"),
    "w1a8_matmul": ("src/repro_torch/csrc/w1a8_matmul.cu",
                    "src/repro/kernels/w1a8_matmul/kernel.py:168"),
    "w1a8_conv3x3_pool2_popcount": (
        "src/repro_torch/csrc/w1a8_conv3x3_pool2_popcount.cu",
        "src/repro/kernels/w1a8_conv/fused_pool.py:56"),
    "w1a8_conv3x3_popcount": (
        "src/repro_torch/csrc/w1a8_conv3x3_popcount.cu",
        "src/repro/kernels/w1a8_conv/kernel.py:63"),
    "w1a8_matmul_popcount": (
        "src/repro_torch/csrc/w1a8_matmul_popcount.cu",
        "src/repro/kernels/w1a8_matmul/kernel.py:135"),
    "w1a8_matmul_int": ("src/repro_torch/csrc/w1a8_matmul_int.cu",
                        "src/repro/kernels/w1a8_matmul/kernel.py:228"),
    # the counterpart of the reference's jitted postprocess (decode_head and
    # a lax.fori_loop NMS), which is no Pallas kernel
    "detect_postprocess": ("src/repro_torch/csrc/detect_nms.cu",
                           "src/repro/models/detection.py:90"),
    # the counterpart of the reference's numpy int64 yolo_forward_int, which
    # is no Pallas kernel
    "w1a8_int_pe": ("src/repro_torch/csrc/w1a8_int_pe.cu",
                    "src/repro/models/yolo.py:323"),
}
DOT = ("w1a8_conv3x3_pool2", "w1a8_conv3x3", "w1a8_matmul")
# name: the tensor-core instruction its library's SASS must hold
TENSOR_CORE_KERNELS = {
    "w1a8_conv3x3_pool2": "HMMA", "w1a8_conv3x3": "HMMA",
    "w1a8_matmul": "HMMA", "w1a8_conv3x3_pool2_popcount": "IMMA",
    "w1a8_conv3x3_popcount": "IMMA", "w1a8_matmul_popcount": "IMMA",
    "w1a8_matmul_int": "IMMA", "w1a8_int_pe": "IMMA"}
PROFILES = ("tuned", "default")  # the launcher's --profile, both driven
AUTOTUNE_CMD = "PYTHONPATH=src python -m repro_torch.launch.autotune --batch 4"
WINNERS = 22                   # 11 cells x 2 accum modes in the table
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
NMS_IOU_OPS = 15               # float ops of one IoU and its suppression test
# popcount forward, per route: (pool2_popcount, conv3x3_popcount,
# matmul_popcount) launches of one forward
POPCOUNT = ("w1a8_conv3x3_pool2_popcount", "w1a8_conv3x3_popcount",
            "w1a8_matmul_popcount")
PER_FORWARD = {True: (4, 4, 1), False: (0, 8, 1)}
INT_PE = "w1a8_int_pe"
INT_BATCHES = (1, 4)           # the integer PE's per-layer checks
# (Cin, Cout) off the detector's grid: Cin % 16 != 0 (3, 24: the pair of
# units spans taps), 16, 48 and 128; Cout ragged against the warp tiles
INT_OFF_GRID = ((3, 16), (16, 20), (24, 40), (48, 33), (128, 75))
# the integer PE's device ms a layer and a forward at B = 4, 320×320 before
# its redesign, on the CUDA cores in int64 (PERF.md §6, NVIDIA H100 80GB
# HBM3, 700.00 W)
INT_BEFORE_DEVICE_MS = {
    "conv1": 0.2016, "conv2": 0.1462, "conv3": 0.1562, "conv4": 0.1864,
    "conv5": 0.1870, "conv6": 0.1878, "conv7": 0.1941, "conv8": 0.1227,
    "conv9": 0.0274, "conv10": 0.0628, "conv11": 0.0191, "forward": 1.4925}
# int head against the float head: tests/test_yolo.py's
# test_int_pipeline_alignment (max_abs, mean_abs; 100% within 1 LSB of 0.02)
INT_ENVELOPE = (0.02, 0.002)
QAT_PARITY_BATCH = 2           # phase 9's one step on the card and the CPU
QAT_BATCH, QAT_STEPS = 16, 30  # phase 9's training run at 320×320
LM_ARCH = "chatglm3-6b"        # phase 10's LM, at full width
LM_SLOTS, LM_PROMPT = 4, 3     # the launcher's slots and prompt length
LM_REQUESTS, LM_MAX_NEW, LM_MAX_LEN = 8, 16, 128
# packed against unpacked prefill logits at 28 layers, K up to 13696, tie
# codes forced: the unpacked path sums code·step·sign in f32 (about 1e-7
# relative a rounding, |Σ| some sqrt(K) ≈ 117 times below Σ|·| at random
# signs) where the packed one sums exactly, at each of 252 projections;
# the CPU tests hold 1e-4 at 2 layers and K ≤ 128
LM_TOL = 1e-3


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


def bound(nbytes: int, ops: int, ops_per_s: float = BF16_OPS_PER_S) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tensor_core_counts(_build) -> dict:
    """Phase 1: tensor-core instructions in each library's SASS, by name
    of its kernel; raises if a tensor-core kernel's library has none of its
    kind or any library's build log (ptxas -v) reports a spill."""
    import re
    tool = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    counts = {}
    for name, (source, _) in KERNELS.items():
        lib = _build.library_path(pathlib.Path(source).name)
        sass = subprocess.run([str(tool), "--dump-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass))
                        for op in TENSOR_CORE_OPS}
        print(f"[sass] {lib.name}: " + ", ".join(
            f"{n} {op}" for op, n in counts[name].items()), flush=True)
    for name, (source, _) in KERNELS.items():
        op = TENSOR_CORE_KERNELS.get(name)
        if op and not counts[name][op]:
            raise AssertionError(f"{name}: no {op} instruction in its SASS")
        log = _build.build_log(pathlib.Path(source).name)
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", log)
        if not spills or any(int(n) for n in spills):
            raise AssertionError(f"{name}: spills registers or its build "
                                 f"log is missing: {spills}")
    return counts


def layer_operands(torch, np, rng, b, h, cin, cout, dev, *, ksize=3):
    a = torch.from_numpy(rng.integers(0, 256, (b, h, h, cin),
                                      dtype=np.uint8)).to(dev)
    w = rng.standard_normal((ksize * ksize * cin, cout)).astype(np.float32)
    mul = rng.uniform(0.01, 0.1, cin).astype(np.float32)
    div = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return a, torch.from_numpy(w).to(dev), *(torch.from_numpy(x).to(dev)
                                             for x in (mul, div, bias))


def matmul_operands(torch, np, rng, m, k, n, dev):
    """(m, k) codes, (k, n) float weights, Mul_prev, Div and bias."""
    a = torch.from_numpy(rng.integers(0, 256, (m, k), dtype=np.uint8))
    w = rng.standard_normal((k, n)).astype(np.float32)
    mul = rng.uniform(0.01, 0.1, k).astype(np.float32)
    div = rng.uniform(0.5, 1.5, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return a.to(dev), *(torch.from_numpy(x).to(dev)
                        for x in (w, mul, div, bias))


def unaligned(torch, x):
    """A copy of the uint8 tensor ``x`` whose data starts one byte past a
    16-byte boundary, so that no row of it is 16-byte aligned."""
    buf = torch.empty(x.numel() + 32, dtype=torch.uint8, device=x.device)
    off = (1 - buf.data_ptr()) % 16
    y = buf[off:off + x.numel()].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 == 1
    return y


def row_checks(torch, run, a2, full, what: str) -> None:
    """Raises unless the rows of ``run`` on a prefix of M (several lengths,
    so several launch geometries), on ``a2[1:]`` (whose row pointer is not
    16-byte aligned where K % 16 != 0) and on an unaligned copy of ``a2``
    equal the same rows of ``full`` = run(a2) bit for bit."""
    m = a2.shape[0]
    for mp in sorted({1, min(17, m), m // 2, m - 1} - {0}):
        _exact(torch, run(a2[:mp]), full[:mp], f"{what} rows [:{mp}]")
    if m > 1:
        _exact(torch, run(a2[1:]), full[1:], f"{what} rows [1:]")
    _exact(torch, run(unaligned(torch, a2)), full, f"{what} unaligned")


def dot_matmul_case(torch, a2, wp, mul, div, bias, k, note, what):
    """Phase 2 on one matmul operand set: the dot matmul within 6e-3·max|y|
    (f32) and 1 LSB (codes) of its plain version, and `row_checks` on
    both. Returns (y, y_ref, q, q_ref, step)."""
    from repro_torch.kernels.config import KernelConfig
    from repro_torch.kernels.w1a8_matmul import ops as mm_ops
    from repro_torch.kernels.w1a8_matmul import ref as mm_ref

    def run(c):
        return lambda x: mm_ops.w1a8_matmul(x, wp, mul, div, bias, k=k,
                                            config=c)
    y_ref = mm_ref.w1a8_matmul_ref(a2, wp, k, mul, div, bias)
    y = run(None)(a2)
    step = float(y_ref.abs().max()) / 255.0
    cfg = KernelConfig(op="matmul", out_step=step)
    q = run(cfg)(a2)
    q_ref = mm_ref.w1a8_matmul_ref(a2, wp, k, mul, div, bias, step)
    torch.cuda.synchronize()
    err, tol = note("w1a8_matmul", y, y_ref), 6e-3 * float(y_ref.abs().max())
    codes = note("w1a8_matmul", q, q_ref)
    if err > tol or codes > 1:
        raise AssertionError(f"{what}: dot matmul f32 err {err} > {tol} or "
                             f"codes differ by {codes} > 1 LSB")
    row_checks(torch, run(None), a2, y, f"{what} dot matmul f32")
    row_checks(torch, run(cfg), a2, q, f"{what} dot matmul codes")
    return y, y_ref, q, q_ref, step


def check_kernels(torch, np, dev) -> tuple:
    """Phase 2: every dot kernel against its plain version at the main path's
    shapes, and the conv kernels at OFF_GRID. Returns the per-layer records,
    the off-grid record and, per kernel, the worst codes difference and f32
    error over every call that launched it."""
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
    layers, off_grid = [], None
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
    cases = [(spec.name, BATCH, sizes[spec.name], spec.cin, spec.cout,
              spec.ksize, spec.pool)
             for spec in yolo.YOLO_LAYERS if spec.kind == "w1a8"]
    b, h, _, cin, cout = OFF_GRID
    cases.append(("off_grid", b, h, cin, cout, 3, True))
    for name, b, h, cin, cout, ksize, pool in cases:
        a, w, mul, div, bias = layer_operands(torch, np, rng, b, h, cin,
                                              cout, dev, ksize=ksize)
        rec = {"layer": name, "shape": [b, h, h, cin, cout]}
        if ksize == 1:
            rec["kernel"] = "w1a8_matmul"
            a2 = a.reshape(-1, cin)
            wp = mm_ops.w1a8_pack_weights(w)
            y, y_ref, q, q_ref, step = dot_matmul_case(
                torch, a2, wp, mul, div, bias, cin, note, name)
            cfg = KernelConfig(op="matmul", out_step=step)
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
                raise AssertionError(f"{name}: conv3x3 rows=2 differs")
            ops = 2 * b * h * h * 9 * cin * cout
            a_bf = mm_ref.bf16_prologue(a, mul).to(torch.bfloat16) \
                .permute(0, 3, 1, 2).contiguous()
            w_bf = torch.where(w >= 0, 1.0, -1.0).reshape(3, 3, cin, cout) \
                .permute(3, 2, 0, 1).contiguous().to(torch.bfloat16)
            library = lambda: F.conv2d(a_bf, w_bf, padding=1)  # noqa: E731
            in_bytes = a.numel() + wp.numel() * 4 + 4 * cin + 8 * cout
            if pool:
                rec["kernel"] = "w1a8_conv3x3_pool2"
                p = fused_pool.w1a8_conv3x3_pool2(a, wp, mul, div, bias,
                                                  cin=cin, out_step=step)
                p_ref = conv_ref.w1a8_conv3x3_pool2_ref(a, wp, cin, mul, div,
                                                        bias, step)
                if not torch.equal(p, conv_ref.maxpool2_codes(q)):
                    raise AssertionError(
                        f"{name}: fused pool != conv3x3 kernel + max")
                p_rows = fused_pool.w1a8_conv3x3_pool2(
                    a, wp, mul, div, bias, cin=cin, out_step=step, rows=2)
                if not torch.equal(p_rows, p):
                    raise AssertionError(f"{name}: pool rows=2 differs")
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
        base = "w1a8_matmul" if ksize == 1 else "w1a8_conv3x3"
        scale = float(y_ref.abs().max())
        rec["f32_max_abs_err"] = note(base, y, y_ref)
        rec["f32_tol"] = 6e-3 * scale
        rec["codes_max_diff"] = note(base, q, q_ref)
        rec["codes_identical"] = float((q == q_ref).float().mean())
        if rec["f32_max_abs_err"] > rec["f32_tol"]:
            raise AssertionError(f"{name}: f32 error {rec}")
        if rec["codes_max_diff"] > 1 or rec.get("pool_codes_max_diff", 0) > 1:
            raise AssertionError(f"{name}: codes differ by > 1 LSB {rec}")
        if name == "off_grid":
            off_grid = rec
            print(f"[check] off the grid {rec['shape']}: conv3x3 and "
                  f"conv3x3_pool2 codes max diff {rec['codes_max_diff']}, "
                  f"{rec['pool_codes_max_diff']} "
                  f"({100 * rec['codes_identical']:.3f}% identical), f32 "
                  f"err {rec['f32_max_abs_err']:.3g} <= "
                  f"{rec['f32_tol']:.3g}; fused = conv + max and rows=2 "
                  f"exact", flush=True)
            continue
        rec["ms"] = cuda_ms(torch, run)
        rec["plain_ms"] = cuda_ms(torch, plain, reps=3, n=3)
        rec["library_ms"] = cuda_ms(torch, library)
        rec["device_ms"] = device_profile(torch, run)["device_busy_ms"]
        rec["library_device_ms"] = device_profile(torch,
                                                  library)["device_busy_ms"]
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops)
        rec["bytes"], rec["ops"] = nbytes, ops
        print(f"[check] {name} {rec['kernel']} {rec['shape']}: codes "
              f"max diff {rec['codes_max_diff']} "
              f"({100 * rec['codes_identical']:.3f}% identical), f32 err "
              f"{rec['f32_max_abs_err']:.3g} <= {rec['f32_tol']:.3g}; "
              f"{rec['ms']:.4f} ms, device {rec['device_ms']:.4f} ms (plain "
              f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f}, "
              f"device {rec['library_device_ms']:.4f}, bound "
              f"{rec['bound_ms']:.5f} by {rec['bound_by']})", flush=True)
        layers.append(rec)
    for m, k, n in MATMUL_OFF_GRID:
        a2, w, mul, div, bias = matmul_operands(torch, np, rng, m, k, n, dev)
        dot_matmul_case(torch, a2, mm_ops.w1a8_pack_weights(w), mul, div,
                        bias, k, note, f"off the grid {(m, k, n)}")
    print(f"[check] dot matmul off the grid {list(MATMUL_OFF_GRID)} and at "
          f"conv9: within the tolerances; rows of prefixes of M, of a2[1:] "
          f"and of unaligned rows bit-exact with the full call", flush=True)
    return layers, off_grid, errs


def _exact(torch, got, want, what: str) -> float:
    """Raises unless ``got`` equals ``want`` bit for bit, NaN where it is
    NaN; returns the largest absolute difference (0.0 when it returns)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    same = got == want
    if got.is_floating_point():
        same |= got.isnan() & want.isnan()
    if not bool(same.all()):
        diff = float((got.double() - want.double()).abs().max())
        raise AssertionError(f"{what}: not bit-exact (max diff {diff})")
    return 0.0


def check_popcount_kernels(torch, np, dev, size: int = None) -> tuple:
    """Phase 3: the popcount kernels and the int kernel at every W1A8 layer
    shape, exactly against their plain versions and, under canonical
    operands, against the dot kernels. Returns the per-layer records and,
    per kernel, the largest difference over every check (0 when it
    returns)."""
    import torch.nn.functional as F
    from repro_torch.core import packing
    from repro_torch.kernels.config import KernelConfig
    from repro_torch.kernels.w1a8_conv import fused_pool
    from repro_torch.kernels.w1a8_conv import ops as conv_ops
    from repro_torch.kernels.w1a8_conv import ref as conv_ref
    from repro_torch.kernels.w1a8_matmul import ops as mm_ops
    from repro_torch.kernels.w1a8_matmul import ref as mm_ref
    from repro_torch.models import yolo

    MM, INT = "w1a8_matmul_popcount", "w1a8_matmul_int"
    CONV, POOL = "w1a8_conv3x3_popcount", "w1a8_conv3x3_pool2_popcount"
    rng = np.random.default_rng(SEED + 1)
    sizes = yolo.spatial_sizes(size or yolo.INPUT_SIZE)
    records = []
    errs = {name: 0.0 for name in (MM, INT, CONV, POOL)}

    def exact(kernel, got, want, what):
        errs[kernel] = max(errs[kernel], _exact(torch, got, want, what))

    def conv_checks(name, a, wp, div, bias, cin, pooled):
        """The popcount conv (and, where ``pooled``, the fused pool) on
        one layer's operands, exactly against the plain versions, across
        `rows`, against conv + max and against dot under canonical
        operands. Returns the requant step, the conv codes and the fused
        pool's call (None where not pooled)."""
        # canonical operands: a uniform step m̄ against mul ≡ 1 and div·m̄
        cin_ones = torch.ones(cin, device=dev)
        mul_m = torch.full((cin,), CANONICAL_M, device=dev)
        div_m = div * torch.tensor(CANONICAL_M, device=dev)
        cfg = KernelConfig(op="conv3x3", accum="popcount")

        def conv(mul, d, c, fn=conv_ops.w1a8_conv3x3):
            return fn(a, wp, mul, d, bias, cin=cin, config=c)
        y = conv(None, div, cfg)
        exact(CONV, y, conv_ref.w1a8_conv3x3_popcount_ref(
            a, wp, cin, div, bias), f"{name} conv f32")
        step = float(y.abs().max()) / 255.0
        qcfg = cfg.replace(out_step=step)
        q = conv(None, div, qcfg)
        exact(CONV, q, conv_ref.w1a8_conv3x3_popcount_ref(
            a, wp, cin, div, bias, step), f"{name} conv codes")
        for rows in ROWS:
            exact(CONV, conv(None, div, qcfg.replace(rows=rows)), q,
                  f"{name} conv rows={rows}")
        for c in (cfg, qcfg):
            exact(CONV, conv(mul_m, div, c),
                  conv(cin_ones, div_m, c.replace(accum="dot")),
                  f"{name} conv popcount vs dot")
        if not pooled:
            return step, q, None

        def pool(rows=1):
            return fused_pool.w1a8_conv3x3_pool2(
                a, wp, None, div, bias, cin=cin, out_step=step,
                accum="popcount", rows=rows)
        p = pool()
        exact(POOL, p, conv_ref.w1a8_conv3x3_pool2_popcount_ref(
            a, wp, cin, div, bias, step), f"{name} pool codes")
        exact(POOL, p, conv_ref.maxpool2_codes(q),
              f"{name} fused pool vs conv + max")
        for rows in ROWS:
            exact(POOL, pool(rows), p, f"{name} pool rows={rows}")
        pcfg = KernelConfig(op="conv3x3_pool", accum="popcount",
                            out_step=step)
        exact(POOL, conv(mul_m, div, pcfg, conv_ops.w1a8_conv3x3_pool),
              conv(cin_ones, div_m, pcfg.replace(accum="dot"),
                   conv_ops.w1a8_conv3x3_pool),
              f"{name} pool popcount vs dot")
        return step, q, pool

    def matmul_checks(a2, wp, div, bias, k, name):
        """The popcount matmul on one operand set, exactly: against its
        plain version (f32 and codes), against the dot matmul under
        canonical operands, and its sum under div ≡ 1, bias ≡ 0 against
        the int kernel, which is held against its plain version; then
        `row_checks`. Returns the call, the requant step, the signs and
        their column sums."""
        n = wp.shape[1]
        ones = torch.ones(k, device=dev)
        mul_m = torch.full((k,), CANONICAL_M, device=dev)
        div_m = div * torch.tensor(CANONICAL_M, device=dev)
        cfg = KernelConfig(op="matmul", accum="popcount")

        def mm(x, d, c, mul=None):
            return mm_ops.w1a8_matmul(x, wp, mul, d, bias, k=k, config=c)
        y = mm(a2, div, cfg)
        exact(MM, y, mm_ref.w1a8_matmul_popcount_ref(a2, wp, k, div, bias),
              f"{name} matmul f32")
        step = float(y.abs().max()) / 255.0
        qcfg = cfg.replace(out_step=step)
        q = mm(a2, div, qcfg)
        exact(MM, q, mm_ref.w1a8_matmul_popcount_ref(a2, wp, k, div, bias,
                                                     step),
              f"{name} matmul codes")
        for c in (cfg, qcfg):
            exact(MM, mm(a2, div, c, mul_m),
                  mm(a2, div_m, c.replace(accum="dot"), ones),
                  f"{name} matmul popcount vs dot")
        signs = packing.unpack_signs(wp, k, dtype=torch.float32)
        colsum = signs.sum(dim=0).to(torch.int32)
        yi = mm_ops.w1a8_matmul_int(a2, wp, colsum)
        exact(INT, yi, mm_ref.w1a8_matmul_int_ref(a2, wp, colsum),
              f"{name} int")
        sums = mm_ops.w1a8_matmul(a2, wp, None, torch.ones(n, device=dev),
                                  torch.zeros(n, device=dev), k=k, config=cfg)
        exact(INT, yi.to(torch.float32), sums, f"{name} int vs popcount sum")
        row_checks(torch, lambda x: mm_ops.w1a8_matmul_int(x, wp, colsum), a2,
                   yi, f"{name} int")
        row_checks(torch, lambda x: mm(x, div, cfg), a2, y,
                   f"{name} popcount matmul f32")
        row_checks(torch, lambda x: mm(x, div, qcfg), a2, q,
                   f"{name} popcount matmul codes")
        return mm, step, signs, colsum

    for spec in yolo.YOLO_LAYERS:
        if spec.kind != "w1a8":
            continue
        first = len(records)
        h, cin, cout = sizes[spec.name], spec.cin, spec.cout
        name = spec.name
        a, w, _, div, bias = layer_operands(torch, np, rng, BATCH, h, cin,
                                            cout, dev, ksize=spec.ksize)
        shape = [BATCH, h, h, cin, cout]
        if spec.ksize == 1:
            a2 = a.reshape(-1, cin)
            m = a2.shape[0]
            wp = mm_ops.w1a8_pack_weights(w)
            mm, step, signs, colsum = matmul_checks(a2, wp, div, bias, cin,
                                                    name)
            qcfg = KernelConfig(op="matmul", accum="popcount", out_step=step)
            ops = 2 * m * cin * cout
            nbytes = m * cin + wp.numel() * 4 + 8 * cout + m * cout
            a_bf, s_bf = a2.to(torch.bfloat16), signs.to(torch.bfloat16)
            records.append(dict(
                layer=name, kernel=MM, shape=shape,
                run=lambda: mm(a2, div, qcfg),
                plain=lambda: mm_ref.w1a8_matmul_popcount_ref(
                    a2, wp, cin, div, bias, step),
                library=lambda: torch.matmul(a_bf, s_bf),
                bound=bound(nbytes, ops, INT8_OPS_PER_S), bytes=nbytes,
                ops=ops))
            nbytes = m * cin + wp.numel() * 4 + 4 * cout + 4 * m * cout
            a8 = (a2.to(torch.int16) - 128).to(torch.int8)
            s8 = signs.to(torch.int8)
            records.append(dict(
                layer=name, kernel=INT, shape=shape,
                run=lambda: mm_ops.w1a8_matmul_int(a2, wp, colsum),
                plain=lambda: mm_ref.w1a8_matmul_int_ref(a2, wp, colsum),
                library=lambda: torch._int_mm(a8, s8),
                bound=bound(nbytes, ops, INT8_OPS_PER_S), bytes=nbytes,
                ops=ops))
        else:
            wp = conv_ops.conv_pack_weights(w.reshape(3, 3, cin, cout))
            step, q, pool = conv_checks(name, a, wp, div, bias, cin,
                                        spec.pool)
            qcfg = KernelConfig(op="conv3x3", accum="popcount",
                                out_step=step)
            ops = 2 * BATCH * h * h * 9 * cin * cout
            in_bytes = a.numel() + wp.numel() * 4 + 8 * cout
            a_bf = a.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous()
            w_bf = torch.where(w >= 0, 1.0, -1.0).reshape(3, 3, cin, cout) \
                .permute(3, 2, 0, 1).contiguous().to(torch.bfloat16)
            library = lambda: F.conv2d(a_bf, w_bf, padding=1)  # noqa: E731
            if spec.pool:
                nbytes = in_bytes + q.numel() // 4
                records.append(dict(
                    layer=name, kernel=POOL, shape=shape, run=pool,
                    plain=lambda: conv_ref.w1a8_conv3x3_pool2_popcount_ref(
                        a, wp, cin, div, bias, step),
                    library=library, bound=bound(nbytes, ops, INT8_OPS_PER_S),
                    bytes=nbytes, ops=ops))
            else:
                nbytes = in_bytes + q.numel()
                records.append(dict(
                    layer=name, kernel=CONV, shape=shape,
                    run=lambda: conv_ops.w1a8_conv3x3(
                        a, wp, None, div, bias, cin=cin, config=qcfg),
                    plain=lambda: conv_ref.w1a8_conv3x3_popcount_ref(
                        a, wp, cin, div, bias, step),
                    library=library, bound=bound(nbytes, ops, INT8_OPS_PER_S),
                    bytes=nbytes, ops=ops))
        torch.cuda.synchronize()
        for rec in records[first:]:
            run, library = rec.pop("run"), rec.pop("library")
            rec["ms"] = cuda_ms(torch, run)
            rec["plain_ms"] = cuda_ms(torch, rec.pop("plain"), reps=2, n=2)
            rec["library_ms"] = cuda_ms(torch, library)
            rec["device_ms"] = device_profile(torch, run)["device_busy_ms"]
            rec["library_device_ms"] = device_profile(
                torch, library)["device_busy_ms"]
            rec["bound_ms"], rec["bound_by"] = rec.pop("bound")
            print(f"[popcount] {rec['layer']} {rec['kernel']} "
                  f"{rec['shape']}: bit-exact with its plain version and "
                  f"the dot kernel; {rec['ms']:.4f} ms, device "
                  f"{rec['device_ms']:.4f} ms (plain {rec['plain_ms']:.4f}, "
                  f"library {rec['library_ms']:.4f}, device "
                  f"{rec['library_device_ms']:.4f}, bound "
                  f"{rec['bound_ms']:.6f} by {rec['bound_by']})",
                  flush=True)

    # off the detector's grid: Cin % 16 != 0, Cout % 32 != 0
    b, h, _, cin, cout = OFF_GRID
    a, w, _, div, bias = layer_operands(torch, np, rng, b, h, cin, cout, dev)
    conv_checks("off_grid", a,
                conv_ops.conv_pack_weights(w.reshape(3, 3, cin, cout)), div,
                bias, cin, True)
    print(f"[popcount] off the grid {list(OFF_GRID)}: conv3x3_popcount and "
          f"conv3x3_pool2_popcount bit-exact with their plain versions, "
          f"with conv + max, across rows {ROWS} and with the dot kernels",
          flush=True)
    for m, k, n in MATMUL_OFF_GRID:
        a2, w, _, div, bias = matmul_operands(torch, np, rng, m, k, n, dev)
        matmul_checks(a2, mm_ops.w1a8_pack_weights(w), div, bias, k,
                      f"off the grid {(m, k, n)}")
    print(f"[popcount] matmul off the grid {list(MATMUL_OFF_GRID)} and at "
          f"conv9: bit-exact with its plain version, with the dot matmul "
          f"and with the int kernel's sum; rows of prefixes of M, of a2[1:] "
          f"and of unaligned rows bit-exact with the full call", flush=True)
    return records, errs


# the measurements whose every trace lost device activity, timed with CUDA
# events instead (`events_profile`)
TRACE_FALLBACKS = []


def device_profile(torch, fn, n: int = 10, tries: int = 5) -> dict:
    """torch.profiler over ``n`` calls of ``fn`` after a warm one: device
    busy ms per call (the union of the traced device intervals), host ms per
    call (profiled, so above the unprofiled time) and device launches per
    call. Every call launches at least one kernel, so a trace with fewer
    device events than calls has lost some, as one now and then does; it is
    taken again, up to ``tries`` times, and then `events_profile` times the
    calls."""
    from repro_torch.launch.profile import union_us
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(events) >= n:
            break
    else:
        return events_profile(torch, fn, n, tries)
    busy_us = union_us((e.time_range.start, e.time_range.end)
                       for e in events)
    return {"device_busy_ms": busy_us / 1e3 / n, "wall_ms": wall_ms / n,
            "device_launches": len(events) / n,
            "device_timing": "torch.profiler"}


def events_profile(torch, fn, n: int, tries: int) -> dict:
    """Where ``tries`` traces lost device activity (CUPTI may record
    nothing in a process): CUDA-event ms per call over ``n`` calls, which
    bounds the device busy time from above, and host ms per call; device
    launches are not measured (None). Noted in `TRACE_FALLBACKS` and
    printed."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    TRACE_FALLBACKS.append(getattr(fn, "__qualname__", repr(fn)))
    print(f"[profile] {tries} traces lost device activity: CUDA events "
          f"instead (device launches not measured)", flush=True)
    return {"device_busy_ms": start.elapsed_time(end) / n,
            "wall_ms": wall_ms / n, "device_launches": None,
            "device_timing": "cuda events"}


def _num(x, spec: str) -> str:
    """``x`` formatted by ``spec``, or "not measured" where it is None."""
    return "not measured" if x is None else format(x, spec)


def _zero(kernels) -> None:
    for k in kernels.values():
        k.launches = 0


def drive_popcount(torch, np, dev, size: int = None) -> dict:
    """Phase 5: the popcount forward at full width on a per-channel
    artifact, once per pool route, and the int path; every launch count
    zeroed just before each run and read just after. Returns the record
    with the popcount kernels' and the int kernel's launches."""
    from repro_torch.core import packing, verify
    from repro_torch.kernels.w1a8_matmul import ops as mm_ops
    from repro_torch.launch import serve as launch
    from repro_torch.models import yolo

    size = size or yolo.INPUT_SIZE
    rng = np.random.default_rng(SEED + 2)
    imgs = torch.from_numpy(rng.integers(0, 256, (BATCH, size, size, 3),
                                         dtype=np.uint8)).to(dev) \
        .to(torch.float32) / 256.0
    params, art = yolo.build_detector(SEED, imgs, device=dev)
    with torch.no_grad():
        ref = yolo.yolo_forward_float(params, imgs).cpu().numpy()
    launches = {name: 0 for name in POPCOUNT}
    raws, record = {}, {"routes": {}}
    for fused in (True, False):
        configs = yolo.kernel_configs(art, size, BATCH, accum="popcount",
                                      fuse_pool=fused)
        _zero(launch.KERNELS)
        with torch.no_grad():
            raws[fused] = yolo.yolo_forward_kernel(art, imgs,
                                                   configs=configs)
        torch.cuda.synchronize()
        counts = launch.launch_counts()
        got = tuple(counts[name] for name in POPCOUNT)
        if got != PER_FORWARD[fused] or any(
                counts[name] for name in DOT + ("w1a8_matmul_int",)):
            raise AssertionError(f"popcount forward fused={fused}: launches "
                                 f"{counts}, want {PER_FORWARD[fused]}")
        for name in POPCOUNT:
            launches[name] += counts[name]
        rep = verify.compare("popcount_vs_float", raws[fused].cpu().numpy(),
                             ref, lsb=0.02)
        if not (rep.max_abs < 0.02 and rep.within_1lsb == 1.0):
            raise AssertionError(f"popcount raw head fused={fused} outside "
                                 f"the envelope: {rep.row()}")
        with torch.no_grad():
            forward = lambda: yolo.yolo_forward_kernel(  # noqa: E731
                art, imgs, configs=configs)
            ms = cuda_ms(torch, forward, reps=5, n=10)
            prof = device_profile(torch, forward)
        record["routes"]["fused" if fused else "unfused"] = {
            "launches": dict(zip(POPCOUNT, got)), "ms_per_forward": ms,
            "profile": prof, "max_abs": rep.max_abs,
            "within_1lsb": rep.within_1lsb}
    _exact(torch, raws[True], raws[False], "popcount fused vs unfused route")
    dot_configs = yolo.kernel_configs(art, size, BATCH, accum="dot",
                                      fuse_pool=True)
    _zero(launch.KERNELS)
    with torch.no_grad():
        dot_raw = yolo.yolo_forward_kernel(art, imgs, configs=dot_configs)
    torch.cuda.synchronize()
    counts = launch.launch_counts()
    record["dot_launches"] = {name: counts[name] for name in DOT}
    if tuple(record["dot_launches"].values()) != PER_FORWARD[True] or any(
            counts[name] for name in POPCOUNT + ("w1a8_matmul_int",)):
        raise AssertionError(f"dot forward: launches {counts}, want "
                             f"{PER_FORWARD[True]}")
    rep = verify.compare("dot_vs_float", dot_raw.cpu().numpy(), ref,
                         lsb=0.02)
    if not (rep.max_abs < 0.02 and rep.within_1lsb == 1.0):
        raise AssertionError(f"dot raw head outside the envelope: "
                             f"{rep.row()}")
    with torch.no_grad():
        forward = lambda: yolo.yolo_forward_kernel(  # noqa: E731
            art, imgs, configs=dot_configs)
        record["dot_ms_per_forward"] = cuda_ms(torch, forward, reps=5, n=10)
        record["dot_profile"] = device_profile(torch, forward)

    # per-tensor artifact: popcount and dot differ by the dot path's bf16
    # prologue rounding only
    _, art_t = yolo.build_detector(SEED, imgs, per_channel=False,
                                   device=dev)
    with torch.no_grad():
        pc = yolo.yolo_forward_kernel(art_t, imgs, accum="popcount")
        dot = yolo.yolo_forward_kernel(art_t, imgs, accum="dot")
    record["per_tensor_popcount_vs_dot"] = float((pc - dot).abs().max())
    if not record["per_tensor_popcount_vs_dot"] < 0.02:
        raise AssertionError(f"per-tensor popcount vs dot: {record}")

    # the int path: one call at conv9's shape on conv9's sign words
    conv9 = next(e for e in art["layers"] if e["spec"].name == "conv9")
    spec = conv9["spec"]
    h = yolo.spatial_sizes(size)["conv9"]
    a = torch.from_numpy(rng.integers(0, 256, (BATCH * h * h, spec.cin),
                                      dtype=np.uint8)).to(dev)
    signs = packing.unpack_signs(conv9["w_packed"], spec.cin,
                                 dtype=torch.float32)
    colsum = signs.sum(dim=0).to(torch.int32)
    _zero(launch.KERNELS)
    out = mm_ops.w1a8_matmul_int(a, conv9["w_packed"], colsum)
    torch.cuda.synchronize()
    launches["w1a8_matmul_int"] = launch.launch_counts()["w1a8_matmul_int"]
    with torch.no_grad():
        want = (a.to(torch.float64) @ signs.to(torch.float64)) \
            .to(torch.int32)
    _exact(torch, out, want, "int path vs the integer product")
    if launches["w1a8_matmul_int"] != 1:
        raise AssertionError(f"int path launches: {launches}")
    record["launches"] = launches
    print(f"[popcount forward] B={BATCH} {size}x{size}, per-channel "
          f"artifact: launches {record['routes']['fused']['launches']} "
          f"fused, {record['routes']['unfused']['launches']} unfused, raw "
          f"heads bit-identical, max_abs vs float "
          f"{record['routes']['fused']['max_abs']:.3g}; per-tensor "
          f"popcount vs dot {record['per_tensor_popcount_vs_dot']:.3g}; "
          f"int path launches {launches['w1a8_matmul_int']}", flush=True)
    for name, ms, prof in (
            ("popcount fused", record["routes"]["fused"]["ms_per_forward"],
             record["routes"]["fused"]["profile"]),
            ("popcount unfused",
             record["routes"]["unfused"]["ms_per_forward"],
             record["routes"]["unfused"]["profile"]),
            ("dot fused", record["dot_ms_per_forward"],
             record["dot_profile"])):
        print(f"[forward ms] {name}: {ms:.4f} ms per forward back to back "
              f"(CUDA events); profiled: device busy "
              f"{prof['device_busy_ms']:.4f} ms, host "
              f"{prof['wall_ms']:.4f} ms, "
              f"{_num(prof['device_launches'], '.0f')} device launches per "
              f"forward", flush=True)
    return record


def per_dispatch(configs) -> dict:
    """Launches of one dispatch by kernel, derived from the W1A8 layers'
    configs (dicts, as `DetectionBackend.configs` gives them): a fused
    pool layer launches its mode's fused kernel, an unfused one its mode's
    conv kernel (the 2×2 max is PyTorch's), a conv layer its mode's conv
    kernel and the matmul its mode's matmul; then one post-processing
    launch."""
    counts = {"detect_postprocess": 1}
    for cfg in configs:
        suffix = "_popcount" if cfg["accum"] == "popcount" else ""
        if cfg["op"] == "matmul":
            name = "w1a8_matmul"
        elif cfg["op"] == "conv3x3_pool" and cfg["fused"]:
            name = "w1a8_conv3x3_pool2"
        else:
            name = "w1a8_conv3x3"
        counts[name + suffix] = counts.get(name + suffix, 0) + 1
    return counts


def check_table() -> dict:
    """The committed autotune table's entries for this card; raises when
    it has none, so tuned serving can never quietly equal the dot
    default."""
    from repro_torch.kernels import config

    key = config.device_key()
    entries = {k: rec for k, rec in config.load_table().items()
               if config.parse_key(k)[3] == key}
    if len(entries) != WINNERS:
        raise AssertionError(
            f"the committed autotune table ({config.DEFAULT_TABLE.name}) "
            f"holds {len(entries)} entries for device key {key!r}, want "
            f"{WINNERS}: sweep it on this card with `{AUTOTUNE_CMD}`")
    return entries


def check_winners(torch, entries: dict, batch: int) -> list:
    """Each committed winner bit-exact against its accum mode's default
    config on the card, on the sweep's operands at the sweep's batch (no
    timing)."""
    from repro_torch.kernels.config import KernelConfig, parse_key
    from repro_torch.launch import autotune

    dev = torch.device("cuda", 0)
    held = []
    for key, rec in sorted(entries.items()):
        op, dims, accum, _ = parse_key(key)
        operands = autotune._operands(op, dims, batch, dev)
        default = autotune.candidates(op, dims, accum)[0]
        tuned = KernelConfig.from_dict(rec["config"])
        why = autotune.launch_error(op, dims, batch, tuned)
        if why is not None:
            raise AssertionError(f"{key}: winner cannot launch: {why}")
        _exact(torch, autotune._call(op, operands, tuned),
               autotune._call(op, operands, default),
               f"{key} winner {tuned} vs default")
        held.append(key)
    torch.cuda.synchronize()
    print(f"[autotune] {len(held)} committed winners bit-exact with their "
          f"defaults on the card (batch {batch})", flush=True)
    return held


def drive_main_path(profile: str) -> tuple:
    """Phase 4: the serving launcher under ``profile``, with every launch
    count zeroed just before and read just after; the raw-wire depth-2
    serve's launches must equal its dispatches times `per_dispatch` of
    the configs the backend resolved at 320. Returns (its record, the
    counts)."""
    from repro_torch.launch import serve as launch
    from repro_torch.models import yolo

    _zero(launch.KERNELS)
    record = launch.main(["--workload", "detect", "--requests", "16",
                          "--slots", str(BATCH), "--depth", "2",
                          "--profile", profile])
    launches = launch.launch_counts()
    dispatches = record["raw_wire_dispatches"]
    configs = record["configs"]["320"]
    per = per_dispatch(configs)
    check_dispatch_launches(record["raw_wire_launches"], dispatches,
                            configs, profile)
    for name in per:
        if not launches[name]:
            raise AssertionError(f"{profile}: {name} never launched")
    names = [s.name for s in yolo.YOLO_LAYERS if s.kind == "w1a8"]
    for name, cfg in zip(names, configs):
        print(f"[serve {profile}] {name}: {cfg}", flush=True)
    print(f"[serve {profile}] 16 requests, 0 dropped, checks passed; "
          f"raw-wire depth-2 serve: {dispatches} graph replays, launches "
          f"{ {k: v for k, v in record['raw_wire_launches'].items() if v} } "
          f"= {dispatches} x {per}", flush=True)
    return record, launches


def profile_dispatch(profile: str) -> dict:
    """Device busy, device records and idle share per dispatch under
    ``profile`` (`launch.profile`: 8 dispatches of 4 images, raw wire)."""
    from repro_torch.launch import profile as prof

    rec = prof.profile_dispatches(profile=profile)
    if rec["trace_lost"]:
        print(f"[profile {profile}] the trace lost records: "
              f"{rec['trace_lost']}", flush=True)
    print(f"[profile {profile}] per dispatch: device busy "
          f"{rec['device_busy_ms_per_dispatch']:.4f} ms, "
          f"{_num(rec['device_launches_per_dispatch'], '.0f')} device "
          f"records, idle share {_num(rec['device_idle_share'], '.3f')} "
          f"({rec['device_timing']}), W1A8 and post-processing "
          f"ms {({g: round(v, 5) for g, v in rec['groups'].items()})}",
          flush=True)
    return rec


def drive_multires() -> tuple:
    """Phase 4b: the launcher's multires workload at 256 and 320 (tuned):
    per-bucket raw heads bit-exact with each bucket served alone, and the
    launcher's other checks, per bucket; every launch count zeroed just
    before and read just after. Returns (its record, the counts)."""
    from repro_torch.launch import serve as launch

    _zero(launch.KERNELS)
    record = launch.main(["--workload", "multires", "--buckets", "256,320",
                          "--requests", "16", "--slots", str(BATCH)])
    launches = launch.launch_counts()
    for bucket, configs in record["configs"].items():
        for name in per_dispatch(configs):
            if not launches[name]:
                raise AssertionError(f"multires {bucket}: {name} never "
                                     f"launched")
        print(f"[multires] {bucket}: " + ", ".join(
            f"{c['op']} {c['accum']} rows={c['rows']} fused={c['fused']} "
            f"({c['source']})" for c in configs), flush=True)
    print(f"[multires] buckets {record['buckets']}, "
          f"{record['requests_per_bucket']} requests: per-bucket raw heads "
          f"bit-exact with each bucket alone, checks passed; alignment "
          f"{record['alignment']}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return record, launches


def sweep_tiles(np, boxes, scores, out_b, out_s, max_out: int,
                score_thresh: float, tile: int = 32) -> list:
    """Tiles of 32 ranks the post-processing kernel's sweep visits in each
    image, from its decoded inputs and its outputs: it stops at the tile
    that holds the max_out-th kept box, or after the last candidate."""
    tiles = []
    for bx, sc, kb, ks in zip(boxes, scores, out_b, out_s):
        best = sc.max(-1)
        score = np.where(best >= np.float32(score_thresh), best, 0)
        order = np.lexsort((np.arange(len(score)), -score))
        m = int((score > 0).sum())
        k = int((ks > 0).sum())
        last = m - 1
        if k == max_out:
            last = next(i for i, j in enumerate(order[:m])
                        if score[j] == ks[k - 1]
                        and (bx[j] == kb[k - 1]).all())
        tiles.append(last // tile + 1 if m else 0)
    return tiles


def check_graphs_and_postprocess(torch, np, dev) -> dict:
    """Phase 6: graph replays against eager forwards; the post-processing
    kernel's two entry points against `decode_head` + `nms_plain` on the
    card, bit for bit; its launches and the device records per dispatch
    through the replays; then its times at the served shape. Returns the
    kernel's record."""
    from repro_torch.launch import nms_fixtures
    from repro_torch.launch import serve as launch
    from repro_torch.models import detection, yolo
    from repro_torch.serve import DetectionBackend

    size = yolo.INPUT_SIZE
    imgs = launch.make_images(4 * BATCH, SEED + 3, size)
    _, art = yolo.build_detector(SEED, imgs[:1].astype(np.float32) / 256.0,
                                 device=dev)
    raws, served, per_dispatch = [], [], {}
    for device_nms in (False, True):
        backend = DetectionBackend(art, slots=BATCH, device=dev,
                                   device_nms=device_nms)
        batches = [backend._host_batch(list(imgs[i:i + BATCH]))
                   for i in range(0, len(imgs), BATCH)]
        backend._dispatch(batches[0])          # captures the graph
        torch.cuda.synchronize()
        replayed = {"detect_postprocess": 0, "detect_nms": 0}
        for batch in batches:
            _zero(launch.KERNELS)
            host = backend._host_outputs(size, *backend._dispatch(batch))
            for name in replayed:
                replayed[name] += launch.KERNELS[name].launches
            with torch.no_grad():
                eager = backend._forward(batch.to(dev).to(torch.float32)
                                         / 256.0)
            for got, want in zip(host, eager):
                _exact(torch, torch.from_numpy(got), want.cpu(),
                       f"graph replay vs eager forward, device_nms="
                       f"{device_nms}")
            if not device_nms:
                raws.append(host[0])
                served.append(host[1:])
        wire = "device_nms" if device_nms else "raw"
        if replayed != {"detect_postprocess": len(batches), "detect_nms": 0}:
            raise AssertionError(f"{wire} wire: launches {replayed} for "
                                 f"{len(batches)} replays, want one "
                                 f"detect_postprocess and no detect_nms a "
                                 f"dispatch")
        prof = device_profile(torch, lambda: backend._host_outputs(
            size, *backend._dispatch(batches[0])))
        per_dispatch[wire] = {"device_records": prof["device_launches"],
                              "device_busy_ms": prof["device_busy_ms"]}
    nb = len(raws)

    def held(raw, what, **post):
        """postprocess(raw) and nms(decode_head(raw)) against nms_plain on
        decode_head(raw), all on the card, bit for bit."""
        dec = detection.decode_head(raw)
        want = detection.nms_plain(dec["boxes"], dec["scores"], **post)
        for entry, got in (
                ("postprocess", detection.postprocess(raw, **post)),
                ("nms", detection.nms(dec["boxes"], dec["scores"], **post))):
            for g, w, field in zip(got, want, ("boxes", "scores", "classes")):
                _exact(torch, g, w, f"{entry} vs plain, {what}, {field}")
        return want

    raw = torch.from_numpy(np.concatenate(raws)).to(dev)
    got = held(raw, "served heads at 320")
    for g, field, parts in zip(got, ("boxes", "scores", "classes"),
                               zip(*served)):
        _exact(torch, g.cpu(), torch.from_numpy(np.concatenate(parts)),
               f"served {field} vs nms_plain on the served heads")
    small = torch.from_numpy(launch.make_images(BATCH, SEED + 4, 256)).to(dev)
    with torch.no_grad():
        raw256 = yolo.yolo_forward_kernel(
            art, small.to(torch.float32) / 256.0,
            configs=yolo.kernel_configs(art, 256, BATCH))
    held(raw256, "a batch at 256 (G = 8, 192 boxes)")
    head, peaks = nms_fixtures.separated_head()
    _, sep_scores, _ = held(torch.from_numpy(head).to(dev),
                            "score-separated fixture")
    if int((sep_scores > 0).sum()) != len(peaks):
        raise AssertionError(f"separated fixture: kept "
                             f"{int((sep_scores > 0).sum())} of {len(peaks)}")
    for name, fixture in nms_fixtures.HEADS.items():
        head, post = fixture()
        held(torch.from_numpy(head).to(dev), f"fixture {name}", **post)
    boxes, scores = (torch.from_numpy(x).to(dev)
                     for x in nms_fixtures.tied_boxes())
    for thresh in (nms_fixtures.TIE_IOU, 0.45):
        tie = detection.nms(boxes, scores, iou_thresh=thresh)
        for g, w in zip(tie, detection.nms_plain(boxes, scores,
                                                 iou_thresh=thresh)):
            _exact(torch, g, w, f"nms vs plain, tie fixture at {thresh}")
    tie_b, tie_s, _ = detection.nms(boxes, scores,
                                    iou_thresh=nms_fixtures.TIE_IOU)
    kept = [int(torch.nonzero((boxes[0] == tie_b[0, i]).all(-1))[0])
            for i in range(int((tie_s[0] > 0).sum()))]
    if tuple(kept) != nms_fixtures.TIE_KEPT:
        raise AssertionError(f"tie fixture kept {kept}, want "
                             f"{nms_fixtures.TIE_KEPT}")

    # times at the served shape: the first dispatch's four heads
    r4 = raw[:BATCH].contiguous()
    dec = detection.decode_head(r4)
    b4, s4 = dec["boxes"], dec["scores"]
    n, c = s4.shape[1:]
    max_out, score_thresh = 50, 0.25
    run = lambda: detection.postprocess(r4)  # noqa: E731
    out_b, out_s, _ = run()
    rec = {"shape": [BATCH, n, c, max_out], "served_heads": nb,
           "ms": cuda_ms(torch, run),
           "device_ms": device_profile(torch, run)["device_busy_ms"],
           "nms_device_ms": device_profile(
               torch, lambda: detection.nms(b4, s4))["device_busy_ms"],
           "decode_head_device_ms": device_profile(
               torch, lambda: detection.decode_head(r4))["device_busy_ms"],
           "plain_ms": cuda_ms(torch, lambda: detection.nms_plain(
               **detection.decode_head(r4)), reps=3, n=3),
           "library_ms": None, "per_dispatch": per_dispatch}
    scores_np = s4.cpu().numpy()
    rec["tiles"] = sweep_tiles(np, b4.cpu().numpy(), scores_np,
                               out_b.cpu().numpy(), out_s.cpu().numpy(),
                               max_out, score_thresh)
    # bytes: the raw head in, the outputs out; operations: the decode
    # (5 + 2C a box), the ranking (a compare per candidate pair) and an IoU
    # of each kept box with each candidate, as the greedy loop takes them
    cand = (scores_np.max(-1) >= score_thresh).sum(-1)
    kept_n = (out_s.cpu().numpy() > 0).sum(-1)
    rec["bytes"] = 4 * r4.numel() + BATCH * max_out * 24
    rec["ops"] = int(sum(n * (5 + 2 * c) + m * n + k * m * NMS_IOU_OPS
                         for m, k in zip(cand, kept_n)))
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["ops"],
                                             FP32_OPS_PER_S)
    print(f"[graphs] {nb} served heads: each wire's graph replay equals an "
          f"eager forward bit for bit; one detect_postprocess launch and no "
          f"detect_nms launch a dispatch through the replays; device "
          f"records a dispatch: raw wire "
          f"{_num(per_dispatch['raw']['device_records'], '.0f')}, "
          f"device-NMS wire "
          f"{_num(per_dispatch['device_nms']['device_records'], '.0f')}; "
          f"device busy "
          f"{per_dispatch['raw']['device_busy_ms']:.4f} / "
          f"{per_dispatch['device_nms']['device_busy_ms']:.4f} ms",
          flush=True)
    print(f"[postprocess] detect_postprocess and detect_nms bit-exact with "
          f"decode_head + nms_plain on the card: served heads at 320 (and "
          f"the served detections), a batch at 256, the score-separated "
          f"fixture ({len(peaks)} kept), fixtures "
          f"{list(nms_fixtures.HEADS)}, tie fixture (kept {kept}); "
          f"B={BATCH}, {n} boxes, {c} classes: {rec['ms']:.4f} ms, device "
          f"{rec['device_ms']:.5f} ms (detect_nms on the decoded heads "
          f"{rec['nms_device_ms']:.5f}, decode_head "
          f"{rec['decode_head_device_ms']:.5f}; plain {rec['plain_ms']:.4f}, "
          f"bound {rec['bound_ms']:.6f} by {rec['bound_by']}); tiles swept "
          f"{rec['tiles']}", flush=True)
    return rec


def int_plain(entry, x):
    """The plain version of the integer PE entry point that runs
    ``entry``'s layer, on the tensors' device (integer sums, no matmul)."""
    from repro_torch.kernels.w1a8_int import ref
    from repro_torch.models import yolo
    spec = entry["spec"]
    if spec.name == "conv1":
        return ref.int_pe_conv1_ref(
            x, entry["w_raw"].reshape(-1, spec.cout), entry["b_shifted"],
            entry["post_mult"], entry["post_shift"], pool=spec.pool)
    if spec.name == "conv11":
        return ref.int_pe_head_ref(
            x, entry["w_raw"].reshape(-1, spec.cout), entry["m_raw"],
            entry["b_shifted"], yolo.FM)
    return ref.w1a8_int_pe_ref(
        x, entry["w_packed"], entry["m_raw"], entry["post_mult"],
        entry["b_pre"], entry["post_shift"], ksize=spec.ksize,
        pool=spec.pool)


def int_library(torch, entry, x):
    """F.conv2d in float64 on codes·m_raw and the ±1 or raw weights: the
    layer's accumulator, exact since every partial sum is an integer below
    2^53; the port never makes this call. Returns the call."""
    import torch.nn.functional as F
    spec = entry["spec"]
    a = x.to(torch.float64)
    if "m_raw" in entry:
        a = a * entry["m_raw"].to(torch.float64)
    a = a.permute(0, 3, 1, 2).contiguous()
    w = entry["signs"] if "signs" in entry else entry["w_raw"]
    w = w.to(torch.float64).reshape(spec.ksize, spec.ksize, spec.cin,
                                    spec.cout).permute(3, 2, 0, 1) \
        .contiguous()
    return lambda: F.conv2d(a, w, padding=spec.ksize // 2)


def int_bytes_ops(entry, x, out) -> tuple:
    """Bytes the layer must move (codes in, weights, per-channel constants,
    output) and its operations (2 per MAC)."""
    spec = entry["spec"]
    w = entry["w_packed"] if "w_packed" in entry else entry["w_raw"]
    consts = sum(entry[k].numel() * 8 for k in (
        "m_raw", "post_mult", "post_shift", "b_pre", "b_shifted")
        if k in entry)
    nbytes = (x.numel() + w.numel() * w.element_size() + consts
              + out.numel() * out.element_size())
    b, h, wd, _ = x.shape
    return nbytes, 2 * b * h * wd * spec.ksize ** 2 * spec.cin * spec.cout


def check_int_pe(torch, np, dev, art) -> list:
    """Phase 7a: the integer PE's three entry points bit for bit against
    their plain versions on the card: at every layer shape of the 320 path
    (the deployed artifact's constants and digit planes, random codes) at
    B = 1 and 4; off the grid (INT_OFF_GRID: Cin 3, 16, 24, 48 and 128,
    ragged Cout) for every kind, ksize and pool it takes, with random m,
    mult, shift (0 included) and int40 biases; on the overflow operands
    (m_raw ≈ 2^17, codes 255, every sign +1 at K = 1152: |acc| ≈ 3.9e10,
    3 planes), on m_raw of 1 to 9 planes and INT64_MIN (10) at the W1A8
    kind, pooled and not, and at the head, the large ones wrapping numpy's
    int64 sum; and on a head with negative values on rounding ties. Times
    each layer at B = 4. Returns the per-layer records."""
    from repro_torch.core import packing
    from repro_torch.kernels.w1a8_int import ops, planes as pl, ref
    from repro_torch.models import yolo

    rng = np.random.default_rng(SEED + 3)
    sizes = yolo.spatial_sizes(yolo.INPUT_SIZE)
    records = []

    def codes(shape):
        return torch.from_numpy(rng.integers(0, 256, shape,
                                             dtype=np.uint8)).to(dev)
    for batch in INT_BATCHES:
        for entry in art["layers"]:
            spec = entry["spec"]
            h = sizes[spec.name]
            x = codes((batch, h, h, spec.cin))
            out = yolo.int_layer(entry, x)
            want = int_plain(entry, x)
            torch.cuda.synchronize()
            _exact(torch, out, want, f"int PE {spec.name} B={batch}")
            if batch != BATCH:
                continue
            nbytes, ops_n = int_bytes_ops(entry, x, out)
            run = lambda: yolo.int_layer(entry, x)  # noqa: E731
            library = int_library(torch, entry, x)
            acc = library()
            if float(acc.abs().max()) >= 2 ** 53:
                raise AssertionError(f"{spec.name}: float64 library sum "
                                     f"is not exact")
            rec = {"layer": spec.name,
                   "shape": [batch, h, h, spec.cin, spec.cout],
                   "planes": int(entry["planes"].shape[0]),
                   "ms": cuda_ms(torch, run),
                   "device_ms": device_profile(torch, run)["device_busy_ms"],
                   "plain_ms": cuda_ms(torch, lambda: int_plain(entry, x),
                                       reps=3, n=3),
                   "library_ms": cuda_ms(torch, library, reps=3, n=3),
                   "library_device_ms": device_profile(
                       torch, library, n=3)["device_busy_ms"],
                   "before_device_ms": INT_BEFORE_DEVICE_MS[spec.name],
                   "bytes": nbytes, "ops": ops_n}
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops_n,
                                                     INT8_OPS_PER_S)
            print(f"[int pe] {spec.name} {rec['shape']}: P = "
                  f"{rec['planes']}, bit-exact at B = {INT_BATCHES}; "
                  f"{rec['ms']:.4f} ms, device {rec['device_ms']:.5f} ms "
                  f"(before {rec['before_device_ms']:.4f}; plain "
                  f"{rec['plain_ms']:.4f}, float64 conv2d "
                  f"{rec['library_ms']:.4f}, device "
                  f"{rec['library_device_ms']:.5f}, bound "
                  f"{rec['bound_ms']:.6f} by {rec['bound_by']})", flush=True)
            records.append(rec)

    def ints(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape,
                                             dtype=np.int64)).to(dev)

    def signs(k, cout):
        return packing.pack_signs(ints(0, 2, (k, cout)) * 2 - 1, axis=0)

    def w1a8_case(x, wp, m, mult, bias, shift, ksize, pool, what):
        _exact(torch, ops.w1a8_int_pe(x, wp, m, mult, bias, shift,
                                      ksize=ksize, pool=pool),
               ref.w1a8_int_pe_ref(x, wp, m, mult, bias, shift, ksize=ksize,
                                   pool=pool), f"w1a8 {what}")

    def head_case(x, w, m, bias, shift, what):
        _exact(torch, ops.int_pe_head(x, w, m, bias, shift),
               ref.int_pe_head_ref(x, w, m, bias, shift), f"head {what}")
    b, h = 2, 18
    for cin, cout in INT_OFF_GRID:
        for ksize, pool in ((3, True), (3, False), (1, False), (1, True)):
            x = codes((b, h, h, cin))
            k = ksize * ksize * cin
            m = ints(1, 1 << 17, cin)
            mult, bias = ints(0, 1 << 15, cout), ints(-(1 << 40), 1 << 40,
                                                      cout)
            shift = ints(0, 47, cout)
            shift[0] = 0
            w = ints(-(1 << 16), 1 << 16, (k, cout))
            what = (f"off the grid (B {b}, {h}x{h}, Cin {cin}, Cout {cout}) "
                    f"ksize {ksize} pool {pool}")
            w1a8_case(x, signs(k, cout), m, mult, bias, shift, ksize, pool,
                      what)
            if ksize == 3:
                _exact(torch, ops.int_pe_conv1(x, w, bias, mult, shift,
                                               pool=pool),
                       ref.int_pe_conv1_ref(x, w, bias, mult, shift,
                                            pool=pool), f"conv1 {what}")
            elif not pool:
                head_case(x, w, m, bias, 16, what)

    # overflow: int32 accumulation would wrap
    x = torch.full((BATCH, 20, 20, 128), 255, dtype=torch.uint8, device=dev)
    wp = packing.pack_signs(torch.ones(1152, 128, device=dev), axis=0)
    m = (1 << 17) - ints(0, 64, 128)
    mult, shift = ints(1 << 14, 1 << 15, 128), ints(40, 47, 128)
    bias = ints(-(1 << 40), 1 << 40, 128)
    acc = ref.accumulate(x, m, packing.unpack_signs(wp, 1152,
                                                    dtype=torch.int64), 3)
    overflow_acc = float(acc.abs().max())
    if not overflow_acc > 3e10 or pl.plane_count(m) != 3:
        raise AssertionError("the overflow operands stay inside int32")
    w1a8_case(x, wp, m, mult, bias, shift, 3, False, "overflow operands")
    # m_raw of 1 to 9 planes (7P bits), then INT64_MIN (10): numpy's int64
    # sum wraps from 8 planes on, and the fused max is over the codes
    x = codes((2, 10, 10, 128))
    wp = signs(1152, 96)
    wrapped = []
    for p in range(1, pl.MAX_PLANES + 1):
        if p < pl.MAX_PLANES:
            m = ints(1 << (7 * p - 7), min(1 << (7 * p), (1 << 63) - 1),
                     128)
        else:
            m = torch.full((128,), -(1 << 63), dtype=torch.int64,
                           device=dev)
        if pl.plane_count(m) != p:
            raise AssertionError(f"m_raw of {p} planes has "
                                 f"{pl.plane_count(m)}")
        exact = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2).double() * m.double()[None, :, None, None],
            packing.unpack_signs(wp, 1152, dtype=torch.float64).reshape(
                3, 3, 128, 96).permute(3, 2, 0, 1), padding=1)
        if float(exact.abs().max()) > 2.0 ** 63:
            wrapped.append(p)
        mult, bias = ints(1, 1 << 15, 96), ints(-(1 << 40), 1 << 40, 96)
        shift = ints(0, 63, 96)
        for pool in (True, False):
            w1a8_case(x, wp, m, mult, bias, shift, 3, pool,
                      f"m_raw of {p} planes, pool {pool}")
        head_case(x[..., :64], ints(-3, 4, (64, 75)), m[:64], bias[:75],
                  20, f"m_raw of {p} planes")
    if not set(range(8, pl.MAX_PLANES + 1)) <= set(wrapped):
        raise AssertionError(f"numpy's int64 sum wraps only at planes "
                             f"{wrapped}")
    # the head on exact ties of the 16-bit shift, negatives included
    x = codes((BATCH, 10, 10, 64))
    w = ints(0, 2, (64, 75)) * 2 - 1
    m = torch.full((64,), 1 << 15, dtype=torch.int64, device=dev)
    bias = ints(-400, 400, 75)
    want = ref.int_pe_head_ref(x, w, m, bias, 16)
    acc = ref.accumulate(x, m, w, 1)
    if not (bool((want < 0).any()) and bool(
            ((acc < 0) & (acc.abs() % (1 << 16) == 1 << 15)).any())):
        raise AssertionError("the head fixture has no negative tie")
    _exact(torch, ops.int_pe_head(x, w, m, bias, 16), want,
           "int PE head on negative ties")
    torch.cuda.synchronize()
    print(f"[int pe] off the grid (B 2, 18×18, (Cin, Cout) "
          f"{INT_OFF_GRID}: W1A8 3×3 and 1×1, pooled and not; conv1 pooled "
          f"and not; the head), overflow operands (max |acc| "
          f"{overflow_acc:.6g}, 3 planes), m_raw of 1 to "
          f"{pl.MAX_PLANES} planes (numpy's int64 sum wrapping at "
          f"{wrapped}) and a head on negative ties: bit-exact", flush=True)
    return records


def drive_int(torch, np, dev) -> dict:
    """Phase 7b: `yolo_forward_int` at B = 4, 320×320 on the card, with
    every launch count zeroed just before and read just after: one integer
    PE launch per layer, the raw head equal to the plain version's (on the
    CPU) as int64 and inside INT_ENVELOPE of the port's float forward.
    Prints `launch/alignment.py`'s rows. Returns the record, with the
    per-layer records of `check_int_pe`."""
    from repro_torch.core import verify
    from repro_torch.launch import alignment
    from repro_torch.launch import serve as launch
    from repro_torch.models import yolo

    rng = np.random.default_rng(SEED + 4)
    img_u8 = torch.from_numpy(rng.integers(
        0, 256, (BATCH, yolo.INPUT_SIZE, yolo.INPUT_SIZE, 3),
        dtype=np.uint8)).to(dev)
    img = img_u8.to(torch.float32) / torch.tensor(256.0, device=dev)
    with torch.no_grad():
        params = yolo.calibrate_yolo(yolo.init_yolo_params(SEED, device=dev),
                                     img)
        art = yolo.deploy_yolo(params)
        layers = check_int_pe(torch, np, dev, art)
        _zero(launch.KERNELS)
        raw = yolo.yolo_forward_int(art, img_u8, device=dev)
        torch.cuda.synchronize()
        counts = launch.launch_counts()
        n_layers = len(yolo.YOLO_LAYERS)
        if counts[INT_PE] != n_layers or any(
                n for name, n in counts.items() if name != INT_PE):
            raise AssertionError(f"int forward: launches {counts}, want "
                                 f"{n_layers} of {INT_PE} alone")
        art_cpu = {"layers": [{k: (v.cpu() if hasattr(v, "cpu") else v)
                               for k, v in e.items()}
                              for e in art["layers"]]}
        t0 = time.perf_counter()
        want = yolo.yolo_forward_int(art_cpu, img_u8.cpu(), device="cpu")
        cpu_s = time.perf_counter() - t0
        _exact(torch, raw.cpu(), want, "int forward vs its plain version")
        ref = yolo.yolo_forward_float(params, img).double().cpu().numpy()
    rep = verify.compare("int_vs_float", raw.cpu().numpy() / 2.0 ** 15, ref,
                         lsb=0.02)
    if not (rep.max_abs < INT_ENVELOPE[0] and rep.mean_abs < INT_ENVELOPE[1]
            and rep.within_1lsb == 1.0):
        raise AssertionError(f"int raw head outside the envelope: "
                             f"{rep.row()}")
    with torch.no_grad():
        forward = lambda: yolo.yolo_forward_int(  # noqa: E731
            art, img_u8, device=dev)
        ms = cuda_ms(torch, forward, reps=5, n=10)
        prof = device_profile(torch, forward)
    record = {"launches": {INT_PE: counts[INT_PE]}, "ms_per_forward": ms,
              "profile": prof, "plain_cpu_s": cpu_s, "max_abs": rep.max_abs,
              "mean_abs": rep.mean_abs, "corr": rep.corr,
              "within_1lsb": rep.within_1lsb, "layers": layers}
    print(f"[int forward] B={BATCH} {yolo.INPUT_SIZE}x{yolo.INPUT_SIZE}: "
          f"{counts[INT_PE]} {INT_PE} launches, raw head bit-exact with the "
          f"plain version ({cpu_s:.2f} s on the CPU), vs float max_abs "
          f"{rep.max_abs:.6g} mean_abs {rep.mean_abs:.6g} corr "
          f"{rep.corr:.6f}; {ms:.4f} ms per forward back to back (CUDA "
          f"events), device busy {prof['device_busy_ms']:.5f} ms (before "
          f"{INT_BEFORE_DEVICE_MS['forward']}), "
          f"{_num(prof['device_launches'], '.0f')} device launches per "
          f"forward", flush=True)
    with torch.no_grad():
        record["alignment"] = alignment.run(size=yolo.INPUT_SIZE, device=dev)
    for name, value, note in record["alignment"]:
        print(f"[alignment] {name} {value!r} {note}", flush=True)
    return record


def _max_rel_err(np, got: dict, want: dict) -> dict:
    """{layer.name: max|got − want| / max|want|} over the params' leaves,
    both moved to the host."""
    out = {}
    for layer in sorted(want):
        for k in sorted(want[layer]):
            g = got[layer][k].detach().double().cpu().numpy()
            w = want[layer][k].detach().double().cpu().numpy()
            scale = float(np.abs(w).max())
            out[f"{layer}.{k}"] = (float(np.abs(g - w).max()) / scale
                                   if scale > 0 else float(np.abs(g).max()))
    return out


def check_qat_step(torch, np, dev) -> dict:
    """Phase 9a: one QAT train step on the card against the same step on
    the CPU, from the same params and batch (the card's, moved over), with
    cuDNN's TF32 flag left at its default outside the trainer. A code that
    rounds across a tie on one side only is forced to the CPU's
    (`train.ties`, within 1e-3 of a tie on both). Loss and gradient norm
    within rtol 1e-4, each gradient leaf within 1e-3·max|g|: the backward
    runs in full f32. Also prints how far a backward outside `full_f32`
    (cuDNN's TF32 default) lands, which that check would catch."""
    from repro_torch.data import pipeline as data
    from repro_torch.models import yolo
    from repro_torch.optim import adamw, tree_leaves, tree_map
    from repro_torch.train import ties, yolo_qat

    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("cuDNN's TF32 flag is off before the QAT step: "
                             "the check would not show a TF32 backward")
    ds = data.make_detection_dataset(QAT_PARITY_BATCH, seed=SEED)
    img, boxes, classes = data.detection_batch(ds, 0, device=dev)
    with torch.no_grad():
        params = yolo.calibrate_yolo(yolo.init_yolo_params(SEED, device=dev),
                                     img)
    host = lambda t: tree_map(lambda v: v.cpu(), t)  # noqa: E731
    target = data.yolo_target(boxes, classes)
    opt = adamw(1e-3)
    step = yolo_qat.make_yolo_train_step(opt)

    t0 = time.perf_counter()
    with ties.record() as recorded:
        loss_c, grads_c = yolo_qat.loss_and_grads(host(params), img.cpu(),
                                                  target.cpu())
        _, _, m_c = step(host(params), opt[0](host(params)), img.cpu(),
                         boxes.cpu(), classes.cpu())
    cpu_s = time.perf_counter() - t0
    with ties.forced(recorded) as forced:
        loss_g, grads_g = yolo_qat.loss_and_grads(params, img, target)
        _, _, m_g = step(params, opt[0](params), img, boxes, classes)
    torch.cuda.synchronize()
    errs = _max_rel_err(np, grads_g, grads_c)
    rel = lambda a, b: abs(float(a) / float(b) - 1.0)  # noqa: E731
    if (rel(loss_g, loss_c) > 1e-4 or rel(m_g["loss"], m_c["loss"]) > 1e-4
            or rel(m_g["grad_norm"], m_c["grad_norm"]) > 1e-4
            or max(errs.values()) > 1e-3):
        raise AssertionError(
            f"QAT step on the card vs the CPU: loss {float(loss_g)} vs "
            f"{float(loss_c)}, grad_norm {float(m_g['grad_norm'])} vs "
            f"{float(m_c['grad_norm'])}, gradient errors {errs}")
    # the same gradients with the backward outside full_f32: TF32 convs
    leaves = tree_map(lambda v: v.detach().requires_grad_(True), params)
    with ties.forced(recorded):
        loss = yolo_qat.yolo_loss(leaves, img, target)
    flat = tree_leaves(leaves)
    tf32 = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    tf32_errs = _max_rel_err(
        np, tree_map(lambda v: tf32[id(v)], leaves), grads_c)
    record = {"loss_card": float(loss_g), "loss_cpu": float(loss_c),
              "grad_norm_card": float(m_g["grad_norm"]),
              "grad_norm_cpu": float(m_c["grad_norm"]),
              "max_grad_rel_err": max(errs.values()),
              "grad_rel_err": errs, "forced_codes": forced,
              "tf32_backward_max_grad_rel_err": max(tf32_errs.values()),
              "batch": QAT_PARITY_BATCH, "cpu_s": cpu_s}
    worst = max(errs, key=errs.get)
    print(f"[qat] one step, B={QAT_PARITY_BATCH} 320x320, card vs CPU: loss "
          f"{float(loss_g):.7g} vs {float(loss_c):.7g}, grad norm "
          f"{float(m_g['grad_norm']):.7g} vs {float(m_c['grad_norm']):.7g}, "
          f"worst gradient leaf {worst} {errs[worst]:.3g}·max|g| (limit "
          f"1e-3), codes forced at ties {forced}; a TF32 backward would be "
          f"{record['tf32_backward_max_grad_rel_err']:.3g}·max|g| off",
          flush=True)
    return record


def drive_qat(torch, np, dev) -> dict:
    """Phase 9: the paper's offline workflow on the card. `check_qat_step`,
    then `launch/train_yolo_qat.train` (QAT_STEPS AdamW steps at
    B = QAT_BATCH, 320×320): the held-out loss must fall; ms per step (CUDA
    events) and images per second, peak memory, and from torch.profiler
    the device busy ms and idle share of a step. Then, with every launch
    count zeroed just before each and read just after: `yolo_forward_int`
    of the trained artifact on BATCH test images (11 integer PE launches
    and no other kernel, bit-exact with the plain version on the CPU, the
    int head within test_system's envelope of the float head:
    corr > 0.99, mean_abs < 0.01, 100% within 1 LSB of 0.02), `postprocess`
    on that head (1 `detect_postprocess` launch, bit for bit with
    `decode_head` + `nms_plain` on the card) and `launch/alignment.py`'s
    Table 6 rows on the trained params (the kernel path under the tuned
    profile: PER_FORWARD[True] popcount launches). Returns the record,
    with the launches of those three as the path's."""
    from repro_torch.core import verify
    from repro_torch.data import pipeline as data
    from repro_torch.launch import alignment, train_yolo_qat
    from repro_torch.launch import serve as launch
    from repro_torch.models import detection, yolo
    from repro_torch.optim import adamw, tree_map
    from repro_torch.train import yolo_qat

    record = {"step_parity": check_qat_step(torch, np, dev)}
    params, ds, train = train_yolo_qat.train(QAT_STEPS, QAT_BATCH, SEED, dev)
    if not train["held_out_loss_after"] < train["held_out_loss_before"]:
        raise AssertionError(f"QAT: the held-out loss did not fall: {train}")
    # device busy per step: more steps from the trained params, profiled
    opt = adamw(train_yolo_qat.LR)
    step = yolo_qat.make_yolo_train_step(opt)
    batch = data.detection_batch(ds, QAT_STEPS, device=dev)
    live = {"params": tree_map(lambda v: v.clone(), params)}
    live["state"] = opt[0](live["params"])

    def one_step():
        live["params"], live["state"], _ = step(live["params"],
                                                live["state"], *batch)

    prof = device_profile(torch, one_step, n=5)
    prof["idle_share_of_step"] = (
        None if prof["device_launches"] is None
        else 1.0 - prof["device_busy_ms"] / train["ms_per_step"])
    record.update({"train": train, "step_profile": prof})
    print(f"[qat] {QAT_STEPS} steps at B={QAT_BATCH} 320x320: loss "
          f"{train['loss']}, held-out {train['held_out_loss_before']:.6g} -> "
          f"{train['held_out_loss_after']:.6g}; {train['ms_per_step']:.4f} "
          f"ms a step (CUDA events, median; first step "
          f"{train['first_step_ms']:.1f}), {train['img_per_s']:.1f} img/s, "
          f"peak memory {train['peak_memory_bytes'] / 2 ** 20:.1f} MiB; "
          f"device busy {prof['device_busy_ms']:.4f} ms a step "
          f"({_num(prof['device_launches'], '.0f')} device records), idle "
          f"share {_num(prof['idle_share_of_step'], '.3f')} of the step",
          flush=True)

    by_path = {}
    art = yolo.deploy_yolo(params)
    img, _, _ = data.detection_batch(ds, train_yolo_qat.TEST_STEP, device=dev)
    img = img[:BATCH]
    img_u8 = torch.clamp(torch.round(img * 256.0), 0, 255).to(torch.uint8)
    with torch.no_grad():
        _zero(launch.KERNELS)
        raw_i = yolo.yolo_forward_int(art, img_u8, device=dev)
        torch.cuda.synchronize()
        counts = launch.launch_counts()
        n_layers = len(yolo.YOLO_LAYERS)
        if counts[INT_PE] != n_layers or any(
                n for name, n in counts.items() if name != INT_PE):
            raise AssertionError(f"QAT int forward: launches {counts}, want "
                                 f"{n_layers} of {INT_PE} alone")
        by_path["int forward"] = counts
        art_cpu = {"layers": [{k: (v.cpu() if hasattr(v, "cpu") else v)
                               for k, v in e.items()}
                              for e in art["layers"]]}
        _exact(torch, raw_i.cpu(), yolo.yolo_forward_int(
            art_cpu, img_u8.cpu(), device="cpu"),
            "trained int forward vs its plain version")
        out_f = yolo.yolo_forward_float(params, img)
    rep = verify.compare("final_raw (trained)",
                         raw_i.cpu().numpy() / 2.0 ** 15,
                         out_f.double().cpu().numpy(), lsb=0.02)
    if not (rep.corr > 0.99 and rep.mean_abs < 0.01
            and rep.within_1lsb == 1.0):
        raise AssertionError(f"trained int head outside the envelope: "
                             f"{rep.row()}")
    record["final_raw"] = {"max_abs": rep.max_abs, "mean_abs": rep.mean_abs,
                           "corr": rep.corr, "within_1lsb": rep.within_1lsb}
    print(f"[qat] int forward of the trained artifact, B={BATCH}: "
          f"{counts[INT_PE]} {INT_PE} launches, bit-exact with the plain "
          f"version; {rep.row()}", flush=True)

    raw = raw_i.to(torch.float32) / 2.0 ** 15
    post = {"score_thresh": 0.05, "max_out": 8}
    _zero(launch.KERNELS)
    got = detection.postprocess(raw, **post)
    torch.cuda.synchronize()
    counts = launch.launch_counts()
    if counts["detect_postprocess"] != 1 or any(
            n for name, n in counts.items() if name != "detect_postprocess"):
        raise AssertionError(f"QAT postprocess: launches {counts}")
    by_path["postprocess"] = counts
    dec = detection.decode_head(raw)
    want = detection.nms_plain(dec["boxes"], dec["scores"], **post)
    for g, w, field in zip(got, want, ("boxes", "scores", "classes")):
        _exact(torch, g, w, f"trained head postprocess {field}")
    kept = [int(n) for n in torch.sum(got[1] > 0, dim=1)]
    record["kept_boxes"] = kept
    print(f"[qat] postprocess of the trained int head: 1 detect_postprocess "
          f"launch, bit for bit with decode_head + nms_plain; kept {kept} "
          f"of max_out {post['max_out']}", flush=True)

    _zero(launch.KERNELS)
    with torch.no_grad():
        rows = alignment.run(device=dev, trained_params=params)
    torch.cuda.synchronize()
    counts = launch.launch_counts()
    # the kernel path's launches, derived from its configs (tuned, B = 1)
    # as phase 4 derives a dispatch's; the int path's conv1 checkpoint and
    # forward launch the integer PE 1 + 11 times
    configs = yolo.kernel_configs(yolo.deploy_yolo_kernel(params),
                                  yolo.INPUT_SIZE, 1)
    want = per_dispatch([c.to_dict() for c in configs])
    del want["detect_postprocess"]
    want[INT_PE] = n_layers + 1
    if {k: n for k, n in counts.items() if n} != want:
        raise AssertionError(f"Table 6 on trained params: launches {counts}, "
                             f"want {want}")
    by_path["table 6"] = counts
    print(f"[qat alignment] launches {want}", flush=True)
    record["alignment"] = rows
    for name, value, note in rows:
        print(f"[qat alignment] {name} {value!r} {note}", flush=True)
    record["launches"] = {name: sum(c[name] for c in by_path.values())
                          for name in launch.KERNELS}
    record["launches_by_step"] = by_path
    return record


# ---------------------------------------------------------------------------
# Phase 10: the LM stack's dense family (chatglm3-6b at full width, packed)
# ---------------------------------------------------------------------------

def lm_projections(cfg) -> dict:
    """(K, N) of each packed projection of one layer, in call order."""
    d, hd = cfg.d_model, cfg.hd
    qn, kvn = cfg.heads_eff * hd, cfg.num_kv_heads * hd
    out = {"wq": (d, qn), "wk": (d, kvn), "wv": (d, kvn), "wo": (qn, d),
           "up": (d, cfg.d_ff)}
    if cfg.gated_mlp:
        out["gate"] = (d, cfg.d_ff)
    out["down"] = (cfg.d_ff, d)
    return out


def lm_shapes(cfg) -> list:
    """(what, M, K, N) the LM path gives the matmuls: decode at M = slots
    and prefill at M = slots × prompt for each distinct (K, N), and one
    shape off the grid (ragged M and N, the widest K)."""
    kn = sorted(set(lm_projections(cfg).values()))
    rows = [("decode", LM_SLOTS, k, n) for k, n in kn]
    rows += [("prefill", LM_SLOTS * LM_PROMPT, k, n) for k, n in kn]
    k_max = max(k for k, _ in kn)
    rows.append(("off grid", 37, k_max, 2061))
    return rows


def check_lm_kernels(torch, np, dev, cfg) -> tuple:
    """Phase 10a: the popcount matmul, called as `layers.packed_linear`
    calls it (one uniform step broadcast to (K,)), and the int matmul,
    through `core.w1a8.w1a8_linear_infer_int`, each bit for bit against
    its plain version on the card at the LM path's shapes; rows of a
    prefix of M, of a2[1:] and of an unaligned copy at the shape off the
    grid. Times each like phases 2–3, beside ``torch.matmul`` in f32 on
    codes·step and the unpacked ±1 (the reference's arithmetic). Returns
    the records and the largest difference per kernel (0)."""
    from repro_torch.core import packing, w1a8
    from repro_torch.device import full_f32
    from repro_torch.kernels.w1a8_matmul import ops as mm_ops
    from repro_torch.kernels.w1a8_matmul import ref as mm_ref
    from repro_torch.models import layers

    MM, INT = "w1a8_matmul_popcount", "w1a8_matmul_int"
    rng = np.random.default_rng(SEED + 10)
    records = []
    for what, m, k, n in lm_shapes(cfg):
        a2 = torch.from_numpy(rng.integers(0, 256, (m, k), dtype=np.uint8)
                              ).to(dev)
        w = torch.from_numpy(rng.standard_normal((k, n)).astype(
            np.float32)).to(dev)
        wp = packing.pack_signs(w, axis=0)
        step = torch.full((), 0.05, device=dev)
        mul = torch.broadcast_to(step, (k,))
        alpha = torch.mean(torch.abs(w), dim=0)
        bias = torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(dev)

        def run():
            return mm_ops.w1a8_matmul(a2, wp, mul, alpha, bias, k=k,
                                      config=layers.POPCOUNT)
        codes, div = mm_ops.fold_operands(a2, mul, alpha)
        y = run()
        _exact(torch, codes, a2, f"LM {what} {(m, k, n)}: uniform-step fold")
        _exact(torch, y, mm_ref.w1a8_matmul_popcount_ref(a2, wp, k, div,
                                                         bias),
               f"LM {what} {(m, k, n)} popcount matmul")
        dep = {"w_packed": wp, "mul_prev": mul.contiguous(),
               "div_post": alpha, "bias": bias, "k": k}
        colsum = packing.unpack_signs(wp, k, dtype=torch.int32).sum(
            dim=0, dtype=torch.int32)
        acc = w1a8.int_sums(dep, a2)
        want = mm_ref.w1a8_matmul_int_ref(a2, wp, colsum)
        _exact(torch, acc, want, f"LM {what} {(m, k, n)} int sums")
        _exact(torch, w1a8.w1a8_linear_infer_int(dep, a2),
               want.to(torch.float32) * mul[0] * alpha + bias,
               f"LM {what} {(m, k, n)} w1a8_linear_infer_int")
        if what == "off grid":
            row_checks(torch, lambda x: mm_ops.w1a8_matmul(
                x, wp, mul, alpha, bias, k=k, config=layers.POPCOUNT),
                a2, y, f"LM {what} popcount")
            row_checks(torch, lambda x: mm_ops.w1a8_matmul_int(
                x, wp, colsum), a2, acc, f"LM {what} int")
        xq = a2.to(torch.float32) * step
        signs = packing.unpack_signs(wp, k, dtype=torch.float32)

        def library():
            with full_f32():
                return torch.matmul(xq, signs)
        nbytes = k * n // 8 + m * k + 4 * m * n
        ops = 2 * m * k * n
        for kernel, fn, alone, plain in (
                (MM, run, lambda: mm_ops.w1a8_matmul(
                    a2, wp, None, div, bias, k=k, config=layers.POPCOUNT),
                 lambda: mm_ref.w1a8_matmul_popcount_ref(
                     a2, wp, k, div, bias)),
                (INT, lambda: mm_ops.w1a8_matmul_int(a2, wp, colsum),
                 lambda: mm_ops.w1a8_matmul_int(a2, wp, colsum),
                 lambda: mm_ref.w1a8_matmul_int_ref(a2, wp, colsum))):
            rec = {"kernel": kernel, "what": what, "shape": [m, k, n],
                   "bytes": nbytes, "ops": ops,
                   "ms": cuda_ms(torch, fn),
                   # the wrapper's: the popcount matmul's holds its fold
                   # of the codes onto one grid (PyTorch kernels) beside
                   # the kernel; the int matmul's launches the kernel alone
                   "device_ms": graph_ms(torch, fn),
                   "kernel_device_ms": graph_ms(torch, alone),
                   "plain_ms": cuda_ms(torch, plain, reps=2, n=2),
                   "library_ms": cuda_ms(torch, library),
                   "library_device_ms": graph_ms(torch, library)}
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops,
                                                     INT8_OPS_PER_S)
            _exact(torch, alone(), fn(), f"LM {what} {kernel} alone")
            records.append(rec)
            alone_ms = f", of it the kernel {rec['kernel_device_ms']:.5f}"
            print(f"[lm kernels] {kernel} {what} (M, K, N) = {(m, k, n)}: "
                  f"bit-exact with its plain version; {rec['ms']:.4f} ms, "
                  f"device {rec['device_ms']:.5f}{alone_ms} ms (plain "
                  f"{rec['plain_ms']:.4f}, f32 torch.matmul "
                  f"{rec['library_ms']:.4f}, device "
                  f"{rec['library_device_ms']:.5f}, bound "
                  f"{rec['bound_ms']:.6f} by {rec['bound_by']})",
                  flush=True)
    return records, {MM: 0.0, INT: 0.0}


def lm_prefill_parity(torch, params, packed, cfg, prompts) -> dict:
    """Phase 10c: prefill logits of the packed path against the unpacked
    ``w1a8_eval`` path on the same card, the packed run's codes that round
    across a tie forced to the unpacked run's (`train.ties`, each within
    1e-3 of a tie on both sides): within LM_TOL·max|logit|, and greedy
    tokens equal wherever the unpacked run's top-2 gap exceeds that. The
    unforced difference is printed beside it."""
    from repro_torch.models import layers
    from repro_torch.serve.engine import prefill
    from repro_torch.train import ties

    with torch.no_grad():
        with ties.record("quantize_act", module=layers) as recorded:
            want, _ = prefill(cfg, params, prompts, max_len=LM_MAX_LEN,
                              mode="w1a8_eval")
        with ties.forced(recorded, "quantize_act", module=layers) as counts:
            got, _ = prefill(cfg, packed, prompts, max_len=LM_MAX_LEN,
                             mode="w1a8_eval")
        free, _ = prefill(cfg, packed, prompts, max_len=LM_MAX_LEN,
                          mode="w1a8_eval")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    free_err = float((free - want).abs().max())
    if not err <= LM_TOL * scale:
        raise AssertionError(f"packed prefill logits {err} off the unpacked "
                             f"path's, > {LM_TOL} * {scale}")
    top2 = torch.topk(want, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > LM_TOL * scale
    same = torch.argmax(got, -1) == torch.argmax(want, -1)
    if not bool(same[decided].all()):
        raise AssertionError("packed prefill: a greedy token differs where "
                             "the top-2 gap exceeds the tolerance")
    return {"max_abs_err": err, "max_abs_logit": scale,
            "rel_err": err / scale, "unforced_max_abs_err": free_err,
            "codes_forced": sum(counts), "quantizer_calls": len(counts),
            "decided_rows": int(decided.sum()), "rows": int(len(decided))}


def step_profile(torch, fn, popcount_per_call: int, n: int = 5,
                 tries: int = 5, top: int = 12) -> dict:
    """torch.profiler over ``n`` calls of ``fn`` (a decode step) after a
    warm one: device busy ms per call (the union of the traced device
    intervals), profiled wall ms and idle share, device records per call
    and device ms per call by kernel name (the ``top`` largest). A trace
    must hold ``popcount_per_call`` popcount matmul records a call, or it
    has lost device records and is taken again, up to ``tries`` times, and
    then `events_profile` times the calls (idle share, device records and
    the kernels' ms not measured)."""
    from repro_torch.launch.profile import union_us
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / n
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum("matmul_popcount" in e.name for e in events) == \
                popcount_per_call * n:
            break
    else:
        rec = events_profile(torch, fn, n, tries)
        return {"device_busy_ms": rec["device_busy_ms"],
                "wall_ms": rec["wall_ms"], "idle_share": None,
                "device_records": None, "device_ms_by_kernel": {},
                "device_ms_rest": None, "device_timing": "cuda events"}
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / n
    order = sorted(by_name.items(), key=lambda kv: -kv[1])
    busy = union_us((e.time_range.start, e.time_range.end)
                    for e in events) / 1e3 / n
    return {"device_busy_ms": busy, "wall_ms": wall_ms,
            "idle_share": 1.0 - busy / wall_ms,
            "device_records": len(events) / n,
            "device_ms_by_kernel": dict(order[:top]),
            "device_ms_rest": sum(v for _, v in order[top:]),
            "device_timing": "torch.profiler"}


def graph_ms(torch, fn, n: int = 20, reps: int = 5) -> float:
    """Device ms per call of ``fn``: CUDA events around replays of one
    CUDA graph that holds ``n`` calls, so no host work sits between the
    launches (median of ``reps`` replays). Phase 10 times its calls so,
    not with torch.profiler: on the card, after phase 9, five traces in a
    row of one short call came back short of device records."""
    from repro_torch.kernels import _build
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with _build.capturing(), torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(torch, graph.replay, reps=reps, n=1) / n


def drive_lm(torch, np, dev, smi: str) -> dict:
    """Phase 10: the LM stack's dense family on the card. The popcount and
    int matmuls at the LM path's shapes (`check_lm_kernels`); chatglm3-6b
    at full width from a seeded init, deployed (`deploy_lm`) and served
    through the launcher's `run_lm` (packed, 8 requests, 16 new tokens,
    slots 4, max_len 128) with every launch count zeroed just before and
    read just after: done-mask tokens equal to host-checked ones (run_lm
    raises otherwise), and per decode step exactly one popcount matmul
    launch a packed projection (7 × 28 = 196, derived from the config) and
    no other kernel; the packed prefill against the unpacked one
    (`lm_prefill_parity`); one `w1a8_linear_infer_int` call, counted the
    same way; the decode step's CUDA-event ms, device busy ms and idle
    share (torch.profiler), and peak memory. Returns (the f32 params,
    which phase 11 serves, and the record)."""
    import argparse

    from repro_torch import configs
    from repro_torch.core import packing, w1a8
    from repro_torch.launch import serve as launch
    from repro_torch.models.transformer import init_lm_params, tree_items
    from repro_torch.serve import deploy_lm, prefill
    from repro_torch.serve.engine import decode_step

    cfg = configs.get_config(LM_ARCH)
    t0 = time.perf_counter()
    kernel_rows, kernel_errs = check_lm_kernels(torch, np, dev, cfg)
    print(f"[lm kernels] {len(kernel_rows)} timed calls in "
          f"{time.perf_counter() - t0:.1f} s ({smi})", flush=True)
    per_step = len(lm_projections(cfg)) * cfg.num_layers
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = init_lm_params(cfg, gen, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        args = argparse.Namespace(
            workload="lm", arch=LM_ARCH, reduced=False, packed=True,
            requests=LM_REQUESTS, max_new=LM_MAX_NEW, slots=LM_SLOTS,
            max_len=LM_MAX_LEN, temperature=0.0, stop_token=[], seed=SEED,
            device=str(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        _zero(launch.KERNELS)
        record = launch.run_lm(args, params=params)
        torch.cuda.synchronize()
        counts = launch.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
    want = {"w1a8_matmul_popcount": float(per_step)}
    if record["kernel_launches_per_decode_step"] != want:
        raise AssertionError(f"LM decode step: launches "
                             f"{record['kernel_launches_per_decode_step']}, "
                             f"want {want}")
    if set(n for name, n in counts.items()
           if name != "w1a8_matmul_popcount") != {0}:
        raise AssertionError(f"LM serve launched other kernels: {counts}")
    print(f"[lm serve] {LM_ARCH} full width, packed, {LM_REQUESTS} requests "
          f"x {LM_MAX_NEW} tokens, slots {LM_SLOTS}: done-mask tokens equal "
          f"host-checked; {per_step} w1a8_matmul_popcount launches a decode "
          f"step ({record['decode_steps']} steps), "
          f"{counts['w1a8_matmul_popcount']} in the run; "
          f"{record['tok_per_s']:.2f} tok/s, tick p50 "
          f"{record['tick_p50_ms']:.3f} ms, p95 {record['tick_p95_ms']:.3f} "
          f"ms, peak memory {peak / 2 ** 30:.2f} GiB; init "
          f"{init_s:.1f} s ({smi})", flush=True)
    with torch.no_grad():
        packed = deploy_lm(params)
        sign_bytes = sum(int(x.numel()) * 4 for name, x in tree_items(packed)
                         if "w_packed" in name)
        emb_bytes = packed["embed"]["emb"].numel() * 4
        prompts = torch.tensor(
            [[2 + i, 11, 7 + i % 3] for i in range(LM_SLOTS)],
            dtype=torch.int32, device=dev)
        parity = lm_prefill_parity(torch, params, packed, cfg, prompts)
        print(f"[lm parity] packed prefill logits vs unpacked w1a8_eval on "
              f"the card: max_abs {parity['max_abs_err']:.6g} of max|logit| "
              f"{parity['max_abs_logit']:.6g} (rel {parity['rel_err']:.3g}, "
              f"tol {LM_TOL}; {parity['codes_forced']} tie codes forced "
              f"over {parity['quantizer_calls']} quantizer calls; unforced "
              f"max_abs {parity['unforced_max_abs_err']:.6g}); greedy "
              f"tokens equal on {parity['decided_rows']} of "
              f"{parity['rows']} rows decided beyond the tolerance",
              flush=True)
        # one w1a8_linear_infer_int call at the wo projection, counted
        k, n = lm_projections(cfg)["wo"]
        o = packed["slots"][0]["attn"]["wo"]
        dep = {"w_packed": o["w_packed"][0], "mul_prev": o["act_step"][0],
               "div_post": o["alpha"][0],
               "bias": torch.zeros(n, device=dev), "k": k}
        a = torch.randint(0, 256, (LM_SLOTS, k), generator=gen,
                          device=dev).to(torch.uint8)
        _zero(launch.KERNELS)
        y = w1a8.w1a8_linear_infer_int(dep, a)
        torch.cuda.synchronize()
        int_counts = launch.launch_counts()
        if {k_: c for k_, c in int_counts.items() if c} != \
                {"w1a8_matmul_int": 1}:
            raise AssertionError(f"w1a8_linear_infer_int: {int_counts}")
        signs = packing.unpack_signs(dep["w_packed"].cpu(), k,
                                     dtype=torch.int64)
        _exact(torch, w1a8.int_sums(dep, a).cpu(),
               (a.cpu().to(torch.int64) @ signs).to(torch.int32),
               "w1a8_linear_infer_int sums vs int64 on the CPU")
        if not bool(torch.isfinite(y).all()):
            raise AssertionError("w1a8_linear_infer_int: non-finite output")
        # the decode step alone, on the served shape
        logits, cache = prefill(cfg, packed, prompts, max_len=LM_MAX_LEN,
                                mode="w1a8_eval")
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]

        def step():
            return decode_step(cfg, packed, cache, tok, mode="w1a8_eval")
        step_ms = cuda_ms(torch, step, reps=3, n=5)
        prof = step_profile(torch, step, per_step)
    step_bound = (sign_bytes + emb_bytes) / HBM_BYTES_PER_S * 1e3
    print(f"[lm decode step] {LM_ARCH} at M = {LM_SLOTS}: {step_ms:.3f} ms "
          f"(CUDA events), device busy {prof['device_busy_ms']:.4f} ms, "
          f"profiled wall {prof['wall_ms']:.3f} ms, idle share "
          f"{_num(prof['idle_share'], '.4f')}, "
          f"{_num(prof['device_records'], '.0f')} device records a step "
          f"({prof['device_timing']}); bound {step_bound:.4f} ms ({sign_bytes / 1e9:.3f}"
          f" GB of sign words + {emb_bytes / 1e9:.3f} GB of f32 "
          f"unembedding at 3.35 TB/s) ({smi})", flush=True)
    for name, ms in prof["device_ms_by_kernel"].items():
        print(f"[lm decode step] device ms a step {ms:.4f}: {name[:90]}",
              flush=True)
    print(f"[lm decode step] device ms a step "
          f"{_num(prof['device_ms_rest'], '.4f')}: the rest", flush=True)
    return params, {"card": smi, "arch": LM_ARCH, "kernels": kernel_rows,
            "kernel_errs": kernel_errs, "serve": record,
            "launches": counts, "int_call_launches": int_counts,
            "per_decode_step": per_step, "peak_memory_bytes": peak,
            "init_s": init_s, "parity": parity, "step_ms": step_ms,
            "step_profile": prof, "step_bound_ms": step_bound,
            "sign_bytes": sign_bytes, "emb_bytes": emb_bytes}


def check_dispatch_launches(launches: dict, dispatches: int, configs,
                            what: str) -> None:
    """``launches`` by kernel equal ``dispatches`` times `per_dispatch` of
    ``configs`` (each replay adds the launches its capture recorded)."""
    per = per_dispatch(configs)
    for name in set(launches) | set(per):
        if launches.get(name, 0) != dispatches * per.get(name, 0):
            raise AssertionError(f"{what}: {name}: {launches.get(name, 0)} "
                                 f"launches for {dispatches} dispatches, "
                                 f"want {per.get(name, 0)} each")


def drive_tiers(torch, dev, smi: str, lm_params) -> dict:
    """Phase 11: the launcher's fleet, the traffic harness's real and model
    modes, and compose on phase 10's f32 params, each with every launch
    count zeroed just before and read just after."""
    import argparse

    from repro_torch.launch import serve as launch
    from repro_torch.launch import traffic

    serve_out = ROOT / "build" / "tiers_serve.json"
    fleet_out = ROOT / "build" / "tiers_fleet.json"
    for path in (serve_out, fleet_out):
        path.parent.mkdir(exist_ok=True)
        path.unlink(missing_ok=True)
    counts = {}
    # (a) the launcher's detect with a 2-replica autoscaled fleet
    _zero(launch.KERNELS)
    record = launch.main(["--workload", "detect", "--requests", "512",
                          "--slots", str(BATCH), "--depth", "2",
                          "--profile", "tuned", "--replicas", "2",
                          "--autoscale", "--out", str(serve_out)])
    counts["launcher fleet"] = launch.launch_counts()
    fleet = record["fleet"]
    check_dispatch_launches(fleet["launches"], fleet["dispatches"],
                            record["configs"]["320"], "launcher fleet")
    if fleet["requests_lost"] or sum(fleet["drops_by_cause"].values()):
        raise AssertionError(f"launcher fleet: {fleet['drops_by_cause']}")
    print(f"[fleet] launcher detect, 512 requests, 2 replicas autoscaled "
          f"(replicas {fleet['replicas_min']}→{fleet['replicas_max']}, "
          f"{len(fleet['scale_events'])} scale events): payloads bit-exact "
          f"with the single scheduler, 0 lost, 0 dropped; "
          f"{fleet['dispatches']} dispatches, launches "
          f"{ {k: v for k, v in fleet['launches'].items() if v} }; single "
          f"scheduler {record['img_per_s']:.2f} img/s, tick p50 "
          f"{record['tick_p50_ms']:.4f} ms ({smi})", flush=True)
    # (b) real replicas: 1 against 2, bit for bit
    _zero(launch.KERNELS)
    real = traffic.main(["--mode", "real", "--requests", "256",
                         "--replicas", "2", "--out", str(fleet_out)])
    counts["traffic real"] = launch.launch_counts()
    check_dispatch_launches(
        real["launches"], real["dispatches_single"]
        + real["dispatches_fleet"], real["configs"], "traffic real")
    print(f"[traffic real] 256 requests at 320, slots {real['slots']}: "
          f"1 replica {real['img_per_s_single']:.2f} img/s, 2 replicas "
          f"{real['img_per_s_fleet']:.2f} img/s; completed sets equal, "
          f"payloads bit-exact ({smi})", flush=True)
    # (c) the model replay calibrated from (a)'s record
    model = traffic.run_model(argparse.Namespace(
        serve_bench=str(serve_out), slo_ms=5000.0, requests=2000,
        seed=SEED, max_seconds=0.0))
    cells = {f"{kind}/{name}": cell for kind in traffic.TRACES
             for name, cell in model[kind].items()}
    if len(cells) != 12 or any(c["requests_lost"] for c in cells.values()):
        raise AssertionError(f"model replay: {len(cells)} cells, lost "
                             f"{[c['requests_lost'] for c in cells.values()]}")
    cal = model["config"]
    print(f"[traffic model] 12 cells, {model['total_requests']} requests, "
          f"0 lost; calibration width {cal['width']}, depth {cal['depth']}, "
          f"tick {cal['tick_ms']:.4f} ms: slo {cal['slo_ms']} ms = "
          f"{cal['slo_ticks']} ticks; attainment "
          f"{ {k: round(c['slo_attainment'], 4) for k, c in cells.items()} }",
          flush=True)
    # (d) compose on phase 10's params, at full width
    args = argparse.Namespace(
        device=str(dev), requests=8, buckets="320", seed=SEED,
        slots=LM_SLOTS, depth=2, profile="tuned", arch=LM_ARCH,
        reduced=False, max_new=LM_MAX_NEW, max_len=LM_MAX_LEN,
        temperature=0.0, stop_token=[])
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(launch.KERNELS)
    with torch.no_grad():
        compose = launch.run_compose(args, params=lm_params)
    torch.cuda.synchronize()
    counts["compose"] = launch.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if compose["handoffs"] != 8 or compose["lost"] or compose["duplicated"]:
        raise AssertionError(f"compose: {compose['handoffs']} hand-offs, "
                             f"{compose['lost']} lost, "
                             f"{compose['duplicated']} duplicated")
    check_dispatch_launches(compose["launches"],
                            compose["detect_dispatches"],
                            compose["configs"]["320"], "compose")
    print(f"[compose] {LM_ARCH} full width, float, 8 requests x "
          f"{LM_MAX_NEW} greedy tokens, slots {LM_SLOTS}: 0 lost, 0 "
          f"duplicated, 8 hand-offs, prompts the template; "
          f"{compose['ticks']} ticks, {compose['wall_s']:.2f} s, "
          f"{compose['detect_dispatches']} detect dispatches, peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({smi})", flush=True)
    return {"launches": counts, "launcher": record, "real": real,
            "model": model, "compose": compose, "compose_peak_bytes": peak,
            "summary": {
                "launcher_fleet": {k: fleet[k] for k in (
                    "dispatches", "replicas_min", "replicas_max",
                    "requests_completed", "requests_lost")},
                "img_per_s_single": real["img_per_s_single"],
                "img_per_s_fleet": real["img_per_s_fleet"],
                "calibration": {k: cal[k] for k in (
                    "width", "depth", "tick_ms", "slo_ticks")},
                "compose": {k: compose[k] for k in (
                    "ticks", "wall_s", "handoffs", "lost", "duplicated")},
                "compose_peak_bytes": peak}}


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
    entries = check_table()
    secs = _build.build_all()
    print(f"[build] {len(_build.SOURCES)} kernels built with nvcc in "
          f"{secs:.1f} s", flush=True)
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}")
    sass = tensor_core_counts(_build)


    t0 = time.perf_counter()
    layers, off_grid, errs = check_kernels(torch, np, dev)
    print(f"[check] {len(layers)} layer shapes in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    pc_layers, pc_errs = check_popcount_kernels(torch, np, dev)
    print(f"[popcount] {len(pc_layers)} kernel calls checked in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    one = torch.zeros(1, device=dev)
    floor_ms = device_profile(torch, lambda: torch.add(one, 1.0))[
        "device_busy_ms"]
    print(f"[floor] one-element torch.add: device {floor_ms:.4f} ms a call",
          flush=True)
    from repro_torch.kernels import config
    table_batch = json.loads(config.DEFAULT_TABLE.read_text())["batch"]
    winners = check_winners(torch, entries, table_batch)
    records, by_path = {}, {}
    for profile in PROFILES:
        records[profile], by_path[f"launcher {profile}"] = \
            drive_main_path(profile)
    record = records["tuned"]
    multires, by_path["launcher multires"] = drive_multires()
    dispatch_profiles = {p: profile_dispatch(p) for p in PROFILES}
    pc_record = drive_popcount(torch, np, dev)
    by_path["popcount forward and int call"] = pc_record["launches"]
    by_path["dot forward"] = pc_record["dot_launches"]
    per = {p: per_dispatch(records[p]["configs"]["320"]) for p in PROFILES}
    nms_record = check_graphs_and_postprocess(torch, np, dev)
    int_record = drive_int(torch, np, dev)
    by_path["int forward"] = int_record["launches"]
    t0 = time.perf_counter()
    qat_record = drive_qat(torch, np, dev)
    print(f"[qat] phase 9 in {time.perf_counter() - t0:.1f} s", flush=True)
    by_path["qat pipeline"] = qat_record["launches"]
    t0 = time.perf_counter()
    lm_params, lm_record = drive_lm(torch, np, dev, smi)
    print(f"[lm] phase 10 in {time.perf_counter() - t0:.1f} s", flush=True)
    by_path["lm serve"] = lm_record["launches"]
    by_path["lm int call"] = lm_record["int_call_launches"]
    t0 = time.perf_counter()
    tiers = drive_tiers(torch, dev, smi, lm_params)
    del lm_params
    print(f"[tiers] phase 11 in {time.perf_counter() - t0:.1f} s", flush=True)
    by_path.update(tiers["launches"])
    # every driven path's launches: the three launcher runs, phase 5's
    # eager forwards (popcount on both pool routes, dot fused) and int
    # call, phase 7's integer forward, phase 9's QAT pipeline, phase 10's
    # LM serve and int call, and phase 11's launcher fleet, real traffic
    # and compose
    launches = {name: sum(path.get(name, 0) for path in by_path.values())
                for name in KERNELS}

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        popcount = name not in DOT
        rows = [r for r in (pc_layers if popcount else layers)
                if r["kernel"] == name]
        peak = INT8_OPS_PER_S if popcount else BF16_OPS_PER_S
        t_ops = sum(r["ops"] / peak for r in rows)
        t_bytes = sum(r["bytes"] / HBM_BYTES_PER_S for r in rows)
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": {path: counts.get(name, 0)
                                 for path, counts in by_path.items()},
            "launches_per_dispatch": {p: per[p].get(name, 0)
                                      for p in PROFILES}}
        if name == INT_PE:
            rows = int_record["layers"]
            t_ops = sum(r["ops"] / INT8_OPS_PER_S for r in rows)
            t_bytes = sum(r["bytes"] / HBM_BYTES_PER_S for r in rows)
            entry.update({
                "counterpart_of": "the numpy int64 yolo_forward_int (no "
                                  "Pallas kernel)",
                "max_abs_err": 0,
                "launches_per_forward": int_record["launches"][INT_PE],
                "tensor_core_instructions": sass[name],
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "layers": [r["layer"] for r in rows],
                "planes": [r["planes"] for r in rows],
                "ms_per_forward": int_record["ms_per_forward"],
                "device_ms_per_forward":
                    int_record["profile"]["device_busy_ms"],
                **{k: sum(r[k] for r in rows) for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                    "library_device_ms")}})
            if not entry["launches"]:
                raise AssertionError(f"{name}: no launch on its path")
            kernels.append(entry)
            continue
        if name == "detect_postprocess":
            entry.update({
                "counterpart_of": "the jitted postprocess: decode_head and "
                                  "a lax.fori_loop NMS (no Pallas kernel)",
                "max_abs_err": 0.0, "library_device_ms": None,
                "tensor_core_instructions": sass[name],
                **{k: nms_record[k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape", "nms_device_ms",
                    "decode_head_device_ms", "tiles")}})
            if not entry["launches"]:
                raise AssertionError(f"{name}: no launch on its path")
            kernels.append(entry)
            continue
        lm_rows = [r for r in lm_record["kernels"] if r["kernel"] == name]
        if lm_rows:
            # at the LM path's shapes, beside the detector's below
            entry["lm"] = {
                "shapes": [[r["what"], *r["shape"]] for r in lm_rows],
                "launches_per_decode_step":
                    lm_record["serve"]["kernel_launches_per_decode_step"]
                    .get(name, 0),
                "max_abs_err": lm_record["kernel_errs"][name],
                **{k: [r[k] for r in lm_rows] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms")}}
            entry["lm"]["kernel_device_ms"] = [
                r["kernel_device_ms"] for r in lm_rows]
        if popcount:
            # every call is held bit for bit: the worst difference found
            entry["max_abs_err"] = pc_errs[name]
            if name in POPCOUNT:
                entry["launches_per_forward"] = {
                    route: r["launches"][name]
                    for route, r in pc_record["routes"].items()}
        else:
            e = errs[name]
            entry.update({
                # f32 error where the kernel has an f32 output; the pool
                # kernel writes codes only, so its error is in codes
                "max_abs_err": (e["f32"] if e["f32"] is not None
                                else e["codes"]),
                "max_codes_diff": e["codes"], "max_f32_err": e["f32"]})
        entry.update({
            "ms": sum(r["ms"] for r in rows),
            "device_ms": sum(r["device_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": sum(r["library_ms"] for r in rows),
            "library_device_ms": sum(r["library_device_ms"] for r in rows),
            "layers": [r["layer"] for r in rows]})
        entry["tensor_core_instructions"] = sass[name]
        if not entry["launches"]:
            raise AssertionError(f"{name}: no launch on its path")
        kernels.append(entry)
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "layers": layers, "off_grid": off_grid,
         "popcount_layers": pc_layers,
         "kernels": kernels, "launchers": records, "multires": multires,
         "dispatch_profiles": dispatch_profiles, "winners": winners,
         "popcount_forward": pc_record, "nms": nms_record,
         "int_forward": int_record, "qat": qat_record, "lm": lm_record,
         "tiers": tiers, "floor_device_ms": floor_ms},
        indent=1))
    print(json.dumps({"kernels": kernels, "img_per_s": record["img_per_s"],
                      "requests": record["requests"],
                      "device_busy_ms_per_dispatch": {
                          p: r["device_busy_ms_per_dispatch"]
                          for p, r in dispatch_profiles.items()},
                      "popcount_forward": pc_record["routes"],
                      "dot_ms_per_forward": pc_record["dot_ms_per_forward"],
                      "dot_profile": pc_record["dot_profile"],
                      "int_ms_per_forward": int_record["ms_per_forward"],
                      "int_profile": int_record["profile"],
                      "qat": {k: qat_record["train"][k] for k in (
                          "ms_per_step", "img_per_s", "peak_memory_bytes",
                          "held_out_loss_before", "held_out_loss_after")},
                      "qat_step_device_busy_ms":
                          qat_record["step_profile"]["device_busy_ms"],
                      "qat_idle_share": qat_record["step_profile"][
                          "idle_share_of_step"],
                      "qat_final_raw": qat_record["final_raw"],
                      "lm": {"arch": LM_ARCH, "packed": True,
                             **{k: lm_record["serve"][k] for k in (
                                 "tok_per_s", "tick_p50_ms", "tick_p95_ms",
                                 "kernel_launches_per_decode_step")},
                             "decode_step_ms": lm_record["step_ms"],
                             "decode_step_device_busy_ms":
                                 lm_record["step_profile"]["device_busy_ms"],
                             "decode_step_idle_share":
                                 lm_record["step_profile"]["idle_share"],
                             "decode_step_bound_ms":
                                 lm_record["step_bound_ms"],
                             "peak_memory_bytes":
                                 lm_record["peak_memory_bytes"],
                             "prefill_parity": lm_record["parity"]},
                      "tiers": tiers["summary"],
                      "trace_fallbacks": TRACE_FALLBACKS,
                      "floor_device_ms": floor_ms, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
