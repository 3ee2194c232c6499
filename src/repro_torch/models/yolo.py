"""The paper's W1A8 YOLOv3-tiny-like detector (Table 1), three datapaths:

  float   — eval model, the verification oracle ("ONNX Runtime" role),
  int     — the bit-exact integer deployment pipeline ("RTL" role): Q0.8
            input, Q5.11/Q2.14 conv1, the sign PE with fixed-point Mul_prev
            fused into accumulation, (mult, shift) requantization, Q1.15/
            Q4.12 conv11 emitting signed Q*.15 raw; one integer PE launch
            (``csrc/w1a8_int_pe.cu``) per layer,
  kernel  — packed 1-bit weights through the CUDA kernels, fused epilogues.

Input 320×320×3 → output 10×10×75 (y/x/channel), 0.74 M params. Counterpart
of ``repro/models/yolo.py``. Tensors are NHWC and weights HWIO at every
public function, as in the reference; only the internal ``F.conv2d`` calls
see NCHW.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.packing import pack_signs
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quant import (ACT_QMAX, binarize_ste, binarize_weight,
                                    lsq_fake_quant, lsq_grad_scale,
                                    quantize_act)
from repro_torch.device import full_f32, resolve_device
from repro_torch.kernels import config as _cfg
from repro_torch.kernels.config import KernelConfig
from repro_torch.kernels.w1a8_conv import ops as conv_ops
from repro_torch.kernels.w1a8_int import ops as int_ops
from repro_torch.kernels.w1a8_int import planes as int_planes
from repro_torch.kernels.w1a8_int import ref as int_ref
from repro_torch.kernels.w1a8_matmul import ops as mm_ops

# "tuned" resolves the port's autotune table (`kernels.config.resolve_tuned`:
# per layer the faster accum mode, its row blocking and pool route);
# "default" is the heuristic dot config with the unfused pool route.
PROFILES = ("tuned", "default")


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    kind: str          # "std" | "w1a8"
    cin: int
    cout: int
    ksize: int
    pool: bool


# Table 1, exactly.
YOLO_LAYERS = (
    ConvSpec("conv1", "std", 3, 16, 3, True),
    ConvSpec("conv2", "w1a8", 16, 32, 3, True),
    ConvSpec("conv3", "w1a8", 32, 64, 3, True),
    ConvSpec("conv4", "w1a8", 64, 128, 3, True),
    ConvSpec("conv5", "w1a8", 128, 128, 3, False),
    ConvSpec("conv6", "w1a8", 128, 128, 3, False),
    ConvSpec("conv7", "w1a8", 128, 128, 3, True),
    ConvSpec("conv8", "w1a8", 128, 128, 3, False),
    ConvSpec("conv9", "w1a8", 128, 64, 1, False),
    ConvSpec("conv10", "w1a8", 64, 64, 3, False),
    ConvSpec("conv11", "std", 64, 75, 1, False),
)

INPUT_SIZE = 320
NUM_ANCHORS, NUM_CLASSES = 3, 20          # 75 = 3 * (5 + 20), VOC
GRID = 10                                 # the head's side at INPUT_SIZE


def init_yolo_params(seed: int, *, device=None) -> dict:
    """Random init from a numpy seed: w ~ N(0, 1/fan_in) (HWIO), b = 0,
    act_step = 0.05 per input channel."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params = {}
    for spec in YOLO_LAYERS:
        fan_in = spec.ksize * spec.ksize * spec.cin
        w = rng.standard_normal((spec.ksize, spec.ksize, spec.cin,
                                 spec.cout)) / np.sqrt(fan_in)
        layer = {"w": w.astype(np.float32),
                 "b": np.zeros((spec.cout,), np.float32)}
        if spec.kind == "w1a8" or spec.name == "conv11":
            layer["act_step"] = np.full((spec.cin,), 0.05, np.float32)
        params[spec.name] = {k: torch.from_numpy(v).to(dev)
                             for k, v in layer.items()}
    return params


def count_params() -> dict:
    """Parameter count (weights + biases), matching the paper's 0.74 M."""
    weights = sum(s.ksize ** 2 * s.cin * s.cout for s in YOLO_LAYERS)
    biases = sum(s.cout for s in YOLO_LAYERS)
    return {"weights": weights, "biases": biases, "total": weights + biases}


def spatial_sizes(input_size: int = INPUT_SIZE) -> dict:
    """Input H=W per layer for one resolution bucket (a multiple of 32)."""
    if input_size <= 0 or input_size % 32:
        raise ValueError(f"input size must be a positive multiple of 32 "
                         f"(5 pools), got {input_size}")
    sizes, h = {}, input_size
    for s in YOLO_LAYERS:
        sizes[s.name] = h
        if s.pool:
            h //= 2
    return sizes


def count_gflops() -> dict:
    """FLOPs under the paper's full-precision-ops convention (``paper``)
    and at face value including binary-weight MACs (``total``)."""
    sizes = spatial_sizes()
    full, binary, aux = 0, 0, 0
    for s in YOLO_LAYERS:
        hw = sizes[s.name] ** 2
        macs = s.ksize ** 2 * s.cin * s.cout * hw
        if s.kind == "std":
            full += 2 * macs + s.cout * hw          # MACs + bias
        else:
            binary += 2 * macs                       # sign-controlled add/sub
            aux += s.cin * hw                        # Mul_prev m_i·a_i
            aux += 3 * s.cout * hw                   # post: scale, bias, round
        if s.pool:
            aux += 3 * s.cout * (sizes[s.name] // 2) ** 2  # 2×2 max = 3 cmp
    return {"paper_gflops": (full + aux) / 1e9,
            "total_gflops": (full + binary + aux) / 1e9,
            "binary_discount64_gflops": (full + aux + binary / 64) / 1e9}


# ---------------------------------------------------------------------------
# Float forward (QAT train / eval oracle)
# ---------------------------------------------------------------------------

def _conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC x, HWIO w; SAME for 3×3, VALID for 1×1 (stride 1). Full f32:
    TF32 would flip codes downstream (`device.full_f32`)."""
    pad = 1 if w.shape[0] == 3 else 0
    with full_f32():
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     padding=pad)
    return y.permute(0, 2, 3, 1)


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _conv1(p: dict, images: torch.Tensor) -> torch.Tensor:
    return torch.relu(_conv2d(images, fxp.CONV1_W.roundtrip(p["w"]))
                      + fxp.CONV1_B.roundtrip(p["b"]))


def _conv11(p: dict, xq: torch.Tensor) -> torch.Tensor:
    return (_conv2d(xq, fxp.CONV11_W.roundtrip(p["w"]))
            + fxp.CONV11_B.roundtrip(p["b"]))


def _w1a8_float(p: dict, x: torch.Tensor) -> torch.Tensor:
    xq = quantize_act(x, p["act_step"]) * p["act_step"]
    alpha = torch.mean(torch.abs(p["w"]), dim=(0, 1, 2))
    return torch.relu(_conv2d(xq, binarize_weight(p["w"])) * alpha + p["b"])


def _lsq(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The layer's input through LSQ fake quantization, its gradient scale
    from the elements per channel."""
    return lsq_fake_quant(x, p["act_step"],
                          lsq_grad_scale(x.numel() // x.shape[-1]))


def _w1a8_train(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The W1A8 layer under QAT: LSQ on the input, the sign STE on the
    weights, α = mean|w| held constant (no gradient through it)."""
    alpha = torch.mean(torch.abs(p["w"].detach()), dim=(0, 1, 2))
    return torch.relu(_conv2d(_lsq(p, x), binarize_ste(p["w"])) * alpha
                      + p["b"])


def yolo_forward_float(params: dict, images: torch.Tensor, *,
                       train: bool = False) -> torch.Tensor:
    """images: (B, S, S, 3) in [0, 1]. Returns (B, S/32, S/32, 75) raw head.

    ``train=True`` is the QAT forward: conv1 and conv11 take the raw float
    w and b (no fixed-point roundtrip), conv11's input and every W1A8
    layer's go through `lsq_fake_quant`, and W1A8 weights through
    `binarize_ste`."""
    x = images
    for spec in YOLO_LAYERS:
        p = params[spec.name]
        if spec.name == "conv1":
            x = (torch.relu(_conv2d(x, p["w"]) + p["b"]) if train
                 else _conv1(p, x))
        elif spec.name == "conv11":
            x = (_conv2d(_lsq(p, x), p["w"]) + p["b"] if train else
                 _conv11(p, quantize_act(x, p["act_step"]) * p["act_step"]))
        else:
            x = _w1a8_train(p, x) if train else _w1a8_float(p, x)
        if spec.pool:
            x = _maxpool2(x)
    return x


def calibrate_yolo(params: dict, images: torch.Tensor, *,
                   per_channel: bool = True) -> dict:
    """Range-calibrate every activation quantizer: each act_step maps the
    observed (per-channel, or per-tensor) max to code 255, floored at 1e-4.
    Returns new params; the input dict is not changed."""
    params = {name: dict(p) for name, p in params.items()}
    x = images
    for spec in YOLO_LAYERS:
        p = params[spec.name]
        if spec.kind == "w1a8" or spec.name == "conv11":
            cmax = (torch.amax(torch.abs(x), dim=(0, 1, 2)) if per_channel
                    else torch.amax(torch.abs(x)))
            # a tensor divisor: CUDA would multiply by 1/255 for a number
            qmax = torch.tensor(float(ACT_QMAX), device=cmax.device)
            step = torch.clamp(cmax / qmax, min=1e-4)
            p["act_step"] = torch.broadcast_to(
                step, (x.shape[-1],)).to(torch.float32).contiguous()
        if spec.name == "conv1":
            x = _conv1(p, x)
        elif spec.name == "conv11":
            x = _conv11(p, quantize_act(x, p["act_step"]) * p["act_step"])
        else:
            x = _w1a8_float(p, x)
        if spec.pool:
            x = _maxpool2(x)
    return params


# ---------------------------------------------------------------------------
# Integer golden datapath (paper §4): deployment artifact and forward
# ---------------------------------------------------------------------------

FM = 16  # fractional bits of the fixed-point Mul_prev inside the PE

# the reference's names for the plain integer helpers
_rshift_round = int_ref.rshift_round
_im2col = int_ref.im2col


def _requant_multshift(scale: np.ndarray, bits: int = 15):
    """scale → (mult int, rshift) with mult in [2^(bits-1), 2^bits):
    x·scale ≈ (x·mult) >> rshift, the ONNX-style normalized requantizer.
    numpy float64, as the reference computes it."""
    scale = np.asarray(scale, np.float64)
    out_m = np.zeros(scale.shape, np.int64)
    out_s = np.zeros(scale.shape, np.int64)
    nz = scale > 0
    exp = np.floor(np.log2(scale[nz]))
    rshift = (bits - 1 - exp).astype(np.int64)
    mult = np.round(scale[nz] * (2.0 ** rshift)).astype(np.int64)
    # rounding may push mult to 2^bits; renormalize
    over = mult >= (1 << bits)
    mult[over] >>= 1
    rshift[over] -= 1
    out_m[nz], out_s[nz] = mult, rshift
    return out_m, out_s


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def deploy_yolo(params: dict) -> dict:
    """Float params → the integer deployment artifact ("COE" role), on the
    params' device.

    Keeps the reference's keys and int64 values (``w_raw``, ``b_raw``,
    ``post_mult``, ``post_shift``, ``m_raw``, ``signs`` (K, N) ±1,
    ``b_pre``). The constants are computed on the host in numpy float64 in
    the reference's order (``np.mean``, ``np.floor(np.log2(·))``,
    ``np.round`` half to even), so each equals the reference's bit for bit;
    `fold_int_pe` then adds what the integer PE reads beyond them.
    """
    dev = params["conv1"]["w"].device
    steps_next = {}   # each layer's output step: the next layer's input step
    for spec, nxt in zip(YOLO_LAYERS[:-1], YOLO_LAYERS[1:]):
        steps_next[spec.name] = np.broadcast_to(
            _f64(params[nxt.name]["act_step"]), (nxt.cin,))
    art = {"layers": []}
    for spec in YOLO_LAYERS:
        p = {k: _f64(v) for k, v in params[spec.name].items()}
        entry = {"spec": spec}
        if spec.name == "conv1":
            entry["w_raw"] = _fixed(fxp.CONV1_W, p["w"])
            entry["b_raw"] = _fixed(fxp.CONV1_B, p["b"])
            # acc scale 2^-19 (Q0.8 input × Q5.11 weights); bias at 2^-14
            # → <<5; post: /step_next ⇒ scale = 2^-19/step
            mult, shift = _requant_multshift(2.0 ** -19 / steps_next["conv1"])
            entry["post_mult"], entry["post_shift"] = mult, shift
        elif spec.name == "conv11":
            entry["w_raw"] = _fixed(fxp.CONV11_W, p["w"])
            entry["b_raw"] = _fixed(fxp.CONV11_B, p["b"])
            entry["m_raw"] = np.round(np.broadcast_to(
                p["act_step"], (spec.cin,)) * 2 ** FM).astype(np.int64)
        else:
            w2 = p["w"].reshape(-1, spec.cout)
            entry["signs"] = np.where(w2 >= 0, 1, -1).astype(np.int64)
            alpha = np.mean(np.abs(w2), axis=0)
            entry["m_raw"] = np.round(np.broadcast_to(
                p["act_step"], (spec.cin,)) * 2 ** FM).astype(np.int64)
            # post: y = acc·2^-FM·α + b, then /step_next — one fused
            # rounding: q = rshift(acc·mult + b_preshifted, shift)
            scale = alpha * 2.0 ** -FM / steps_next[spec.name]
            mult, shift = _requant_multshift(scale)
            entry["post_mult"], entry["post_shift"] = mult, shift
            entry["b_pre"] = np.round(p["b"] / steps_next[spec.name]
                                      * 2.0 ** shift).astype(np.int64)
        entry = {k: v if k == "spec" else torch.from_numpy(
            np.ascontiguousarray(v, np.int64)).to(dev)
            for k, v in entry.items()}
        art["layers"].append(fold_int_pe(entry))
    return art


def _fixed(fmt, x: np.ndarray) -> np.ndarray:
    """The float32 parameter as ``fmt``'s raw integers, int64."""
    raw = fmt.quantize(torch.from_numpy(x.astype(np.float32)))
    return raw.numpy().astype(np.int64)


def fold_int_pe(entry: dict) -> dict:
    """Adds what the integer PE reads beyond the reference's keys, once at
    deploy: a W1A8 layer's ``signs`` packed into sign words (``w_packed``,
    the kernel artifact's words bit for bit), conv1's and conv11's biases
    at the accumulator's scale (``b_shifted``: b_raw << 5 and << 3), the
    signed digit planes of the layer's constant W' (``planes``: a W1A8
    layer's m_raw per input channel, conv1's w_raw, the head's m[c]·w_raw
    in wrapping int64; `kernels/w1a8_int/planes.py`), and the (min, max)
    of a layer's shifts (``shifts``, host ints), so a forward reads
    nothing back from the card."""
    spec = entry["spec"]
    if spec.name == "conv1":
        entry["b_shifted"] = entry["b_raw"] << 5
        entry["planes"] = int_planes.dense_planes(
            entry["w_raw"].reshape(-1, spec.cout), spec.cin, 3)
    elif spec.name == "conv11":
        entry["b_shifted"] = entry["b_raw"] << 3
        entry["planes"] = int_planes.dense_planes(
            int_planes.head_weights(entry["m_raw"],
                                    entry["w_raw"].reshape(-1, spec.cout)),
            spec.cin, 1)
    else:
        entry["w_packed"] = pack_signs(entry["signs"], axis=0)
        entry["planes"] = int_planes.sign_planes(entry["m_raw"])
    if "post_shift" in entry:
        lo, hi = torch.aminmax(entry["post_shift"])
        entry["shifts"] = (int(lo), int(hi))
    return entry


def int_layer(entry: dict, x: torch.Tensor) -> torch.Tensor:
    """One layer of the integer datapath, one integer PE launch on CUDA
    tensors (its plain version on CPU ones): uint8 codes in, the next
    layer's uint8 codes (pooled where the spec pools) or, at conv11, the
    int64 raw head out."""
    spec: ConvSpec = entry["spec"]
    if spec.name == "conv1":
        return int_ops.int_pe_conv1(
            x, entry["w_raw"].reshape(-1, spec.cout), entry["b_shifted"],
            entry["post_mult"], entry["post_shift"], pool=spec.pool,
            shifts=entry["shifts"], planes=entry["planes"])
    if spec.name == "conv11":
        return int_ops.int_pe_head(
            x, entry["w_raw"].reshape(-1, spec.cout), entry["m_raw"],
            entry["b_shifted"], FM, planes=entry["planes"])
    return int_ops.w1a8_int_pe(
        x, entry["w_packed"], entry["m_raw"], entry["post_mult"],
        entry["b_pre"], entry["post_shift"], ksize=spec.ksize,
        pool=spec.pool, shifts=entry["shifts"], planes=entry["planes"])


def yolo_forward_int(art: dict, images_u8, device=None) -> torch.Tensor:
    """The bit-exact integer pipeline (the RTL-analogue datapath).

    images_u8: (B, S, S, 3) uint8 pixels (Q0.8 codes, value = px/256), a
    tensor or an array, S a multiple of 32. Runs on the card unless
    ``device="cpu"``; the artifact lives there too. Returns the (B, S/32,
    S/32, 75) int64 raw head at Q*.15 (float = raw / 2^15).
    """
    dev = resolve_device(device)
    x = torch.as_tensor(images_u8).to(dev)
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise TypeError(f"images_u8 must be (B, S, S, 3) uint8, got "
                        f"{x.dtype} {tuple(x.shape)}")
    spatial_sizes(x.shape[1])            # validates the ×32 constraint
    for entry in art["layers"]:
        x = int_layer(entry, x)
    return x


# ---------------------------------------------------------------------------
# Kernel path (packed 1-bit weights, fused epilogues)
# ---------------------------------------------------------------------------

def deploy_yolo_kernel(params: dict) -> dict:
    """Float params → packed-weight artifact for the kernel path."""
    art = {"layers": []}
    for i, spec in enumerate(YOLO_LAYERS):
        p = params[spec.name]
        entry = {"spec": spec}
        if spec.kind == "std":
            entry["w"] = p["w"].to(torch.float32)
            entry["b"] = p["b"].to(torch.float32)
            if spec.name == "conv11":
                entry["step_in"] = torch.broadcast_to(p["act_step"],
                                                      (spec.cin,))
        else:
            w2 = p["w"].reshape(-1, spec.cout)
            entry["w_packed"] = (conv_ops.conv_pack_weights(p["w"])
                                 if spec.ksize == 3 else
                                 mm_ops.w1a8_pack_weights(w2))
            entry["alpha"] = torch.mean(torch.abs(w2), dim=0).to(torch.float32)
            entry["step_in"] = torch.broadcast_to(
                p["act_step"], (spec.cin,)).to(torch.float32)
            entry["b"] = p["b"].to(torch.float32)
        if spec.name != "conv11":
            nxt = YOLO_LAYERS[i + 1]
            entry["step_out"] = torch.broadcast_to(
                params[nxt.name]["act_step"], (nxt.cin,)).to(torch.float32)
        art["layers"].append(fold_epilogue(entry))
    return art


def fold_epilogue(entry: dict) -> dict:
    """Adds a W1A8 layer's requant epilogue constants to its artifact entry,
    once at deploy: q = round(acc·div_eff + b_eff) with div_eff = α/s_next
    and b_eff = b/s_next, so a forward does no scale arithmetic."""
    if entry["spec"].kind == "w1a8":
        entry["div_eff"] = entry["alpha"] / entry["step_out"]
        entry["b_eff"] = entry["b"] / entry["step_out"]
    return entry


def build_detector(seed: int, calib_images, *, per_channel: bool = True,
                   buckets=None, device=None) -> tuple:
    """Init from a numpy seed + range-calibrate + pack.

    calib_images (B, S, S, 3) float in [0, 1], a tensor or an array.
    Returns (calibrated float params, `deploy_yolo_kernel` artifact); the
    float params stay the verification oracle for the packed path.
    ``buckets`` (image sides, multiples of 32) are recorded on the artifact
    for `DetectionBackend`; default: the calibration image size.
    """
    dev = resolve_device(device)
    calib = torch.as_tensor(calib_images, dtype=torch.float32).to(dev)
    if buckets is None:
        buckets = (int(calib.shape[1]),)
    buckets = tuple(dict.fromkeys(int(b) for b in buckets))
    for b in buckets:
        spatial_sizes(b)                 # validates the ×32 constraint
    params = init_yolo_params(seed, device=dev)
    params = calibrate_yolo(params, calib, per_channel=per_channel)
    art = deploy_yolo_kernel(params)
    art["buckets"] = buckets
    return params, art


def art_uniform_steps(art: dict) -> bool:
    """True iff every W1A8 layer's input steps are per-tensor uniform.

    A diagnostic only: popcount serves per-channel artifacts too, through
    the producer-side step fold (`fold_boundaries`)."""
    for entry in art["layers"][1:-1]:
        steps = entry["step_in"].reshape(-1)
        if not bool(torch.all(steps == steps[0])):
            return False
    return True


def yolo_layer_cells(batch: int = 1) -> list:
    """Structural autotune cells of every W1A8 layer at 320×320.

    Returns [(layer name, op, dims)] with conv dims (h, w, cin, cout) of
    the input plane and matmul dims (m, k, n), m = batch·h·w. Pooled
    layers contribute both their ``conv3x3_pool`` cell (fused route) and
    the plain ``conv3x3`` cell (unfused route); a cell may repeat (conv5,
    conv6 and conv7's conv cell share one), and callers dedupe by key.
    """
    sizes = spatial_sizes()
    cells = []
    for spec in YOLO_LAYERS:
        if spec.kind != "w1a8":
            continue
        h = sizes[spec.name]
        if spec.ksize == 3:
            if spec.pool:
                cells.append((spec.name, "conv3x3_pool",
                              (h, h, spec.cin, spec.cout)))
            cells.append((spec.name, "conv3x3", (h, h, spec.cin, spec.cout)))
        else:
            cells.append((spec.name, "matmul",
                          (batch * h * h, spec.cin, spec.cout)))
    return cells


def _layer_config(spec: ConvSpec, h: int, batch: int, *, profile: str,
                  accum, fuse_pool, table) -> KernelConfig:
    """One W1A8 layer's KernelConfig under the named profile; explicit
    ``accum`` / ``fuse_pool`` override the profile's choice."""
    if spec.ksize == 1:
        op, dims = "matmul", (batch * h * h, spec.cin, spec.cout)
    elif spec.pool:
        op, dims = "conv3x3_pool", (h, h, spec.cin, spec.cout)
    else:
        op, dims = "conv3x3", (h, h, spec.cin, spec.cout)
    if profile == "tuned":
        if accum is not None:
            cfg = _cfg.resolve(op, dims, accum=accum, table=table)
        else:
            cfg = _cfg.resolve_tuned(op, dims, table=table)
    else:
        cfg = KernelConfig(op=op, accum=accum or "dot", fused=False,
                           source=profile)
    if fuse_pool is not None:
        cfg = cfg.replace(fused=fuse_pool)
    return cfg.replace(out_step=1.0)


def kernel_configs(art: dict, bucket: int, batch: int, *,
                   profile: str = "tuned", fuse_pool: bool = None,
                   accum: str = None) -> tuple:
    """The W1A8 layers' KernelConfigs for one (bucket, batch) shape, in
    layer order, with their epilogue constants folded (`fold_boundaries`).
    Resolve once per shape and pass them to `yolo_forward_kernel`;
    `DetectionBackend` does so per bucket."""
    if profile not in PROFILES:
        raise ValueError(f"profile must be one of {PROFILES}, got {profile!r}")
    table = _cfg.load_table() if profile == "tuned" else None
    sizes = spatial_sizes(bucket)
    configs = tuple(_layer_config(e["spec"], sizes[e["spec"].name], batch,
                                  profile=profile, accum=accum,
                                  fuse_pool=fuse_pool, table=table)
                    for e in art["layers"][1:-1])
    fold_boundaries(art, configs)
    return configs


def fold_boundaries(art: dict, configs: tuple) -> dict:
    """The constants of a forward under ``configs``, folded once and kept
    on the artifact (``art["folded"]``, keyed by the configs).

    Producer-side fold: when a layer's consumer contracts with popcount,
    the producer's epilogue (conv1's quantizer for conv2) quantizes onto
    the uniform step s̄ = max_c s_c instead of the per-channel s_c, so the
    codes reaching the bit-packed sum already sit on one grid. conv10 feeds
    conv11 and keeps its per-channel step. Each W1A8 layer then gets
    q = round(acc·div + bias) with div = α/s_next and bias = b/s_next, and
    a popcount layer's div also carries its input step m̄ = max(s_in)
    (the consumer-side fold, the identity on codes already on one grid),
    in the reference's order: (α/s_next)·m̄. Layers whose boundaries keep
    their deployed steps reuse `fold_epilogue`'s constants, so the dot
    path's constants are the deployed ones bit for bit.

    Returns {"step1": conv1's quantizer step, "layers": [(div, bias,
    step_out)] in layer order}.
    """
    cache = art.setdefault("folded", {})
    if configs in cache:
        return cache[configs]
    layers = art["layers"]
    w1a8 = layers[1:-1]
    if len(configs) != len(w1a8):
        raise ValueError(f"{len(configs)} configs for {len(w1a8)} layers")

    def boundary_step(step_out, i):
        if i < len(configs) and configs[i].accum == "popcount":
            return torch.broadcast_to(torch.max(step_out), step_out.shape)
        return step_out

    s_in = boundary_step(layers[0]["step_out"], 0)
    folded = {"step1": s_in, "layers": []}
    for i, (entry, cfg) in enumerate(zip(w1a8, configs)):
        s_next = boundary_step(entry["step_out"], i + 1)
        if s_next is entry["step_out"]:
            div, bias = entry["div_eff"], entry["b_eff"]
        else:
            div, bias = entry["alpha"] / s_next, entry["b"] / s_next
        if cfg.accum == "popcount":
            div = div * torch.clamp(torch.max(s_in), min=1e-20)
        folded["layers"].append((div, bias, s_next))
        s_in = s_next
    cache[configs] = folded
    return folded


def yolo_forward_kernel(art: dict, images: torch.Tensor, *,
                        profile: str = "tuned", fuse_pool: bool = None,
                        accum: str = None, configs: tuple = None
                        ) -> torch.Tensor:
    """Packed path: images (B,S,S,3) in [0,1] → (B,S/32,S/32,75) f32 raw
    head, for any bucket S that is a multiple of 32. On CUDA tensors every
    W1A8 layer runs a CUDA kernel; on CPU tensors their plain versions.

    ``accum="popcount"`` contracts every W1A8 layer in the binary domain
    (XNOR-popcount); a per-channel artifact serves through it by the
    producer-side step fold of `fold_boundaries`. Between layers the
    activations are uint8-code QTensors, requantized in each kernel's
    epilogue with constants folded once per configs, and out_step = 1.
    ``configs`` (from `kernel_configs` at this shape) skips the per-call
    resolution of profile/accum/fuse_pool.
    """
    if configs is None:
        configs = kernel_configs(art, images.shape[1], images.shape[0],
                                 profile=profile, fuse_pool=fuse_pool,
                                 accum=accum)
    folded = fold_boundaries(art, configs)
    layers = art["layers"]

    # conv1 (fixed-point-rounded weights) in f32, pool, quantize to codes.
    x = _maxpool2(_conv1(layers[0], images))
    qx = QTensor.quantize_u8(x, folded["step1"], axis=-1)

    for entry, cfg, (div, bias, step_out) in zip(layers[1:-1], configs,
                                                  folded["layers"]):
        spec: ConvSpec = entry["spec"]
        # Mul_prev is the input codes' step; popcount's is folded into div
        mul = None if cfg.accum == "popcount" else qx.scale
        args = (entry["w_packed"], mul, div, bias)
        if spec.ksize == 3 and spec.pool:
            out = conv_ops.w1a8_conv3x3_pool(qx.data, *args, cin=spec.cin,
                                             config=cfg)
        elif spec.ksize == 3:
            out = conv_ops.w1a8_conv3x3(qx.data, *args, cin=spec.cin,
                                        config=cfg)
        else:
            b, h, w, _ = qx.data.shape
            out = mm_ops.w1a8_matmul(qx.data.reshape(b * h * w, spec.cin),
                                     *args, k=spec.cin, config=cfg)
            out = out.reshape(b, h, w, spec.cout)
        qx = QTensor.from_codes(out, step_out, axis=-1)

    # conv11 detection head (1×1, fixed-point weights) on dequantized codes.
    return _conv11(layers[-1], qx.dequantize())
