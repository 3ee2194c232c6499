"""Public wrappers for the W1A8 3×3 conv kernels.

`w1a8_conv3x3` — conv + fused Mul_prev/Div/bias/round/clip epilogue.
`w1a8_conv3x3_pool` — the same conv with the 2×2 MaxPool, either fused into
the kernel (``config.fused=True``, `fused_pool.w1a8_conv3x3_pool2`) or as
the conv kernel followed by a 2×2 max. The two routes agree bit for bit.

``config.accum`` picks the contraction: ``"dot"`` (bf16(a·Mul_prev)
against ±1, f32 sum) or ``"popcount"`` (exact int32 sum over the codes'
bit-planes). A popcount call first folds a per-channel Mul_prev into the
codes (`core.quant.fold_codes_to_uniform_step`) and the uniform step m̄
into Div; with ``mul_prev=None`` the caller has done so already (the
detector's forward, whose producers quantize onto one grid).

A CUDA tensor launches the kernel in ``csrc/`` (or raises); a CPU tensor
runs the plain version in ``ref.py``; a fake or meta tensor gives the
result's shape alone (`_build.shape_only`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.packing import pack_signs, packed_dim
from repro_torch.kernels import _build
from repro_torch.kernels.config import KernelConfig
from repro_torch.kernels.w1a8_conv import ref as _ref
from repro_torch.kernels.w1a8_conv.geometry import conv_launch
from repro_torch.kernels.w1a8_conv.fused_pool import w1a8_conv3x3_pool2
from repro_torch.kernels.w1a8_conv.ref import conv_mul9  # noqa: F401
from repro_torch.kernels.w1a8_matmul.ops import fold_operands

KERNEL = _build.Kernel(
    "w1a8_conv3x3.cu", "w1a8_conv3x3",
    [_build.P] * 6 + [_build.I] * 6 + [_build.F] + [_build.I] * 9
    + [_build.P])
POPCOUNT_KERNEL = _build.Kernel(
    "w1a8_conv3x3_popcount.cu", "w1a8_conv3x3_popcount",
    [_build.P] * 5 + [_build.I] * 6 + [_build.F] + [_build.I] * 9
    + [_build.P])


def conv_pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) float → (ceil(9·Cin/32), Cout) int32 sign words."""
    k9 = w.shape[0] * w.shape[1] * w.shape[2]
    return pack_signs(w.reshape(k9, w.shape[3]), axis=0)


def _config(config: Optional[KernelConfig], op: str) -> KernelConfig:
    cfg = config if config is not None else KernelConfig(op=op)
    if cfg.op != op:
        raise ValueError(f"config.op={cfg.op!r} does not match {op!r}")
    return cfg


def cuda_operands(a_u8, w_packed, mul_prev, div_post, bias, cin: int):
    """Checks and lays out a conv kernel's operands on a_u8's device;
    ``mul_prev`` may be None (popcount), and stays so."""
    dev = a_u8.device
    if a_u8.dtype != torch.uint8 or a_u8.ndim != 4 or a_u8.shape[3] != cin:
        raise ValueError(f"a_u8 must be uint8 (B, H, W, {cin}), got "
                         f"{a_u8.dtype} {tuple(a_u8.shape)}")
    if w_packed.dtype != torch.int32 or w_packed.shape[0] != packed_dim(9 * cin):
        raise ValueError(f"w_packed must be int32 ({packed_dim(9 * cin)}, "
                         f"Cout), got {w_packed.dtype} {tuple(w_packed.shape)}")
    cout = w_packed.shape[1]

    def vec(x):
        return x.to(dev, torch.float32).reshape(-1).contiguous()
    mul = None if mul_prev is None else vec(mul_prev)
    div, bs = vec(div_post), vec(bias)
    if (mul is not None and mul.numel() != cin) or div.numel() != cout \
            or bs.numel() != cout:
        raise ValueError("mul_prev must be (Cin,), div_post and bias (Cout,)")
    return a_u8.contiguous(), w_packed.to(dev).contiguous(), mul, div, bs


def w1a8_conv3x3(a_u8: torch.Tensor, w_packed: torch.Tensor,
                 mul_prev: Optional[torch.Tensor], div_post: torch.Tensor,
                 bias: torch.Tensor, *, cin: int,
                 config: Optional[KernelConfig] = None) -> torch.Tensor:
    """Streaming 3×3 SAME conv on uint8 codes.

    a_u8 (B,H,W,Cin); w_packed (ceil(9Cin/32),Cout) int32; mul_prev (Cin,)
    (None: popcount on folded operands); div_post/bias (Cout,). Returns
    (B,H,W,Cout) f32, or uint8 codes when ``config.out_step`` is set.
    """
    cfg = _config(config, "conv3x3")
    popcount = cfg.accum == "popcount"
    if popcount:
        a_u8, div_post = fold_operands(a_u8, mul_prev, div_post)
        mul_prev = None
    elif mul_prev is None:
        raise ValueError("accum='dot' needs mul_prev")
    b, h, wd = a_u8.shape[:3]
    with _build.work(
            "w1a8_conv3x3_popcount" if popcount else "w1a8_conv3x3",
            2 * b * h * wd * 9 * cin * w_packed.shape[1],
            "int8" if popcount else "bf16",
            _build.nbytes(a_u8, w_packed, mul_prev, div_post, bias)) as out:
        if _build.shape_only(a_u8):
            cuda_operands(a_u8, w_packed, mul_prev, div_post, bias, cin)
            y = _conv_out(a_u8, w_packed, cfg)
        elif a_u8.is_cuda:
            y = _launch(a_u8, w_packed, mul_prev, div_post, bias, cin, cfg)
        elif popcount:
            y = _ref.w1a8_conv3x3_popcount_ref(a_u8, w_packed, cin, div_post,
                                               bias, cfg.out_step)
        else:
            y = _ref.w1a8_conv3x3_ref(a_u8, w_packed, cin, mul_prev,
                                      div_post, bias, cfg.out_step)
        out.append(y)
    return y


def _launch(a_u8, w_packed, mul_prev, div_post, bias, cin: int,
            cfg: KernelConfig) -> torch.Tensor:
    """Launches the popcount kernel where ``mul_prev`` is None, else the
    dot kernel."""
    a, w, mul, div, bs = cuda_operands(a_u8, w_packed, mul_prev, div_post,
                                       bias, cin)
    out = _conv_out(a, w, cfg)
    g = conv_launch(*a.shape[:3], cin, w.shape[1], cfg.rows, pool=False,
                    accum=cfg.accum)
    geometry = (*a.shape[:3], cin, w.shape[1], g.rows, _step(cfg),
                int(out.dtype == torch.uint8), *g.grid[:2], g.bn, g.wm, g.wn,
                g.row_px, g.threads, g.smem,
                torch.cuda.current_stream(a.device).cuda_stream)
    if mul is None:
        POPCOUNT_KERNEL(a.data_ptr(), w.data_ptr(), div.data_ptr(),
                        bs.data_ptr(), out.data_ptr(), *geometry)
    else:
        KERNEL(a.data_ptr(), w.data_ptr(), mul.data_ptr(), div.data_ptr(),
               bs.data_ptr(), out.data_ptr(), *geometry)
    return out


def _conv_out(a: torch.Tensor, w: torch.Tensor,
              cfg: KernelConfig) -> torch.Tensor:
    b, h, wd, _ = a.shape
    dtype = torch.float32 if cfg.out_step is None else torch.uint8
    return torch.empty((b, h, wd, w.shape[1]), dtype=dtype, device=a.device)


def _step(cfg: KernelConfig) -> float:
    return float(cfg.out_step if cfg.out_step is not None else 1.0)


def w1a8_conv3x3_pool(a_u8: torch.Tensor, w_packed: torch.Tensor,
                      mul_prev: Optional[torch.Tensor],
                      div_post: torch.Tensor, bias: torch.Tensor, *,
                      cin: int, config: Optional[KernelConfig] = None
                      ) -> torch.Tensor:
    """Streaming 3×3 SAME conv + requant + 2×2 MaxPool → (B,H/2,W/2,Cout)
    uint8 codes; H and W even. ``config.out_step`` defaults to 1.0."""
    cfg = _config(config, "conv3x3_pool")
    if cfg.out_step is None:
        cfg = cfg.replace(out_step=1.0)
    if not cfg.fused:
        out = w1a8_conv3x3(a_u8, w_packed, mul_prev, div_post, bias, cin=cin,
                           config=cfg.replace(op="conv3x3"))
        return _ref.maxpool2_codes(out)
    if cfg.accum == "popcount":
        a_u8, div_post = fold_operands(a_u8, mul_prev, div_post)
        mul_prev = None
    return w1a8_conv3x3_pool2(a_u8, w_packed, mul_prev, div_post, bias,
                              cin=cin, out_step=cfg.out_step,
                              accum=cfg.accum, rows=cfg.rows)
