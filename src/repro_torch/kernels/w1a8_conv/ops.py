"""Public wrappers for the W1A8 3×3 conv kernels.

`w1a8_conv3x3` — conv + fused Mul_prev/Div/bias/round/clip epilogue.
`w1a8_conv3x3_pool` — the same conv with the 2×2 MaxPool, either fused into
the kernel (``config.fused=True``, `fused_pool.w1a8_conv3x3_pool2`) or as
the conv kernel followed by a 2×2 max. The two routes agree bit for bit.

A CUDA tensor launches the kernel in ``csrc/`` (or raises); a CPU tensor
runs the plain version in ``ref.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.packing import pack_signs, packed_dim
from repro_torch.kernels import _build
from repro_torch.kernels.config import KernelConfig
from repro_torch.kernels.w1a8_conv import ref as _ref
from repro_torch.kernels.w1a8_conv.fused_pool import w1a8_conv3x3_pool2
from repro_torch.kernels.w1a8_conv.ref import conv_mul9  # noqa: F401

KERNEL = _build.Kernel(
    "w1a8_conv3x3.cu", "w1a8_conv3x3",
    [_build.P] * 6 + [_build.I] * 6 + [_build.F, _build.I, _build.P])


def conv_pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) float → (ceil(9·Cin/32), Cout) int32 sign words."""
    k9 = w.shape[0] * w.shape[1] * w.shape[2]
    return pack_signs(w.reshape(k9, w.shape[3]), axis=0)


def _check_config(cfg: KernelConfig, op: str) -> None:
    if cfg.op != op:
        raise ValueError(f"config.op={cfg.op!r} does not match {op!r}")
    if cfg.accum != "dot":
        raise NotImplementedError(
            f"accum={cfg.accum!r} is not ported yet (ROADMAP.md, Queue 2)")


def cuda_operands(a_u8, w_packed, mul_prev, div_post, bias, cin: int):
    """Checks and lays out a conv kernel's operands on a_u8's device."""
    dev = a_u8.device
    if a_u8.dtype != torch.uint8 or a_u8.ndim != 4 or a_u8.shape[3] != cin:
        raise ValueError(f"a_u8 must be uint8 (B, H, W, {cin}), got "
                         f"{a_u8.dtype} {tuple(a_u8.shape)}")
    if w_packed.dtype != torch.int32 or w_packed.shape[0] != packed_dim(9 * cin):
        raise ValueError(f"w_packed must be int32 ({packed_dim(9 * cin)}, "
                         f"Cout), got {w_packed.dtype} {tuple(w_packed.shape)}")
    cout = w_packed.shape[1]
    ops = (a_u8.contiguous(), w_packed.to(dev).contiguous(),
           mul_prev.to(dev, torch.float32).reshape(-1).contiguous(),
           div_post.to(dev, torch.float32).reshape(-1).contiguous(),
           bias.to(dev, torch.float32).reshape(-1).contiguous())
    if ops[2].numel() != cin or ops[3].numel() != cout \
            or ops[4].numel() != cout:
        raise ValueError("mul_prev must be (Cin,), div_post and bias (Cout,)")
    return ops


def w1a8_conv3x3(a_u8: torch.Tensor, w_packed: torch.Tensor,
                 mul_prev: torch.Tensor, div_post: torch.Tensor,
                 bias: torch.Tensor, *, cin: int,
                 config: Optional[KernelConfig] = None) -> torch.Tensor:
    """Streaming 3×3 SAME conv on uint8 codes.

    a_u8 (B,H,W,Cin); w_packed (ceil(9Cin/32),Cout) int32; mul_prev (Cin,);
    div_post/bias (Cout,). Returns (B,H,W,Cout) f32, or uint8 codes when
    ``config.out_step`` is set.
    """
    cfg = config if config is not None else KernelConfig(op="conv3x3")
    _check_config(cfg, "conv3x3")
    if not a_u8.is_cuda:
        return _ref.w1a8_conv3x3_ref(a_u8, w_packed, cin, mul_prev, div_post,
                                     bias, cfg.out_step)
    a, w, mul, div, bs = cuda_operands(a_u8, w_packed, mul_prev, div_post,
                                       bias, cin)
    b, h, wd, _ = a.shape
    cout = w.shape[1]
    quant = cfg.out_step is not None
    out = torch.empty((b, h, wd, cout),
                      dtype=torch.uint8 if quant else torch.float32,
                      device=a.device)
    KERNEL(a.data_ptr(), w.data_ptr(), mul.data_ptr(), div.data_ptr(),
           bs.data_ptr(), out.data_ptr(), b, h, wd, cin, cout,
           cfg.conv_rows(h), float(cfg.out_step if quant else 1.0),
           int(quant), torch.cuda.current_stream(a.device).cuda_stream)
    return out


def w1a8_conv3x3_pool(a_u8: torch.Tensor, w_packed: torch.Tensor,
                      mul_prev: torch.Tensor, div_post: torch.Tensor,
                      bias: torch.Tensor, *, cin: int,
                      config: Optional[KernelConfig] = None) -> torch.Tensor:
    """Streaming 3×3 SAME conv + requant + 2×2 MaxPool → (B,H/2,W/2,Cout)
    uint8 codes; H and W even. ``config.out_step`` defaults to 1.0."""
    cfg = config if config is not None else KernelConfig(op="conv3x3_pool")
    _check_config(cfg, "conv3x3_pool")
    if cfg.out_step is None:
        cfg = cfg.replace(out_step=1.0)
    if not cfg.fused:
        out = w1a8_conv3x3(a_u8, w_packed, mul_prev, div_post, bias, cin=cin,
                           config=cfg.replace(op="conv3x3"))
        return _ref.maxpool2_codes(out)
    return w1a8_conv3x3_pool2(a_u8, w_packed, mul_prev, div_post, bias,
                              cin=cin, out_step=cfg.out_step,
                              rows=cfg.conv_rows(a_u8.shape[1] // 2))
