"""Public wrapper for the W1A8 packed matmul.

A CUDA tensor launches the kernel in ``csrc/w1a8_matmul.cu`` (or raises);
a CPU tensor runs the plain version in ``ref.py``. Leading dims of ``a_u8``
fold into M. The kernel masks the ragged M and N edges itself, so nothing
is padded.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.packing import pack_signs, packed_dim
from repro_torch.kernels import _build
from repro_torch.kernels.config import KernelConfig
from repro_torch.kernels.w1a8_matmul import ref as _ref

KERNEL = _build.Kernel(
    "w1a8_matmul.cu", "w1a8_matmul",
    [_build.P] * 6 + [_build.I] * 4 + [_build.F, _build.I, _build.P])


def w1a8_matmul(a_u8: torch.Tensor, w_packed: torch.Tensor,
                mul_prev: torch.Tensor, div_post: torch.Tensor,
                bias: torch.Tensor, *, k: int,
                config: Optional[KernelConfig] = None) -> torch.Tensor:
    """y = ((a ⊙ mul_prev) @ unpack(w_packed)) ⊙ div_post + bias [+ requant].

    a_u8: (..., ≥k) uint8 codes; w_packed: (ceil(k/32), N) int32 words;
    mul_prev: (k,) f32; div_post, bias: (N,) f32. Returns (..., N) f32, or
    uint8 codes when ``config.out_step`` is set.
    """
    cfg = config if config is not None else KernelConfig(op="matmul")
    if cfg.op != "matmul":
        raise ValueError(f"config.op={cfg.op!r} does not match 'matmul'")
    if cfg.accum != "dot":
        raise NotImplementedError(
            f"accum={cfg.accum!r} is not ported yet (ROADMAP.md, Queue 2)")
    lead = a_u8.shape[:-1]
    n = w_packed.shape[1]
    a2 = a_u8.reshape(-1, a_u8.shape[-1])[:, :k]
    if not a2.is_cuda:
        y = _ref.w1a8_matmul_ref(a2, w_packed, k, mul_prev, div_post, bias,
                                 cfg.out_step)
    else:
        y = _launch(a2, w_packed, mul_prev, div_post, bias, k, cfg)
    return y.reshape(lead + (n,))


def _launch(a2, w_packed, mul_prev, div_post, bias, k: int,
            cfg: KernelConfig) -> torch.Tensor:
    m = a2.shape[0]
    n = w_packed.shape[1]
    dev = a2.device
    if a2.dtype != torch.uint8:
        raise TypeError(f"a_u8 must be uint8, got {a2.dtype}")
    if w_packed.dtype != torch.int32 or w_packed.shape[0] != packed_dim(k):
        raise ValueError(f"w_packed must be int32 ({packed_dim(k)}, N), got "
                         f"{w_packed.dtype} {tuple(w_packed.shape)}")
    a2 = a2.contiguous()
    w = w_packed.to(dev).contiguous()
    mul = mul_prev.to(dev, torch.float32).reshape(-1).contiguous()
    div = div_post.to(dev, torch.float32).reshape(-1).contiguous()
    bs = bias.to(dev, torch.float32).reshape(-1).contiguous()
    if mul.numel() != k or div.numel() != n or bs.numel() != n:
        raise ValueError("mul_prev must be (k,), div_post and bias (N,)")
    quant = cfg.out_step is not None
    out = torch.empty((m, n), dtype=torch.uint8 if quant else torch.float32,
                      device=dev)
    KERNEL(a2.data_ptr(), w.data_ptr(), mul.data_ptr(), div.data_ptr(),
           bs.data_ptr(), out.data_ptr(), m, k, n, cfg.matmul_bk(k),
           float(cfg.out_step if quant else 1.0), int(quant),
           torch.cuda.current_stream(dev).cuda_stream)
    return out


def w1a8_pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(K, N) float → (ceil(K/32), N) int32 sign words (deploy-time)."""
    return pack_signs(w, axis=0)
