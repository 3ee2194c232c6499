"""W1A8 linear layers — the paper's technique as a composable module.

Counterpart of ``repro/core/w1a8.py``. Generalizes the paper's scheme from
CNN channels to arbitrary feature axes:
  * body matmuls use 1-bit weights (sign + STE) and uint8 LSQ activations,
  * per-*input*-channel scale (``Mul_prev`` = the input quantizer's step,
    optionally channel-wise) is fused into the accumulation (Eq. 3-4),
  * per-*output*-channel scale (``Div_current`` = XNOR-style α = mean|w| per
    output channel) + bias run in the epilogue.

Three paths share one algebra:
  train   — fake-quant QAT (differentiable, STE + LSQ),
  infer   — packed 1-bit weights unpacked in torch, bf16 operands with an
            f32 sum (the reference's ``dot_general``),
  int     — the exact int32 Σ code·sign from ``csrc/w1a8_matmul_int.cu``
            on the card (`kernels.w1a8_matmul.ops.w1a8_matmul_int`), its
            plain version on the CPU, then the f32 epilogue.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import packing
from repro_torch.core.quant import (binarize_ste, binarize_weight,
                                    lsq_fake_quant, lsq_grad_scale,
                                    quantize_act)
from repro_torch.device import full_f32, resolve_device
from repro_torch.kernels.w1a8_matmul.ops import w1a8_matmul_int


def init_w1a8_linear(gen: torch.Generator, k: int, n: int, *,
                     per_channel_step: bool = True, dtype=torch.float32,
                     device=None) -> dict:
    """Latent params for one W1A8 linear layer (training representation),
    drawn from ``gen`` on ``device`` (default: the card)."""
    dev = resolve_device(device)
    w = torch.randn((k, n), generator=gen, dtype=dtype,
                    device=dev).mul_(1.0 / math.sqrt(k))
    step = torch.full((k,) if per_channel_step else (), 0.05, dtype=dtype,
                      device=dev)
    return {"w": w, "act_step": step,
            "bias": torch.zeros((n,), dtype=dtype, device=dev)}


def _alpha(w: torch.Tensor) -> torch.Tensor:
    """XNOR-Net per-output-channel scale α_o = mean_i |w_io| (detached)."""
    return torch.mean(torch.abs(w), dim=0).detach()


def w1a8_linear_train(params: dict, x: torch.Tensor) -> torch.Tensor:
    """QAT forward: LSQ fake-quant input → ±1 (STE) matmul → α, bias."""
    gs = lsq_grad_scale(x.numel() // max(x.shape[-1], 1))
    xq = lsq_fake_quant(x, params["act_step"], gs)
    wb = binarize_ste(params["w"])
    with full_f32():
        y = xq @ wb
    return y * _alpha(params["w"]) + params["bias"]


def w1a8_linear_float_ref(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode float reference (no STE machinery)."""
    xq = quantize_act(x, params["act_step"]) * params["act_step"]
    with full_f32():
        y = xq @ binarize_weight(params["w"])
    return y * _alpha(params["w"]) + params["bias"]


# ---------------------------------------------------------------------------
# Deployment: pack to 1-bit + scale split (the parameter-extraction step, §4)
# ---------------------------------------------------------------------------

def deploy_w1a8_linear(params: dict) -> dict:
    """Training params → deployed artifact.

    mul_prev    (K,) f32 — input quant steps (channel-wise Mul_prev)
    w_packed    (K/32, N) int32 — sign bits, reduction-major (the
                reference's uint32 words, same bits)
    div_post    (N,) f32 — α_o
    bias        (N,) f32
    """
    w = params["w"].detach()
    k = w.shape[0]
    step = torch.broadcast_to(params["act_step"].detach(), (k,)) \
        .to(torch.float32).contiguous()
    return {
        "w_packed": packing.pack_signs(w, axis=0),
        "mul_prev": step,
        "div_post": _alpha(w).to(torch.float32),
        "bias": params["bias"].detach().to(torch.float32),
        "k": k,
    }


def w1a8_linear_infer(deployed: dict, a_u8: torch.Tensor, *,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Deployed inference on quantized activations, plain torch:
    y = ((a ⊙ mul_prev) @ sign) * div_post + bias (Eqs. 3-2/3-4), with
    a ⊙ mul_prev rounded to ``compute_dtype`` and an f32 sum, as the
    reference's ``dot_general`` does."""
    k = deployed["k"]
    signs = packing.unpack_signs(deployed["w_packed"], k, axis=0,
                                 dtype=torch.float32)
    am = a_u8.to(compute_dtype) * deployed["mul_prev"].to(compute_dtype)
    with full_f32():
        y = am.to(torch.float32) @ signs
    return y * deployed["div_post"] + deployed["bias"]


def int_sums(deployed: dict, a_u8: torch.Tensor) -> torch.Tensor:
    """Exact Σ_k a·sign in int32, (..., N): the int matmul kernel on the
    card, its plain version on the CPU."""
    k = deployed["k"]
    w = deployed["w_packed"]
    colsum = packing.unpack_signs(w, k, axis=0, dtype=torch.int32).sum(
        dim=0, dtype=torch.int32)
    a2 = a_u8.reshape(-1, a_u8.shape[-1])
    acc = w1a8_matmul_int(a2, w, colsum)
    return acc.reshape(a_u8.shape[:-1] + (w.shape[1],))


def w1a8_linear_infer_int(deployed: dict, a_u8: torch.Tensor
                          ) -> torch.Tensor:
    """Uniform-scale exact-integer path: Σ a·sign in int32 (`int_sums`),
    then acc · m · div_post + bias in f32, in the reference's order."""
    acc = int_sums(deployed, a_u8)
    m = deployed["mul_prev"][0]
    return acc.to(torch.float32) * m * deployed["div_post"] \
        + deployed["bias"]


def requantize(y: torch.Tensor, next_step: torch.Tensor) -> torch.Tensor:
    """Post-processing to the next layer's uint8 codes (Div_current
    role)."""
    return quantize_act(y, next_step).to(torch.uint8)
