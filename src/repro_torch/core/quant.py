"""W1A8 quantization primitives (paper §3.2, Eqs. 3-1, 3-3).

Weights:      w_b = sign(w) ∈ {-1,+1}, straight-through estimator in training.
Activations:  q_a = clip(round(x / s_a), 0, 255)  (LSQ: learned step size).

Counterpart of ``repro/core/quant.py``. The rounding is half away from zero
(the paper's RTL rounder); ``torch.round`` rounds half to even and must not
stand in for it.
"""
from __future__ import annotations

import torch

from repro_torch.device import full_f32

ACT_QMAX = 255  # uint8 activations, ReLU-style non-negative range [0, 255]


def binarize_weight(w: torch.Tensor) -> torch.Tensor:
    """sign(w) ∈ {-1,+1} (0 maps to +1, matching the RTL sign-bit convention)."""
    return torch.where(w >= 0, 1.0, -1.0).to(w.dtype)


class _BinarizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        ctx.save_for_backward(w)
        return binarize_weight(w)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return g * (torch.abs(w) <= 1.0).to(g.dtype)


def binarize_ste(w: torch.Tensor) -> torch.Tensor:
    """sign(w) forward; backward dL/dw = dL/dw_b · 1[|w| <= 1], the
    boundary included (the BNN/XNOR-Net STE with saturation clipping)."""
    return _BinarizeSTE.apply(w)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """trunc(x + (x >= 0 ? 0.5 : -0.5)), with the add rounded in x's dtype."""
    return torch.trunc(x + torch.where(x >= 0, 0.5, -0.5).to(x.dtype))


def quantize_act(x: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """q = clip(round(x / s), 0, 255), as a float tensor of x's dtype."""
    return torch.clamp(round_half_away(x / step), 0, ACT_QMAX)


def dequantize_act(q: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    return q * step


def _reduce_to_shape(g: torch.Tensor, shape) -> torch.Tensor:
    """Sum ``g`` down to the broadcast shape ``shape``: the leading axes and
    the axes where ``shape`` has 1 (a (C,) step against (B, H, W, C) sums
    over (0, 1, 2))."""
    shape = tuple(shape)
    if tuple(g.shape) == shape:
        return g
    ndiff = g.dim() - len(shape)
    axes = tuple(range(ndiff)) + tuple(
        i + ndiff for i, s in enumerate(shape)
        if s == 1 and g.shape[i + ndiff] != 1)
    return torch.sum(g, dim=axes).reshape(shape)


class _LSQFakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, step, grad_scale):
        ctx.save_for_backward(x, step)
        ctx.grad_scale = grad_scale
        return dequantize_act(quantize_act(x, step), step)

    @staticmethod
    def backward(ctx, g):
        x, step = ctx.saved_tensors
        xs = x / step                      # a divide, as the forward does
        q = torch.clamp(round_half_away(xs), 0, ACT_QMAX)
        in_range = (xs >= 0) & (xs <= ACT_QMAX)
        dx = g * in_range.to(g.dtype)
        # in range d(q̂)/ds = q - x/s; at the rails q̂ = rail·s, so q
        dstep_elem = torch.where(in_range, q - xs, q)
        dstep = _reduce_to_shape(g * dstep_elem, step.shape) * ctx.grad_scale
        return dx, dstep.to(step.dtype), None


def lsq_fake_quant(x: torch.Tensor, step: torch.Tensor,
                   grad_scale) -> torch.Tensor:
    """LSQ fake quantization (Esser et al., ICLR 2020): forward
    quantize-dequantize; backward dx = g inside [0, 255]·s and 0 outside,
    dstep = Σ g·(q − x/s) inside and g·q at the rails, times
    ``grad_scale`` (a float or a tensor; it gets no gradient)."""
    return _LSQFakeQuant.apply(x, step, grad_scale)


def lsq_grad_scale(numel: int) -> float:
    """LSQ gradient scale 1/sqrt(numel · QMAX), a Python float."""
    return float(numel * ACT_QMAX) ** -0.5


def init_step_from_batch(x: torch.Tensor) -> torch.Tensor:
    """LSQ init: s0 = 2·mean(|x|)/sqrt(QMAX)."""
    qmax = torch.tensor(float(ACT_QMAX), dtype=x.dtype, device=x.device)
    return 2.0 * torch.mean(torch.abs(x)) / torch.sqrt(qmax)


def requant_epilogue(y: torch.Tensor, out_step: float,
                     out_dtype=torch.uint8) -> torch.Tensor:
    """f32 post-scale accumulator → next-layer uint8 codes.

    Divides by the step (never multiplies by its reciprocal): the reference
    does, and the two differ in the last bit. On CUDA, PyTorch multiplies
    by the reciprocal when the divisor is a Python number, so the step goes
    in as a tensor on y's device.
    """
    step = torch.as_tensor(out_step, dtype=y.dtype, device=y.device)
    q = round_half_away(y / step)
    return torch.clamp(q, 0, ACT_QMAX).to(out_dtype)


def fold_codes_to_uniform_step(a_u8: torch.Tensor,
                               mul_prev: torch.Tensor) -> tuple:
    """(codes, per-input-channel steps) → (codes', uniform scalar step m̄).

    The popcount contraction cannot carry a per-input-channel Mul_prev, so
    the codes are requantized onto the coarsest channel's grid,
    m̄ = max(max_k m_k, 1e-20):

        a'_k = clip(round_half_away(a_k · (m_k / m̄)), 0, 255)

    in f32, ratio first, as the reference does; m̄ then folds into
    Div_current. Under uniform steps the ratio is exactly 1.0 and the fold
    is the identity. ``mul_prev`` broadcasts against the trailing axis.
    """
    m = mul_prev.to(torch.float32)
    mbar = torch.clamp(torch.max(m), min=1e-20)
    codes = torch.clamp(round_half_away(a_u8.to(torch.float32) * (m / mbar)),
                        0, ACT_QMAX).to(torch.uint8)
    return codes, mbar


# ---------------------------------------------------------------------------
# Eq. 3-2 / 3-4: sign-controlled accumulation (reference semantics)
# ---------------------------------------------------------------------------

def _exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two. Floats run in full f32 (no
    TF32 on the card). Integers are summed exactly: in int64 on the CPU,
    in float64 on the card (which has no integer matmul; exact while
    |sum| < 2^53), then cast to the promoted dtype."""
    out = torch.promote_types(a.dtype, b.dtype)
    if out.is_floating_point:
        with full_f32():
            return a.to(out) @ b.to(out)
    wide = torch.int64 if a.device.type == "cpu" else torch.float64
    return (a.to(wide) @ b.to(wide)).to(out)


def sign_accumulate(acts: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """y_o = Σ_i s_{o,i} a_i, the binary PE's reference (Eq. 3-2).

    acts: (..., K) uint8-valued; signs: (K, N) ∈ {-1, +1}. Integer-exact
    where both are integers."""
    return _exact_matmul(acts, signs)


def sign_accumulate_fused(acts: torch.Tensor, mul_prev: torch.Tensor,
                          signs: torch.Tensor) -> torch.Tensor:
    """Eq. 3-4: y_o = Σ_i s_{o,i} (m_i a_i), Mul_prev fused into the PE."""
    return _exact_matmul(acts * mul_prev, signs)
