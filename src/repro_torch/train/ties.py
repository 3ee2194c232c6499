"""Rounding ties held fixed, to compare two runs of the float forward.

A float32 conv summed in another order (another framework, the CPU
against the card) moves some activation across a rounding tie, x / step =
n + 1/2 within an ulp: its code differs by one, and the difference spreads
through every later layer. So two correct runs of one forward or one train
step differ far beyond float32 rounding downstream of the flip. To compare
them, `record` keeps the quantizer inputs of one run, and `forced` runs
the next forward with each input whose code differs from the recorded
run's replaced by the recorded value, after checking that it sits within
``tol`` of a tie in both runs. The replacement is a constant added to the
input, so a gradient still flows through the forward's own input.

The quantizer is ``models.yolo``'s ``lsq_fake_quant`` (the QAT forward,
``train=True``) or ``quantize_act`` (the eval forward), or the same name in
another ``module``: ``models.layers`` for the LM projections (the
``w1a8_eval`` and packed paths call its ``quantize_act``). Both functions
patch it for the length of a ``with`` block: not for concurrent use.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.quant import quantize_act
from repro_torch.models import yolo

QUANTIZERS = ("lsq_fake_quant", "quantize_act")


@contextlib.contextmanager
def _patched(name: str, wrap, module=None):
    if name not in QUANTIZERS:
        raise ValueError(f"quantizer must be one of {QUANTIZERS}, got "
                         f"{name!r}")
    module = yolo if module is None else module
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def record(quantizer: str = "lsq_fake_quant", module=None):
    """Yields a list that gets every input of ``quantizer`` in the forwards
    inside the block (detached copies, in call order)."""
    inputs = []

    def wrap(real):
        def recording(x, step, *rest):
            inputs.append(x.detach().clone())
            return real(x, step, *rest)
        return recording

    with _patched(quantizer, wrap, module):
        yield inputs


@contextlib.contextmanager
def forced(recorded: list, quantizer: str = "lsq_fake_quant",
           tol: float = 1e-3, module=None):
    """Yields a list that gets the number of codes forced at each call of
    ``quantizer`` in the forward inside the block, which must make as many
    calls, in the same order, as the recorded run. Raises if a differing
    code is not within ``tol`` of a rounding tie in both runs."""
    counts, pending = [], iter(recorded)

    def wrap(real):
        def forcing(x, step, *rest):
            ref = torch.as_tensor(next(pending)).to(x.device)
            s = step.detach()
            flip = quantize_act(x.detach(), s) != quantize_act(ref, s)
            counts.append(int(flip.sum()))
            if counts[-1]:
                for v in (x.detach(), ref):
                    off = torch.abs(torch.remainder(v / s, 1.0) - 0.5)[flip]
                    if float(off.max()) > tol:
                        raise AssertionError(
                            f"{quantizer} call {len(counts) - 1}: a code "
                            f"differs {float(off.max()):.6g} away from a "
                            f"rounding tie")
                x = x + torch.where(flip, ref - x.detach(), 0.0)
            return real(x, step, *rest)
        return forcing

    with _patched(quantizer, wrap, module):
        yield counts
