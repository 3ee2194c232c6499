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

LSQ's backward passes the gradient only where 0 ≤ x / step ≤ 255, so an
input that sits within an ulp of a rail (x near 0, say the product of a
gated MLP) can take the gradient in one run and not in the other with
the same code: the forward agrees bit for bit and a gradient leaf does
not. For ``lsq_fake_quant``, `forced` replaces such inputs too, checked
to sit within ``tol`` of the rail in both runs.

The quantizer is ``models.yolo``'s ``lsq_fake_quant`` (the QAT forward,
``train=True``) or ``quantize_act`` (the eval forward), or the same name in
another ``module``: ``models.layers`` for the LM projections (the
``w1a8_eval`` and packed paths call its ``quantize_act``). Both functions
patch it for the length of a ``with`` block: not for concurrent use.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.quant import ACT_QMAX, quantize_act
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


def _force(x, ref, s, rails: bool, tol: float, counts: list,
           quantizer: str):
    """``x`` with each code that differs from ``ref``'s (and, with
    ``rails``, each input on the other side of a rail) replaced by
    ``ref``'s value, after checking it sits within ``tol`` of the tie
    (rail) in both; appends the number forced to ``counts``."""
    def in_range(v: torch.Tensor) -> torch.Tensor:
        return (v >= 0) & (v <= ACT_QMAX)

    def check(flip, offs, what: str) -> None:
        for off in offs:
            if bool(flip.any()) and float(off[flip].max()) > tol:
                raise AssertionError(
                    f"{quantizer} call {len(counts) - 1}: an input differs "
                    f"{float(off[flip].max()):.6g} away from a {what}")

    xs, rs = x.detach() / s, ref / s
    code = quantize_act(x.detach(), s) != quantize_act(ref, s)
    rail = (in_range(xs) != in_range(rs)) & ~code if rails \
        else torch.zeros_like(code)
    counts.append(int(code.sum()) + int(rail.sum()))
    if counts[-1]:
        check(code, [torch.abs(torch.remainder(v, 1.0) - 0.5)
                     for v in (xs, rs)], "rounding tie")
        check(rail, [torch.minimum(torch.abs(v), torch.abs(v - ACT_QMAX))
                     for v in (xs, rs)], "rail")
        x = x + torch.where(code | rail, ref - x.detach(), 0.0)
    return x


@contextlib.contextmanager
def forced(recorded: list, quantizer: str = "lsq_fake_quant",
           tol: float = 1e-3, module=None):
    """Yields a list that gets the number of inputs forced at each call of
    ``quantizer`` in the forward inside the block, which must make as many
    calls, in the same order, as the recorded run. Raises if a differing
    code is not within ``tol`` of a rounding tie in both runs, or (for
    ``lsq_fake_quant``) an input on the other side of a rail not within
    ``tol`` of it in both."""
    counts, pending = [], iter(recorded)
    rails = quantizer == "lsq_fake_quant"

    def wrap(real):
        def forcing(x, step, *rest):
            ref = torch.as_tensor(next(pending)).to(x.device)
            x = _force(x, ref, step.detach(), rails, tol, counts, quantizer)
            return real(x, step, *rest)
        return forcing

    with _patched(quantizer, wrap, module):
        yield counts


@contextlib.contextmanager
def forced_by_rows(recorded: list, quantizer: str = "lsq_fake_quant",
                   tol: float = 1e-3, module=None, splits: tuple = (1,)):
    """`forced`, with each input row's reference the nearest row of the
    same width among ``recorded`` (matched by content, not by call): for
    a run that calls the quantizer on other shapes than the recorded one,
    such as one rank of a sharded step (its rows of the batch; an MoE
    buffer laid out by expert shard). ``splits``: the recorded rows are
    also offered cut into n column blocks for each n (a rank's slice of a
    tensor-parallel hidden dim). A row matched to another token or layer
    fails the tie check. Yields the inputs forced at each call."""
    rows_of: dict = {}
    for r in recorded:
        r = torch.as_tensor(r)
        w = r.shape[-1]
        for n in splits:
            if w % n == 0:
                blocks = r.reshape(-1, n, w // n).transpose(0, 1)
                rows_of.setdefault(w // n, []).append(
                    blocks.reshape(-1, w // n))
    rows_of = {k: torch.cat(v) for k, v in rows_of.items()}
    counts: list = []
    rails = quantizer == "lsq_fake_quant"

    def wrap(real):
        def forcing(x, step, *rest):
            k = x.shape[-1]
            cand = rows_of[k].to(x.device)
            rows = x.detach().reshape(-1, k)
            ref = cand[torch.cdist(rows, cand).argmin(1)].reshape(x.shape)
            x = _force(x, ref, step.detach(), rails, tol, counts, quantizer)
            return real(x, step, *rest)
        return forcing

    with _patched(quantizer, wrap, module):
        yield counts
