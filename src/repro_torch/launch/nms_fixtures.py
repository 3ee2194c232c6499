"""NMS inputs whose kept sets are known, made with numpy: they hold the
post-processing kernel against its plain version on the card
(``chip_smoke.py``) and the plain version against the reference on the CPU
(the tests).

Untrained heads score every box near σ(0)² ≈ 0.25, so their kept sets are
ties; these fixtures separate the scores or set the ties on purpose.
`HEADS` names the raw heads that each exercise one case of the kernel's
ranked, tiled sweep (`csrc/detect_nms.cu`), with the post-processing
arguments they take.
"""
from __future__ import annotations

import numpy as np

# `tied_boxes` holds one pair of boxes whose IoU is exactly 1/3 in float32:
# at this threshold the pair is kept, since NMS suppresses IoU > thresh.
TIE_IOU = 1 / 3
# the indices `tied_boxes` keeps, in order, at TIE_IOU and the default
# score threshold
TIE_KEPT = (1, 2, 7, 4, 5, 6)


def separated_head() -> tuple:
    """A (1, 10, 10, 75) raw head of confident, class-separated peaks on a
    quiet background (the reference's trained-regime fixture), and its
    peaks (gy, gx, anchor, class)."""
    rng = np.random.default_rng(7)
    r = np.zeros((1, 10, 10, 3, 25), np.float32)
    r[..., 4] = -6.0                                 # background objectness
    peaks = [(1, 2, 0, 3), (4, 7, 1, 11), (8, 3, 2, 0),
             (5, 5, 0, 19), (9, 9, 1, 7), (2, 8, 2, 11)]
    for gy, gx, a, cls in peaks:
        r[0, gy, gx, a, 4] = 5.0                     # confident object
        r[0, gy, gx, a, 5:] = -5.0
        r[0, gy, gx, a, 5 + cls] = 4.0               # separated class
        r[0, gy, gx, a, :4] = rng.standard_normal(4)
    return r.reshape(1, 10, 10, 75), peaks


def tied_boxes() -> tuple:
    """(boxes (1, 12, 4) cxcywh, scores (1, 12, 4)) with equal scores at
    several indices: argmax must take the lowest index, of the boxes and
    of a box's classes.

    Boxes 1, 2, 3 and 7 score 0.75; 1 and 3 overlap (IoU ≈ 0.9, class 2),
    so taking 1 first suppresses 3, and taking 3 first would suppress 1.
    Box 4 scores 0.6 in classes 1 and 3 (class 1 wins). Boxes 5 and 6
    score 0.5 in class 0 and overlap with an IoU of exactly 1/3 (every
    coordinate a power of two). Box 0 is under the score threshold and
    8–11 score 0."""
    boxes = np.array([
        [0.5, 0.5, 0.9, 0.9],
        [0.2, 0.2, 0.2, 0.2], [0.7, 0.2, 0.2, 0.2], [0.21, 0.2, 0.2, 0.2],
        [0.5, 0.8, 0.1, 0.1],
        [0.25, 0.5, 0.25, 0.125], [0.375, 0.5, 0.25, 0.125],
        [0.8, 0.8, 0.1, 0.1],
        [0.1, 0.9, 0.1, 0.1], [0.3, 0.9, 0.1, 0.1], [0.5, 0.9, 0.1, 0.1],
        [0.7, 0.9, 0.1, 0.1]], np.float32)[None]
    scores = np.zeros((1, 12, 4), np.float32)
    scores[0, 0, 0] = 0.1
    scores[0, [1, 2, 3], 2] = 0.75
    scores[0, 7, 1] = 0.75
    scores[0, 4, [1, 3]] = 0.6
    scores[0, [5, 6], 0] = 0.5
    return boxes, scores


# `tile_boundary_head`'s sweep: 40 candidates, ranks 32 and 33 suppressed
# by ranks 31 and 0, kept boxes of the first tile of 32 ranks
TILE_CANDIDATES, TILE_SUPPRESSED = 40, (32, 33)


def _background(grid: int = 10) -> np.ndarray:
    """A (1, grid, grid, 3, 25) raw head that scores no box above 0.25."""
    r = np.zeros((1, grid, grid, 3, 25), np.float32)
    r[..., 4] = -6.0
    r[..., 5:] = -5.0
    return r


def _peak(r, gy, gx, a, cls, obj, box=(0.0, 0.0, 0.0, 0.0)) -> None:
    r[0, gy, gx, a, :4] = box
    r[0, gy, gx, a, 4] = obj
    r[0, gy, gx, a, 5 + cls] = 4.0


def distinct_classes_head() -> tuple:
    """20 large, overlapping boxes of anchor 0, one in each class, at
    strictly falling scores, and max_out = 12: the sweep stops at max_out
    with nothing suppressed, where one class would have kept one box."""
    r = _background()
    for i in range(20):
        _peak(r, 3 + i // 5, 3 + i % 5, 0, i, 6.0 - 0.2 * i,
              (0.0, 0.0, 2.0, 2.0))
    return r.reshape(1, 10, 10, 75), {"max_out": 12}


def empty_head() -> tuple:
    """No score reaches the threshold: every slot is empty and carries box
    0, score 0 and class -1."""
    return _background().reshape(1, 10, 10, 75), {}


def nonfinite_head() -> tuple:
    """NaN and ±inf in the raw head: a box with a NaN centre (its IoUs are
    NaN, so it suppresses nothing and nothing suppresses it) that ties a
    finite box at score 1 (objectness and class logits +inf), a NaN class
    logit that ranks first in the argmax and zeroes the box's score, an
    objectness of -inf, width and height logits of ±inf (clamped to ±8),
    centres at ±inf logits, and two overlapping finite boxes of one class,
    the second suppressed."""
    inf, nan = np.inf, np.nan
    r = _background()
    _peak(r, 1, 1, 0, 3, inf, (0.0, 0.0, 0.0, 0.0))      # score 1, kept
    r[0, 1, 1, 0, 5 + 3] = inf
    _peak(r, 2, 2, 0, 3, inf, (nan, 0.0, 0.0, 0.0))      # score 1, NaN cx
    r[0, 2, 2, 0, 5 + 3] = inf
    _peak(r, 3, 3, 1, 7, 5.0)                            # NaN class logit
    r[0, 3, 3, 1, 5 + 2] = nan
    _peak(r, 4, 4, 2, 9, -inf)                           # objectness -inf
    _peak(r, 5, 5, 1, 11, 4.0, (inf, -inf, inf, -inf))   # clamped w and h
    _peak(r, 7, 7, 0, 5, 3.0, (0.1, -0.2, 0.5, 0.4))     # kept
    _peak(r, 7, 7, 1, 5, 2.5, (0.1, -0.2, -0.5, -0.5))   # suppressed by it
    _peak(r, 8, 2, 2, 5, nan)                            # NaN objectness
    return r.reshape(1, 10, 10, 75), {}


def tile_boundary_head() -> tuple:
    """`TILE_CANDIDATES` small boxes in distinct cells at strictly falling
    scores (rank = placement order), classes cycling over 20, no two
    overlapping, except that the box of rank 32 nearly repeats rank 31's
    (same cell and class, the next anchor) and the box of rank 33 repeats
    rank 0's: kept boxes of the first tile suppress ranks of the second,
    one across the boundary of ranks 31 and 32."""
    r = _background()
    cells = [(i // 8, i % 8) for i in range(TILE_CANDIDATES)]
    logit = {0: -2.0, 1: np.log(0.12 / 0.32) - 2.0,
             2: np.log(0.12 / 0.72) - 2.0}
    for rank in range(TILE_CANDIDATES):
        twin = {32: (31, 1), 33: (0, 2)}.get(rank)
        src, a = twin if twin else (rank, 0)
        gy, gx = cells[src]
        cls = src % 20
        hw = logit[a] + (0.05 if twin else 0.0)
        _peak(r, gy, gx, a, cls, 6.0 - 0.1 * rank, (0.3, -0.3, hw, hw))
    return r.reshape(1, 10, 10, 75), {}


def separated_max_out_1() -> tuple:
    """The score-separated head with max_out = 1: one round."""
    return separated_head()[0], {"max_out": 1}


# name: () -> (raw head (1, 10, 10, 75), post-processing arguments)
HEADS = {"distinct_classes": distinct_classes_head, "empty": empty_head,
         "nonfinite": nonfinite_head, "tile_boundary": tile_boundary_head,
         "max_out_1": separated_max_out_1}
