"""NMS inputs whose kept sets are known, made with numpy: they hold the NMS
kernel against its plain version on the card (``chip_smoke.py``) and the
plain version against the reference on the CPU (the tests).

Untrained heads score every box near σ(0)² ≈ 0.25, so their kept sets are
ties; these fixtures separate the scores or set the ties on purpose.
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
