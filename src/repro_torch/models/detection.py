"""Detection-head decode + NMS (paper §6.2 post-processing).

The head emits (B, G, G, 75) raw values = 3 anchors × (tx, ty, tw, th, obj,
20 cls) per cell, y/x/channel order. Decode follows YOLOv3:
  bx = (σ(tx) + cx)/G, by = (σ(ty) + cy)/G, bw = pw·e^tw, bh = ph·e^th,
confidence = σ(obj)·σ(cls). NMS is greedy per-class IoU suppression over a
fixed number of iterations, batched over images. On the card `postprocess`
is one CUDA kernel (``csrc/detect_nms.cu``, entry point
``detect_postprocess``) that decodes and suppresses, and `nms` the same
kernel on decoded boxes (``detect_nms``); on the CPU they are
`decode_head` and the plain loop `nms_plain`, the versions the kernel is
held to. Counterpart of ``repro/models/detection.py``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.models.yolo import NUM_ANCHORS, NUM_CLASSES

# Anchor priors (fraction of image size), 3 anchors for the single head.
ANCHORS = ((0.12, 0.18), (0.32, 0.42), (0.72, 0.78))
# the priors as float32 in host memory, (w, h) of each anchor, for the
# kernel's decode
_ANCHORS_HOST = (ctypes.c_float * (2 * NUM_ANCHORS))(
    *(v for pair in ANCHORS for v in pair))

# (boxes, scores, out_b, out_s, out_c, batch, n, c, max_out, iou_thresh,
# score_thresh, stream)
NMS_KERNEL = _build.Kernel("detect_nms.cu", "detect_nms",
                           [_build.P] * 5 + [_build.I] * 4
                           + [_build.F] * 2 + [_build.P])
# (raw, anchors, out_b, out_s, out_c, batch, grid, c, max_out, iou_thresh,
# score_thresh, stream)
POSTPROCESS_KERNEL = _build.Kernel("detect_nms.cu", "detect_postprocess",
                                   [_build.P] * 5 + [_build.I] * 4
                                   + [_build.F] * 2 + [_build.P])

_grids: Dict[Tuple[torch.device, int], tuple] = {}


def _grid_constants(grid: int, device: torch.device) -> tuple:
    """(cx, cy, anchors) of a G×G head on ``device``, made once per
    (device, G): the anchors come from the host, and a copy from the host
    inside a dispatch would break its CUDA graph capture."""
    key = (device, grid)
    if key not in _grids:
        ar = torch.arange(grid, dtype=torch.float32, device=device)
        cy, cx = torch.meshgrid(ar, ar, indexing="ij")
        anchors = torch.tensor(ANCHORS, dtype=torch.float32, device=device)
        _grids[key] = (cx, cy, anchors)
    return _grids[key]


def decode_head(raw: torch.Tensor) -> dict:
    """raw (B, G, G, 75) → boxes (B, G·G·A, 4) cxcywh in [0,1], scores
    (B, G·G·A, 20). G is read off the head, so every bucket shares one
    decode."""
    b, grid = raw.shape[0], raw.shape[1]
    r = raw.reshape(b, grid, grid, NUM_ANCHORS, 5 + NUM_CLASSES)
    cx, cy, anchors = _grid_constants(grid, raw.device)
    bx = (torch.sigmoid(r[..., 0]) + cx[None, :, :, None]) / grid
    by = (torch.sigmoid(r[..., 1]) + cy[None, :, :, None]) / grid
    bw = anchors[:, 0] * torch.exp(torch.clamp(r[..., 2], -8, 8))
    bh = anchors[:, 1] * torch.exp(torch.clamp(r[..., 3], -8, 8))
    obj = torch.sigmoid(r[..., 4])
    cls_prob = torch.sigmoid(r[..., 5:])
    boxes = torch.stack([bx, by, bw, bh], dim=-1).reshape(b, -1, 4)
    scores = (obj[..., None] * cls_prob).reshape(b, -1, NUM_CLASSES)
    return {"boxes": boxes, "scores": scores}


def iou_cxcywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between (..., 4) and (..., 4) cxcywh boxes."""
    ax1, ay1 = a[..., 0] - a[..., 2] / 2, a[..., 1] - a[..., 3] / 2
    ax2, ay2 = a[..., 0] + a[..., 2] / 2, a[..., 1] + a[..., 3] / 2
    bx1, by1 = b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2
    bx2, by2 = b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), min=0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), min=0)
    inter = iw * ih
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return inter / torch.clamp(union, min=1e-9)


def _check_post(max_out: int, score_thresh: float) -> None:
    """What the kernel's ranked sweep takes besides shapes: it ranks the
    boxes of positive score only, which is the greedy loop's order while
    no score is negative."""
    if max_out < 1:
        raise ValueError(f"max_out must be positive, got {max_out}")
    if score_thresh < 0:
        raise ValueError(f"the post-processing kernel takes score_thresh "
                         f">= 0, got {score_thresh}")


def _launch(kernel: _build.Kernel, dev: torch.device, inputs: tuple,
            sizes: tuple, max_out: int, iou_thresh: float,
            score_thresh: float) -> tuple:
    """Launches one of the kernel's two entry points: (two input pointers,
    the three outputs, sizes beginning with the batch, max_out, the
    thresholds, the stream)."""
    out_b, out_s, out_c = _empty_detections(sizes[0], max_out, dev)
    kernel(*inputs, out_b.data_ptr(), out_s.data_ptr(), out_c.data_ptr(),
           *sizes, max_out, float(iou_thresh), float(score_thresh),
           torch.cuda.current_stream(dev).cuda_stream)
    return out_b, out_s, out_c


def nms(boxes: torch.Tensor, scores: torch.Tensor, *,
        iou_thresh: float = 0.45, score_thresh: float = 0.25,
        max_out: int = 50):
    """Greedy per-class NMS, batched: boxes (B, N, 4), scores (B, N, C) →
    (B, max_out, 4), (B, max_out), (B, max_out) int32 class ids; empty
    slots have box 0, score 0 and class -1.

    CUDA tensors launch ``csrc/detect_nms.cu``'s ``detect_nms`` (one block
    per image; float32 only; score_thresh >= 0) or raise, also where an
    image's N boxes do not fit in the block's shared memory (N above about
    8,000: the launch fails with cudaErrorInvalidValue); CPU tensors run
    `nms_plain`. The two agree bit for bit.
    """
    with _build.work("detect_nms", 0, "none",
                     _build.nbytes(boxes, scores)) as out:
        if _build.shape_only(boxes):
            res = _empty_detections(scores.shape[0], max_out, boxes.device)
        elif boxes.is_cuda:
            res = _nms_launch(boxes, scores, iou_thresh, score_thresh,
                              max_out)
        else:
            res = nms_plain(boxes, scores, iou_thresh=iou_thresh,
                            score_thresh=score_thresh, max_out=max_out)
        out.extend(res)
    return res


def _empty_detections(nb: int, max_out: int, dev) -> tuple:
    """Post-processing's three results, empty: (nb, max_out, 4) boxes and
    (nb, max_out) scores in f32, (nb, max_out) int32 classes."""
    return (torch.empty((nb, max_out, 4), dtype=torch.float32, device=dev),
            torch.empty((nb, max_out), dtype=torch.float32, device=dev),
            torch.empty((nb, max_out), dtype=torch.int32, device=dev))


def _nms_launch(boxes, scores, iou_thresh: float, score_thresh: float,
                max_out: int) -> tuple:
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms on the card takes float32 boxes and scores, "
                        f"got {boxes.dtype} and {scores.dtype}")
    nb, n, c = scores.shape
    if boxes.shape != (nb, n, 4) or scores.device != boxes.device:
        raise ValueError(f"boxes {tuple(boxes.shape)} on {boxes.device} do "
                         f"not match scores {tuple(scores.shape)} on "
                         f"{scores.device}")
    if min(nb, n, c) < 1:
        raise ValueError(f"nms needs images, boxes and classes, got B={nb}, "
                         f"N={n}, C={c}")
    _check_post(max_out, score_thresh)
    boxes, scores = boxes.contiguous(), scores.contiguous()
    return _launch(NMS_KERNEL, boxes.device,
                   (boxes.data_ptr(), scores.data_ptr()), (nb, n, c),
                   max_out, iou_thresh, score_thresh)


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor, *,
              iou_thresh: float = 0.45, score_thresh: float = 0.25,
              max_out: int = 50):
    """`nms` as a loop of PyTorch ops: the plain version of the kernel.

    Runs exactly ``max_out`` iterations, as the reference does; argmax
    breaks ties on the first index.
    """
    nb = boxes.shape[0]
    rows = torch.arange(nb, device=boxes.device)
    cls_id = torch.argmax(scores, dim=-1)
    score = torch.amax(scores, dim=-1)
    score = torch.where(score >= score_thresh, score, 0.0)
    out_b = torch.zeros((nb, max_out, 4), dtype=boxes.dtype,
                        device=boxes.device)
    out_s = torch.zeros((nb, max_out), dtype=score.dtype, device=boxes.device)
    out_c = torch.full((nb, max_out), -1, dtype=torch.int32,
                       device=boxes.device)
    for i in range(max_out):
        j = torch.argmax(score, dim=-1)
        best = score[rows, j]
        box = boxes[rows, j]
        cj = cls_id[rows, j]
        out_b[:, i] = box
        out_s[:, i] = best
        out_c[:, i] = torch.where(best > 0, cj, -1).to(torch.int32)
        ious = iou_cxcywh(box[:, None, :], boxes)
        suppress = (ious > iou_thresh) & (cls_id == cj[:, None])
        score = torch.where(suppress, 0.0, score)
        score[rows, j] = 0.0
    out_s = torch.where(out_s > 0, out_s, 0.0)
    return out_b, out_s, out_c


def postprocess(raw: torch.Tensor, *, iou_thresh: float = 0.45,
                score_thresh: float = 0.25, max_out: int = 50):
    """Full post-processing for a batch of raw heads (B, G, G, 75): the
    outputs of `nms` on `decode_head`'s boxes and scores.

    A CUDA tensor launches ``csrc/detect_nms.cu``'s ``detect_postprocess``
    once, which decodes in its prologue and runs `nms`'s sweep (float32
    only; score_thresh >= 0; G·G·3 boxes up to about 8,000, past which the
    launch fails with cudaErrorInvalidValue), or raises; a CPU tensor runs
    `decode_head` and `nms_plain`. The two agree bit for bit.
    """
    with _build.work("detect_postprocess", 0, "none",
                     _build.nbytes(raw)) as out:
        if _build.shape_only(raw):
            res = _empty_detections(raw.shape[0], max_out, raw.device)
        elif raw.is_cuda:
            res = _postprocess_launch(raw, iou_thresh, score_thresh, max_out)
        else:
            dec = decode_head(raw)
            res = nms_plain(dec["boxes"], dec["scores"],
                            iou_thresh=iou_thresh,
                            score_thresh=score_thresh, max_out=max_out)
        out.extend(res)
    return res


def _postprocess_launch(raw, iou_thresh: float, score_thresh: float,
                        max_out: int) -> tuple:
    if raw.dtype != torch.float32:
        raise TypeError(f"postprocess on the card takes a float32 head, got "
                        f"{raw.dtype}")
    if (raw.dim() != 4 or raw.shape[1] != raw.shape[2] or raw.shape[1] < 1
            or raw.shape[0] < 1
            or raw.shape[3] != NUM_ANCHORS * (5 + NUM_CLASSES)):
        raise ValueError(f"postprocess takes heads (B, G, G, "
                         f"{NUM_ANCHORS * (5 + NUM_CLASSES)}), got "
                         f"{tuple(raw.shape)}")
    _check_post(max_out, score_thresh)
    raw = raw.contiguous()
    return _launch(POSTPROCESS_KERNEL, raw.device,
                   (raw.data_ptr(), ctypes.addressof(_ANCHORS_HOST)),
                   (raw.shape[0], raw.shape[1], NUM_CLASSES), max_out,
                   iou_thresh, score_thresh)


def compact_detections(boxes: torch.Tensor, scores: torch.Tensor,
                       classes: torch.Tensor):
    """NMS output → the device-side emission wire: fp16 boxes, fp16 scores,
    int8 classes and an int32 valid count (kept boxes are a prefix, in
    descending score). Works per image or on a leading batch dim."""
    valid = torch.sum((scores > 0).to(torch.int32), dim=-1, dtype=torch.int32)
    return (boxes.to(torch.float16), scores.to(torch.float16),
            classes.to(torch.int8), valid)


def detections_to_list(boxes, scores, classes) -> list:
    """NMS output for ONE image → host-side list of dicts (empty slots
    dropped) — the wire form of a detection ServeResult."""
    boxes, scores, classes = (_np(boxes), _np(scores), _np(classes))
    keep = scores > 0
    return [{"box_cxcywh": boxes[i].tolist(), "score": float(scores[i]),
             "class_id": int(classes[i])} for i in np.flatnonzero(keep)]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
