"""Synthetic datasets, deterministic in (seed, step, shard), as the
reference's (``repro/data/pipeline.py``).

LM:        token streams with an induced bigram structure, so the loss
           falls (a model can learn the transition table).
Detection: coloured rectangles on noise, the boxes as labels. The
           detector's QAT trains on these.

A batch is a pure function of (seed, step, shard), with no iterator state,
as the reference's is. ``jax.random`` cannot be reproduced without JAX, so
the port's batches are its own draws with the reference's structure.

* LM: x0, the per-sequence offset, the noise mask and the noise tokens come
  from ``np.random.default_rng([seed, step, shard])`` on the host; the
  recurrence, the 10% noise and the label roll are the reference's.
* Detection: the boxes, classes and presence come from
  ``np.random.default_rng([seed + 77, step, shard])`` on the host, and the
  noise from a ``torch.Generator`` on the batch's device, seeded by the
  same host generator. The ranges, the painting and `yolo_target` are the
  reference's; `yolo_target` is bit-exact with it on the same boxes and
  classes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.yolo import GRID, INPUT_SIZE, NUM_ANCHORS, NUM_CLASSES


@dataclasses.dataclass(frozen=True)
class LMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def make_lm_dataset(vocab_size: int, seq_len: int, global_batch: int,
                    seed: int = 0) -> LMDataset:
    return LMDataset(vocab_size, seq_len, global_batch, seed)


LM_MULT = 31
LM_OFFSETS = 7
LM_NOISE = 0.1


def lm_batch(ds: LMDataset, step: int, *, shard: int = 0,
             num_shards: int = 1, device=None) -> tuple:
    """→ (tokens, labels), each (global_batch / num_shards, seq_len) int32
    on ``device`` (default: the card).

    Token stream: x_{t+1} = (31·x_t + c_b) mod V from a uniform x_0, with
    c_b ∈ [0, 7) drawn per sequence (a bigram table to learn); the stream
    starts at x_1, as the reference's scan emits it. Each token is then
    replaced by a uniform one with probability 0.1. Labels are the tokens
    rolled left by one."""
    dev = resolve_device(device)
    bsz, v = ds.global_batch // num_shards, ds.vocab_size
    rng = np.random.default_rng([ds.seed, int(step), int(shard)])
    x = rng.integers(0, v, (bsz, 1))
    offs = rng.integers(0, LM_OFFSETS, (bsz, 1))
    mult = LM_MULT % v or 1
    seq = np.empty((bsz, ds.seq_len), np.int64)
    for t in range(ds.seq_len):
        x = (x * mult + offs) % v
        seq[:, t:t + 1] = x
    noise = rng.random(seq.shape) < LM_NOISE
    rand = rng.integers(0, v, seq.shape)
    tokens = np.where(noise, rand, seq).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    return (torch.from_numpy(tokens).to(dev),
            torch.from_numpy(labels).to(dev))


@dataclasses.dataclass(frozen=True)
class DetectionDataset:
    global_batch: int
    seed: int = 0
    max_boxes: int = 4


def make_detection_dataset(global_batch: int, seed: int = 0,
                           max_boxes: int = 4) -> DetectionDataset:
    return DetectionDataset(global_batch, seed, max_boxes)


def detection_batch(ds: DetectionDataset, step: int, *, shard: int = 0,
                    num_shards: int = 1, device=None) -> tuple:
    """→ images (B, 320, 320, 3) f32 in [0, 1], boxes (B, M, 4) f32 cxcywh
    and classes (B, M) int32 (−1: no box), all on ``device`` (default: the
    card). cx, cy ∈ [0.15, 0.85], w, h ∈ [0.1, 0.3], classes ∈ [0, 20),
    each box present with probability 0.8; noise ×0.15 and each present
    box painted in its class colour, clipped to [0, 1]."""
    dev = resolve_device(device)
    bsz, m = ds.global_batch // num_shards, ds.max_boxes
    rng = np.random.default_rng([ds.seed + 77, int(step), int(shard)])
    cx = rng.uniform(0.15, 0.85, (bsz, m))
    cy = rng.uniform(0.15, 0.85, (bsz, m))
    w = rng.uniform(0.1, 0.3, (bsz, m))
    h = rng.uniform(0.1, 0.3, (bsz, m))
    boxes = np.stack([cx, cy, w, h], -1).astype(np.float32)
    classes = rng.integers(0, NUM_CLASSES, (bsz, m))
    present = rng.random((bsz, m)) < 0.8
    classes = np.where(present, classes, -1).astype(np.int32)
    noise_seed = int(rng.integers(0, 2 ** 63))

    # the colour encodes the class (a learnable signal); f32 on the host
    col = np.stack([(classes % 5).astype(np.float32) / np.float32(5) + 0.2,
                    (classes % 7).astype(np.float32) / np.float32(7) + 0.1,
                    (classes % 3).astype(np.float32) / np.float32(3) + 0.3],
                   -1).astype(np.float32)
    col = np.clip(col, 0, 1) * present[..., None]
    pix = ((np.arange(INPUT_SIZE, dtype=np.float32) + np.float32(0.5))
           / np.float32(INPUT_SIZE))
    boxes_t = torch.from_numpy(boxes).to(dev)
    col_t = torch.from_numpy(col).to(dev)
    pix_t = torch.from_numpy(pix).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(noise_seed)
    img = torch.rand((bsz, INPUT_SIZE, INPUT_SIZE, 3), generator=gen,
                     device=dev) * 0.15
    bx, by, bw, bh = boxes_t.unbind(-1)
    yy, xx = pix_t[None, :, None], pix_t[None, None, :]
    for j in range(m):          # boxes painted one at a time, in order
        inside = ((yy > (by[:, j] - bh[:, j] / 2)[:, None, None])
                  & (yy < (by[:, j] + bh[:, j] / 2)[:, None, None])
                  & (xx > (bx[:, j] - bw[:, j] / 2)[:, None, None])
                  & (xx < (bx[:, j] + bw[:, j] / 2)[:, None, None]))
        img = img + inside[..., None].to(torch.float32) \
            * col_t[:, None, None, j]
    img = torch.clamp(img, 0.0, 1.0)
    return img, boxes_t, torch.from_numpy(classes).to(dev)


def yolo_target(boxes: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """Rasterize the ground truth onto the 10×10×3-anchor grid (YOLOv3
    style): (B, M, 4), (B, M) → (B, G, G, A, 5 + C), on the boxes' device.

    Bit-exact with the reference: cell = clip(int32(box·G)), anchor =
    clip(int32(area / 0.05), 0, 2), rows of absent boxes zeroed, added
    into the grid, clipped to [0, 1]. XLA adds colliding rows in (b, m)
    order; here one box slot at a time, in which the batch indices are
    distinct, so the sums run in that order on every device."""
    bsz, m, _ = boxes.shape
    dev = boxes.device
    tgt = torch.zeros((bsz, GRID, GRID, NUM_ANCHORS, 5 + NUM_CLASSES),
                      dtype=torch.float32, device=dev)
    cell_y = torch.clamp((boxes[..., 1] * GRID).to(torch.int32), 0, GRID - 1)
    cell_x = torch.clamp((boxes[..., 0] * GRID).to(torch.int32), 0, GRID - 1)
    # anchor by box area (small / medium / large); a tensor divisor keeps
    # the division a division on CUDA
    area = boxes[..., 2] * boxes[..., 3]
    area_unit = torch.full((), 0.05, dtype=area.dtype, device=dev)
    anchor = torch.clamp((area / area_unit).to(torch.int32), 0,
                         NUM_ANCHORS - 1)
    valid = classes >= 0
    one_cls = torch.nn.functional.one_hot(
        torch.clamp(classes, min=0).long(), NUM_CLASSES).to(torch.float32)
    rows = torch.cat([boxes.to(torch.float32),
                      torch.ones((bsz, m, 1), dtype=torch.float32,
                                 device=dev), one_cls], -1)
    rows = rows * valid[..., None].to(torch.float32)
    bidx = torch.arange(bsz, device=dev)
    for j in range(m):
        tgt.index_put_((bidx, cell_y[:, j].long(), cell_x[:, j].long(),
                        anchor[:, j].long()), rows[:, j], accumulate=True)
    return torch.clamp(tgt, 0.0, 1.0)
