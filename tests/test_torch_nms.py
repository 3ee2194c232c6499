"""Port parity for the post-processing kernel's algorithm
(``csrc/detect_nms.cu``): a numpy model of its ranked, tiled sweep held bit
for bit against the plain loop `nms_plain` and the reference's `nms`, on
the fixtures of ``launch/nms_fixtures.py`` and on drawn heads with many
equal scores; and the CPU `postprocess` against `decode_head` +
`nms_plain` and the reference's jitted `postprocess`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.models import detection as jdetection  # noqa: E402
from repro_torch.launch import nms_fixtures  # noqa: E402
from repro_torch.models import detection  # noqa: E402

TILE = 32          # ranks the kernel resolves at a time, one warp's lanes
F = np.float32


def _iou_gt(a, b, thresh):
    """iou_cxcywh(a, b) > thresh in float32, a the kept box, broadcast over
    leading dimensions, in the order of operations of the plain version."""
    with np.errstate(all="ignore"):
        ax1, ay1 = a[..., 0] - a[..., 2] / F(2), a[..., 1] - a[..., 3] / F(2)
        ax2, ay2 = a[..., 0] + a[..., 2] / F(2), a[..., 1] + a[..., 3] / F(2)
        bx1, by1 = b[..., 0] - b[..., 2] / F(2), b[..., 1] - b[..., 3] / F(2)
        bx2, by2 = b[..., 0] + b[..., 2] / F(2), b[..., 1] + b[..., 3] / F(2)
        iw = np.maximum(np.minimum(ax2, bx2) - np.maximum(ax1, bx1), F(0))
        ih = np.maximum(np.minimum(ay2, by2) - np.maximum(ay1, by1), F(0))
        inter = iw * ih
        union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
        return inter / np.maximum(union, F(1e-9)) > F(thresh)


def sweep_model(boxes, scores, *, iou_thresh=0.45, score_thresh=0.25,
                max_out=50):
    """The kernel's algorithm in numpy, image by image.

    Rank the boxes of positive score by (score descending, index
    ascending). Sweep the ranks a tile of 32 at a time: a rank is dropped
    when a box kept in an earlier tile suppresses it (same class, IoU above
    the threshold, the kept box first); the tile's row masks say which of
    its earlier ranks would suppress each rank; a rank is kept when it is
    not dropped and no kept rank of its row suppresses it, until max_out
    are kept. Slots past the kept boxes carry box 0, score 0, class -1.
    """
    outs = ([], [], [])
    for bx, sc in zip(boxes, scores):
        cls = np.argmax(sc, axis=-1)        # the first NaN, else first max
        best = np.max(sc, axis=-1)
        score = np.where(best >= F(score_thresh), best, F(0))
        order = sorted(np.flatnonzero(score > 0),
                       key=lambda j: (-score[j], j))
        keep = []
        for base in range(0, len(order), TILE):
            if len(keep) >= max_out:
                break
            tile = np.asarray(order[base:base + TILE])
            kept = np.asarray(keep, dtype=np.int64)
            dropped = [bool(np.any((cls[kept] == cls[q])
                                   & _iou_gt(bx[kept], bx[q], iou_thresh)))
                       for q in tile]
            rows = (cls[tile][:, None] == cls[tile][None, :]) \
                & _iou_gt(bx[tile][None, :], bx[tile][:, None], iou_thresh) \
                & np.tri(len(tile), k=-1, dtype=bool)
            bits = []
            for r in range(len(tile)):
                if len(keep) + len(bits) == max_out:
                    break
                if not dropped[r] and not rows[r, bits].any():
                    bits.append(r)
            keep += [int(tile[r]) for r in bits]
        empty = max_out - len(keep)
        outs[0].append(np.concatenate([bx[keep], np.repeat(bx[:1], empty, 0)]))
        outs[1].append(np.concatenate([score[keep], np.zeros(empty, F)]))
        outs[2].append(np.concatenate([cls[keep], np.full(empty, -1)])
                       .astype(np.int32))
    return [np.stack(o) for o in outs]


def _reference_nms(boxes, scores, **post):
    """The reference's `nms` image by image, stacked."""
    outs = [jdetection.nms(jnp.asarray(b), jnp.asarray(s), **post)
            for b, s in zip(boxes, scores)]
    return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(3)]


def _assert_same(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w, equal_nan=True)


def _decoded(head):
    dec = detection.decode_head(torch.from_numpy(head))
    return dec["boxes"].numpy(), dec["scores"].numpy()


def _case(name):
    """(decoded boxes, scores, post-processing arguments) of a fixture."""
    if name.startswith("tie"):
        boxes, scores = nms_fixtures.tied_boxes()
        return boxes, scores, {"iou_thresh": float(name.split("@")[1])}
    if name == "separated":
        return (*_decoded(nms_fixtures.separated_head()[0]), {})
    head, post = nms_fixtures.HEADS[name]()
    return (*_decoded(head), post)


CASES = ["separated", f"tie@{nms_fixtures.TIE_IOU}", "tie@0.45",
         *nms_fixtures.HEADS]


@pytest.mark.parametrize("name", CASES)
def test_sweep_model_is_the_greedy_loop(name):
    boxes, scores, post = _case(name)
    plain = detection.nms_plain(torch.from_numpy(boxes),
                                torch.from_numpy(scores), **post)
    model = sweep_model(boxes, scores, **post)
    _assert_same(model, [t.numpy() for t in plain])
    _assert_same(model, _reference_nms(boxes, scores, **post))


def _kept_indices(boxes, out_b, out_s):
    """Indices of the kept boxes, matched by value (NaN equal to NaN)."""
    def at(b):
        same = (boxes[0] == b) | (np.isnan(boxes[0]) & np.isnan(b))
        return int(np.flatnonzero(same.all(-1))[0])
    return [at(b) for b, s in zip(out_b[0], out_s[0]) if s > 0]


@pytest.mark.parametrize("name", list(nms_fixtures.HEADS))
def test_fixture_exercises_its_case(name):
    boxes, scores, post = _case(name)
    out_b, out_s, out_c = sweep_model(boxes, scores, **post)
    kept = _kept_indices(boxes, out_b, out_s)
    best = scores[0].max(-1)
    if name == "distinct_classes":
        # max_out boxes kept, in falling score, though they overlap
        assert len(kept) == post["max_out"]
        assert out_c[0].tolist() == list(range(post["max_out"]))
        assert _iou_gt(boxes[0][kept[0]], boxes[0][kept[1]], 0.45)
    elif name == "empty":
        assert not (best >= F(0.25)).any()
        assert (out_c == -1).all() and (out_s == 0).all()
        assert (out_b[0] == boxes[0][0]).all()
    elif name == "nonfinite":
        head = nms_fixtures.nonfinite_head()[0]
        assert np.isnan(head).any() and np.isposinf(head).any() \
            and np.isneginf(head).any()
        assert len(kept) == 4 and np.isnan(out_b[0, :4]).any()
        assert (out_s[0, :2] == 1).all()         # the two score-1 boxes
    elif name == "tile_boundary":
        order = sorted(np.flatnonzero(best >= F(0.25)),
                       key=lambda j: (-best[j], j))
        assert len(order) == nms_fixtures.TILE_CANDIDATES
        ranks = [order.index(k) for k in kept]
        assert ranks == [r for r in range(nms_fixtures.TILE_CANDIDATES)
                         if r not in nms_fixtures.TILE_SUPPRESSED]
        # rank 31 (first tile) suppresses rank 32 (second tile)
        assert _iou_gt(boxes[0][order[31]], boxes[0][order[32]], 0.45)
    elif name == "max_out_1":
        assert out_s.shape == (1, 1) and out_s[0, 0] == best.max()


@pytest.mark.parametrize("name", ["separated", *nms_fixtures.HEADS])
def test_postprocess_on_cpu_is_decode_and_plain_nms(name):
    if name == "separated":
        head, post = nms_fixtures.separated_head()[0], {}
    else:
        head, post = nms_fixtures.HEADS[name]()
    raw = torch.from_numpy(head)
    got = detection.postprocess(raw, **post)
    dec = detection.decode_head(raw)
    _assert_same(got, [t.numpy() for t in detection.nms_plain(
        dec["boxes"], dec["scores"], **post)])
    if name == "separated":
        # the reference decodes with XLA's sigmoid and exp, which differ
        # from PyTorch's in the last bit on the CPU: the same boxes kept,
        # in the same order and classes, within the decode's tolerance
        want = jdetection.postprocess(jnp.asarray(head), **post)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


_VALUES = np.array([0, 0.1, 0.25, 0.3, 0.5, 0.75, 1.0], F)
_COORDS = np.array([0.25, 0.375, 0.5, 0.625], F)


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(n=st.integers(1, 80), c=st.integers(1, 4), max_out=st.integers(1, 70),
       iou_thresh=st.sampled_from([1 / 3, 0.45, 0.0]),
       score_thresh=st.sampled_from([0.25, 0.0]),
       seed=st.integers(0, 2 ** 31 - 1))
def test_sweep_model_on_drawn_heads_with_equal_scores(n, c, max_out,
                                                      iou_thresh,
                                                      score_thresh, seed):
    """Scores from seven values and boxes on a coarse grid: ties in score,
    in class and in IoU, across tile boundaries."""
    rng = np.random.default_rng(seed)
    scores = _VALUES[rng.integers(0, len(_VALUES), (1, n, c))]
    boxes = np.stack([_COORDS[rng.integers(0, 4, (1, n))],
                      _COORDS[rng.integers(0, 4, (1, n))],
                      F(0.25) * rng.integers(1, 4, (1, n)),
                      F(0.125) * rng.integers(1, 4, (1, n))],
                     -1).astype(F)
    post = dict(iou_thresh=iou_thresh, score_thresh=score_thresh,
                max_out=max_out)
    model = sweep_model(boxes, scores, **post)
    plain = detection.nms_plain(torch.from_numpy(boxes),
                                torch.from_numpy(scores), **post)
    _assert_same(model, [t.numpy() for t in plain])
    _assert_same(model, _reference_nms(boxes, scores, **post))
