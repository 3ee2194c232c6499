"""Port parity for one-dispatch serving: the NMS dispatcher and its plain
loop against the reference on the score-separated and tie fixtures,
decode's cached grid constants, the launch accounting of CUDA graph
replays (with stub kernels), and the CPU backend's payloads."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import detection as jdetection  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import nms_fixtures  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import detection, yolo  # noqa: E402
from repro_torch.serve import DetectionBackend  # noqa: E402


def _reference_nms(boxes, scores, **post):
    """The reference's `nms` image by image, stacked."""
    outs = [jdetection.nms(jnp.asarray(b), jnp.asarray(s), **post)
            for b, s in zip(boxes, scores)]
    return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(3)]


def _assert_same(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_nms_dispatcher_on_cpu_is_the_plain_loop_and_the_reference():
    head, peaks = nms_fixtures.separated_head()
    dec = detection.decode_head(torch.from_numpy(head))
    got = detection.nms(dec["boxes"], dec["scores"])
    plain = detection.nms_plain(dec["boxes"], dec["scores"])
    _assert_same(got, [t.numpy() for t in plain])
    _assert_same(got, _reference_nms(dec["boxes"].numpy(),
                                     dec["scores"].numpy()))
    assert int((got[1] > 0).sum()) == len(peaks)
    assert sorted(int(c) for c in got[2][0] if c >= 0) == sorted(
        cls for *_, cls in peaks)


@pytest.mark.parametrize("iou_thresh", [nms_fixtures.TIE_IOU, 0.45])
def test_nms_ties_take_the_lowest_index(iou_thresh):
    boxes, scores = nms_fixtures.tied_boxes()
    got = detection.nms_plain(torch.from_numpy(boxes),
                              torch.from_numpy(scores),
                              iou_thresh=iou_thresh)
    _assert_same(got, _reference_nms(boxes, scores, iou_thresh=iou_thresh))
    _assert_same(detection.nms(torch.from_numpy(boxes),
                               torch.from_numpy(scores),
                               iou_thresh=iou_thresh),
                 [t.numpy() for t in got])
    kept = [int(np.flatnonzero((boxes[0] == b).all(-1))[0])
            for b, s in zip(got[0][0].numpy(), got[1][0]) if s > 0]
    assert tuple(kept) == nms_fixtures.TIE_KEPT
    # box 4 ties classes 1 and 3; the first wins
    assert int(got[2][0, kept.index(4)]) == 1


@pytest.mark.parametrize("grid", [2, 10])
def test_decode_grid_constants_are_cached_and_unchanged(grid):
    rng = np.random.default_rng(grid)
    raw = torch.from_numpy(
        (3 * rng.standard_normal((2, grid, grid, 75))).astype(np.float32))
    dec = detection.decode_head(raw)
    cx, cy, anchors = detection._grid_constants(grid, raw.device)
    assert detection._grid_constants(grid, raw.device)[0] is cx
    # the constants as decode_head built them in every call before
    ar = torch.arange(grid, dtype=torch.float32)
    want_cy, want_cx = torch.meshgrid(ar, ar, indexing="ij")
    assert torch.equal(cx, want_cx) and torch.equal(cy, want_cy)
    assert torch.equal(anchors, torch.tensor(detection.ANCHORS,
                                             dtype=torch.float32))
    r = raw.reshape(2, grid, grid, 3, 25)
    bx = (torch.sigmoid(r[..., 0]) + want_cx[None, :, :, None]) / grid
    bw = anchors[:, 0] * torch.exp(torch.clamp(r[..., 2], -8, 8))
    assert torch.equal(dec["boxes"][..., 0], bx.reshape(2, -1))
    assert torch.equal(dec["boxes"][..., 2], bw.reshape(2, -1))
    # XLA's and PyTorch's sigmoid and exp differ in the last bit on the
    # CPU, so the reference holds within the suite's tolerance
    jdec = jdetection.decode_head(jnp.asarray(raw.numpy()))
    for leaf in ("boxes", "scores"):
        np.testing.assert_allclose(dec[leaf].numpy(), np.asarray(jdec[leaf]),
                                   rtol=1e-6, atol=1e-7)


@pytest.fixture
def stub_kernels():
    """Two kernels whose launches run nothing and report no error."""
    kernels = [_build.Kernel("stub.cu", name, []) for name in ("a", "b")]
    for k in kernels:
        k._fn = lambda *args: 0
    yield kernels
    for k in kernels:
        _build.KERNELS.remove(k)


@pytest.mark.parametrize("replays", [1, 3])
def test_graph_replays_add_the_captured_launches(stub_kernels, replays):
    a, b = stub_kernels
    a()
    with _build.capturing() as captured:
        a()
        a()
        b()
    # a captured call launches nothing: the counts are as before capture
    assert (a.launches, b.launches) == (1, 0)
    assert captured.counts == {a: 2, b: 1}
    for _ in range(replays):
        captured.replayed()
    assert (a.launches, b.launches) == (1 + 2 * replays, replays)


def test_failed_capture_leaves_the_counts(stub_kernels):
    a, b = stub_kernels
    b._fn = lambda *args: 700            # cudaErrorIllegalAddress
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        with _build.capturing():
            a()
            b()
    assert (a.launches, b.launches) == (0, 0)


@pytest.fixture(scope="module")
def cpu_detector():
    imgs = launch.make_images(3, 1, size=64)
    _, art = yolo.build_detector(0, imgs[:1].astype(np.float32) / 256.0,
                                 device="cpu")
    return art, imgs


@pytest.mark.parametrize("device_nms", [False, True])
def test_cpu_backend_payloads_are_the_eager_forward(cpu_detector,
                                                    device_nms):
    """Stacking on the host changes nothing: uint8 images divided by 256
    and float images as they are, zero-padded to the width, through the
    forward, decode and NMS."""
    art, imgs = cpu_detector
    images = [imgs[0], imgs[1].astype(np.float32) / 256.0, imgs[2]]
    backend = DetectionBackend(art, slots=4, device="cpu",
                               device_nms=device_nms)
    batch = backend._host_batch(images)
    assert batch.dtype == torch.float32 and batch.shape == (4, 64, 64, 3)
    assert backend._host_batch([imgs[0]]).dtype == torch.uint8
    results, _ = launch.serve(backend, np.stack(
        [np.asarray(im) for im in (imgs[0], imgs[2])]))
    want_x = torch.zeros((4, 64, 64, 3))
    for i, im in enumerate(images):
        t = torch.from_numpy(np.asarray(im))
        want_x[i] = t.to(torch.float32) / 256.0 if t.dtype == torch.uint8 \
            else t
    with torch.no_grad():
        raw = yolo.yolo_forward_kernel(
            art, want_x, configs=yolo.kernel_configs(art, 64, 4))
    outs = detection.postprocess(raw)
    if device_nms:
        outs = detection.compact_detections(*outs)
    else:
        outs = (raw, *outs)
    got = backend._host_outputs(64, *backend._dispatch(batch))
    _assert_same(got, [t.numpy() for t in outs])
    # the served uint8 images (slots 0 and 1 of a two-image dispatch)
    # carry the same rows as images 0 and 2 of the three-image batch
    first = results[0]
    if device_nms:
        assert np.array_equal(first["boxes"], outs[0][0].numpy()
                              .astype(np.float32))
        assert first["valid"] == int(outs[3][0])
    else:
        assert np.array_equal(first["raw"], outs[0][0].numpy())
        assert np.array_equal(results[1]["classes"], outs[3][2].numpy())


@pytest.mark.parametrize("device_nms", [False, True])
def test_output_layout_packs_each_output_aligned(cpu_detector, device_nms):
    art, _ = cpu_detector
    backend = DetectionBackend(art, slots=3, device="cpu",
                               buckets=(64, 96), device_nms=device_nms)
    for bucket in backend.buckets:
        layout, nbytes = backend._layout(bucket)
        end = 0
        for (offset, shape, dtype), (spec_shape, spec_dtype) in zip(
                layout, backend.output_specs(bucket)):
            assert (shape, dtype) == (spec_shape, spec_dtype)
            assert offset % 16 == 0 and offset >= end
            end = offset + int(np.prod(shape)) * dtype.itemsize
        assert end <= nbytes < end + 16
        assert backend._batch_bytes[bucket] <= nbytes
