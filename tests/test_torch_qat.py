"""Port parity, detector QAT: the sign STE and LSQ autograd functions, the
QAT forward and its gradients, the YOLO target, loss and train step against
the reference on the same numpy inputs; the detection sampler's
invariants; and a port-only run of the paper's offline workflow (QAT,
deploy, integer forward, alignment, decode + NMS).

Tolerances and why:
- the STE, LSQ forward and dx, `yolo_target`, `deploy_yolo`: exact (no
  float reduction, or numpy float64 on the host in the reference's order);
- LSQ's dstep: 1e-5·max|dstep|, a sum over the broadcast axes in another
  order;
- the QAT forward at 64 px: 1e-5·max|y| (f32 convs summed in another
  order); its gradients 1e-3·max|g| per leaf, since an f32 difference that
  moves a code across a rounding tie changes the gradient locally
  (ROADMAP Queue 3, calibration ties);
- the loss: rtol 1e-5 (f32 sums in another order); the train step's loss
  per step rtol 1e-4 (the second step's loss sees the first update).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jquant  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import yolo as jyolo  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import yolo_qat as jqat  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.launch import train_yolo_qat  # noqa: E402
from repro_torch.models import detection, yolo  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import ties, yolo_qat  # noqa: E402

INT_FIELDS = ("w_raw", "b_raw", "post_mult", "post_shift", "m_raw", "signs",
              "b_pre")


def _np_tree(tree):
    return {n: {k: np.asarray(v) for k, v in p.items()}
            for n, p in tree.items()}


def _jax_tree(tree_np):
    return {n: {k: jnp.asarray(v) for k, v in p.items()}
            for n, p in tree_np.items()}


_CACHE = {}


def reference_params(size: int):
    """The reference's detector, inited from PRNGKey(0) and calibrated on
    one port batch of 2 (cropped to ``size``), as numpy."""
    if size not in _CACHE:
        ds = data.make_detection_dataset(2, seed=3)
        img, _, _ = data.detection_batch(ds, 0, device="cpu")
        img = img[:, :size, :size].numpy()
        params = jyolo.calibrate_yolo(
            jyolo.init_yolo_params(jax.random.PRNGKey(0)), jnp.asarray(img))
        _CACHE[size] = _np_tree(params)
    return _CACHE[size]


# ---------------------------------------------------------------------------
# STE and LSQ
# ---------------------------------------------------------------------------

def test_binarize_ste_matches_reference():
    rng = np.random.default_rng(0)
    w = np.concatenate([
        np.array([0.0, -0.0, 1.0, -1.0, 1.0000001, -1.0000001, 1.5, -2.0,
                  0.9999999, -0.9999999], np.float32),
        rng.normal(0, 0.8, 54).astype(np.float32)]).reshape(8, 8)
    g = rng.normal(size=w.shape).astype(np.float32)
    jy, vjp = jax.vjp(jquant.binarize_ste, jnp.asarray(w))
    (jg,) = vjp(jnp.asarray(g))
    tw = torch.from_numpy(w).requires_grad_(True)
    ty = quant.binarize_ste(tw)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(jg))
    # |w| == 1 passes the gradient; |w| > 1 does not
    assert tw.grad[0, 2] == g[0, 2] and tw.grad[0, 3] == g[0, 3]
    assert tw.grad[0, 4] == 0 and tw.grad[0, 6] == 0


def _lsq_inputs(per_channel: bool):
    """x over (2, 3, 4, 5) on the rails, ties, negatives and beyond 255,
    with power-of-two steps so that x / step is exact."""
    rng = np.random.default_rng(1)
    c = 5
    step = (np.array([0.0625, 0.125, 0.5, 0.25, 1.0], np.float32)
            if per_channel else np.array(0.125, np.float32))
    k = rng.uniform(-20, 300, (2, 3, 4, c)).astype(np.float32)
    special = np.array([0.0, -0.0, 255.0, 254.5, 255.5, 0.5, 1.5, 2.5,
                        -0.5, -3.0, 300.0, 127.5], np.float32)
    k.reshape(-1)[:special.size] = special
    x = (k * np.broadcast_to(step, (c,))).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    return x, step, g


@pytest.mark.parametrize("per_channel", [False, True])
def test_lsq_fake_quant_matches_reference(per_channel):
    x, step, g = _lsq_inputs(per_channel)
    gs = quant.lsq_grad_scale(x.size // x.shape[-1])
    jy, vjp = jax.vjp(
        lambda a, s: jquant.lsq_fake_quant(a, s, jnp.asarray(gs, a.dtype)),
        jnp.asarray(x), jnp.asarray(step))
    jdx, jds = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(step).requires_grad_(True)
    ty = quant.lsq_fake_quant(tx, ts, gs)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jdx))
    jds = np.asarray(jds)
    assert ts.grad.shape == step.shape == jds.shape
    np.testing.assert_allclose(ts.grad.numpy(), jds, rtol=0,
                               atol=1e-5 * np.abs(jds).max())
    # the rails: xs of exactly 0 and 255 are in range, beyond 255 is not
    xs = x / np.broadcast_to(step, x.shape)
    assert np.any(xs == 255) and np.any(xs == 0) and np.any(xs > 255)
    in_range = (xs >= 0) & (xs <= 255)
    np.testing.assert_array_equal(tx.grad.numpy() != 0, in_range & (g != 0))


def test_lsq_helpers_match_reference():
    for numel in (1, 7, 100, 2 * 160 * 160, 10 ** 7):
        assert quant.lsq_grad_scale(numel) == jquant.lsq_grad_scale(numel)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 3, (2, 16, 16, 8)).astype(np.float32)
    # a mean of 4096 f32 values, summed in another order
    np.testing.assert_allclose(
        quant.init_step_from_batch(torch.from_numpy(x)).numpy(),
        np.asarray(jquant.init_step_from_batch(jnp.asarray(x))), rtol=1e-5)
    q = rng.integers(0, 256, (4, 8)).astype(np.float32)
    s = rng.uniform(0.01, 0.1, (8,)).astype(np.float32)
    np.testing.assert_array_equal(
        quant.dequantize_act(torch.from_numpy(q), torch.from_numpy(s)).numpy(),
        np.asarray(jquant.dequantize_act(jnp.asarray(q), jnp.asarray(s))))


# ---------------------------------------------------------------------------
# The QAT forward and its gradients
# ---------------------------------------------------------------------------

def test_train_forward_and_grads_match_reference():
    params_np = reference_params(64)
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)

    def jloss(p):
        return jnp.mean(jyolo.yolo_forward_float(p, jnp.asarray(img),
                                                 train=True) ** 2)

    jparams = _jax_tree(params_np)
    jout = np.asarray(jax.jit(lambda p: jyolo.yolo_forward_float(
        p, jnp.asarray(img), train=True))(jparams))
    jgrads = _np_tree(jax.jit(jax.grad(jloss))(jparams))

    params = convert.params_from_numpy(params_np, device="cpu")
    for p in params.values():
        for v in p.values():
            v.requires_grad_(True)
    out = yolo.yolo_forward_float(params, torch.from_numpy(img), train=True)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=0,
                               atol=1e-5 * np.abs(jout).max())
    torch.mean(out ** 2).backward()
    for name, p in params.items():
        for k, v in p.items():
            want = jgrads[name][k]
            np.testing.assert_allclose(
                v.grad.numpy(), want, rtol=0,
                atol=1e-3 * np.abs(want).max(), err_msg=f"{name}.{k}")
    # the latent binary weights and the steps get gradient (STE, LSQ)
    assert float(torch.sum(torch.abs(params["conv5"]["w"].grad))) > 0
    assert float(torch.sum(torch.abs(params["conv5"]["act_step"].grad))) > 0


def test_eval_forward_unchanged_by_train_flag():
    params = convert.params_from_numpy(reference_params(64), device="cpu")
    img = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    assert torch.equal(yolo.yolo_forward_float(params, img),
                       yolo.yolo_forward_float(params, img, train=False))
    assert yolo.GRID == jyolo.GRID == yolo.INPUT_SIZE // 32


# ---------------------------------------------------------------------------
# Target, loss and train step
# ---------------------------------------------------------------------------

def _target_case():
    """Boxes that collide (two and three in one cell and anchor), absent
    boxes, boxes on cell edges, on the image's border and on the anchor
    thresholds (area / 0.05 = 1 and 2), plus sampler boxes."""
    boxes = np.array([
        [[0.35, 0.35, 0.2, 0.2], [0.36, 0.34, 0.21, 0.19],   # one cell
         [0.3, 0.5, 0.1, 0.5], [0.0, 1.0, 0.5, 0.2],          # edges
         [0.55, 0.55, 0.1, 0.1]],
        [[0.15, 0.15, 0.25, 0.2], [0.151, 0.152, 0.2, 0.25],  # three
         [0.159, 0.158, 0.22, 0.22], [0.999, 0.0, 0.3, 0.3],
         [0.7, 0.2, 0.25, 0.4]]], np.float32)
    classes = np.array([[3, 7, 19, -1, 0], [5, 5, 12, 2, -1]], np.int32)
    ds = data.make_detection_dataset(3, seed=9, max_boxes=5)
    _, sb, sc = data.detection_batch(ds, 4, device="cpu")
    return [(boxes, classes), (sb.numpy(), sc.numpy())]


def test_yolo_target_bit_exact():
    for boxes, classes in _target_case():
        want = np.asarray(jdata.yolo_target(jnp.asarray(boxes),
                                            jnp.asarray(classes)))
        got = data.yolo_target(torch.from_numpy(boxes),
                               torch.from_numpy(classes)).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    # the collisions were clipped to 1 after the sum
    boxes, classes = _target_case()[0]
    got = data.yolo_target(torch.from_numpy(boxes),
                           torch.from_numpy(classes)).numpy()
    assert got[0, 3, 3, 0, 4] == 1.0 and got[0, 3, 3, 0, 5 + 3] == 1.0


def test_yolo_loss_matches_reference():
    params_np = reference_params(yolo.INPUT_SIZE)
    ds = data.make_detection_dataset(1, seed=5)
    img, boxes, classes = data.detection_batch(ds, 1, device="cpu")
    want = float(jax.jit(jqat.yolo_loss)(
        _jax_tree(params_np), jnp.asarray(img.numpy()),
        jdata.yolo_target(jnp.asarray(boxes.numpy()),
                          jnp.asarray(classes.numpy()))))
    params = convert.params_from_numpy(params_np, device="cpu")
    got = float(yolo_qat.yolo_loss(params, img,
                                   data.yolo_target(boxes, classes)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _record_reference_lsq(monkeypatch) -> list:
    """Makes the reference's QAT forward, jitted or not, append each LSQ
    input (as numpy) to the returned list."""
    inputs, real = [], jyolo.lsq_fake_quant

    def recording(x, step, grad_scale):
        jax.debug.callback(lambda v: inputs.append(np.array(v)), x)
        return real(x, step, grad_scale)

    monkeypatch.setattr(jyolo, "lsq_fake_quant", recording)
    return inputs


@pytest.mark.parametrize("make_step", [yolo_qat.make_eager_step,
                                       yolo_qat.make_yolo_train_step])
def test_train_step_matches_reference(monkeypatch, make_step):
    """Two AdamW steps from converted params, loss and gradient norm per
    step, for the eager body and for the step on fixed tensors that the
    trainer runs (on the CPU it calls that body directly). A float32
    conv summed in another order moves a code across a rounding tie now
    and then, and the flip spreads (at this seed one at
    conv6's input changes 156 of conv11's input codes), and the first
    AdamW update, ±lr wherever a gradient is not tiny, carries the
    difference into every param. So the first step's forward runs with
    the codes that differ forced to the reference's (`train.ties`, each
    checked to sit within 1e-3 of a tie in both), as
    test_calibrate_drift_is_a_rounding_tie does; the second runs free."""
    params_np = reference_params(yolo.INPUT_SIZE)
    ds = data.make_detection_dataset(1, seed=6)
    batches = [data.detection_batch(ds, i, device="cpu") for i in range(2)]

    jopt = jadamw(1e-3)
    jstep = jqat.make_yolo_train_step(jopt)
    jp = _jax_tree(params_np)
    jstate = jopt[0](jp)
    opt = adamw(1e-3)
    step = make_step(opt)
    p = convert.params_from_numpy(params_np, device="cpu")
    state = opt[0](p)
    recorded = _record_reference_lsq(monkeypatch)
    for i, (img, boxes, classes) in enumerate(batches):
        recorded.clear()
        jp, jstate, jm = jstep(jp, jstate, jnp.asarray(img.numpy()),
                               jnp.asarray(boxes.numpy()),
                               jnp.asarray(classes.numpy()))
        assert len(recorded) == 10            # conv2 … conv10 and conv11
        if i == 0:
            with ties.forced([torch.from_numpy(a)
                              for a in recorded]) as counts:
                p, state, m = step(p, state, img, boxes, classes)
            assert len(counts) == 10 and sum(counts) <= 2, counts
        else:
            p, state, m = step(p, state, img, boxes, classes)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert int(m["step"]) == int(jm["step"]) == i + 1
        assert m["loss"].dim() == 0 and m["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------

def test_detection_batch_invariants():
    ds = data.make_detection_dataset(4, seed=11)
    img, boxes, classes = data.detection_batch(ds, 3, device="cpu")
    assert img.shape == (4, 320, 320, 3) and img.dtype == torch.float32
    assert boxes.shape == (4, 4, 4) and boxes.dtype == torch.float32
    assert classes.shape == (4, 4) and classes.dtype == torch.int32
    assert float(img.min()) >= 0 and float(img.max()) <= 1
    assert float(boxes[..., :2].min()) >= 0.15
    assert float(boxes[..., :2].max()) <= 0.85
    assert float(boxes[..., 2:].min()) >= 0.1
    assert float(boxes[..., 2:].max()) <= 0.3
    assert int(classes.min()) >= -1 and int(classes.max()) < 20
    # a pure function of (seed, step, shard)
    again = data.detection_batch(ds, 3, device="cpu")
    for a, b in zip((img, boxes, classes), again):
        assert torch.equal(a, b)
    other = data.detection_batch(ds, 4, device="cpu")
    assert not torch.equal(other[1], boxes) and not torch.equal(other[0], img)
    shard = data.detection_batch(ds, 3, shard=1, num_shards=2, device="cpu")
    assert shard[0].shape[0] == 2 and not torch.equal(shard[1], boxes[:2])
    seeded = data.detection_batch(data.make_detection_dataset(4, seed=12), 3,
                                  device="cpu")
    assert not torch.equal(seeded[1], boxes)
    # each present box carries its class colour at its centre
    n_present = 0
    for b in range(4):
        for j in range(4):
            c = int(classes[b, j])
            if c < 0:
                continue
            n_present += 1
            col = np.clip([c % 5 / 5 + 0.2, c % 7 / 7 + 0.1, c % 3 / 3 + 0.3],
                          0, 1)
            y = int(float(boxes[b, j, 1]) * 320)
            x = int(float(boxes[b, j, 0]) * 320)
            px = img[b, y, x].numpy()
            assert np.all(px >= np.minimum(col, 1) - 1e-6), (b, j, px, col)
    assert n_present > 0
    # background away from every box is noise below 0.15
    assert float(img.min()) < 0.15


# ---------------------------------------------------------------------------
# The paper's offline workflow on the port
# ---------------------------------------------------------------------------

def test_e2e_qat_deploy_verify_detect():
    """QAT train → parameter extraction → integer datapath → Table 6
    alignment → decode + NMS, as the reference's
    test_system::test_e2e_qat_deploy_verify_detect, on the port's own
    batches; the deployed artifact is also the reference's bit for bit."""
    params, ds, record = train_yolo_qat.train(8, 2, seed=0, device="cpu")
    losses = [loss for _, loss in record["loss"]]
    assert np.isfinite(losses).all()
    assert record["held_out_loss_after"] < record["held_out_loss_before"], \
        record

    art = yolo.deploy_yolo(params)
    jart = jyolo.deploy_yolo(_jax_tree(convert.params_to_numpy(params)))
    for ours, theirs in zip(art["layers"], jart["layers"]):
        assert ours["spec"].name == theirs["spec"].name
        for k in INT_FIELDS:
            if k in theirs:
                np.testing.assert_array_equal(
                    ours[k].numpy(), theirs[k],
                    err_msg=f"{theirs['spec'].name}.{k}")

    rep, raw, _ = train_yolo_qat.deploy_and_check(params, ds, "cpu")
    assert rep.corr > 0.99, rep.row()
    assert rep.mean_abs < 0.01, rep.row()
    assert rep.within_1lsb == 1.0, rep.row()
    b, s, c = detection.postprocess(raw, score_thresh=0.05, max_out=8)
    assert b.shape == (2, 8, 4)
    assert bool(torch.all(torch.isfinite(b)))


def test_params_roundtrip_through_numpy():
    params = yolo.init_yolo_params(0, device="cpu")
    back = convert.params_from_numpy(convert.params_to_numpy(params),
                                     device="cpu")
    for name, p in params.items():
        for k, v in p.items():
            assert torch.equal(back[name][k], v)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ds = data.make_detection_dataset(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data.detection_batch(ds, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_yolo_qat.train(1, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_yolo_qat.main(["--steps", "1", "--batch", "1"])


def test_ties_force_only_codes_at_ties():
    """`train.ties` leaves a run that matches alone, and refuses to force
    a code that differs away from a rounding tie."""
    img = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    params = yolo.calibrate_yolo(yolo.init_yolo_params(1, device="cpu"), img)
    with ties.record() as recorded:
        want = yolo.yolo_forward_float(params, img, train=True)
    assert len(recorded) == 10
    with ties.forced(recorded) as counts:
        got = yolo.yolo_forward_float(params, img, train=True)
    assert counts == [0] * 10 and torch.equal(got, want)
    moved = {n: dict(p) for n, p in params.items()}
    moved["conv3"]["act_step"] = params["conv3"]["act_step"] * 1.01
    with pytest.raises(AssertionError, match="away from a rounding tie"):
        with ties.forced(recorded):
            yolo.yolo_forward_float(moved, img, train=True)
    with ties.record("quantize_act") as recorded:
        yolo.yolo_forward_float(params, img)
    assert len(recorded) == 10
    with pytest.raises(ValueError):
        with ties.record("binarize_ste"):
            pass
