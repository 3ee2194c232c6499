"""Port parity, detector: calibrated in the reference at bucket 64 and
carried across with `repro_torch.convert`; the port's packed forward (fused
and unfused pool routes, dot and popcount) and the reference's
interpret-mode Pallas forward must sit in the `core.verify` envelope
(max_abs < 0.02, 100% within 1 LSB of 0.02) of each other and of the
reference's float forward."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fixedpoint as jfxp  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import verify as jverify  # noqa: E402
from repro.models import yolo as jyolo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core import verify  # noqa: E402
from repro_torch.models import yolo  # noqa: E402

BUCKET = 64


def _in_envelope(name, got, want):
    rep = verify.compare(name, got, want, lsb=0.02)
    assert rep.max_abs < 0.02 and rep.within_1lsb == 1.0, rep.row()


def _to_numpy(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def reference():
    rng = np.random.default_rng(0)
    img = (rng.integers(0, 256, (2, BUCKET, BUCKET, 3), dtype=np.uint8)
           .astype(np.float32) / 256.0)
    init = jyolo.init_yolo_params(jax.random.PRNGKey(42))
    params = jyolo.calibrate_yolo(init, jnp.asarray(img))
    art = jyolo.deploy_yolo_kernel(params)
    art_np = {"layers": [{k: (v if k == "spec" else np.asarray(v))
                          for k, v in e.items()} for e in art["layers"]]}
    return {
        "img": img,
        "init_np": {n: _to_numpy(p) for n, p in init.items()},
        "params_np": {n: _to_numpy(p) for n, p in params.items()},
        "art_np": art_np,
        "raw_kernel": np.asarray(jyolo.yolo_forward_kernel(
            art, jnp.asarray(img), profile="interpret")),
        "raw_float": np.asarray(jyolo.yolo_forward_float(
            params, jnp.asarray(img))),
    }


@pytest.mark.parametrize("fuse_pool", [True, False])
def test_kernel_path_in_envelope(reference, fuse_pool):
    art = convert.artifact_from_numpy(reference["art_np"], device="cpu")
    img = torch.from_numpy(reference["img"])
    raw = yolo.yolo_forward_kernel(art, img, fuse_pool=fuse_pool).numpy()
    assert raw.shape == (2, BUCKET // 32, BUCKET // 32, 75)
    _in_envelope("port_vs_pallas", raw, reference["raw_kernel"])
    _in_envelope("port_vs_float", raw, reference["raw_float"])
    params = convert.params_from_numpy(reference["params_np"], device="cpu")
    port_float = yolo.yolo_forward_float(params, img).numpy()
    _in_envelope("port_float_vs_float", port_float, reference["raw_float"])
    _in_envelope("port_vs_port_float", raw, port_float)
    rep = jverify.compare("pallas_vs_float", reference["raw_kernel"],
                          reference["raw_float"], lsb=0.02)
    assert rep.max_abs < 0.02 and rep.within_1lsb == 1.0


def test_fused_and_unfused_routes_bit_exact(reference):
    art = convert.artifact_from_numpy(reference["art_np"], device="cpu")
    img = torch.from_numpy(reference["img"])
    assert torch.equal(yolo.yolo_forward_kernel(art, img, profile="tuned"),
                       yolo.yolo_forward_kernel(art, img, profile="default"))


def test_convert_paths_agree(reference):
    """Deploying converted params in the port and converting the reference's
    artifact give the same sign words and steps, and the same detector."""
    params = convert.params_from_numpy(reference["params_np"], device="cpu")
    ours = yolo.deploy_yolo_kernel(params)
    theirs = convert.artifact_from_numpy(reference["art_np"], device="cpu")
    for a, b in zip(ours["layers"], theirs["layers"]):
        assert a["spec"] == b["spec"] and a.keys() == b.keys()
        for key in a:
            if key == "spec":
                continue
            if key in ("alpha", "div_eff"):  # a mean: summation order differs
                torch.testing.assert_close(a[key], b[key], rtol=1e-6, atol=0)
            else:
                assert torch.equal(a[key], b[key]), (a["spec"].name, key)
    img = torch.from_numpy(reference["img"])
    _in_envelope("deploy_vs_convert", yolo.yolo_forward_kernel(ours, img),
                 yolo.yolo_forward_kernel(theirs, img))


# Every layer's step matches at 1e-5 except downstream of a code that the
# two frameworks' float32 convs round to opposite sides of a tie. Under the
# suite's XLA flags (tests/conftest.py) one code at conv6's input has
# x/step = 195.49998 in the reference and 195.50015 here; the flipped code
# moves later layers' maxima. The limits for conv7–conv9 sit just above
# what that reads (3.21e-4, 9.03e-4, 4.94e-4);
# test_calibrate_drift_is_a_rounding_tie shows the cause.
STEP_RTOL = {"conv7": 4e-4, "conv8": 1.1e-3, "conv9": 6e-4}


def test_calibrate_steps_match_reference(reference):
    init = convert.params_from_numpy(reference["init_np"], device="cpu")
    ours = yolo.calibrate_yolo(init, torch.from_numpy(reference["img"]))
    for name, p in reference["params_np"].items():
        if "act_step" in p:
            np.testing.assert_allclose(
                ours[name]["act_step"].numpy(), p["act_step"], atol=0,
                rtol=STEP_RTOL.get(name, 1e-5), err_msg=name)
    assert "act_step" not in init["conv1"]


def _jax_layer(spec, p, xq):
    """One eval float layer of the reference, as its yolo_forward_float."""
    if spec.name == "conv1":
        x = jax.nn.relu(jyolo._conv2d(xq, jfxp.CONV1_W.roundtrip(p["w"]))
                        + jfxp.CONV1_B.roundtrip(p["b"]))
    elif spec.name == "conv11":
        x = (jyolo._conv2d(xq, jfxp.CONV11_W.roundtrip(p["w"]))
             + jfxp.CONV11_B.roundtrip(p["b"]))
    else:
        alpha = jnp.mean(jnp.abs(p["w"]), axis=(0, 1, 2))
        x = jax.nn.relu(jyolo._conv2d(xq, jquant.binarize_weight(p["w"]))
                        * alpha + p["b"])
    return jyolo._maxpool2(x) if spec.pool else x


def _port_layer(spec, p, xq):
    if spec.name == "conv1":
        x = yolo._conv1(p, xq)
    elif spec.name == "conv11":
        x = yolo._conv11(p, xq)
    else:
        alpha = torch.mean(torch.abs(p["w"]), dim=(0, 1, 2))
        x = torch.relu(yolo._conv2d(xq, quant.binarize_weight(p["w"]))
                       * alpha + p["b"])
    return yolo._maxpool2(x) if spec.pool else x


def _calibrate_side_by_side(reference, force: bool) -> dict:
    """Both calibrations layer by layer on the same init. With ``force``,
    every code the port rounds differently is set to the reference's, after
    checking that it sits within 1e-3 of a rounding tie in both. Returns
    {layer: (reference step, port step, codes forced)}."""
    init_np = reference["init_np"]
    init_t = convert.params_from_numpy(init_np, device="cpu")
    jx, tx = jnp.asarray(reference["img"]), torch.from_numpy(reference["img"])
    out = {}
    for spec in yolo.YOLO_LAYERS:
        if spec.name == "conv1":
            jx = _jax_layer(spec, init_np[spec.name], jx)
            tx = _port_layer(spec, init_t[spec.name], tx)
            continue
        js = jnp.maximum(jnp.max(jnp.abs(jx), axis=(0, 1, 2)) / 255, 1e-4)
        ts = torch.clamp(torch.amax(torch.abs(tx), dim=(0, 1, 2)) / 255,
                         min=1e-4)
        jc = np.asarray(jquant.quantize_act(jx, js))
        tc = quant.quantize_act(tx, ts).numpy()
        flipped = jc != tc
        if force and flipped.any():
            for frac in (np.asarray(jx) / np.asarray(js),
                         tx.numpy() / ts.numpy()):
                tie = np.abs(frac[flipped] % 1.0 - 0.5)
                assert tie.max() < 1e-3, (spec.name, tie)
            tc = jc
        out[spec.name] = (np.asarray(js), ts.numpy(),
                          int(flipped.sum()) if force else 0)
        jx = _jax_layer(spec, init_np[spec.name], jc * js)
        tx = _port_layer(spec, init_t[spec.name],
                         torch.from_numpy(tc.copy()) * ts)
    return out


def test_calibrate_drift_is_a_rounding_tie(reference):
    """The side-by-side loop reproduces both calibrate_yolo functions
    exactly; once the codes that round across a tie are forced to the
    reference's, every layer's step matches at 1e-5."""
    free = _calibrate_side_by_side(reference, force=False)
    init = convert.params_from_numpy(reference["init_np"], device="cpu")
    ours = yolo.calibrate_yolo(init, torch.from_numpy(reference["img"]))
    for name, (js, ts, _) in free.items():
        np.testing.assert_array_equal(js, reference["params_np"][name]
                                      ["act_step"], err_msg=name)
        np.testing.assert_array_equal(ts, ours[name]["act_step"].numpy(),
                                      err_msg=name)
    forced = _calibrate_side_by_side(reference, force=True)
    for name, (js, ts, _) in forced.items():
        np.testing.assert_allclose(ts, js, atol=0, rtol=1e-5, err_msg=name)
    assert sum(n for _, _, n in forced.values()) <= 2, forced


def test_model_structure():
    assert yolo.count_params()["weights"] == 736880
    assert yolo.count_params() == jyolo.count_params()
    assert yolo.count_gflops() == jyolo.count_gflops()
    assert yolo.spatial_sizes(256) == jyolo.spatial_sizes(256)
    with pytest.raises(ValueError):
        yolo.spatial_sizes(100)
    params = yolo.init_yolo_params(0, device="cpu")
    assert params["conv5"]["w"].shape == (3, 3, 128, 128)
    assert params["conv11"]["act_step"].shape == (64,)


@pytest.fixture(scope="module")
def popcount_reference(reference):
    """The reference's popcount forward, once per pool route, on the
    per-channel artifact of `reference`."""
    jart = jyolo.deploy_yolo_kernel(
        {n: {k: jnp.asarray(v) for k, v in p.items()}
         for n, p in reference["params_np"].items()})
    return {fuse: np.asarray(jyolo.yolo_forward_kernel(
        jart, jnp.asarray(reference["img"]), profile="interpret",
        accum="popcount", fuse_pool=fuse)) for fuse in (True, False)}


@pytest.fixture(scope="module")
def popcount_port(reference):
    art = convert.artifact_from_numpy(reference["art_np"], device="cpu")
    img = torch.from_numpy(reference["img"])
    return {fuse: yolo.yolo_forward_kernel(art, img, accum="popcount",
                                           fuse_pool=fuse)
            for fuse in (True, False)}


@pytest.mark.parametrize("fuse_pool", [True, False])
def test_popcount_forward_in_envelope(reference, popcount_reference,
                                      popcount_port, fuse_pool):
    """The binary-domain forward on a per-channel artifact (producer-side
    step fold) sits in the envelope of the float forward and of the
    reference's popcount forward."""
    raw = popcount_port[fuse_pool].numpy()
    assert raw.shape == (2, BUCKET // 32, BUCKET // 32, 75)
    _in_envelope("popcount_vs_float", raw, reference["raw_float"])
    _in_envelope("popcount_vs_pallas_popcount", raw,
                 popcount_reference[fuse_pool])


def test_popcount_routes_bit_exact(popcount_port):
    assert torch.equal(popcount_port[True], popcount_port[False])


def test_popcount_folds_boundaries_once(reference):
    """Popcount consumers get uniform boundary steps, conv10 keeps its
    per-channel one; the dot configs keep the deployed constants; each
    configs tuple is folded once."""
    art = convert.artifact_from_numpy(reference["art_np"], device="cpu")
    dot = yolo.kernel_configs(art, BUCKET, 2, accum="dot")
    pc = yolo.kernel_configs(art, BUCKET, 2, accum="popcount")
    f_dot, f_pc = art["folded"][dot], art["folded"][pc]
    assert yolo.fold_boundaries(art, pc) is f_pc
    layers = art["layers"]
    assert f_dot["step1"] is layers[0]["step_out"]
    for entry, (div, bias, step) in zip(layers[1:-1], f_dot["layers"]):
        assert div is entry["div_eff"] and bias is entry["b_eff"]
        assert step is entry["step_out"]
    steps = [f_pc["step1"]] + [s for _, _, s in f_pc["layers"]]
    for step, entry in zip(steps[:-1], layers[:-2]):
        assert torch.equal(step, torch.full_like(step, float(step.max())))
        assert float(step.max()) == float(entry["step_out"].max())
    assert steps[-1] is layers[-2]["step_out"]
    assert any(len(torch.unique(e["step_out"])) > 1 for e in layers[:-2])


def test_popcount_per_tensor_artifact_matches_dot(reference):
    """On a per-tensor artifact the popcount forward differs from the dot
    forward only by the dot path's bf16 prologue rounding (the reference's
    test_kernel_path_popcount_alignment), and sits in the float envelope."""
    params = convert.params_from_numpy(reference["params_np"], device="cpu")
    img = torch.from_numpy(reference["img"])
    pt = yolo.calibrate_yolo(params, img, per_channel=False)
    art = yolo.deploy_yolo_kernel(pt)
    pc = yolo.yolo_forward_kernel(art, img, accum="popcount").numpy()
    dot = yolo.yolo_forward_kernel(art, img, accum="dot").numpy()
    assert np.abs(pc - dot).max() < 0.02
    _in_envelope("per_tensor_popcount_vs_float", pc,
                 yolo.yolo_forward_float(pt, img).numpy())
