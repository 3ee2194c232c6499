"""The detector's QAT step on fixed tensors (`train.yolo_qat.qat_step`,
`make_yolo_train_step`) against its eager body (`make_eager_step`), and
the launch accounting of its graph replays (CPU, B = 1 and 2, 320×320:
`yolo_loss` needs the 10×10 head).

Tolerances: none. The fixed-tensor step runs the eager body's ops in the
same order and copies each result into a tensor of its own, so every
param, moment, ``step``, loss and gradient norm is held bit for bit. The
reference's step is jitted; the port's on the card is one CUDA graph
replay of this step, held against the eager body on the card by
`chip_smoke.py` phase 9b, and against the reference's jitted step by
`tests/test_torch_qat.py::test_train_step_matches_reference`.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import yolo  # noqa: E402
from repro_torch.optim import adamw, tree_map  # noqa: E402
from repro_torch.optim.optimizers import tree_items  # noqa: E402
from repro_torch.train import yolo_qat  # noqa: E402

STEPS, LR = 3, 1e-3
_CACHE = {}


def _setup(batch: int):
    """Calibrated params and STEPS batches at ``batch``, seeded."""
    if batch not in _CACHE:
        ds = data.make_detection_dataset(batch, seed=5)
        batches = [data.detection_batch(ds, i, device="cpu")
                   for i in range(STEPS)]
        with torch.no_grad():
            params = yolo.calibrate_yolo(
                yolo.init_yolo_params(2, device="cpu"), batches[0][0])
        _CACHE[batch] = params, batches
    return _CACHE[batch]


def _snapshot(tree):
    return tree_map(torch.clone, tree)


def _eager(batch: int):
    """The eager body's STEPS steps: (params, state, metrics) after each,
    cloned."""
    key = ("eager", batch)
    if key not in _CACHE:
        params, batches = _setup(batch)
        opt = adamw(LR)
        body = yolo_qat.make_eager_step(opt)
        p, s, out = params, opt[0](params), []
        for b in batches:
            p, s, m = body(p, s, *b)
            out.append(_snapshot((p, s, m)))
        _CACHE[key] = out
    return _CACHE[key]


def _assert_equal(got, want, what):
    for (path, g), (_, w) in zip(tree_items(got), tree_items(want)):
        assert g.dtype == w.dtype and torch.equal(g, w), f"{what} {path}"


@pytest.mark.parametrize("batch", [1, 2])
def test_fixed_step_equals_the_eager_body(batch):
    """Three steps: params, mu, nu, step, loss and grad norm bit for bit;
    the caller's first params and state never written."""
    params, batches = _setup(batch)
    opt = adamw(LR)
    step = yolo_qat.make_yolo_train_step(opt)
    p, s = params, opt[0](params)
    first = _snapshot((p, s))
    for i, b in enumerate(batches):
        p, s, m = step(p, s, *b)
        want_p, want_s, want_m = _eager(batch)[i]
        _assert_equal(p, want_p, f"step {i} params")
        _assert_equal(s, want_s, f"step {i} state")
        _assert_equal(m, want_m, f"step {i} metrics")
        assert int(m["step"]) == i + 1
    _assert_equal((params, opt[0](params)), first, "the caller's first")
    assert step.graph is None and step.device.type == "cpu"


def test_storage_kept_and_metrics_not_overwritten():
    """The step's tensors keep their addresses across steps (a captured
    graph reads those), it returns them as the params and state, and the
    metrics of step i are not changed by step i + 1."""
    params, batches = _setup(1)
    opt = adamw(LR)
    step = yolo_qat.make_yolo_train_step(opt)
    p, s, m0 = step(params, opt[0](params), *batches[0])
    fixed = step.fixed
    assert p is fixed["params"] and s is fixed["state"]
    ptrs = [t.data_ptr() for _, t in tree_items(fixed)]
    kept = _snapshot(m0)
    for b in batches[1:]:
        p, s, m = step(p, s, *b)
        assert step.fixed is fixed
        assert [t.data_ptr() for _, t in tree_items(fixed)] == ptrs
        _assert_equal(m0, kept, "step 0's metrics")
    assert int(m0["step"]) == 1 and int(m["step"]) == STEPS


def test_params_passed_in_are_copied_in():
    """Params and state that are not the step's own are copied into its
    tensors (the caller's left as they were); a new batch size makes new
    tensors. Each step equals the eager body's from the same inputs."""
    params, batches = _setup(2)
    opt = adamw(LR)
    step = yolo_qat.make_yolo_train_step(opt)
    step(params, opt[0](params), *batches[0])
    fixed = step.fixed
    # the caller's own params and state, not the step's tensors, and not
    # what they hold after step 1: the first ones again
    p_own, s_own = _snapshot((params, opt[0](params)))
    keep = _snapshot((p_own, s_own))
    p2, s2, m2 = step(p_own, s_own, *batches[1])
    assert step.fixed is fixed and p2 is fixed["params"]
    want = yolo_qat.make_eager_step(opt)(*_snapshot((params, opt[0](params))),
                                         *batches[1])
    _assert_equal((p2, s2, m2), want, "copied in")
    assert int(m2["step"]) == 1
    _assert_equal((p_own, s_own), keep, "the caller's copy")
    # B = 1: new fixed tensors, the batch-2 step's params copied from
    one = _setup(1)[1][0]
    b1 = yolo_qat.make_eager_step(opt)
    want = b1(*_snapshot((p2, s2)), *one)
    got = step(p2, s2, *one)
    assert step.fixed is not fixed
    assert step.fixed["batch"][0].shape[0] == 1
    _assert_equal(got, want, "a new batch size")


@pytest.fixture
def stub_kernels():
    """Two kernels whose launches run nothing and report no error (as in
    tests/test_torch_lm_tick.py)."""
    kernels = [_build.Kernel("stub.cu", name, []) for name in ("a", "b")]
    for k in kernels:
        k._fn = lambda *args: 0
    yield kernels
    for k in kernels:
        _build.KERNELS.remove(k)


class _StandIn:
    """A graph whose replay runs the step it was captured over, eagerly."""

    def __init__(self, run):
        self.replay = run


def test_replays_add_the_captured_launches(stub_kernels, monkeypatch):
    """The card's path, driven on the CPU (``device`` set to cuda after the
    first step, a stand-in graph in place of the capture): one capture,
    then one replay a step, which credits the launches its capture
    recorded and nothing of the warm steps; the steps equal the eager
    body's. The real step launches no kernel of the port (its convs are
    cuDNN's), so its capture records none."""
    a, b = stub_kernels
    captured = []

    def capture(body, fixed):
        captured.append(fixed)
        a()                                   # a warm step: not counted
        with _build.capturing() as launches:
            a()
            b()
        return _build.Graph(_StandIn(lambda: yolo_qat.qat_step(body, fixed)),
                            launches)
    monkeypatch.setattr(yolo_qat, "capture_qat_step", capture)
    params, batches = _setup(1)
    opt = adamw(LR)
    step = yolo_qat.make_yolo_train_step(opt)
    p, s, m = step(params, opt[0](params), *batches[0])
    step.device = torch.device("cuda")
    for i, batch in enumerate(batches[1:], 1):
        p, s, m = step(p, s, *batch)
        _assert_equal((p, s, m), _eager(1)[i], f"replay {i}")
    assert len(captured) == 1 and captured[0] is step.fixed
    replays = STEPS - 1
    assert dict(step.graph.launches.counts) == {a: 1, b: 1}
    assert (a.launches, b.launches) == (1 + replays, replays)
    with _build.capturing() as launches:
        yolo_qat.qat_step(step.body, _snapshot(step.fixed))
    assert not launches.counts


def test_failed_capture_raises(monkeypatch):
    """No fallback: a capture that fails raises out of the step, which
    then has run nothing."""
    def capture(*args, **kwargs):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    monkeypatch.setattr(yolo_qat, "capture_qat_step", capture)
    params, batches = _setup(1)
    opt = adamw(LR)
    step = yolo_qat.make_yolo_train_step(opt)
    p, s, _ = step(params, opt[0](params), *batches[0])
    step.device = torch.device("cuda")
    before = _snapshot((p, s))
    with pytest.raises(RuntimeError, match="capturing"):
        step(p, s, *batches[1])
    assert step.graph is None
    _assert_equal((p, s), before, "after a failed capture")
