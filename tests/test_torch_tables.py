"""Port parity, the paper's tables: Tables 2 and 5 row for row with the
reference's ``benchmarks/memory_table.py`` and ``benchmarks/complexity.py``
(and the runner's CSV with ``benchmarks/run.py``'s), and Table 6 on one
converted artifact and one image at 64 px: the integer rows equal, the
correlations within 1e-5 (the float forwards sum float32 convs in another
order)."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:           # benchmarks/ has no __init__.py
    sys.path.insert(0, str(ROOT))

from benchmarks import alignment as jalignment  # noqa: E402
from benchmarks import complexity as jcomplexity  # noqa: E402
from benchmarks import memory_table as jmemory  # noqa: E402
from benchmarks import run as jrun  # noqa: E402
from repro.models import yolo as jyolo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import alignment, tables  # noqa: E402
from repro_torch.train import ties  # noqa: E402

SIZE = 64


def test_table2_rows_equal_reference():
    assert tables.memory() == jmemory.run()


def test_table5_rows_equal_reference():
    assert tables.complexity() == jcomplexity.run()


@pytest.mark.parametrize("suite", ["memory", "complexity"])
def test_runner_csv_equals_reference(suite, capsys, monkeypatch):
    assert tables.main(["--only", suite]) == 0
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["run", "--only", suite])
    jrun.main()
    assert ours == capsys.readouterr().out
    assert ours.startswith("name,value,notes\n") and ours.count("\n") > 4


def test_runner_reports_a_failing_suite(capsys, monkeypatch):
    def boom():
        raise RuntimeError("no")
    monkeypatch.setattr(tables, "memory", boom)
    assert tables.main(["--only", "memory"]) == 1
    assert "memory.ERROR,RuntimeError" in capsys.readouterr().out


def test_table6_equal_across_packages(monkeypatch):
    """The reference's `run(trained_params=)` draws its 320 px image from
    jax.random; the draw is replaced by the test's 64 px image, and both
    packages get the same converted params. A float32 conv summed in
    another order moves a code across a rounding tie (at this seed one at
    conv3's input, which spreads to conv11's) and the float head with it,
    so the port's float forward runs with those codes forced to the
    reference's (`train.ties`, each within 1e-3 of a tie in both), as
    test_calibrate_drift_is_a_rounding_tie does."""
    rng = np.random.default_rng(7)
    img_u8 = rng.integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)
    params = jyolo.calibrate_yolo(
        jyolo.init_yolo_params(jax.random.PRNGKey(42)),
        jnp.asarray(img_u8.astype(np.float32) / 256.0))
    params_np = {n: {k: np.asarray(v) for k, v in p.items()}
                 for n, p in params.items()}

    def image_draw(key, shape, lo, hi, dtype):
        assert shape == (1, 320, 320, 3)
        return jnp.asarray(img_u8, dtype)

    recorded, quantize = [], jyolo.quantize_act

    def recording(x, step):
        recorded.append(np.array(x))
        return quantize(x, step)

    monkeypatch.setattr(jalignment.jax.random, "randint", image_draw)
    monkeypatch.setattr(jyolo, "quantize_act", recording)
    want = jalignment.run(trained_params=params)
    monkeypatch.undo()
    assert len(recorded) == 10      # the float forward: conv2 … conv11
    with ties.forced(recorded, "quantize_act") as counts:
        got = alignment.run(device="cpu", image_u8=img_u8,
                            trained_params=convert.params_from_numpy(
                                params_np, device="cpu"))
    assert len(counts) == 10 and sum(counts) <= 2, counts
    assert [r[0] for r in got] == [r[0] for r in want]
    rows = {name: (ours, theirs) for (name, ours, _), (_, theirs, _)
            in zip(got, want)}
    ours, theirs = rows["align.conv1_post.within_1lsb"]
    assert round(ours, 4) == theirs
    for name in ("align.conv1_raw.corr", "align.final_raw.corr",
                 "align.final_raw_kernel.corr"):
        ours, theirs = rows[name]
        assert abs(ours - theirs) <= 1e-5, (name, ours, theirs)
    # the int head against the float head is in the envelope
    note = dict((r[0], r[2]) for r in got)["align.final_raw.corr"]
    assert "within_1lsb=100.0000%" in note


def test_table6_trained_params_are_not_recalibrated():
    rng = np.random.default_rng(8)
    img_u8 = rng.integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)
    from repro_torch.models import yolo
    params = yolo.init_yolo_params(3, device="cpu")
    rows = alignment.run(device="cpu", image_u8=img_u8,
                         trained_params=params)
    assert params["conv2"]["act_step"][0] == 0.05      # untouched
    default = alignment.run(seed=3, device="cpu", image_u8=img_u8)
    assert [r[0] for r in rows] == [r[0] for r in default]
    assert rows != default
