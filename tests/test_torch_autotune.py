"""Port parity, autotune: `kernels.config` resolution (exact → nearest →
heuristic, with ``source``), `launch.autotune`'s candidates, winners and
roofline, `models.yolo`'s autotune cells and tuned configs against the
reference under one hand-written table, the committed table, and the
launcher's workloads on the CPU."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import config as jkc  # noqa: E402
from repro.kernels.w1a8_conv import ops as jconv  # noqa: E402
from repro.kernels.w1a8_matmul import ops as jmm  # noqa: E402
from repro.launch import autotune as jautotune  # noqa: E402
from repro.models import yolo as jyolo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import verify  # noqa: E402
from repro_torch.kernels import config as kc  # noqa: E402
from repro_torch.launch import autotune  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import yolo  # noqa: E402
from repro_torch.serve import DetectionBackend  # noqa: E402

PACKAGES = {"reference": (jkc, jkc.KernelConfig),
            "port": (kc, kc.KernelConfig)}
DEV = "cpu"          # the device key both packages give on the CPU


def _fields(cfg) -> tuple:
    return cfg.accum, cfg.rows, cfg.fused, cfg.source


def _entry(cls, op, t_us=None, **kw) -> dict:
    rec = {"config": cls(op=op, out_step=1.0, **kw).to_dict()}
    if t_us is not None:
        rec["t_us"] = t_us
    return rec


# ---------------------------------------------------------------------------
# Resolution, mirrored from the reference's tests/test_kernel_config.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_config_source_excluded_and_round_trips(pkg):
    _, cls = PACKAGES[pkg]
    a = cls(op="conv3x3", rows=4, source="table")
    b = cls(op="conv3x3", rows=4, source="heuristic")
    assert a == b and hash(a) == hash(b)
    assert cls.from_dict(a.to_dict()) == a
    assert cls.from_dict(a.to_dict()).source == "table"
    assert cls().source == "manual"


def test_resolve_exact_nearest_heuristic():
    got = {}
    for pkg, (mod, cls) in PACKAGES.items():
        table = {mod.shape_key("conv3x3", (8, 8, 8, 16), "dot", DEV):
                 _entry(cls, "conv3x3", 10.0, rows=4)}
        got[pkg] = [_fields(mod.resolve(op, dims, accum="dot", device=DEV,
                                        table=table))
                    for op, dims in (("conv3x3", (8, 8, 8, 16)),
                                     ("conv3x3", (10, 10, 8, 16)),
                                     ("matmul", (100, 128, 64)))]
    assert got["port"] == got["reference"] == [
        ("dot", 4, True, "table"), ("dot", 4, True, "nearest"),
        ("dot", 1, True, "heuristic")]


def test_resolve_nearest_is_deterministic_on_ties():
    got = {}
    for pkg, (mod, cls) in PACKAGES.items():
        # two entries equidistant from the query: the smaller key wins
        table = {mod.shape_key("conv3x3", (8, 8, 8, 16), "dot", DEV):
                 _entry(cls, "conv3x3", rows=2),
                 mod.shape_key("conv3x3", (32, 32, 8, 16), "dot", DEV):
                 _entry(cls, "conv3x3", rows=8)}
        got[pkg] = [mod.resolve("conv3x3", (16, 16, 8, 16), device=DEV,
                                table=dict(order)).rows
                    for order in (table.items(), reversed(table.items()))]
    want = min(("conv3x3/8x8x8x16/dot/cpu", 2),
               ("conv3x3/32x32x8x16/dot/cpu", 8))[1]
    assert got["port"] == got["reference"] == [want, want]


def test_resolve_tuned_picks_fastest_accum():
    got = {}
    dims = (8, 8, 8, 16)
    for pkg, (mod, cls) in PACKAGES.items():
        table = {mod.shape_key("conv3x3", dims, "dot", DEV):
                 _entry(cls, "conv3x3", 20.0, rows=2),
                 mod.shape_key("conv3x3", dims, "popcount", DEV):
                 _entry(cls, "conv3x3", 10.0, accum="popcount", rows=4)}
        got[pkg] = [_fields(mod.resolve_tuned("conv3x3", dims, device=DEV,
                                              table=table,
                                              allow_popcount=allow))
                    for allow in (True, False)]
        # no exact timed entry: dot, resolved nearest
        got[pkg].append(_fields(mod.resolve_tuned(
            "conv3x3", (16, 16, 8, 16), device=DEV, table=table)))
    assert got["port"] == got["reference"] == [
        ("popcount", 4, True, "table"), ("dot", 2, True, "table"),
        ("dot", 2, True, "nearest")]


def test_table_env_override_and_missing_file(tmp_path, monkeypatch):
    missing = str(tmp_path / "nope.json")
    monkeypatch.setenv("REPRO_AUTOTUNE_TABLE", missing)
    monkeypatch.setenv(kc.TABLE_ENV, missing)
    for mod, _ in PACKAGES.values():
        mod.clear_table_cache()
        assert mod.load_table() == {}
        assert mod.resolve("conv3x3", (8, 8, 8, 16)).source == "heuristic"
    assert kc.table_path() == pathlib.Path(missing)
    (tmp_path / "bad.json").write_text("{not json")
    assert kc.load_table(tmp_path / "bad.json") == {}
    for mod, _ in PACKAGES.values():
        mod.clear_table_cache()


def test_select_winner_tie_breaks_on_canonical_key():
    for mod, at in ((jkc, jautotune), (kc, autotune)):
        a = mod.KernelConfig(op="conv3x3", rows=4)
        b = mod.KernelConfig(op="conv3x3", rows=2)
        w1 = at.select_winner([(5.0, a), (5.0, b)])
        w2 = at.select_winner([(5.0, b), (5.0, a)])
        assert w1 == w2
        assert w1[1] == min((a, b), key=lambda c: json.dumps(
            c.to_dict(), sort_keys=True))
        assert at.select_winner([(4.0, a), (5.0, b)])[1] == a


@pytest.mark.parametrize("op", ["conv3x3", "conv3x3_pool"])
@pytest.mark.parametrize("accum", ["dot", "popcount"])
def test_sweep_persist_load_roundtrip(tmp_path, op, accum):
    """sweep → persist → load → resolve gives the winner back, on the CPU
    at (8, 8, 8, 16), as the reference's test does."""
    dims = (8, 8, 8, 16)
    entry = autotune.sweep_cell(op, dims, accum, batch=2, iters=1,
                                device="cpu")
    assert entry["candidates_tried"] == len(autotune.candidates(
        op, dims, accum)) and entry["skipped"] == []
    key = kc.shape_key(op, dims, accum, DEV)
    path = tmp_path / "AUTOTUNE_cuda.json"
    autotune.write_json(path, {"version": 1, "device": DEV, "card": "cpu",
                               "batch": 2}, {key: entry})
    loaded = kc.resolve(op, dims, accum=accum, device=DEV,
                        table=kc.load_table(path))
    assert loaded == kc.KernelConfig.from_dict(entry["config"])
    assert loaded.source == "table" and loaded.accum == accum
    bench = autotune.bench_cell(op, dims, accum, entry, batch=2, iters=1,
                                device="cpu")
    assert bench["t_us"] > 0 and bench["roofline_frac"] > 0


# ---------------------------------------------------------------------------
# Every candidate bit-exact (kernel test shapes), and against the reference
# ---------------------------------------------------------------------------

def _reference_default(op, operands, accum):
    """The reference's default config on the same operands, as numpy."""
    ops = {k: np.asarray(v) if isinstance(v, torch.Tensor) else v
           for k, v in operands.items()}
    fn = {"matmul": jmm.w1a8_matmul, "conv3x3": jconv.w1a8_conv3x3,
          "conv3x3_pool": jconv.w1a8_conv3x3_pool}[op]
    cfg = jkc.KernelConfig(op=op, accum=accum, out_step=1.0, interpret=True)
    wp = ops["wp"].view(np.uint32)
    return np.asarray(fn(jnp.asarray(ops["a"]), jnp.asarray(wp),
                         jnp.asarray(ops["mul"]), jnp.asarray(ops["div"]),
                         jnp.asarray(ops["bias"]), config=cfg, **ops["kw"]))


def _held(op, dims, batch):
    """Every candidate of both modes equals its mode's default bit for
    bit; the default equals the reference's (popcount exactly, dot within
    one code: the reference's oracle skips the bf16 prologue rounding)."""
    operands = autotune._operands(op, dims, batch, "cpu", seed=3)
    for accum in ("dot", "popcount"):
        cands = autotune.candidates(op, dims, accum)
        assert cands[0] == kc.KernelConfig(op=op, accum=accum, out_step=1.0)
        ref = autotune._call(op, operands, cands[0])
        assert ref.dtype == torch.uint8
        for cfg in cands[1:]:
            assert torch.equal(autotune._call(op, operands, cfg), ref), cfg
        want = _reference_default(op, operands, accum)
        diff = np.abs(ref.numpy().astype(int) - want.astype(int)).max()
        assert diff <= (1 if accum == "dot" else 0), (accum, diff)


@pytest.mark.parametrize("m,k,n", [(5, 70, 12), (16, 64, 128),
                                   (257, 96, 130)])
def test_matmul_candidates_bit_exact(m, k, n):
    assert len(autotune.candidates("matmul", (m, k, n), "dot")) == 1
    _held("matmul", (m, k, n), 1)


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 8, 8, 16, 32),
                                            (1, 10, 10, 64, 75),
                                            (3, 6, 10, 24, 40)])
def test_conv_candidates_bit_exact(b, h, w, cin, cout):
    _held("conv3x3", (h, w, cin, cout), b)


def test_pool_candidates_bit_exact():
    cands = autotune.candidates("conv3x3_pool", (8, 8, 16, 32), "popcount")
    assert {c.fused for c in cands} == {True, False}
    assert [c.rows for c in cands if not c.fused] == [1, 2, 4]
    _held("conv3x3_pool", (8, 8, 16, 32), 2)


def test_launch_error_skips_what_does_not_fit():
    """The dot fused kernel at conv2's cell cannot stage 16 pooled rows in
    a block's shared memory: the sweep records it instead of failing."""
    dims = (160, 160, 16, 32)
    cfg = kc.KernelConfig(op="conv3x3_pool", rows=16)
    assert "shared memory" in autotune.launch_error("conv3x3_pool", dims, 4,
                                                    cfg)
    assert autotune.launch_error("conv3x3_pool", dims, 4,
                                 cfg.replace(accum="popcount")) is None
    assert autotune.launch_error("conv3x3_pool", dims, 4,
                                 cfg.replace(fused=False)) is None


def test_roofline_h100_peaks():
    r = autotune.roofline("matmul", (400, 128, 64), "dot")
    assert r["ops"] == 2 * 400 * 128 * 64
    assert r["bytes"] == 400 * 128 + 4 * 4 * 64 + 4 * (128 + 128) + 400 * 64
    assert r["bound"] == "bytes"
    assert r["t_model_us_h100"] == pytest.approx(1e6 * r["bytes"] / 3.35e12)
    rd = autotune.roofline("conv3x3", (40, 40, 64, 128), "dot", batch=4)
    rp = autotune.roofline("conv3x3", (40, 40, 64, 128), "popcount", batch=4)
    assert rd["bound"] == rp["bound"] == "operations"
    assert rd["t_model_us_h100"] == pytest.approx(1e6 * rd["ops"] / 989e12)
    assert rp["t_model_us_h100"] == pytest.approx(1e6 * rp["ops"] / 1979e12)
    pool = autotune.roofline("conv3x3_pool", (40, 40, 64, 128), "dot",
                             batch=4)
    assert pool["bytes"] < rd["bytes"]     # the pooled output is a quarter


# ---------------------------------------------------------------------------
# The detector: cells, mixed-table configs, forward, steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 4])
def test_yolo_layer_cells_match_reference(batch):
    assert yolo.yolo_layer_cells(batch) == jyolo.yolo_layer_cells(batch)
    assert autotune.yolo_cells(batch) == jautotune.yolo_cells(batch)
    assert len(autotune.yolo_cells(batch)) == 11


# One table keyed "cpu" for both packages: some cells popcount, some dot,
# the first pool cell's popcount entry unfused; timed at B = 2.
MIXED = [  # (op, dims, dot (t_us, rows, fused), popcount (t_us, rows, fused))
    ("conv3x3_pool", (160, 160, 16, 32), (10.0, 2, True), (5.0, 2, False)),
    ("conv3x3", (160, 160, 16, 32), (9.0, 4, True), (4.0, 8, True)),
    ("conv3x3_pool", (80, 80, 32, 64), (5.0, 4, True), (7.0, 1, True)),
    ("conv3x3_pool", (40, 40, 64, 128), (6.0, 1, True), (3.0, 5, True)),
    ("conv3x3", (40, 40, 64, 128), (3.0, 2, True), (2.5, 10, True)),
    ("conv3x3_pool", (20, 20, 128, 128), (2.0, 2, True), (3.0, 1, True)),
    ("conv3x3", (20, 20, 128, 128), (4.0, 5, True), (3.0, 4, True)),
    ("conv3x3", (10, 10, 128, 128), (2.0, 5, True), (3.0, 2, True)),
    ("matmul", (200, 128, 64), (1.5, 1, True), (1.0, 1, True)),
    ("conv3x3", (10, 10, 64, 64), (2.0, 1, True), (1.0, 2, True)),
]


def _mixed_table(cls, mod) -> dict:
    table = {}
    for op, dims, *modes in MIXED:
        for accum, (t, rows, fused) in zip(("dot", "popcount"), modes):
            table[mod.shape_key(op, dims, accum, DEV)] = _entry(
                cls, op, t, accum=accum, rows=rows, fused=fused)
    return table


@pytest.fixture
def mixed_tables(tmp_path, monkeypatch):
    """Each package's mixed table, written and named by its override."""
    for mod, cls in PACKAGES.values():
        name = "ref" if mod is jkc else "port"
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps({"entries": _mixed_table(cls, mod)}))
        monkeypatch.setenv("REPRO_AUTOTUNE_TABLE" if mod is jkc
                           else kc.TABLE_ENV, str(path))
        mod.clear_table_cache()
    yield
    for mod, _ in PACKAGES.values():
        mod.clear_table_cache()


def _layer_cells(bucket: int, batch: int) -> list:
    sizes = yolo.spatial_sizes(bucket)
    out = []
    for spec in yolo.YOLO_LAYERS:
        if spec.kind != "w1a8":
            continue
        h = sizes[spec.name]
        op = ("matmul" if spec.ksize == 1 else
              "conv3x3_pool" if spec.pool else "conv3x3")
        dims = ((batch * h * h, spec.cin, spec.cout) if op == "matmul"
                else (h, h, spec.cin, spec.cout))
        out.append((spec, h, op, dims))
    return out


@pytest.mark.parametrize("bucket", [64, 320])
def test_mixed_table_resolution_matches_reference(mixed_tables, bucket):
    """resolve and resolve_tuned, and each layer's tuned config, agree with
    the reference cell by cell; at 64 every hit is a nearest one."""
    cells = _layer_cells(bucket, 2)
    got = {}
    for pkg, (mod, _) in PACKAGES.items():
        got[pkg] = [(_fields(mod.resolve_tuned(op, dims)),
                     _fields(mod.resolve(op, dims, accum="dot")),
                     _fields(mod.resolve(op, dims, accum="popcount")))
                    for _, _, op, dims in cells]
    assert got["port"] == got["reference"]
    ref_layers = [jyolo._layer_config(spec, h, 2, profile="tuned",
                                      accum=None, fuse_pool=None,
                                      interpret=None, table=jkc.load_table())
                  for spec, h, _, _ in cells]
    port_layers = [yolo._layer_config(spec, h, 2, profile="tuned",
                                      accum=None, fuse_pool=None,
                                      table=kc.load_table())
                   for spec, h, _, _ in cells]
    assert [_fields(c) for c in port_layers] == \
        [_fields(c) for c in ref_layers]
    sources = {s for row in got["port"] for (*_, s) in row}
    if bucket == 64:
        assert sources == {"nearest"}
    else:
        assert sources == {"table"}
        tuned = [c.accum for c in port_layers]
        assert set(tuned) == {"dot", "popcount"}
        assert not port_layers[0].fused and port_layers[0].accum == \
            "popcount"


@pytest.fixture(scope="module")
def detector():
    """Images at bucket 64, B = 2, and the reference's per-channel
    artifact calibrated on them."""
    rng = np.random.default_rng(0)
    img = (rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
           .astype(np.float32) / 256.0)
    params = jyolo.calibrate_yolo(jyolo.init_yolo_params(
        jax.random.PRNGKey(42)), jnp.asarray(img))
    return img, jyolo.deploy_yolo_kernel(params)


def _port_art(jart):
    art_np = {"layers": [{k: (v if k == "spec" else np.asarray(v))
                          for k, v in e.items()} for e in jart["layers"]]}
    return convert.artifact_from_numpy(art_np, device="cpu")


def _in_envelope(name, got, want):
    rep = verify.compare(name, got, want, lsb=0.02)
    assert rep.max_abs < 0.02 and rep.within_1lsb == 1.0, rep.row()


def test_mixed_table_forward_in_envelope(mixed_tables, detector):
    """At bucket 64, B = 2: the port's tuned forward against the
    reference's under the same table, and the port's forward under the
    configs the table gives at 320 (popcount and dot layers, an unfused
    pool), all in the envelope of the reference's tuned forward."""
    img, jart = detector
    art = _port_art(jart)
    want = np.asarray(jyolo.yolo_forward_kernel(jart, jnp.asarray(img),
                                                profile="tuned"))
    x = torch.from_numpy(img)
    got = yolo.yolo_forward_kernel(art, x, profile="tuned").numpy()
    _in_envelope("port_tuned_vs_reference_tuned", got, want)
    configs320 = yolo.kernel_configs(art, 320, 2)
    assert {c.accum for c in configs320} == {"dot", "popcount"}
    mixed = yolo.yolo_forward_kernel(art, x, configs=configs320).numpy()
    _in_envelope("port_mixed_vs_reference_tuned", mixed, want)
    backend = DetectionBackend(art, slots=2, buckets=(64, 320), device="cpu")
    assert backend.configs(64) == yolo.kernel_configs(art, 64, 2)
    assert backend.configs(320) == configs320
    assert all(c.source == "default" for c in DetectionBackend(
        art, slots=2, profile="default", buckets=(64,),
        device="cpu").configs(64))


@pytest.mark.parametrize("per_channel", [True, False])
def test_art_uniform_steps_matches_reference(detector, per_channel):
    """On the reference's per-channel artifact, and on a per-tensor one
    calibrated by the port, both packages' diagnostic agree."""
    img, jart = detector
    if per_channel:
        art = _port_art(jart)
    else:
        _, art = yolo.build_detector(0, img, per_channel=False, device="cpu")
        jart = {"layers": [{k: (v if k == "spec" else v.numpy())
                            for k, v in e.items()} for e in art["layers"]]}
    want = jyolo.art_uniform_steps(jart)
    assert yolo.art_uniform_steps(art) == want == (not per_channel)


# ---------------------------------------------------------------------------
# The committed table
# ---------------------------------------------------------------------------

def test_committed_table():
    doc = json.loads(autotune.AUTOTUNE_OUT.read_text())
    card = doc["card"].split(",")
    assert len(card) == 2 and card[0].strip() and card[1].strip()[-1] == "W"
    batch = doc["batch"]
    assert doc["version"] == 1 and batch == 4
    entries = doc["entries"]
    devices = {kc.parse_key(k)[3] for k in entries}
    assert devices == {doc["device"]}
    want = {(op, dims) for op, dims in autotune.yolo_cells(batch)}
    keys = [kc.parse_key(k) for k in entries]
    assert len(entries) == 22
    assert {(op, dims) for op, dims, _, _ in keys} == want
    for key, rec in entries.items():
        op, dims, accum, _ = kc.parse_key(key)
        cfg = kc.KernelConfig.from_dict(rec["config"])
        assert (cfg.op, cfg.accum, cfg.source) == (op, accum, "table")
        assert rec["t_us"] > 0 and rec["t_default_us"] > 0
        assert autotune.launch_error(op, dims, batch, cfg) is None
        assert cfg in autotune.candidates(op, dims, accum)
    bench = json.loads(autotune.BENCH_OUT.read_text())
    assert bench["card"] == doc["card"] and bench["batch"] == batch
    assert set(entries) <= set(bench["entries"])


# ---------------------------------------------------------------------------
# The launcher on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", ["tuned", "default"])
def test_launcher_detect_burst_and_depth_sweep(profile):
    record = launch.main(["--device", "cpu", "--buckets", "64", "--slots",
                          "2", "--requests", "3", "--burst", "2x",
                          "--depth", "4", "--profile", profile])
    assert record["requests"] == 4 and record["bucket"] == 64
    assert record["profile"] == profile
    assert sorted(record["depth_sweep"], key=int) == ["1", "2", "4", "8"]
    assert record["host_syncs_per_tick"] <= 1.0
    assert "at most one host sync a tick" in record["checks"]
    configs = record["configs"]["64"]
    assert len(configs) == 9
    fused = {c["fused"] for c in configs if c["op"] == "conv3x3_pool"}
    assert fused == ({False} if profile == "default" else {True})
    assert record["alignment"]["within_1lsb"] == 1.0


def test_launcher_multires():
    record = launch.main(["--device", "cpu", "--workload", "multires",
                          "--buckets", "32,64", "--slots", "2",
                          "--requests", "6"])
    assert record["buckets"] == [32, 64]
    assert record["requests_per_bucket"] == {"32": 3, "64": 3}
    for b in ("32", "64"):
        assert sorted(record["saturation"][b], key=int) == ["1", "2", "4",
                                                             "8"]
        assert record["alignment"][b]["within_1lsb"] == 1.0
    with pytest.raises(ValueError):
        launch.main(["--device", "cpu", "--workload", "multires",
                     "--buckets", "64"])


def test_parse_burst_matches_reference():
    from repro.launch import serve as jlaunch
    for burst in ("", "4x", "3X", "2"):
        assert launch._parse_burst(burst, 4) == jlaunch._parse_burst(burst, 4)
