"""The reference's last two launcher flags in the port, on the CPU.

* ``serve --gate-bench``: the port's `launch.serve.gate` and launcher
  against the reference's ``main`` over a table of committed records and
  new ones (each threshold, one ulp either side of it, a key absent, the
  committed file empty, unparsable or missing, compose losing a request),
  and the port's launcher run twice against one record file (the first
  run records, the second enforces), then against a doctored one.
* ``dryrun --save-hlo``: rank 0's op text of a production cell and of a
  reduced cell on a fake world adds up to the cell's record.
* Every ``--flag`` of the reference's launchers has a counterpart of the
  same name in the port's launcher of the same name.
"""
import ast
import collections
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
UP, DOWN = math.inf, -math.inf

# committed values and the gates' edges: bytes <= B x 1.05, img/s >= I x 0.95
B, I = 554.0, 3436.080737583625
B_EDGE, I_EDGE = B * 1.05, I * 0.95


def _record(workload: str, **kw) -> dict:
    base = {"lm": {"workload": "lm", "host_sync_bytes_per_tick": 4.0,
                   "img_per_s": 0.0, "tokens": 96},
            "detect": {"workload": "detect", "depth": 2,
                       "host_sync_bytes_per_tick": B, "img_per_s": I},
            "multires": {"workload": "multires", "depth": 2,
                         "img_per_s": I},
            "compose": {"workload": "compose", "lost": 0, "duplicated": 0,
                        "ticks": 9}}[workload]
    return {**base, **kw}


def _file(workload: str, **committed) -> str:
    return json.dumps({workload: _record(workload, **committed),
                       "other": {"kept": True}}, indent=2, sort_keys=True)


# (id, workload, committed file text or None for no file, new record)
CASES = [
    ("lm bytes at the edge", "lm", _file("lm", host_sync_bytes_per_tick=B),
     _record("lm", host_sync_bytes_per_tick=B_EDGE)),
    ("lm bytes an ulp past", "lm", _file("lm", host_sync_bytes_per_tick=B),
     _record("lm", host_sync_bytes_per_tick=math.nextafter(B_EDGE, UP))),
    ("lm bytes an ulp inside", "lm",
     _file("lm", host_sync_bytes_per_tick=B),
     _record("lm", host_sync_bytes_per_tick=math.nextafter(B_EDGE, DOWN))),
    ("lm bytes absent", "lm", _file("lm", host_sync_bytes_per_tick=None),
     _record("lm", host_sync_bytes_per_tick=10 * B)),
    ("detect bytes an ulp past", "detect", _file("detect"),
     _record("detect", host_sync_bytes_per_tick=math.nextafter(B_EDGE, UP))),
    ("detect bytes at the edge", "detect", _file("detect"),
     _record("detect", host_sync_bytes_per_tick=B_EDGE)),
    ("detect img/s at the edge", "detect", _file("detect"),
     _record("detect", img_per_s=I_EDGE)),
    ("detect img/s an ulp below", "detect", _file("detect"),
     _record("detect", img_per_s=math.nextafter(I_EDGE, DOWN))),
    ("detect img/s an ulp above", "detect", _file("detect"),
     _record("detect", img_per_s=math.nextafter(I_EDGE, UP))),
    ("detect img/s absent", "detect", _file("detect", img_per_s=None),
     _record("detect", img_per_s=1.0)),
    ("detect bytes absent", "detect",
     _file("detect", host_sync_bytes_per_tick=None),
     _record("detect", host_sync_bytes_per_tick=10 * B)),
    ("detect both fail", "detect", _file("detect"),
     _record("detect", host_sync_bytes_per_tick=2 * B, img_per_s=1.0)),
    ("multires img/s an ulp below", "multires", _file("multires"),
     _record("multires", img_per_s=math.nextafter(I_EDGE, DOWN))),
    ("multires img/s at the edge", "multires", _file("multires"),
     _record("multires", img_per_s=I_EDGE)),
    ("multires ignores bytes", "multires",
     _file("multires", host_sync_bytes_per_tick=1.0),
     _record("multires", host_sync_bytes_per_tick=10 * B)),
    ("lm ignores img/s", "lm", _file("lm", img_per_s=1e9),
     _record("lm")),
    ("compose lost 1", "compose", _file("compose"),
     _record("compose", lost=1)),
    ("compose duplicated 1", "compose", _file("compose"),
     _record("compose", duplicated=1)),
    ("compose conserved", "compose", _file("compose"), _record("compose")),
    ("compose lost 1, nothing committed", "compose", None,
     _record("compose", lost=1)),
    ("no file", "detect", None, _record("detect", img_per_s=1.0)),
    ("empty file", "detect", "", _record("detect", img_per_s=1.0)),
    ("unparsable file", "lm", "{not json",
     _record("lm", host_sync_bytes_per_tick=10 * B)),
    ("workload null", "detect", json.dumps({"detect": None}),
     _record("detect", img_per_s=1.0)),
    ("another workload only", "multires", _file("detect"),
     _record("multires", img_per_s=1.0)),
]


def _outcome(fn) -> tuple:
    try:
        fn()
    except AssertionError as e:
        return "fail", str(e)
    return "pass", None


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_gate_matches_the_reference(case, tmp_path, monkeypatch):
    """Pass or fail, the message and the file left behind: the port's
    `gate` and launcher against the reference's ``main``, its runner
    replaced by one that returns the record."""
    from repro.launch import serve as ref
    _, workload, text, record = case
    paths = {}
    for side in ("ref", "port", "gate"):
        paths[side] = tmp_path / side / "bench.json"
        paths[side].parent.mkdir()
        if text is not None:
            paths[side].write_text(text)
    before = paths["ref"].read_bytes() if text is not None else None

    monkeypatch.setattr(ref, f"run_{workload}", lambda args: dict(record))
    monkeypatch.setattr(sys, "argv", ["serve", "--workload", workload,
                                      "--gate-bench", "--out",
                                      str(paths["ref"])])
    want, want_msg = _outcome(ref.main)

    monkeypatch.setattr(serve, f"run_{workload}", lambda args: dict(record))
    got, got_msg = _outcome(lambda: serve.main(
        ["--workload", workload, "--gate-bench", "--out",
         str(paths["port"])]))
    committed = serve.read_records(str(paths["gate"])).get(workload) or {}
    direct, direct_msg = _outcome(lambda: serve.gate(workload, committed,
                                                     record))

    assert got == direct == want, (got, direct, want)
    if want_msg:                     # the reference's compose gate is bare
        assert got_msg == direct_msg == want_msg
    if want == "fail":
        assert (paths["port"].read_bytes() if paths["port"].exists()
                else None) == before
    assert paths["port"].exists() == paths["ref"].exists()
    if paths["ref"].exists():
        assert paths["port"].read_bytes() == paths["ref"].read_bytes()
        if want == "pass":
            assert json.loads(paths["port"].read_text())[workload] == record


def test_gate_names_its_key():
    committed = _record("detect")
    with pytest.raises(AssertionError, match="^host_sync_bytes_per_tick"):
        serve.gate("detect", committed, _record(
            "detect", host_sync_bytes_per_tick=2 * B))
    with pytest.raises(AssertionError, match="^img_per_s at depth=2"):
        serve.gate("detect", committed, _record("detect", img_per_s=1.0))
    assert serve.gate("detect", {}, _record("detect", img_per_s=1.0)) == []
    assert len(serve.gate("detect", committed, _record("detect"))) == 2


LAUNCHES = {
    "detect": ["--workload", "detect", "--device", "cpu", "--buckets", "64",
               "--requests", "8"],
    "lm": ["--workload", "lm", "--reduced", "--device", "cpu"],
}


@pytest.mark.parametrize("workload", list(LAUNCHES))
def test_launcher_records_then_enforces(workload, tmp_path, capsys):
    """The port's launcher twice against one file, then against a
    committed record doctored to half the bytes. The committed img/s is
    taken out before the second run: one run's img/s on a shared host
    spreads past the 5% gate, which `test_gate_matches_the_reference`
    holds at its edge."""
    path = tmp_path / "bench.json"
    argv = LAUNCHES[workload] + ["--gate-bench", "--out", str(path)]
    first = serve.main(argv)
    assert "gate records, next run enforces" in capsys.readouterr().out
    data = json.loads(path.read_text())
    assert data[workload] == json.loads(json.dumps(first))
    data[workload].pop("img_per_s")
    path.write_text(json.dumps(data))
    second = serve.main(argv)
    assert "[gate] host_sync_bytes_per_tick" in capsys.readouterr().out
    assert second["host_sync_bytes_per_tick"] == \
        first["host_sync_bytes_per_tick"] > 0
    if workload == "detect":
        # bucket 64: a raw head of 2 x 2 x 75 f32, recorded, not gated
        assert second["sync_bytes_reduction_vs_raw_wire"] == (
            second["raw_wire"]["host_sync_bytes_per_sync"]
            / second["host_sync_bytes_per_sync"]) > 1
        assert second["host_syncs"] > 0
    data = json.loads(path.read_text())
    data[workload]["host_sync_bytes_per_tick"] = \
        second["host_sync_bytes_per_tick"] / 2
    data[workload].pop("img_per_s")
    path.write_text(json.dumps(data))
    before = path.read_bytes()
    with pytest.raises(AssertionError,
                       match="^host_sync_bytes_per_tick regressed"):
        serve.main(argv)
    assert path.read_bytes() == before


def test_detect_reduced_serves_two_requests(tmp_path):
    rec = serve.main(["--workload", "detect", "--device", "cpu",
                      "--buckets", "64", "--reduced"])
    assert rec["requests"] == 2


_OPS_PROGRAM = r"""
import collections, json, sys
from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_test_mesh

dr.RESULTS_DIR = sys.argv[1]


def sums(lines):
    kinds = collections.Counter(l.split()[0] for l in lines)
    c10d = collections.Counter(l.split()[1] for l in lines
                               if l.startswith("c10d "))
    flops, kernels = {}, collections.Counter()
    for l in lines:
        f = l.split()          # op|kernel NAME flops=N class=C ...
        if f[0] == "kernel":
            kernels[f[1]] += 1
        if f[0] in ("op", "kernel") and f[3][6:] not in ("-", "none"):
            flops[f[3][6:]] = flops.get(f[3][6:], 0) + int(f[2][6:])
    return {"kinds": kinds, "c10d": c10d, "flops": flops,
            "kernels": kernels}


out = {}
rec = dr.run_cell("mixtral-8x7b", "decode_32k", multi_pod=False,
                  save_hlo=True)
plain = dr.run_cell("mixtral-8x7b", "decode_32k", multi_pod=False)
with open(rec["ops_text"]) as f:
    text = f.read().splitlines()
out["production"] = {"path": rec["ops_text"], "head": text[0],
                     "sums": sums(text[1:]),
                     "rec": {k: rec[k] for k in ("cost", "collectives")},
                     "same": {k: v for k, v in rec.items()
                              if k not in ("trace_s", "ops_text")}
                     == {k: v for k, v in plain.items()
                         if k != "trace_s"}}
with dr.fake_world(4):
    mesh = make_test_mesh(2, 2, device="cpu")
    cfg = configs.get_reduced("mixtral-8x7b")
    spec = ShapeSpec("d", "decode", 64, 8)
    _, counter, _ = dr.trace(lambda dev: dr.build_cell(
        "mixtral-8x7b", spec, mesh, cfg=cfg, device=dev), lines=True)
    _, quiet, _ = dr.trace(lambda dev: dr.build_cell(
        "mixtral-8x7b", spec, mesh, cfg=cfg, device=dev))
    out["reduced"] = {"sums": sums(counter.lines),
                      "rec": dr.counted_record(counter),
                      "quiet_lines": quiet.lines,
                      "same": dr.counted_record(quiet)
                      == dr.counted_record(counter)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ops_text(tmp_path_factory):
    """The op text of mixtral-8x7b decode_32k at (16, 16) through
    `run_cell(save_hlo=True)` and of the reduced mixtral decode cell on a
    fake (2, 2) world, in a subprocess (a fake process group changes the
    process's distributed state)."""
    results = tmp_path_factory.mktemp("results")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _OPS_PROGRAM, str(results)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return results, json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ("production", "reduced"))
def test_op_text_adds_up_to_the_record(ops_text, cell):
    _, out = ops_text
    r = out[cell]
    sums, cost, coll = r["sums"], r["rec"]["cost"], r["rec"]["collectives"]
    assert sums["kinds"]["op"] + sums["kinds"]["c10d"] == cost["ops"]
    assert {k: sums["c10d"].get(k, 0) for k in coll["counts"]} == \
        coll["counts"]
    assert sums["kinds"]["c10d"] == sum(coll["counts"].values()) > 0
    assert sums["kernels"] == cost["kernel_calls"] and sums["kernels"]
    assert sums["flops"] == cost["flops_by_dtype"]
    assert r["same"]                      # the flag changes no count


def test_save_hlo_writes_the_cell_file(ops_text):
    results, out = ops_text
    r = out["production"]
    assert pathlib.Path(r["path"]) == \
        results / "ops_mixtral-8x7b_decode_32k_16x16.txt"
    assert r["head"].startswith("# rank 0 of mixtral-8x7b x decode_32k")
    assert out["reduced"]["quiet_lines"] is None
    assert out["reduced"]["sums"]["c10d"]["all-to-all"] > 0   # the MoE's EP


def _flags(path: pathlib.Path) -> set:
    flags = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", "") == "add_argument":
            flags |= {a.value for a in node.args
                      if isinstance(a, ast.Constant)
                      and str(a.value).startswith("--")}
    return flags


REF_LAUNCHERS = sorted(p.name for p in (SRC / "repro" / "launch").glob(
    "*.py") if _flags(p))


@pytest.mark.parametrize("name", REF_LAUNCHERS)
def test_every_reference_flag_is_ported(name):
    port = SRC / "repro_torch" / "launch" / name
    assert port.exists(), f"no port of launch/{name}"
    missing = _flags(SRC / "repro" / "launch" / name) - _flags(port)
    assert not missing, f"launch/{name}: {sorted(missing)}"
