"""The dry run and the costs tooling on the CPU (`launch.dryrun`,
`launch.costs`), the kernel wrappers' shape-only path, Table 7 and the
kernel suite (`launch.tables`) and the two examples.

A fake process group changes the process's distributed state, so every
check that starts one runs in a subprocess (the ``fake_world`` fixture's),
away from the gloo tests' workers: the collective counter on a fake
16-rank world, reduced mixtral and jamba cells on a fake (2, 2) world
(meta and ``FakeTensorMode`` alike), the costs assembly against the
whole-step trace, and one production cell. The real runs of the same
reduced steps on the CPU count the traced FLOPs by dtype.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeSpec, skip_reason  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
RESULTS = SRC / "repro_torch" / "results"
REDUCED = ("mixtral-8x7b", "jamba-1.5-large-398b")
CELLS = {"train": ShapeSpec("t", "train", 32, 8),
         "prefill": ShapeSpec("p", "prefill", 32, 8),
         "decode": ShapeSpec("d", "decode", 64, 8)}
# the real CPU runs: the plain popcount versions are slow, so smaller
CPU_CELLS = {"train": ShapeSpec("t", "train", 16, 4),
             "prefill": ShapeSpec("p", "prefill", 16, 2),
             "decode": ShapeSpec("d", "decode", 32, 4)}

_PROGRAM = r"""
import json, sys
import torch
import torch.distributed as dist
from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import costs, dryrun as dr
from repro_torch.launch.mesh import make_test_mesh

out = {}
with dr.fake_world(16):
    g = dist.new_group(list(range(16)))
    node = dist.new_group([0, 1, 2, 3])
    c = dr.Counter()
    with c:
        x = torch.zeros(128, 4096, device="meta")
        dist.all_reduce(x, group=g)
        y = torch.zeros(1, 512, dtype=torch.bfloat16, device="meta")
        o = torch.empty(16, 512, dtype=torch.bfloat16, device="meta")
        dist.all_gather_into_tensor(o, y, group=g)
        z = torch.zeros(16, 8, 64, dtype=torch.bfloat16, device="meta")
        dist.all_to_all_single(torch.empty_like(z), z, group=node)
        w = torch.zeros(32, dtype=torch.uint8, device="meta")
        ops = [dist.P2POp(dist.isend, w, 1, g),
               dist.P2POp(dist.irecv, torch.empty_like(w), 15, g)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    out["collectives"] = c.collective_summary()

cells = {k: ShapeSpec(*v) for k, v in json.loads(sys.argv[1]).items()}
with dr.fake_world(4):
    mesh = make_test_mesh(2, 2, device="cpu")
    for arch in json.loads(sys.argv[2]):
        cfg = configs.get_reduced(arch)
        for kind, spec in cells.items():
            def build(dev):
                return dr.build_cell(arch, spec, mesh, cfg=cfg,
                                     microbatches=2, device=dev)
            _, meta, _ = dr.trace(build)
            _, fake, _ = dr.trace(build, fake=True)
            total, parts, _ = costs._units(arch, cfg, spec, mesh, 2, {})
            asm = dict(total["flops_by_dtype"])
            for k, v in parts.get("remat_flops", {}).items():
                asm[k] = asm.get(k, 0) + v
            out[f"{arch}/{kind}"] = {
                "flops": meta.flops, "fake_flops": fake.flops,
                "peak": meta.peak, "fake_peak": fake.peak,
                "peak_by": meta.peak_by, "kernels": meta.kernels,
                "collectives": meta.collective_summary(),
                "assembled": asm, "remat": parts.get("remat_flops", {})}
rec = dr.run_cell("mixtral-8x7b", "decode_32k", multi_pod=False)
out["production"] = {k: rec[k] for k in ("status", "trace_s", "fits",
                                          "memory", "cost", "collectives",
                                          "roofline", "chips")}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_world():
    """The fake-world program's results, from a subprocess."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    cells = {k: [v.name, v.kind, v.seq_len, v.global_batch]
             for k, v in CELLS.items()}
    out = subprocess.run([sys.executable, "-c", _PROGRAM, json.dumps(cells),
                          json.dumps(REDUCED)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_collective_counter_sums_output_bytes(fake_world):
    c = fake_world["collectives"]
    assert c["all-reduce"] == 128 * 4096 * 4
    assert c["all-gather"] == 16 * 512 * 2
    assert c["all-to-all"] == 16 * 8 * 64 * 2
    assert c["collective-permute"] == 2 * 32
    assert c["reduce-scatter"] == 0
    assert c["counts"] == {"all-reduce": 1, "all-gather": 1,
                           "reduce-scatter": 0, "all-to-all": 1,
                           "collective-permute": 2}
    groups = {(g["kind"], g["group"], g["intra_node"]): g["count"]
              for g in c["groups"]}
    assert groups == {("all-reduce", 16, False): 1,
                      ("all-gather", 16, False): 1,
                      ("all-to-all", 4, True): 1,
                      ("collective-permute", 2, True): 1,
                      ("collective-permute", 2, False): 1}


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("arch", REDUCED)
def test_reduced_cell_on_a_fake_world(fake_world, arch, kind):
    r = fake_world[f"{arch}/{kind}"]
    assert r["flops"] and all(v > 0 for v in r["flops"].values())
    assert r["flops"] == r["fake_flops"] and r["peak"] == r["fake_peak"]
    assert r["collectives"]["counts"]["all-to-all"] > 0      # the MoE's EP
    assert r["peak_by"]["parameters"] > 0
    if kind == "train":
        assert set(r["flops"]) == {"f32" if arch == "mixtral-8x7b"
                                   else "bf16"}
        assert r["peak_by"]["gradients"] > 0
        assert r["peak_by"]["optimizer_state"] > 0
    else:
        assert r["flops"]["int8"] > 0          # the popcount matmuls
        assert r["kernels"]["w1a8_matmul_popcount_grouped"] > 0


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("arch", REDUCED)
def test_costs_assembly_equals_the_whole_step(fake_world, arch, kind):
    r = fake_world[f"{arch}/{kind}"]
    assert r["assembled"] == r["flops"]
    assert bool(r["remat"]) == (kind == "train")


def test_production_cell_traces(fake_world):
    r = fake_world["production"]
    assert r["status"] == "ok" and r["chips"] == 256
    assert r["cost"]["kernel_calls"]["w1a8_matmul_popcount_grouped"] == 96
    # the dense projections run on the rank's blocks: wq, wk, wv, wo one
    # popcount launch each a layer
    assert r["cost"]["kernel_calls"]["w1a8_matmul_popcount"] == 4 * 32
    # 8 experts do not split over 16 data ranks: no EP; the experts' F
    # splits over 'model', one TP sum a layer; wo row-parallel, one sum a
    # layer, and the embedding's; 8 KV heads do not split over 16, so the
    # K and V products are gathered, two a layer, and the vocabulary's
    # logits once; every group is the 16 'model' ranks, which span two
    # nodes of 8
    assert r["collectives"]["counts"] == {
        "all-reduce": 1 + 2 * 32, "all-gather": 2 * 32 + 1,
        "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}
    assert sorted((g["kind"], g["group"], g["intra_node"]) for g in
                  r["collectives"]["groups"]) == [
        ("all-gather", 16, False), ("all-reduce", 16, False)]
    assert r["memory"]["peak_bytes"] > r["memory"]["peak_by_category"][
        "parameters"] > 0
    assert r["roofline"]["bottleneck"] in ("compute", "memory",
                                           "collective")


@pytest.mark.parametrize("kind", list(CPU_CELLS))
@pytest.mark.parametrize("arch", ("chatglm3-6b",) + REDUCED)
def test_trace_counts_what_a_cpu_run_does(arch, kind):
    """The local step traced on meta and run on the CPU from drawn params:
    the same FLOPs by dtype (the kernel wrappers report 2·M·N·K either
    way; their plain versions' ops are not counted)."""
    cfg = configs.get_reduced(arch)
    spec = CPU_CELLS[kind]

    def build(dev, gen=None):
        return dr.build_cell(arch, spec, None, cfg=cfg, microbatches=2,
                             device=dev, generator=gen,
                             **({} if kind == "train" else
                                {"dtype": torch.float32}))
    _, meta, _ = dr.trace(build)
    gen = torch.Generator()
    gen.manual_seed(0)
    real, _ = dr.count(build("cpu", gen))
    assert meta.flops == real.flops
    assert meta.kernels == real.kernels
    if kind == "train":
        assert meta.peak == real.peak


def test_shape_only_kernels_launch_nothing(monkeypatch):
    """Every wrapper on meta tensors: the kernel's shape and dtype, no
    launch, no plain version, its 2·M·N·K reported."""
    from repro_torch.kernels.config import KernelConfig
    from repro_torch.kernels.w1a8_conv import fused_pool
    from repro_torch.kernels.w1a8_conv import ops as conv_ops
    from repro_torch.kernels.w1a8_conv import ref as conv_ref
    from repro_torch.kernels.w1a8_int import ops as int_ops
    from repro_torch.kernels.w1a8_int import ref as int_ref
    from repro_torch.kernels.w1a8_matmul import ops as mm_ops
    from repro_torch.kernels.w1a8_matmul import ref as mm_ref
    from repro_torch.models import detection

    def boom(*a, **k):
        raise AssertionError("a plain version ran")
    for mod in (mm_ref, conv_ref, int_ref):
        for name in dir(mod):
            if name.endswith("_ref"):
                monkeypatch.setattr(mod, name, boom)
    monkeypatch.setattr(detection, "nms_plain", boom)
    monkeypatch.setattr(detection, "decode_head", boom)
    before = [k.launches for k in _build.KERNELS]

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    u8 = torch.uint8
    c = dr.Counter()
    with c:
        y = mm_ops.w1a8_matmul(meta((3, 5, 70), u8), meta((3, 16),
                               torch.int32), meta((70,)), meta((16,)),
                               meta((16,)), k=70,
                               config=KernelConfig(op="matmul",
                                                   accum="popcount"))
        assert y.shape == (3, 5, 16) and y.dtype == torch.float32
        y = mm_ops.w1a8_matmul(meta((4, 64), u8), meta((2, 8), torch.int32),
                               meta((64,)), meta((8,)), meta((8,)), k=64,
                               config=KernelConfig(op="matmul",
                                                   out_step=0.1))
        assert y.shape == (4, 8) and y.dtype == u8
        y = mm_ops.w1a8_matmul_grouped(meta((6, 4, 64), u8),
                                       meta((6, 2, 8), torch.int32),
                                       meta((6,), torch.int32),
                                       meta((6, 8)), meta((6, 8)), k=64)
        assert y.shape == (6, 4, 8)
        y = mm_ops.w1a8_matmul_int(meta((4, 64), u8),
                                   meta((2, 8), torch.int32),
                                   meta((8,), torch.int32))
        assert y.shape == (4, 8) and y.dtype == torch.int32
        for accum in ("dot", "popcount"):
            cfg = KernelConfig(op="conv3x3", accum=accum, out_step=0.5)
            y = conv_ops.w1a8_conv3x3(meta((2, 8, 8, 16), u8),
                                      meta((5, 32), torch.int32),
                                      meta((16,)), meta((32,)),
                                      meta((32,)), cin=16, config=cfg)
            assert y.shape == (2, 8, 8, 32) and y.dtype == u8
            y = fused_pool.w1a8_conv3x3_pool2(
                meta((2, 8, 8, 16), u8), meta((5, 32), torch.int32),
                meta((16,)), meta((32,)), meta((32,)), cin=16,
                out_step=0.5, accum=accum)
            assert y.shape == (2, 4, 4, 32)
        i64 = torch.int64
        y = int_ops.w1a8_int_pe(meta((2, 8, 8, 16), u8),
                                meta((5, 32), torch.int32), meta((16,), i64),
                                meta((32,), i64), meta((32,), i64),
                                meta((32,), i64), ksize=3, pool=True)
        assert y.shape == (2, 4, 4, 32) and y.dtype == u8
        y = int_ops.int_pe_conv1(meta((2, 8, 8, 3), u8), meta((27, 16), i64),
                                 meta((16,), i64), meta((16,), i64),
                                 meta((16,), i64))
        assert y.shape == (2, 4, 4, 16)
        y = int_ops.int_pe_head(meta((2, 4, 4, 16), u8), meta((16, 75), i64),
                                meta((16,), i64), meta((75,), i64), 3)
        assert y.shape == (2, 4, 4, 75) and y.dtype == i64
        boxes, scores, cls = detection.postprocess(meta((2, 10, 10, 75)),
                                                   max_out=7)
        assert boxes.shape == (2, 7, 4) and cls.dtype == torch.int32
        boxes, _, _ = detection.nms(meta((2, 30, 4)), meta((2, 30, 20)),
                                    max_out=5)
        assert boxes.shape == (2, 5, 4)
    assert [k.launches for k in _build.KERNELS] == before
    mm = 2 * 15 * 16 * 70 + 2 * 6 * 4 * 8 * 64 + 2 * 4 * 8 * 64
    conv = 2 * 2 * 8 * 8 * 9 * 16 * 32
    ints = 2 * 128 * 32 * 144 + 2 * 128 * 16 * 27 + 2 * 32 * 75 * 16
    assert c.flops == {"int8": mm + 2 * conv + ints,
                       "bf16": 2 * 4 * 8 * 64 + 2 * conv}
    assert c.kernels["detect_postprocess"] == 1
    assert c.kernels["detect_nms"] == 1


def test_fake_world_refuses_a_real_group(tmp_path):
    program = (
        "import torch.distributed as dist\n"
        "from repro_torch.launch import dryrun as dr\n"
        f"dist.init_process_group('gloo', init_method='file://{tmp_path}/s',"
        " rank=0, world_size=1)\n"
        "try:\n"
        "    with dr.fake_world(4):\n"
        "        raise SystemExit(3)\n"
        "except RuntimeError as e:\n"
        "    print('refused', e)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", program], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "refused" in out.stdout and "gloo" in out.stdout


def test_importing_the_tooling_touches_no_group():
    program = (
        "import os, torch.distributed as dist\n"
        "env = dict(os.environ)\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.costs\n"
        "import repro_torch.launch.quickstart, repro_torch.launch.serve_lm\n"
        "import repro_torch.configs.yolo_w1a8\n"
        "assert not dist.is_initialized()\n"
        "assert dict(os.environ) == env\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", program], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-3000:]


def _records(name: str) -> list:
    path = RESULTS / name
    if not path.exists():
        pytest.skip(f"no committed {name}")
    return json.loads(path.read_text())


@pytest.mark.parametrize("name", ["dryrun.json", "costs.json"])
def test_committed_matrix(name):
    recs = _records(name)
    archs = list(configs.ARCH_NAMES)
    for mesh in ("16x16", "2x16x16"):
        mine = {(r["arch"], r["shape"]): r for r in recs
                if r["mesh"] == mesh}
        assert set(mine) == {(a, s) for a in archs for s in SHAPES}
        skipped = {k for k, r in mine.items() if r["status"] == "skipped"}
        assert skipped == {(a, s) for a in archs for s in SHAPES
                           if skip_reason(a, s)}
        assert len(skipped) == 7
        assert all(r["status"] in ("ok", "skipped") for r in mine.values())
        for r in mine.values():
            if r["status"] != "ok":
                continue
            assert r["hw"] == "NVIDIA H100 80GB HBM3, 700 W (datasheet)"
            roof = r["roofline"]
            assert {"t_compute_s", "t_memory_s", "t_collective_s",
                    "bottleneck"} <= set(roof)
            assert r["memory"]["peak_by_category"]["parameters"] > 0
            assert isinstance(r["fits"], bool)
            assert r["reference_layout_bytes"] > 0
            if name == "dryrun.json":
                assert r["cost"]["flops_by_dtype"]
                assert set(r["collectives"]["counts"]) == set(dr.KINDS)
            else:
                assert r["totals"]["flops_by_dtype"]
                assert set(r["totals"]["collectives"]) == set(dr.KINDS)


def test_tables_suites_on_the_cpu(capsys):
    from repro_torch.launch import tables
    rows = tables.kernels("cpu", shapes=((8, 96, 64),))
    tags = [r[0] for r in rows]
    assert tags == [f"kernel.w1a8_matmul.8x96x64.{k}" for k in (
        "cpu_ref_us", "cpu_packed_us", "cpu_popcount_us", "h100_bound_us")]
    assert all(r[1] > 0 for r in rows)
    assert tables.main(["--only", "roofline"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("dryrun.summary,")
    if (RESULTS / "dryrun.json").exists():
        assert lines[-1].startswith("dryrun.summary,66ok/14skip/0err")
        assert len(lines) == 1 + 80 + 1


def test_roofline_suite_reads_a_results_dir(tmp_path):
    from repro_torch.launch import tables
    dry = [{"arch": "a", "shape": "s", "mesh": "16x16", "status": "ok",
            "trace_s": 1.0, "fits": False, "reference_layout_bytes": 2 ** 30,
            "memory": {"peak_bytes": 2 ** 31}},
           {"arch": "a", "shape": "t", "mesh": "16x16", "status": "skipped",
            "reason": "why"},
           {"arch": "b", "shape": "s", "mesh": "16x16", "status": "error",
            "error": "E"}]
    cost = [{"arch": "a", "shape": "s", "mesh": "16x16", "status": "ok",
             "roofline": {"t_compute_s": 1.0, "t_memory_s": 2.0,
                          "t_collective_s": 0.5, "bottleneck": "memory",
                          "roofline_fraction": 0.25}}]
    (tmp_path / "dryrun.json").write_text(json.dumps(dry))
    (tmp_path / "costs.json").write_text(json.dumps(cost))
    rows = tables.roofline(str(tmp_path))
    assert rows[0][:2] == ("dryrun.a.s.16x16", 0.25)
    assert "2.0 GiB/device (reference layout 1.0); fits False" in rows[0][2]
    assert rows[1][1] == "skipped" and rows[2][1] == "ERROR"
    assert rows[-1][1] == "1ok/1skip/1err"


def test_quickstart_on_the_cpu():
    from repro_torch.launch import quickstart
    rec = quickstart.run("cpu")
    assert rec["linear_in_envelope"] and rec["detector_in_envelope"]
    assert rec["lm_finite"] and rec["lm_logits_shape"] == [2, 16, 128]


def test_serve_lm_on_the_cpu():
    from repro_torch.launch import serve_lm
    rec = serve_lm.main(["--device", "cpu", "--max-new", "6"])
    assert sorted(rec["requests"]) == [0, 1, 2, 3, 4]
    assert rec["greedy"] == [0, 1, 2, 3]
    for rid, r in rec["requests"].items():
        if rid in rec["greedy"]:
            assert r["finish"] == "length" and len(r["tokens"]) == 6
        else:
            assert r["finish"] in ("length", "stop")


def test_yolo_config_is_the_reference_s():
    from repro.configs import yolo_w1a8 as jyolo
    from repro_torch.configs import yolo_w1a8
    assert yolo_w1a8.NAME == jyolo.NAME == "yolo-w1a8"
    assert [(s.name, s.kind, s.ksize, s.cin, s.cout) for s in
            yolo_w1a8.LAYERS] == [(s.name, s.kind, s.ksize, s.cin, s.cout)
                                  for s in jyolo.LAYERS]
    assert yolo_w1a8.count_params() == jyolo.count_params()
