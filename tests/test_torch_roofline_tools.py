"""Port parity, the roofline tooling's arithmetic: `launch.dryrun` and
`launch.costs` against `repro.launch.dryrun` and `repro.launch.costs` on
the CPU.

MODEL_FLOPS on all 40 arch × shape cells, the analytic HBM bytes on the
reference's 33 ``ok`` cells at both production sizes, the KV / SSM cache
specs of `dist.sharding.cache_spec` against the reference's
``_cache_shardings`` on shape-only production meshes, the bubble table,
the skip reasons and the ring formulas; tests/test_roofline_tools.py's
cases hold for the port. The H100 constants are the datasheet's.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from conftest import FakeProdMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.launch import costs as jcosts  # noqa: E402
from repro.launch import dryrun as jdr  # noqa: E402
from repro.models.transformer import init_lm_params as jinit  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve.packed import deploy_lm as jdeploy  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import SHAPES, skip_reason  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.launch import costs  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch.mesh import HW, link_bw  # noqa: E402
from repro_torch.models.transformer import tree_items  # noqa: E402
from repro_torch.serve.cache import init_cache  # noqa: E402
from repro_torch.serve.packed import deploy_lm  # noqa: E402


class FakePodsMesh:
    """The (2, 16, 16) ('pod', 'data', 'model') production mesh, shapes
    only."""

    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


ARCHS = list(configs.ARCH_NAMES)


def test_archs_and_shapes_are_the_reference_s():
    assert ARCHS == list(jconfigs.ARCH_NAMES)
    assert list(SHAPES) == list(JSHAPES)
    assert dr.BIG == jdr.BIG


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch):
    for shape in SHAPES:
        want = jdr.model_flops(arch, shape)
        got = dr.model_flops(arch, shape)
        assert math.isclose(got, want, rel_tol=1e-12), (arch, shape, got,
                                                        want)


def _ref_trees(arch: str) -> dict:
    """The reference's (train, serving) param trees of ``arch``, shapes
    only, as its ``measure_cell`` builds them."""
    cfg = jconfigs.get_config(arch)
    dtype = jnp.bfloat16 if arch in jdr.BIG else jnp.float32
    train = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), cfg, dtype))
    serve = jax.eval_shape(
        lambda: jinit(jax.random.PRNGKey(0), cfg, jnp.bfloat16))
    if cfg.w1a8_body:
        serve = jax.eval_shape(jdeploy, serve)
    return {"train": train, "serve": serve}


def _port_trees(arch: str) -> dict:
    cfg = configs.get_config(arch)
    dtype = torch.bfloat16 if arch in dr.BIG else torch.float32
    serve = dr.param_shapes(cfg, torch.bfloat16)
    return {"train": dr.param_shapes(cfg, dtype),
            "serve": deploy_lm(serve) if cfg.w1a8_body else serve}


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_bytes_equal_the_reference(arch):
    ref, port = _ref_trees(arch), _port_trees(arch)
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    cells = 0
    for name, spec in SHAPES.items():
        if skip_reason(arch, name):
            continue
        tree = "train" if spec.kind == "train" else "serve"
        for n_chips in (256, 512):
            for seq_shard in (False, True):
                want = jcosts.analytic_bytes(jcfg, JSHAPES[name], ref[tree],
                                             n_chips,
                                             cache_seq_shard=seq_shard)
                got = costs.analytic_bytes(cfg, spec, port[tree], n_chips,
                                           cache_seq_shard=seq_shard)
                assert got == want, (arch, name, n_chips, got, want)
        cells += 1
    assert cells == (4 if arch in ("mamba2-1.3b", "jamba-1.5-large-398b",
                                   "mixtral-8x7b") else 3)


def _norm(spec) -> tuple:
    """A spec's entries with one-axis tuples as the axis, trailing Nones
    dropped: the reference's ``PartitionSpec`` and the port's tuples
    compare alike."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else
           (tuple(e) if isinstance(e, (tuple, list)) else e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("mesh", [FakeProdMesh, FakePodsMesh],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_is_the_reference_s(arch, mesh, monkeypatch):
    monkeypatch.setattr(jdr, "NamedSharding", lambda _mesh, spec: spec)
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jdp = tuple(a for a in mesh.axis_names if a != "model")
    dp = sharding.dp_axes(mesh)
    assert dp == jdp
    for name in ("decode_32k", "long_500k"):
        spec = SHAPES[name]
        long_ctx = spec.global_batch < dr._axsize(mesh, dp)
        jcache = jax.eval_shape(lambda: jengine.init_cache(
            jcfg, spec.global_batch, spec.seq_len, jnp.bfloat16))
        cache = init_cache(cfg, spec.global_batch, spec.seq_len,
                           dtype=torch.bfloat16, device="meta")
        for fallback in (False, True):
            want = jax.tree_util.tree_flatten_with_path(jdr._cache_shardings(
                jcache, mesh, jcfg, dp=jdp, long_ctx=long_ctx,
                seq_shard_fallback=fallback),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
            )[0]
            want = {jax.tree_util.keystr(p): _norm(s) for p, s in want}
            got = {p: _norm(s) for p, s in dr.cache_shardings(
                cache, cfg, mesh, dp=dp, long_ctx=long_ctx,
                seq_shard_fallback=fallback).items()}
            assert got == want, (arch, name, fallback)
            shapes = {p: tuple(leaf.shape) for p, leaf in tree_items(cache)}
            assert shapes == {jax.tree_util.keystr(p): tuple(x.shape) for
                              p, x in jax.tree_util.tree_flatten_with_path(
                                  jcache)[0]}


def test_spec_block_bytes_divides_by_the_axes():
    mesh = FakePodsMesh
    assert sharding.spec_block_bytes((("pod", "data"), None, "model"),
                                     (64, 3, 32), 2, mesh) == 2 * 3 * 2 * 2
    assert sharding.spec_block_bytes((), (5, 7), 4, mesh) == 140


def test_bubble_table_and_records_match_the_reference():
    assert dr.bubble_table() == jdr.bubble_table()
    assert dr.bubble_table((2, 4, 8), (1, 4, 16)) == \
        jdr.bubble_table((2, 4, 8), (1, 4, 16))
    for arch in ARCHS:
        assert dr.pipeline_bubble_record(configs.get_config(arch)) == \
            jdr.pipeline_bubble_record(jconfigs.get_config(arch))


def test_skip_reasons_match_the_reference():
    from repro.configs.shapes import skip_reason as jskip
    for arch in ARCHS:
        for shape in SHAPES:
            assert skip_reason(arch, shape) == jskip(arch, shape)
    assert sum(bool(skip_reason(a, s)) for a in ARCHS for s in SHAPES) == 7


@pytest.mark.parametrize("n", [1, 2, 16, 256, 512])
def test_wire_bytes_equal_the_reference(n):
    coll = {"all-reduce": 100, "all-gather": 300, "reduce-scatter": 7,
            "all-to-all": 64, "collective-permute": 50}
    assert dr.wire_bytes(coll, n) == jdr.wire_bytes(coll, n)


# tests/test_roofline_tools.py's cases, on the port


def test_wire_bytes_ring_formulas():
    coll = {"all-reduce": 100, "all-gather": 100, "reduce-scatter": 0,
            "all-to-all": 0, "collective-permute": 50}
    f = 15 / 16
    assert abs(dr.wire_bytes(coll, 16) - (2 * 100 * f + 100 * f + 50)) \
        < 1e-9


def test_model_flops_train_matches_6nd():
    f = dr.model_flops("chatglm3-6b", "train_4k")
    base = 6 * 6.35e9 * 256 * 4096
    assert base * 0.9 < f < base * 1.6


def test_model_flops_moe_uses_active_params():
    f = dr.model_flops("kimi-k2-1t-a32b", "train_4k")
    tokens = 256 * 4096
    assert 6 * 25e9 * tokens < f < 6 * 100e9 * tokens


def test_model_flops_decode_linear_in_context():
    assert dr.model_flops("qwen2.5-14b", "decode_32k") > 2 * 14e9 * 128


def test_model_flops_swa_bounded():
    f = dr.model_flops("mixtral-8x7b", "long_500k")
    attn_win = 1 * 4 * 32 * 128 * 4096 * 32
    attn_full = 1 * 4 * 32 * 128 * 524288 * 32
    base = 2 * 12.9e9
    assert base * 0.9 < f < base + attn_full * 0.5
    assert f > attn_win


def test_skip_reasons_match_design():
    assert skip_reason("gemma2-27b", "long_500k")
    assert not skip_reason("mamba2-1.3b", "long_500k")
    assert not skip_reason("mixtral-8x7b", "long_500k")
    assert not skip_reason("gemma2-27b", "train_4k")


def test_h100_constants_and_roofline_terms():
    assert HW["peak_flops_bf16"] == 989.4e12
    assert HW["peak_ops_int8"] == 1978.9e12
    assert HW["peak_flops_f32"] == 66.9e12
    assert HW["hbm_bw"] == 3.35e12 and HW["hbm_bytes"] == 80e9
    assert HW["gpus_per_node"] == 8
    assert link_bw(True) == 450e9 and link_bw(False) == 50e9
    t = dr.roofline_terms({"f32": 66.9e12, "bf16": 989.4e12,
                           "int8": 2 * 1978.9e12}, 3.35e12, 0.5)
    assert math.isclose(t["t_compute_s"], 4.0)
    assert math.isclose(t["t_memory_s"], 1.0)
    assert t["bottleneck"] == "compute"
    groups = [{"kind": "all-reduce", "bytes": 450e9, "group": 2,
               "intra_node": True},
              {"kind": "collective-permute", "bytes": 50e9, "group": 2,
               "intra_node": False}]
    assert math.isclose(dr.collective_seconds(groups), 2.0)


def test_variant_knobs():
    cfg = configs.get_config("mixtral-8x7b")
    assert costs.variant_config(cfg, {"microbatches": 4}) is cfg
    assert costs.variant_config(cfg, {"flash_block": 1024}).flash_block \
        == 1024
    assert costs.variant_config(cfg, {"flat_head": True}).flat_head_attn
    with pytest.raises(ValueError, match="no counterpart"):
        costs.variant_config(cfg, {"ring_block": 2})
    assert costs.parse_variant("a=1,b=true,c=0.5") == {"a": 1, "b": True,
                                                       "c": 0.5}
