"""Port parity, the sharding rules: `dist.sharding` against
`repro.dist.sharding` on the CPU.

`param_spec` reads only a mesh's axis names and sizes, so shape-only
stand-ins check the production layouts, (16, 16) over ('data', 'model')
and (2, 16, 16) over ('pod', 'data', 'model'), without their ranks, as
tests/conftest.py's ``FakeProdMesh`` does for the reference; (2, 2) is the
test layout. Every leaf of every arch's param tree (the port's shapes from
the ``meta`` device, its paths from `tree_items`), of its AdamW and
Adafactor states, and of the reference's packed tree gets the
reference's spec exactly (equal tuples, trailing Nones dropped).
`tree_shardings` and `pipeline_tree_shardings` give the DTensor
placements of the reference's ``NamedSharding`` specs.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from conftest import FakeProdMesh  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.dist import sharding as jsharding  # noqa: E402
from repro.models.transformer import init_lm_params as jinit  # noqa: E402
from repro.optim import adafactor as jadafactor  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serve.packed import deploy_lm as jdeploy  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.models.transformer import (init_lm_params,  # noqa: E402
                                            tree_items)
from repro_torch.optim import adafactor, adamw  # noqa: E402


class PodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


class SmallMesh:
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 2}


class StageMesh:
    axis_names = ("data", "stage")
    shape = {"data": 2, "stage": 2}


LAYOUTS = {"16x16": FakeProdMesh(), "2x16x16": PodMesh(), "2x2": SmallMesh()}


def _jax_items(tree) -> list:
    return [(jax.tree_util.keystr(p), tuple(leaf.shape)) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_items(tree) -> list:
    return [(p, tuple(leaf.shape)) for p, leaf in tree_items(tree)]


def _specs_equal(items, jcfg, cfg, mesh) -> int:
    for path, shape in items:
        want = tuple(jsharding.param_spec(path, shape, jcfg, mesh))
        got = sharding.param_spec(path, shape, cfg, mesh)
        assert got == want, f"{path} {shape}: {got} vs {want}"
    return len(items)


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_param_spec_every_leaf_every_layout(name):
    cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
    params = init_lm_params(cfg, None, device="meta")
    items = _port_items(params)
    assert items == _jax_items(jax.eval_shape(
        lambda: jinit(jax.random.PRNGKey(0), jcfg)))
    for mesh in LAYOUTS.values():
        _specs_equal(items, jcfg, cfg, mesh)
    # the model axis lands on the projections at production size
    specs = [sharding.param_spec(p, s, cfg, FakeProdMesh()) for p, s in items]
    assert any("model" in s for s in specs)


@pytest.mark.parametrize("name", ["mixtral-8x7b", "jamba-1.5-large-398b"])
def test_optimizer_and_packed_trees(name):
    cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
    params = init_lm_params(cfg, None, device="meta")
    sds = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    for port_opt, jax_opt in ((adamw, jadamw), (adafactor, jadafactor)):
        items = _port_items(port_opt(1e-3)[0](params))
        assert items == _jax_items(jax.eval_shape(jax_opt(1e-3)[0], sds))
        for mesh in LAYOUTS.values():
            _specs_equal(items, jcfg, cfg, mesh)
    packed = _jax_items(jax.eval_shape(jdeploy, sds))
    assert any(p.endswith("['w_packed']") for p, _ in packed)
    for mesh in LAYOUTS.values():
        _specs_equal(packed, jcfg, cfg, mesh)


def _placements(spec, axis_names) -> list:
    dims = {a: d for d, a in enumerate(spec) if a is not None}
    return [Shard(dims[a]) if a in dims else Replicate() for a in axis_names]


def test_tree_shardings_are_the_reference_specs():
    name = "mixtral-8x7b"
    cfg, jcfg = configs.get_reduced(name), jconfigs.get_reduced(name)
    params = init_lm_params(cfg, None, device="meta")
    sds = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    want = jsharding.tree_shardings(
        sds, jcfg, jax.make_mesh((2, 2), ("data", "model")))
    got = dict(tree_items(sharding.tree_shardings(params, cfg, SmallMesh())))
    wants = dict((jax.tree_util.keystr(p), s) for p, s in
                 jax.tree_util.tree_flatten_with_path(want)[0])
    assert set(got) == set(wants)
    for path, placements in got.items():
        assert placements == _placements(wants[path].spec,
                                         SmallMesh.axis_names), path
    assert any(isinstance(p, Shard) for pl in got.values() for p in pl)
    assert "['slots'][0]['attn']['wq']['w']" in sharding.spec_report(
        params, cfg, SmallMesh(), only_sharded=True)


@pytest.mark.parametrize("name", ["qwen2.5-14b", "mamba2-1.3b"])
def test_pipeline_tree_shardings(name):
    """Layer-stacked leaves of params and AdamW state shard dim 0 over
    'stage', everything else replicates; `stage_slice` keeps those rows."""
    cfg, jcfg = configs.get_reduced(name), jconfigs.get_reduced(name)
    params = init_lm_params(cfg, None, device="meta")
    sds = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    jmesh = jax.make_mesh((2, 2), ("data", "stage"))
    for tree, jtree in ((params, sds),
                        (adamw(1e-3)[0](params),
                         jax.eval_shape(jadamw(1e-3)[0], sds))):
        got = dict(tree_items(sharding.pipeline_tree_shardings(
            tree, StageMesh(), cfg.num_layers)))
        want = dict((jax.tree_util.keystr(p), s) for p, s in
                    jax.tree_util.tree_flatten_with_path(
                        jsharding.pipeline_tree_shardings(
                            jtree, jmesh, jcfg.num_layers))[0])
        assert set(got) == set(want)
        for path, placements in got.items():
            assert placements == _placements(want[path].spec,
                                             StageMesh.axis_names), path
        stacked = [p for p, pl in got.items() if pl[1] == Shard(0)]
        assert stacked and all("['slots']" in p for p in stacked)
