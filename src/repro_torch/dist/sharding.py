"""Sharding rules: param path + shape → a spec, and its placements on a
`DeviceMesh`. Counterpart of ``repro/dist/sharding.py``.

One function, ``param_spec``, maps every param leaf of every arch in
``configs.ARCH_NAMES`` (and the optimizer and packed trees derived from
them) to a legal spec on a ('data', 'model') or ('pod', 'data', 'model')
mesh:

  * attention / dense-FFN / SSM projections: tensor-parallel over
    ``model``, column-parallel (wq/wk/wv/up/gate/in_proj: output dim) or
    row-parallel (wo/down/out_proj: contraction dim); packed weights
    (``w_packed``) shard the same dims, so the W1A8 scale split stays
    shard-local;
  * MoE expert stacks (E, K, N): expert-parallel over ``data`` on E and
    tensor-parallel over ``model`` inside the expert;
  * embedding / LM head: vocab over ``model``;
  * norms, biases of row-parallel projections, scalar LSQ steps, router:
    replicated.

A spec is a tuple with an axis name or None per dim, trailing Nones
dropped (the reference's ``PartitionSpec``); an axis lands on a dim only
where its size divides it. ``param_spec`` reads nothing of the mesh but
its axis names and sizes (`launch.mesh.axis_sizes`), so a shape-only
stand-in checks a production layout without its ranks. Paths are the
port's key strings (`models.transformer.tree_items`, which
``ckpt/checkpoint.py`` writes): ``"['slots'][0]['attn']['wq']['w']"``.
`tree_shardings` and `pipeline_tree_shardings` give each leaf its DTensor
placements, one `Shard(dim)` or `Replicate()` a mesh dim.
"""
from __future__ import annotations

import re

from torch.distributed.tensor import Replicate, Shard

from repro_torch.dist.collectives import all_gather_rows
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.transformer import tree_items, tree_map_with_path
from repro_torch.optim.optimizers import tree_map

# leaf names of column-parallel projections (shard output dim over model)
_COL_PARALLEL = ("wq", "wk", "wv", "up", "gate", "in_proj", "x_proj",
                 "dt_proj", "shared_up", "shared_gate")
# leaf names of row-parallel projections (shard contraction dim over model)
_ROW_PARALLEL = ("wo", "down", "out_proj", "shared_down")

_KEY_RE = re.compile(r"\['([^']+)'\]")


def dp_axes(mesh) -> tuple:
    """Mesh axes the batch shards over (everything except 'model')."""
    return tuple(a for a in axis_sizes(mesh) if a != "model")


def _fits(sizes: dict, shape, dim: int, axis: str) -> bool:
    """True iff `axis` exists and divides shape[dim] (dim may be negative)."""
    if axis not in sizes:
        return False
    if not (-len(shape) <= dim < len(shape)):
        return False
    return shape[dim] % sizes[axis] == 0


def _spec(ndim: int, placements: dict) -> tuple:
    """A spec from {dim (may be negative): axis}."""
    entries = [None] * ndim
    for dim, axis in placements.items():
        entries[dim % ndim] = axis
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _moe_spec(keys, shape, sizes: dict) -> tuple:
    """Expert stacks: leaves under a ['moe'] node.

    Canonical shapes (an optional leading stage dim rides along replicated):
      up/gate[_packed]   (E, K[/32], F)   → ep on E, model on F (columns)
      down[_packed]      (E, F[/32], D)   → ep on E, model on F (rows)
      up/gate_alpha      (E, 1, F)        → ep on E, model on F
      down_alpha         (E, 1, D)        → ep on E
    """
    leaf = keys[-1]
    ndim = len(shape)
    placements = {}
    # E is third-from-last for the 3D+ expert stacks; for reduced optimizer
    # leaves (adafactor vr/vc drop a trailing dim) fall back to dim 0
    e_dim = (-3 if ndim >= 3 else 0) % ndim
    if _fits(sizes, shape, e_dim, "data"):
        placements[e_dim] = "data"
    if leaf.startswith(("up", "gate")):
        tp_dim = (-1) % ndim
    elif leaf.startswith("down") and not leaf.endswith("alpha") and ndim >= 2:
        tp_dim = (-2) % ndim
    else:
        tp_dim = None
    if tp_dim is not None and tp_dim != e_dim \
            and _fits(sizes, shape, tp_dim, "model"):
        placements[tp_dim] = "model"
    return _spec(ndim, placements)


def param_spec(path: str, shape, cfg, mesh) -> tuple:
    """The spec of one param leaf.

    path: a key string such as ``"['slots'][0]['attn']['wq']['w']"``
    (optimizer prefixes like ['mu'] are ignored: rules match on the
    innermost module keys). shape: the leaf's shape (with or without the
    stacked stage dim)."""
    sizes = axis_sizes(mesh)
    keys = _KEY_RE.findall(path)
    ndim = len(shape)
    if ndim == 0 or not keys:
        return ()

    # ---- MoE expert tensors: (data, model) ---------------------------------
    if "moe" in keys:
        leaf = keys[-1]
        if leaf == "router" or leaf == "act_step":
            return ()
        if leaf.startswith("shared_"):
            dim = -1 if leaf in ("shared_up", "shared_gate") else -2
            if _fits(sizes, shape, dim, "model") and ndim >= 2:
                return _spec(ndim, {dim: "model"})
            return ()
        return _moe_spec(keys, shape, sizes)

    # ---- embedding / LM head: vocab over model -----------------------------
    if keys[-1] == "emb":
        if ndim >= 2 and _fits(sizes, shape, -2, "model"):
            return _spec(ndim, {-2: "model"})
        return ()
    if keys[-1] == "head":
        if _fits(sizes, shape, -1, "model"):
            return _spec(ndim, {-1: "model"})
        return ()

    # ---- projections (attn / dense mlp / mamba), incl. packed deploy -------
    proj = next((k for k in reversed(keys) if k in _COL_PARALLEL
                 or k in _ROW_PARALLEL), None)
    if proj is not None:
        leaf = keys[-1]
        col = proj in _COL_PARALLEL
        if leaf in ("w", "w_packed", "vr", "vc", "v", proj):
            # weight matrix (…, K[/32], N) or a same-/reduced-shape moment
            if col and _fits(sizes, shape, -1, "model"):
                return _spec(ndim, {-1: "model"})
            if not col and ndim >= 2 and _fits(sizes, shape, -2, "model"):
                return _spec(ndim, {-2: "model"})
            return ()
        if leaf in ("b", "alpha") and col and _fits(sizes, shape, -1,
                                                    "model"):
            # output-channel vectors follow the column shards
            return _spec(ndim, {-1: "model"})
        return ()

    # ---- depthwise conv / SSM channel vectors ------------------------------
    if keys[-1] in ("conv_w", "conv_b") and _fits(sizes, shape, -1, "model"):
        return _spec(ndim, {-1: "model"})

    # norms, scalar steps, A_log/D/dt_bias, step counters: replicate
    return ()


def placements(spec: tuple, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    `Shard(d)` where the spec puts that axis on tensor dim d, else
    `Replicate()` (a list: a leaf to `tree_map`)."""
    dims = {axis: d for d, axis in enumerate(spec) if axis is not None}
    return [Shard(dims[a]) if a in dims else Replicate()
            for a in axis_sizes(mesh)]


def tree_shardings(tree, cfg, mesh):
    """Every leaf of a param / optimizer tree (tensors, on ``meta`` too)
    mapped to its placements from :func:`param_spec`."""
    return tree_map_with_path(lambda p, leaf: placements(
        param_spec(p, leaf.shape, cfg, mesh), mesh), tree)


def _is_stage_stacked(shape, num_layers: int, n: int) -> bool:
    return len(shape) >= 1 and shape[0] == num_layers and num_layers % n == 0


def pipeline_tree_shardings(tree, mesh, num_layers: int,
                            axis: str = "stage"):
    """Placements for pipelined training (``launch/train.py --pipeline``):
    every layer-stacked leaf (leading dim == num_layers) shards dim 0 over
    the pipeline ``axis``, so each rank's params *and optimizer state* are
    its stage's; everything else (embed, final norm, step counters)
    replicates."""
    n = axis_sizes(mesh)[axis]
    return tree_map(lambda leaf: placements(
        (axis,) if _is_stage_stacked(leaf.shape, num_layers, n) else (),
        mesh), tree)


def stage_slice(tree, mesh, num_layers: int, axis: str = "stage"):
    """This rank's share of a one-device tree under
    `pipeline_tree_shardings`: its stage's rows of each layer-stacked leaf
    (copied, so the whole leaf can go), every other leaf as it is."""
    n, idx = axis_sizes(mesh)[axis], mesh.get_local_rank(axis)
    if n == 1:
        return tree
    lps = num_layers // n

    def one(leaf):
        if _is_stage_stacked(leaf.shape, num_layers, n):
            return leaf[idx * lps:(idx + 1) * lps].clone()
        return leaf
    return tree_map(one, tree)


def gather_stages(tree, template, mesh, num_layers: int,
                  axis: str = "stage"):
    """The one-device tree back from each rank's `stage_slice` of
    ``template`` (the one-device tree, or its shapes on ``meta``): the
    layer-stacked leaves all-gathered over ``axis``. Every rank of the axis
    calls it."""
    n = axis_sizes(mesh)[axis]
    group = mesh.get_group(axis)

    def one(leaf, like):
        if _is_stage_stacked(like.shape, num_layers, n):
            return all_gather_rows(leaf, group)
        return leaf
    return tree_map(one, tree, template)


def spec_report(tree, cfg, mesh, *, only_sharded: bool = False) -> str:
    """Human-readable leaf → spec table."""
    lines = []
    for path, leaf in tree_items(tree):
        spec = param_spec(path, tuple(leaf.shape), cfg, mesh)
        if only_sharded and all(s is None for s in spec):
            continue
        lines.append(f"{path:70s} {str(tuple(leaf.shape)):24s} {spec}")
    return "\n".join(lines)
