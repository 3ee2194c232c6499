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

A rank holds its block of each leaf (`shard_tree`, which reads only that
block of a numpy memmap); `gather_tree` all-gathers the blocks back into
the whole tree. `tp_plan` reads the same rules as the layers' plan: each
projection runs column-split, row-split or whole on the rank's block as
``param_spec`` lays its weight out, attention on a head range, the
embedding and head on a vocabulary block (`models.layers`).
`moe_in_layout` re-lays one MoE layer's held leaves to
the reference's ``shard_map`` ``in_specs`` where the two differ.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Optional

import numpy as np
from torch.distributed.tensor import Replicate, Shard

from repro_torch.core.packing import packed_dim
from repro_torch.dist.collectives import all_gather_rows, group_rank
from repro_torch.launch.mesh import axis_sizes
from repro_torch.optim.optimizers import (tree_items, tree_map,
                                          tree_map_with_path)

# leaf names of column-parallel projections (shard output dim over model)
_COL_PARALLEL = ("wq", "wk", "wv", "up", "gate", "in_proj", "x_proj",
                 "dt_proj", "shared_up", "shared_gate")
# leaf names of row-parallel projections (shard contraction dim over model)
ROW_PARALLEL = ("wo", "down", "out_proj", "shared_down")

_KEY_RE = re.compile(r"\['([^']+)'\]")


def path_keys(path: str) -> list:
    """The dict keys of a leaf path, outermost first."""
    return _KEY_RE.findall(path)


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
    keys = path_keys(path)
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
                 or k in ROW_PARALLEL), None)
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


def _axsize(sizes: dict, axes) -> int:
    return int(np.prod([sizes[a] for a in axes])) if axes else 1


def cache_spec(path: str, shape, cfg, mesh, *, dp: tuple, long_ctx: bool,
               seq_shard_fallback: bool = False) -> tuple:
    """The spec of one KV / SSM cache leaf (`serve.cache.init_cache`'s
    tree), the reference's dry-run layout (``_cache_shardings``): the batch
    over ``dp`` where it divides; for long context (a batch smaller than
    the dp size) the KV sequence over 'data' (SP); KV heads, conv and SSM
    channels over 'model' where they divide. ``seq_shard_fallback``
    shards the KV sequence over 'model' where the KV heads do not split.
    Entries are an axis name, a tuple of them, or None, trailing Nones
    kept; like `param_spec` it reads only the mesh's axis names and
    sizes."""
    sizes = axis_sizes(mesh)
    model = "model"
    if "lengths" in path:
        return ()
    dp = tuple(dp)
    batch_ok = bool(dp) and shape[1] % _axsize(sizes, dp) == 0
    bspec = dp if batch_ok else None
    if "['k']" in path or "['v']" in path:             # (st, B, L, KV, hd)
        seq = "data" if (long_ctx and shape[2] % sizes["data"] == 0
                         and not batch_ok) else None
        kvs = model if shape[3] % sizes[model] == 0 else None
        if kvs is None and seq is None and seq_shard_fallback and \
                shape[2] % sizes[model] == 0:
            seq = model
        return (None, bspec, seq, kvs, None)
    if "['pos']" in path:                               # (st, B, L)
        seq = "data" if (long_ctx and shape[2] % sizes["data"] == 0
                         and not batch_ok) else None
        kvs_possible = cfg.num_kv_heads % sizes[model] == 0
        if not kvs_possible and seq is None and seq_shard_fallback and \
                shape[2] % sizes[model] == 0:
            seq = model
        return (None, bspec, seq)
    if "conv" in path:                                  # (st, B, W-1, C)
        c = model if shape[-1] % sizes[model] == 0 else None
        return (None, bspec, None, c)
    if "ssm" in path:                       # (st, B, H, P, N) | (st, B, C, N)
        c = model if shape[2] % sizes[model] == 0 else None
        return tuple([None, bspec, c] + [None] * (len(shape) - 3))
    return ()


class _Sizes:
    """A shape-only mesh of {axis: size} (`launch.mesh.axis_sizes`)."""

    def __init__(self, sizes: tuple):
        self.axis_names = tuple(a for a, _ in sizes)
        self.shape = dict(sizes)


@functools.lru_cache(maxsize=None)
def _model_split(cfg, sizes: tuple, path: str, shape: tuple) -> bool:
    return "model" in param_spec(path, shape, cfg, _Sizes(sizes))


@dataclasses.dataclass(frozen=True)
class Proj:
    """How one projection runs on a rank: ``kind`` is 'col' (the weight
    and product hold the rank's block of the output columns), 'row' (the
    rank's block of the contraction dim; the partial products summed over
    the plan's group) or 'whole'; ``k`` is the whole contraction dim;
    ``plan`` the `TPPlan` it belongs to."""
    kind: str
    k: int
    plan: "TPPlan"


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """One rank's tensor-parallel plan over the mesh axis ``axis`` (size
    ``n``, this rank ``rank``): every answer is `param_spec`'s layout of
    the leaf at its whole shape, so the layers run on the blocks the rank
    holds. Attention's query heads split into ranges of ⌊H/n⌋ or ⌈H/n⌉
    (`heads`); a projection whose column blocks do not fall on whole heads
    has its product gathered first (`layers.head_block`). Each
    projection's `Proj` is worked out once."""
    cfg: Any
    sizes: tuple
    axis: str
    group: Any
    n: int
    rank: int
    _projs: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    def split(self, path: str, shape: tuple) -> bool:
        """Whether ``param_spec`` puts the axis on the leaf at ``path``
        (at n = 1 too: the plan's split paths then run on whole blocks)."""
        return _model_split(self.cfg, self.sizes, path, tuple(shape))

    def proj(self, name: str, k: int, n_out: int,
             packed: bool = False) -> Proj:
        """The plan of projection ``name`` with a whole (k, n_out)
        weight (sign words (⌈k/32⌉, n_out) where ``packed``)."""
        key = (name, k, n_out, packed)
        got = self._projs.get(key)
        if got is None:
            leaf, shape = (("w_packed", (packed_dim(k), n_out)) if packed
                           else ("w", (k, n_out)))
            kind = "whole"
            if self.split(f"[{name!r}][{leaf!r}]", shape):
                kind = "col" if name in _COL_PARALLEL else "row"
            got = self._projs[key] = Proj(kind, k, self)
        return got

    def heads(self, h: int) -> tuple:
        """This rank's query heads [h0, h1) of ``h``: an even block where
        the axis divides ``h``, else ⌊h/n⌋ or ⌈h/n⌉ of them."""
        return self.rank * h // self.n, (self.rank + 1) * h // self.n

    def block(self, size: int) -> tuple:
        """This rank's even block [a, b) of a dim of ``size``."""
        m = size // self.n
        return self.rank * m, (self.rank + 1) * m

    def vocab(self) -> Optional[tuple]:
        """This rank's rows [v0, v1) of the embedding, or None where it
        is whole (`param_spec` of ``emb``; ``head``, untied, splits
        alike)."""
        cfg = self.cfg
        if not self.split("['emb']", (cfg.vocab_size, cfg.d_model)):
            return None
        return self.block(cfg.vocab_size)


def tp_plan(cfg, mesh, axis: str = "model") -> TPPlan:
    """This rank's `TPPlan` over ``axis`` of ``mesh``."""
    sizes = axis_sizes(mesh)
    group = mesh.get_group(axis)
    return TPPlan(cfg, tuple(sizes.items()), axis, group, sizes[axis],
                  group_rank(group))


def spec_block_bytes(spec: tuple, shape, itemsize: int, mesh) -> int:
    """The bytes of one rank's block of a leaf under ``spec`` (entries an
    axis name, a tuple of them, or None)."""
    sizes = axis_sizes(mesh)
    n = int(np.prod(shape)) if len(shape) else 1
    for entry in spec:
        if entry is not None:
            n //= _axsize(sizes, entry if isinstance(entry, tuple)
                          else (entry,))
    return n * itemsize


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


def full_spec(spec: tuple, ndim: int) -> tuple:
    """``spec`` with the trailing Nones it drops put back."""
    return tuple(spec) + (None,) * (ndim - len(spec))


def block(leaf, dim: int, axis: str, mesh):
    """This rank's block of ``leaf`` along ``dim`` split over ``axis``."""
    n = leaf.shape[dim] // axis_sizes(mesh)[axis]
    r = mesh.get_local_rank(axis)
    idx = [slice(None)] * leaf.ndim
    idx[dim] = slice(r * n, (r + 1) * n)
    return leaf[tuple(idx)]


def gather_dim(x, dim: int, axis: str, mesh):
    """The blocks of ``x`` along ``dim`` all-gathered over ``axis``."""
    if axis_sizes(mesh)[axis] == 1:
        return x
    out = all_gather_rows(x.movedim(dim, 0), mesh.get_group(axis))
    return out.movedim(0, dim).contiguous()


def gather_leaf(x, spec: tuple, mesh):
    """The whole leaf from this rank's block under ``spec``; every rank of
    the spec's axes calls it."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = gather_dim(x, dim, axis, mesh)
    return x


def tree_specs(template, cfg, mesh) -> dict:
    """{leaf path: its `param_spec`, full length} from a tree of whole
    leaves (tensors, or their shapes on ``meta``)."""
    return {p: full_spec(param_spec(p, tuple(leaf.shape), cfg, mesh),
                         leaf.ndim) for p, leaf in tree_items(template)}


def placement_block(leaf, pls: list, mesh):
    """This rank's block of a whole leaf under its placements (one
    `Shard` or `Replicate` a mesh dim; a view)."""
    for axis, pl in zip(axis_sizes(mesh), pls):
        if isinstance(pl, Shard):
            leaf = block(leaf, pl.dim, axis, mesh)
    return leaf


def shard_by(tree, shardings, mesh):
    """This rank's block of every leaf of ``tree`` under ``shardings`` (a
    tree of placements, `tree_shardings`'): a copy, so the whole leaf can
    go, or the leaf itself where the block is all of it. A numpy leaf (a
    memmap of a checkpoint's array) gives a numpy copy of the block alone,
    which is all that is read."""
    def one(leaf, pls):
        part = placement_block(leaf, pls, mesh)
        if part.shape == leaf.shape:
            return leaf
        return np.array(part) if isinstance(part, np.ndarray) \
            else part.clone()
    return tree_map(one, tree, shardings)


def shard_tree(tree, cfg, mesh):
    """`shard_by` under `tree_shardings`."""
    return shard_by(tree, tree_shardings(tree, cfg, mesh), mesh)


def gather_tree(tree, template, cfg, mesh):
    """The whole tree back from each rank's `shard_tree` of ``template``
    (the whole tree, or its shapes on ``meta``). Every rank calls it."""
    specs = tree_specs(template, cfg, mesh)
    return tree_map_with_path(lambda p, leaf: gather_leaf(leaf, specs[p],
                                                          mesh), tree)


def _moe_whole_shape(cfg, name: str) -> tuple:
    """A one-stage MoE leaf's whole shape."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    fs = f * cfg.shared_experts
    return {"router": (d, e), "act_step": (),
            "up": (e, d, f), "gate": (e, d, f), "down": (e, f, d),
            "up_packed": (e, packed_dim(d), f),
            "gate_packed": (e, packed_dim(d), f),
            "down_packed": (e, packed_dim(f), d),
            "up_alpha": (e, 1, f), "gate_alpha": (e, 1, f),
            "down_alpha": (e, 1, d),
            "shared_up": (d, fs), "shared_gate": (d, fs),
            "shared_down": (fs, d)}[name]


def _moe_in_spec(name: str, ep, tp, tp_sh) -> tuple:
    """The reference's ``_apply_moe`` ``in_specs`` of one leaf."""
    if name in ("up", "gate", "up_packed", "gate_packed", "up_alpha",
                "gate_alpha"):
        return (ep, None, tp)
    if name in ("down", "down_packed"):
        return (ep, tp, None)
    if name == "down_alpha":
        return (ep, None, None)
    if name in ("shared_up", "shared_gate"):
        return (None, tp_sh)
    if name == "shared_down":
        return (tp_sh, None)
    return ()                                 # router, act_step: whole


def moe_in_layout(slot_moe: dict, cfg, mesh, ep, tp, tp_sh) -> dict:
    """One MoE layer's leaves as this rank holds them (`tree_shardings`)
    re-laid to the reference's ``in_specs`` for ep / tp / tp_sh (axis
    names or None, `models.transformer.moe_axes`): a dim held split and
    wanted whole is all-gathered, one held whole and wanted split is cut
    to this rank's block. Reduced mixtral packed at |model| = 2 splits
    ``up_packed``'s F but not ``down_packed``'s 3 words, so the layer runs
    with F whole and ``up_packed`` is gathered. Float and QAT leaves
    always agree (their F splits wherever d_ff does): the gather has no
    gradient, and a leaf that needs one raises."""
    out = {}
    for name, leaf in slot_moe.items():
        shape = _moe_whole_shape(cfg, name)
        held = full_spec(param_spec(f"['moe'][{name!r}]", shape, cfg, mesh),
                         len(shape))
        want = full_spec(_moe_in_spec(name, ep, tp, tp_sh), len(shape))
        for dim, (h, w) in enumerate(zip(held, want)):
            if h == w:
                continue
            if h is not None:
                if leaf.requires_grad:
                    raise NotImplementedError(
                        f"MoE leaf {name} held split over {h} and run whole"
                        f": the gather has no gradient")
                leaf = gather_dim(leaf, dim, h, mesh)
            if w is not None:
                leaf = block(leaf, dim, w, mesh)
        out[name] = leaf
    return out


def spec_report(tree, cfg, mesh, *, only_sharded: bool = False) -> str:
    """Human-readable leaf → spec table."""
    lines = []
    for path, leaf in tree_items(tree):
        spec = param_spec(path, tuple(leaf.shape), cfg, mesh)
        if only_sharded and all(s is None for s in spec):
            continue
        lines.append(f"{path:70s} {str(tuple(leaf.shape)):24s} {spec}")
    return "\n".join(lines)
