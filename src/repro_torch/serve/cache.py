"""KV / SSM decode caches with static shapes (counterpart of
``repro/serve/cache.py``).

Layout: one cache entry per layer-slot, stacked over stages like the
params. Attention caches are **ring buffers** (stages, B, L, KV, hd) ×2
plus a ``pos`` plane recording the absolute position written at each ring
slot; L = min(max_len, sliding_window) for windowed layers. Mamba caches
are the O(1) recurrent states: the conv inputs (stages, B, W-1, C) and the
SSM state. Per-row ``lengths`` (B,) drive causal masking, so rows at
different positions coexist in one batch (continuous batching).

Every leaf under ``cache["slots"]`` carries the batch on axis 1 (after the
stage axis) and ``cache["lengths"]`` on axis 0 — `merge_rows` and
`write_rows` rely on that invariant to scatter freshly prefilled rows
into the serving pool.

Under a `ShardCtx` a rank allocates its block of each leaf by
`dist.sharding.cache_spec`, the reference's dry-run layout: its rows
(``batch`` is already the rank's), the KV heads and Mamba channels over
'model' where they divide, and for long context the KV sequence over
'data' (`sp_axis`).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.models import mamba as mb
from repro_torch.models.layers import ModelConfig
from repro_torch.models.transformer import tree_leaves, tree_map, window_of

# Unwritten ring slots carry this sentinel position: always masked out by
# the `pc <= pos` validity test in engine._attn_decode.
BIGPOS = 2 ** 30


def _attn_cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    window = window_of(cfg, kind)
    return min(max_len, window) if window else max_len


def sp_axis(ctx):
    """The axis the KV sequence splits over under ``ctx``, as the
    reference's long-context layout has it: 'data' where the batch is not
    split (``ctx.dp_axes`` empty: a batch smaller than the data ranks)
    and that axis has more than one rank; else None."""
    if ctx is None or ctx.dp_axes:
        return None
    from repro_torch.launch.mesh import axis_sizes
    return "data" if axis_sizes(ctx.mesh).get("data", 1) > 1 else None


def _block_shape(path: str, shape: tuple, cfg: ModelConfig, ctx) -> tuple:
    """The rank's block of a cache leaf of ``shape`` (its batch the
    rank's rows) under ``ctx``, by `dist.sharding.cache_spec`."""
    from repro_torch.dist.sharding import _axsize, cache_spec
    from repro_torch.launch.mesh import axis_sizes
    sizes = axis_sizes(ctx.mesh)
    dp = tuple(ctx.dp_axes)
    whole = list(shape)
    if len(whole) > 1:                               # the global batch
        whole[1] *= _axsize(sizes, dp)
    sp = sp_axis(ctx)
    spec = cache_spec(path, tuple(whole), cfg, ctx.mesh, dp=dp,
                      long_ctx=sp is not None)
    if sp is not None and ("['k']" in path or "['v']" in path) \
            and spec[2] != sp:
        raise ValueError(f"a KV sequence of {shape[2]} does not split over "
                         f"{sp!r} ({sizes[sp]} ranks)")
    for dim, entry in enumerate(spec):
        if entry is not None:
            axes = entry if isinstance(entry, tuple) else (entry,)
            whole[dim] //= _axsize(sizes, axes)
    return tuple(whole)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None, ctx=None) -> dict:
    """Cache tree: {'slots': tuple per period-slot, 'lengths': (B,)}.
    ``ctx``: a `ShardCtx`; the tree is then the rank's block of each leaf
    (``batch`` its rows)."""
    dev = resolve_device(device)
    n_stages = cfg.num_layers // cfg.period

    def shape_of(path: str, shape: tuple) -> tuple:
        return shape if ctx is None else _block_shape(path, shape, cfg, ctx)
    slots = []
    for i in range(cfg.period):
        kind = cfg.mixer_kind(i)
        if kind.startswith("attn"):
            length = _attn_cache_len(cfg, kind, max_len)
            shape = (n_stages, batch, length, cfg.num_kv_heads, cfg.hd)
            slots.append({
                "k": torch.zeros(shape_of(f"[{i}]['k']", shape),
                                 dtype=dtype, device=dev),
                "v": torch.zeros(shape_of(f"[{i}]['v']", shape),
                                 dtype=dtype, device=dev),
                "pos": torch.full(shape_of(f"[{i}]['pos']", shape[:3]),
                                  BIGPOS, dtype=torch.int32, device=dev)})
        else:
            slots.append({k: torch.zeros(
                shape_of(f"[{i}][{k!r}]", (n_stages,) + shape),
                dtype=dtype, device=dev)
                for k, shape in mb.mamba_cache_shapes(cfg, batch).items()})
    return {"slots": tuple(slots),
            "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def merge_rows(pool: dict, new: dict, rows: Sequence[int]) -> dict:
    """Scatter rows of a freshly prefilled cache into the serving pool.

    ``new`` is an init_cache/prefill cache of batch k; ``rows`` names the k
    pool rows (slots) to overwrite. Returns a new pool; ``pool`` is left as
    it was.
    """
    idx = torch.as_tensor(list(rows), dtype=torch.long,
                          device=pool["lengths"].device)

    def scatter(p, n):
        out = p.clone()
        out[:, idx] = n.to(p.dtype)
        return out

    lengths = pool["lengths"].clone()
    lengths[idx] = new["lengths"].to(lengths.dtype)
    return {"slots": tree_map(scatter, pool["slots"], new["slots"]),
            "lengths": lengths}


def write_rows(pool: dict, new: dict, rows: Sequence[int]) -> None:
    """`merge_rows` in place: the rows of ``new`` written into the pool's
    own tensors, so that a decode tick captured over them (`engine.
    capture_tick`) reads the admitted rows. ``new`` is left as it was."""
    idx = torch.as_tensor(list(rows), dtype=torch.long,
                          device=pool["lengths"].device)
    for p, n in zip(tree_leaves(pool["slots"]), tree_leaves(new["slots"])):
        p[:, idx] = n.to(p.dtype)
    pool["lengths"][idx] = new["lengths"].to(pool["lengths"].dtype)


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int,
                bytes_per_el: int = 4) -> int:
    """Elements of every cache leaf times ``bytes_per_el``, as the
    reference counts (shapes only, on ``meta``)."""
    cache = init_cache(cfg, batch, max_len, device="meta")
    return sum(int(x.numel()) * bytes_per_el for x in tree_leaves(cache))
