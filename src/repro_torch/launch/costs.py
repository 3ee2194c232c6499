"""Decomposed roofline measurement (counterpart of ``repro/launch/costs.py``).

    PYTHONPATH=src python -m repro_torch.launch.costs [--arch A] [--shape S]
        [--multi-pod | --both-meshes] [--out PATH] [--variant k=v,...]

The reference decomposes because XLA's cost analysis counts a scan body
once. The port traces the same repeating units, on rank 0 of the
production mesh in the fake world of `launch.dryrun` (every tensor on
``meta``, every collective on the ``fake`` backend), and assembles them by
their trip counts:

  train:   microbatches × [ stages × C(stage fwd+bwd) + C(top fwd+bwd) ]
           + C(optimizer update)   (+ the encoder's stages for enc-dec)
  prefill: stages × C(stage fwd) + C(top fwd)   (+ encoder stages)
  decode:  stages × C(decode stage) + C(top fwd)

A unit is the port's own code (`models.transformer.apply_stage`,
`serve.engine.decode_stage`, the embedding, final norm, LM head and loss
of `train.step.lm_loss`) on the rank's layout: its block of every leaf
and of the cache, its rows of the batch. The port's Python loop over
stages counts every stage, so the assembled FLOPs by dtype equal a
whole-step trace (`launch.dryrun.run_cell`) but for remat's recompute,
which the units measure apart (``remat_flops``: each stage's forward run
once more under ``torch.utils.checkpoint``, which stops once it has
recomputed what the backward needs). Collectives and bytes of the
whole train step hold more than the units: the sharded step's gradient
sums and the microbatch slicing.

The record and its ``roofline`` block are the reference's, on the H100
terms of `launch.dryrun.roofline_terms`, with the whole step's
``memory``, ``fits`` and ``reference_layout_bytes`` copied from the dry
run's record of the cell (``--dryrun``, run that first); ``roofline_fraction`` is against
the bf16 peak, as the reference's is. Variant knobs: ``microbatches``,
``packed``, ``a2a_quant``, ``cache_seq_shard`` and the `ModelConfig`
fields the reference tunes where the port's config has them
(``flash_block``, ``pad_heads_to``, ``capacity_factor``, ``flat_head``);
any other raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os

import torch

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, skip_reason
from repro_torch.device import full_f32
from repro_torch.dist import sharding
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.models.layers import embed, norm, unembed
from repro_torch.models.transformer import (apply_stage, encoder_stage,
                                            stage, tp_of, tree_leaves,
                                            tree_map)

KNOBS = ("microbatches", "packed", "a2a_quant", "cache_seq_shard")
# what a record takes from the dry run's record of its cell: the units
# hold no whole step's memory
WHOLE_STEP = ("memory", "fits", "reference_layout_bytes")
CFG_KNOBS = {"flash_block": "flash_block", "pad_heads_to": "pad_heads_to",
             "capacity_factor": "capacity_factor",
             "flat_head": "flat_head_attn"}


def _unit(counter: dr.Counter) -> dict:
    return {"flops": float(sum(counter.flops.values())),
            "flops_by_dtype": dict(sorted(counter.flops.items())),
            "bytes": float(counter.bytes),
            "coll": counter.collective_summary()}


def _scale(unit: dict, trips: int) -> dict:
    coll = {k: (v * trips if isinstance(v, (int, float)) else v)
            for k, v in unit["coll"].items() if k in dr.KINDS}
    groups = [dict(g, bytes=g["bytes"] * trips, count=g["count"] * trips)
              for g in unit["coll"].get("groups", [])]
    return {"flops": unit["flops"] * trips,
            "flops_by_dtype": {k: v * trips
                               for k, v in unit["flops_by_dtype"].items()},
            "bytes": unit["bytes"] * trips,
            "coll": dict(coll, groups=groups)}


def _merge(parts) -> dict:
    tot = {"flops": 0.0, "flops_by_dtype": {}, "bytes": 0.0,
           "coll": {k: 0 for k in dr.KINDS}}
    groups = []
    for p in parts:
        tot["flops"] += p["flops"]
        for k, v in p.get("flops_by_dtype", {}).items():
            tot["flops_by_dtype"][k] = tot["flops_by_dtype"].get(k, 0) + v
        tot["bytes"] += p["bytes"]
        for k in dr.KINDS:
            tot["coll"][k] += p["coll"].get(k, 0)
        groups += p["coll"].get("groups", [])
    tot["coll"]["groups"] = groups
    return tot


def analytic_bytes(cfg, spec, params_sds, n_chips, *,
                   microbatches: int = 8,
                   cache_seq_shard: bool = False,
                   model_axis: int = 16) -> float:
    """Per-device HBM traffic model (fused-execution napkin roofline), the
    reference's.

    train:   3 weight passes/microbatch (fwd, remat-fwd, bwd) + grad
             accumulation r/w (f32) + optimizer state r/w + residual-stream
             activations at stage boundaries (×4 traversals).
    prefill: 1 weight pass + activations.
    decode:  1 weight pass + KV/SSM cache read+write (with packed W1A8 the
             weight pass is 1 bit/weight).
    ``params_sds``: the cell's param tree (tensors; on ``meta`` or fake).
    ``model_axis``: the 'model' axis's size (16 in both production meshes,
    the reference's constant; 1 for one device).
    """
    leaves = tree_leaves(params_sds)
    p_bytes = sum(int(math.prod(l.shape)) * l.element_size()
                  for l in leaves) / n_chips
    p_count = sum(int(math.prod(l.shape)) for l in leaves) / n_chips
    d = cfg.d_model
    act_bytes = 2  # bf16 residual stream
    stages = cfg.num_layers // cfg.period
    if spec.kind == "train":
        # tokens shard over dp axes only (model axis = 16 in both meshes)
        tok_pd = spec.global_batch * spec.seq_len / (n_chips / model_axis)
        weights = 3 * microbatches * p_bytes
        grads = 2 * microbatches * p_count * 4
        opt = 5 * p_count * 4
        acts = 4 * stages * tok_pd * d * act_bytes
        return weights + grads + opt + acts
    if spec.kind == "prefill":
        tok_pd = spec.global_batch * spec.seq_len / (n_chips / model_axis)
        return p_bytes + 4 * stages * tok_pd * d * act_bytes
    # decode
    from repro_torch.serve.cache import init_cache
    cache = init_cache(cfg, spec.global_batch, spec.seq_len,
                       dtype=torch.bfloat16, device="meta")
    c_total = sum(int(math.prod(l.shape)) * l.element_size()
                  for l in tree_leaves(cache))
    # cache shards over dp (batch) when divisible, else over data (seq);
    # kv-head dim additionally over model when divisible.
    dp_size = n_chips / model_axis              # data(+pod) axes
    kv_shard = model_axis if (cfg.num_kv_heads % model_axis == 0
                              or cache_seq_shard) else 1
    c_pd = c_total / min(dp_size * kv_shard, n_chips)
    return p_bytes + 2 * c_pd


def variant_config(cfg, variant: dict):
    """``cfg`` with the variant's config knobs; raises on an unknown knob
    or one the port's `ModelConfig` lacks."""
    fields = {f.name for f in dataclasses.fields(cfg)}
    updates = {}
    for key, value in variant.items():
        if key in KNOBS:
            continue
        field = CFG_KNOBS.get(key)
        if field is None or field not in fields:
            raise ValueError(f"variant knob {key!r} has no counterpart in "
                             f"the port")
        updates[field] = value
    return dataclasses.replace(cfg, **updates) if updates else cfg


def _trace_unit(fn) -> dict:
    """One unit's counts: ``fn()`` under a `launch.dryrun.Counter`."""
    counter = dr.Counter()
    with counter:
        fn()
    return _unit(counter)


def _leaf_grads(fn, leaves: list, *inputs):
    """fn(*inputs)'s VJP with a ones cotangent, w.r.t. ``leaves`` and the
    float inputs, under autograd and in full f32 (as `train.step`)."""
    with torch.enable_grad(), full_f32():
        out = fn(*inputs)
        wrt = leaves + [x for x in inputs
                        if isinstance(x, torch.Tensor) and x.requires_grad]
        return torch.autograd.grad(out, wrt, torch.ones_like(out),
                                   allow_unused=True)


def _requires_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(
        t.is_floating_point()), tree)


def _float_leaves(tree) -> list:
    return [t for t in tree_leaves(tree) if t.requires_grad]


def _top_fn(cfg, tokens_len: int, loss: bool, tp=None):
    """Embedding (with the vision prefix) → final norm → LM head, and in
    train the loss of `train.step.lm_loss` (``tp``: the rank's plan)."""
    from repro_torch.train.step import token_loss

    def top(embed_p, norm_p, tokens, labels, prefix):
        x = embed(embed_p, tokens, tp)
        if prefix is not None:
            x = torch.cat([prefix.to(x.dtype), x], dim=1)
        logits = unembed(embed_p, cfg, norm(norm_p, x, cfg.norm_kind), tp)
        if not loss:
            return logits
        return token_loss(logits[:, -tokens_len:, :], labels, tp)
    return top


def measure_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                 microbatches: int = 8, variant: dict = None) -> dict:
    """The decomposed record of one cell on rank 0 of the production
    mesh (see the module's docstring)."""
    variant = dict(variant or {})
    microbatches = variant.get("microbatches", microbatches)
    cfg = variant_config(configs.get_config(arch), variant)
    spec = SHAPES[shape_name]
    n_chips = 512 if multi_pod else 256
    rec = {"arch": arch, "shape": shape_name, "mesh": dr.mesh_name(multi_pod),
           "hw": HW["name"]}
    skip = skip_reason(arch, shape_name)
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec
    if spec.kind == "train":
        rec["pipeline_bubble"] = dr.pipeline_bubble_record(
            cfg, microbatches=microbatches)
    with dr.fake_world(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        total, parts, params = _units(arch, cfg, spec, mesh, microbatches,
                                      variant)
    rec["parts"] = parts
    cw = dr.wire_bytes(total["coll"], n_chips)
    ana = analytic_bytes(cfg, spec, params, n_chips,
                         microbatches=microbatches,
                         cache_seq_shard=variant.get("cache_seq_shard",
                                                     False))
    rec["totals"] = {"flops_per_device": total["flops"],
                     "flops_by_dtype": total["flops_by_dtype"],
                     "bytes_per_device_measured_unfused": total["bytes"],
                     "bytes_per_device_analytic": ana,
                     "collective_wire_bytes": cw,
                     "collectives": {k: total["coll"][k] for k in dr.KINDS}}
    terms = dr.roofline_terms(total["flops_by_dtype"], ana,
                              dr.collective_seconds(total["coll"]["groups"]),
                              total["bytes"])
    t_comp, t_mem, t_coll = (terms["t_compute_s"], terms["t_memory_s"],
                             terms["t_collective_s"])
    bound = max(t_comp, t_mem, t_coll)
    mf = dr.model_flops(arch, shape_name) / n_chips
    rec["roofline"] = dict(
        terms, model_flops_per_device=mf,
        useful_flops_ratio=mf / total["flops"] if total["flops"] else None,
        step_time_bound_s=bound,
        roofline_fraction=(mf / HW["peak_flops_bf16"]) / bound
        if bound > 0 else None)
    rec["status"] = "ok"
    return rec


def _units(arch, cfg, spec, mesh, microbatches: int, variant: dict,
           dev=dr.META) -> tuple:
    """(assembled totals, parts, the param tree analytic_bytes reads) of
    one cell, its tensors on ``dev`` (``meta``, or a fake mode's device
    under the mode the caller entered)."""
    dp = sharding.dp_axes(mesh)
    long_ctx = spec.global_batch < dr._axsize(mesh, dp)
    ctx = dr.make_ctx(cfg, mesh, () if long_ctx else dp,
                      bool(variant.get("a2a_quant", False)))
    rows = spec.global_batch // dr._axsize(mesh, ctx.dp_axes)
    stages = cfg.num_layers // cfg.period
    train = spec.kind == "train"
    dtype = torch.float32 if train and arch not in dr.BIG else torch.bfloat16
    whole = dr._params(cfg, dtype, packed=not train and
                       variant.get("packed", True), device=dev)
    tree = dr.rank_tree(whole, cfg, mesh)
    slots = stage(tree["slots"], 0)
    cross = stage(tree["cross"], 0) if "cross" in tree else None
    inputs = dr.batch_specs(cfg, spec)
    toks = inputs["tokens"].shape[1]
    s_total = spec.seq_len if spec.kind != "decode" else 1
    b = rows // microbatches if train else rows
    mode = "w1a8_train" if train else "w1a8_eval"
    positions = torch.arange(s_total, device=dev).expand(b, s_total)
    x = torch.zeros((b, s_total, cfg.d_model), dtype=dtype, device=dev)
    enc = None
    if "encoder_embeds" in inputs:
        enc = torch.zeros((b, inputs["encoder_embeds"].shape[1],
                           cfg.d_model), dtype=dtype, device=dev)
    prefix = None
    if "prefix_embeds" in inputs:
        prefix = torch.zeros((b, cfg.prefix_len, cfg.d_model),
                             dtype=torch.float32, device=dev)
    tokens = torch.zeros((b, toks if spec.kind != "decode" else 1),
                         dtype=torch.int32, device=dev)
    top = _top_fn(cfg, toks, loss=train, tp=tp_of(ctx, cfg))
    parts, scaled = {}, []

    def stage_fwd(sl, x_, enc_):
        return apply_stage(cfg, sl, x_, mode=mode, positions=positions,
                           ctx=ctx, cross=cross, enc_out=enc_)

    if train:
        sl = _requires_grad(slots)
        cross = None if cross is None else _requires_grad(cross)
        leaves = _float_leaves(sl) + ([] if cross is None
                                      else _float_leaves(cross))
        xg = x.requires_grad_(True)
        eg = None if enc is None else enc.requires_grad_(True)

        def remat(sl_, x_, enc_):
            return torch.utils.checkpoint.checkpoint(
                stage_fwd, sl_, x_, enc_, use_reentrant=False,
                preserve_rng_state=False)
        c_stage = _trace_unit(lambda: _leaf_grads(stage_fwd, leaves, sl, xg,
                                                  eg))
        c_remat = _trace_unit(lambda: _leaf_grads(remat, leaves, sl, xg, eg))
        ep = _requires_grad(tree["embed"])
        npar = _requires_grad(tree["final_norm"])
        c_top = _trace_unit(lambda: _leaf_grads(
            lambda: top(ep, npar, tokens, tokens, prefix),
            _float_leaves(ep) + _float_leaves(npar)))
        from repro_torch.optim import adafactor, adamw
        opt = adafactor(1e-3) if arch in dr.BIG else adamw(1e-3)
        p_rank = sharding.shard_tree(whole, cfg, mesh)
        o_rank = opt[0](p_rank)
        g_rank = tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32)
                          if t.is_floating_point() else t, p_rank)
        c_opt = _trace_unit(lambda: opt[1](g_rank, o_rank, p_rank))
        trips = stages * microbatches
        parts = {"stage_fwdbwd": c_stage, "top_fwdbwd": c_top,
                 "optimizer": c_opt,
                 "trips": {"stage": trips, "top": microbatches}}
        scaled = [_scale(c_stage, trips), _scale(c_top, microbatches), c_opt]
        recompute = {k: (v - c_stage["flops_by_dtype"].get(k, 0)) * trips
                     for k, v in c_remat["flops_by_dtype"].items()}
        parts["remat_flops"] = {k: v for k, v in recompute.items() if v}
        if enc is not None:
            enc_slot = _requires_grad(stage(tree["encoder"]["slots"][0], 0))
            c_enc = _trace_unit(lambda: _leaf_grads(
                lambda e: encoder_stage(cfg, enc_slot, e, mode=mode,
                                        positions=_pos(e),
                                        tp=tp_of(ctx, cfg)),
                _float_leaves(enc_slot), eg))
            parts["encoder_fwdbwd"] = c_enc
            parts["trips"]["encoder"] = cfg.encoder_layers * microbatches
            scaled.append(_scale(c_enc, parts["trips"]["encoder"]))
        params = dr.param_shapes(cfg, dtype)
    elif spec.kind == "prefill":
        with torch.no_grad():
            c_stage = _trace_unit(lambda: stage_fwd(slots, x, enc))
            c_top = _trace_unit(lambda: top(tree["embed"],
                                            tree["final_norm"], tokens,
                                            None, prefix))
            parts = {"stage_fwd": c_stage, "top_fwd": c_top,
                     "trips": {"stage": stages}}
            scaled = [_scale(c_stage, stages), c_top]
            if enc is not None:
                enc_slot = stage(tree["encoder"]["slots"][0], 0)
                c_enc = _trace_unit(lambda: encoder_stage(
                    cfg, enc_slot, enc, mode=mode, positions=_pos(enc),
                    tp=tp_of(ctx, cfg)))
                parts["encoder_fwd"] = c_enc
                parts["trips"]["encoder"] = cfg.encoder_layers
                scaled.append(_scale(c_enc, cfg.encoder_layers))
        params = whole
    else:
        from repro_torch.serve.cache import init_cache
        from repro_torch.serve.engine import decode_stage
        cache = init_cache(cfg, rows, spec.seq_len, dtype=torch.bfloat16,
                           device=dev, ctx=ctx)
        pos = cache["lengths"]
        with torch.no_grad():
            c_stage = _trace_unit(lambda: decode_stage(
                cfg, slots, cache["slots"], 0, x, pos, mode=mode, ctx=ctx))
            c_top = _trace_unit(lambda: top(tree["embed"],
                                            tree["final_norm"], tokens,
                                            None, None))
        parts = {"stage_decode": c_stage, "top_fwd": c_top,
                 "trips": {"stage": stages}}
        scaled = [_scale(c_stage, stages), c_top]
        params = whole
    return _merge(scaled), parts, params


def _pos(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def parse_variant(text: str) -> dict:
    variant = {}
    for kv in (text or "").split(","):
        if not kv:
            continue
        k, v = kv.split("=")
        if v.lower() in ("true", "false"):
            variant[k] = v.lower() == "true"
        else:
            variant[k] = float(v) if "." in v else int(v)
    return variant


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=os.path.join(dr.RESULTS_DIR,
                                                  "costs.json"))
    ap.add_argument("--variant", default=None,
                    help="k=v[,k=v] knobs, e.g. microbatches=4")
    ap.add_argument("--dryrun", default=os.path.join(dr.RESULTS_DIR,
                                                     "dryrun.json"),
                    help="the dry run whose whole-step memory, fits and "
                         "reference layout each record carries")
    args = ap.parse_args(argv)
    variant = parse_variant(args.variant)
    whole = {}
    if os.path.exists(args.dryrun):
        with open(args.dryrun) as f:
            whole = {(r["arch"], r["shape"], r["mesh"]): r
                     for r in json.load(f) if r.get("status") == "ok"}
    archs = list(configs.ARCH_NAMES) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    def run(arch, shape, *, multi_pod):
        rec = measure_cell(arch, shape, multi_pod=multi_pod, variant=variant)
        if variant:
            rec["variant"] = variant
        step = whole.get((arch, shape, rec["mesh"]))
        if step is not None and not variant:
            rec.update({k: step[k] for k in WHOLE_STEP})
        return rec
    results = dr.run_matrix(run, archs, shapes, meshes, args.out, "cost ")
    return 1 if any(r.get("status") == "error" for r in results) else 0


if __name__ == "__main__":
    raise SystemExit(main())
