"""The LM training launcher: ``python -m repro_torch.launch.train --arch
<id> [...]``, counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b
        [--reduced] [--steps 100] [--seq-len 128] [--global-batch 8]
        [--microbatches 1] [--lr 3e-4] [--mode w1a8_train|float]
        [--optimizer adamw|adafactor|sgdm] [--ckpt-dir DIR] [--seed 0]
        [--pipeline none|1f1b|gpipe] [--pipeline-stages 4]
        [--grad-wire fp32|int8] [--production-mesh] [--device cpu]

Runs on the card unless ``--device cpu``. A cosine schedule with a warm-up
of steps / 20; remat on unless ``--reduced``; resume from the latest
checkpoint of ``--ckpt-dir`` (the loop checkpoints every 50 steps, at a
preemption and at the last step). Enc-dec archs get ``encoder_embeds`` and
vision archs ``prefix_embeds``, 0.1·N(0, 1) from a ``torch.Generator``
seeded by the step on the batch's device (the port's own draws, as the
sampler's are).

``--pipeline 1f1b|gpipe`` trains pipelined (`train.step.
make_pipeline_train_step`) over a (world // n, n) mesh of ('data',
'stage'), n = ``--pipeline-stages``, one rank a device, under
``torchrun``:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch
        qwen2.5-14b --reduced --pipeline 1f1b --pipeline-stages 2
        --microbatches 2 --grad-wire int8 --device cpu

The world comes from torchrun's environment (without it, one rank). The
backend is NCCL on the card and gloo with ``--device cpu``; without NCCL
the card's run raises. The global batch splits into the data ranks'
shards × ``--microbatches``; ``--grad-wire int8`` reduces the gradients
across the data ranks over `dist.collectives.tree_quantized_allreduce`.
Each rank restores or initialises the whole tree and keeps its stage's
slice (`dist.sharding.stage_slice`); rank 0 writes each checkpoint in the
one-device layout after an all-gather of the slices over 'stage', so the
one-device launcher and the reference's ``restore_checkpoint`` read it.
Adafactor is refused there: its factored moments and update clip reduce
across the layers a stage splits.

``--production-mesh`` trains the sharded model on the reference's (16,
16) mesh of ('data', 'model'), 256 ranks under ``torchrun`` (any other
world exits naming the 256 it needs): `ShardCtx(mesh, ("data",),
"model", "data")` for an MoE arch (None for the experts' axis otherwise),
`train.step.make_train_step(ctx=)`, each rank holding its block of the
params and optimizer state under `dist.sharding.tree_shardings` and
running tensor-parallel on it, restored elastically
(`resume_or_init(shardings=, mesh=)`) from a checkpoint any layout wrote,
or on a fresh start drawn a leaf at a time, the rank keeping its blocks
(`models.transformer.init_lm_params(cut=)`); rank 0 writes each
checkpoint whole after `dist.sharding.gather_tree`. It and
``--pipeline`` are separate mesh layouts; Adafactor is refused (its
factored moments reduce across a leaf's rows and columns, which the
blocks split). `train` takes any ('data', 'model') mesh, so a smaller
one drives the same branch.

Prints the loop's lines, then one JSON line: arch, steps run, first and
last loss, mean ms a step (CUDA events around each step on the card, the
host clock on the CPU; the first step, which warms up, left out), tokens
per second from it, and peak device memory on the card; pipelined, also
the world, the mesh, the schedule, the wire, the bubble fraction and the
backend; sharded, the world, the mesh and the backend. Under torchrun
only rank 0 prints.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.data import pipeline as data
from repro_torch.ckpt import save_checkpoint
from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.dist.collectives import all_reduce
from repro_torch.dist.pipeline import bubble_fraction, bubble_fraction_1f1b
from repro_torch.launch.mesh import (axis_sizes, make_pipeline_mesh,
                                     make_production_mesh)
from repro_torch.device import card_name
from repro_torch.models.transformer import (ShardCtx, count_lm_params,
                                            init_lm_params, keep_all)
from repro_torch.optim import adafactor, adamw, cosine_schedule, sgdm
from repro_torch.train.loop import StepTimer, resume_or_init, run_train
from repro_torch.train.step import make_pipeline_train_step, make_train_step

OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor, "sgdm": sgdm}
EMBED_STD = 0.1


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mode", default="w1a8_train",
                    choices=["w1a8_train", "float"])
    ap.add_argument("--optimizer", default="adamw", choices=list(OPTIMIZERS))
    ap.add_argument("--reduced", action="store_true",
                    help="tiny config (CPU-scale)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pipeline", default="none",
                    choices=["none", "gpipe", "1f1b"],
                    help="pipelined training schedule (dist/pipeline)")
    ap.add_argument("--pipeline-stages", type=int, default=4,
                    help="pipeline depth n; mesh = (ranks/n, n) over "
                         "('data', 'stage')")
    ap.add_argument("--grad-wire", default="fp32",
                    choices=["fp32", "int8"],
                    help="DP gradient all-reduce wire format "
                         "(int8 → dist/collectives.tree_quantized_allreduce)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the sharded model on the (16, 16) mesh of "
                         "('data', 'model'): 256 ranks under torchrun")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    return ap.parse_args(argv)


def stub_embeds(shape: tuple, step: int, dev: torch.device) -> torch.Tensor:
    """0.1·N(0, 1) from a generator on ``dev`` seeded by the step."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(step))
    return torch.randn(shape, generator=gen, device=dev) * EMBED_STD


def make_batch_fn(cfg, ds, dev: torch.device):
    """batch_fn(step) → tokens and labels (`data.lm_batch`) and the arch's
    stub embeddings, all on ``dev``."""
    def batch_fn(step: int) -> dict:
        tokens, labels = data.lm_batch(ds, step, device=dev)
        batch = {"tokens": tokens, "labels": labels}
        b, s = tokens.shape
        if cfg.family == "encdec":
            batch["encoder_embeds"] = stub_embeds((b, s, cfg.d_model), step,
                                                  dev)
        if cfg.frontend == "vision":
            batch["prefix_embeds"] = stub_embeds(
                (b, cfg.prefix_len, cfg.d_model), step, dev)
        return batch
    return batch_fn


def start_ranks(dev: torch.device) -> tuple:
    """(this rank's device, backend) with the default process group
    started: NCCL on the card (the rank's ``LOCAL_RANK`` card), gloo on the
    CPU; torchrun's world from its environment, else a world of one."""
    backend = "gloo"
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a mesh on the card needs NCCL, which "
                               "this torch lacks; pass --device cpu to run "
                               "gloo ranks on the CPU")
        backend = "nccl"
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if "RANK" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev, backend


PRODUCTION_RANKS = 256


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.pipeline != "none" and args.production_mesh:
        raise SystemExit("--pipeline and --production-mesh are separate "
                         "mesh layouts; pick one")
    dev = resolve_device(args.device)
    if args.production_mesh:
        if args.optimizer == "adafactor":
            raise SystemExit("--production-mesh does not support "
                             "--optimizer adafactor: its factored moments "
                             "reduce across the rows and columns a rank's "
                             "block splits")
        dev, backend = start_ranks(dev)
        try:
            world = dist.get_world_size()
            if world != PRODUCTION_RANKS:
                raise SystemExit(
                    f"--production-mesh needs {PRODUCTION_RANKS} ranks (the "
                    f"(16, 16) mesh of ('data', 'model')); this run has "
                    f"{world}: launch it under torchrun with "
                    f"{PRODUCTION_RANKS} ranks")
            return train(args, dev, make_production_mesh(device=dev),
                         backend)
        finally:
            dist.destroy_process_group()
    if args.pipeline == "none":
        return train(args, dev)
    if args.optimizer == "adafactor":
        raise SystemExit("--pipeline does not support --optimizer adafactor:"
                         " its factored moments and update clip reduce "
                         "across the layers a stage splits")
    dev, backend = start_ranks(dev)
    try:
        world, n_st = dist.get_world_size(), args.pipeline_stages
        if world % n_st:
            raise SystemExit(f"{world} devices do not split into "
                             f"{n_st} pipeline stages")
        return train(args, dev, make_pipeline_mesh(n_st, device=dev),
                     backend)
    finally:
        dist.destroy_process_group()


def train(args, dev: torch.device, mesh=None, backend=None) -> dict:
    """The run: one device, or with ``mesh`` this rank's share of a
    pipelined one (('data', 'stage')) or of the sharded model (('data',
    'model'))."""
    rank = dist.get_rank() if mesh is not None else 0
    sharded = mesh is not None and "model" in axis_sizes(mesh)

    def say(*line):
        if rank == 0:
            print(*line, flush=True)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    sched = cosine_schedule(args.lr, max(args.steps // 20, 1), args.steps)
    opt = OPTIMIZERS[args.optimizer](sched)

    def init_fn(d: torch.device, cut=keep_all) -> dict:
        """The fresh state on ``d``; with ``cut`` (`train.loop.
        block_cutter`) the rank's blocks, drawn a leaf at a time (the
        optimizers' moments start as zeros, element by element)."""
        gen = None
        if d.type != "meta":
            gen = torch.Generator(device=d)
            gen.manual_seed(args.seed)
        params = init_lm_params(
            cfg, gen, device=d,
            cut=lambda p, x, st: cut("['params']" + p, x, st))
        return {"params": params, "opt_state": opt[0](params)}

    template = init_fn(torch.device("meta"))
    loop_kw, extra, restore_kw = {}, {}, {}

    def agree(flag: bool) -> bool:
        return bool(all_reduce(torch.tensor(int(flag), device=dev), None,
                               dist.ReduceOp.MAX))
    if mesh is None:
        step_fn = make_train_step(cfg, opt, mode=args.mode,
                                  microbatches=args.microbatches,
                                  remat=not args.reduced)
    elif sharded:
        ctx = ShardCtx(mesh, ("data",), "model",
                       "data" if cfg.num_experts else None)
        step_fn = make_train_step(cfg, opt, mode=args.mode,
                                  microbatches=args.microbatches, ctx=ctx,
                                  remat=not args.reduced)
        extra = {"world": dist.get_world_size(), "mesh": axis_sizes(mesh),
                 "sharded": True,
                 "backend": backend or dist.get_backend()}
        restore_kw = {"shardings": sharding.tree_shardings(template, cfg,
                                                           mesh),
                      "mesh": mesh}

        def save(ckpt_dir, step, tree, **kw):
            whole = sharding.gather_tree(tree, template, cfg, mesh)
            if rank == 0:
                save_checkpoint(ckpt_dir, step, whole, **kw)
        loop_kw = {"save": save, "agree": agree}
    else:
        n_st, num_micro = args.pipeline_stages, max(args.microbatches, 1)
        step_fn = make_pipeline_train_step(
            cfg, opt, mesh=mesh, num_micro=num_micro, mode=args.mode,
            schedule=args.pipeline, grad_wire=args.grad_wire)
        bf = (bubble_fraction_1f1b if args.pipeline == "1f1b"
              else bubble_fraction)(n_st, num_micro)
        say(f"[pipeline] {args.pipeline} n={n_st} M={num_micro} "
            f"bubble={bf:.3f} grad-wire={args.grad_wire}")
        extra = {"world": dist.get_world_size(),
                 "mesh": {"data": dist.get_world_size() // n_st,
                          "stage": n_st},
                 "pipeline": args.pipeline, "microbatches": num_micro,
                 "grad_wire": args.grad_wire, "bubble": bf,
                 "backend": backend}

        def save(ckpt_dir, step, tree, **kw):
            whole = sharding.gather_stages(tree, template, mesh,
                                           cfg.num_layers)
            if rank == 0:
                save_checkpoint(ckpt_dir, step, whole, **kw)
        loop_kw = {"save": save, "agree": agree}

    state, start = resume_or_init(args.ckpt_dir, init_fn, device=dev,
                                  print_fn=say, **restore_kw)
    if mesh is not None and not sharded:
        state = sharding.stage_slice(state, mesh, cfg.num_layers)
    ds = data.make_lm_dataset(cfg.vocab_size, args.seq_len,
                              args.global_batch, seed=args.seed)
    timer, losses = StepTimer(dev), []

    def train_step(params, opt_state, batch):
        with timer:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(metrics["loss"])
        return params, opt_state, metrics

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _, _, end = run_train(train_step=train_step, params=state["params"],
                          opt_state=state["opt_state"],
                          batch_fn=make_batch_fn(cfg, ds, dev),
                          steps=args.steps, start_step=start,
                          ckpt_dir=args.ckpt_dir, print_fn=say, **loop_kw)
    ms = timer.ms()
    timed = ms[1:] if len(ms) > 1 else ms
    ms_step = statistics.mean(timed) if timed else None
    tokens = args.global_batch * args.seq_len
    record = {
        "arch": args.arch, "reduced": args.reduced, "mode": args.mode,
        "optimizer": args.optimizer, "device": card_name(dev),
        "params": count_lm_params(template["params"]),
        "start_step": start, "steps": end,
        "first_loss": float(losses[0]) if losses else None,
        "last_loss": float(losses[-1]) if losses else None,
        "clock": "cuda events" if dev.type == "cuda" else "host",
        "ms_per_step": ms_step,
        "tokens_per_s": tokens / (ms_step / 1e3) if ms_step else None,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None), **extra}
    say(json.dumps(record))
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
