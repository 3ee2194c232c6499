"""The LM training launcher: ``python -m repro_torch.launch.train --arch
<id> [...]``, counterpart of ``repro/launch/train.py`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b
        [--reduced] [--steps 100] [--seq-len 128] [--global-batch 8]
        [--microbatches 1] [--lr 3e-4] [--mode w1a8_train|float]
        [--optimizer adamw|adafactor|sgdm] [--ckpt-dir DIR] [--seed 0]
        [--device cpu]

Runs on the card unless ``--device cpu``. A cosine schedule with a warm-up
of steps / 20; remat on unless ``--reduced``; resume from the latest
checkpoint of ``--ckpt-dir`` (the loop checkpoints every 50 steps, at a
preemption and at the last step). Enc-dec archs get ``encoder_embeds`` and
vision archs ``prefix_embeds``, 0.1·N(0, 1) from a ``torch.Generator``
seeded by the step on the batch's device (the port's own draws, as the
sampler's are). The reference's mesh flags (``--production-mesh``,
``--pipeline``, ``--pipeline-stages``, ``--grad-wire``) wait for the
distribution layer (ROADMAP.md, Queue 1, item 6) and are not defined.

Prints the loop's lines, then one JSON line: arch, steps run, first and
last loss, mean ms a step (CUDA events around each step on the card, the
host clock on the CPU; the first step, which warms up, left out), tokens
per second from it, and peak device memory on the card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from repro_torch import configs
from repro_torch.data import pipeline as data
from repro_torch.device import resolve_device
from repro_torch.launch.serve import card_name
from repro_torch.models.transformer import count_lm_params, init_lm_params
from repro_torch.optim import adafactor, adamw, cosine_schedule, sgdm
from repro_torch.train.loop import StepTimer, resume_or_init, run_train
from repro_torch.train.step import make_train_step

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


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    sched = cosine_schedule(args.lr, max(args.steps // 20, 1), args.steps)
    opt = OPTIMIZERS[args.optimizer](sched)
    step_fn = make_train_step(cfg, opt, mode=args.mode,
                              microbatches=args.microbatches,
                              remat=not args.reduced)

    def init_fn(d: torch.device) -> dict:
        gen = None
        if d.type != "meta":
            gen = torch.Generator(device=d)
            gen.manual_seed(args.seed)
        params = init_lm_params(cfg, gen, device=d)
        return {"params": params, "opt_state": opt[0](params)}

    state, start = resume_or_init(args.ckpt_dir, init_fn, device=dev)
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
                          ckpt_dir=args.ckpt_dir)
    ms = timer.ms()
    timed = ms[1:] if len(ms) > 1 else ms
    ms_step = statistics.mean(timed) if timed else None
    tokens = args.global_batch * args.seq_len
    record = {
        "arch": args.arch, "reduced": args.reduced, "mode": args.mode,
        "optimizer": args.optimizer, "device": card_name(dev),
        "params": count_lm_params(state["params"]),
        "start_step": start, "steps": end,
        "first_loss": float(losses[0]) if losses else None,
        "last_loss": float(losses[-1]) if losses else None,
        "clock": "cuda events" if dev.type == "cuda" else "host",
        "ms_per_step": ms_step,
        "tokens_per_s": tokens / (ms_step / 1e3) if ms_step else None,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
