"""LM QAT training with checkpoint and restart: the fault-tolerance loop,
end to end. Port-owned counterpart of ``examples/train_lm_w1a8.py``.

    PYTHONPATH=src python -m repro_torch.launch.train_lm_w1a8
        [--arch chatglm3-6b] [--steps 40] [--ckpt-dir DIR] [--device cpu]

Trains a reduced W1A8 LM (AdamW, cosine schedule from 3e-3, microbatches 2,
8 sequences of 16 tokens a step), drops the ``PREEMPT`` sentinel half-way so
that the loop checkpoints and stops, restores that checkpoint and finishes
from it. Runs on the card unless ``--device cpu``; the checkpoints go to a
temporary directory unless ``--ckpt-dir``. Prints the example's lines, then
one JSON line: the step it stopped at, the restored step and its loss, the
first and last loss, and whether the restored state equals the one saved.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

from repro_torch import ckpt as ckpt_lib
from repro_torch import configs
from repro_torch.data import pipeline as data
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_lm_params, tree_leaves
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train.loop import run_train
from repro_torch.train.step import make_train_step

LR = 3e-3
SEQ_LEN = 16
BATCH = 8
MICROBATCHES = 2
CKPT_EVERY = 10


def run(arch: str, steps: int, ckpt_dir: str, device=None,
        seed: int = 0) -> dict:
    dev = resolve_device(device)
    cfg = configs.get_reduced(arch)
    opt = adamw(cosine_schedule(LR, 4, steps))
    step_fn = make_train_step(cfg, opt, remat=False,
                              microbatches=MICROBATCHES)
    ds = data.make_lm_dataset(cfg.vocab_size, SEQ_LEN, BATCH, seed=seed)
    half = steps // 2
    sentinel = os.path.join(ckpt_dir, "PREEMPT")
    losses = {}

    def batch_fn(i: int) -> dict:
        if i == half - 1:             # the preemption arrives mid-step
            os.makedirs(ckpt_dir, exist_ok=True)
            open(sentinel, "w").close()
        t, l = data.lm_batch(ds, i, device=dev)
        return {"tokens": t, "labels": l}

    def train_step(params, opt_state, batch):
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses[int(m["step"])] = m["loss"]
        return params, opt_state, m

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_lm_params(cfg, gen, device=dev)
    state = opt[0](params)
    print(f"phase 1: train, preempted at step {half}…", flush=True)
    params, state, stopped = run_train(
        train_step=train_step, params=params, opt_state=state,
        batch_fn=batch_fn, steps=steps, ckpt_dir=ckpt_dir,
        ckpt_every=CKPT_EVERY, async_ckpt=True)
    os.remove(sentinel)
    last = ckpt_lib.latest_step(ckpt_dir)
    print(f"checkpointed at step {last}; simulating restart…", flush=True)

    template = {"params": params, "opt_state": state}
    restored, meta = ckpt_lib.restore_checkpoint(ckpt_dir, last, template,
                                                 device=dev)
    exact = all(torch.equal(a, b) for a, b in
                zip(tree_leaves(restored), tree_leaves(template)))
    print(f"phase 2: resume from step {last} (ckpt loss "
          f"{meta.get('loss', float('nan')):.4f}) → {steps}", flush=True)
    run_train(train_step=train_step, params=restored["params"],
              opt_state=restored["opt_state"], batch_fn=batch_fn,
              steps=steps, start_step=last, ckpt_dir=ckpt_dir,
              ckpt_every=CKPT_EVERY)
    print("restart e2e OK", flush=True)
    return {"arch": arch, "steps": steps, "stopped_at": stopped,
            "restored_step": last, "restored_loss": meta.get("loss"),
            "restored_equal_saved": exact,
            "first_loss": float(losses[min(losses)]),
            "last_loss": float(losses[max(losses)])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    if args.ckpt_dir is None:
        with tempfile.TemporaryDirectory() as d:
            record = run(args.arch, args.steps, os.path.join(d, "ckpt"),
                         args.device, args.seed)
    else:
        record = run(args.arch, args.steps, args.ckpt_dir, args.device,
                     args.seed)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
