"""The training loop with its fault-tolerance plumbing. Counterpart of
``repro/train/loop.py``.

Restart contract: a checkpoint holds (params, opt_state) and the step; the
data is a pure function of the step, so a resume is exact. Preemption:
SIGTERM or a ``<ckpt_dir>/PREEMPT`` sentinel file makes the loop checkpoint
(synchronously) and stop at the next step boundary. A watchdog reports a
step whose host time exceeds ``watchdog_factor`` × the median of the last
50. The loss is read on the host (a sync with the card) on logged steps
only.
"""
from __future__ import annotations

import os
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.distributed.tensor import Shard

from repro_torch import ckpt as ckpt_lib
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import placement_block
from repro_torch.optim.optimizers import tree_items


class _PreemptFlag:
    def __init__(self):
        self.hit = False

    def install(self):
        try:
            signal.signal(signal.SIGTERM, lambda *_: setattr(self, "hit", True))
        except ValueError:
            pass                    # not the main thread (tests)


def run_train(*, train_step: Callable, params, opt_state,
              batch_fn: Callable, steps: int,
              ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
              start_step: int = 0, log_every: int = 10,
              async_ckpt: bool = True, watchdog_factor: float = 3.0,
              print_fn: Callable = print,
              save: Callable = ckpt_lib.save_checkpoint,
              agree: Callable = bool) -> tuple:
    """Runs ``train_step`` from ``start_step`` to ``steps``; batch_fn(step)
    → batch dict. Returns (params, opt_state, the step it stopped at).

    ``save(ckpt_dir, step, tree, metadata=, async_=)`` writes a checkpoint
    and ``agree(flag)`` turns this process's preemption flag into the one
    every process of a job acts on; a job of several ranks passes both (a
    rank of a pipeline gathers its stage's slices and only rank 0 writes;
    the flag is all-reduced), so all ranks checkpoint and stop at the same
    step."""
    flag = _PreemptFlag()
    flag.install()
    durations = []
    step = start_step
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        batch = batch_fn(step)
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            print_fn(f"step {step:5d} loss {loss:.4f} "
                     f"gnorm {float(metrics['grad_norm']):.3f}")
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged at step {step}")
        dt = time.perf_counter() - t0
        durations.append(dt)
        med = float(np.median(durations[-50:]))
        if len(durations) > 5 and dt > watchdog_factor * med:
            print_fn(f"[watchdog] step {step} took {dt:.2f}s "
                     f"(median {med:.2f}s) — straggler suspected")
        preempt = agree(bool(flag.hit or (ckpt_dir and os.path.exists(
            os.path.join(ckpt_dir, "PREEMPT")))))
        if ckpt_dir and ((step + 1) % ckpt_every == 0 or preempt or
                         step == steps - 1):
            save(
                ckpt_dir, step + 1,
                {"params": params, "opt_state": opt_state},
                metadata={"loss": float(metrics["loss"])},
                async_=async_ckpt and not preempt)
        if preempt:
            print_fn(f"[preempt] checkpointed at step {step + 1}; exiting")
            break
    ckpt_lib.wait_for_async()
    return params, opt_state, step + 1


def block_cutter(shardings, mesh) -> Callable:
    """``cut(path, leaf, stacked)``: this rank's block of the whole leaf
    at ``path`` of a tree under ``shardings`` (its placements, a tree of
    `dist.sharding.tree_shardings`), or of one stage of it where
    ``stacked`` (the leaf's stage dim 0 dropped; no rule splits it)."""
    by_path = dict(tree_items(shardings))

    def cut(path: str, leaf, stacked: bool):
        pls = by_path[path]
        if stacked:
            pls = [Shard(pl.dim - 1) if isinstance(pl, Shard) else pl
                   for pl in pls]
        return placement_block(leaf, pls, mesh)
    return cut


def resume_or_init(ckpt_dir: Optional[str], init_fn: Callable, device=None,
                   print_fn: Callable = print, shardings=None,
                   mesh=None) -> tuple:
    """→ (state, start step): the latest checkpoint of ``ckpt_dir`` restored
    on ``device`` (default: the card), else ``init_fn(device)``.
    ``init_fn(device)`` builds the state on a device; on ``meta`` it gives
    the restore template without allocating. ``shardings`` (placements,
    `dist.sharding.tree_shardings` of the template) with ``mesh``: elastic
    restore, each leaf this rank's block whatever mesh wrote the
    checkpoint; a fresh state is ``init_fn(device, cut=)`` with
    `block_cutter`'s ``cut``: the rank's blocks drawn a leaf at a time
    (`models.transformer.materialize`), each bit for bit the block
    `dist.sharding.shard_by` cuts from ``init_fn(device)``."""
    dev = resolve_device(device)
    template = init_fn(torch.device("meta"))    # jax.eval_shape's counterpart
    if ckpt_dir:
        last = ckpt_lib.latest_step(ckpt_dir)
        if last is not None:
            state, _ = ckpt_lib.restore_checkpoint(
                ckpt_dir, last, template, device=dev, shardings=shardings,
                mesh=mesh)
            print_fn(f"[resume] restored step {last} from {ckpt_dir}")
            return state, last
    if shardings is None:
        return init_fn(dev), 0
    return init_fn(dev, cut=block_cutter(shardings, mesh)), 0


class StepTimer:
    """ms of each timed region: CUDA events on the card (read once, at the
    end, so the loop makes no host sync), the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def __enter__(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append([ev, None])
        else:
            self.marks.append([time.perf_counter(), None])
        return self

    def __exit__(self, *exc):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks[-1][1] = ev
        else:
            self.marks[-1][1] = time.perf_counter()

    def ms(self) -> list:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.marks]
        return [1e3 * (b - a) for a, b in self.marks]
