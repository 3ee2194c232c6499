"""Times one packed decode step of two source trees of this repo in turns
on the card: the local path and the same step under a `ShardCtx` on a
one-rank NCCL ('data', 'model') = (1, 1) mesh (`chip_smoke.py` phase
15's), so the cost of the sharded path's own code shows beside the
kernels it shares with the local one.

    python -m repro_torch.launch.turns --trees build/parent . \\
        [--arch mixtral-8x7b] [--out chiprun_out/turns.json]

Each turn (A, B, B, A) is a process of its own, started in the tree with
that tree's ``src`` on its path: it builds the kernels
(`kernels._build.build_all`), draws the packed params from seed 0
(`serve.init_packed_lm`), prefills 4 prompts of 3 tokens (max_len 128,
w1a8_eval) and times the decode step by CUDA events: ``REPS`` medians of
``N`` back-to-back calls each, local and sharded. Prints the card's name
and power limit, one line a turn, and one JSON line last: per tree and
path, every turn's medians.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys

REPS, N = 5, 3

TURN = r'''
import json, pathlib, statistics, sys
import torch
import torch.distributed as dist
from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.transformer import ShardCtx
from repro_torch.serve import init_packed_lm
from repro_torch.serve.engine import decode_step, prefill

arch, store, reps, n = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    int(sys.argv[4])
_build.build_all()
torch.cuda.set_device(0)
pathlib.Path(store).unlink(missing_ok=True)
dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                        world_size=1)
dev = torch.device("cuda", 0)
cfg = configs.get_config(arch)
gen = torch.Generator(device=dev)
gen.manual_seed(0)
params = init_packed_lm(cfg, gen, device=dev)
mesh = make_test_mesh(1, 1, device="cuda")
ctxs = {"local": None,
        "sharded": ShardCtx(mesh, ("data",), "model",
                            "data" if cfg.num_experts else None)}
prompts = torch.tensor([[2 + i, 11, 7 + i % 3] for i in range(4)],
                       dtype=torch.int32, device=dev)
out = {}
with torch.no_grad():
    for path, ctx in ctxs.items():
        logits, cache = prefill(cfg, params, prompts, max_len=128,
                                mode="w1a8_eval", ctx=ctx)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]

        def step():
            return decode_step(cfg, params, cache, tok, mode="w1a8_eval",
                               ctx=ctx)
        step()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(reps):
            start.record()
            for _ in range(n):
                step()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / n)
        out[path] = statistics.median(times)
dist.destroy_process_group()
print(json.dumps(out))
'''


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def turn(tree: pathlib.Path, arch: str) -> dict:
    """One turn in ``tree``: {path: median ms of a decode step}."""
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    store = tree / "build" / "store_turns"
    store.parent.mkdir(exist_ok=True)
    done = subprocess.run(
        [sys.executable, "-c", TURN, arch, str(store), str(REPS), str(N)],
        cwd=tree, env=env, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"turn in {tree} exited {done.returncode}:\n"
                           f"{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, required=True,
                    help="two source trees, A then B")
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    trees = [pathlib.Path(t).resolve() for t in args.trees]
    smi = card()
    print(smi, flush=True)
    record = {"card": smi, "arch": args.arch, "reps": REPS, "n": N,
              "trees": [str(t) for t in args.trees], "turns": []}
    for i in (0, 1, 1, 0):
        ms = turn(trees[i], args.arch)
        record["turns"].append({"tree": args.trees[i], **ms})
        print(f"[turns] {args.trees[i]}: a decode step of {args.arch}, "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
              + f" (CUDA events, median of {REPS} × {N}) ({smi})",
              flush=True)
    for tree in args.trees:
        for path in ("local", "sharded"):
            record.setdefault("median", {}).setdefault(tree, {})[path] = \
                statistics.median(t[path] for t in record["turns"]
                                  if t["tree"] == tree)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
