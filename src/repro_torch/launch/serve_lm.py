"""Serving example: continuous batching with 1-bit packed W1A8 weights
through the backend-agnostic Scheduler. Port-owned counterpart of
``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm
        [--arch granite-20b] [--max-new 12] [--device cpu]

Five requests share three slots; the scheduler prefills arrivals as one
batch per prompt length and decodes all active rows in one step per tick.
Per-request sampling: request 4 samples at temperature 0.8 and stops on
token 9 while the others decode greedily. The weights are drawn on the
host, so the greedy tokens do not depend on the device. Runs on the card
unless ``--device cpu``; prints the card's name and power limit beside the time,
then one JSON line: each request's finish reason and tokens.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch import configs
from repro_torch.device import card_name, resolve_device
from repro_torch.models.transformer import init_lm_params, tree_map
from repro_torch.serve import (LMBackend, SamplingParams, Scheduler,
                               ServeRequest, deploy_lm, packed_param_bytes)

SAMPLED, STOP_TOKEN = 4, 9       # the sampled request and its stop token


def run(arch: str = "granite-20b", max_new: int = 12, device=None,
        seed: int = 0) -> dict:
    dev = resolve_device(device)
    cfg = configs.get_reduced(arch)
    # drawn on the host and moved: the card's generator draws other
    # numbers than the CPU's, and the tokens must not depend on the device
    gen = torch.Generator()
    gen.manual_seed(seed)
    params = tree_map(lambda t: t.to(dev),
                      init_lm_params(cfg, gen, device="cpu"))
    packed = deploy_lm(params)
    acct = packed_param_bytes(packed)
    print(f"deployed {arch} (reduced): {acct['packed_bytes'] / 1e6:.2f} MB "
          f"packed ({acct['ratio']:.1f}x smaller than bf16)")
    sched = Scheduler(LMBackend(cfg, packed, slots=3, max_len=64,
                                mode="w1a8_eval", device=dev))
    reqs = [ServeRequest(rid=i, prompt=[5 + i, 23, 7, 11 + i],
                         sampling=SamplingParams(
                             max_new=max_new,
                             temperature=0.8 if i == SAMPLED else 0.0,
                             stop_tokens=(STOP_TOKEN,) if i == SAMPLED
                             else ()))
            for i in range(5)]
    t0 = time.perf_counter()
    results = sched.run(reqs)
    dt = time.perf_counter() - t0
    s = sched.metrics.summary()
    card = card_name(dev)
    print(f"served {len(results)} requests / {s['tokens']} tokens in "
          f"{dt:.2f}s ({s['tokens'] / dt:.1f} tok/s, occupancy "
          f"{s['batch_occupancy']:.2f}; {card})")
    out = {}
    for r in sorted(results, key=lambda r: r.rid):
        print(f"  req {r.rid} [{r.finish_reason}]: → {r.tokens}")
        out[r.rid] = {"finish": r.finish_reason, "tokens": list(r.tokens)}
    return {"arch": arch, "device": dev.type, "card": card, "wall_s": dt,
            "tokens": s["tokens"], "requests": out,
            "greedy": [i for i in out if i != SAMPLED]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-20b")
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    record = run(args.arch, args.max_new, args.device)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
