"""Quickstart: the W1A8 engine in five minutes. Port-owned counterpart of
``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

  1. a W1A8 linear layer — QAT training view vs deployed 1-bit view,
  2. the paper's detector — params/GFLOPs claims + integer-exact inference,
  3. an LM architecture with the W1A8 body (reduced mixtral-8x7b).

Runs on the card unless ``--device cpu``. Prints the example's lines, the
card's name and power limit beside its wall time, then one JSON line: the
two `core.verify.compare` rows and whether each holds its envelope (every
output within its LSB: 0.05 for the linear, 0.02 for the detector's head),
and the LM's logits shape and finiteness.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import verify, w1a8
from repro_torch.core.quant import quantize_act
from repro_torch.device import card_name, resolve_device
from repro_torch.models import yolo
from repro_torch.models.transformer import init_lm_params, lm_forward

LINEAR_LSB, DETECTOR_LSB = 0.05, 0.02


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _gen(dev: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def run(device=None) -> dict:
    dev = resolve_device(device)
    t0 = time.perf_counter()
    print("=== 1. W1A8 linear: train vs deployed-1-bit ===")
    p = w1a8.init_w1a8_linear(_gen(dev, 0), 256, 128, device=dev)
    x = torch.rand((4, 256), generator=_gen(dev, 1), device=dev) * 2.0
    y_train = w1a8.w1a8_linear_train(p, x)            # QAT (STE + LSQ)
    d = w1a8.deploy_w1a8_linear(p)                    # pack to 1 bit/weight
    a = quantize_act(x, p["act_step"]).to(torch.uint8)
    y_dep = w1a8.w1a8_linear_infer(d, a)              # Eq. 3-4 datapath
    linear = verify.compare("linear train-vs-deployed", _np(y_dep),
                            _np(y_train), lsb=LINEAR_LSB)
    print(linear.row())
    w_bytes = p["w"].numel() * p["w"].element_size()
    packed_bytes = d["w_packed"].numel() * d["w_packed"].element_size()
    print(f"weight storage: {packed_bytes} B packed vs {w_bytes} B latent "
          f"f32 ({w_bytes / packed_bytes:.0f}x)")

    print("\n=== 2. Paper detector: structure claims + integer pipeline ===")
    print("params:", yolo.count_params(), "(paper: 0.74 M)")
    print("gflops:", {k: round(v, 4) for k, v in yolo.count_gflops().items()},
          "(paper: 0.098)")
    params = yolo.init_yolo_params(42, device=dev)
    img_u8 = np.random.default_rng(2).integers(
        0, 256, (1, yolo.INPUT_SIZE, yolo.INPUT_SIZE, 3)).astype(np.uint8)
    img = torch.as_tensor(img_u8, device=dev).to(torch.float32) / 256.0
    params = yolo.calibrate_yolo(params, img)
    art = yolo.deploy_yolo(params)                    # COE-analogue artifact
    out_int = _np(yolo.yolo_forward_int(art, img_u8, device=dev)) / 2.0 ** 15
    out_f = _np(yolo.yolo_forward_float(params, img)).astype(np.float64)
    detector = verify.compare("detector int-vs-float", out_int, out_f,
                              lsb=DETECTOR_LSB)
    print(detector.row())

    print("\n=== 3. W1A8 LM (mixtral-8x7b reduced) ===")
    cfg = configs.get_reduced("mixtral-8x7b")
    lm = init_lm_params(cfg, _gen(dev, 3), device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=_gen(dev, 4),
                         device=dev, dtype=torch.int32)
    with torch.no_grad():
        logits = lm_forward(cfg, lm, toks, mode="w1a8_eval")
    finite = bool(torch.isfinite(logits).all())
    print("logits:", tuple(logits.shape), "finite:", finite)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    card = card_name(dev)
    print(f"\nquickstart OK in {wall:.1f} s ({card})")
    return {"device": dev.type, "card": card, "wall_s": wall,
            "linear": dataclasses.asdict(linear),
            "linear_in_envelope": linear.within_1lsb == 1.0,
            "detector": dataclasses.asdict(detector),
            "detector_in_envelope": detector.within_1lsb == 1.0,
            "lm_logits_shape": list(logits.shape), "lm_finite": finite}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    record = run(args.device)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    rec = main(sys.argv[1:])
    sys.exit(0 if rec["linear_in_envelope"] and rec["detector_in_envelope"]
             and rec["lm_finite"] else 1)
