"""The paper's Table 6 on the port: layer-wise numerical alignment of the
integer datapath ("RTL" role) and the packed kernel path against the float
oracle ("ONNX Runtime" role), at the paper's checkpoints:

    PYTHONPATH=src python -m repro_torch.launch.alignment [--size 320]
        [--seed 42] [--device cpu]

Inits the detector from a numpy seed, calibrates it on one random uint8
image from the same seed, deploys the integer artifact (`yolo.deploy_yolo`)
and the packed one, and prints one row per checkpoint. `run` also takes
trained params (used as they are, not calibrated) and a uint8 image, so
both packages can be compared on one converted artifact and one image. The
rows: conv1's raw accumulator against the float conv (correlation, at
2^-19), conv1's pooled codes within 1 LSB, the int raw head against the
float head (correlation, max and mean abs error, at 0.02), and the kernel
path's head against the float head. On the card conv1's codes and both
heads come from the CUDA kernels; conv1's raw accumulator is the plain
version's, since no kernel writes it out. Then one JSON line of the rows.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core import verify
from repro_torch.core.quant import quantize_act
from repro_torch.device import resolve_device
from repro_torch.kernels.w1a8_int import ref as int_ref
from repro_torch.models import yolo


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def run(seed: int = 42, size: int = yolo.INPUT_SIZE, device=None, *,
        trained_params: dict = None, image_u8=None) -> list:
    """Returns [(row name, value, note)] at the four checkpoints.

    ``trained_params`` (moved to ``device``) are used as they are; without
    them the detector is inited from ``seed`` and calibrated on the image.
    ``image_u8`` is a (1, S, S, 3) uint8 image (an array or a tensor; S
    then overrides ``size``); without it one is drawn from ``seed``."""
    dev = resolve_device(device)
    if image_u8 is None:
        rng = np.random.default_rng(seed)
        image_u8 = rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)
    img_u8 = torch.as_tensor(image_u8).to(dev)
    if img_u8.dtype != torch.uint8 or img_u8.dim() != 4:
        raise TypeError(f"image_u8 must be (1, S, S, 3) uint8, got "
                        f"{img_u8.dtype} {tuple(img_u8.shape)}")
    img = img_u8.to(torch.float32) / torch.tensor(256.0, device=dev)
    with torch.no_grad():
        if trained_params is None:
            params = yolo.calibrate_yolo(
                yolo.init_yolo_params(seed, device=dev), img)
        else:
            params = {n: {k: v.detach().to(dev) for k, v in p.items()}
                      for n, p in trained_params.items()}
        art = yolo.deploy_yolo(params)

        p1, e1 = params["conv1"], art["layers"][0]
        raw_f = (yolo._conv2d(img, fxp.CONV1_W.roundtrip(p1["w"]))
                 + fxp.CONV1_B.roundtrip(p1["b"]))
        post_f = quantize_act(yolo._maxpool2(torch.relu(raw_f)),
                              params["conv2"]["act_step"])
        acc = int_ref.accumulate(img_u8, None, e1["w_raw"].reshape(-1, 16),
                                 3) + e1["b_shifted"]
        post_i = yolo.int_layer(e1, img_u8)
        out_f = _f64(yolo.yolo_forward_float(params, img))
        out_i = _f64(yolo.yolo_forward_int(art, img_u8, device=dev)) / 2 ** 15
        out_k = _f64(yolo.yolo_forward_kernel(yolo.deploy_yolo_kernel(params),
                                              img))

    rows = []
    r = verify.compare("conv1_raw", _f64(acc) / 2 ** 19, _f64(raw_f),
                       lsb=2 ** -19)
    rows.append(("align.conv1_raw.corr", r.corr,
                 f"paper corr 0.999999; max_abs={r.max_abs:.6g}"))
    # the paper's conv1 post is before the pool; after it here (max and a
    # monotone quantizer commute), in 8-bit codes
    r = verify.compare("conv1_post", _f64(post_i), _f64(post_f), lsb=1.0)
    rows.append(("align.conv1_post.within_1lsb", 100 * r.within_1lsb,
                 f"paper 98.81%; mean_abs={r.mean_abs:.6g} LSB"))
    r = verify.compare("final_raw", out_i, out_f, lsb=0.02)
    rows.append(("align.final_raw.corr", r.corr,
                 f"paper corr 0.999964 (trained); max_abs={r.max_abs:.6g} "
                 f"(paper 0.109), mean_abs={r.mean_abs:.6g} (paper 0.020), "
                 f"within_1lsb={100 * r.within_1lsb:.4f}%"))
    r = verify.compare("final_raw_kernel", out_k, out_f, lsb=0.02)
    rows.append(("align.final_raw_kernel.corr", r.corr,
                 f"kernel path vs float oracle; max_abs={r.max_abs:.6g}, "
                 f"mean_abs={r.mean_abs:.6g}"))
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=yolo.INPUT_SIZE)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    rows = run(args.seed, args.size, args.device)
    for name, value, note in rows:
        print(f"{name:<32s} {value!r:<22s} {note}", flush=True)
    print(json.dumps({"alignment": rows, "size": args.size,
                      "seed": args.seed}), flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
