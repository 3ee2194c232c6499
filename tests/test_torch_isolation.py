"""The port stands alone: importing every `repro_torch` module loads neither
JAX nor the reference package, and entry points never fall back to the CPU
unless asked."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20, out.stdout


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import alignment
    from repro_torch.models import yolo
    from repro_torch.serve import DetectionBackend
    calib = np.zeros((1, 64, 64, 3), np.float32)
    params, art = yolo.build_detector(0, calib, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DetectionBackend(art)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        yolo.build_detector(0, calib)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        yolo.init_yolo_params(0)
    int_art = yolo.deploy_yolo(params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        yolo.yolo_forward_int(int_art, np.zeros((1, 64, 64, 3), np.uint8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        alignment.run(size=64)
    # LM training: the launchers, restore and resume default to the card
    from repro_torch import ckpt
    from repro_torch.launch import train as launch_train
    from repro_torch.launch import train_lm_w1a8
    from repro_torch.train.loop import resume_or_init
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "chatglm3-6b", "--reduced",
                           "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "qwen2.5-14b", "--reduced", "--steps",
                           "1", "--pipeline", "1f1b", "--pipeline-stages",
                           "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm_w1a8.main(["--steps", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.restore_checkpoint("no_such_dir", 1, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resume_or_init(None, lambda d: {})


def test_lm_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import configs
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.serve import LMBackend
    cfg = configs.get_reduced("chatglm3-6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm_params(cfg, torch.Generator())
    params = init_lm_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMBackend(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--workload", "lm", "--reduced"])
    # asked for the CPU, they run there
    assert LMBackend(cfg, params, device="cpu").device.type == "cpu"


def test_fleet_and_compose_entry_points_raise_without_cuda():
    """`run_compose`, `traffic.run_real` and a Router over card-default
    `DetectionBackend` replicas raise; the Router itself is
    device-agnostic."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import argparse

    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import traffic
    from repro_torch.models import yolo
    from repro_torch.serve import DetectionBackend, ModelBackend, Router
    args = argparse.Namespace(
        device=None, requests=2, buckets="64", seed=0, slots=2, depth=2,
        profile="tuned", arch="chatglm3-6b", reduced=True, max_new=2,
        max_len=32, temperature=0.0, stop_token=[], replicas=2, bucket=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.run_compose(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        traffic.run_real(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--workload", "detect", "--replicas", "2"])
    _, art = yolo.build_detector(0, np.zeros((1, 64, 64, 3), np.float32),
                                 device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Router(lambda: DetectionBackend(art), replicas=2)
    assert Router(ModelBackend, replicas=2).n_live == 2
