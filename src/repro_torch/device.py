"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import contextlib
import subprocess
from typing import Optional, Union

import torch
from torch._guards import active_fake_mode


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. Asking for CUDA without one raises: an entry
    point never carries on quietly on the CPU unless the caller asked.
    Under a ``FakeTensorMode`` (the dry run's trace) a CUDA device needs no
    card: its tensors hold no data."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available() \
            and active_fake_mode() is None:
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


@contextlib.contextmanager
def full_f32():
    """Full-precision float32 convs and matmuls on the card.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits: conv1's error would flip uint8 codes downstream.
    The reference computes these convs in float32, so TF32 is off inside.
    """
    cudnn, matmul = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


def card_name(device: Optional[Union[str, torch.device]] = None) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, for
    every time a record or a line states; "cpu" for a CPU device, and the
    name alone where nvidia-smi cannot run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, check=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)
