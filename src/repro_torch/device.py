"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. Asking for CUDA without one raises: an entry
    point never carries on quietly on the CPU unless the caller asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
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
