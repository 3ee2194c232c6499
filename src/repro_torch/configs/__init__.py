"""Config registry: the 10 LM architectures of the reference, as shape
data (counterpart of ``repro/configs``).

``get_config(name)`` / ``get_reduced(name)`` resolve by the public dashed id
(e.g. ``--arch chatglm3-6b``). ``ARCH_NAMES`` lists the archs in the
reference's order; ``SERVED`` the ones the serving path takes (every
family but enc-dec and the VLM, which run forward only, as in the
reference's tests). The paper's
detector lives in `repro_torch.models.yolo`.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "seamless-m4t-medium": "seamless_m4t_medium",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "mixtral-8x7b": "mixtral_8x7b",
    "mamba2-1.3b": "mamba2_1_3b",
    "gemma2-27b": "gemma2_27b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen2.5-14b": "qwen2_5_14b",
    "granite-20b": "granite_20b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "internvl2-76b": "internvl2_76b",
}

ARCH_NAMES = tuple(_MODULES)
# dense, MoE, SSM and hybrid, in the reference's order
SERVED = ("kimi-k2-1t-a32b", "mixtral-8x7b", "mamba2-1.3b", "gemma2-27b",
          "chatglm3-6b", "qwen2.5-14b", "granite-20b",
          "jamba-1.5-large-398b")


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _module(name).CONFIG


def get_reduced(name: str):
    return _module(name).reduced()
