"""Carry weights across between the packages, as numpy arrays.

`params_from_numpy` takes float params (``{layer: {w, b, act_step}}``,
HWIO) and `params_to_numpy` gives the port's back (trained ones, say, for
the reference's ``deploy_yolo``). `artifact_from_numpy` takes a packed
``deploy_yolo_kernel`` artifact with its ``uint32`` sign words, and folds
the epilogue constants the port's artifact carries (`yolo.fold_epilogue`).
Deploying the converted params with the port's `yolo.deploy_yolo_kernel`
and converting the reference's artifact give the same sign words and steps,
so both paths run the same detector. `int_artifact_from_numpy` takes an
integer ``deploy_yolo`` artifact (numpy int64) and adds what the integer PE
reads (`yolo.fold_int_pe`), so the reference's artifact and the port's
``deploy_yolo`` of the same params compute the same integers.
`lm_params_from_numpy` / `lm_params_to_numpy` carry an LM param tree,
float or packed by ``deploy_lm``, with its nesting (dicts, tuples of
slots, leading stage axes) as it is. Nothing here imports the JAX package:
the caller hands over numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.yolo import (YOLO_LAYERS, fold_epilogue,
                                     fold_int_pe)

_SPECS = {s.name: s for s in YOLO_LAYERS}


def _tensor(x, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype == np.uint32:          # sign words: same bits, int32 carrier
        return torch.from_numpy(x.view(np.int32).copy()).to(device)
    return torch.from_numpy(np.asarray(x, np.float32).copy()).to(device)


def params_from_numpy(params_np: dict, device=None) -> dict:
    """{layer: {name: array}} → the port's params on ``device``."""
    dev = resolve_device(device)
    return {layer: {k: _tensor(v, dev) for k, v in p.items()}
            for layer, p in params_np.items()}


def params_to_numpy(params: dict) -> dict:
    """The port's params → {layer: {name: float32 array}} on the host."""
    return {layer: {k: v.detach().cpu().numpy().astype(np.float32)
                    for k, v in p.items()}
            for layer, p in params.items()}


def artifact_from_numpy(art_np: dict, device=None) -> dict:
    """A reference ``deploy_yolo_kernel`` artifact (arrays as numpy, specs
    as objects with a ``name``) → the port's artifact on ``device``."""
    dev = resolve_device(device)
    layers = []
    for entry in art_np["layers"]:
        spec = entry["spec"]
        out = {"spec": _SPECS[getattr(spec, "name", spec)]}
        out.update({k: _tensor(v, dev) for k, v in entry.items()
                    if k != "spec"})
        layers.append(fold_epilogue(out))
    art = {"layers": layers}
    if "buckets" in art_np:
        art["buckets"] = tuple(int(b) for b in art_np["buckets"])
    return art


def int_artifact_from_numpy(art_np: dict, device=None) -> dict:
    """A reference ``deploy_yolo`` artifact (int64 arrays, specs as objects
    with a ``name``) → the port's integer artifact on ``device``."""
    dev = resolve_device(device)
    layers = []
    for entry in art_np["layers"]:
        spec = entry["spec"]
        out = {"spec": _SPECS[getattr(spec, "name", spec)]}
        out.update({k: torch.from_numpy(np.array(v, np.int64)).to(dev)
                    for k, v in entry.items() if k != "spec"})
        layers.append(fold_int_pe(out))
    return {"layers": layers}


def lm_params_from_numpy(tree, device=None):
    """An LM param tree of numpy arrays (the reference's ``init_lm_params``
    or ``deploy_lm`` output, or an optimizer state over one, its leaves
    converted with ``np.asarray``) → the port's tree on ``device``, nested
    the same. ``uint32`` sign words become int32 with the same bits; an
    int32 leaf (the optimizer's ``step``) stays int32; floats become
    float32."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(walk(v) for v in node)
        if np.asarray(node).dtype == np.int32:
            return torch.from_numpy(np.array(node)).to(dev)
        return _tensor(node, dev)
    return walk(tree)


def lm_leaf_to_numpy(x: torch.Tensor) -> np.ndarray:
    """One leaf of the port's LM tree → numpy as the reference holds it:
    int32 sign words (one axis or more) as ``uint32`` (same bits), a 0-dim
    int32 counter (the optimizer's ``step``) as int32, floats as
    ``float32``; C-ordered, and a copy, never a view of the tensor's
    memory."""
    arr = x.detach().to("cpu", copy=True).contiguous().numpy()
    if arr.dtype == np.int32:
        return arr.view(np.uint32) if arr.ndim else arr
    return arr.astype(np.float32, copy=False)


def lm_params_to_numpy(tree):
    """The port's LM param tree (or an optimizer state over one) → numpy,
    nested the same, each leaf by `lm_leaf_to_numpy`."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(walk(v) for v in node)
        return lm_leaf_to_numpy(node)
    return walk(tree)
