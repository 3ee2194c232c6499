"""Checkpoint save and restore for trees of tensors (nested dicts and
tuples), in the reference's format (``repro/ckpt/checkpoint.py``):

  * ``<dir>/step_%08d/`` holds one ``%05d.npy`` a leaf and ``manifest.json``
    (``step``; ``arrays``: index, path, shape, dtype; ``metadata``). The
    leaves come in ``jax.tree_util``'s flatten order (dict keys sorted,
    tuples in order) and each ``path`` is its ``keystr`` spelling, e.g.
    ``['params']['slots'][0]['attn']['q']['w']``. Sign words are
    ``uint32`` on disk (int32 in the port), the optimizer's ``step`` int32,
    floats float32 (`convert.lm_leaf_to_numpy`).
  * atomic: the arrays and then the manifest land in ``step_N.tmp/``,
    which ``os.rename`` commits; restore reads committed directories only.
  * async: ``save_checkpoint(..., async_=True)`` copies every leaf to host
    memory before it returns (a CPU tensor too: the copy is a snapshot,
    never a view the next update could write through) and writes on a
    thread; `wait_for_async` joins the writers.
  * restore places the leaves on one device (default: the card), whole,
    or with ``shardings=`` and ``mesh=`` each leaf's block on this rank of
    the mesh (elastic restore: any mesh, whatever layout wrote the
    checkpoint, which always holds whole leaves). A leaf's file is mapped,
    not read, so a rank reads its block alone.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.convert import lm_leaf_to_numpy
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import placement_block
from repro_torch.models.transformer import tree_items, tree_map_with_path

_PENDING: list = []


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *,
                    metadata: Optional[dict] = None,
                    async_: bool = False) -> str:
    """Writes ``tree`` as ``<ckpt_dir>/step_<step>``; returns that path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    items = tree_items(tree)
    host = [lm_leaf_to_numpy(x) for _, x in items]    # snapshots
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"

    def write():
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        entries = []
        for i, (arr, (path, _)) in enumerate(zip(host, items)):
            np.save(os.path.join(tmp, f"{i:05d}.npy"), arr)
            entries.append({"index": i, "path": path,
                            "shape": list(arr.shape), "dtype": str(arr.dtype)})
        manifest = {"step": step, "arrays": entries,
                    "metadata": metadata or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # commit point

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        _PENDING.append(t)
    else:
        write()
    return final


def wait_for_async() -> None:
    while _PENDING:
        _PENDING.pop().join()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _leaf_from_numpy(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    if arr.dtype == np.uint32:             # sign words: same bits, int32
        arr = arr.view(np.int32)
    return torch.from_numpy(arr).to(dev)


def restore_checkpoint(ckpt_dir: str, step: int, tree_like: Any, *,
                       device=None, shardings: Any = None,
                       mesh=None) -> tuple:
    """Restores into the structure of ``tree_like`` (tensors, or shapes on
    ``meta``), each leaf on ``device`` (default: the card) in its file's
    dtype. ``shardings`` (a tree of placements, `dist.sharding.
    tree_shardings` of ``tree_like``) with ``mesh``: each leaf is this
    rank's block. Returns (tree, metadata)."""
    if (shardings is None) != (mesh is None):
        raise ValueError("restore_checkpoint takes shardings and mesh "
                         "together")
    dev = resolve_device(device)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["arrays"]}
    pls = dict(tree_items(shardings)) if shardings is not None else {}

    def leaf_at(path, like):
        entry = by_path[path]
        arr = np.load(os.path.join(d, f"{entry['index']:05d}.npy"),
                      mmap_mode="r")
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{path}: checkpoint {arr.shape} vs template "
                             f"{tuple(like.shape)}")
        if path in pls:
            arr = placement_block(arr, pls[path], mesh)
        return _leaf_from_numpy(np.array(arr), dev)
    return tree_map_with_path(leaf_at, tree_like), manifest["metadata"]
