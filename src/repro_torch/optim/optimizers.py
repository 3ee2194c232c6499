"""Optimizers with the (init, update) convention on nested dicts of tensors.

Each factory returns ``(init_fn, update_fn)``:
    state = init_fn(params)
    updates, state = update_fn(grads, state, params)
    params = apply_updates(params, updates)

The states keep the reference's layout (``mu``/``nu``/``step``,
``v``/``vr``/``vc``, ``m``), so a state compares leaf for leaf with
``repro/optim/optimizers.py``'s. ``step`` is an int32 scalar tensor on the
params' device, so an update makes no host sync. Updates run under
``torch.no_grad()``.
"""
from __future__ import annotations

import torch


def full_like0(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-dim tensor on ``x``'s device and of its dtype: the
    divisor or dividend that keeps a division a division. On CUDA, PyTorch
    multiplies by the reciprocal of a Python number divisor, and
    ``number / tensor`` is a reciprocal times the number everywhere; the
    reference divides."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts and tuples, as the
    LM tree's ``slots``; anything else is a leaf), with the matching
    subtrees of ``rest``, in ``tree``'s shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the reference's order: ``jax.tree_util`` visits dict
    keys sorted (``conv1, conv10, conv11, conv2, …``; ``act_step, b, w``)
    and tuples in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_items(tree, path: str = ""):
    """(path, leaf) pairs in ``jax.tree_util``'s order: dict keys sorted,
    tuples in order; a path reads like ``jax.tree_util.keystr``'s."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_items(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple):
        return [item for i, v in enumerate(tree)
                for item in tree_items(v, f"{path}[{i}]")]
    return [(path, tree)]


def tree_map_with_path(fn, tree, path: str = ""):
    """``tree``'s shape with each leaf ``fn(path, leaf)``, paths spelled as
    `tree_items`'s."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map_with_path(fn, v, f"{path}[{i}]")
                     for i, v in enumerate(tree))
    return fn(path, tree)


def unflatten_like(tree, flat: list):
    """``flat`` (in `tree_leaves` order of ``tree``) in tree's shape."""
    by_id = dict(zip(map(id, tree_leaves(tree)), flat))
    return tree_map(lambda p: by_id[id(p)], tree)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def apply_updates(params, updates):
    with torch.no_grad():
        return tree_map(lambda p, u: p if u is None else p + u.to(p.dtype),
                        params, updates)


def sum_of_squares(grads) -> torch.Tensor:
    """Σ g² over every leaf, in f32, leaf by leaf in the reference's
    order."""
    with torch.no_grad():
        total = 0
        for g in tree_leaves(grads):
            total = total + torch.sum(torch.square(g.to(torch.float32)))
        return total


def clip_by_global_norm(grads, max_norm: float, total=None):
    """→ (grads scaled to a global norm of at most ``max_norm``, the norm
    before scaling). ``total``: the sum of squares over the whole tree
    where ``grads`` holds only part of it (default: `sum_of_squares` of
    ``grads``)."""
    with torch.no_grad():
        if total is None:
            total = sum_of_squares(grads)
        gnorm = torch.sqrt(total)
        scale = torch.clamp(full_like0(gnorm, max_norm) / (gnorm + 1e-9),
                            max=1.0)
        return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


def _lr_at(lr, step):
    return lr(step) if callable(lr) else lr


def adamw(lr, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0):
    """lr: a float or a callable(step) -> lr."""

    def init(params):
        return {"mu": tree_map(_zeros_f32, params),
                "nu": tree_map(_zeros_f32, params), "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2)
                      * torch.square(g.to(torch.float32)), state["nu"], grads)
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)

        def upd(m, v, p):
            u = -lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p.to(torch.float32)
            return u

        updates = tree_map(upd, mu, nu, params)
        return updates, {"mu": mu, "nu": nu, "step": step}

    return init, update


def adafactor(lr, *, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0):
    """Factored second moment (rows ``vr``, columns ``vc``) for leaves of
    two or more dims, a full ``v`` for the rest; no first moment."""

    def factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def one(p):
            if factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": _zeros_f32(p)}
        return {"v": tree_map(one, params), "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        beta = 1.0 - step.to(torch.float32) ** -decay

        def upd(g, v):
            g = g.to(torch.float32)
            g2 = torch.square(g) + eps
            if "vr" in v:
                vr = beta * v["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * v["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                rfac = torch.rsqrt(
                    vr / torch.mean(vr, dim=-1, keepdim=True) + eps)
                cfac = torch.rsqrt(vc + eps)
                u = g * rfac[..., None] * cfac[..., None, :]
                nv = {"vr": vr, "vc": vc}
            else:
                nvv = beta * v["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(nvv + eps)
                nv = {"v": nvv}
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / full_like0(rms, clip_threshold),
                                min=1.0)
            return [-lr_t * u, nv]        # a list: a leaf to tree_map

        pairs = tree_map(upd, grads, state["v"])
        updates = tree_map(lambda t: t[0], pairs)
        return updates, {"v": tree_map(lambda t: t[1], pairs), "step": step}

    return init, update


def sgdm(lr, *, momentum: float = 0.9):
    def init(params):
        return {"m": tree_map(_zeros_f32, params), "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        m = tree_map(lambda m_, g: momentum * m_ + g.to(torch.float32),
                     state["m"], grads)
        return tree_map(lambda m_: -lr_t * m_, m), {"m": m, "step": step}

    return init, update
