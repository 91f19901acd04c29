"""Optimizers as functions over dicts of tensors (the JAX package's
``optim/optimizers.py``, formula for formula; ``torch.optim`` is not used).

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``params``, ``grads`` and ``updates`` are dicts of tensors with one key
set; a state holds dicts keyed like ``params`` (moments, accumulators)
and a step count ``t`` (a 0-d int32 tensor, or one per client when the
federated step stacks clients), so each entry can be a view into a stack
of clients.  ``update`` is pure: it returns new tensors and changes none
it was given.  ``adafactor`` keeps factored second moments (rows and
columns) of every leaf with two or more dims.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[..., Tuple[Tree, Any]]


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


def clip_by_global_norm(grads: Tree, max_norm: float):
    g = global_norm(grads)
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    return {k: x * scale for k, x in grads.items()}, g


def _zeros(params: Tree) -> Tree:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def _step_count(params: Tree) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


# --------------------------------------------------------------------- #
def sgd(lr, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return _zeros(params)

    def update(grads, state, params=None):
        if momentum == 0.0:
            return {k: -lr * g for k, g in grads.items()}, state
        new_m = {k: momentum * state[k] + g.to(torch.float32)
                 for k, g in grads.items()}
        return {k: -lr * m for k, m in new_m.items()}, new_m

    return Optimizer(init, update)


# --------------------------------------------------------------------- #
def adam(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    def init(params):
        return {"m": _zeros(params), "v": _zeros(params),
                "t": _step_count(params)}

    def update(grads, state, params=None):
        t = state["t"] + 1
        m = {k: b1 * state["m"][k] + (1 - b1) * g.to(torch.float32)
             for k, g in grads.items()}
        v = {k: b2 * state["v"][k]
             + (1 - b2) * torch.square(g.to(torch.float32))
             for k, g in grads.items()}
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=tf.device), tf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=tf.device), tf)

        def upd(k):
            step = -lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
            if weight_decay and params is not None:
                step = step - lr * weight_decay * params[k].to(torch.float32)
            return step

        return {k: upd(k) for k in grads}, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01) -> Optimizer:
    return adam(lr, b1, b2, eps, weight_decay)


# --------------------------------------------------------------------- #
def adafactor(lr, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, compute_dtype=None) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018).  Leaves
    with two or more dims keep row and column accumulators of their last
    two dims; smaller leaves keep a full one.  ``compute_dtype`` (the JAX
    package's: bfloat16 for the 30B+ training plans) is the dtype of the
    update math; the accumulators stay float32.  (The JAX package's
    ``sequential`` bounds XLA's temporaries; eager PyTorch updates leaf by
    leaf already.)"""
    cdt = compute_dtype or torch.float32

    def init(params):
        def leaf(p):
            if p.dim() >= 2:
                return {"r": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                         device=p.device),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                         dtype=torch.float32,
                                         device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"acc": {k: leaf(p) for k, p in params.items()},
                "t": _step_count(params)}

    def update(grads, state, params=None):
        t = state["t"] + 1
        beta = 1.0 - (t.to(torch.float32) + 1.0) ** -decay

        def leaf(g, acc):
            g = g.to(cdt)
            g2 = torch.square(g) + eps
            if "r" in acc:
                r = beta * acc["r"] + (1 - beta) * g2.mean(dim=-1).to(
                    torch.float32)
                c = beta * acc["c"] + (1 - beta) * g2.mean(dim=-2).to(
                    torch.float32)
                rc = r / torch.clamp(r.mean(dim=-1, keepdim=True), min=eps)
                vhat = (rc[..., None] * c[..., None, :]).to(g.dtype)
                new = {"r": r, "c": c}
            else:
                vhat = beta * acc["v"] + (1 - beta) * g2
                new = {"v": vhat}
            u = g / torch.sqrt(vhat + eps)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return -lr * u, new

        out = {k: leaf(g, state["acc"][k]) for k, g in grads.items()}
        return ({k: o[0] for k, o in out.items()},
                {"acc": {k: o[1] for k, o in out.items()}, "t": t})

    return Optimizer(init, update)


REGISTRY = {"sgd": sgd, "adam": adam, "adamw": adamw, "adafactor": adafactor}
