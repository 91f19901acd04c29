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
columns) of every leaf with two or more dims, and of each group of 1-D
leaves that the JAX package stacks into one (``groups``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[..., Tuple[Tree, Any]]
    # Adafactor's update of a group of >= 2-D leaves in two passes, a leaf
    # at a time (`repro_torch.core.fl_step._local_update`): ``unclipped(
    # grads, state) -> (u, new state, float32 sum of squares of u)``, then
    # ``clipped(u, ss, n)``, u clipped by the RMS of a group whose n
    # entries' squares sum to ss.  None where the update is elementwise.
    unclipped: Optional[Callable[..., Tuple[Tree, Any, torch.Tensor]]] = None
    clipped: Optional[Callable[..., torch.Tensor]] = None


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
    def init(params, groups=()):
        if momentum == 0.0:
            return ()
        return _zeros(params)

    def update(grads, state, params=None, groups=()):
        if momentum == 0.0:
            return {k: -lr * g for k, g in grads.items()}, state
        new_m = {k: momentum * state[k] + g.to(torch.float32)
                 for k, g in grads.items()}
        return {k: -lr * m for k, m in new_m.items()}, new_m

    return Optimizer(init, update)


# --------------------------------------------------------------------- #
def adam(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    def init(params, groups=()):
        return {"m": _zeros(params), "v": _zeros(params),
                "t": _step_count(params)}

    def update(grads, state, params=None, groups=()):
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
    leaf already.)

    ``groups`` (of ``init`` and ``update``: tuples of keys, e.g.
    `repro_torch.models.transformer.layer_groups`) are the leaves the JAX
    package stacks into one: a group's G leaves are updated as that
    stacked leaf.  The update is clipped by the RMS over the whole group
    (per-leaf sums of squares: nothing is stacked), and a group of 1-D
    leaves (n,) keeps the stack's factored moments, rows (G,) and columns
    (n,): each leaf holds its row ``r`` (0-d) and the group's column
    ``c``, the same in every leaf.  A leaf of no group, or a group of one
    >= 2-D leaf, is updated alone.  ``unclipped`` and ``clipped`` make a
    group of >= 2-D leaves' updates a leaf at a time (`Optimizer`)."""
    cdt = compute_dtype or torch.float32

    def init(params, groups=()):
        stacked = {k for grp in groups for k in grp}

        def leaf(k, p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"r": torch.zeros(p.shape[:-1], **f32),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                         **f32)}
            if k in stacked:
                return {"r": torch.zeros(p.shape[:-1], **f32),
                        "c": torch.zeros(p.shape, **f32)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"acc": {k: leaf(k, p) for k, p in params.items()},
                "t": _step_count(params)}

    def factored(g2, acc, beta):
        r = beta * acc["r"] + (1 - beta) * g2.mean(dim=-1).to(torch.float32)
        c = beta * acc["c"] + (1 - beta) * g2.mean(dim=-2).to(torch.float32)
        return r, c

    def vhat_of(new, dtype):
        if "v" in new:
            return new["v"]
        rc = new["r"] / torch.clamp(new["r"].mean(dim=-1, keepdim=True),
                                    min=eps)
        return (rc[..., None] * new["c"][..., None, :]).to(dtype)

    def clip(u, ms):
        rms = torch.sqrt(ms + 1e-12)
        return u / torch.clamp(rms / clip_threshold, min=1.0)

    def beta_of(state):
        t = state["t"] + 1
        return t, 1.0 - (t.to(torch.float32) + 1.0) ** -decay

    def moments(g, acc, beta):
        g2 = torch.square(g.to(cdt)) + eps
        if "r" in acc:
            r, c = factored(g2, acc, beta)
            return {"r": r, "c": c}
        return {"v": beta * acc["v"] + (1 - beta) * g2}

    def raw(g, new):
        g = g.to(cdt)
        return g / torch.sqrt(vhat_of(new, g.dtype) + eps)

    def unclipped(grads, state):
        t, beta = beta_of(state)
        new, us = {}, {}
        ss = torch.zeros((), dtype=torch.float32,
                         device=next(iter(grads.values())).device)
        for k, g in grads.items():
            new[k] = moments(g, state["acc"][k], beta)
            us[k] = raw(g, new[k])
            ss = ss + torch.square(us[k]).sum(dtype=torch.float32)
        return us, {"acc": new, "t": t}, ss

    def clipped(u, ss, n):
        return -lr * clip(u, (ss / n).to(cdt))

    def update(grads, state, params=None, groups=()):
        t, beta = beta_of(state)
        acc = state["acc"]
        new_acc, updates = {}, {}

        def alone(k):
            new_acc[k] = moments(grads[k], acc[k], beta)
            u = raw(grads[k], new_acc[k])
            updates[k] = -lr * clip(u, torch.mean(torch.square(u)))

        def stacked_vectors(ks):
            """A group of 1-D leaves: the JAX package's (G, n) leaf."""
            g = torch.stack([grads[k] for k in ks]).to(cdt)
            g2 = torch.square(g) + eps
            r, c = factored(g2, {"r": torch.stack([acc[k]["r"]
                                                   for k in ks]),
                                 "c": acc[ks[0]]["c"]}, beta)
            u = g / torch.sqrt(vhat_of({"r": r, "c": c}, g.dtype) + eps)
            u = clip(u, torch.mean(torch.square(u)))
            for i, k in enumerate(ks):
                new_acc[k] = {"r": r[i], "c": c}
                updates[k] = -lr * u[i]

        def stacked_matrices(ks):
            """A group of >= 2-D leaves: each leaf's moments are its own;
            the clip is over the group."""
            us, new, ss = unclipped({k: grads[k] for k in ks},
                                    {"acc": acc, "t": state["t"]})
            n = sum(u.numel() for u in us.values())
            new_acc.update(new["acc"])
            for k in ks:
                updates[k] = clipped(us[k], ss, n)

        grouped = set()
        for grp in groups:
            ks = [k for k in grp if k in grads]
            if not ks:
                continue
            if len(ks) != len(grp):
                raise ValueError(f"adafactor: a group's update needs all "
                                 f"of its leaves, got {ks} of {grp}")
            if grads[ks[0]].dim() == 1 and "r" in acc[ks[0]]:
                stacked_vectors(ks)
            elif len(ks) > 1:
                stacked_matrices(ks)
            else:
                continue
            grouped.update(ks)
        for k in grads:
            if k not in grouped:
                alone(k)
        return updates, {"acc": new_acc, "t": t}

    return Optimizer(init, update, unclipped, clipped)


REGISTRY = {"sgd": sgd, "adam": adam, "adamw": adamw, "adafactor": adafactor}
