"""Mixture-of-Experts block: top-k router and capacity-based scatter
dispatch, the JAX package's ``models/moe.py`` on one device.

Tokens are flattened token-major (row t * K + k is token t's k-th
choice), given a position within their expert by a cumsum over the
one-hot assignments, and scattered (``index_add_``) into an
(E * cap + 1, D) buffer whose last row collects the assignments past
capacity and is thrown away.  A kept slot receives exactly one token, so
the order in which a card's atomics add does not matter.  The expert
products are batched matrix products over (E, cap, D) x (E, D, F); the
JAX package computes them outside any Pallas kernel, and so does the
port.  Dropped assignments contribute nothing (Switch / GShard
semantics); shared experts (DeepSeek) see every token.

Capacity depends on the number of tokens in the call, T:
``int(max(1, (T * K * capacity_factor) // E))``.  So a prefill and the
decode steps that follow it drop different assignments, and the later
rows of a batch lose theirs first.

The Switch load-balance loss, E * <fraction routed to e> . <mean router
probability of e>, is returned beside the output: it doubles as the
per-client learning-quality signal of the digital twin.  The JAX
package's expert-parallel ``shard_map`` branch (a ``data`` x ``model``
mesh) is not ported: the port's MoE runs on one device.

Gradients flow through the renormalised top-k gate values (into the
router), the ``index_add_`` scatter, the expert products, the gather of
each assignment's output and the shared experts.  The Switch loss carries
gradient only through the mean router probabilities: the fraction routed
to an expert is a count, as in the JAX package.  The gather's backward
scatters each assignment's output gradient onto its slot; a dropped
assignment gathers slot E * cap - 1 masked to zero, so it adds an exact
zero there.  Adding exact zeros to the one real gradient of a slot gives
the same bits in any order, so a card's atomics in that backward leave
the result independent of their order.

The routing is a function of the block's input alone (float32 router
logits, ``torch.topk``, a cumsum), computed by deterministic ops, so the
per-layer checkpoint's recompute routes every token exactly as the first
pass did.  ``routing`` lets a caller hand in the expert choices of another
pass (the card's live check compares two passes that must dispatch
alike); the model never passes it.

Parameters are a flat mapping: ``router`` (D, E) float32, ``wg`` / ``wu``
(E, D, F), ``wd`` (E, F, D), and ``shared.wg`` / ``shared.wu`` /
``shared.wd`` for the shared experts' gated MLP.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .modules import dense_init, init_mlp, mlp, sub_params


def init_moe(cfg: ArchConfig, generator: Optional[torch.Generator], *,
             device=None) -> Dict[str, object]:
    """The JAX package's ``init_moe`` layout; ``shared`` is a sub-dict."""
    E, D, Fe = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    p: Dict[str, object] = {
        "router": dense_init((D, E), generator, scale=0.02, device=device),
        "wg": dense_init((E, D, Fe), generator, device=device),
        "wu": dense_init((E, D, Fe), generator, device=device),
        "wd": dense_init((E, Fe, D), generator, device=device)}
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(D, cfg.num_shared_experts * Fe, generator,
                               device=device)
    return p


def capacity(tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert for ``tokens`` tokens, in the JAX package's Python
    float arithmetic."""
    return int(max(1, (tokens * cfg.topk * cfg.capacity_factor)
                   // cfg.num_experts))


def dispatch(xt: torch.Tensor, e_flat: torch.Tensor, E: int, cap: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter each assignment of ``e_flat`` (T * K expert ids, token-major)
    into its expert's next free slot.  -> (buf (E, cap, D), slot (T * K,)
    with E * cap for a dropped assignment, keep (T * K,) bool)."""
    onehot = F.one_hot(e_flat, E)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    keep = pos < cap
    slot = torch.where(keep, e_flat * cap + pos,
                       torch.full_like(e_flat, E * cap))
    x_rep = xt.repeat_interleave(e_flat.shape[0] // xt.shape[0], dim=0)
    buf = torch.zeros((E * cap + 1, xt.shape[1]), dtype=xt.dtype,
                      device=xt.device).index_add_(0, slot, x_rep)
    return buf[:-1].reshape(E, cap, -1), slot, keep


def route(p: Mapping[str, torch.Tensor], cfg: ArchConfig, xt: torch.Tensor,
          routing: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt: (T, D) -> (router probabilities (T, E) float32, gate values
    (T, K) renormalised, expert ids (T, K)): the top-k in descending
    probability, or the ids ``routing`` (T, K) with their probabilities."""
    probs = torch.softmax(xt.to(torch.float32) @ p["router"], dim=-1)
    if routing is None:
        gate_vals, gate_idx = torch.topk(probs, cfg.topk, dim=-1)
    else:
        gate_idx = routing.to(device=xt.device, dtype=torch.int64)
        gate_vals = torch.gather(probs, -1, gate_idx)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gate_vals, gate_idx


def moe_forward(p: Mapping[str, torch.Tensor], cfg: ArchConfig,
                x: torch.Tensor, *, routing: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), the Switch aux loss, a float32
    scalar).  ``routing`` (B * S, K) expert ids replace the router's own
    top-k (see the module notes)."""
    B, S, D = x.shape
    T, E, K = B * S, cfg.num_experts, cfg.topk
    xt = x.reshape(T, D)
    probs, gate_vals, gate_idx = route(p, cfg, xt, routing)
    # E * <fraction routed to e> . <mean router probability of e>
    routed = torch.bincount(gate_idx.reshape(-1), minlength=E)
    aux = E * torch.sum(probs.mean(0) * routed.to(torch.float32) / (T * K))

    cap = capacity(T, cfg)
    buf, slot, keep = dispatch(xt, gate_idx.reshape(-1), E, cap)
    g = torch.bmm(buf, p["wg"])
    g = F.silu(g) if cfg.activation == "silu" else F.gelu(
        g, approximate="tanh")
    y_e = torch.bmm(g * torch.bmm(buf, p["wu"]), p["wd"])    # (E, cap, D)
    # a dropped assignment gathers a real slot and is masked
    y_tok = y_e.reshape(E * cap, D)[slot.clamp(max=E * cap - 1)]
    y_tok = y_tok * keep[:, None].to(x.dtype)
    y = (y_tok.reshape(T, K, D) * gate_vals[..., None].to(x.dtype)).sum(1)
    if cfg.num_shared_experts:
        y = y + mlp(sub_params(p, "shared"), xt, cfg.activation)
    return y.reshape(B, S, D), aux
