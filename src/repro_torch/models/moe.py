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
per-client learning-quality signal of the digital twin.

Sharded training (``shards``, `repro_torch.core.sharding.Shards`), the
JAX package's two paths:

  * the plain dispatch, which the JAX package's training plan runs: the
    tokens of the microbatch, split over ``data``, are gathered, so the
    routing, the capacity (of all T tokens) and the dispatch are the
    unsharded ones on every rank; the expert products run on the rank's
    shards of the expert weights at their specs' placements (experts,
    d_ff or the output dim split), whose partial or split outputs are
    summed or gathered back to the whole (E, cap, D) buffer; each rank
    keeps its own tokens' outputs.  `_constrain_ep`'s pins in the JAX
    package are layout hints to its partitioner with no effect on values;
    here the layouts are the ones written out.  Unsharded (no ``shards``)
    this body runs with every gather, chunk and sum the identity;
  * the expert-parallel branch (``shards.ep``, the JAX package's
    ``shard_map`` under ``jax.sharding.set_mesh``; ``ep_tp`` models whose
    expert count the ``data`` axis divides): each rank routes and
    dispatches its own tokens with capacity ``(T // n_data) * K *
    capacity_factor // E`` a token shard, an all-to-all over ``data``
    sends each expert's slots to the rank that holds it (experts over
    ``data``, d_ff over ``model``), and the reverse all-to-all brings the
    outputs back to combine.  The Switch loss is the global one.

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
from .modules import dense_init, init_mlp, mlp, share, sub_params


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


def one_hot(ids: torch.Tensor, E: int) -> torch.Tensor:
    """``F.one_hot(ids, E)`` (int64) by a comparison on the device: the
    library call checks the ids' range on the host (a read back on the
    CPU, none possible on the meta device)."""
    return (ids[..., None] == torch.arange(E, device=ids.device)).long()


def expert_counts(gate_idx: torch.Tensor, E: int) -> torch.Tensor:
    """``torch.bincount(gate_idx.reshape(-1), minlength=E)`` (int64)
    without its host read of the largest id."""
    ids = gate_idx.reshape(-1)
    return torch.zeros(E, dtype=torch.int64, device=ids.device).index_add_(
        0, ids, torch.ones_like(ids, dtype=torch.int64))


def dispatch(xt: torch.Tensor, e_flat: torch.Tensor, E: int, cap: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter each assignment of ``e_flat`` (T * K expert ids, token-major)
    into its expert's next free slot.  -> (buf (E, cap, D), slot (T * K,)
    with E * cap for a dropped assignment, keep (T * K,) bool)."""
    onehot = one_hot(e_flat, E)
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


def _act(cfg: ArchConfig, g: torch.Tensor) -> torch.Tensor:
    return F.silu(g) if cfg.activation == "silu" else F.gelu(
        g, approximate="tanh")


def _experts(p, cfg: ArchConfig, buf: torch.Tensor, sh) -> torch.Tensor:
    """The expert products of the whole (E, cap, D) buffer on this rank's
    shards of ``wg`` / ``wu`` / ``wd`` -> the whole (E, cap, D) output."""
    e_ax, f_ax = sh.axes("wg", 0), sh.axes("wg", 2)
    fd_ax, dd_ax = sh.axes("wd", 1), sh.axes("wd", 2)
    buf = sh.chunk(buf, 0, e_ax)                     # this rank's experts
    h = _act(cfg, torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wu"])
    if fd_ax != f_ax:                                # wd's d_ff layout
        h = sh.relayout(h, (None, None, f_ax), (None, None, fd_ax))
    y = sh.reduce(torch.bmm(h, p["wd"]), fd_ax)      # partial over d_ff
    return sh.gather(sh.gather(y, 2, dd_ax), 0, e_ax)


def _combine(y_e, slot, keep, gate_vals, dtype) -> torch.Tensor:
    """The experts' (E, cap, D) outputs -> each token's gate-weighted sum
    (T, D); a dropped assignment gathers a real slot and is masked."""
    E, cap, D = y_e.shape
    T, K = gate_vals.shape
    y_tok = y_e.reshape(E * cap, D)[slot.clamp(max=E * cap - 1)]
    y_tok = y_tok * keep[:, None].to(dtype)
    return (y_tok.reshape(T, K, D) * gate_vals[..., None].to(dtype)).sum(1)


def _moe_ep(p, cfg: ArchConfig, x: torch.Tensor, sh, routing):
    """The expert-parallel branch (module notes) on this rank's tokens."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.topk
    tok, tp = sh.tokens, sh.tp
    nd = sh.size(tok)
    Tl = B * S
    T = Tl * nd
    xt = x.reshape(Tl, D)
    probs, gate_vals, gate_idx = route(p, cfg, xt, routing)
    routed = expert_counts(gate_idx, E)
    from ..core.sharding import all_reduce_
    all_reduce_(routed, sh.group(tok))
    me = sh.reduce(probs.sum(0), tok) / T      # the mean over all tokens
    aux = E * torch.sum(me * routed.to(torch.float32) / (T * K))
    cap = int(max(1, (T // nd) * K * cfg.capacity_factor // E))
    buf, slot, keep = dispatch(xt, gate_idx.reshape(-1), E, cap)
    buf = sh.all_to_all(buf, 0, 1, tok)          # (E/nd, cap * nd, D)
    ep = (tok[0], None, tp[0] if tp else None)
    w = {k: sh.relayout(p[k], sh.spec(k), ep) for k in ("wg", "wu", "wd")}
    h = _act(cfg, torch.bmm(buf, w["wg"])) * torch.bmm(buf, w["wu"])
    y_e = torch.bmm(sh.gather(h, 2, tp), w["wd"])   # d_ff whole, D split
    y_e = sh.all_to_all(sh.gather(y_e, 2, tp), 1, 0, tok)   # (E, cap, D)
    y = _combine(y_e, slot, keep, gate_vals, x.dtype)
    if cfg.num_shared_experts:
        y = y + mlp(sub_params(p, "shared"), xt, cfg.activation,
                    sh.sub("shared"))
    return y.reshape(B, S, D), aux


def moe_forward(p: Mapping[str, torch.Tensor], cfg: ArchConfig,
                x: torch.Tensor, *, routing: Optional[torch.Tensor] = None,
                shards=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), the Switch aux loss, a float32
    scalar).  ``routing`` (B * S, K) expert ids replace the router's own
    top-k (see the module notes).  ``shards``: this rank's share of a
    sharded training step (module notes): the plain dispatch on the
    rank's shards, or the expert-parallel branch when asked for."""
    sh = share(shards)
    tok = sh.tokens
    if (sh.ep and cfg.shard_scheme == "ep_tp" and tok
            and cfg.num_experts % sh.size(tok) == 0):
        return _moe_ep(p, cfg, x, sh, routing)
    Bl, S, D = x.shape
    E, K = cfg.num_experts, cfg.topk
    xa = sh.gather(x, 0, tok)                    # every token of the batch
    T = xa.shape[0] * S
    xt = xa.reshape(T, D)
    probs, gate_vals, gate_idx = route(p, cfg, xt, routing)
    # E * <fraction routed to e> . <mean router probability of e>
    routed = expert_counts(gate_idx, E)
    aux = E * torch.sum(probs.mean(0) * routed.to(torch.float32) / (T * K))
    buf, slot, keep = dispatch(xt, gate_idx.reshape(-1), E, capacity(T, cfg))
    y = _combine(_experts(p, cfg, buf, sh), slot, keep, gate_vals, x.dtype)
    y = sh.chunk(y.reshape(-1, S, D), 0, tok).reshape(Bl * S, D)
    if cfg.num_shared_experts:
        y = y + mlp(sub_params(p, "shared"), x.reshape(Bl * S, D),
                    cfg.activation, sh.sub("shared"))
    return y.reshape(Bl, S, D), aux
