"""Trust-based aggregation (paper §III-C, Eqns 4-6).

Belief of curator j in node i at slot t (Eqn 4):

    b_{i->j}^t = (1 - u) * q / f̂_i  *  alpha / (alpha + beta)

with u the packet-failure probability, q the learning quality (distance of
the node's update from the honest majority, FoolsGold-style), f̂ the DT
mapping deviation, and (alpha, beta) the positive/malicious interaction
counts.

Reputation (Eqn 5):  T_{i->j} = sum_t b^t + iota * u
Aggregation (Eqn 6): w_k = sum_i T_i w_i / sum_i T_i

Operation order follows the JAX package so float32 results agree to the
last few ulps.  Eqn 6 itself is the trust-aggregation kernels'
(`repro_torch.kernels`, plain versions in `kernels.ref`);
`time_weighted_average` takes its Eqn-19 sum through the unmasked
`trust_aggregate` kernel (its plain version on the CPU).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.trust_aggregate import trust_aggregate

from .twin import TwinState

_EPS = 1e-8


def learning_quality(updates_flat: torch.Tensor, mask=None) -> torch.Tensor:
    """q_{i->j} from Eqn 4: normalized distance of each client's update
    from the mean update; majority-consistent -> ~1, outliers -> low.

    updates_flat: (n, P) flattened per-client updates.  mask: optional (n,)
    validity mask; padded rows are excluded from the majority statistics
    and their own scores are arbitrary.  -> (n,) scores in (0, 1].
    """
    if mask is None:
        mean = updates_flat.mean(0, keepdim=True)
        dist = torch.linalg.vector_norm(updates_flat - mean, dim=1)
        rel = dist / (dist.sum() + _EPS)
        n = updates_flat.shape[0]
        return torch.clamp(1.0 - rel * n / max(n - 1, 1), _EPS, 1.0)
    m = mask.to(updates_flat.dtype)
    cnt = torch.clamp(m.sum(), min=1.0)
    mean = (updates_flat * m[:, None]).sum(0, keepdim=True) / cnt
    dist = torch.linalg.vector_norm(updates_flat - mean, dim=1) * m
    rel = dist / (dist.sum() + _EPS)
    return torch.clamp(1.0 - rel * (cnt / torch.clamp(cnt - 1.0, min=1.0)),
                       _EPS, 1.0)


def gradient_diversity(updates_flat: torch.Tensor, mask=None) -> torch.Tensor:
    """FoolsGold signal: max pairwise cosine similarity per client, turned
    into a diversity score.  ``mask`` excludes padded peers from the max.
    The Gram product runs in full float32 (TF32 is off in the port)."""
    norm = updates_flat / (torch.linalg.vector_norm(
        updates_flat, dim=1, keepdim=True) + _EPS)
    cs = norm @ norm.T
    cs = cs - torch.eye(cs.shape[0], device=cs.device) * 2.0
    if mask is not None:
        cs = torch.where(mask[None, :], cs, torch.full_like(cs, -2.0))
    mx = cs.max(dim=1).values
    return torch.clamp(1.0 - torch.clamp(mx, min=0.0), _EPS, 1.0)


def belief(twins: TwinState, quality, pkt_fail, diversity=None
           ) -> torch.Tensor:
    """Eqn 4 with the bounded deviation term 1/(1 + f̂) and the bounded
    FoolsGold factor (1 + d)/2 in [1/2, 1]."""
    fdev = torch.abs(twins.freq_dev - twins.dev_estimate)
    inter = twins.alpha / (twins.alpha + twins.beta + _EPS)
    b = (1.0 - pkt_fail) * quality / (1.0 + fdev) * inter
    if diversity is not None:
        b = b * 0.5 * (1.0 + diversity)
    return b


def update_reputation(rep, b, pkt_fail, iota: float = 0.1) -> torch.Tensor:
    """Eqn 5 (running form): accumulate belief + uncertainty term."""
    return rep + b + iota * pkt_fail


def trust_weights(rep, mask=None) -> torch.Tensor:
    """Normalized aggregation weights T_i / sum T (Eqn 6).  A degenerate
    fleet (all reputations <= 0) gets uniform weights; with ``mask``,
    padded clients get exactly zero weight."""
    rep = torch.clamp(rep, min=0.0)
    if mask is None:
        total = rep.sum()
        n = rep.shape[-1] if rep.dim() else 1
        uniform = torch.full_like(rep, 1.0 / max(n, 1))
        return torch.where(total > 1e-6, rep / torch.clamp(total, min=1e-6),
                           uniform)
    m = mask.to(rep.dtype)
    rep = rep * m
    total = rep.sum()
    uniform = m / torch.clamp(m.sum(), min=1.0)
    return torch.where(total > 1e-6, rep / torch.clamp(total, min=1e-6),
                       uniform)


def staleness_weights(staleness, base: float = math.e / 2) -> torch.Tensor:
    """Eqn 19's normalized time-decay weights (e/2)^{-(t - timestamp_j)}.

    staleness: (n_clusters,) rounds since each cluster's last update
    -> (n_clusters,) weights summing to 1.
    """
    w = base ** (-staleness.to(torch.float32))
    return w / (w.sum() + _EPS)


def time_weighted_average(cluster_flat, staleness, base: float = math.e / 2):
    """Eqn 19: inter-cluster aggregation with exponential time decay over a
    (n_clusters, N) stack: ``sum_b gw_b x_b``, one launch of the unmasked
    `trust_aggregate` kernel on the card.  -> (the (N,) average, the (B,)
    weights)."""
    w = staleness_weights(staleness, base)
    return trust_aggregate(cluster_flat.contiguous(), w.contiguous()), w
