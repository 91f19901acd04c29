"""K-means node clustering for asynchronous FL (paper §IV-D step 1).

Clusters devices by (data size, compute power) so same-cluster nodes have
similar local-training wall time.  `ensure_nonempty` and
`padded_membership` turn an assignment into the fixed-shape tables the
round consumes: padding slots hold the sentinel id ``n``.
"""
from __future__ import annotations

import numpy as np
import torch

from .twin import TwinState, calibrated_freq


def _normalize(x):
    mu = x.mean(0, keepdim=True)
    sd = x.std(0, keepdim=True, correction=0) + 1e-8
    return (x - mu) / sd


def kmeans(feats: torch.Tensor, k: int, init_idx: torch.Tensor,
           iters: int = 25):
    """feats: (n, d); init_idx: (k,) distinct seed rows drawn by the
    caller -> (assignments (n,), centroids (k, d))."""
    cent = feats[init_idx]
    for _ in range(iters):
        d2 = ((feats[:, None] - cent[None]) ** 2).sum(-1)           # (n, k)
        assign = torch.argmin(d2, dim=1)
        oh = torch.nn.functional.one_hot(assign, k).to(feats.dtype)
        cnt = oh.sum(0)[:, None]
        new = (oh.T @ feats) / torch.clamp(cnt, min=1.0)
        cent = torch.where(cnt > 0, new, cent)
    d2 = ((feats[:, None] - cent[None]) ** 2).sum(-1)
    return torch.argmin(d2, dim=1), cent


def cluster_devices(twins: TwinState, k: int, init_idx: torch.Tensor):
    """Cluster by (data size, calibrated compute power) per the paper."""
    feats = _normalize(torch.stack(
        [twins.data_size, calibrated_freq(twins)], dim=1))
    return kmeans(feats, k, init_idx)


def ensure_nonempty(assign, k: int) -> np.ndarray:
    """Re-seed memberless clusters so every cluster owns >= 1 device: each
    empty cluster takes the first device of the currently largest one."""
    assign = np.asarray(assign).copy()
    if assign.shape[0] < k:
        raise ValueError(f"cannot fill {k} clusters from {assign.shape[0]} "
                         "devices")
    counts = np.bincount(assign, minlength=k)
    for c in range(k):
        if counts[c] == 0:
            donor = int(counts.argmax())
            i = int(np.where(assign == donor)[0][0])
            assign[i] = c
            counts[donor] -= 1
            counts[c] += 1
    return assign


def padded_membership(assign, k: int):
    """-> (member_table (k, M) int64, mask (k, M) bool), M the largest
    cluster size.  Members are in ascending id order; padding slots hold
    the sentinel ``n``."""
    assign = np.asarray(assign)
    n = assign.shape[0]
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=k)
    width = max(int(counts.max()) if n else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    col = np.arange(n) - np.repeat(starts, counts)
    table = np.full((k, width), n, dtype=np.int64)
    mask = np.zeros((k, width), dtype=bool)
    rows = np.repeat(np.arange(k), counts)
    table[rows, col] = order
    mask[rows, col] = True
    return torch.from_numpy(table), torch.from_numpy(mask)


def tolerance_bound(a, freq, t_min, alpha):
    """Alg. 2 lines 4-6: cap local-update counts so a_i / f_i <= alpha*T_m
    relative to the fastest cluster's local-update time T_m."""
    t_local = a.to(torch.float32) / torch.clamp(freq, min=1e-6)
    cap = torch.floor(alpha * t_min * freq).to(torch.int32)
    return torch.where(t_local > alpha * t_min, torch.clamp(cap, min=1), a)
