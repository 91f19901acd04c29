"""Federated (non-IID) data partitioning and per-round batch selection.

``dirichlet_partition`` assigns class-skewed shards to clients.
``padded_partition`` packs the ragged shards into one (n + 1, W) table
whose last row serves the padding sentinel, and ``sample_member_batch``
turns per-member sample positions into dataset rows for one round.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng


def dirichlet_partition(labels, n_clients: int, alpha: float = 0.5,
                        n_classes: int | None = None, seed: int = 0):
    """-> list of index arrays, one per client (non-IID by class skew),
    from numpy's ``default_rng(seed)``."""
    labels = np.asarray(labels)
    n_classes = n_classes or int(labels.max()) + 1
    gen = np.random.default_rng(int(seed))
    out = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.where(labels == c)[0]
        gen.shuffle(idx)
        props = gen.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for cl, part in enumerate(np.split(idx, cuts)):
            out[cl].extend(part.tolist())
    return [np.asarray(sorted(ix), dtype=np.int64) for ix in out]


def padded_partition(parts):
    """Pack ragged per-client index lists into fixed-shape tables.

    -> (part_idx (n + 1, W) int64, part_len (n + 1,) int64), W the largest
    shard.  Rows are zero-padded past their length; row ``n`` serves the
    padding sentinel (length 1, dataset row 0).  An empty shard is rejected:
    in the fixed-shape round it would silently train on dataset row 0.
    """
    n = len(parts)
    empty = [i for i, p in enumerate(parts) if len(p) == 0]
    if empty:
        raise ValueError(f"clients {empty} have empty data shards; every "
                         "client needs >= 1 sample (re-draw the partition)")
    w = max((len(p) for p in parts), default=1)
    idx = np.zeros((n + 1, max(w, 1)), dtype=np.int64)
    length = np.ones((n + 1,), dtype=np.int64)
    for i, p in enumerate(parts):
        idx[i, :len(p)] = np.asarray(p, dtype=np.int64)
        length[i] = len(p)
    return torch.from_numpy(idx), torch.from_numpy(length)


def sample_member_batch(u, part_idx, part_len, members):
    """Dataset rows of one cluster round's batches.

    u: (M, batch) uniforms, one per member and sample; members: (M,) ids,
    possibly the sentinel n.  Each member samples with replacement from its
    own shard: position floor(u * len), clipped.  -> (M, batch) int64.
    """
    pos = rng.randint(u, part_len[members][:, None])
    return torch.gather(part_idx[members], 1, pos)
