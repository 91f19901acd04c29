"""Byzantine-robust aggregation rules, on flat (C, N) client rows.

The rules the paper's trust aggregation (Eqns 4-6) is compared against:

  krum / multi-krum   (Blanchard et al., 2017)
  coordinate median   (Yin et al., 2018)
  trimmed mean        (Yin et al., 2018)

A copy of the JAX package's ``repro.core.robust`` over the port's flat
layout: each rule takes the (C, N) float32 matrix of client parameters
and returns the (N,) aggregate.  What differs from a literal translation:

- the median of an even count averages the two middle values, as
  ``jnp.median`` does (``torch.median`` returns the lower one);
- multi-krum's ranking is a stable sort, as ``jnp.argsort`` is;
- krum's (C, C) squared distances are summed from exact differences in
  blocks of client rows (`KRUM_BLOCK_ELEMS`), never from the (C, C, N)
  tensor at once nor from ``|a|^2 + |b|^2 - 2ab``, which cancels near ties
  and can change the client krum picks.

Everything stays on the tensors' device; no rule reads a value back to
the host.
"""
from __future__ import annotations

import torch

# the most elements of one block of krum's exact differences, (rows, C, N):
# 2^26 float32 values, 256 MiB (4 client rows at C = 99, N = 159,010)
KRUM_BLOCK_ELEMS = 1 << 26


def pairwise_sq_dists(flat: torch.Tensor) -> torch.Tensor:
    """(C, C) squared L2 distances between the rows of ``flat``, from the
    exact differences, ``rows`` client rows at a time."""
    C, N = flat.shape
    rows = max(1, KRUM_BLOCK_ELEMS // max(C * N, 1))
    out = []
    for i in range(0, C, rows):
        d = flat[i:i + rows, None, :] - flat[None, :, :]
        out.append(d.square_().sum(-1))
    return torch.cat(out)


def krum_scores(flat: torch.Tensor, f: int) -> torch.Tensor:
    """Sum of squared distances to the C-f-2 nearest neighbours, per
    client (the diagonal is +inf, so a client is never its own
    neighbour)."""
    C = flat.shape[0]
    d2 = pairwise_sq_dists(flat.to(torch.float32))
    eye = torch.eye(C, dtype=torch.bool, device=flat.device)
    d2 = torch.where(eye, torch.full_like(d2, float("inf")), d2)
    k = max(1, C - f - 2)
    return torch.sort(d2, dim=1).values[:, :k].sum(1)


def krum(flat: torch.Tensor, f: int = 1) -> torch.Tensor:
    """The single client closest to its neighbours (Krum); the first of
    equal scores, as ``jnp.argmin`` picks."""
    best = torch.argmin(krum_scores(flat, f))
    return flat.index_select(0, best.reshape(1))[0].to(torch.float32)


def multi_krum(flat: torch.Tensor, f: int = 1, m: int | None = None
               ) -> torch.Tensor:
    """The mean of the m lowest-score clients (Multi-Krum)."""
    C = flat.shape[0]
    m = m or max(1, C - f)
    sel = torch.argsort(krum_scores(flat, f), stable=True)[:m]
    return flat.to(torch.float32).index_select(0, sel).mean(0)


def _middle_mean(s: torch.Tensor, n) -> torch.Tensor:
    """The mean of ranks (n-1)//2 and n//2 of the sorted (C, N) ``s``:
    the median of its first n rows (``n`` an int or a 0-d int64 tensor)."""
    n = torch.as_tensor(n, dtype=torch.int64, device=s.device).reshape(1)
    # halved by a shift (n >= 1), which DTensor takes in every PyTorch
    # version the port runs on (``//`` it does not)
    lo = s.index_select(0, torch.bitwise_right_shift(n - 1, 1))[0]
    hi = s.index_select(0, torch.bitwise_right_shift(n, 1))[0]
    return 0.5 * (lo + hi)


def coordinate_median(flat: torch.Tensor) -> torch.Tensor:
    s = torch.sort(flat.to(torch.float32), dim=0).values
    return _middle_mean(s, flat.shape[0])


def _padded_sort(flat: torch.Tensor, mask: torch.Tensor):
    """Rows with mask False become +inf and sort past the valid ones:
    -> (the sorted (C, N) matrix, the valid count n >= 1 as a 0-d int64
    tensor)."""
    big = torch.where(mask[:, None], flat.to(torch.float32),
                      float("inf"))
    s = torch.sort(big, dim=0).values
    n = torch.clamp(mask.to(torch.int64).sum(), min=1)
    return s, n


def masked_coordinate_median(flat: torch.Tensor, mask: torch.Tensor
                             ) -> torch.Tensor:
    """Coordinate median over the ``mask``-valid rows, at fixed shape:
    the same two-middle average `coordinate_median` takes on the
    compacted rows."""
    s, n = _padded_sort(flat, mask)
    return _middle_mean(s, n)


def trimmed_mean(flat: torch.Tensor, beta: float = 0.2) -> torch.Tensor:
    """Drop the beta fraction of extremes per coordinate, then average."""
    C = flat.shape[0]
    k = int(C * beta)
    s = torch.sort(flat.to(torch.float32), dim=0).values
    s = s[k:C - k] if C - 2 * k >= 1 else s
    return s.mean(0)


def masked_trimmed_mean(flat: torch.Tensor, mask: torch.Tensor,
                        beta: float = 0.2) -> torch.Tensor:
    """Trimmed mean over the ``mask``-valid rows, at fixed shape: ranks
    [k, n-k) of the padded sort, k = floor(n beta) from the valid count n
    (0 when trimming would drop everything)."""
    s, n = _padded_sort(flat, mask)
    k = torch.floor(n.to(torch.float32) * beta).to(torch.int64)
    k = torch.where(n - 2 * k >= 1, k, 0)
    ranks = torch.arange(s.shape[0], device=s.device)[:, None]
    keep = (ranks >= k) & (ranks < n - k)
    total = torch.where(keep, s, 0.0).sum(0)
    return total / torch.clamp(n - 2 * k, min=1).to(torch.float32)


AGGREGATORS = {
    "krum": krum,
    "multi_krum": multi_krum,
    "median": coordinate_median,
    "trimmed_mean": trimmed_mean,
}

# rules with a fixed-capacity masked variant: these run on the engine's
# padded fixed-shape clusters (supports_mask=True)
MASKED_AGGREGATORS = {
    "median": masked_coordinate_median,
    "trimmed_mean": masked_trimmed_mean,
}
