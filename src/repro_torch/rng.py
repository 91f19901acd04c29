"""Counter-based random draws, keyed per device id.

Every per-round random number of the federation is a pure function of
``(seed, round, stream, device id, index)``: a 32-bit integer hash
(MurmurHash3's finalizer, chained over the five keys) computed with int64
tensor arithmetic, so it runs wherever its inputs live and gives the same
bits on the CPU and the card.  A device's draws then do not depend on how
wide the padded membership is, or on which other devices share its round.

Uniforms carry 24 bits, exactly representable in float32.  Integer draws
come from them by comparison against float32 thresholds that are computed
once on the host in float64 (`cdf_table`), never by a device-side ``exp``,
so they too are identical on every device.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

# streams of one round, and of the init-time generators
BATCH, NOISE, CHANNEL = 0, 1, 2
INIT, DATA = 3, 4
# the DQN's pretraining on the DT environment: the agent's initial weights
# (a generator), an episode's reset, and each step's draws
DQN_INIT, ENV_RESET, DQN_STEP = 5, 6, 7
# the DP noise of a round's aggregate (N normals)
DP_NOISE = 8
# the fault model: the per-member uniforms of dropout, stragglers and twin
# spikes, the gaussian corruption's (M, N) normals, the build-time poison
# patterns (a generator), and the stream that mixes the fault seed into
# the federation's (`fault_seed`)
DROP, STRAGGLE, SPIKE, CORRUPT, POISON, FAULTS = 9, 10, 11, 12, 13, 14
# the seed of a greedy rollout on the DT environment (the paper's Figs 4
# and 5), kept apart from every training episode's draws
ROLLOUT = 15

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) without int64 overflow."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _combine(h: torch.Tensor, v) -> torch.Tensor:
    if isinstance(v, int):          # host arithmetic: no host-to-device copy
        k = ((((v & _M32) + 0x9E3779B9) & _M32) * 0xCC9E2D51) & _M32
    else:
        k = _mul32(((v.to(torch.int64) & _M32) + 0x9E3779B9) & _M32,
                   0xCC9E2D51)
    return _fmix32(h ^ k)


def hash32(seed, round_, stream: int, dev, index) -> torch.Tensor:
    """32-bit hash of the five keys, broadcast over ``dev`` and ``index``
    (int64 tensors); ``round_`` may be a 0-d device tensor, and ``seed``
    an int or a 0-d int64 tensor (a population member's seed), which
    give the same bits."""
    dev = torch.as_tensor(dev, dtype=torch.int64)
    if torch.is_tensor(seed):
        h = seed.to(torch.int64) & _M32
    else:
        h = torch.full((), int(seed) & _M32, dtype=torch.int64,
                       device=dev.device)
    h = _fmix32(h)
    for v in (round_, stream):
        h = _combine(h, v)
    return _combine(_combine(h, dev), index)


def uniform(seed, round_, stream: int, dev, index) -> torch.Tensor:
    """Float32 uniforms in [0, 1) with 24 random bits each."""
    return (hash32(seed, round_, stream, dev, index) >> 8).to(
        torch.float32) * (1.0 / (1 << 24))


def normal(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Standard normals from two uniforms in [0, 1) each (Box-Muller)."""
    return torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos(
        (2.0 * math.pi) * u2)


def normals(seed, round_, stream: int, dev, n: int) -> torch.Tensor:
    """(..., n) float32 standard normals, one row per entry of ``dev``
    (an int64 tensor or an int), from 2n uniforms of each row (indices
    0..n-1 and n..2n-1)."""
    dev = torch.as_tensor(dev, dtype=torch.int64)
    idx = torch.arange(2 * n, dtype=torch.int64, device=dev.device)
    u = uniform(seed, round_, stream, dev[..., None], idx)
    return normal(u[..., :n], u[..., n:])


def fault_seed(seed: int, fault_seed_: int) -> int:
    """The seed of every fault draw: the federation's seed mixed with the
    fault spec's, so two fault specs that differ only in their seed realise
    different faults against the same federation."""
    return int(hash32(seed, 0, FAULTS, 0, int(fault_seed_)))


def generator(seed: int, stream: int) -> torch.Generator:
    """A CPU `torch.Generator` for init-time draws (twins, k-means seeds,
    model weights, data), seeded from ``(seed, stream)`` so two streams of
    one seed never share bits."""
    return torch.Generator().manual_seed(int(hash32(seed, 0, stream, 0, 0)))


def randint(u: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Integers in [0, high) from uniforms ``u`` (high >= 1)."""
    k = (u * high.to(torch.float32)).to(torch.int64)
    return torch.minimum(k, high.to(torch.int64) - 1)


def cdf_table(rows: Sequence[Sequence[float]]) -> torch.Tensor:
    """Cumulative sums of probability rows, in float64 on the host, as a
    float32 (R, K) table for `inverse_cdf`."""
    out = []
    for row in rows:
        acc, cum = 0.0, []
        for p in row:
            acc += float(p)
            cum.append(acc)
        out.append(cum)
    return torch.tensor(out, dtype=torch.float32)


def poisson_cdf_table(lams: Sequence[float], kmax: int = 16) -> torch.Tensor:
    """`cdf_table` of Poisson(lam) over k = 0..kmax-1 for each lam."""
    return cdf_table([[math.exp(-lam) * lam ** k / math.factorial(k)
                       for k in range(kmax)] for lam in lams])


def inverse_cdf(u: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
    """Index of the first cumulative value above ``u``: ``cdf`` is (..., K)
    broadcast against ``u[..., None]``; the result is clipped to K - 1."""
    k = (u[..., None] >= cdf).sum(-1)
    return torch.clamp(k, max=cdf.shape[-1] - 1)
