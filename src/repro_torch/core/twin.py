"""Digital twins of Industrial-IoT training devices (paper §III-A).

``DT_i(t) = {F(w_i^t), f_i(t), E_i(t)}`` (Eqn 1): the twin mirrors each
device's training loss, compute frequency and energy.  The mapping has a
deviation ``f̂_i(t)`` (Eqn 2); calibration folds a running estimate of it
into the calibrated frequency.  A struct of (n,) tensors over the fleet.

Gathers and scatters over a padded member slice go through `take` and
`put`: slots holding the sentinel id ``n`` read a fill value and their
writes are dropped, as JAX's ``mode="fill"`` / ``mode="drop"`` do.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import is_dtensor


@dataclasses.dataclass
class TwinState:
    """Struct-of-arrays digital twin of an n-device fleet."""
    loss: torch.Tensor          # (n,) F(w_i^t): per-client training loss
    freq: torch.Tensor          # (n,) mapped compute capability f_i(t) [GHz]
    freq_dev: torch.Tensor      # (n,) current mapping deviation f̂_i(t)
    dev_estimate: torch.Tensor  # (n,) running empirical deviation estimate
    energy: torch.Tensor        # (n,) cumulative energy E_i(t) [J]
    data_size: torch.Tensor     # (n,) |D_i| local dataset sizes
    alpha: torch.Tensor         # (n,) positive-interaction counts (Eqn 4)
    beta: torch.Tensor          # (n,) malicious/lazy-update counts (Eqn 4)
    router_entropy: torch.Tensor  # (n,) MoE learning-quality extension

    def replace(self, **kw) -> "TwinState":
        return dataclasses.replace(self, **kw)


def take(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``x[idx]`` where ``idx`` may hold the sentinel ``len(x)``, which
    reads ``fill``."""
    pad = torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])[idx]


def put(x: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor
        ) -> torch.Tensor:
    """A copy of ``x`` with ``x[idx] = vals``; writes to the sentinel
    ``len(x)`` are dropped.  The ids in ``idx`` other than the sentinel are
    distinct.

    A DTensor ``x`` (the partitioner-inferred placement) takes the same
    values by a comparison, a gather and a select, which keep its rows
    where they are (DTensor has no sharding strategy for an in-place
    ``index_put_`` in every PyTorch version the port runs on).  A plain
    ``x`` keeps the ``index_put_``, which dispatches fewer ops to the card
    in a host-bound round (the select forms cost the unsharded round 17-36 %
    of its rounds/s: `repro_torch.api.engine._with_row`)."""
    if is_dtensor(x):
        n, m = x.shape[0], idx.shape[0]
        hit = torch.arange(n, device=x.device)[:, None] == idx[None, :]
        slot = torch.where(hit, torch.arange(m, device=x.device)[None, :],
                           m).min(dim=1).values        # m: no write
        pad = x.new_zeros((1,) + tuple(x.shape[1:]))
        got = torch.cat([vals.to(x.dtype), pad])[slot]
        keep = (slot < m).reshape((n,) + (1,) * (x.dim() - 1))
        return torch.where(keep, got, x)
    buf = torch.cat([x, x[:1]])
    buf[idx] = vals.to(x.dtype)
    return buf[:-1]


def init_twins(freq: torch.Tensor, data_size: torch.Tensor) -> TwinState:
    """Twins from drawn frequencies ~ U(0.5, 2.0) GHz and dataset sizes."""
    n = freq.shape[0]
    z = torch.zeros((n,), dtype=torch.float32, device=freq.device)
    return TwinState(loss=torch.full_like(z, float("inf")),
                     freq=freq.to(torch.float32), freq_dev=z, dev_estimate=z,
                     energy=z, data_size=data_size.to(torch.float32),
                     alpha=torch.ones_like(z), beta=z, router_entropy=z)


def draw_twins(n: int, generator: torch.Generator, *, freq_lo=0.5,
               freq_hi=2.0, data_lo=256, data_hi=4096) -> TwinState:
    """`init_twins` with its draws taken from ``generator`` (on the CPU)."""
    freq = torch.rand((n,), generator=generator) * (freq_hi - freq_lo) + freq_lo
    data = torch.randint(data_lo, data_hi, (n,), generator=generator)
    return init_twins(freq, data)


def sample_deviation(twins: TwinState, dev: torch.Tensor) -> TwinState:
    """Paper §V: DT mapping error; ``dev`` ~ U(0, 0.2) drawn by the caller,
    as a fraction of the true frequency."""
    return twins.replace(freq_dev=dev * twins.freq)


def calibrate(twins: TwinState, ema: float = 0.9) -> TwinState:
    """Self-calibration (Eqn 2): fold the observed deviation into a running
    estimate; calibrated frequency = mapped + estimate."""
    est = ema * twins.dev_estimate + (1.0 - ema) * twins.freq_dev
    return twins.replace(dev_estimate=est)


def calibrated_freq(twins: TwinState) -> torch.Tensor:
    return twins.freq + twins.dev_estimate


def observe_round(twins: TwinState, losses, energies, malicious_mask=None
                  ) -> TwinState:
    """Update twins after a federated round (real-time mapping)."""
    mal = (torch.zeros_like(twins.beta) if malicious_mask is None
           else malicious_mask.to(torch.float32))
    return twins.replace(loss=losses, energy=twins.energy + energies,
                         alpha=twins.alpha + (1.0 - mal),
                         beta=twins.beta + mal)


# what a sentinel member slot reads of each twin array (alpha = 1 keeps the
# Eqn-4 interaction ratio finite)
MEMBER_FILLS = dict(loss=0.0, freq=1.0, freq_dev=0.0, dev_estimate=0.0,
                    energy=0.0, data_size=1.0, alpha=1.0, beta=0.0,
                    router_entropy=0.0)


def member_view(twins: TwinState, members: torch.Tensor) -> TwinState:
    """The (M,) member slice of every twin array.  Sentinel slots read
    neutral values (`MEMBER_FILLS`) and must be masked by the caller before
    any reduction."""
    return TwinState(**{f: take(getattr(twins, f), members, v)
                        for f, v in MEMBER_FILLS.items()})


def observe_round_members(twins: TwinState, members, losses, energies,
                          malicious_mask=None) -> TwinState:
    """`observe_round` driven by one cluster's (M,) member slice: member
    losses and energies are scattered into the fleet (sentinels dropped),
    and the fleet-wide interaction counts advance as in `observe_round`."""
    full_loss = put(twins.loss, members, losses)
    full_e = put(torch.zeros_like(twins.energy), members, energies)
    return observe_round(twins, full_loss, full_e, malicious_mask)
