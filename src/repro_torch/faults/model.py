"""`FaultModel`: a `FaultSpec` applied inside the port's round.

A copy of the JAX package's ``repro.faults.model``.  Built once at engine
init; every method is a pure tensor function over the round's fixed
shapes, and each takes its random numbers as an argument: the engine
draws them (`repro_torch.rng`, keyed per device id and by the fault
seed, streams ``DROP``, ``STRAGGLE``, ``SPIKE`` and ``CORRUPT``), and the
parity tests hand over the JAX package's own.  The ``may_*`` flags mirror
the spec's, so the engine gates each family with a Python bool: a family
that is off adds no operation and no draw to the round.

The Byzantine subsets (update corruption, input poisoning) are static:
``int(frac * n)`` devices drawn once from ``FaultSpec.seed`` with numpy's
``default_rng((seed, tag))``, the JAX package's own code, so the subsets
are bitwise the reference's.  The poison patterns, one bias vector a
device, are drawn once from a CPU generator of the fault seed.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.twin import TwinState, take

from .spec import FaultSpec

# the JAX package's per-family tags; the two subsets draw from the
# streams of tags 3 and 4 of the fault seed
_TAG_CORRUPT, _TAG_POISON = 3, 4


def _static_subset(gen: np.random.Generator, n: int, frac: float
                   ) -> np.ndarray:
    """(n,) float32 indicator of a fixed ``int(frac*n)``-device subset."""
    out = np.zeros((n,), np.float32)
    k = int(frac * n)
    if k:
        out[gen.choice(n, size=k, replace=False)] = 1.0
    return out


class FaultModel:
    """The fault transformations of one fleet (see the module docstring).

    ``n_devices`` is the fleet size (the padding sentinel is ``n``),
    ``feat`` the width of a sample (for the poison patterns), ``device``
    where the subsets and patterns live.
    """

    def __init__(self, spec: FaultSpec, n_devices: int, *, feat: int = 0,
                 device=None):
        self.spec = spec.validate()
        self.n = int(n_devices)
        # the two subsets draw from independent streams of the fault seed,
        # so enabling poisoning never reshuffles the corrupters
        self.corrupt_dev = torch.as_tensor(_static_subset(
            np.random.default_rng((spec.seed, _TAG_CORRUPT)), self.n,
            spec.corrupt_frac if spec.may_corrupt else 0.0), device=device)
        self.poison_dev = torch.as_tensor(_static_subset(
            np.random.default_rng((spec.seed, _TAG_POISON)), self.n,
            spec.poison_frac if spec.may_poison else 0.0), device=device)
        # one frozen bias vector a device (row n: the padding sentinel's)
        self.patterns: Optional[torch.Tensor] = None
        if spec.may_poison:
            self.patterns = torch.randn(
                (self.n + 1, feat),
                generator=rng.generator(spec.seed, rng.POISON)).to(device)

    # mirrors of the spec's flags ---------------------------------------- #
    def stats(self) -> dict:
        """Build-time bookkeeping: the Byzantine subset sizes and the
        per-family rates (the JAX package's telemetry gauges)."""
        s = self.spec
        return {
            "active": float(self.active),
            "corrupt_devices": float(self.corrupt_dev.sum()),
            "poison_devices": float(self.poison_dev.sum()),
            "dropout_rate": float(s.dropout) if self.may_drop else 0.0,
            "straggler_frac": (float(s.straggler_frac)
                               if self.may_straggle else 0.0),
            "twin_spike_prob": (float(s.twin_spike_prob)
                                if self.may_spike else 0.0),
        }

    @property
    def active(self) -> bool:
        return self.spec.active

    @property
    def may_drop(self) -> bool:
        return self.spec.may_drop

    @property
    def may_straggle(self) -> bool:
        return self.spec.may_straggle

    @property
    def may_spike(self) -> bool:
        return self.spec.may_spike

    @property
    def may_corrupt(self) -> bool:
        return self.spec.may_corrupt

    @property
    def may_poison(self) -> bool:
        return self.spec.may_poison

    # per-round transformations; u: (M,) uniforms keyed per member id -- #
    def drop_mask(self, u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Bernoulli(dropout) participation failure per member slot."""
        return mask & (u >= self.spec.dropout)

    def straggle(self, u: torch.Tensor, dur: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        """Any straggling member multiplies the cluster round's duration by
        ``straggler_factor`` (the straggler gates the local phase, Alg. 2's
        min-frequency convention)."""
        st = (u < self.spec.straggler_frac) & mask
        return dur * torch.where(st.any(), self.spec.straggler_factor, 1.0)

    def spike_twins(self, u: torch.Tensor, tw_m: TwinState,
                    mask: torch.Tensor) -> TwinState:
        """Amplify the DT mapping deviation f̂ of spiked members in the
        (M,) twin view feeding Eqn 4."""
        sp = (u < self.spec.twin_spike_prob) & mask
        return tw_m.replace(freq_dev=torch.where(
            sp, tw_m.freq_dev * self.spec.twin_spike_scale, tw_m.freq_dev))

    def corrupt_updates(self, new: torch.Tensor, stacked: torch.Tensor,
                        members: torch.Tensor,
                        segments: Sequence[Tuple[int, int]],
                        normal: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """Byzantine corruption of the (M, N) member parameters ``new`` on
        the static corrupt subset, applied to the deltas ``new - stacked``
        before trust and aggregation (padding sentinels gather weight 0).

        ``segments`` are the (offset, size) of the model's leaves in the
        flat layout: the gaussian mode scales its noise by each leaf's own
        update norm over sqrt(leaf size), as the JAX package does per leaf;
        ``normal`` is its (M, N) standard normals (unused by the other
        modes, whose result is the same per leaf or per row)."""
        cz = take(self.corrupt_dev, members, 0.0)[:, None]
        mode, scale = self.spec.corrupt_mode, self.spec.corrupt_scale
        upd = new - stacked
        if mode == "sign_flip":
            # the model-replacement attack: against the honest direction
            bad = -upd * scale
        elif mode == "scaled_norm":
            bad = upd * scale
        else:                                           # gaussian
            parts = []
            for off, size in segments:
                u = upd[:, off:off + size]
                nrm = torch.sqrt((u * u).sum(1, keepdim=True) + 1e-12)
                sigma = scale * nrm / float(np.float32(np.sqrt(size or 1)))
                parts.append(u + sigma * normal[:, off:off + size])
            bad = torch.cat(parts, dim=1)
        return stacked + upd + cz * (bad - upd)

    def poison_inputs(self, x: torch.Tensor, members: torch.Tensor
                      ) -> torch.Tensor:
        """Add ``poison_scale`` times each poisoned device's frozen bias
        vector to every feature it trains on (a stuck-sensor model); x is
        (M, B, feat)."""
        pz = take(self.poison_dev, members, 0.0)
        p_m = self.patterns[torch.clamp(members, 0, self.n)]
        w = pz.reshape((-1,) + (1,) * (x.dim() - 1))
        bias = p_m.reshape((p_m.shape[0],) + (1,) * (x.dim() - 2)
                           + (x.shape[-1],))
        return x + w * self.spec.poison_scale * bias
