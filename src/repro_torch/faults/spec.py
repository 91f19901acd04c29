"""`FaultSpec`: declarative fault injection for a federation experiment.

A copy of the JAX package's ``repro.faults.spec``, so the spec dicts of
the two packages stay interchangeable.  The fault model that applies a
spec inside the round is not ported yet: the port's engine raises on an
active spec (ROADMAP queue 1, "Faults").

Five orthogonal fault families, all off by default (the default spec is
inert: the engine compiles the exact pre-fault round):

dropout          per-member per-round Bernoulli participation failure.  A
                 dropped member leaves the round's padded mask; a round
                 whose cluster empties entirely is *skipped* (state carried
                 unchanged, zero energy) rather than aggregating a
                 degenerate all-padding cluster.
straggler        per-member per-round Bernoulli slow-down; any straggling
                 member multiplies the cluster's round duration by
                 ``straggler_factor`` (the straggler gates the cluster —
                 the same min-frequency semantics as Alg. 2).
twin spike       per-member per-round amplification of the digital-twin
                 mapping deviation f̂ by ``twin_spike_scale`` — inflating
                 the Eqn-4 deviation term the trust rule divides by, which
                 is precisely the deviation signal trust aggregation is
                 supposed to absorb.
update corruption Byzantine corruption of the per-member parameter
                 *updates* before aggregation, on a fixed ``corrupt_frac``
                 subset of devices (drawn once from ``seed``):
                 ``sign_flip`` negates the update, ``gaussian`` adds
                 N(0, corrupt_scale²) noise, ``scaled_norm`` multiplies it
                 by ``corrupt_scale``.
input poisoning  additive Gaussian input corruption (scale
                 ``poison_scale``) on a fixed ``poison_frac`` subset of
                 devices — the attack surface for unsupervised tasks
                 (``autoencoder-anomaly``), where label flips are a no-op
                 and trust must catch the poisoned reconstruction
                 gradients instead.

``seed`` drives both the static device subsets (corrupt/poison membership)
and the per-round fault randomness stream, decoupled from the federation's
``spec.seed`` so fault realizations can be varied against a fixed
federation.
"""
from __future__ import annotations

import dataclasses

CORRUPT_MODES = ("none", "sign_flip", "gaussian", "scaled_norm")


@dataclasses.dataclass
class FaultSpec:
    """Declarative fault model (see module docstring for semantics)."""
    dropout: float = 0.0             # P(member misses a round)
    straggler_frac: float = 0.0      # P(member straggles in a round)
    straggler_factor: float = 4.0    # round-duration multiplier if any do
    twin_spike_prob: float = 0.0     # P(member's twin deviation spikes)
    twin_spike_scale: float = 8.0    # f̂ amplification for spiked members
    corrupt_mode: str = "none"          # sign_flip = -scale * upd       # sign_flip | gaussian | scaled_norm
    corrupt_frac: float = 0.0        # fraction of devices corrupting updates
    corrupt_scale: float = 4.0       # gaussian sigma / norm multiplier
    poison_frac: float = 0.0         # fraction of devices with poisoned x
    poison_scale: float = 3.0        # additive input-noise magnitude
    seed: int = 0                    # fault stream + subset-selection seed

    # ------------------------------------------------------------------ #
    @property
    def may_drop(self) -> bool:
        return self.dropout > 0.0

    @property
    def may_straggle(self) -> bool:
        return self.straggler_frac > 0.0

    @property
    def may_spike(self) -> bool:
        return self.twin_spike_prob > 0.0

    @property
    def may_corrupt(self) -> bool:
        return self.corrupt_mode != "none" and self.corrupt_frac > 0.0

    @property
    def may_poison(self) -> bool:
        return self.poison_frac > 0.0

    @property
    def active(self) -> bool:
        """Whether any fault family is enabled.  Inert specs compile the
        exact pre-fault round (identical program, identical RNG stream)."""
        return (self.may_drop or self.may_straggle or self.may_spike
                or self.may_corrupt or self.may_poison)

    # ------------------------------------------------------------------ #
    def validate(self) -> "FaultSpec":
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(
                f"faults: unknown corrupt_mode {self.corrupt_mode!r}; "
                f"valid: {list(CORRUPT_MODES)}")
        for name in ("dropout", "straggler_frac", "twin_spike_prob",
                     "corrupt_frac", "poison_frac"):
            v = getattr(self, name)
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(
                    f"faults: {name}={v} must be a probability in [0, 1]")
        for name in ("straggler_factor", "twin_spike_scale",
                     "corrupt_scale", "poison_scale"):
            if float(getattr(self, name)) < 0.0:
                raise ValueError(
                    f"faults: {name}={getattr(self, name)} must be >= 0")
        return self
