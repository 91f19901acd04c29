"""`PopulationEngine`: B independent federations as one batched round.

The port's counterpart of the JAX package's ``repro.pop.engine``.  The
round of `DeviceScaleEngine` is a pure function of its `FleetState`, so a
population of B federations is one more batch axis: this engine builds B
real `DeviceScaleEngine`s from the member specs (data, partitions,
cluster assignments and Byzantine subsets come from the standalone
construction code), stacks their states and padded tables along a leading
population axis, and runs the *unmodified* round methods under
``torch.func.vmap`` through a `_MemberView`: a duck-typed engine whose
attributes hold one member's slices.  One population round dispatches the
same operations whatever B is, and each trust kernel launches once for
all members (the kernels' batching rules, `repro_torch.kernels.
trust_aggregate`).

A round is two batched halves with one host read between them, as the
standalone round reads its ``a``: the first half schedules the cluster
(argmin over the member's event times), runs the controller's scan policy
and caps its choice by the Alg.-2 bound; the host then reads the largest
``a`` of the population; the second half draws, runs that many local SGD
steps (each member keeps its own ``a`` steps: the later ones leave its
parameters as they were), and does trust, aggregation, energy, twins and
the queue.

Member heterogeneity splits into three classes, as in the JAX package:

build-time   fields only read at construction (seed, data params,
             malicious_frac, dt_max_dev, channel p_good, fault subsets):
             realized per member by the standalone constructors, stacked.
lifted       scalar knobs read inside the round (lr, iota, pkt_fail, DP
             noise, alpha0/alpha_growth, fault intensities, the Lyapunov
             knobs, the trust-vs-fedavg flag, the seeds of the draws):
             per-member 0-d tensors bound into the `_MemberView`.
static       everything that changes the round's operations (shapes,
             component kinds, fault gates ``may_*``, corrupt_mode, DP
             on/off, calibrate_dt): must be uniform; checked at build.

Ragged per-member widths (padded membership M, partition width W) pad to
the population-wide maximum: padded slots hold the sentinel id and a
false mask, so they are never read as members.  Reductions over the wider
padded rows may round differently from a standalone run's: a member
agrees with its standalone run in its schedule exactly and in its values
to float32 rounding (`tests/test_torch_pop.py`).

The population axis shards over a 1-D mesh of ``torch.distributed`` ranks
(``PopulationSpec.sharding``, one shard a rank): rank r builds and runs
members ``[r*B/G, (r+1)*B/G)``, and members are independent, so a round
has no collective.  At build one MAX all-reduce pads every rank's members
to the population-wide widths M and W, so each member runs the batched
shapes of the unsharded population; after each `run_scanned`, one SUM
all-reduce of the zero-padded per-member rows and evaluations gives every
rank every member's trace, energy and round count.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.api.components import WeightedAggregator
from repro_torch.api.engine import (DeviceScaleEngine, FleetState, RoundDraws,
                                    _row, _with_row, fleet_state_from_numpy,
                                    fleet_tree)
from repro_torch.api.records import FLTrace, RoundRecord
from repro_torch.api.spec import FederationSpec
from repro_torch.control import policy as ctl_policy
from repro_torch.control import queue as ctl_queue
from repro_torch.core.envs import OBS_DIM
from repro_torch.core.twin import TwinState
from repro_torch.data.synthetic import SyntheticClassification
from repro_torch.device import resolve_device
from repro_torch.faults.model import FaultModel

from .spec import PopulationSpec

__all__ = ["PopulationEngine", "PopulationMember"]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"population: {msg}")


def _uniform(specs, label: str, get):
    vals = [get(s) for s in specs]
    _require(all(v == vals[0] for v in vals),
             f"{label} must be uniform across the population (it is "
             f"compiled static); got {vals}")
    return vals[0]


def _state_of(d: Dict[str, torch.Tensor]) -> FleetState:
    """The `FleetState` of a `FleetState.tensors()` dict."""
    twins = TwinState(**{f.name: d[f"twins.{f.name}"]
                         for f in dataclasses.fields(TwinState)})
    return FleetState(twins=twins, **{
        f.name: d[f.name] for f in dataclasses.fields(FleetState)
        if f.name != "twins"})


class _MemberView(DeviceScaleEngine):
    """A duck-typed `DeviceScaleEngine` carrying one member's vmap-sliced
    tensors and lifted spec scalars.  Only the attributes the round and
    the controller features read are set; the round methods themselves
    are inherited unmodified."""

    def __init__(self, **attrs):          # noqa: D401 — attribute bag
        for k, v in attrs.items():
            setattr(self, k, v)
        self.draws = self._own_draws


class _FaultView(FaultModel):
    """`FaultModel` over lifted per-member fault scalars and Byzantine
    subsets.  The ``may_*`` gates come from the (uniform) base spec, so
    every member runs the same operations; the probabilities and scales
    the methods read are 0-d tensors."""

    def __init__(self, base: FaultModel, p: Dict[str, Any]):
        self._base = base.spec
        self.n = base.n
        self.patterns = base.patterns
        self.corrupt_dev = p["corrupt_dev"]
        self.poison_dev = p["poison_dev"]
        self.spec = dataclasses.replace(
            base.spec, **{k: p[k] for k in _LIFTED_FAULT})

    active = property(lambda self: self._base.active)
    may_drop = property(lambda self: self._base.may_drop)
    may_straggle = property(lambda self: self._base.may_straggle)
    may_spike = property(lambda self: self._base.may_spike)
    may_corrupt = property(lambda self: self._base.may_corrupt)
    may_poison = property(lambda self: self._base.may_poison)


class _LiftedWeightedAggregator(WeightedAggregator):
    """Trust/fedavg selected by a per-member flag: both weight vectors are
    computed and `torch.where`-selected, so the selected lane is the
    standalone branch's."""

    def __init__(self, uniform_flag):
        super().__init__(uniform=False)
        self._flag = uniform_flag         # () bool tensor: True = fedavg

    def _effective_weights(self, weights, mask):
        m = mask.to(weights.dtype)
        uni = m / torch.clamp(m.sum(), min=1.0)
        return torch.where(self._flag, uni, weights)


# lifted FederationSpec scalars: (key, getter)
_LIFTED_SPEC = (
    ("lr", lambda s: s.lr),
    ("iota", lambda s: s.iota),
    ("pkt_fail", lambda s: s.channel.pkt_fail),
    ("noise", lambda s: s.privacy.noise),
    ("alpha0", lambda s: s.clustering.alpha0),
    ("alpha_growth", lambda s: s.clustering.alpha_growth),
)
_LIFTED_FAULT = ("dropout", "straggler_frac", "straggler_factor",
                 "twin_spike_prob", "twin_spike_scale", "corrupt_scale",
                 "poison_scale")
_ROW_KEYS = ("t", "cluster", "a", "dur", "consumed", "loss")


class PopulationEngine:
    """B federations, one batched round (see the module docstring).

    ``specs`` are the member specs (`PopulationSpec.expand`), all on
    ``device`` (the card unless the caller asks for another);
    ``federations`` overrides the standalone federations built from them
    (the parity tests hand over ones built on the JAX package's data).
    ``sharding`` (a 1-D `ShardingSpec` over ``torch.distributed`` ranks)
    makes this rank build and run only its block of members; ``specs``,
    ``B`` and the per-member rounds, energies and traces stay the whole
    population's."""

    def __init__(self, specs: Sequence[FederationSpec], *, device=None,
                 federations: Optional[Sequence[Any]] = None,
                 sharding=None):
        from repro_torch.api.federation import Federation
        self.specs = list(specs)
        self.B = len(self.specs)
        _require(self.B >= 1, "need at least one member spec")
        self.device = dev = resolve_device(device)
        self._group = None
        self._lo, self._hi = 0, self.B
        if sharding is not None and sharding.is_sharded:
            from repro_torch.api import placement
            _require(len(sharding.mesh) == 1,
                     "the population shards over a 1-D mesh (one pop axis)")
            shards = int(sharding.mesh[0])
            _require(self.B % shards == 0,
                     f"mesh has {shards} shards, which does not divide the "
                     f"population size {self.B}")
            # the members are the rows the one axis shards
            pl = placement.resolve(dataclasses.replace(
                sharding, axes=sharding.axes or ("pop",), device_axis=None,
                cluster_axis=None), n_devices=self.B, n_clusters=1,
                device=dev)
            self._group = pl.group
            per = self.B // shards
            self._lo, self._hi = pl.rank * per, (pl.rank + 1) * per
        local = self.specs[self._lo:self._hi]
        if federations is None:
            federations = [Federation.from_spec(s, controller=c, device=dev)
                           for s, c in zip(local,
                                           self._build_controllers(local,
                                                                   dev))]
        self.federations = list(federations)
        engines = [f.engine for f in self.federations]
        self._check_static(engines)
        e0 = engines[0]
        self._proto = e0
        self.task = e0.task

        # --- stack member state + tables (padded to population-wide M/W)
        stack = lambda xs: torch.stack(list(xs))               # noqa: E731
        self.state = _state_of({
            k: stack(e.state.tensors()[k] for e in engines)
            for k in e0.state.tensors()})
        self._scan_times = stack(e._scan_times for e in engines)
        widths = torch.tensor(
            [max(e._member_table.shape[1] for e in engines),
             max(e._part_idx.shape[1] for e in engines)], device=dev)
        if self._group is not None:
            dist.all_reduce(widths, op=dist.ReduceOp.MAX, group=self._group)
        M, W = widths.tolist()
        n = int(e0.spec.fleet.n_devices)

        def pad(t, width, value):
            return F.pad(t, (0, width - t.shape[1]), value=value)

        x = stack(e.data.x for e in engines)
        y = stack(e.data.y for e in engines)
        for b, e in enumerate(engines):    # the members read the stack
            e.data = e.data._replace(x=x[b], y=y[b])
        mp: Dict[str, Any] = {
            "x": x, "y": y,
            "part_idx": stack(pad(e._part_idx, W, 0) for e in engines),
            "part_len": stack(e._part_len for e in engines),
            "member_table": stack(pad(e._member_table, M, n)
                                  for e in engines),
            "member_mask": stack(pad(e._member_mask, M, False)
                                 for e in engines),
            "member_mask_f": stack(pad(e._member_mask_f, M, 0.0)
                                   for e in engines),
            "malicious": stack(e._malicious_dev for e in engines),
            "misbehaving": stack(e._misbehaving_dev for e in engines),
            "trans": stack(e._trans_cdf for e in engines),
            "per_slot": torch.tensor(
                [ctl_queue.per_slot_of(f.controller)
                 for f in self.federations], dtype=torch.float32,
                device=dev),
            "seed": torch.tensor([int(s.seed) for s in local],
                                 dtype=torch.int64, device=dev),
        }
        for key, get in _LIFTED_SPEC:
            mp[key] = torch.tensor([float(get(s)) for s in local],
                                   dtype=torch.float32, device=dev)
        if e0.faults.active:
            flt = {k: torch.tensor([float(getattr(s.faults, k))
                                    for s in local],
                                   dtype=torch.float32, device=dev)
                   for k in _LIFTED_FAULT}
            flt["corrupt_dev"] = stack(e.faults.corrupt_dev for e in engines)
            flt["poison_dev"] = stack(e.faults.poison_dev for e in engines)
            mp["flt"] = flt
            mp["fault_seed"] = torch.tensor(
                [int(e._fault_seed) for e in engines], dtype=torch.int64,
                device=dev)
        agg_kinds = {s.aggregator.kind for s in self.specs}
        self._lift_agg = agg_kinds == {"trust", "fedavg"}
        if self._lift_agg:
            mp["agg_uniform"] = torch.tensor(
                [s.aggregator.kind == "fedavg" for s in local], device=dev)
        self._pol_step, self._pol_needs_obs, pol_mp = self._build_policy()
        if pol_mp:
            mp["pol"] = pol_mp
        self._mp = mp

        self._rounds = [0] * self.B
        self._energy_used = [0.0] * self.B      # exact f64, per member
        self._sinks: List[Any] = [None] * self.B
        self._retain = [True] * self.B
        # the per-round draws: None draws each member's own inside the
        # batched round; the parity tests set a callable (batched state,
        # (B, M) members) -> batched `RoundDraws` (the JAX package's draws)
        self.draws = None

    # ------------------------------------------------------------------ #
    @classmethod
    def from_population(cls, pspec: PopulationSpec, *, device=None
                        ) -> "PopulationEngine":
        """The population of ``pspec``'s expanded member specs; a sharded
        ``pspec`` builds this rank's block of members (a mesh of G > 1
        needs a G-rank launch, `repro_torch.launch.distributed`)."""
        return cls(pspec.expand(), device=device, sharding=pspec.sharding)

    def _build_controllers(self, specs, device):
        """Member controllers from the registries; identical DQN pretrains
        are built once and shared (the agent is immutable at deploy time;
        fixed and Lyapunov controllers carry per-member queue state and
        are always built per member)."""
        from repro_torch.api import registry
        cache: Dict[str, Any] = {}
        out = []
        for s in specs:
            factory = registry.CONTROLLERS.get(s.controller.kind)
            if s.controller.kind == "dqn":
                key = json.dumps(s.controller.params, sort_keys=True,
                                 default=repr)
                if key not in cache:
                    cache[key] = factory(s.controller.params, device=device)
                out.append(cache[key])
            else:
                out.append(factory(s.controller.params, device=device))
        return out

    # ------------------------------------------------------------------ #
    def _check_static(self, engines) -> None:
        specs = self.specs
        for e in engines:
            _require(type(e) is DeviceScaleEngine,
                     f"member engines must be unsharded device-scale "
                     f"engines; got {type(e).__name__}")
            _require(e._padded, "members need a mask-aware aggregator "
                     "(run_scanned's padded fused round)")
        _uniform(specs, "fleet.n_devices", lambda s: s.fleet.n_devices)
        _uniform(specs, "clustering.n_clusters",
                 lambda s: s.clustering.n_clusters)
        _uniform(specs, "local_batch", lambda s: s.local_batch)
        _uniform(specs, "task", lambda s: (s.task.kind,
                                           sorted(s.task.params.items())))
        _uniform(specs, "controller.kind", lambda s: s.controller.kind)
        _uniform(specs, "fleet.calibrate_dt",
                 lambda s: s.fleet.calibrate_dt)
        _uniform(specs, "privacy.clip", lambda s: s.privacy.clip)
        _uniform(specs, "aggregator.use_kernel",
                 lambda s: s.aggregator.use_kernel)
        agg_kinds = {s.aggregator.kind for s in specs}
        if len(agg_kinds) > 1:
            _require(agg_kinds == {"trust", "fedavg"},
                     f"mixed aggregator kinds {sorted(agg_kinds)} — only "
                     "the trust/fedavg pair lifts to a traced flag")
            _require(specs[0].privacy.clip <= 0.0,
                     "mixed trust/fedavg aggregators cannot combine with "
                     "DP (the DP weight path branches on the kind)")
        else:
            _uniform(specs, "aggregator.params",
                     lambda s: sorted(s.aggregator.params.items()))
        for gate in ("may_drop", "may_straggle", "may_spike",
                     "may_corrupt", "may_poison"):
            _uniform(specs, f"faults.{gate}",
                     lambda s, g=gate: getattr(s.faults, g))
        if specs[0].faults.may_corrupt:
            _uniform(specs, "faults.corrupt_mode",
                     lambda s: s.faults.corrupt_mode)
        if specs[0].faults.may_poison:
            _uniform(specs, "faults.seed (with poisoning on: the poison "
                     "patterns derive from it statically)",
                     lambda s: s.faults.seed)
        _require(len({e._n_actions for e in engines}) == 1,
                 "controller n_actions must be uniform")
        _require(len({e._fuse_global for e in engines}) == 1,
                 "aggregator fused-global support must be uniform")

    # ------------------------------------------------------------------ #
    def _build_policy(self):
        """The population's scan policy: per-member scalar knobs lifted
        into ``mp["pol"]``, the same arithmetic as
        `repro_torch.control.policy`."""
        ctls = [f.controller for f in self.federations]
        kind = self.specs[0].controller.kind
        dev = self.device
        if kind == "fixed":
            pol_mp = {"a": torch.tensor([int(c.a) for c in ctls],
                                        dtype=torch.int32, device=dev)}

            def step(state, obs, p):
                return p["a"], state
            return step, False, pol_mp
        if kind == "lyapunov":
            pol_mp = {k: torch.tensor([float(getattr(c, k)) for c in ctls],
                                      dtype=torch.float32, device=dev)
                      for k in ("kappa", "f_star", "v0", "v_growth")}
            n_actions = int(ctls[0].n_actions)

            def step(state, obs, p):
                s = ctl_policy.lyapunov_scores(
                    obs.queue, obs.round, obs.cluster_loss, obs.mean_freq,
                    obs.channel_good_frac, n_actions=n_actions,
                    kappa=p["kappa"], f_star=p["f_star"], v0=p["v0"],
                    v_growth=p["v_growth"])
                return torch.argmax(s).to(torch.int32) + 1, state
            return step, False, pol_mp
        # generic (dqn, custom): one shared step function, per-member carry
        # stacked; the step must not depend on the member (the built-in DQN
        # policy's net rides in the carry)
        base = ctls[0].scan_policy()

        def step(state, obs, p):
            return base.step(state, obs)
        return step, base.needs_obs, None

    def _ctl_state(self):
        """The stacked policy carry, fetched from the member controllers
        each call, as the standalone `run_scanned` fetches
        ``scan_policy().state``."""
        states = [f.controller.scan_policy().state
                  for f in self.federations]
        if not isinstance(states[0], dict) or not states[0]:
            return {}
        return {k: torch.stack([s[k] for s in states]) for k in states[0]}

    # ------------------------------------------------------------------ #
    def _member_view(self, mp: Dict[str, Any]) -> _MemberView:
        """Bind one member's vmap-sliced tensors and lifted scalars to a
        duck-typed engine the inherited round methods run against."""
        e0 = self._proto
        s0 = e0.spec
        spec = dataclasses.replace(
            s0, seed=mp["seed"], lr=mp["lr"], iota=mp["iota"],
            clustering=dataclasses.replace(
                s0.clustering, alpha0=mp["alpha0"],
                alpha_growth=mp["alpha_growth"]),
            channel=dataclasses.replace(s0.channel,
                                        pkt_fail=mp["pkt_fail"]),
            privacy=dataclasses.replace(s0.privacy, noise=mp["noise"]))
        faults = (_FaultView(e0.faults, mp["flt"])
                  if e0.faults.active else e0.faults)
        aggregator = (_LiftedWeightedAggregator(mp["agg_uniform"])
                      if self._lift_agg else e0.aggregator)
        return _MemberView(
            spec=spec, task=e0.task, faults=faults, aggregator=aggregator,
            device=self.device, _n_actions=e0._n_actions, _padded=True,
            _fuse_global=e0._fuse_global, _segments=e0._segments,
            _fault_seed=mp.get("fault_seed"),
            data=SyntheticClassification(x=mp["x"], y=mp["y"],
                                         prototypes=None),
            _member_table=mp["member_table"],
            _member_mask=mp["member_mask"],
            _member_mask_f=mp["member_mask_f"],
            _part_idx=mp["part_idx"], _part_len=mp["part_len"],
            _malicious_dev=mp["malicious"],
            _misbehaving_dev=mp["misbehaving"], _trans_cdf=mp["trans"],
            _queue_per_slot=mp["per_slot"], _dev_ids=e0._dev_ids,
            _zero=e0._zero, _batch_idx=e0._batch_idx)

    def _choose(self, state, times, ctl, energy, mp):
        """First half of one member's round: the cluster, its event time,
        the controller's choice capped by the Alg.-2 bound."""
        view = self._member_view(mp)
        state = _state_of(state)
        c = torch.argmin(times)
        t = _row(times, c)
        feats = view._ctl_features(state, c)
        obs = (view._scan_obs(state, c, feats) if self._pol_needs_obs
               else torch.zeros((OBS_DIM,), device=times.device))
        cobs = ctl_policy.CtlObs(
            round=state.round, cluster=c, queue=state.queue,
            cluster_loss=feats["cluster_loss"],
            cluster_freq=feats["cluster_freq"],
            mean_freq=feats["mean_freq"],
            channel_good_frac=feats["channel_good_frac"],
            energy_used=energy, dqn_obs=obs)
        a_raw, ctl = self._pol_step(ctl, cobs, mp.get("pol"))
        return c, t, view._round_choice(state, c, a_raw), ctl

    def _members(self, c, mp):
        return self._member_view(mp)._round_members(c)[0]

    def _apply(self, steps, state, times, energy, c, t, a, draws, mp):
        """Second half of one member's round: ``steps`` local steps of
        which it keeps its own ``a``, then the rest of the round."""
        view = self._member_view(mp)
        state = _state_of(state)
        members, mask, mask_f = view._round_members(c)
        draws = (view.draws(state, members) if draws is None
                 else RoundDraws(**draws))
        state, m = view._round_apply(state, c, a, steps, members, mask,
                                     mask_f, draws, own_steps=True)
        times = _with_row(times, c, t + m["dur"])
        energy = energy + m["consumed"]
        row = torch.stack([t, c.to(torch.float32), m["a"].to(torch.float32),
                           m["dur"], m["consumed"], m["loss"]])
        return state.tensors(), times, energy, row

    def _round(self, state: FleetState, times, ctl, energy):
        """One population round: every member's round, batched; the
        largest ``a`` is read to the host once.  No loop over members."""
        vmap = torch.func.vmap
        sd = state.tensors()
        c, t, a, ctl = vmap(self._choose)(sd, times, ctl, energy, self._mp)
        steps = int(a.max())        # the round's one read back to the host
        draws = None
        if self.draws is not None:
            members = vmap(self._members)(c, self._mp)
            draws = {k: v for k, v in self.draws(state, members)
                     ._asdict().items() if v is not None}
        apply = functools.partial(self._apply, steps)
        sd, times, energy, row = vmap(
            apply, in_dims=(0, 0, 0, 0, 0, 0, None if draws is None else 0,
                            0))(sd, times, energy, c, t, a, draws, self._mp)
        return _state_of(sd), times, ctl, energy, row

    # ------------------------------------------------------------------ #
    def set_member_sink(self, b: int, sink, *, retain: bool = True) -> None:
        """Attach a per-member trace sink (e.g. a run-dir `JsonlSink`)."""
        self._sinks[b] = sink
        self._retain[b] = retain

    def run_scanned(self, K: int, *,
                    eval_final: bool = True) -> List[FLTrace]:
        """Run K rounds of every member; per-member traces.

        Consecutive calls continue (times, energy and round counters
        carry), so segment sequences match one long run: the invariant the
        pool supervisor checkpoints on, as the standalone engine's."""
        K = int(K)
        energy = torch.tensor([np.float32(e) for e in
                               self._energy_used[self._lo:self._hi]],
                              dtype=torch.float32, device=self.device)
        state, times, ctl = self.state, self._scan_times, self._ctl_state()
        rows = []
        for _ in range(K):
            state, times, ctl, energy, row = self._round(state, times, ctl,
                                                         energy)
            rows.append(row)
        self.state = state
        self._scan_times = times
        ys = torch.stack(rows) if rows else torch.zeros(
            (0, len(self.federations), len(_ROW_KEYS)), device=self.device)
        return self._emit(ys, K, eval_final)

    def _emit(self, ys: torch.Tensor, K: int, eval_final: bool
              ) -> List[FLTrace]:
        """Per-member records from the (K, B, 6) rows, read back once; the
        float64 energy of each member adds its float32 consumptions one by
        one, as the standalone engine does.  Sharded, the rows and the
        final evaluations of the whole population are gathered first."""
        evals = torch.zeros((ys.shape[1], 2), dtype=torch.float64,
                            device=self.device)
        if eval_final and K:
            for i, f in enumerate(self.federations):
                ev = self.task.evaluate(self.state.global_flat[i],
                                        f.engine.data)
                evals[i] = torch.tensor([ev["loss"], ev["acc"]],
                                        dtype=torch.float64)
        if self._group is not None:
            ys, evals = self._gather_rows(ys, evals)
        ys, evals = ys.cpu().numpy(), evals.cpu().numpy()
        queue_host = None
        traces = []
        for b in range(self.B):
            base = self._rounds[b]
            self._rounds[b] += K
            cum = []
            for ci in ys[:, b, 4]:
                self._energy_used[b] += float(ci)
                cum.append(self._energy_used[b])
            if self._lo <= b < self._hi:
                sync_queue = getattr(self._fed(b).controller, "sync_queue",
                                     None)
                if sync_queue is not None:
                    if queue_host is None:
                        queue_host = self.state.queue.cpu()
                    sync_queue(queue_host[b - self._lo])
            trace = FLTrace(records=[], sink=self._sinks[b],
                            retain=self._retain[b])
            for i in range(K):
                trace.append(RoundRecord(
                    t=float(ys[i, b, 0]), round=base + i + 1,
                    cluster=int(ys[i, b, 1]), a=int(ys[i, b, 2]),
                    loss=float(ys[i, b, 5]), acc=None, energy=cum[i],
                    agg_count=base + i + 1))
            if eval_final and K:
                trace.append(RoundRecord(
                    t=float(ys[-1, b, 0]) + float(ys[-1, b, 3]),
                    round=self._rounds[b], cluster=int(ys[-1, b, 1]),
                    a=int(ys[-1, b, 2]), loss=float(evals[b, 0]),
                    acc=float(evals[b, 1]), energy=self._energy_used[b],
                    agg_count=self._rounds[b]))
            traces.append(trace)
        return traces

    def _gather_rows(self, ys: torch.Tensor, evals: torch.Tensor):
        """The (K, B, 6) rows and (B, 2) evaluations of the whole
        population from this rank's block: one zero-padded SUM all-reduce
        in float64 (exact: one contributor a member)."""
        K = ys.shape[0]
        full = torch.zeros((K, self.B, ys.shape[2]), dtype=torch.float64,
                           device=self.device)
        full[:, self._lo:self._hi] = ys.to(torch.float64)
        ev = torch.zeros((self.B, 2), dtype=torch.float64,
                         device=self.device)
        ev[self._lo:self._hi] = evals
        vec = torch.cat([full.reshape(-1), ev.reshape(-1)])
        dist.all_reduce(vec, group=self._group)
        return (vec[:full.numel()].reshape(full.shape),
                vec[full.numel():].reshape(ev.shape))

    def _fed(self, b: int):
        """The standalone federation of member ``b``, built on this rank
        (a sharded population builds only its block)."""
        if not self._lo <= b < self._hi:
            raise ValueError(
                f"population: member {b} runs on another rank (this rank "
                f"runs members {self._lo}-{self._hi - 1})")
        return self.federations[b - self._lo]

    # ------------------------------------------------------------------ #
    # per-member serve surface (checkpoint/resume in single-tenant format)
    # ------------------------------------------------------------------ #
    def member(self, b: int) -> "PopulationMember":
        return PopulationMember(self, int(b))

    def member_rounds(self, b: int) -> int:
        return self._rounds[b]

    def member_energy(self, b: int) -> float:
        return self._energy_used[b]

    def member_state(self, b: int) -> FleetState:
        """Member ``b``'s slice of the batched state, a single-tenant
        `FleetState` (views, no copy); on this rank's block only."""
        i = self._index(b)
        return _state_of({k: v[i] for k, v in self.state.tensors().items()})

    def _index(self, b: int) -> int:
        """Member ``b``'s slot in this rank's batched state."""
        self._fed(b)
        return b - self._lo

    def _member_resumable(self, b: int) -> dict:
        return {"fleet": fleet_tree(self.member_state(b), self.task.layout),
                "times": self._scan_times[self._index(b)]}

    def _restore_member(self, b: int, tree: dict, *, rounds: int,
                        energy: float) -> None:
        fleet = tree["fleet"]
        if not isinstance(fleet, FleetState):
            fleet = fleet_state_from_numpy(fleet, self.device)
        new = fleet.tensors()
        i = self._index(b)

        def put(L, l):
            L = L.clone()
            L[i] = l.to(L.dtype)
            return L
        self.state = _state_of({k: put(v, new[k])
                                for k, v in self.state.tensors().items()})
        self._scan_times = put(self._scan_times, torch.as_tensor(
            tree["times"], dtype=torch.float32).to(self.device))
        self._rounds[b] = int(rounds)
        self._energy_used[b] = float(energy)
        sync_queue = getattr(self._fed(b).controller, "sync_queue", None)
        if sync_queue is not None:
            sync_queue(self.state.queue[i])


class _MemberEngineView:
    """The engine half of a `PopulationMember`: exactly the resumable
    surface `repro_torch.serve.runner` drives, backed by slices of the
    stacked population state, so member checkpoints are single-tenant
    run-dir checkpoints."""

    def __init__(self, pop: PopulationEngine, b: int):
        self._pop = pop
        self.b = b

    @property
    def spec(self):
        return self._pop.specs[self.b]

    @property
    def round(self) -> int:
        return self._pop.member_rounds(self.b)

    @property
    def energy_used(self) -> float:
        return self._pop.member_energy(self.b)

    def resumable_state(self) -> dict:
        return self._pop._member_resumable(self.b)

    def restore_resumable(self, tree: dict, *, rounds: int,
                          energy: float) -> None:
        self._pop._restore_member(self.b, tree, rounds=rounds,
                                  energy=energy)


class PopulationMember:
    """A federation-shaped facade over one population slot: what
    `repro_torch.serve.runner.save_resumable` / `restore_resumable`
    consume."""

    def __init__(self, pop: PopulationEngine, b: int):
        self.engine = _MemberEngineView(pop, b)
        self.controller = pop._fed(b).controller
        self.spec = pop.specs[b]
