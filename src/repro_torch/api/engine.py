"""The device-scale engine of the port: the paper's §IV-D asynchronous
clustered federation, one cluster round at a time, on the card.

The state of the whole federation is one `FleetState` of tensors on
``device``: twins, reputations, channel states, the stacked cluster models
and the global model (both flat float32, `kernels.ops` layout), the
per-cluster update rounds, the Eqn-12 queue and the round counter.

`DeviceScaleEngine._fleet_round` is one asynchronous cluster round: the
Alg.-2 bound, the padded batch gather, batched local SGD of all members,
Eqns 4-5 trust, Eqn 6 + Eqn 19 aggregation in one pass of the CUDA
``trust_aggregate_global`` kernel, Eqns 7-8 energy, the twin update and the
Eqn-12 queue.  Ragged clusters run as one fixed-shape round over a padded
(n_clusters, M) membership table whose padding slots hold the sentinel id
``n`` (`core.twin.take` / `put` read fills and drop writes for it).

Under differential privacy (``spec.privacy.clip > 0``), and for a rule
without ``aggregate_with_global`` (the robust rules), Eqn 6 and Eqn 19 are
two steps: the rule's aggregate, or `core.privacy.dp_aggregate` through
the masked ``trust_aggregate`` kernel, replaces the cluster's row, and
`core.trust.time_weighted_average` takes Eqn 19 through the unmasked
kernel.  Krum and multi-krum have no masked variant: they run on each
cluster's exact member list, on the event heap only.  An active
`FaultSpec` adds the `faults.FaultModel` transformations at the JAX
package's places in the round; each family is gated by a Python bool, so
an inert spec runs and draws exactly what the fault-free round does.

Two entry points drive the round:

  run           the host event heap (per-round evaluation, ``sim_seconds``
                cutoffs); the controller's ``select`` runs on the host.
  run_scanned   exactly K rounds with the controller on the card: cluster
                scheduling by argmin over the per-cluster event times, the
                policy's step, the round and the queue stay on the device,
                and the per-round metrics are read back once at the end,
                where the float64 energy tally is rebuilt from the float32
                consumptions by sequential host additions.

In both, the local-step count ``a`` is read to the host once per round: it
sets the number of SGD steps.  (A sync-free round, a masked loop of
``n_actions`` steps under a CUDA graph, is queued in ROADMAP.md.)  The
round is pure: it returns a new `FleetState` and leaves the one it was
handed as it was.

Serving: `set_trace_sink` streams the records (``repro_torch.serve``
keeps none in memory), `set_obs` attaches telemetry
(`repro_torch.obs.EngineObs`: spans, per-segment metrics, kernel-library
loads as compile events), and `resumable_state` / `restore_resumable`
give the checkpointed state, in the JAX package's `FleetState` layout
(`FleetTree`).  Telemetry reads only what a round already reads back: an
instrumented run's trace equals an uninstrumented one's, bit for bit.

Randomness: every per-round draw (batch rows, channel noise, next channel
states, and where the spec turns them on the DP normals and the fault
uniforms and normals) is a counter-based function of (seed, round,
stream, device id, index) from `repro_torch.rng`, through the ``draws``
attribute; the parity tests replace it with the JAX package's draws.
Init-time draws come from CPU generators seeded from ``spec.seed``.

Placement: a sharded spec that resolves to ``impl='gspmd'`` (every
multi-axis mesh, ``impl='gspmd'`` on a 1-D mesh, and the ``device-gspmd``
scale, `DeviceScaleGspmdEngine`) runs this engine on one
``torch.distributed`` rank a shard, the JAX package's partitioner-inferred
path: the `FleetState` leaves are DTensors committed to their leaf
groups' placements (`repro_torch.api.placement`), the same round code runs
on them, DTensor's sharding propagation supplies the collectives (the
all-gathers of membership gathers that do not line up with the shards),
the trust kernels launch on every rank's local tensors through their
DTensor sharding rules, and the round's outputs go back to the at-rest
placements.  Reads to the host (``a``, the records, the evaluation) take
replicated values; checkpoints hold whole tensors and re-shard on
restore.  A 1-D ``shard_map`` spec builds the cluster-major engine
instead (`from_spec`).

`DatacenterEngine` (``scale="datacenter"``) drives the federated LM step
of `repro_torch.core.fl_step` instead: one round a step over every
client, the controller choosing ``a`` from a one-cluster context.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import math
import types
from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.control import policy as ctl_policy
from repro_torch.control import queue as ctl_queue
from repro_torch.core.clustering import (cluster_devices, ensure_nonempty,
                                         padded_membership, tolerance_bound)
from repro_torch.core.energy import (channel_cdf, draw_noise,
                                     round_energy, step_channel)
from repro_torch.core import fl_step
from repro_torch.core.envs import OBS_DIM
from repro_torch.core.privacy import dp_aggregate
from repro_torch.core.trust import (belief, gradient_diversity,
                                    learning_quality, staleness_weights,
                                    time_weighted_average, trust_weights,
                                    update_reputation)
from repro_torch.core.twin import (MEMBER_FILLS, TwinState, calibrate,
                                   calibrated_freq, draw_twins,
                                   observe_round_members, put,
                                   sample_deviation, take)
from repro_torch.data.federated import (dirichlet_partition,
                                        padded_partition,
                                        sample_member_batch)
from repro_torch.data.synthetic import (SyntheticClassification,
                                        SyntheticTelemetry,
                                        make_classification,
                                        make_iot_telemetry)
from repro_torch.device import is_dtensor, resolve_device
from repro_torch.faults.model import FaultModel
from repro_torch.kernels import build as kernel_build
from repro_torch.kernels.ops import leaf_views
from repro_torch.obs.spans import fence
from repro_torch.optim import adam

from . import placement as placement_lib
from .components import ControllerCtx
from .placement import gather, whole
from .records import FLTrace, RoundRecord
from .registry import register_engine
from .spec import (DATACENTER_SCALE, DEVICE_SCALE, GSPMD_DEVICE_SCALE,
                   GSPMD_IMPL, SHARD_MAP_IMPL, FederationSpec)


@dataclasses.dataclass
class FleetState:
    """Struct-of-arrays state of the whole federation, tensors on one
    device.  A round builds a new state and changes no tensor of the one
    it was handed."""
    twins: TwinState            # per-device digital twins (n,)
    rep: torch.Tensor           # (n,) Eqn-5 reputations
    channel: torch.Tensor       # (n,) Markov channel state, int64
    cluster_flat: torch.Tensor  # (n_clusters, N) stacked cluster models
    global_flat: torch.Tensor   # (N,) Eqn-19 global model
    cluster_ts: torch.Tensor    # (n_clusters,) last-update round, f32
    queue: torch.Tensor         # () Eqn-12 Lyapunov deficit backlog, f32
    round: torch.Tensor         # () global round counter, int64

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor of the state by name (twins as ``twins.<field>``)."""
        out = {f"twins.{f.name}": getattr(self.twins, f.name)
               for f in dataclasses.fields(TwinState)}
        out.update({f.name: getattr(self, f.name)
                    for f in dataclasses.fields(self) if f.name != "twins"})
        return out


class RoundDraws(NamedTuple):
    """The random numbers one round consumes.  The optional fields are
    drawn only where the spec turns their family on (None otherwise); the
    per-member ones are keyed by the member slots' device ids before
    dropout."""
    sel: torch.Tensor       # (M, local_batch) int64 dataset rows per member
    noise: torch.Tensor     # (M,) f32 Poisson channel-noise counts
    channel: torch.Tensor   # (n,) int64 next channel state of every device
    dp_normal: Optional[torch.Tensor] = None       # (N,) DP noise normals
    drop_u: Optional[torch.Tensor] = None          # (M,) dropout uniforms
    straggle_u: Optional[torch.Tensor] = None      # (M,) straggler uniforms
    spike_u: Optional[torch.Tensor] = None         # (M,) twin-spike uniforms
    corrupt_normal: Optional[torch.Tensor] = None  # (M, N) gaussian mode


class MemberRound(NamedTuple):
    """What `DeviceScaleEngine._member_round` hands back, all over the (M,)
    member slots after dropout."""
    members: torch.Tensor   # (M,) device ids, sentinel where masked
    mask: torch.Tensor      # (M,) bool
    mask_f: torch.Tensor    # (M,) f32
    cnt: torch.Tensor       # 0-d live-member count, at least 1
    new: torch.Tensor       # (M, N) the members' trained models
    upd: torch.Tensor       # (M, N) their deltas from the cluster model
    w: torch.Tensor         # (M,) Eqn-5 trust weights
    rep_m: torch.Tensor     # (M,) updated reputations
    losses: torch.Tensor    # (M,) local losses
    e: torch.Tensor         # (M,) consumed energy, 0 where masked
    loss: torch.Tensor      # 0-d mean local loss of the live members


class FleetTree(NamedTuple):
    """A `FleetState` in the JAX package's `FleetState` layout, without its
    PRNG key: the flat models cut into their parameter leaves (dicts of
    views, no copy), so that a checkpoint names each leaf as the JAX
    package's does (``fleet/.cluster_params/w1``, ``fleet/.round``)."""
    twins: TwinState
    rep: torch.Tensor
    channel: torch.Tensor
    cluster_params: Dict[str, torch.Tensor]   # leaves (n_clusters, ...)
    global_params: Dict[str, torch.Tensor]
    cluster_ts: torch.Tensor
    queue: torch.Tensor
    round: torch.Tensor


def fleet_tree(state: FleetState, layout) -> FleetTree:
    """``state`` as a `FleetTree`; ``layout`` is the task's flat layout
    (`kernels.ops.layout_of`)."""
    return FleetTree(
        twins=state.twins, rep=state.rep, channel=state.channel,
        cluster_params=leaf_views(state.cluster_flat, layout),
        global_params=leaf_views(state.global_flat, layout),
        cluster_ts=state.cluster_ts, queue=state.queue, round=state.round)


def fleet_state_from_numpy(tree, device, *, population: bool = False
                           ) -> FleetState:
    """The port's `FleetState` from the JAX package's, or from a
    `FleetTree` (leaves as tensors, numpy, or anything ``np.asarray``
    takes; a PRNG key is not carried).  With ``population=True`` every leaf
    has a leading population axis (the JAX package's `PopulationEngine`
    state): the result is a population's batched `FleetState`, each tensor
    with that axis first (``cluster_flat`` (P, n_clusters, N))."""
    dev = torch.device(device)
    lead = 1 if population else 0

    def t(a, dtype=torch.float32):
        a = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
        return a.to(device=dev, dtype=dtype)

    def flat(params, rows: bool):
        keep = lead + int(rows)         # leading dims that are not a leaf's
        leaves = [t(params[k]) for k in sorted(params)]
        return torch.cat([v.reshape(*v.shape[:keep], -1) for v in leaves],
                         dim=-1)

    twins = TwinState(**{f.name: t(getattr(tree.twins, f.name))
                         for f in dataclasses.fields(TwinState)})
    return FleetState(
        twins=twins, rep=t(tree.rep), channel=t(tree.channel, torch.int64),
        cluster_flat=flat(tree.cluster_params, True),
        global_flat=flat(tree.global_params, False),
        cluster_ts=t(tree.cluster_ts), queue=t(tree.queue),
        round=t(tree.round, torch.int64))


def _row(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``t[c]`` for a 0-d index tensor on the device, without reading it
    back to the host."""
    return t.index_select(0, c.reshape(1))[0]


def _with_row(t: torch.Tensor, c: torch.Tensor, v) -> torch.Tensor:
    """A copy of ``t`` with ``t[c] = v``, ``c`` a 0-d index tensor on the
    device (``t`` is left as it was).  A DTensor ``t`` takes the same
    values by a select against its row ids, which keeps its rows where
    they are (DTensor has no sharding strategy for ``index_copy`` in every
    PyTorch version the port runs on).  A plain ``t`` keeps the
    ``index_copy``: with the select forms here and in `core.twin.put` as
    the only path, the unsharded ``paper-mlp-fleet1k`` round dispatched 30
    more device ops and ran 47.3-55.1 scanned rounds/s against 66.1-73.4
    (H100, ``scripts/port_profile.py``, two runs of each in one call)."""
    if is_dtensor(t):
        rows = torch.arange(t.shape[0], device=t.device) == c
        return torch.where(rows.reshape((-1,) + (1,) * (t.dim() - 1)),
                           v.reshape(tuple(t.shape[1:])), t)
    return t.index_copy(0, c.reshape(1),
                        v.reshape((1,) + tuple(t.shape[1:])))


Data = Union[SyntheticClassification, SyntheticTelemetry]


def _as_data(data, device) -> Data:
    """The dataset's ``x``/``y`` (and the telemetry's ``device_type``) as
    tensors on ``device``, from tensors or arrays such as the JAX
    package's."""
    def t(a, dtype):
        a = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
        return a.to(device=device, dtype=dtype)
    x, y = t(data.x, torch.float32), t(data.y, torch.int64)
    if hasattr(data, "device_type"):
        return SyntheticTelemetry(x=x, y=y, device_type=t(
            data.device_type, torch.int64))
    return SyntheticClassification(x=x, y=y, prototypes=None)


class DeviceScaleEngine:
    """Discrete-event asynchronous clustered FL over a device fleet."""

    def __init__(self, spec: FederationSpec, data, parts, *, controller,
                 aggregator, task, device=None, assign=None, state=None):
        if spec.scale not in (DEVICE_SCALE, GSPMD_DEVICE_SCALE):
            raise ValueError(f"DeviceScaleEngine runs scale={DEVICE_SCALE!r}"
                             f" or {GSPMD_DEVICE_SCALE!r}, got {spec.scale!r}")
        dev = resolve_device(device)
        self.device = dev
        # where the fleet lives: this engine is the partitioner-inferred
        # path, so a sharded spec resolves under impl='gspmd''s strict
        # rules even where it defaults to shard_map (the JAX package's
        # DeviceScaleEngine does the same); unsharded: SINGLE_DEVICE
        self.placement = placement_lib.resolve(
            spec.sharding, n_devices=spec.fleet.n_devices,
            n_clusters=spec.clustering.n_clusters, device=dev,
            impl=GSPMD_IMPL)
        self.spec = spec
        self.data = _as_data(data, dev)
        self.parts = parts
        self.controller = controller
        self.aggregator = aggregator
        self.task = task

        n = spec.fleet.n_devices
        C = spec.clustering.n_clusters
        gen = rng.generator(spec.seed, rng.INIT)
        twins = draw_twins(n, gen)
        twins = sample_deviation(
            twins, torch.rand((n,), generator=gen) * spec.fleet.dt_max_dev)
        twins = twins.replace(data_size=torch.tensor(
            [len(p) for p in parts], dtype=torch.float32))
        init_idx = torch.randperm(n, generator=gen)[:C]
        if assign is None:
            assign, _ = cluster_devices(twins, C, init_idx)
        self.assign = ensure_nonempty(np.asarray(assign), C)
        table, mask = padded_membership(self.assign, C)
        self._member_table = table.to(dev)
        self._member_mask = mask.to(dev)
        self._member_mask_f = mask.to(torch.float32).to(dev)

        self.malicious = np.zeros(n, bool)
        n_mal = int(spec.fleet.malicious_frac * n)
        if n_mal:
            self.malicious[torch.randperm(n, generator=gen)[:n_mal].numpy()] \
                = True
        self._malicious_dev = torch.as_tensor(self.malicious,
                                              dtype=torch.float32,
                                              device=dev)
        # the fault model; its Byzantine subsets count as misbehaving in the
        # Eqn-4 tallies, as the label flippers do (inert: both are zero)
        self.faults = FaultModel(spec.faults, n, feat=self.data.x.shape[1],
                                 device=dev)
        self._misbehaving_dev = torch.maximum(
            self._malicious_dev, torch.maximum(self.faults.corrupt_dev,
                                               self.faults.poison_dev))
        self._fault_seed = (rng.fault_seed(spec.seed, spec.faults.seed)
                            if self.faults.active else None)
        # mask-aware rules share the padded round; krum and multi-krum run
        # on each cluster's exact member list (event heap only)
        self._padded = bool(getattr(aggregator, "supports_mask", False))
        if not self._padded:
            self._members = [torch.as_tensor(np.where(self.assign == k)[0],
                                             dtype=torch.int64, device=dev)
                             for k in range(C)]
            self._masks = [torch.ones(m.shape, dtype=torch.bool, device=dev)
                           for m in self._members]
        # Eqns 6 + 19 in one kernel pass, where the rule has it and DP,
        # which needs the bare aggregate, is off
        self._fuse_global = (self._padded and hasattr(
            aggregator, "aggregate_with_global")
            and spec.privacy.clip <= 0.0)

        gflat = task.init(gen, dim=self.data.x.shape[1])
        # (offset, size) of each leaf in the flat layout
        self._segments = [(off, int(torch.Size(shape).numel()))
                          for _, shape, off in task.layout]
        if state is None:
            state = FleetState(
                twins=TwinState(**{f.name: getattr(twins, f.name).to(dev)
                                   for f in dataclasses.fields(TwinState)}),
                rep=torch.ones((n,), device=dev),
                channel=torch.zeros((n,), dtype=torch.int64, device=dev),
                cluster_flat=gflat.expand(C, -1).clone().to(dev),
                global_flat=gflat.to(dev),
                cluster_ts=torch.zeros((C,), device=dev),
                queue=ctl_queue.init_leaf(device=dev),
                round=torch.zeros((), dtype=torch.int64, device=dev))
        self.state = state
        self._queue_per_slot = ctl_queue.per_slot_of(controller)

        part_idx, part_len = padded_partition(parts)
        self._part_idx = part_idx.to(dev)
        self._part_len = part_len.to(dev)
        self._trans_cdf = channel_cdf(spec.channel.p_good).to(dev)
        self._dev_ids = torch.arange(n, device=dev)
        self._zero = torch.zeros((), dtype=torch.int64, device=dev)
        self._batch_idx = torch.arange(spec.local_batch, device=dev)
        self._cidx = torch.arange(C, device=dev)
        self._n_actions = int(getattr(controller, "n_actions", 10))
        self._needs_ctx = bool(getattr(controller, "needs_ctx", True))
        self._rounds = 0
        # cumulative energy in float64 on the host, from the float32
        # per-round consumptions
        self._energy_used = 0.0
        # per-cluster next-event times of the scanned path, carried across
        # run_scanned calls so run_scanned(K) twice continues run_scanned(2K)
        self._scan_times = torch.zeros((C,), device=dev)
        # the per-round random draws: (state, members) -> RoundDraws
        self.draws = self._own_draws
        # streamed traces and telemetry (`set_trace_sink`, `set_obs`)
        self.trace_sink = None
        self.trace_retain = True
        self.obs = None
        self._on_library_load = None
        if self.placement.is_gspmd:
            self._commit_placement()

    def _commit_placement(self) -> None:
        """Commit the state to its leaf groups' placements (the JAX
        package's ``shard_state``), the membership tables replicated, the
        device ids with the device group and the scanned path's event
        times with the cluster group; every rank's DQN net becomes rank
        0's.  The other tables of the round stay plain tensors, which the
        round treats as replicated (`placement.replicated_constants`)."""
        pl = self.placement
        self.state = pl.shard_state(self.state)
        self._member_table = pl.distribute(self._member_table)
        self._member_mask = pl.distribute(self._member_mask)
        self._member_mask_f = pl.distribute(self._member_mask_f)
        self._dev_ids = pl.distribute(self._dev_ids, pl.device_axis)
        self._misbehaving_dev = pl.distribute(self._misbehaving_dev,
                                              pl.device_axis)
        self._scan_times = pl.distribute(self._scan_times, pl.cluster_axis)
        self._share_policy()

    def _share_policy(self) -> None:
        """A DQN controller's deployed net from rank 0 to every rank (one
        broadcast at build), so that every rank picks the same actions
        whatever its own pretraining computed (a sharded DQN federation
        pretrains on rank 0 alone: `api.federation._controller_params`)."""
        agent = getattr(self.controller, "agent", None)
        params = getattr(agent, "eval_params", None)
        if self.placement.world_size == 1 or not isinstance(params, dict):
            return
        keys = sorted(params)
        flat = torch.cat([params[k].reshape(-1).to(torch.float32)
                          for k in keys])
        dist.broadcast(flat, src=0, group=self.placement.group)
        out, off = {}, 0
        for k in keys:
            v = params[k]
            out[k] = flat[off:off + v.numel()].reshape(v.shape).to(v.dtype)
            off += v.numel()
        self.controller.restore_policy_state(out)

    def _spmd(self):
        """The context a round of the partitioner-inferred placement runs
        in (plain tensors mixed with its DTensors are replicated); nothing
        on one device."""
        if self.placement.is_gspmd:
            return placement_lib.replicated_constants()
        return contextlib.nullcontext()

    @classmethod
    def from_spec(cls, spec: FederationSpec, *, controller, aggregator, task,
                  device=None, data=None, parts=None, assign=None,
                  state=None) -> "DeviceScaleEngine":
        """Build from a spec; ``data``/``parts``/``assign``/``state``
        override what the engine would generate from ``spec.seed``.  A
        1-D mesh whose resolved impl is ``shard_map`` builds the
        cluster-major engine (`repro_torch.api.cluster_engine`) on this
        rank; ``impl='gspmd'``, a multi-axis mesh and the ``device-gspmd``
        scale build this engine on the partitioner-inferred placement.
        ``cls is`` keeps the subclasses from re-dispatching."""
        if data is None or parts is None:
            data, parts = default_device_data(spec)
        if (cls is DeviceScaleEngine and spec.sharding.is_sharded
                and spec.sharding.resolved_impl() == SHARD_MAP_IMPL):
            from .cluster_engine import ClusterMajorEngine
            return ClusterMajorEngine(
                spec, data, parts, controller=controller,
                aggregator=aggregator, task=task, device=device,
                assign=assign, state=state)
        return cls(spec, data, parts, controller=controller,
                   aggregator=aggregator, task=task, device=device,
                   assign=assign, state=state)

    # ------------------------------------------------------------------ #
    # streamed traces + resumable state (the `repro_torch.serve` surface)
    # ------------------------------------------------------------------ #
    def set_trace_sink(self, sink, *, retain: bool = True) -> None:
        """Stream every emitted `RoundRecord` to ``sink`` (an object with
        ``append(RoundRecord)``, e.g. `repro_torch.api.records.JsonlSink`).
        ``retain=False`` stops the trace from also accumulating records in
        memory — required for unbounded service runs."""
        self.trace_sink = sink
        self.trace_retain = bool(retain)

    def _new_trace(self) -> FLTrace:
        return FLTrace(sink=self.trace_sink, retain=self.trace_retain)

    def set_obs(self, obs) -> None:
        """Attach an `repro_torch.obs.EngineObs` telemetry bundle (``None``
        detaches).  The engine publishes per-segment round aggregates,
        state summaries, kernel-library loads (as compile events) and
        fault tallies into it.  Attaching telemetry adds no read inside a
        round: emitted traces stay bit-identical to an uninstrumented run
        (pinned by tests/test_torch_obs.py)."""
        if self._on_library_load is not None:
            kernel_build.load_listeners.remove(self._on_library_load)
            self._on_library_load = None
        self.obs = obs
        if obs is not None:
            obs.publish_static(self)
            self._on_library_load = obs.record_compile
            kernel_build.load_listeners.append(self._on_library_load)

    def _obs_span(self, name: str, fence_on=None, **attrs):
        if self.obs is None:
            return contextlib.nullcontext()
        return self.obs.span(name, fence_on=fence_on, **attrs)

    def obs_state_summary(self) -> dict:
        """Host scalars for the telemetry gauges: Eqn-12 deficit-queue
        level, Eqn-4 trust-weight (reputation) summary stats, and the
        fleet's total β (negative-interaction) tally.  One read of a small
        reduction over `FleetState`, never part of the round (sharded: a
        collective, which every rank calls)."""
        st = self.state
        vals = torch.stack([whole(v) for v in (
            st.queue, st.rep.min(), st.rep.mean(), st.rep.max(),
            st.twins.beta.sum())]).tolist()
        return dict(zip(("queue_deficit", "reputation_min",
                         "reputation_mean", "reputation_max",
                         "twin_beta_sum"), vals))

    @property
    def scan_times(self) -> torch.Tensor:
        """The carried per-cluster next-event times of the scanned path."""
        return whole(self._scan_times)

    def resumable_state(self) -> dict:
        """Everything on the device a resumed run needs, as one
        checkpointable tree: the full `FleetState` (as a `FleetTree`, the
        JAX package's leaf names; the port's draws need no key) plus the
        carried per-cluster event times.  The host scalars (round counter,
        f64 energy tally) ride in the checkpoint manifest instead.  Sharded
        leaves are gathered whole (a collective, which every rank calls),
        so a checkpoint moves between placements."""
        return {"fleet": fleet_tree(self.placement.full_state(self.state),
                                    self.task.layout),
                "times": whole(self._scan_times)}

    def restore_resumable(self, tree: dict, *, rounds: int,
                          energy: float) -> None:
        """Adopt a `resumable_state` tree (typically loaded through
        `repro_torch.checkpoint`) plus the manifest scalars.  The engine
        must have been built from the same spec (data, assignments and the
        malicious mask all derive from the spec seed, so a fresh process
        rebuilds them bit for bit)."""
        fleet = tree["fleet"]
        if not isinstance(fleet, FleetState):
            fleet = fleet_state_from_numpy(fleet, self.device)
        self.state = fleet
        self._scan_times = torch.as_tensor(
            tree["times"], dtype=torch.float32).to(self.device)
        if self.placement.is_gspmd:     # re-shard (the JAX package's
            pl = self.placement         # shard_state on restore)
            self.state = pl.shard_state(self.state)
            self._scan_times = pl.distribute(self._scan_times,
                                             pl.cluster_axis)
        self._rounds = int(rounds)
        self._energy_used = float(energy)
        sync_queue = getattr(self.controller, "sync_queue", None)
        if sync_queue is not None:      # host controller adopts the
            sync_queue(whole(self.state.queue))  # restored Eqn-12 backlog

    @property
    def round(self) -> int:
        return self._rounds

    @property
    def energy_used(self) -> float:
        return self._energy_used

    # legacy attribute views (the `AsyncFederation` shim, examples) ---- #
    @property
    def agg_count(self) -> int:
        return self._rounds

    @property
    def rep(self) -> torch.Tensor:
        """The reputations, whole (sharded: a collective)."""
        return whole(self.state.rep)

    # ------------------------------------------------------------------ #
    # randomness
    # ------------------------------------------------------------------ #
    def _own_draws(self, state: FleetState, members) -> RoundDraws:
        seed, r = self.spec.seed, state.round
        u = rng.uniform(seed, r, rng.BATCH, members[:, None],
                        self._batch_idx[None, :])
        sel = sample_member_batch(u, self._part_idx, self._part_len, members)
        ch_m = take(state.channel, members, 0)
        noise = draw_noise(rng.uniform(seed, r, rng.NOISE, members, 0), ch_m)
        channel = step_channel(
            rng.uniform(seed, r, rng.CHANNEL, self._dev_ids, 0),
            state.channel, self._trans_cdf)
        extra = {}
        if self.spec.privacy.clip > 0.0:
            extra["dp_normal"] = rng.normals(seed, r, rng.DP_NOISE,
                                             self._zero,
                                             state.global_flat.shape[0])
        fm, fs = self.faults, self._fault_seed
        for on, name, stream in ((fm.may_drop, "drop_u", rng.DROP),
                                 (fm.may_straggle, "straggle_u",
                                  rng.STRAGGLE),
                                 (fm.may_spike, "spike_u", rng.SPIKE)):
            if on:
                extra[name] = rng.uniform(fs, r, stream, members, 0)
        if fm.may_corrupt and fm.spec.corrupt_mode == "gaussian":
            extra["corrupt_normal"] = rng.normals(
                fs, r, rng.CORRUPT, members, state.global_flat.shape[0])
        return RoundDraws(sel=sel, noise=noise, channel=channel, **extra)

    # ------------------------------------------------------------------ #
    # the round
    # ------------------------------------------------------------------ #
    def _cluster_freq_table(self, twins: TwinState) -> torch.Tensor:
        """Straggler (min) calibrated frequency of every cluster, (C,),
        from the whole frequencies (`placement.gather` on the partitioner-
        inferred placement: a plain tensor, the same on every rank)."""
        fmat = take(gather(calibrated_freq(twins)),
                    self._member_table, float("inf"))
        fmin = torch.where(self._member_mask, fmat, float("inf")).min(
            dim=1).values
        return torch.where(self._member_mask.any(dim=1), fmin, 1.0)

    def _fleet_round(self, state: FleetState, c: torch.Tensor, a_raw,
                     members=None, mask=None):
        """One asynchronous cluster round (paper §IV-D), state -> state.

        ``c`` is the cluster, a 0-d int64 tensor on the device; ``a_raw``
        the controller's raw choice (int or 0-d tensor); ``members`` /
        ``mask`` the cluster's exact member ids and an all-true mask, or
        None for its padded membership row.  Returns the new state and the
        round's metrics as 0-d device tensors.

        It is `_round_choice`, the one read of ``a`` back to the host, the
        draws and `_round_apply`; a population runs the two halves over
        all its members and reads the largest ``a`` in between.

        On the partitioner-inferred placement the same code runs on the
        state's DTensors: DTensor's propagation gathers what a step needs
        (the members' rows of the device group, the cluster model), and
        the new state and the metrics go back to their at-rest placements
        (the JAX package's ``out_shardings``)."""
        with self._spmd():
            members, mask, mask_f = self._round_members(c, members, mask)
            a = self._round_choice(state, c, a_raw)
            steps = int(whole(a))   # the round's one read back to the host
            draws = self._round_draws(state, members)
            new_state, metrics = self._round_apply(
                state, c, a, steps, members, mask, mask_f, draws)
            if self.placement.is_gspmd:
                pl = self.placement
                new_state = pl.pin_state(new_state)
                metrics = {k: pl.pin(v) for k, v in metrics.items()}
        return new_state, metrics

    def _round_draws(self, state: FleetState, members) -> "RoundDraws":
        """The round's draws.  Injected draws (the parity tests' JAX draws)
        read whole tensors: on the partitioner-inferred placement they get
        the round, the channel and the model width of the whole state and
        the members' ids, and return plain tensors, which the round treats
        as replicated."""
        if not self.placement.is_gspmd or self.draws == self._own_draws:
            return self.draws(state, members)
        view = types.SimpleNamespace(round=whole(state.round),
                                     channel=whole(state.channel),
                                     global_flat=whole(state.global_flat))
        return self.draws(view, whole(members))

    def _round_members(self, c, members=None, mask=None):
        """(member ids, bool mask, float mask) of cluster ``c``'s round:
        its padded membership row, or the exact list it was given."""
        if members is None:
            return (_row(self._member_table, c), _row(self._member_mask, c),
                    _row(self._member_mask_f, c))
        return members, mask, mask.to(torch.float32)

    def _round_choice(self, state: FleetState, c: torch.Tensor, a_raw
                      ) -> torch.Tensor:
        """The controller's raw choice capped by the Alg.-2 tolerance
        bound: the round's local-step count ``a``, a 0-d int32 tensor."""
        spec = self.spec
        cluster_freq = self._cluster_freq_table(state.twins)
        if not torch.is_tensor(a_raw):
            a_raw = torch.full((), int(a_raw), dtype=torch.int32,
                               device=self.device)
        a_req = torch.clamp(a_raw.to(torch.int32), 1, self._n_actions)
        t_ref = a_req.to(torch.float32) / torch.clamp(cluster_freq.max(),
                                                      min=1e-6)
        alpha = torch.clamp(
            spec.clustering.alpha0 + spec.clustering.alpha_growth
            * state.round.to(torch.float32), max=1.0)
        a = tolerance_bound(a_req, _row(cluster_freq, c), t_ref, alpha)
        return torch.clamp(a, 1, self._n_actions)

    def _round_apply(self, state: FleetState, c: torch.Tensor, a, steps,
                     members, mask, mask_f, draws: "RoundDraws",
                     own_steps: bool = False):
        """The round after its ``a`` is chosen: ``steps`` local SGD steps
        (``steps == int(a)``; or, with ``own_steps``, the population's
        largest ``a``, of which this member keeps its own ``a``), trust,
        aggregation, energy, twins and the queue."""
        spec, fm = self.spec, self.faults
        m = self._member_round(state, _row(state.cluster_flat, c), a, steps,
                               members, mask, mask_f, draws, own_steps)
        members, mask, mask_f, cnt = m.members, m.mask, m.mask_f, m.cnt
        rep = put(state.rep, members, m.rep_m)
        consumed = m.e.sum()
        twins = observe_round_members(state.twins, members, m.losses, m.e,
                                      self._misbehaving_dev)
        if spec.fleet.calibrate_dt:
            twins = calibrate(twins)

        # --- Eqn 6 + Eqn 19: cluster aggregate and staleness-weighted
        # global model (async pull: the cluster adopts the global model)
        rnd = state.round + 1
        ts = _with_row(state.cluster_ts, c, rnd.to(torch.float32))
        staleness = rnd.to(torch.float32) - ts
        # Eqn 19's reductions over the clusters run on whole tensors
        # (`placement.gather`: explicit collectives on a sharded state)
        whole_ = gather
        if self._fuse_global:
            gflat = self.aggregator.aggregate_with_global(
                m.new, m.w, mask_f, state.cluster_flat,
                staleness_weights(whole_(staleness)), c)
            cflat = state.cluster_flat
        else:
            cflat = _with_row(state.cluster_flat, c, self._eqn6(
                state, c, m.new, m.upd, m.w, mask, mask_f, cnt, draws))
            gflat, _ = time_weighted_average(whole_(cflat),
                                             whole_(staleness))
        cflat = _with_row(cflat, c, gflat)

        if fm.may_drop:
            # a cluster whose members all dropped skips its event: it spends
            # nothing and leaves every model, trust and twin tensor as it
            # was; the channel and the round counter advance
            empty = mask_f.sum() < 0.5

            def keep(old, new_):
                return torch.where(empty, old, new_)
            consumed = keep(torch.zeros_like(consumed), consumed)
            twins = TwinState(**{f.name: keep(getattr(state.twins, f.name),
                                              getattr(twins, f.name))
                                 for f in dataclasses.fields(TwinState)})
            rep = keep(state.rep, rep)
            cflat = keep(state.cluster_flat, cflat)
            gflat = keep(state.global_flat, gflat)
            ts = keep(state.cluster_ts, ts)

        # --- Eqn 12 with the realized consumption (+inf per slot: q = 0)
        queue = ctl_queue.queue_advance(state.queue, consumed,
                                        self._queue_per_slot)
        # --- round duration from the post-calibration straggler frequency
        dur = a.to(torch.float32) / torch.clamp(
            _row(self._cluster_freq_table(twins), c), min=1e-6)
        if fm.may_straggle:
            dur = fm.straggle(draws.straggle_u, dur, mask)

        new_state = FleetState(
            twins=twins, rep=rep, channel=draws.channel, cluster_flat=cflat,
            global_flat=gflat, cluster_ts=ts, queue=queue, round=rnd)
        metrics = {"a": a, "dur": dur, "consumed": consumed, "loss": m.loss}
        return new_state, metrics

    def _member_round(self, state: FleetState, cluster_flat, a, steps,
                      members, mask, mask_f, draws: "RoundDraws",
                      own_steps: bool = False, block=None) -> "MemberRound":
        """The members' half of a round, shared by every engine: drops,
        local batches, ``steps`` local SGD steps from the cluster model
        ``cluster_flat``, faults, trust (Eqns 4-5) and energy (Eqns 7-8).
        The members' rows of the fleet leaves are read by member id, or,
        with ``block``, as that slice of a cluster-major layout
        (`repro_torch.api.cluster_engine`), masked to the same values."""
        spec, task, twins, fm = self.spec, self.task, state.twins, self.faults

        # --- dropped members leave the mask and become the padding
        # sentinel, so every gather fills neutrally and every scatter drops
        # them, and they train on the sentinel's batch (dataset row 0, its
        # one-sample shard: `padded_partition`)
        sel = draws.sel
        if fm.may_drop:
            mask = fm.drop_mask(draws.drop_u, mask)
            members = torch.where(mask, members, spec.fleet.n_devices)
            sel = torch.where(mask[:, None], sel, 0)
            mask_f = mask.to(torch.float32)
        cnt = torch.clamp(mask_f.sum(), min=1.0)

        def view(x, fill):
            if block is None:
                return take(x, members, fill)
            return torch.where(mask, x[block], fill)

        # --- local batches
        x = self.data.x[sel]
        y = self.data.y[sel]
        if fm.may_poison:
            x = fm.poison_inputs(x, members)
        mal_m = take(self._malicious_dev, members, 0.0)
        y = torch.where(mal_m[:, None] > 0.5, task.corrupt_labels(y), y)

        # --- `steps` local SGD steps on every member, from the cluster model
        stacked = cluster_flat.expand(members.shape[0], -1)
        new = task.local_train(stacked, x, y, spec.lr, steps,
                               a if own_steps else None)
        if fm.may_corrupt:
            # Byzantine members replace their deltas before trust sees them
            new = fm.corrupt_updates(new, stacked, members, self._segments,
                                     draws.corrupt_normal)

        # --- trust (Eqns 4-5)
        upd = new - stacked
        q = learning_quality(upd, mask)
        div = gradient_diversity(upd, mask)
        tw_m = TwinState(**{f: view(getattr(twins, f), v)
                            for f, v in MEMBER_FILLS.items()})
        if fm.may_spike:
            tw_m = fm.spike_twins(draws.spike_u, tw_m, mask)
        b = belief(tw_m, q, spec.channel.pkt_fail, div)
        rep_m = update_reputation(view(state.rep, 1.0), b,
                                  spec.channel.pkt_fail, spec.iota)
        w = trust_weights(rep_m, mask)

        # --- losses and energy (Eqns 7-8)
        losses = task.losses(new, x, y)
        true_freq = view(twins.freq + twins.freq_dev, 1.0)
        e = round_energy(a.to(torch.float32), true_freq,
                         view(state.channel, 0), draws.noise) * mask_f
        return MemberRound(members=members, mask=mask, mask_f=mask_f,
                           cnt=cnt, new=new, upd=upd, w=w, rep_m=rep_m,
                           losses=losses, e=e,
                           loss=(losses * mask_f).sum() / cnt)

    def _eqn6(self, state: FleetState, c, new, upd, w, mask, mask_f, cnt,
              draws: RoundDraws) -> torch.Tensor:
        """The Eqn-6 aggregate of the two-step path: under DP the noised
        sum of the clipped deltas (`dp_aggregate`, weights ``w`` for trust,
        ``mask / cnt`` otherwise; the rule's own aggregate, which the JAX
        package computes and discards, is not computed), else the rule's
        aggregate of the members' parameters."""
        priv = self.spec.privacy
        if priv.clip > 0.0:
            weights = (w if self.spec.aggregator.kind == "trust"
                       else mask_f / cnt)
            return dp_aggregate(upd, weights, mask_f,
                                _row(state.cluster_flat, c), priv.clip,
                                priv.noise, cnt, draws.dp_normal)
        return self.aggregator(new, w, mask if self._padded else None)

    # ------------------------------------------------------------------ #
    # controller features
    # ------------------------------------------------------------------ #
    def _ctl_features(self, state: FleetState, c) -> Dict[str, torch.Tensor]:
        """The f32 scalars a frequency controller scores from, over the
        padded membership row of cluster ``c`` (0-d device tensors)."""
        twins = state.twins
        members = _row(self._member_table, c)
        mask = _row(self._member_mask, c)
        cnt = torch.clamp(_row(self._member_mask_f, c).sum(), min=1.0)
        loss_m = take(twins.loss, members, 0.0)
        loss = torch.where(mask, loss_m, 0.0).sum() / cnt
        loss = torch.nan_to_num(loss, nan=0.0, posinf=2.3)
        f_m = take(calibrated_freq(twins), members, 0.0)
        mean_freq = torch.where(mask, f_m, 0.0).sum() / cnt
        ch_m = take(state.channel, members, 1)
        good = torch.where(mask, (ch_m == 0).to(torch.float32), 0.0).sum() \
            / cnt
        return {"cluster_loss": loss, "mean_freq": mean_freq,
                "channel_good_frac": good,
                "cluster_freq": _row(self._cluster_freq_table(twins), c)}

    def _scan_obs(self, state: FleetState, c: torch.Tensor,
                  feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The §IV-B DQN observation (OBS_DIM,) on the device, one layout
        for the host path (`ControllerCtx.obs`) and the scanned path; it
        reads nothing back to the host.

        Slot 2 holds the Eqn-12 backlog, as in the environment the agent
        trained on (`core.envs._obs`).  Where the deployed layout departs
        from the environment's, it does as the JAX package's does: the
        one-hot encodes round % 10, not the last action, and tau (the
        cluster model's hidden-activation mean over the first 256 samples)
        stands where the spent-budget fraction would be.
        """
        tau = self.task.hidden_mean(_row(state.cluster_flat, c),
                                    self.data.x[:256])
        # (one_hot with its class count given reads nothing back on CUDA)
        ch3 = F.one_hot(state.channel, 3).to(torch.float32).mean(0)
        return ctl_policy.deploy_obs(
            feats["cluster_loss"], state.queue,
            state.round.to(torch.float32) / 100.0, tau, state.round % 10,
            ch3, feats["mean_freq"])

    def _lazy_obs(self, state: FleetState, c: torch.Tensor, feats=None):
        def obs():
            with self._spmd():
                f = (feats if feats is not None
                     else self._ctl_features(state, c))
                return whole(self._scan_obs(state, c, f))
        return obs

    def _ctx(self, c: int) -> ControllerCtx:
        cidx = self._cidx[c]
        with self._spmd():
            f = self._ctl_features(self.state, cidx)
            loss, freq, mean_freq, good = whole(torch.stack(
                [f["cluster_loss"], f["cluster_freq"], f["mean_freq"],
                 f["channel_good_frac"]])).tolist()
        return ControllerCtx(round=self._rounds, cluster=c,
                             obs=self._lazy_obs(self.state, cidx, f),
                             cluster_loss=loss, cluster_freq=freq,
                             mean_freq=mean_freq, channel_good_frac=good,
                             energy_used=self._energy_used)

    def _null_ctx(self, c: int) -> ControllerCtx:
        """Read-free ctx for ``needs_ctx=False`` controllers; the
        observation stays available, lazily."""
        return ControllerCtx(round=self._rounds, cluster=c,
                             obs=self._lazy_obs(self.state, self._cidx[c]),
                             cluster_loss=0.0, cluster_freq=1.0,
                             mean_freq=1.0, channel_good_frac=1.0,
                             energy_used=0.0)

    # ------------------------------------------------------------------ #
    # K rounds with the controller on the device
    # ------------------------------------------------------------------ #
    def run_scanned(self, K: int, *, eval_final: bool = True) -> FLTrace:
        """Run exactly K asynchronous cluster rounds, scheduled on the
        device by argmin over the per-cluster event times (ties go to the
        lowest cluster index, as the event heap's (t, c) order does), with
        the controller's `scan_policy` choosing each round's ``a``.  The
        per-round metrics are read back once, after round K; ``eval_final``
        appends one evaluation record of the final global model.
        Consecutive calls continue the schedule."""
        if not self._padded:
            raise ValueError(
                f"aggregator {type(self.aggregator).__name__} has "
                "supports_mask=False (exact-shape clusters); run_scanned "
                "needs the padded round: use run() instead")
        scan_policy = getattr(self.controller, "scan_policy", None)
        if scan_policy is None:
            raise ValueError(
                f"controller {type(self.controller).__name__} has no "
                "scan_policy(); use the event-heap run() instead")
        pol = scan_policy()
        state, times, ctl = self.state, self._scan_times, pol.state
        energy = torch.full((), self._energy_used, dtype=torch.float32,
                            device=self.device)
        no_obs = torch.zeros((OBS_DIM,), device=self.device)
        rows = []
        # the round span fences on the rows the segment reads back anyway
        with self._obs_span("round", mode="scanned", rounds=int(K)) as sp, \
                self._spmd():
            for _ in range(int(K)):
                # the whole times, the same on every rank: DTensor's
                # argmin of a sharded tensor gathers partial results
                c = torch.argmin(gather(times))
                t = _row(times, c)
                feats = self._ctl_features(state, c)
                cobs = ctl_policy.CtlObs(
                    round=state.round, cluster=c, queue=state.queue,
                    cluster_loss=feats["cluster_loss"],
                    cluster_freq=feats["cluster_freq"],
                    mean_freq=feats["mean_freq"],
                    channel_good_frac=feats["channel_good_frac"],
                    energy_used=energy,
                    dqn_obs=(self._scan_obs(state, c, feats)
                             if pol.needs_obs else no_obs))
                # the controller runs on every rank's whole copy of its
                # (replicated) inputs
                a_raw, ctl = pol.step(ctl, cobs._make(map(whole, cobs)))
                state, m = self._fleet_round(state, c, a_raw)
                times = _with_row(times, c, t + m["dur"])
                energy = energy + m["consumed"]
                rows.append(torch.stack([t, c.to(torch.float32),
                                         m["a"].to(torch.float32), m["dur"],
                                         m["consumed"], m["loss"]]))
            ys = whole(torch.stack(rows))
            if self.placement.is_gspmd:     # the carry's at-rest placement
                times = self.placement.pin(times,
                                           self.placement.cluster_axis)
            if sp is not None:
                sp.mark("dispatch")
                fence(ys)
        self.state = state
        self._scan_times = times
        return self._emit_scanned_trace(ys, eval_final)

    def _emit_scanned_trace(self, ys: torch.Tensor, eval_final: bool
                            ) -> FLTrace:
        """Records from the (K, 6) float32 rows (t, cluster, a, dur,
        consumed, loss) on the device, read back here once; the float64
        energy tally adds the float32 consumptions one by one, as the
        event loop does."""
        with self._obs_span("host_sync", rounds=ys.shape[0]):
            ys = ys.cpu().numpy()           # the one end-of-run read
        K = ys.shape[0]
        base = self._rounds
        self._rounds += K
        cum = []
        for ci in ys[:, 4]:
            self._energy_used += float(ci)
            cum.append(self._energy_used)
        sync_queue = getattr(self.controller, "sync_queue", None)
        if sync_queue is not None:            # host controller adopts the
            sync_queue(whole(self.state.queue))  # device-resident backlog
        if self.obs is not None:
            self.obs.on_segment(ys, K, engine=self)
        trace = self._new_trace()
        for i in range(K):
            trace.append(RoundRecord(
                t=float(ys[i, 0]), round=base + i + 1,
                cluster=int(ys[i, 1]), a=int(ys[i, 2]),
                loss=float(ys[i, 5]), acc=None, energy=cum[i],
                agg_count=base + i + 1))
        if eval_final and K:
            with self._obs_span("eval"):
                ev = self.task.evaluate(whole(self.state.global_flat),
                                        self.data)
            if self.obs is not None:
                self.obs.on_eval(ev["loss"], ev["acc"])
            trace.append(RoundRecord(
                t=float(ys[-1, 0]) + float(ys[-1, 3]), round=self._rounds,
                cluster=int(ys[-1, 1]), a=int(ys[-1, 2]), loss=ev["loss"],
                acc=ev["acc"], energy=self._energy_used,
                agg_count=self._rounds))
        return trace

    # ------------------------------------------------------------------ #
    # the host event heap
    # ------------------------------------------------------------------ #
    def run(self, eval_every: float = 1.0,
            max_rounds: Optional[int] = None) -> FLTrace:
        if self.spec.execution == "scanned":
            K = max_rounds if max_rounds is not None else self.spec.rounds
            return self.run_scanned(K)
        spec = self.spec
        trace = self._new_trace()
        events = [(0.0, c) for c in range(spec.clustering.n_clusters)]
        heapq.heapify(events)
        t = 0.0
        next_eval = 0.0
        done = 0
        while events and t < spec.sim_seconds:
            if max_rounds is not None and done >= max_rounds:
                break
            t, c = heapq.heappop(events)
            if t >= spec.sim_seconds:
                break
            ctx = self._ctx(c) if self._needs_ctx else self._null_ctx(c)
            a_raw = int(self.controller.select(ctx))
            exact = (None, None) if self._padded else (self._members[c],
                                                       self._masks[c])
            self.state, m = self._fleet_round(self.state, self._cidx[c],
                                              a_raw, *exact)
            self._rounds += 1
            done += 1
            a, dur, consumed, loss = whole(torch.stack(
                [m["a"].to(torch.float32), m["dur"], m["consumed"],
                 m["loss"]])).tolist()
            self._energy_used += consumed
            self.controller.observe(None, consumed, loss)
            if self.obs is not None:
                self.obs.on_round(cluster=c, a=int(a), dur=dur,
                                  consumed=consumed, loss=loss, engine=self)
            heapq.heappush(events, (t + dur, c))
            if t >= next_eval:
                with self._obs_span("eval"):
                    ev = self.task.evaluate(whole(self.state.global_flat),
                                            self.data)
                if self.obs is not None:
                    self.obs.on_eval(ev["loss"], ev["acc"])
                trace.append(RoundRecord(
                    t=t, round=self._rounds, cluster=c, a=int(a),
                    loss=ev["loss"], acc=ev["acc"],
                    energy=self._energy_used, agg_count=self._rounds))
                next_eval = t + eval_every
        return trace


def default_device_data(spec: FederationSpec):
    """Synthetic non-IID federated data from the task params, generated
    from ``spec.seed``.  Classification tasks draw the MNIST-shaped
    prototype mixture, partitioned by a Dirichlet draw over the labels;
    the reconstruction task draws IoT telemetry, partitioned over the
    device types (each client sees mostly one equipment family)."""
    p = spec.task.params
    gen = rng.generator(spec.seed, rng.DATA)
    if spec.task.kind == "autoencoder-anomaly":
        n_types = p.get("n_types", 8)
        data = make_iot_telemetry(
            gen, n=p.get("n_samples", 2048), dim=p.get("dim", 32),
            n_types=n_types, latent=p.get("latent", 4),
            anomaly_frac=p.get("anomaly_frac", 0.05),
            noise=p.get("noise", 0.05))
        parts = dirichlet_partition(data.device_type.numpy(),
                                    spec.fleet.n_devices,
                                    alpha=p.get("dirichlet_alpha", 0.5),
                                    n_classes=n_types, seed=spec.seed)
        return data, parts
    data = make_classification(gen, n=p.get("n_samples", 4096),
                               dim=p.get("dim", 784))
    parts = dirichlet_partition(data.y.numpy(), spec.fleet.n_devices,
                                alpha=p.get("dirichlet_alpha", 0.5),
                                seed=spec.seed)
    return data, parts


class DatacenterEngine:
    """The federated LM step (`core.fl_step`, mode A or B) under the
    federation spec and the trace schema (the JAX package's
    ``DatacenterEngine``).

    The controller picks each round's local-step count ``a`` exactly as at
    device scale, from a one-cluster context; reputations stay all ones
    (Eqn 6's weights uniform within a cluster) and staleness zero
    (synchronous clusters), as in the JAX package.  A round draws its
    token batch from a CPU generator seeded from ``spec.seed``, runs the
    step on ``device`` and records the mean client loss.  There is no
    energy model at this scale: records carry zero energy.
    """

    @classmethod
    def from_spec(cls, spec: FederationSpec, *, controller, aggregator=None,
                  task, device=None, data=None, parts=None, assign=None,
                  state=None) -> "DatacenterEngine":
        """``state`` (a `fl_step.TrainState`) replaces the one drawn from
        ``spec.seed``.  Eqn-6 weighting lives inside the step and the task
        draws its own batches: the aggregator and the device-scale data
        overrides are unused."""
        del aggregator, data, parts, assign
        return cls(spec, controller=controller, task=task, device=device,
                   state=state)

    def __init__(self, spec: FederationSpec, *, controller, task,
                 device=None, state=None):
        self.spec = spec
        self.controller = controller
        self.task = task
        self.device = resolve_device(device)
        self.n_clusters = spec.clustering.n_clusters
        self.clients = max(1, spec.fleet.n_devices // self.n_clusters)
        self.opt = adam(task.lr)
        if state is None:
            state = fl_step.build_init_fn(
                task.cfg, self.opt, mode=task.mode,
                n_clusters=self.n_clusters,
                clients_per_cluster=self.clients,
                device=self.device)(spec.seed)
        self.state = state
        self.rep = torch.ones((self.n_clusters, self.clients),
                              device=self.device)
        self.generator = torch.Generator().manual_seed(spec.seed)
        self._steps = {}

    def _step(self, a: int):
        if a not in self._steps:
            self._steps[a] = fl_step.build_train_step(
                self.task.cfg, self.opt, mode=self.task.mode,
                local_steps=a)
        return self._steps[a]

    def run(self, eval_every: float = 1.0,
            max_rounds: Optional[int] = None) -> FLTrace:
        del eval_every                      # every round is recorded
        spec, dev = self.spec, self.device
        trace = FLTrace()
        loss = float("nan")
        rounds = spec.rounds if max_rounds is None else min(spec.rounds,
                                                            max_rounds)
        for i in range(rounds):
            seen = 0.0 if math.isnan(loss) else loss
            feats = torch.tensor([seen, i / max(spec.rounds, 1), 0.0])
            ctx = ControllerCtx(
                round=i, cluster=0,
                obs=lambda f=feats: F.pad(f, (0, OBS_DIM - 3)).to(dev),
                cluster_loss=seen, cluster_freq=1.0, mean_freq=1.0,
                channel_good_frac=1.0, energy_used=0.0)
            a = max(1, min(int(self.controller.select(ctx)),
                           self.controller.n_actions))
            batch = self.task.make_batch(self.generator, self.n_clusters,
                                         self.clients, device=dev)
            stale = torch.zeros((self.n_clusters,), device=dev)
            self.state, metrics = self._step(a)(self.state, batch,
                                                self.rep, stale)
            loss = float(metrics["loss"].mean())
            # no energy model at datacenter scale: report zero consumption
            # (a raw step count would corrupt a Lyapunov queue's units)
            self.controller.observe(ctx, 0.0, loss)
            trace.append(RoundRecord(
                t=float(i), round=i + 1, cluster=-1, a=a, loss=loss,
                acc=None, energy=0.0, agg_count=i + 1))
        return trace

    def run_scanned(self, K: int, *, eval_final: bool = True) -> FLTrace:
        raise ValueError(
            "the datacenter engine has no scanned lowering (its round loop "
            "is already a fixed-shape jit step per round); use run()")


class DeviceScaleGspmdEngine(DeviceScaleEngine):
    """The partitioner-inferred path, pinned: ``scale='device-gspmd'`` runs
    `DeviceScaleEngine` itself even where a 1-D mesh would resolve to the
    cluster-major engine (the JAX package's ``DeviceScaleGspmdEngine``;
    the per-spec equivalent is ``ShardingSpec.impl='gspmd'``)."""


register_engine(DEVICE_SCALE)(DeviceScaleEngine)
register_engine(GSPMD_DEVICE_SCALE)(DeviceScaleGspmdEngine)
register_engine(DATACENTER_SCALE)(DatacenterEngine)
