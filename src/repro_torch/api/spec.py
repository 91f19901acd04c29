"""`FederationSpec`: the declarative description of a federation experiment.

A copy of the JAX package's ``repro.api.spec``: every dataclass keeps every
field and default, and `to_dict` / `from_dict` use the same plain dicts, so
a spec written by either package builds in the other.  Only `validate`
differs: it raises `NotImplementedError`, naming the ROADMAP item that will
port it, for what the port does not run yet (a scale without an engine),
before the JAX package's checks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.robust import AGGREGATORS as _ROBUST
from repro_torch.core.robust import MASKED_AGGREGATORS as _MASKED
from repro_torch.faults.spec import FaultSpec

from . import registry

DEVICE_SCALE = "device"          # discrete-event simulator over the MLP task
DATACENTER_SCALE = "datacenter"  # sharded fl_step modes over the LM task
# the partitioner-inferred device-scale engine, pinned: a 1-D mesh runs
# `DeviceScaleEngine` itself instead of the cluster-major engine
GSPMD_DEVICE_SCALE = "device-gspmd"

# default axis names by mesh rank: 1-D meshes shard the fleet's device dim;
# 2-D meshes put the cluster stack on the leading axis
_DEFAULT_AXES = {1: ("fleet",), 2: ("cluster", "fleet")}

# sharded execution implementations (`ShardingSpec.impl`)
SHARD_MAP_IMPL = "shard_map"    # explicit per-shard round, cluster-major
GSPMD_IMPL = "gspmd"            # DTensor placements, inferred collectives

_QUEUE = "ROADMAP.md, queue 1"


def unported(spec: "FederationSpec") -> Optional[str]:
    """What of ``spec`` the port cannot run yet, with the ROADMAP item that
    ports it; None when the port runs all of it.  The port runs the
    device scale with every aggregator (trust, fedavg and the robust
    rules), controller and task, differential privacy and every fault
    family, on one device or on a mesh of ``torch.distributed`` ranks, one
    shard a rank: the cluster-major engine (``impl='shard_map'``, 1-D
    meshes) or the partitioner-inferred placement through DTensor
    (``impl='gspmd'``, every multi-axis mesh, and the ``device-gspmd``
    scale); and the datacenter scale's LM training of every kind of model
    (dense, hybrid, SSM, MoE, MLA and audio).  A sharded device-scale spec
    runs as a checkpointed service too, and a sharded population as a
    pool (`repro_torch.serve`: one job of ranks).  A sharded datacenter
    spec is left to `FederationSpec.validate`, which rejects it as the JAX
    package does."""
    if spec.scale not in (DEVICE_SCALE, GSPMD_DEVICE_SCALE,
                          DATACENTER_SCALE):
        return (f"scale {spec.scale!r} (the port has engines for the JAX "
                f"package's {DEVICE_SCALE!r}, {GSPMD_DEVICE_SCALE!r} and "
                f"{DATACENTER_SCALE!r} scales; {_QUEUE})")
    return None


@dataclasses.dataclass
class ShardingSpec:
    """Where the federation runs, as spec data (resolved by
    `repro_torch.api.placement` into a `Placement`: the rank's process
    group and device).

    ``mesh`` is the mesh shape; ``()`` (the default) is the single-device
    fallback.  ``axes`` names one mesh axis per entry (defaults: 1-D
    ``("fleet",)``, 2-D ``("cluster", "fleet")``).  ``device_axis`` shards
    the `FleetState` device-dim leaf group (twins / rep / channel) and
    ``cluster_axis`` the cluster-dim group (the cluster models, their
    update rounds); either may be None to replicate that group.  Scalars
    (queue, round) and the global model are always replicated.

    ``impl`` picks the sharded execution implementation:

      "shard_map"   the cluster-major engine
                    (`repro_torch.api.cluster_engine`): the fleet is
                    re-indexed so each cluster's member slots are
                    contiguous, every FleetState leaf co-shards over one
                    mesh axis of ``torch.distributed`` ranks (one shard a
                    rank), and a round's only collectives are two SUM
                    all-reduces: one for metrics and one for the Eqn-19
                    global average.  1-D meshes only.  Arbitrary
                    (n_devices, n_clusters) run on any shard count: the
                    engine pads with masked sentinel devices and clusters.
      "gspmd"       the JAX package's partitioner-inferred placement,
                    `DeviceScaleEngine` itself: the FleetState leaves are
                    DTensors on a ``DeviceMesh`` of the mesh's shape and
                    axis names (``Shard(0)`` of each leaf group on its
                    axis, ``Replicate()`` elsewhere), DTensor's sharding
                    propagation infers a round's collectives, and the
                    round's outputs go back to those placements.  Any
                    mesh rank; each group's axis must divide its dim.
      None          (default) "shard_map" for 1-D meshes, "gspmd" for 2-D.
    """
    mesh: Tuple[int, ...] = ()
    axes: Optional[Tuple[str, ...]] = None
    device_axis: Optional[str] = "fleet"
    cluster_axis: Optional[str] = None
    impl: Optional[str] = None

    def __post_init__(self):
        # JSON round-trips deliver lists; normalize so eq/hash behave
        self.mesh = tuple(int(m) for m in self.mesh)
        if self.axes is not None:
            self.axes = tuple(str(a) for a in self.axes)
        if self.impl is not None:
            self.impl = str(self.impl)

    @property
    def is_sharded(self) -> bool:
        return bool(self.mesh)

    def resolved_impl(self) -> Optional[str]:
        """The sharded implementation this spec runs on (None: unsharded)."""
        if not self.mesh:
            return None
        if self.impl is not None:
            if self.impl not in (SHARD_MAP_IMPL, GSPMD_IMPL):
                raise ValueError(
                    f"sharding: unknown impl {self.impl!r}; valid: "
                    f"{SHARD_MAP_IMPL!r}, {GSPMD_IMPL!r}")
            return self.impl
        return SHARD_MAP_IMPL if len(self.mesh) == 1 else GSPMD_IMPL

    def resolved_axes(self) -> Tuple[str, ...]:
        if self.axes is not None:
            return self.axes
        try:
            return _DEFAULT_AXES[len(self.mesh)]
        except KeyError:
            raise ValueError(
                f"sharding: no default axis names for a {len(self.mesh)}-D "
                "mesh; set axes=(...) explicitly") from None

    def resolved_cluster_axis(self, axes: Tuple[str, ...]) -> Optional[str]:
        """Default cluster placement: the "cluster" axis when the mesh has
        one, else replicated."""
        if self.cluster_axis is not None:
            return self.cluster_axis
        return "cluster" if "cluster" in axes else None

    def validate(self, n_devices: int, n_clusters: int) -> "ShardingSpec":
        """The JAX package's checks, with its messages."""
        if not self.mesh:
            return self
        if any(m < 1 for m in self.mesh):
            raise ValueError(f"sharding: mesh {self.mesh} has a "
                             "non-positive extent")
        axes = self.resolved_axes()
        if len(axes) != len(self.mesh):
            raise ValueError(
                f"sharding: mesh {self.mesh} has {len(self.mesh)} axes but "
                f"axes={axes} names {len(axes)}")
        if len(set(axes)) != len(axes):
            raise ValueError(f"sharding: duplicate axis names in {axes}")
        impl = self.resolved_impl()
        if impl == SHARD_MAP_IMPL:
            # the cluster-major engine co-shards every leaf over one axis
            # and pads indivisible fleets with masked sentinel devices and
            # clusters itself: no divisibility requirement here
            if len(self.mesh) != 1:
                raise ValueError(
                    f"sharding: impl='shard_map' runs on 1-D meshes (one "
                    f"cluster-shard axis); got mesh {self.mesh} — use "
                    "impl='gspmd' for multi-axis placements")
            if n_devices < n_clusters:
                raise ValueError("n_devices < n_clusters")
            for role, name in (("device_axis", self.device_axis),
                               ("cluster_axis", self.cluster_axis)):
                if name is not None and name not in axes:
                    raise ValueError(
                        f"sharding: {role}={name!r} is not a mesh axis; "
                        f"axes={axes}")
            return self
        cluster_axis = self.resolved_cluster_axis(axes)
        for role, name, dim, total in (
                ("device_axis", self.device_axis, "n_devices", n_devices),
                ("cluster_axis", cluster_axis, "n_clusters", n_clusters)):
            if name is None:
                continue
            if name not in axes:
                raise ValueError(
                    f"sharding: {role}={name!r} is not a mesh axis; "
                    f"axes={axes}")
            k = self.mesh[axes.index(name)]
            if total % k:
                raise ValueError(
                    f"sharding: mesh axis {name!r} has {k} shards, which "
                    f"does not divide {dim}={total}; pad the fleet or pick "
                    f"a mesh shape with {dim} % shards == 0")
        if (self.device_axis is not None and cluster_axis is not None
                and self.device_axis == cluster_axis):
            raise ValueError(
                f"sharding: device_axis and cluster_axis are both "
                f"{cluster_axis!r}; the device and cluster dims need "
                "distinct mesh axes (or replicate one with None)")
        return self


@dataclasses.dataclass
class FleetSpec:
    """The device fleet and its digital twins (Eqns 1-2)."""
    n_devices: int = 16
    malicious_frac: float = 0.0      # Byzantine label-flippers
    dt_max_dev: float = 0.2          # DT mapping error ~ U(0, max_dev)
    calibrate_dt: bool = True        # Eqn-2 self-calibration on/off


@dataclasses.dataclass
class ClusteringSpec:
    """K-means clustering + Alg.-2 tolerance bound."""
    n_clusters: int = 4
    alpha0: float = 0.5              # tolerance factor (grows with rounds)
    alpha_growth: float = 0.02


@dataclasses.dataclass
class ControllerSpec:
    """Aggregation-frequency controller: fixed | dqn | lyapunov."""
    kind: str = "dqn"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AggregatorSpec:
    """Intra-cluster aggregation rule (Eqn 6 or a robust baseline)."""
    kind: str = "trust"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # kept so the two packages' spec dicts stay interchangeable; the port
    # ignores it and always launches its kernel on the card
    use_kernel: bool = True


@dataclasses.dataclass
class TaskSpec:
    """Model/task adapter: mlp (device scale) | lm (datacenter scale)."""
    kind: str = "mlp"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PrivacySpec:
    """Client-level DP on aggregated deltas; clip <= 0 disables."""
    clip: float = 0.0
    noise: float = 0.0


@dataclasses.dataclass
class ChannelSpec:
    """Markov wireless channel + packet-failure probability (Eqn 4's u)."""
    p_good: float = 0.5
    pkt_fail: float = 0.05


@dataclasses.dataclass
class FederationSpec:
    scale: str = DEVICE_SCALE
    fleet: FleetSpec = dataclasses.field(default_factory=FleetSpec)
    clustering: ClusteringSpec = dataclasses.field(
        default_factory=ClusteringSpec)
    controller: ControllerSpec = dataclasses.field(
        default_factory=ControllerSpec)
    aggregator: AggregatorSpec = dataclasses.field(
        default_factory=AggregatorSpec)
    task: TaskSpec = dataclasses.field(default_factory=TaskSpec)
    privacy: PrivacySpec = dataclasses.field(default_factory=PrivacySpec)
    channel: ChannelSpec = dataclasses.field(default_factory=ChannelSpec)
    sharding: ShardingSpec = dataclasses.field(default_factory=ShardingSpec)
    faults: FaultSpec = dataclasses.field(default_factory=FaultSpec)
    sim_seconds: float = 60.0        # device scale: simulated wall-clock
    rounds: int = 20                 # global rounds (datacenter scale, and
                                     # the K of device-scale "scanned" runs)
    execution: str = "event"         # device scale: "event" (discrete-event
                                     # heap) | "scanned" (lax.scan over K
                                     # rounds, controller in-jit)
    local_batch: int = 64
    lr: float = 0.1
    iota: float = 0.1                # Eqn 5 uncertainty coefficient
    seed: int = 0

    # ------------------------------------------------------------------ #
    def validate(self) -> "FederationSpec":
        missing = unported(self)
        if missing is not None:
            raise NotImplementedError(f"not ported yet: {missing}")
        from . import engine as _engine  # noqa: F401  (populates ENGINES)
        registry.ENGINES.get(self.scale)
        registry.CONTROLLERS.get(self.controller.kind)
        registry.AGGREGATORS.get(self.aggregator.kind)
        registry.TASKS.get(self.task.kind)
        # built-in tasks are scale-specific; custom registrations (tasks or
        # engines) are not checked
        scale_of = {"mlp": DEVICE_SCALE,
                    "autoencoder-anomaly": DEVICE_SCALE,
                    "lm": DATACENTER_SCALE}
        want = scale_of.get(self.task.kind)
        if (want is not None and want != self.scale
                and self.scale in (DEVICE_SCALE, DATACENTER_SCALE)):
            fit = "lm" if self.scale == DATACENTER_SCALE else "mlp"
            raise ValueError(
                f"task {self.task.kind!r} is {want}-scale but spec has "
                f"scale={self.scale!r}; use task {fit!r}")
        if self.sharding.is_sharded and self.scale == DATACENTER_SCALE:
            raise ValueError(
                "sharding: mesh placement is not supported at datacenter "
                "scale (the fl_step modes manage their own sharding)")
        self.sharding.validate(self.fleet.n_devices,
                               self.clustering.n_clusters)
        self.faults.validate()
        if self.faults.active and self.scale == DATACENTER_SCALE:
            raise ValueError(
                "faults: fault injection is device-scale only (the "
                "datacenter fl_step modes have no fault model)")
        if self.scale == DATACENTER_SCALE:
            # the federated step implements Eqn-6 trust weighting; robust
            # rules and DP have no datacenter implementation, so reject
            # rather than silently run without them
            if self.aggregator.kind not in ("trust", "fedavg"):
                raise ValueError(
                    f"aggregator {self.aggregator.kind!r} is not supported "
                    "at datacenter scale (fl_step implements Eqn-6 trust "
                    "weighting only)")
            if self.privacy.clip > 0.0 or self.privacy.noise > 0.0:
                raise ValueError(
                    "privacy (DP) is not implemented at datacenter scale")
        if self.execution not in ("event", "scanned"):
            raise ValueError(f"unknown execution {self.execution!r}; "
                             "valid: 'event', 'scanned'")
        if self.execution == "scanned":
            if self.scale != DEVICE_SCALE:
                raise ValueError("execution='scanned' is device-scale only "
                                 "(the datacenter engine is already a "
                                 "fixed round loop)")
            # the scan needs the padded round: built-in rules without a
            # masked variant cannot join it (custom registrations are
            # checked at run_scanned time instead)
            if self.aggregator.kind in set(_ROBUST) - set(_MASKED):
                raise ValueError(
                    f"aggregator {self.aggregator.kind!r} has no masked "
                    "variant (supports_mask=False); execution='scanned' "
                    "needs the padded round: pick a mask-aware rule "
                    "(trust/fedavg/" + "/".join(sorted(_MASKED))
                    + ") or execution='event'")
        if self.fleet.n_devices < self.clustering.n_clusters:
            raise ValueError("n_devices < n_clusters")
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FederationSpec":
        return _from_dict(cls, d, path="spec")

    def replace(self, **kw) -> "FederationSpec":
        return dataclasses.replace(self, **kw)


def _from_dict(cls, d: Dict[str, Any], path: str):
    """Recursive strict dataclass hydration: unknown keys are errors."""
    if not isinstance(d, dict):
        raise TypeError(f"{path}: expected dict, got {type(d).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(d) - set(fields)
    if unknown:
        raise KeyError(f"{path}: unknown keys {sorted(unknown)}; "
                       f"valid: {sorted(fields)}")
    kwargs = {}
    for name, value in d.items():
        nested = _NESTED.get((cls.__name__, name))
        kwargs[name] = (_from_dict(nested, value, f"{path}.{name}")
                        if nested else value)
    return cls(**kwargs)


_NESTED = {
    ("FederationSpec", "fleet"): FleetSpec,
    ("FederationSpec", "clustering"): ClusteringSpec,
    ("FederationSpec", "controller"): ControllerSpec,
    ("FederationSpec", "aggregator"): AggregatorSpec,
    ("FederationSpec", "task"): TaskSpec,
    ("FederationSpec", "privacy"): PrivacySpec,
    ("FederationSpec", "channel"): ChannelSpec,
    ("FederationSpec", "sharding"): ShardingSpec,
    ("FederationSpec", "faults"): FaultSpec,
}


def legacy_spec(cfg) -> FederationSpec:
    """Translate a legacy ``AsyncFLConfig`` into the equivalent spec (the
    JAX package's ``repro.api.spec.legacy_spec``: the same dict for the
    same config).

    Used by the `AsyncFederation` shim, whose traces equal those of
    ``Federation.from_spec(legacy_spec(cfg))`` bit for bit.
    """
    if cfg.fixed_frequency is not None:
        controller = ControllerSpec("fixed", {"a": int(cfg.fixed_frequency)})
    else:
        # the legacy default without an agent: constant a = 5; a trained
        # agent is attached by the caller via Federation(controller=...)
        controller = ControllerSpec("fixed", {"a": 5})
    return FederationSpec(
        scale=DEVICE_SCALE,
        fleet=FleetSpec(n_devices=cfg.n_devices,
                        malicious_frac=cfg.malicious_frac,
                        dt_max_dev=cfg.dt_max_dev,
                        calibrate_dt=cfg.calibrate_dt),
        clustering=ClusteringSpec(n_clusters=cfg.n_clusters,
                                  alpha0=cfg.alpha0,
                                  alpha_growth=cfg.alpha_growth),
        controller=controller,
        aggregator=AggregatorSpec(kind=cfg.aggregator),
        task=TaskSpec("mlp"),
        privacy=PrivacySpec(clip=cfg.dp_clip, noise=cfg.dp_noise),
        channel=ChannelSpec(p_good=cfg.p_good, pkt_fail=cfg.pkt_fail),
        sim_seconds=cfg.sim_seconds,
        local_batch=cfg.local_batch,
        lr=cfg.lr, iota=cfg.iota, seed=cfg.seed)
