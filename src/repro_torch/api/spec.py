"""`FederationSpec`: the declarative description of a federation experiment.

A copy of the JAX package's ``repro.api.spec``: every dataclass keeps every
field and default, and `to_dict` / `from_dict` use the same plain dicts, so
a spec written by either package builds in the other.  Only `validate`
differs: it raises `NotImplementedError`, naming the ROADMAP item that will
port it, for what the port does not run yet (the multi-device scales,
sharding meshes, and language models with MoE, MLA, qkv-bias / qk-norm or
audio-codebook layers), before the JAX package's checks.
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

_QUEUE = "ROADMAP.md, queue 1"


def unported(spec: "FederationSpec") -> Optional[str]:
    """What of ``spec`` the port cannot run yet, with the ROADMAP item that
    ports it; None when the port runs all of it.  The port runs the
    device scale on one device with every aggregator (trust, fedavg and the
    robust rules), controller and task, differential privacy and every
    fault family, and the datacenter scale's LM training for the dense,
    hybrid and SSM (Mamba) kinds; it does not run the multi-device scales,
    a sharding mesh, or the training of a model with MoE, MLA, qkv-bias /
    qk-norm or audio-codebook layers."""
    if spec.scale not in (DEVICE_SCALE, DATACENTER_SCALE):
        return (f"scale {spec.scale!r} (multi-device engines, {_QUEUE}, "
                "item 9)")
    if spec.sharding.is_sharded:
        return f"a sharding mesh (multi-device, {_QUEUE}, item 9)"
    if spec.scale == DATACENTER_SCALE and spec.task.kind == "lm":
        from repro_torch.models.transformer import untrainable

        from .components import lm_task_config
        try:
            return untrainable(lm_task_config(**spec.task.params))
        except NotImplementedError as e:       # an unported architecture
            return str(e)
    return None


@dataclasses.dataclass
class ShardingSpec:
    """Where the federation runs, as spec data.

    ``mesh`` is the mesh shape; ``()`` (the default) is one device, the
    only placement the port runs so far.  ``axes`` names one mesh axis per
    entry; ``device_axis`` / ``cluster_axis`` say which axis shards the
    fleet's device-dim and cluster-dim state; ``impl`` picks the sharded
    implementation ("shard_map", "gspmd", or None for the default by mesh
    rank).  The fields are the JAX package's; its ``validate`` and
    ``resolved_*`` are not ported (`unported()` rejects every sharded spec
    first) and come with the multi-device engines (ROADMAP.md, queue 1,
    item 9).
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
        if want is not None and want != self.scale:
            fit = "lm" if self.scale == DATACENTER_SCALE else "mlp"
            raise ValueError(
                f"task {self.task.kind!r} is {want}-scale but spec has "
                f"scale={self.scale!r}; use task {fit!r}")
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
