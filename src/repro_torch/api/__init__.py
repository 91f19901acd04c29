"""Federation API of the port: the same surface as ``repro.api`` for what
is ported.

  spec        `FederationSpec` tree (+ dict round-trip, same dicts),
              `legacy_spec` (a legacy `AsyncFLConfig` as a spec)
  registry    named component registries (aggregators, controllers,
              tasks, scenarios, engines)
  components  trust / fedavg and the robust aggregators, fixed /
              Lyapunov / DQN controllers, MLP, autoencoder-anomaly and
              LM tasks
  engine      `DeviceScaleEngine`, `FleetState` (and `FleetTree`, its
              checkpoint layout); `DatacenterEngine`, the federated LM
              step's
  cluster_engine  `ClusterMajorEngine`: the device scale on a 1-D mesh of
              ``torch.distributed`` ranks (``ShardingSpec(mesh=(G,))``),
              built by `DeviceScaleEngine.from_spec`; `placement` resolves
              the mesh into a rank's `Placement`.  ``impl='gspmd'``, a
              multi-axis mesh and the ``device-gspmd`` scale
              (`DeviceScaleGspmdEngine`) run `DeviceScaleEngine` itself on
              DTensors over a ``DeviceMesh`` of the ranks
  records     `RoundRecord` / `FLTrace` (same JSONL format), `tail_jsonl`
  scenarios   the JAX package's ten presets (`SCENARIOS`) and the
              full-width spec dicts the card is driven at
  run         the scenario CLI, ``python -m repro_torch.api.run``
"""
from . import scenarios  # noqa: F401  (populates SCENARIOS presets)
from .components import (AutoencoderAnomalyTask, ControllerCtx,
                         DQNController, FixedController, LMTask,
                         LyapunovGreedyController, MLPTask, RobustAggregator,
                         WeightedAggregator)
from .engine import (DatacenterEngine, DeviceScaleEngine,
                     DeviceScaleGspmdEngine, FleetState, FleetTree, RoundDraws,
                     default_device_data, fleet_state_from_numpy,
                     fleet_tree, resolve_device)
from .federation import Federation
from .records import FLTrace, JsonlSink, RoundRecord, read_jsonl_trace
from .registry import (AGGREGATORS, CONTROLLERS, ENGINES, SCENARIOS,
                       TASKS, register_aggregator, register_controller,
                       register_engine, register_scenario, register_task)
from .spec import (AggregatorSpec, ChannelSpec, ClusteringSpec,
                   ControllerSpec, DATACENTER_SCALE, DEVICE_SCALE,
                   GSPMD_DEVICE_SCALE, FaultSpec, FederationSpec, FleetSpec,
                   PrivacySpec, ShardingSpec, TaskSpec, legacy_spec)

__all__ = [
    "Federation", "FederationSpec", "FleetState", "FleetTree", "fleet_tree",
    "RoundDraws", "FLTrace",
    "RoundRecord", "JsonlSink", "read_jsonl_trace", "FleetSpec",
    "ClusteringSpec", "ControllerSpec", "AggregatorSpec", "TaskSpec",
    "PrivacySpec", "ChannelSpec", "ShardingSpec", "FaultSpec",
    "DEVICE_SCALE", "DATACENTER_SCALE", "GSPMD_DEVICE_SCALE", "legacy_spec",
    "DeviceScaleEngine", "DeviceScaleGspmdEngine",
    "default_device_data", "fleet_state_from_numpy", "resolve_device",
    "AGGREGATORS", "CONTROLLERS", "ENGINES", "TASKS", "SCENARIOS",
    "register_aggregator", "register_controller", "register_engine",
    "register_task", "register_scenario", "WeightedAggregator",
    "RobustAggregator", "FixedController", "LyapunovGreedyController",
    "MLPTask", "ControllerCtx", "DQNController", "AutoencoderAnomalyTask",
    "LMTask", "DatacenterEngine",
]
