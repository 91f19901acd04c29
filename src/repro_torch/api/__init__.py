"""Federation API of the port: the same surface as ``repro.api`` for what
is ported.

  spec        `FederationSpec` tree (+ dict round-trip, same dicts)
  registry    named component registries
  components  trust / fedavg aggregator, fixed / Lyapunov / DQN
              controllers, MLP and autoencoder-anomaly tasks
  engine      `DeviceScaleEngine`, `FleetState`
  records     `RoundRecord` / `FLTrace` (same JSONL format)
"""
from .components import (AutoencoderAnomalyTask, ControllerCtx,
                         DQNController, FixedController,
                         LyapunovGreedyController, MLPTask,
                         WeightedAggregator)
from .engine import (DeviceScaleEngine, FleetState, RoundDraws,
                     default_device_data, fleet_state_from_numpy,
                     resolve_device)
from .federation import Federation
from .records import FLTrace, JsonlSink, RoundRecord, read_jsonl_trace
from .registry import (AGGREGATORS, CONTROLLERS, ENGINES, TASKS,
                       register_aggregator, register_controller,
                       register_engine, register_task)
from .spec import (AggregatorSpec, ChannelSpec, ClusteringSpec,
                   ControllerSpec, DATACENTER_SCALE, DEVICE_SCALE, FaultSpec,
                   FederationSpec, FleetSpec, PrivacySpec, ShardingSpec,
                   TaskSpec)

__all__ = [
    "Federation", "FederationSpec", "FleetState", "RoundDraws", "FLTrace",
    "RoundRecord", "JsonlSink", "read_jsonl_trace", "FleetSpec",
    "ClusteringSpec", "ControllerSpec", "AggregatorSpec", "TaskSpec",
    "PrivacySpec", "ChannelSpec", "ShardingSpec", "FaultSpec",
    "DEVICE_SCALE", "DATACENTER_SCALE", "DeviceScaleEngine",
    "default_device_data", "fleet_state_from_numpy", "resolve_device",
    "AGGREGATORS", "CONTROLLERS", "ENGINES", "TASKS", "register_aggregator",
    "register_controller", "register_engine", "register_task",
    "WeightedAggregator", "FixedController", "LyapunovGreedyController",
    "MLPTask", "ControllerCtx", "DQNController", "AutoencoderAnomalyTask",
]
