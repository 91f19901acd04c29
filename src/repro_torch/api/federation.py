"""`Federation`: the public entry point of the port.

    from repro_torch.api import Federation, FederationSpec

    fed = Federation.from_spec(spec)            # on the card
    trace = fed.run(max_rounds=20)              # host event heap
    trace = fed.run_scanned(30)                 # controller on the card

``device="cpu"`` runs the plain versions of the kernels on the CPU (the
tests do); without a card and without it, construction raises.  ``data``,
``parts``, ``assign`` and ``state`` override what the engine generates
from ``spec.seed`` (the parity tests hand over the JAX package's).
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.device import resolve_device

from . import registry
from .engine import DeviceScaleEngine
from .records import FLTrace
from .spec import FederationSpec


class Federation:
    """Facade tying spec -> components -> engine -> trace."""

    def __init__(self, spec: FederationSpec, *, device=None, data=None,
                 parts=None, assign=None, state=None, controller=None,
                 aggregator=None, task=None):
        spec.validate()
        self.spec = spec
        device = resolve_device(device)
        # a controller is built on the federation's device (the DQN
        # pretrains there)
        self.controller = controller or registry.CONTROLLERS.get(
            spec.controller.kind)(_controller_params(spec), device=device)
        self.aggregator = aggregator or registry.AGGREGATORS.get(
            spec.aggregator.kind)(spec.aggregator.params)
        self.task = task or registry.TASKS.get(spec.task.kind)(
            spec.task.params)
        self.engine: DeviceScaleEngine = registry.ENGINES.get(
            spec.scale).from_spec(
                spec, controller=self.controller, aggregator=self.aggregator,
                task=self.task, device=device, data=data, parts=parts,
                assign=assign, state=state)

    @classmethod
    def from_spec(cls, spec: FederationSpec, **kw) -> "Federation":
        return cls(spec, **kw)

    @classmethod
    def from_dict(cls, d: dict, **kw) -> "Federation":
        return cls(FederationSpec.from_dict(d), **kw)

    def run(self, eval_every: float = 1.0, **kw) -> FLTrace:
        """Extra keywords (``max_rounds``) pass through to the engine."""
        return self.engine.run(eval_every=eval_every, **kw)

    def __getattr__(self, name):
        if name == "engine":                 # not yet set: avoid recursion
            raise AttributeError(name)
        return getattr(self.engine, name)


def _controller_params(spec: FederationSpec) -> dict:
    """The controller's parameters on this process.  A sharded DQN
    federation pretrains on rank 0 alone: both sharded engines hand rank
    0's net to every rank by one broadcast at build
    (`DeviceScaleEngine._share_policy`), so the other ranks start from
    the untrained agent and skip the pretraining."""
    params = spec.controller.params
    if (spec.controller.kind == "dqn" and spec.sharding.is_sharded
            and "agent" not in params and dist.is_initialized()
            and dist.get_rank() != 0):
        params = {**params, "episodes": 0}
    return params
