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
        self.controller = controller or registry.CONTROLLERS.get(
            spec.controller.kind)(spec.controller.params)
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
