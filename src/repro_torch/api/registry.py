"""Component registries for the federation API (a copy of the JAX
package's ``repro.api.registry``, which has no JAX in it).

Every pluggable piece of the pipeline — aggregation rule, frequency
controller, task adapter, scenario preset, engine — registers itself under a string
name, so a `FederationSpec` (and therefore a config file) can name any
component without the orchestrator knowing about it:

    @register_aggregator("krum")
    def _build(params):
        ...return an Aggregator...

Lookups raise ``KeyError`` with the available names, so a typo in a config
fails loudly at build time rather than silently falling back.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List


class Registry:
    """A named string -> factory mapping with decorator registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._factories: Dict[str, Callable[..., Any]] = {}

    def register(self, name: str) -> Callable:
        def deco(factory):
            if name in self._factories:
                raise ValueError(
                    f"duplicate {self.kind} registration: {name!r}")
            self._factories[name] = factory
            return factory
        return deco

    def get(self, name: str) -> Callable[..., Any]:
        try:
            return self._factories[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: "
                f"{sorted(self._factories)}") from None

    def names(self) -> List[str]:
        return sorted(self._factories)

    def __contains__(self, name: str) -> bool:
        return name in self._factories


AGGREGATORS = Registry("aggregator")
CONTROLLERS = Registry("controller")
TASKS = Registry("task")
SCENARIOS = Registry("scenario")
# execution engines, keyed by `FederationSpec.scale` — entries must satisfy
# the `repro_torch.api.engine.DeviceScaleEngine` surface (classmethod ``from_spec`` plus
# ``run``/``run_scanned`` emitting the FLTrace schema)
ENGINES = Registry("engine")

register_aggregator = AGGREGATORS.register
register_controller = CONTROLLERS.register
register_task = TASKS.register
register_scenario = SCENARIOS.register
register_engine = ENGINES.register
