"""Populations of the port: B federations as one batched round.

    from repro_torch.pop import PopulationSpec, PopulationEngine, member_seed

    pspec = PopulationSpec(base=FederationSpec(...),
                           grid={"lr": [0.05, 0.1]}, replicates=4)
    traces = PopulationEngine.from_population(pspec).run_scanned(K)

The counterpart of the JAX package's ``repro.pop``: the same specs,
member seeds and pool directories.  Each returned trace is the
standalone ``Federation.from_spec(member_spec).run_scanned(K)`` run of
the matching expanded spec (its schedule exactly, its values to float32
rounding).  ``python -m repro_torch.serve pool`` serves a population
across checkpointed segments into per-member run dirs.
"""
from .engine import PopulationEngine, PopulationMember
from .spec import PopulationSpec, member_seed

__all__ = ["PopulationEngine", "PopulationMember", "PopulationSpec",
           "member_seed"]
