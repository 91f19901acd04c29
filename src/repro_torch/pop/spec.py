"""`PopulationSpec`: a declarative sweep of `FederationSpec`s.

A copy of the JAX package's ``repro.pop.spec``.  A population is B
independent federations that share one *structure* (shapes, component
kinds, static fault gates) and vary in seeds and scalar knobs: what
`repro_torch.pop.engine.PopulationEngine` batches into one round.  The
spec mirrors `repro_torch.api.spec`: a plain dataclass with strict
dict/JSON round-trip (the JAX package's dicts), expanded into validated
member `FederationSpec`s by `expand()`.

Sweep axes compose two ways:

``grid``        dotted-field-path -> list of values; member cells are the
                cartesian product in key order (``{"lr": [...], "channel.
                pkt_fail": [...]}``).  Paths traverse nested spec
                dataclasses and the ``params`` dicts of component specs
                (``"controller.params.budget"``).
``replicates``  seed replicates per grid cell — the confidence-interval
                axis.

Per-member seeds derive from the base seed via `member_seed`, bit for bit
the JAX package's (a ``jax.random.fold_in`` of the member index, then a
``randint``, written here in plain Python threefry-2x32), so a pool
directory and its member specs mean the same in both packages.
``derive_seeds=False`` keeps the base/grid seed verbatim instead.

``sharding`` places the *population* axis on a 1-D mesh of
``torch.distributed`` ranks (axis name defaults to "pop"): rank r runs
members ``[r*B/G, (r+1)*B/G)`` with no collective in a round
(`repro_torch.pop.engine`).  Member specs themselves are always
unsharded: the population batch dim is the parallel axis.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Tuple

from repro_torch.api.spec import (DEVICE_SCALE, FederationSpec,
                                  ShardingSpec, _NESTED, _from_dict)

__all__ = ["PopulationSpec", "member_seed"]

POP_AXIS = "pop"                 # default mesh axis name for the batch dim

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key: Tuple[int, int], x: Tuple[int, int]
                  ) -> Tuple[int, int]:
    """Threefry-2x32 with 20 rounds (JAX's PRNG block function)."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0, x1 = (x[0] + ks[0]) & _M32, (x[1] + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _bits32(key: Tuple[int, int]) -> int:
    """The 32 random bits of one draw from ``key`` (partitionable mode)."""
    a, b = _threefry2x32(key, (0, 0))
    return a ^ b


def member_seed(base_seed: int, b: int) -> int:
    """The seed of population member ``b``: ``randint(fold_in(key(base),
    b), (), 0, 2**31 - 1)`` as the JAX package computes it, as a plain
    non-negative int.  A standalone ``Federation.from_spec`` run with
    ``seed=member_seed(base, b)`` is member ``b``'s reference run."""
    seed = int(base_seed)
    key = ((seed >> 32) & _M32, seed & _M32)
    key = _threefry2x32(key, (0, int(b) & _M32))            # fold_in
    hi = _bits32(_threefry2x32(key, (0, 0)))                 # split 0
    lo = _bits32(_threefry2x32(key, (0, 1)))                 # split 1
    span = 2 ** 31 - 1
    mult = (((1 << 16) % span) ** 2 & _M32) % span           # uint32 math
    off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    return off % span


def _apply_override(obj, path: str, value):
    """Set a dotted field path on a nested dataclass/dict tree, returning
    a replaced copy (the original spec is never mutated)."""
    head, _, rest = path.partition(".")
    if isinstance(obj, dict):
        if rest and head not in obj:
            raise KeyError(f"grid path {path!r}: no key {head!r} in dict")
        out = dict(obj)
        out[head] = _apply_override(obj[head], rest, value) if rest \
            else value
        return out
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"grid path {path!r}: cannot descend into "
                        f"{type(obj).__name__}")
    names = {f.name for f in dataclasses.fields(obj)}
    if head not in names:
        raise KeyError(f"grid path {path!r}: {type(obj).__name__} has no "
                       f"field {head!r}; valid: {sorted(names)}")
    new = _apply_override(getattr(obj, head), rest, value) if rest else value
    return dataclasses.replace(obj, **{head: new})


@dataclasses.dataclass
class PopulationSpec:
    """B federations from one base spec + sweep axes (module docstring)."""
    base: FederationSpec
    grid: Dict[str, List[Any]] = dataclasses.field(default_factory=dict)
    replicates: int = 1
    derive_seeds: bool = True
    sharding: ShardingSpec = dataclasses.field(default_factory=ShardingSpec)

    # ------------------------------------------------------------------ #
    @property
    def size(self) -> int:
        n = self.replicates
        for values in self.grid.values():
            n *= len(values)
        return n

    def validate(self) -> "PopulationSpec":
        if self.replicates < 1:
            raise ValueError(f"population: replicates={self.replicates} "
                             "must be >= 1")
        for path, values in self.grid.items():
            if not isinstance(values, (list, tuple)) or not len(values):
                raise ValueError(f"population: grid[{path!r}] must be a "
                                 "non-empty list of values")
        if self.sharding.is_sharded:
            if len(self.sharding.mesh) != 1:
                raise ValueError(
                    f"population: sharding shards the population axis only "
                    f"(1-D mesh); got mesh {self.sharding.mesh}")
            shards = self.sharding.mesh[0]
            if self.size % shards:
                raise ValueError(
                    f"population: mesh has {shards} shards, which does not "
                    f"divide the population size {self.size}")
        if self.base.sharding.is_sharded:
            raise ValueError(
                "population: the base spec must be unsharded — the "
                "population batch axis is the parallel dim (set sharding "
                "on the PopulationSpec instead)")
        self.base.validate()
        if self.base.scale != DEVICE_SCALE:
            raise NotImplementedError(
                f"not ported yet: a population of {self.base.scale!r}-scale "
                "federations (a population batches the device-scale round; "
                "ROADMAP.md, queue 1, item 10)")
        return self

    def pop_axis(self) -> str:
        axes = self.sharding.axes
        return axes[0] if axes else POP_AXIS

    # ------------------------------------------------------------------ #
    def expand(self) -> List[FederationSpec]:
        """Member specs in population order: grid cells in cartesian
        product order (key order), replicates innermost; each validated."""
        self.validate()
        keys = list(self.grid)
        members: List[FederationSpec] = []
        for combo in itertools.product(*(self.grid[k] for k in keys)):
            cell = self.base
            for path, value in zip(keys, combo):
                cell = _apply_override(cell, path, value)
            for _ in range(self.replicates):
                b = len(members)
                spec = dataclasses.replace(cell, sharding=ShardingSpec())
                if self.derive_seeds and "seed" not in keys:
                    spec = dataclasses.replace(
                        spec, seed=member_seed(self.base.seed, b))
                members.append(spec.validate())
        return members

    # ------------------------------------------------------------------ #
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PopulationSpec":
        return _from_dict(cls, d, path="population")

    def replace(self, **kw) -> "PopulationSpec":
        return dataclasses.replace(self, **kw)


# strict hydration of the nested spec fields rides the same machinery as
# FederationSpec.from_dict
_NESTED[("PopulationSpec", "base")] = FederationSpec
_NESTED[("PopulationSpec", "sharding")] = ShardingSpec
