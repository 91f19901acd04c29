"""Placement: resolve a `ShardingSpec` into a rank's share of a mesh.

*Where* a federation runs is spec data like everything else
(`FederationSpec.sharding`); this module turns it into a `Placement`: the
``torch.distributed`` process group whose ranks are the mesh's shards (one
shard a rank, so the mesh's extent is the world size), this process's
rank and device, the axis names, and the axis each `FleetState` leaf
*group* shards on:

  device group      leaves with leading dim n_devices (twins, rep,
                    channel), partitioned over ``device_axis``
  cluster group     leaves with leading dim n_clusters (the stacked
                    cluster models, their update rounds and the scanned
                    path's per-cluster event times), partitioned over
                    ``cluster_axis``
  replicated        everything else: the global model, the Eqn-12 queue,
                    the round counter

The single-device fallback (``mesh=()``) resolves to ``SINGLE_DEVICE``,
which holds no group.  A mesh of G > 1 shards needs a G-rank job
(`repro_torch.launch.distributed`); a mesh of one shard in a plain
process sets up a one-rank gloo group on a free localhost port itself, as
the JAX package's one-device mesh needs no launcher.

Two sharded implementations consume a `Placement`:

* ``impl='shard_map'`` (the cluster-major engine,
  `repro_torch.api.cluster_engine`): every leaf co-shards over the one
  mesh axis (`shard_map_placement`) and the round's collectives are
  written out by hand.
* ``impl='gspmd'`` (`DeviceScaleEngine` itself, the JAX package's
  partitioner-inferred path): the placement carries a ``DeviceMesh`` of
  the mesh's shape and axis names, the state's leaves are DTensors
  committed to their group's placements (`shard_state`: ``Shard(0)`` on
  the group's mesh axis, ``Replicate()`` on every other), and DTensor's
  sharding propagation infers the collectives of a round, the
  all-gathers of membership gathers that do not line up with the shards
  among them.  The round's outputs go back to the same placements
  (`pin_state`), as the JAX package's ``out_shardings`` pin them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import is_dtensor, resolve_device
from repro_torch.launch.distributed import device_mesh, job_group

from .spec import GSPMD_IMPL, ShardingSpec

# FleetState field -> leaf-group membership (leading-dim semantics)
DEVICE_GROUP = ("twins", "rep", "channel")
CLUSTER_GROUP = ("cluster_flat", "cluster_ts")


def whole(t):
    """The whole value of ``t`` on every rank: a DTensor's full tensor (a
    collective where it is sharded or partial, which every rank calls);
    anything else as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def gather(t):
    """The whole value of the DTensor ``t`` as a plain tensor on every
    rank, by the process groups' own all-gathers of its shards, one
    mesh dim after another in the mesh's order (every rank calls it,
    in the same order); a plain tensor as it is.  The partitioner-
    inferred round takes the inputs of its own reductions through
    this (the next event's ``argmin``, the straggler minimum, Eqn 19's
    weights and sum), so that none is left to DTensor, whose inferred
    collectives for them differ between PyTorch versions (2.11's
    ``argmin`` of a sharded tensor gathers partial results, and one
    rank of four skipped a ``(Partial(min), Partial(min))`` reduction
    there: mesh (2, 2) over NCCL hung); each is the unsharded engine's
    on whole tensors."""
    if not is_dtensor(t):
        return t
    from repro_torch.core.sharding import Shards, spec_of
    if any(p.is_partial() for p in t.placements):
        raise ValueError(f"gather takes sharded or replicated DTensors, "
                         f"got {t.placements}")
    with torch.no_grad():
        return Shards(t.device_mesh, {}).relayout(
            t.to_local(), spec_of(t), (None,) * t.dim())


_replicating = [0]


@contextlib.contextmanager
def replicated_constants():
    """DTensor's ``implicit_replication``, nestable: inside, a plain tensor
    mixed with DTensors counts as replicated.  The partitioner-inferred
    round runs in it, so the engine's constant tables (the dataset, the
    partition index, the channel's transition) stay plain tensors, the same
    on every rank."""
    if _replicating[0]:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), warnings.catch_warnings():
        # a one-element index (a cluster's row) is replicated as intended
        warnings.filterwarnings("ignore", message=".*numel=1 and ndim!=0")
        _replicating[0] += 1
        try:
            yield
        finally:
            _replicating[0] -= 1


@dataclasses.dataclass(frozen=True)
class Placement:
    """A rank's share of a resolved mesh and the axis each FleetState leaf
    group shards on."""
    world_size: int = 1
    rank: int = 0
    device: Optional[torch.device] = None
    group: Any = None                   # the process group; None: unsharded
    axes: Tuple[str, ...] = ()
    device_axis: Optional[str] = None
    cluster_axis: Optional[str] = None
    mesh: Any = None                    # the DeviceMesh of impl='gspmd'

    @property
    def is_sharded(self) -> bool:
        return self.group is not None

    @property
    def is_gspmd(self) -> bool:
        return self.mesh is not None

    def group_axis(self, field: str) -> Optional[str]:
        if field in DEVICE_GROUP:
            return self.device_axis
        if field in CLUSTER_GROUP:
            return self.cluster_axis
        return None

    # ------------------------------------------------------------------ #
    # the DTensor placements of impl='gspmd'
    # ------------------------------------------------------------------ #
    def placements(self, axis: Optional[str] = None) -> tuple:
        """``Shard(0)`` on the mesh dim named ``axis``, ``Replicate()`` on
        every other (all ``Replicate()`` for None): the JAX package's
        ``NamedSharding(mesh, PartitionSpec(axis))``."""
        from torch.distributed.tensor import Replicate, Shard
        return tuple(Shard(0) if name == axis else Replicate()
                     for name in self.axes)

    def distribute(self, t: torch.Tensor, axis: Optional[str] = None):
        """The DTensor of the whole tensor ``t`` (the same on every rank)
        placed by `placements`: this rank keeps its chunk, and nothing
        travels between ranks."""
        from torch.distributed.tensor import DTensor
        t = t.to(self.device)
        for d, name in enumerate(self.axes):
            if name == axis:
                t = t.chunk(self.mesh.size(d))[self.mesh.get_local_rank(d)]
        return DTensor.from_local(t.contiguous(), self.mesh,
                                  self.placements(axis), run_check=False)

    def pin(self, t, axis: Optional[str] = None):
        """``t`` at the placements of ``axis``: a DTensor is
        redistributed (nothing moves where it already is, and a
        replicated one only drops the rows this rank does not keep), a
        plain tensor, the same on every rank, is distributed."""
        if not is_dtensor(t):
            return self.distribute(torch.as_tensor(t), axis)
        want = self.placements(axis)
        if tuple(t.placements) == want:
            return t
        return t.redistribute(self.mesh, want)

    def _map_state(self, state, fn):
        out = {}
        for f in dataclasses.fields(state):
            v = getattr(state, f.name)
            axis = self.group_axis(f.name)
            if dataclasses.is_dataclass(v):
                v = type(v)(**{g.name: fn(getattr(v, g.name), axis)
                               for g in dataclasses.fields(v)})
            else:
                v = fn(v, axis)
            out[f.name] = v
        return type(state)(**out)

    def shard_state(self, state):
        """Commit a whole `FleetState` (the same on every rank) to its
        leaf groups' placements."""
        return self._map_state(state, self.distribute)

    def pin_state(self, state):
        """A round's `FleetState` back at its leaf groups' placements: the
        JAX package's ``out_shardings`` pin."""
        return self._map_state(state, self.pin)

    def full_state(self, state):
        """The whole `FleetState` as plain tensors on every rank: one
        all-gather a sharded leaf (every rank must call it)."""
        return self._map_state(
            state, lambda t, axis: t.full_tensor() if is_dtensor(t) else t)


SINGLE_DEVICE = Placement()


def _process_group(mesh_shape) -> Any:
    """The process group backing a mesh of one shard a rank
    (`repro_torch.launch.distributed.job_group`)."""
    return job_group(mesh_shape)


def resolve(sharding: ShardingSpec, *, n_devices: int, n_clusters: int,
            device=None, impl: Optional[str] = None) -> Placement:
    """`ShardingSpec` -> this rank's `Placement`; the one way in for every
    sharded engine and the sharded population.

    ``impl`` overrides the spec's resolved implementation, as the JAX
    package's does: `DeviceScaleEngine` passes ``'gspmd'``, so a 1-D spec
    that resolves to ``shard_map`` by default still gets the strict
    divisibility checks of the path it runs.

    Raises with a readable error when the spec is malformed
    (``ShardingSpec.validate``'s messages) or when this process is not one
    of the mesh's ranks."""
    if not sharding.is_sharded:
        return SINGLE_DEVICE
    if impl is not None and impl != sharding.resolved_impl():
        sharding = dataclasses.replace(sharding, impl=impl)
    sharding.validate(n_devices, n_clusters)
    if sharding.resolved_impl() == GSPMD_IMPL:
        return gspmd_placement(sharding, device=device)
    return shard_map_placement(sharding, device=device)


def gspmd_placement(sharding: ShardingSpec, device=None) -> Placement:
    """The partitioner-inferred placement: a ``DeviceMesh`` of the spec's
    shape and axis names over the job's ranks, on this rank's device, and
    the axis each leaf group shards on (`ShardingSpec.validate` has
    checked them), built by `resolve`.  It registers the DTensor sharding
    rules of the port's custom operators (the trust kernels and the
    per-member products) on first use."""
    from repro_torch.core.member_ops import (
        register_dtensor_rules as member_rules)
    from repro_torch.kernels.trust_aggregate import (
        register_dtensor_rules as kernel_rules)
    axes = sharding.resolved_axes()
    group = _process_group(sharding.mesh)
    dev = resolve_device(device)
    G = dist.get_world_size(group)
    if dev.type == "cuda" and G > 1 and dist.get_backend(group) == "gloo":
        raise RuntimeError(
            f"impl='gspmd' on mesh {tuple(sharding.mesh)} needs DTensor's "
            f"all-gather between {G} ranks that share a card (backend "
            "gloo), and DTensor's all-gather (the functional collective "
            "all_gather_into_tensor) of CUDA tensors over gloo ends the "
            "process with a segfault (scripts/dtensor_probe.py); run one "
            "rank a card (backend nccl) or on the CPU (device='cpu'); "
            "ROADMAP.md, queue 1, item 9")
    kernel_rules()
    member_rules()
    return Placement(world_size=G, rank=dist.get_rank(group), device=dev,
                     group=group, axes=axes,
                     device_axis=sharding.device_axis,
                     cluster_axis=sharding.resolved_cluster_axis(axes),
                     mesh=device_mesh(sharding.mesh, axes, dev))


def shard_map_placement(sharding: ShardingSpec, device=None) -> Placement:
    """The cluster-major placement: one 1-D mesh axis of ranks carrying
    *both* leaf groups (fleet rows are cluster-major, so device and cluster
    dims co-shard by construction), built by `resolve`."""
    assert sharding.is_sharded and len(sharding.mesh) == 1
    axes = sharding.resolved_axes()
    group = _process_group(sharding.mesh)
    return Placement(world_size=dist.get_world_size(group),
                     rank=dist.get_rank(group),
                     device=resolve_device(device), group=group, axes=axes,
                     device_axis=axes[0], cluster_axis=axes[0])
