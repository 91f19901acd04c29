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
                    cluster models and their update rounds), partitioned
                    over ``cluster_axis``
  replicated        everything else: the global model, the Eqn-12 queue,
                    the round counter

The single-device fallback (``mesh=()``) resolves to ``SINGLE_DEVICE``,
which holds no group.  A mesh of G > 1 shards needs a G-rank job
(`repro_torch.launch.distributed`); a mesh of one shard in a plain
process sets up a one-rank gloo group on a free localhost port itself, as
the JAX package's one-device mesh needs no launcher.

The port runs one sharded implementation, ``impl='shard_map'`` (the
cluster-major engine, `repro_torch.api.cluster_engine`): every leaf
co-shards over the one mesh axis (`shard_map_placement`).  The JAX
package's partitioner-inferred ``impl='gspmd'`` is not ported
(`FederationSpec.validate` raises first, naming ROADMAP.md queue 1, item
9).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.launch.distributed import (DEFAULT_TIMEOUT_S, ENV_COORD,
                                            ENV_NPROC, ENV_PID, free_port)

from .spec import GSPMD_IMPL, ShardingSpec

# FleetState field -> leaf-group membership (leading-dim semantics)
DEVICE_GROUP = ("twins", "rep", "channel")
CLUSTER_GROUP = ("cluster_flat", "cluster_ts")


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

    @property
    def is_sharded(self) -> bool:
        return self.group is not None

    def group_axis(self, field: str) -> Optional[str]:
        if field in DEVICE_GROUP:
            return self.device_axis
        if field in CLUSTER_GROUP:
            return self.cluster_axis
        return None


SINGLE_DEVICE = Placement()


def _process_group(mesh_shape) -> Any:
    """The process group backing a mesh of one shard a rank, or a readable
    error.  A one-shard mesh in a process outside any job gets a one-rank
    gloo group on a free localhost port."""
    need = math.prod(mesh_shape)
    if dist.is_initialized():
        have = dist.get_world_size()
        if have != need:
            raise ValueError(
                f"sharding: mesh {tuple(mesh_shape)} needs {need} ranks, one "
                f"shard a rank, but this process is rank "
                f"{dist.get_rank()} of {have}; launch {need} ranks with "
                "repro_torch.launch.distributed.spawn_local, or export "
                f"{ENV_COORD} / {ENV_NPROC} / {ENV_PID} to each rank and "
                "call initialize_from_env()")
        return dist.group.WORLD
    if need == 1:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
            world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
        return dist.group.WORLD
    raise ValueError(
        f"sharding: mesh {tuple(mesh_shape)} needs {need} ranks, one shard "
        "a rank, but this process is not part of a torch.distributed job; "
        f"launch {need} ranks with repro_torch.launch.distributed."
        f"spawn_local, or export {ENV_COORD} / {ENV_NPROC} / {ENV_PID} to "
        "each rank and call initialize_from_env()")


def resolve(sharding: ShardingSpec, *, n_devices: int, n_clusters: int,
            device=None) -> Placement:
    """`ShardingSpec` -> this rank's `Placement`; the one way in for the
    cluster-major engine and the sharded population.

    Raises with a readable error when the spec is malformed
    (``ShardingSpec.validate``'s messages) or when this process is not one
    of the mesh's ranks; a ``gspmd`` spec raises `NotImplementedError`
    (not ported)."""
    if not sharding.is_sharded:
        return SINGLE_DEVICE
    sharding.validate(n_devices, n_clusters)
    if sharding.resolved_impl() == GSPMD_IMPL:
        raise NotImplementedError(
            "not ported yet: impl='gspmd' (the partitioner-inferred "
            "placement, through DTensor; ROADMAP.md, queue 1, item 9)")
    return shard_map_placement(sharding, device=device)


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
