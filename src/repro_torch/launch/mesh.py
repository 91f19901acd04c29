"""Meshes of the sharded training step (the JAX package's
``launch/mesh.py``), as ``torch.distributed`` `DeviceMesh` es of one rank
a shard.

Single pod: 256 ranks as (16, 16) ``('data', 'model')``.
Multi-pod:  512 ranks as (2, 16, 16) ``('pod', 'data', 'model')``; the
``pod`` axis carries the federation's clusters.

A production mesh needs a job of 256 or 512 ranks.  To lay out a plan at
that size in one process with nothing allocated -- as the JAX package
does on 512 forced host devices -- ask for ``fake=True``: the mesh then
sits on torch's ``fake`` process-group backend, whose collectives move
nothing.  Nothing falls back to it.

The JAX module's v5e constants (peak rate, memory and link bandwidth) do
not carry over.  The roofline terms of the dry run (`repro_torch.launch.
dryrun`) divide by the H100's published figures instead, `peak_flops_bf16`,
`hbm_bytes_per_s` and `link_bytes_per_s`, each for the card `CARD` names:
NVIDIA's data sheet of the SXM part at its full 700 W power limit.  A
mesh lays ranks out row-major over nodes of `NODE_CARDS` cards; an axis
whose ranks share a node talks over NVLink, one that spans nodes over one
400 Gb/s NIC a card.  Functions, not module constants: importing this
module starts nothing.
"""
from __future__ import annotations

import math

from .distributed import device_mesh, job_group


CARD = "NVIDIA H100 80GB HBM3, 700.00 W"   # the card the figures are for
NODE_CARDS = 8                             # cards a node joins by NVLink


def peak_flops_bf16() -> float:
    """Dense bfloat16 tensor-core operations a second of one `CARD`."""
    return 989e12


def hbm_bytes_per_s() -> float:
    """HBM3 bytes a second of one `CARD`."""
    return 3.35e12


def nvlink_bytes_per_s() -> float:
    """NVLink bytes a second each way between two cards of a node
    (`CARD`'s 900 GB/s both ways)."""
    return 450e9


def nic_bytes_per_s() -> float:
    """Bytes a second each way of one 400 Gb/s NIC a card, between
    nodes."""
    return 50e9


def link_bytes_per_s(ranks) -> float:
    """The rate of a collective over ``ranks`` (global ranks, laid out
    row-major over nodes of `NODE_CARDS`): NVLink when they share one
    node, the NIC when they span nodes."""
    nodes = {r // NODE_CARDS for r in ranks}
    return nvlink_bytes_per_s() if len(nodes) <= 1 else nic_bytes_per_s()


def _fake_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise ValueError(
                f"a fake mesh of {world} ranks needs this process outside "
                f"any job, but it is rank {dist.get_rank()} of "
                f"{dist.get_world_size()} ({dist.get_backend()})")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_production_mesh(*, multi_pod: bool = False, fake: bool = False,
                         device=None):
    """(16, 16) ``('data', 'model')``, or (2, 16, 16) ``('pod', 'data',
    'model')`` with ``multi_pod``, over the job's ranks (256 or 512 of
    them, a card each), or, with ``fake``, over a fake process group in
    this one process (see the module notes; ``device`` then defaults to
    the CPU, and nothing is allocated on it)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if fake:
        _fake_group(math.prod(shape))
        return device_mesh(shape, axes, device or "cpu")
    job_group(shape)
    return device_mesh(shape, axes, device or "cuda")


def make_host_mesh(data: int = 1, model: int = 1, *, pod: int = 0,
                   device=None):
    """A small mesh over the job's ranks (example runs, CPU tests):
    ``('data', 'model')`` of (data, model), or ``('pod', 'data',
    'model')`` with ``pod`` > 0.  Its extent must be the job's world size
    (one rank outside any job gets a one-rank gloo group).  ``device``:
    the card unless the caller asks for the CPU."""
    shape = ((pod,) if pod else ()) + (data, model)
    axes = (("pod",) if pod else ()) + ("data", "model")
    job_group(shape)
    return device_mesh(shape, axes, device or "cuda")


def axis_size(mesh, name: str) -> int:
    """The size of the mesh axis ``name``, 1 when the mesh has none."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def n_chips(mesh) -> int:
    return mesh.size()


def host_mesh_for(shape, device=None):
    """The host mesh of a ``(data, model)`` or ``(pod, data, model)``
    tuple."""
    shape = tuple(shape)
    if len(shape) == 3:
        return make_host_mesh(shape[1], shape[2], pod=shape[0],
                              device=device)
    return make_host_mesh(*shape, device=device)
