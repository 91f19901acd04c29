"""`torch.distributed` bring-up: one process a shard.

Every rank runs the *same* program and owns exactly one shard of the
mesh, so the mesh's extent is the world size.  The cluster-major round's
two SUM all-reduces (`repro_torch.api.cluster_engine`) and the
collectives DTensor infers for the partitioner-inferred placement (over
the `device_mesh` of the job's ranks) run as real cross-process
collectives.

    # parent: spawn 2 ranks of this very script
    from repro_torch.launch.distributed import spawn_local
    results = spawn_local([sys.argv[0], "--dist-worker"], n_procs=2)

    # rank (before building a sharded federation):
    from repro_torch.launch.distributed import initialize_from_env
    initialize_from_env()

The env contract (``REPRO_DIST_COORD`` / ``_NPROC`` / ``_PID``, and
``_LOCAL_DEVICES``, which must be 1) is the JAX package's, so it also
works under an external launcher (mpirun, srun, k8s indexed jobs): export
the variables for each rank and call :func:`initialize_from_env`.

The backend follows one rule, logged at start: ``nccl`` when every rank
has a card of its own (CUDA and at least as many cards as ranks; rank r
takes card r), ``gloo`` on the CPU and when ranks share a card (gloo
carries ``all_reduce`` and ``broadcast`` of CUDA tensors; NCCL refuses
two ranks on one card; DTensor's all-gather of CUDA tensors over gloo
ends the process with a segfault, so the partitioner-inferred placement
refuses ranks that share a card: `repro_torch.api.placement`).  A failed
start raises; nothing falls back to another backend.
"""
from __future__ import annotations

import datetime
import logging
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

ENV_COORD = "REPRO_DIST_COORD"            # host:port of rank 0
ENV_NPROC = "REPRO_DIST_NPROC"            # world size
ENV_PID = "REPRO_DIST_PID"                # this process's rank
ENV_LOCAL = "REPRO_DIST_LOCAL_DEVICES"    # shards a rank: must be 1

DEFAULT_TIMEOUT_S = 300.0                 # of the group's collectives

log = logging.getLogger("repro_torch.distributed")


def backend_for(device, world_size: int) -> str:
    """The backend rule: ``nccl`` when each of ``world_size`` ranks has a
    card of its own, ``gloo`` on the CPU and when ranks share a card."""
    import torch
    dev = torch.device(device)
    if (dev.type == "cuda" and torch.cuda.is_available()
            and torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


def initialize_from_env(device=None,
                        timeout: float = DEFAULT_TIMEOUT_S) -> Optional[int]:
    """Join the process group described by the ``REPRO_DIST_*`` env.

    No-op (returns None) when ``REPRO_DIST_COORD`` is unset, so an entry
    point can call it unconditionally and still run as one process, and
    (returns the rank) when this process has joined its group already, so
    a rank can run several entry points.  Otherwise returns the rank after
    ``init_process_group`` with the backend of `backend_for` on ``device``
    (the card unless the caller asks for the CPU), the given collective
    timeout, and, under ``nccl``, card ``rank`` as the current device."""
    coord = os.environ.get(ENV_COORD)
    if coord is None:
        return None
    import torch
    import torch.distributed as dist

    nproc = int(os.environ[ENV_NPROC])
    pid = int(os.environ[ENV_PID])
    local = int(os.environ.get(ENV_LOCAL, "1"))
    if local != 1:
        raise ValueError(
            f"{ENV_LOCAL}={local}: a rank of the port owns exactly one "
            f"shard, so the mesh's extent is the world size; launch "
            f"{nproc * local} ranks with {ENV_LOCAL}=1 instead")
    if dist.is_initialized():
        return dist.get_rank()
    dev = torch.device("cuda" if device is None else device)
    backend = backend_for(dev, nproc)
    if backend == "nccl":
        torch.cuda.set_device(pid)
    log.info("rank %d of %d: backend %s (%s)", pid, nproc, backend,
             "a card a rank" if backend == "nccl" else
             ("ranks share a card" if dev.type == "cuda" else "the CPU"))
    dist.init_process_group(
        backend, init_method=f"tcp://{coord}", world_size=nproc, rank=pid,
        timeout=datetime.timedelta(seconds=float(timeout)))
    return pid


def device_mesh(shape: Sequence[int], axes: Sequence[str], device):
    """The ``torch.distributed`` `DeviceMesh` of ``shape`` over the job's
    process group (which must exist and hold ``prod(shape)`` ranks), its
    dims named ``axes``; rank ``r`` sits at the row-major position ``r``.
    It is built on ``device`` itself: a CUDA device is made current first,
    so the mesh does not guess a card from the rank (ranks that share a
    card all stay on it).  Each mesh dim's group takes the job's backend
    (`backend_for`'s rule)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device()
                              if dev.index is None else dev.index)
    ranks = torch.arange(dist.get_world_size(), dtype=torch.int)
    return DeviceMesh(dev.type, ranks.reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def job_group(mesh_shape: Sequence[int]):
    """The process group backing a mesh of one shard a rank, or a readable
    error.  A one-shard mesh in a process outside any job gets a one-rank
    gloo group on a free localhost port."""
    import math

    import torch.distributed as dist
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


def free_port() -> int:
    """An OS-assigned free TCP port (release-then-reuse: fine for a
    localhost coordinator started immediately after)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_local(argv: Sequence[str], n_procs: int = 2,
                local_devices: int = 1, coordinator: Optional[str] = None,
                timeout: float = 1200.0,
                env: Optional[dict] = None
                ) -> List[subprocess.CompletedProcess]:
    """Run ``n_procs`` copies of ``[sys.executable, *argv]`` as one job of
    ranks on this host.

    Each copy gets the ``REPRO_DIST_*`` env pointing at a shared localhost
    coordinator (rank 0).  Blocks until every rank exits and returns their
    `CompletedProcess` results (stdout/stderr captured, text mode); the
    caller asserts on the return codes and parses what the ranks printed.
    The first rank to exit non-zero ends the job: the others, which would
    wait in a collective, are killed at once.  Past ``timeout`` seconds
    every rank is killed and `subprocess.TimeoutExpired` raised, its
    ``stderr`` the end of each rank's standard error."""
    coord = coordinator or f"127.0.0.1:{free_port()}"
    base = dict(os.environ if env is None else env)
    with tempfile.TemporaryDirectory(prefix="repro_dist_") as tmp:
        procs, files = [], []
        for pid in range(n_procs):
            e = dict(base)
            e.update({ENV_COORD: coord, ENV_NPROC: str(n_procs),
                      ENV_PID: str(pid), ENV_LOCAL: str(local_devices)})
            out = open(os.path.join(tmp, f"{pid}.out"), "w+")
            err = open(os.path.join(tmp, f"{pid}.err"), "w+")
            files.append((out, err))
            procs.append(subprocess.Popen([sys.executable, *argv], env=e,
                                          stdout=out, stderr=err,
                                          text=True))
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in procs]
                if all(c is not None for c in codes):
                    break
                if any(c not in (None, 0) for c in codes):
                    break                   # a rank failed: end the job
                if time.monotonic() > deadline:
                    # each rank's last words, to show where it waited
                    tails = []
                    for pid, (_, err) in enumerate(files):
                        err.flush()
                        err.seek(0)
                        tails.append(f"rank {pid}: {err.read()[-2000:]}")
                    raise subprocess.TimeoutExpired(
                        [sys.executable, *argv], timeout,
                        stderr="\n".join(tails))
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        results = []
        for p, (out, err) in zip(procs, files):
            out.seek(0)
            err.seek(0)
            results.append(subprocess.CompletedProcess(
                p.args, p.returncode, out.read(), err.read()))
            out.close()
            err.close()
    return results
