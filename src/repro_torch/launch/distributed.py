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

A job that outlives its caller (the sharded service and pool,
`repro_torch.serve`) runs under `run_job`: this process starts the G
ranks and supervises them, and its one pid stands for the job.  SIGTERM
or SIGINT to it is passed to rank 0, which agrees the stop with the others
(`agree`); a rank dies with the supervisor (``PR_SET_PDEATHSIG``, set as
the rank joins its group), and when a rank fails the supervisor kills the
others, so no rank is left waiting in a collective or holding the card or
the coordinator's port.

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
ENV_JOB = "REPRO_DIST_JOB_PID"            # the supervisor of a `run_job`

DEFAULT_TIMEOUT_S = 300.0                 # of the group's collectives
POLL_S = 0.05                             # how often a job's ranks are polled

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
    if ENV_JOB in os.environ:
        die_with_job()
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


def in_job() -> bool:
    """Whether this process is a rank of a job (the ``REPRO_DIST_*`` env
    is set)."""
    return ENV_COORD in os.environ


def job_rank() -> int:
    """This process's rank in its job's group (0 outside any group)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def agree(value):
    """Rank 0's ``value`` on every rank of the job (a broadcast, which
    every rank calls); ``value`` itself outside a process group."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def every_rank(value) -> list:
    """``value`` of every rank of the job, in rank order (an all-gather,
    which every rank calls); ``[value]`` outside a process group."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [value]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def die_with_job() -> None:
    """Have the kernel SIGKILL this rank when its `run_job` supervisor
    dies (``PR_SET_PDEATHSIG``); exit at once if it is gone already."""
    import ctypes
    import signal
    job = int(os.environ[ENV_JOB])
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, int(signal.SIGKILL), 0, 0, 0)    # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass                  # no prctl: the supervisor's kills remain
    if os.getppid() != job:
        os._exit(1)


def run_job(argv: Sequence[str], n_procs: int, *,
            env: Optional[dict] = None) -> int:
    """Run ``n_procs`` ranks of ``[sys.executable, *argv]`` as one job
    supervised by this process, and return its exit code.

    The ranks write to this process's standard output and error.  Each
    gets the ``REPRO_DIST_*`` env (`spawn_local`'s) and this pid as
    ``REPRO_DIST_JOB_PID``: it dies with this process (`die_with_job`).
    SIGTERM and SIGINT to this process go on to rank 0, which agrees the
    stop with the other ranks (`agree`).  When a rank exits non-zero the
    others are killed at once and its code is returned (128 + the signal
    that ended it, as a shell reports one); 0 when every rank exits 0.
    Meant for a process that stands for the job (the sharded service's
    and pool's ``--foreground`` process): a ``start_new_session`` parent
    can end the whole job with one ``killpg``."""
    import signal
    job_env = _job_env(env, n_procs, f"127.0.0.1:{free_port()}", 1)
    job_env[ENV_JOB] = str(os.getpid())
    procs: List[subprocess.Popen] = []

    def forward(signum, frame):
        if procs and procs[0].poll() is None:
            procs[0].send_signal(signum)

    prev = {sig: signal.signal(sig, forward)
            for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        code = _run_ranks(argv, n_procs, job_env, procs,
                          lambda pid: {"stdin": subprocess.DEVNULL})
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
    if code:
        log.error("a rank of the job exited with code %d: ending the job",
                  code)
    return code if code >= 0 else 128 - code


def _job_env(env: Optional[dict], n_procs: int, coord: str,
             local_devices: int) -> dict:
    """``env`` (this process's when None) with the job's ``REPRO_DIST_*``
    variables but the rank's own (`_run_ranks` adds it)."""
    base = dict(os.environ if env is None else env)
    base.update({ENV_COORD: coord, ENV_NPROC: str(n_procs),
                 ENV_LOCAL: str(local_devices)})
    return base


def _run_ranks(argv: Sequence[str], n_procs: int, env: dict,
               procs: List[subprocess.Popen], streams,
               timeout: Optional[float] = None) -> int:
    """Start ``n_procs`` ranks of ``[sys.executable, *argv]`` into
    ``procs`` (rank r with ``env`` and its ``REPRO_DIST_PID``, its streams
    ``streams(r)``, keyword arguments of `subprocess.Popen`) and wait for
    them, polling every `POLL_S`.  Returns 0 when every rank exits 0,
    else the first failed rank's return code as soon as it is seen.  Past
    ``timeout`` seconds raises `subprocess.TimeoutExpired`.  Whatever
    ends the wait, the ranks still running are killed and every rank is
    reaped, so none is left waiting in a collective."""
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for pid in range(n_procs):
            procs.append(subprocess.Popen(
                [sys.executable, *argv], env={**env, ENV_PID: str(pid)},
                **streams(pid)))
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired([sys.executable, *argv],
                                                timeout)
            time.sleep(POLL_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


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
    job_env = _job_env(env, n_procs,
                       coordinator or f"127.0.0.1:{free_port()}",
                       local_devices)
    with tempfile.TemporaryDirectory(prefix="repro_dist_") as tmp:
        procs: List[subprocess.Popen] = []
        files = [(open(os.path.join(tmp, f"{pid}.out"), "w+"),
                  open(os.path.join(tmp, f"{pid}.err"), "w+"))
                 for pid in range(n_procs)]
        try:
            _run_ranks(argv, n_procs, job_env, procs,
                       lambda pid: {"stdout": files[pid][0],
                                    "stderr": files[pid][1], "text": True},
                       timeout)
        except subprocess.TimeoutExpired as e:
            # each rank's last words, to show where it waited
            tails = []
            for pid, (_, err) in enumerate(files):
                err.seek(0)
                tails.append(f"rank {pid}: {err.read()[-2000:]}")
            e.stderr = "\n".join(tails)
            raise
        results = []
        for p, (out, err) in zip(procs, files):
            out.seek(0)
            err.seek(0)
            results.append(subprocess.CompletedProcess(
                p.args, p.returncode, out.read(), err.read()))
            out.close()
            err.close()
    return results
