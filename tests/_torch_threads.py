"""The port's tests' thread budget under pytest-xdist.

PyTorch's CPU ops run on one OpenMP thread a core.  Under ``-n W``
workers every worker's pool, and the pool of every ``python -m
repro_torch...`` child a test starts, spin on all the cores at once, and
a test of small ops then takes 10-40x its time alone (``python -m
repro_torch.paper --quick``: ~9 s alone, ~120 s beside six busy pools of
eight threads).  So a worker gives itself, and the children it starts
(``OMP_NUM_THREADS``), an equal share of the cores.  Run alone, nothing
changes.  The port's test modules import this module."""
import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)

if _WORKERS > 1:
    _cores = len(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else (os.cpu_count() or 1)
    THREADS = max(1, _cores // _WORKERS)
    torch.set_num_threads(THREADS)
    os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
else:
    THREADS = torch.get_num_threads()
