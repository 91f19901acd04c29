"""The port's sharded service: a device-scale spec on a 1-D mesh of two
ranks, the cluster-major engine (``impl='shard_map'``) and the
partitioner-inferred placement (``impl='gspmd'``), through ``python -m
repro_torch.serve start|stop|resume|chaos`` as one job of two gloo ranks
on the CPU, under the one process that stands for it
(`repro_torch.launch.distributed.run_job`).

* Started in the background, stopped (``stop``: SIGTERM to that process,
  passed to rank 0, which agrees the stop with rank 1) and resumed for one
  segment, its ``trace.jsonl`` equals an uninterrupted sharded run's byte
  for byte; the last checkpoint, whole and in the unsharded layout,
  restores into an unsharded `DeviceScaleEngine`; the JAX package's
  ``load_checkpoint``, ``read_jsonl_trace`` and ``service_status`` read
  the run dir; its snapshots carry both ranks' kernel launches.

``tests/test_torch_chaos_sharded.py`` SIGKILLs such a job.
"""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)

from repro_torch import api as tapi  # noqa: E402
from repro_torch.api.records import read_jsonl_trace  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.checkpoint.ckpt import _leaves  # noqa: E402
from repro_torch.serve import (latest_resumable,  # noqa: E402
                               restore_resumable)
from repro_torch.serve.__main__ import main  # noqa: E402
from repro_torch.serve.runner import _resumable_tree  # noqa: E402
from repro_torch.serve.service import (load_run_metrics,  # noqa: E402
                                       pid_alive, service_status)

try:            # the card's machine has no JAX: only its tests skip there
    from repro.api.records import read_jsonl_trace as jax_read_trace
    from repro.checkpoint import load_checkpoint as jax_load_checkpoint
    from repro.serve.service import service_status as jax_status
except ImportError:
    jax_status = None

IMPLS = ("shard_map", "gspmd")
SEGMENT_ROUNDS = 3


def spec_dict(mesh=(), impl=None):
    return dict(fleet={"n_devices": 8}, clustering={"n_clusters": 2},
                controller={"kind": "lyapunov",
                            "params": {"budget": 120.0, "horizon": 40}},
                aggregator={"kind": "trust"},
                task={"kind": "mlp", "params": {"n_samples": 512, "dim": 16,
                                                "hidden": 8}},
                execution="scanned", rounds=3, sim_seconds=1e9,
                local_batch=16, seed=5,
                sharding={"mesh": list(mesh), "impl": impl})


def write_spec(path, d):
    path.write_text(json.dumps(d))
    return str(path)


def loop(*extra):
    return ["--segment-rounds", str(SEGMENT_ROUNDS), "--keep", "0",
            "--device", "cpu", *extra]


def read(path):
    with open(path, "rb") as f:
        return f.read()


def wait_for(predicate, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return False


@pytest.fixture(scope="module", params=IMPLS)
def stopped_and_resumed(request, tmp_path_factory):
    """A sharded service started in the background, stopped after its first
    checkpoint, resumed for one segment; then an uninterrupted sharded run
    of as many segments."""
    impl = request.param
    tmp = tmp_path_factory.mktemp(impl)
    spec = write_spec(tmp / "spec.json", spec_dict((2,), impl))
    d = str(tmp / "run")
    assert main(["start", "--run-dir", d, "--spec-file", spec,
                 *loop()]) == 0
    pid = json.loads(read(os.path.join(d, "serve.pid")) or b"0")
    ckpts = os.path.join(d, "checkpoints")
    assert wait_for(lambda: latest_resumable(ckpts) is not None)
    assert main(["stop", "--run-dir", d, "--timeout", "120"]) == 0
    assert not pid_alive(pid)
    stopped = service_status(d)["state"]
    assert main(["resume", "--run-dir", d, "--foreground",
                 "--max-segments", "1", *loop()]) == 0
    ref = str(tmp / "ref")
    assert main(["start", "--run-dir", ref, "--spec-file", spec,
                 "--foreground", "--max-segments",
                 str(stopped["segment"] + 1), *loop()]) == 0
    return {"impl": impl, "dir": d, "ref": ref, "stopped": stopped,
            "spec": spec}


def test_stop_resume_equals_an_uninterrupted_sharded_run(
        stopped_and_resumed):
    r = stopped_and_resumed
    assert r["stopped"]["status"] == "stopped"
    assert len(r["stopped"]["ranks"]) == 2
    st = service_status(r["dir"])
    assert st["state"]["status"] == "stopped" and not st["alive"]
    assert st["state"]["segment"] == r["stopped"]["segment"] + 1
    assert read(os.path.join(r["dir"], "trace.jsonl")) \
        == read(os.path.join(r["ref"], "trace.jsonl"))
    assert st["state"]["energy"] == service_status(r["ref"])["state"][
        "energy"]
    # rank 0's snapshots carry every rank's kernel launches
    fam = load_run_metrics(r["dir"])["families"]["fl_kernel_launches"]
    assert {x["labels"]["rank"] for x in fam["series"]} == {"0", "1"}


def test_the_last_checkpoint_restores_into_an_unsharded_engine(
        stopped_and_resumed):
    r = stopped_and_resumed
    path, manifest = latest_resumable(os.path.join(r["dir"], "checkpoints"))
    fed = tapi.Federation.from_dict(spec_dict(), device="cpu")
    assert type(fed.engine) is tapi.DeviceScaleEngine
    got = restore_resumable(fed, os.path.join(r["dir"], "checkpoints"))
    assert got == manifest and fed.engine.round == manifest["rounds"]
    tree = _resumable_tree(fed)
    want = load_checkpoint(path, like=tree)
    flat = lambda t: [x for x in torch.utils._pytree.tree_leaves(t)   # noqa
                      if isinstance(x, (torch.Tensor, np.ndarray))]
    for a, b in zip(flat(tree), flat(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_the_jax_package_reads_the_sharded_run_dir(stopped_and_resumed):
    if jax_status is None:
        pytest.skip("the JAX package is not installed")
    r = stopped_and_resumed
    st, jst = service_status(r["dir"]), jax_status(r["dir"])
    assert st == jst
    trace = os.path.join(r["dir"], "trace.jsonl")
    assert read_jsonl_trace(trace).records \
        == [tapi.RoundRecord(**vars(x))
            for x in jax_read_trace(trace).records]
    path = st["latest_checkpoint"]
    with np.load(path) as z:
        raw = {k: z[k] for k in z.files}
    fed = tapi.Federation.from_dict(spec_dict(), device="cpu")
    mine = dict(_leaves(load_checkpoint(path, like=_resumable_tree(fed))))
    theirs = jax_load_checkpoint(path, like=raw)   # the file's own paths
    assert sorted(mine) == sorted(theirs) == sorted(raw)
    for k, v in mine.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(theirs[k]))
