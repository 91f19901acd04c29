"""The port's sharded pool: a ``pool.json`` whose population shards over a
1-D mesh of ranks (``sharding.mesh = (2,)``) runs through ``python -m
repro_torch.serve pool start|resume`` as one job of two gloo ranks on the
CPU, under the one process that stands for it
(`repro_torch.launch.distributed.run_job`).  Rank r runs its block of
members and writes their traces and checkpoints; rank 0 owns the pool
root.  Started for two segments and resumed for one, every member's
``trace.jsonl`` equals the unsharded pool's byte for byte, and every
checkpoint leaf and manifest number equals the unsharded pool's at the
same step.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)

from repro_torch.pop import PopulationSpec  # noqa: E402
from repro_torch.serve import list_resumable  # noqa: E402
from repro_torch.serve.__main__ import main  # noqa: E402
from repro_torch.serve.pool import member_dir, pool_status  # noqa: E402

B, SEGMENT_ROUNDS = 4, 2


def pool_json(path, mesh=()):
    d = PopulationSpec.from_dict({"base": dict(
        fleet={"n_devices": 8}, clustering={"n_clusters": 2},
        controller={"kind": "lyapunov",
                    "params": {"budget": 60.0, "horizon": 10}},
        aggregator={"kind": "trust"},
        task={"kind": "mlp", "params": {"n_samples": 256, "dim": 16,
                                        "hidden": 16}},
        execution="scanned", rounds=5, sim_seconds=1e9, local_batch=16,
        seed=42), "replicates": B}).to_dict()
    d["sharding"] = {**d["sharding"], "mesh": list(mesh)}
    path.write_text(json.dumps(d))
    return str(path)


def pool(cmd, root, *extra):
    return main(["pool", cmd, "--run-dir", root, "--segment-rounds",
                 str(SEGMENT_ROUNDS), "--keep", "0", "--foreground",
                 "--device", "cpu", *extra])


def read(path):
    with open(path, "rb") as f:
        return f.read()


def checkpoints(root, b):
    out = {}
    for step, path in list_resumable(os.path.join(member_dir(root, b),
                                                  "checkpoints")):
        with np.load(path) as z:
            leaves = {k: z[k] for k in z.files}
        with open(path[:-len(".npz")] + ".json") as f:
            manifest = json.load(f)
        out[step] = (leaves, {k: manifest[k] for k in
                              ("step", "rounds", "energy", "segment")})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pools")
    sharded, plain = str(tmp / "sharded"), str(tmp / "plain")
    rcs = [pool("start", sharded, "--spec-file",
                pool_json(tmp / "sharded.json", (2,)), "--max-segments", "2"),
           pool("resume", sharded, "--max-segments", "1"),
           pool("start", plain, "--spec-file", pool_json(tmp / "plain.json"),
                "--max-segments", "3")]
    return sharded, plain, rcs


def test_a_sharded_pool_json_runs_as_a_job_of_ranks(runs):
    sharded, plain, rcs = runs
    assert rcs == [0, 0, 0]
    st = pool_status(sharded)
    assert st["state"]["status"] == "stopped" and not st["alive"]
    assert st["state"]["members"] == B and len(st["state"]["ranks"]) == 2
    assert st["state"]["segment"] == 3
    assert st["state"]["rounds"] == 3 * SEGMENT_ROUNDS
    assert [m["checkpoint_step"] for m in st["members"]] \
        == [3 * SEGMENT_ROUNDS] * B
    assert st["state"]["energy"] == pool_status(plain)["state"]["energy"]


@pytest.mark.parametrize("b", range(B))
def test_each_member_equals_the_unsharded_pools(runs, b):
    sharded, plain, _ = runs
    got, want = (os.path.join(member_dir(r, b), "trace.jsonl")
                 for r in (sharded, plain))
    assert read(got) == read(want)
    assert read(os.path.join(member_dir(sharded, b), "spec.json")) \
        == read(os.path.join(member_dir(plain, b), "spec.json"))
    cg, cw = checkpoints(sharded, b), checkpoints(plain, b)
    assert sorted(cg) == sorted(cw) == [2, 4, 6]
    for step in cw:
        (lg, mg), (lw, mw) = cg[step], cw[step]
        assert mg == mw, step
        assert sorted(lg) == sorted(lw)
        for k in lw:
            np.testing.assert_array_equal(lg[k], lw[k], err_msg=k)
