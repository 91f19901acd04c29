"""The port's pool supervisor (`repro_torch.serve.pool`) and its CLI.

* Per-member run dirs in the single-tenant format; a resume from a ragged
  checkpoint frontier continues at the common step, and the resumed pool
  writes the same member traces, byte for byte, as a pool run straight
  through.  Each member's trace equals a single-tenant `run_service` of
  its spec: the schedule exactly, the values within the population's
  tolerance (`tests/test_torch_pop.py`: 1e-6 relative).
* ``pop``-labelled telemetry respects the registry's cardinality cap.
* Each package's ``pool status`` reads the other's pool dir; the port
  refuses to resume a JAX package pool (its checkpoints carry a PRNG
  key), as it refuses a single-tenant JAX checkpoint.
* ``python -m repro_torch.serve pool start|resume|status`` on the CPU.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.obs import EngineObs  # noqa: E402
from repro_torch.pop import PopulationSpec  # noqa: E402
from repro_torch.serve.__main__ import main  # noqa: E402
from repro_torch.serve.pool import (common_checkpoint_step,  # noqa: E402
                                    load_pool_spec, member_dir,
                                    pool_status, run_pool, write_pool_spec)
from repro_torch.serve.service import RunDir, run_service  # noqa: E402

try:            # the card's machine has no JAX: only its tests skip there
    import jax  # noqa: F401
    from repro.serve import pool as jpool
except ImportError:
    jpool = None


def quiet(msg):
    pass


def spec_dict(seed=42, kind="fixed", params=None):
    return dict(fleet={"n_devices": 8}, clustering={"n_clusters": 2},
                controller={"kind": kind, "params": params or {"a": 3}},
                aggregator={"kind": "trust"},
                task={"kind": "mlp", "params": {"n_samples": 256, "dim": 16,
                                                "hidden": 16}},
                execution="scanned", rounds=5, sim_seconds=1e9,
                local_batch=16, seed=seed)


def read_trace(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def assert_same_trace_records(got, want, rtol=1e-6):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert {k: a[k] for k in ("round", "cluster", "a", "agg_count")} \
            == {k: b[k] for k in ("round", "cluster", "a", "agg_count")}
        np.testing.assert_allclose(
            [a["t"], a["loss"], a["energy"], a["acc"] or 0.0],
            [b["t"], b["loss"], b["energy"], b["acc"] or 0.0], rtol=rtol,
            atol=0)


def make_pool(root, pspec):
    os.makedirs(root)
    write_pool_spec(root, pspec)
    return root


LYAPUNOV = {"budget": 60.0, "horizon": 10}


def test_pool_resumes_a_ragged_frontier_at_the_common_step(tmp_path):
    pspec = PopulationSpec.from_dict({
        "base": spec_dict(kind="lyapunov", params=LYAPUNOV),
        "grid": {"lr": [0.05, 0.1]}})
    root = make_pool(str(tmp_path / "pool"), pspec)
    run_pool(root, segment_rounds=2, max_segments=2, keep=None,
             device="cpu", log=quiet)
    dirs = [member_dir(root, b) for b in range(2)]
    assert common_checkpoint_step(dirs) == 4

    # a ragged frontier: member 1 lost its newest checkpoint (a crash
    # mid-sweep); resume falls back to the common step for both
    ckpts = os.path.join(dirs[1], "checkpoints")
    for f in os.listdir(ckpts):
        if "00000004" in f:
            os.remove(os.path.join(ckpts, f))
    assert common_checkpoint_step(dirs) == 2
    run_pool(root, segment_rounds=2, max_segments=2, keep=None,
             resume=True, device="cpu", log=quiet)

    st = pool_status(root)
    assert st["state"]["status"] == "stopped" and not st["alive"]
    assert st["state"]["rounds"] == 6
    assert [m["checkpoint_step"] for m in st["members"]] == [6, 6]
    assert load_pool_spec(root) == pspec

    straight = make_pool(str(tmp_path / "straight"), pspec)
    run_pool(straight, segment_rounds=2, max_segments=3, keep=None,
             device="cpu", log=quiet)
    for b, spec in enumerate(pspec.expand()):
        got = read_trace(os.path.join(dirs[b], "trace.jsonl"))
        with open(os.path.join(dirs[b], "trace.jsonl"), "rb") as f, \
                open(os.path.join(member_dir(straight, b), "trace.jsonl"),
                     "rb") as g:
            assert f.read() == g.read(), f"member {b} resumed != straight"
        # each member dir speaks the single-tenant protocol, and its trace
        # is a single-tenant service run of the member's spec
        sdir = str(tmp_path / f"single{b}")
        RunDir(sdir).ensure().write_spec(spec)
        run_service(sdir, segment_rounds=2, max_segments=3, keep=None,
                    device="cpu", log=quiet)
        assert_same_trace_records(
            got, read_trace(os.path.join(sdir, "trace.jsonl")))
        with open(os.path.join(dirs[b], "spec.json")) as f:
            assert json.load(f) == json.loads(json.dumps(spec.to_dict()))


def test_pool_metrics_pop_label_cardinality_cap():
    obs = EngineObs(source="pool", max_series=4)
    g = obs.registry.gauge("pool_member_loss", "per-member loss")
    for b in range(32):
        g.set(float(b), pop=str(b))
    snap = obs.registry.snapshot()
    series = snap["families"]["pool_member_loss"]["series"]
    assert len(series) <= 5                  # cap + the overflow series
    assert {"overflow": "true"} in [s["labels"] for s in series]
    dropped = snap["families"]["metrics_dropped_series_total"]["series"]
    assert dropped[0]["labels"] == {"metric": "pool_member_loss"}
    assert dropped[0]["value"] >= 28


@pytest.fixture(scope="module")
def jax_pool_dir(tmp_path_factory):
    """One JAX package pool of the tiny spec, 2 members x 2 segments."""
    if jpool is None:
        pytest.skip("the JAX package is not installed")
    from repro.pop import PopulationSpec as JaxPopulationSpec
    root = str(tmp_path_factory.mktemp("jaxpool") / "pool")
    os.makedirs(root)
    jpool.write_pool_spec(root, JaxPopulationSpec.from_dict(
        {"base": spec_dict(seed=7), "replicates": 2}))
    jpool.run_pool(root, segment_rounds=2, max_segments=2, keep=None,
                   log=quiet)
    return root


def test_each_package_reads_the_others_pool_status(jax_pool_dir, tmp_path):
    ours = pool_status(jax_pool_dir)
    theirs = jpool.pool_status(jax_pool_dir)
    assert ours == theirs
    assert [m["checkpoint_step"] for m in ours["members"]] == [4, 4]
    assert ours["state"]["status"] == "stopped"
    root = make_pool(str(tmp_path / "pool"), PopulationSpec.from_dict(
        {"base": spec_dict(seed=7), "replicates": 2}))
    run_pool(root, segment_rounds=2, max_segments=1, keep=None,
             device="cpu", log=quiet)
    assert jpool.pool_status(root) == pool_status(root)
    assert [m["checkpoint_step"] for m in pool_status(root)["members"]] == \
        [2, 2]


def test_the_port_refuses_to_resume_a_jax_pool(jax_pool_dir, tmp_path,
                                               capsys):
    with pytest.raises(ValueError, match="JAX package checkpoint"):
        run_pool(jax_pool_dir, segment_rounds=2, max_segments=1,
                 resume=True, device="cpu", log=quiet)
    assert pool_status(jax_pool_dir)["state"]["status"] == "failed"


def test_pool_cli_start_resume_status_on_the_cpu(tmp_path, capsys):
    spec_file = tmp_path / "population.json"
    spec_file.write_text(json.dumps({"base": spec_dict(), "replicates": 2}))
    root = str(tmp_path / "pool")
    loop = ["--segment-rounds", "2", "--keep", "0", "--foreground",
            "--device", "cpu"]
    assert main(["pool", "start", "--run-dir", root, "--spec-file",
                 str(spec_file), "--max-segments", "1", *loop]) == 0
    # a second start refuses: the members have checkpoints
    assert main(["pool", "start", "--run-dir", root, "--max-segments", "1",
                 *loop]) == 1
    assert "pool resume" in capsys.readouterr().err
    assert main(["pool", "resume", "--run-dir", root, "--max-segments", "1",
                 *loop]) == 0
    capsys.readouterr()
    assert main(["pool", "status", "--run-dir", root]) == 0
    st = json.loads(capsys.readouterr().out)
    assert st["state"]["status"] == "stopped"
    assert [m["checkpoint_step"] for m in st["members"]] == [4, 4]
    assert all(m["last_records"][0]["round"] == 4 for m in st["members"])
    # no pool.json: resume says so; a member's dir is a single-tenant one
    assert main(["pool", "resume", "--run-dir", str(tmp_path / "none"),
                 *loop]) == 1
    assert main(["status", "--run-dir", member_dir(root, 1)]) == 0
    assert json.loads(capsys.readouterr().out)["latest_checkpoint"] \
        is not None
