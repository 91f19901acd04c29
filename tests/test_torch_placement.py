"""The port's placement layer against the JAX package's.

`ShardingSpec`'s resolution and validation give the JAX package's results
and messages on the same inputs; `FederationSpec.validate` adds its two
sharding checks; `placement.resolve` turns a 1-D mesh into this rank's
share of a ``torch.distributed`` group (a one-shard mesh sets up its own
group in a plain process; a larger one needs a launch of as many ranks
and says how); `launch.distributed` keeps the JAX package's env contract,
picks its backend by one rule, and ends a job whose rank fails.  Every
test that starts processes has a timeout of its own.
"""
import json
import os
import subprocess
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import FederationSpec, ShardingSpec  # noqa: E402
from repro_torch.api import placement  # noqa: E402
from repro_torch.api import run as trun  # noqa: E402
from repro_torch.launch import distributed  # noqa: E402

try:            # the card's machine has no JAX: only the cuda tests run there
    from repro.api import spec as jspec
except ImportError:
    jspec = None

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


@pytest.fixture
def needs_jax():
    if jspec is None:
        pytest.skip("the JAX package is not installed")


SHARDINGS = [
    dict(mesh=(8,)), dict(mesh=(1,)), dict(mesh=(3,)),
    dict(mesh=(3,), impl="gspmd"), dict(mesh=(4, 2)),
    dict(mesh=(4, 2), axes=("cluster", "fleet"), cluster_axis="cluster"),
    dict(mesh=(4, 2), axes=("fleet",)), dict(mesh=(4, 2), axes=("x", "x"),
                                             device_axis="x"),
    dict(mesh=(4,), axes=("pod",)), dict(mesh=(2, 2, 2)),
    dict(mesh=(4,), cluster_axis="fleet", impl="gspmd"),
    dict(mesh=(8,), cluster_axis="fleet", device_axis=None, impl="gspmd"),
    dict(mesh=(0,)), dict(mesh=(4, 2), impl="shard_map"),
    dict(mesh=(2,), impl="pjit"), dict(mesh=(4,), cluster_axis="pod"),
    dict(mesh=(2,), device_axis=None),
]


def _outcome(fn):
    try:
        out = fn()
    except (ValueError, KeyError) as e:
        return type(e).__name__, str(e)
    return "ok", repr(out)


@pytest.mark.parametrize("kw", SHARDINGS,
                         ids=[str(i) for i in range(len(SHARDINGS))])
@pytest.mark.parametrize("n,C", [(16, 4), (24, 6), (3, 4)])
def test_sharding_spec_matches_reference(needs_jax, kw, n, C):
    """resolved_impl / resolved_axes / resolved_cluster_axis and validate:
    the same results and the same messages as the JAX package's."""
    ours, ref = ShardingSpec(**kw), jspec.ShardingSpec(**kw)
    for name in ("resolved_impl", "resolved_axes"):
        assert _outcome(getattr(ours, name)) == _outcome(getattr(ref, name))
    axes = _outcome(ref.resolved_axes)
    if axes[0] == "ok":
        got = ours.resolved_cluster_axis(ours.resolved_axes())
        assert got == ref.resolved_cluster_axis(ref.resolved_axes())
    mine, theirs = _outcome(lambda: ours.validate(n, C)), _outcome(
        lambda: ref.validate(n, C))
    assert mine[0] == theirs[0] and (mine[0] == "ok" or mine == theirs)


def test_sharding_spec_dict_roundtrip(needs_jax):
    spec = FederationSpec(sharding=ShardingSpec(mesh=(8,)))
    d = spec.to_dict()
    assert d["sharding"]["mesh"] == (8,)
    assert FederationSpec.from_dict(json.loads(json.dumps(d))) == spec
    two_d = ShardingSpec(mesh=[4, 2], axes=["cluster", "fleet"],
                         cluster_axis="cluster")
    assert two_d.mesh == (4, 2) and two_d.axes == ("cluster", "fleet")
    jax_spec = jspec.FederationSpec.from_dict(d)
    assert jax_spec.to_dict() == d


@pytest.mark.parametrize("change,error,match", [
    # the JAX package's two sharding checks, its messages
    ({"scale": "datacenter", "task": {"kind": "lm", "params": {}},
      "sharding": {"mesh": [1]}}, ValueError, "not supported at datacenter"),
    ({"sharding": {"mesh": [3], "impl": "shard_map", "device_axis": "pod"}},
     ValueError, "not a mesh axis"),
    ({"sharding": {"mesh": [4, 2], "impl": "shard_map"}}, ValueError,
     "runs on 1-D meshes"),
], ids=["datacenter", "device-axis", "shard-map-2d"])
def test_federation_spec_sharding_checks(change, error, match):
    d = FederationSpec().to_dict()
    d.update(change)
    with pytest.raises(error, match=match):
        FederationSpec.from_dict(d).validate()
    if jspec is not None and error is ValueError:
        with pytest.raises(ValueError, match=match):
            jspec.FederationSpec.from_dict(d).validate()


@pytest.mark.parametrize("change,ranks", [
    # refused (NotImplementedError) before the partitioner-inferred
    # placement was ported; now each validates as the JAX package's does
    # and builds: outside a launch of as many ranks as the mesh has shards
    # with the placement's message, a one-shard one here, and mesh (2,) /
    # (2, 2) under launches in tests/test_torch_gspmd.py
    ({"sharding": {"mesh": [2], "impl": "gspmd"}}, 2),
    ({"sharding": {"mesh": [4, 2]}}, 8),
    ({"scale": "device-gspmd"}, 0),
], ids=["gspmd", "two-axes", "gspmd-scale"])
def test_gspmd_specs_validate_and_build(change, ranks):
    d = FederationSpec(controller=tapi_fixed()).to_dict()
    d.update(change)
    d["fleet"]["n_devices"] = 8
    d["task"]["params"] = {"n_samples": 256, "dim": 16, "hidden": 8}
    spec = FederationSpec.from_dict(d).validate()
    if jspec is not None:
        jspec.FederationSpec.from_dict(d).validate()
    from repro_torch.api import Federation
    if ranks > 1:
        if not torch.distributed.is_initialized():
            with pytest.raises(ValueError, match=f"needs {ranks} ranks"):
                Federation.from_spec(spec, device="cpu")
        one = {**d, "sharding": {**d["sharding"],
                                 "mesh": [1] * len(d["sharding"]["mesh"])}}
        spec = FederationSpec.from_dict(one).validate()
    fed = Federation.from_spec(spec, device="cpu")
    assert type(fed.engine).__name__ in ("DeviceScaleEngine",
                                         "DeviceScaleGspmdEngine")
    assert len(fed.run(eval_every=0.0, max_rounds=2).records) == 2


def tapi_fixed():
    from repro_torch.api import ControllerSpec
    return ControllerSpec("fixed", {"a": 2})


def test_one_dimensional_mesh_validates():
    spec = FederationSpec(sharding=ShardingSpec(mesh=(3,))).validate()
    assert spec.sharding.resolved_impl() == "shard_map"


def test_resolve_placement():
    assert placement.resolve(ShardingSpec(), n_devices=16, n_clusters=4) \
        is placement.SINGLE_DEVICE
    assert not placement.SINGLE_DEVICE.is_sharded
    if not torch.distributed.is_initialized():
        with pytest.raises(ValueError) as e:
            placement.resolve(ShardingSpec(mesh=(2,)), n_devices=16,
                              n_clusters=4, device="cpu")
        for word in ("needs 2 ranks", "spawn_local", "REPRO_DIST_COORD",
                     "REPRO_DIST_NPROC", "REPRO_DIST_PID",
                     "initialize_from_env"):
            assert word in str(e.value)
    # a one-shard mesh sets up its own one-rank group
    pl = placement.resolve(ShardingSpec(mesh=(1,)), n_devices=16,
                           n_clusters=4, device="cpu")
    assert pl.is_sharded and (pl.world_size, pl.rank) == (1, 0)
    assert pl.device == torch.device("cpu") and pl.axes == ("fleet",)
    assert pl.group_axis("twins") == pl.group_axis("cluster_flat") == "fleet"
    assert pl.group_axis("queue") is None
    # now the process is rank 0 of 1: a larger mesh still says what to do
    with pytest.raises(ValueError, match="rank 0 of 1.*spawn_local"):
        placement.resolve(ShardingSpec(mesh=(2,)), n_devices=16,
                          n_clusters=4, device="cpu")
    # impl='gspmd' resolves to a DeviceMesh of the spec's axes
    pl = placement.resolve(ShardingSpec(mesh=(1,), impl="gspmd"),
                           n_devices=16, n_clusters=4, device="cpu")
    assert pl.is_gspmd and pl.mesh.mesh_dim_names == ("fleet",)
    assert (pl.device_axis, pl.cluster_axis) == ("fleet", None)
    with pytest.raises(ValueError, match="does not divide"):
        placement.resolve(ShardingSpec(mesh=(3,), impl="gspmd"),
                          n_devices=16, n_clusters=4, device="cpu")


def test_cli_mesh_outside_a_launch_exits_2(capsys, monkeypatch):
    for var in (distributed.ENV_COORD, distributed.ENV_NPROC,
                distributed.ENV_PID):
        monkeypatch.delenv(var, raising=False)
    assert trun.main(["--scenario", "byzantine", "--mesh", "2", "--device",
                      "cpu", "--devices", "8", "--clusters", "2"]) == 2
    assert "spawn_local" in capsys.readouterr().err
    assert trun.main(["--scenario", "byzantine", "--mesh", "x"]) == 2
    assert "expected a mesh shape" in capsys.readouterr().err
    assert trun.main(["--scenario", "byzantine", "--mesh", "3", "--impl",
                      "shard_map", "--devices", "2", "--clusters",
                      "4"]) == 2
    assert "n_devices < n_clusters" in capsys.readouterr().err


def test_initialize_from_env_contract(monkeypatch):
    monkeypatch.delenv(distributed.ENV_COORD, raising=False)
    assert distributed.initialize_from_env(device="cpu") is None
    monkeypatch.setenv(distributed.ENV_COORD, "127.0.0.1:1")
    monkeypatch.setenv(distributed.ENV_NPROC, "2")
    monkeypatch.setenv(distributed.ENV_PID, "0")
    monkeypatch.setenv(distributed.ENV_LOCAL, "2")
    with pytest.raises(ValueError, match="exactly one shard"):
        distributed.initialize_from_env(device="cpu")
    assert distributed.backend_for("cpu", 2) == "gloo"
    if torch.cuda.device_count() < 2:      # ranks would share a card
        assert distributed.backend_for("cuda", 2) == "gloo"


_FAILING = r"""
import os, sys, datetime
import torch, torch.distributed as dist
r = int(os.environ["REPRO_DIST_PID"])
dist.init_process_group("gloo", init_method="tcp://"
                        + os.environ["REPRO_DIST_COORD"], rank=r,
                        world_size=int(os.environ["REPRO_DIST_NPROC"]),
                        timeout=datetime.timedelta(seconds=600))
if r == 1:
    raise RuntimeError("rank 1 fails")
dist.all_reduce(torch.ones(3))          # waits for rank 1 for ever
"""


def test_a_failing_rank_ends_the_job():
    """Rank 1 raises while rank 0 waits in a collective whose own timeout
    is ten minutes: `spawn_local` ends the job at the first non-zero exit,
    in seconds."""
    env = dict(os.environ, PYTHONPATH=SRC)
    t0 = time.monotonic()
    out = distributed.spawn_local(["-c", _FAILING], n_procs=2, timeout=90,
                                  env=env)
    assert time.monotonic() - t0 < 60
    assert out[1].returncode == 1 and "rank 1 fails" in out[1].stderr
    assert out[0].returncode != 0


def test_a_hanging_job_is_killed_at_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired):
        distributed.spawn_local(["-c", "import time; time.sleep(60)"],
                                n_procs=2, timeout=1)
    assert time.monotonic() - t0 < 30


def test_spawn_local_env_contract():
    code = ("import os, json; print(json.dumps({k: os.environ[k] for k in "
            "('REPRO_DIST_COORD', 'REPRO_DIST_NPROC', 'REPRO_DIST_PID', "
            "'REPRO_DIST_LOCAL_DEVICES')}))")
    out = distributed.spawn_local(["-c", code], n_procs=3, timeout=60)
    envs = [json.loads(o.stdout) for o in out]
    assert [e["REPRO_DIST_PID"] for e in envs] == ["0", "1", "2"]
    assert {e["REPRO_DIST_COORD"] for e in envs} == {envs[0][
        "REPRO_DIST_COORD"]}
    assert all(e["REPRO_DIST_NPROC"] == "3" and
               e["REPRO_DIST_LOCAL_DEVICES"] == "1" for e in envs)
