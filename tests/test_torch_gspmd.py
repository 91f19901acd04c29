"""The port's partitioner-inferred placement (``impl='gspmd'``, multi-axis
meshes, the ``device-gspmd`` scale): `DeviceScaleEngine` on DTensors.

The contract, the JAX package's (``tests/test_placement.py``): placement
changes *where* the federation's tensors live, never *what* it does.

* Meshes (1,) and (1, 1) reproduce the unsharded engine's scanned and
  event records bit for bit; mesh (1,) is held to the JAX package's gspmd
  engine at mesh (1,) on the JAX package's draws.
* Meshes (2,) and (2, 2) (one ``spawn_local`` job each, gloo on the CPU):
  every rank's trace equal, the schedule exact, t, loss and energy within
  rtol 1e-5 (the JAX package's ``_assert_sharded_parity``), under the fixed
  and Lyapunov controllers and the DQN, whose net is rank 0's on every
  rank; the two-step DP path at (2,); a checkpoint moves between (2,) and
  the unsharded engine in both directions; the scenario CLI at
  ``--mesh 2x2``.
* The DTensor sharding rules of the trust kernels and the per-member
  products launch each operator on the local tensors and agree with the
  plain call; the placements are the JAX package's ``NamedSharding`` s;
  malformed meshes give the JAX package's messages.
"""
import concurrent.futures
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)

from repro_torch import api as tapi  # noqa: E402
from repro_torch.api import placement  # noqa: E402
from repro_torch.launch.distributed import spawn_local  # noqa: E402

try:            # the card's machine has no JAX: only the cuda tests run there
    import jax
    from repro import api as japi
    from repro.api import spec as jspec
    from test_torch_engine import assert_same_state, assert_same_trace
    from test_torch_engine import mirror_jax_federation
except ImportError:
    jax = None

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
JOB_TIMEOUT = 150                   # seconds, a spawn_local job
LYAPUNOV = {"kind": "lyapunov", "params": {"budget": 600, "horizon": 20}}
FIXED = {"kind": "fixed", "params": {"a": 3}}
DQN = {"kind": "dqn", "params": {"episodes": 1, "horizon": 5}}
K, E = 4, 3                         # scanned rounds, then event rounds
RTOL, ATOL = 1e-5, 1e-6             # the JAX package's sharded parity


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("the JAX package is not installed")


def spec_dict(controller=LYAPUNOV, mesh=(), impl="gspmd", **kw):
    d = dict(fleet={"n_devices": 16}, clustering={"n_clusters": 4},
             controller=controller, aggregator={"kind": "trust"},
             task={"kind": "mlp", "params": {"n_samples": 512, "dim": 24,
                                             "hidden": 16}},
             local_batch=8, seed=3, lr=0.1, sim_seconds=1e9,
             sharding={"mesh": list(mesh), "impl": impl if mesh else None})
    d.update(kw)
    return d


def rows(trace):
    return [[r.t, r.round, r.cluster, r.a, r.loss, r.energy, r.acc,
             r.agg_count] for r in trace.records]


def assert_sharded_parity(got, want):
    """cluster, a, round and agg_count exactly; t, loss and energy within
    rtol 1e-5, atol 1e-6; accuracy within 1e-5."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g[1], g[2], g[3], g[7]) == (w[1], w[2], w[3], w[7]), (g, w)
        np.testing.assert_allclose([g[0], g[4], g[5]], [w[0], w[4], w[5]],
                                   rtol=RTOL, atol=ATOL)
        assert (g[6] is None) == (w[6] is None)
        if w[6] is not None:
            assert abs(g[6] - w[6]) < 1e-5


def scanned_then_event(fed):
    return rows(fed.engine.run_scanned(K)), rows(
        fed.run(max_rounds=E, eval_every=0.0))


# ---------------------------------------------------------------------- #
# the G-rank jobs: one a mesh shape
# ---------------------------------------------------------------------- #
WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.launch.distributed import initialize_from_env
cfg = json.loads(sys.argv[1])
initialize_from_env(device="cpu")
from repro_torch import api as tapi
sys.path.insert(0, cfg["root"])
from chip_smoke import count_collectives  # the card's count, on the CPU
ta = __import__("importlib").import_module(
    "repro_torch.kernels.trust_aggregate")

# on the CPU a wrapper computes its kernel's plain version: count those
# calls, one a launch on the card
launches = {}


def counted(name, fn):
    def call(*args):
        key = name if name != "trust_aggregate" or args[2] is not None \
            else "trust_aggregate_dense"
        launches[key] = launches.get(key, 0) + 1
        return fn(*args)
    return call


ta.trust_aggregate_ref = counted("trust_aggregate", ta.trust_aggregate_ref)
ta.trust_aggregate_global_ref = counted("trust_aggregate_global",
                                        ta.trust_aggregate_global_ref)


def rows(tr):
    return [[r.t, r.round, r.cluster, r.a, r.loss, r.energy, r.acc,
             r.agg_count] for r in tr.records]


out = {"rank": dist.get_rank(), "runs": {}}
for name, d in cfg["specs"].items():
    fed = tapi.Federation.from_dict(d, device="cpu")
    eng = fed.engine
    run = {"engine": type(eng).__name__,
           "placements": {k: [repr(p) for p in v.placements]
                          for k, v in eng.state.tensors().items()},
           "pretrained": getattr(fed.controller, "pretrain_aux",
                                 None) is not None}
    agent = getattr(fed.controller, "agent", None)
    if agent is not None:
        run["net"] = {k: v.tolist() for k, v in
                      sorted(agent.eval_params.items())}
    launches.clear()
    with count_collectives() as cs:
        run["scanned"] = rows(eng.run_scanned(cfg["K"]))
    run["launches"] = dict(launches)
    run["collectives"] = cs
    if not cfg.get("scanned_only"):
        run["event"] = rows(fed.run(max_rounds=cfg["E"], eval_every=0.0))
    if name == cfg.get("ckpt"):
        # to the unsharded engine and on; then back to this one and on
        plain = tapi.Federation.from_dict(
            {**d, "sharding": {"mesh": []}}, device="cpu").engine
        plain.restore_resumable(eng.resumable_state(), rounds=eng.round,
                                energy=eng.energy_used)
        run["cont_sharded"] = rows(eng.run_scanned(3))
        run["cont_plain"] = rows(plain.run_scanned(3))
        eng.restore_resumable(plain.resumable_state(), rounds=plain.round,
                              energy=plain.energy_used)
        run["back_sharded"] = rows(eng.run_scanned(2))
        run["back_plain"] = rows(plain.run_scanned(2))
    out["runs"][name] = run
if cfg.get("cli"):
    import contextlib, io
    from repro_torch.api import run as trun
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["cli_rc"] = trun.main(cfg["cli"])
    out["cli_out"] = buf.getvalue()
print("RESULT" + json.dumps(out))
"""

CLI = ["--scenario", "faulty-fleet", "--rounds", "2", "--device", "cpu",
       "--devices", "8", "--clusters", "2"]
JOBS = {
    # 1-D: the device-gspmd scale (a 1-D mesh that would otherwise run the
    # cluster-major engine), impl='gspmd', the DQN and the DP path
    (2,): dict(specs={
        "fixed": spec_dict(FIXED, mesh=(2,), impl=None,
                           scale="device-gspmd"),
        "lyapunov": spec_dict(LYAPUNOV, mesh=(2,)),
        "dqn": spec_dict(DQN, mesh=(2,), seed=4),
        "dp": spec_dict(LYAPUNOV, mesh=(2,),
                        privacy={"clip": 1.0, "noise": 0.5})},
        ckpt="lyapunov", K=K, E=E),
    # 2-D ("cluster", "fleet"): the default impl of a multi-axis mesh
    (2, 2): dict(specs={
        "fixed": spec_dict(FIXED, mesh=(2, 2), impl=None),
        "lyapunov": spec_dict(LYAPUNOV, mesh=(2, 2)),
        "dqn": spec_dict(DQN, mesh=(2, 2), seed=4)},
        K=K, E=E, cli=CLI + ["--mesh", "2x2"]),
}


# F2: each rank's collectives in order over 3 scanned rounds of
# paper-mlp-fleet1k at mesh (2, 2), against the unsharded engine
SEQ_ROUNDS = 3
SEQ_WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.launch.distributed import initialize_from_env
initialize_from_env(device="cpu")
from repro_torch import api as tapi
from repro_torch.api import scenarios
from repro_torch.launch.op_stats import OpStats
K = int(sys.argv[1])
d = json.loads(json.dumps(scenarios.PAPER_MLP_FLEET1K))


def rows(tr):
    return [[r.t, r.round, r.cluster, r.a, r.loss, r.energy, r.acc,
             r.agg_count] for r in tr.records]


fed = tapi.Federation.from_dict(
    {**d, "sharding": {"mesh": [2, 2], "impl": "gspmd"}}, device="cpu")
stats = OpStats(record=True)
with stats:
    got = rows(fed.engine.run_scanned(K))
plain = rows(tapi.Federation.from_dict(d, device="cpu").engine.run_scanned(K))
print("RESULT" + json.dumps({
    "rank": dist.get_rank(), "rows": got, "plain": plain,
    "seq": [[k, list(g), list(sh), dt] for k, g, sh, dt in stats.sequence]}))
"""


def run_seq_job():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = spawn_local(["-c", SEQ_WORKER, str(SEQ_ROUNDS)], n_procs=4,
                      timeout=JOB_TIMEOUT, env=env)
    for o in out:
        assert o.returncode == 0, o.stderr[-4000:]
    return [json.loads(o.stdout.split("RESULT", 1)[1]) for o in out]


def run_job(mesh):
    cfg = dict(JOBS[mesh], root=os.path.dirname(SRC))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = spawn_local(["-c", WORKER, json.dumps(cfg)],
                      n_procs=int(np.prod(mesh)), timeout=JOB_TIMEOUT,
                      env=env)
    for o in out:
        assert o.returncode == 0, o.stderr[-4000:]
    return [json.loads(o.stdout.split("RESULT", 1)[1]) for o in out]


@pytest.fixture(scope="module", autouse=True)
def started_jobs():
    """The three jobs start with the module's first test (10 processes,
    each job within its own timeout) and run while the in-process tests
    do."""
    pool = concurrent.futures.ThreadPoolExecutor(3)
    futures = {m: pool.submit(run_job, m) for m in JOBS}
    futures["seq"] = pool.submit(run_seq_job)
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jobs(started_jobs):
    return {m: f.result() for m, f in started_jobs.items()}


def unsharded(d, **kw):
    return tapi.Federation.from_dict({**d, "sharding": {"mesh": []},
                                      "scale": "device"}, device="cpu", **kw)


# ---------------------------------------------------------------------- #
# in process: one-shard meshes, the JAX package's engine, the rules
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh,impl,scale", [
    ((1,), "gspmd", "device"), ((1, 1), None, "device"),
    ((1,), None, "device-gspmd")], ids=["1-gspmd", "1x1", "1-scale"])
@pytest.mark.parametrize("controller", [FIXED, LYAPUNOV],
                         ids=["fixed", "lyapunov"])
def test_one_shard_meshes_are_bit_for_bit_the_unsharded_engine(
        mesh, impl, scale, controller):
    d = spec_dict(controller, mesh=mesh, impl=impl, scale=scale)
    fed = tapi.Federation.from_dict(d, device="cpu")
    assert type(fed.engine).__name__ == (
        "DeviceScaleGspmdEngine" if scale == "device-gspmd"
        else "DeviceScaleEngine")
    assert fed.engine.placement.is_gspmd
    assert placement.is_dtensor(fed.engine.state.rep)
    got = scanned_then_event(fed)
    ref = unsharded(d)
    assert json.dumps(got) == json.dumps(scanned_then_event(ref))
    for name, t in fed.engine.state.tensors().items():
        assert torch.equal(placement.whole(t), ref.engine.state.tensors()[
            name]), name
    assert fed.engine.state.global_flat.placements == \
        fed.engine.placement.placements(None)


def test_one_shard_checkpoint_and_summaries():
    d = spec_dict(LYAPUNOV, mesh=(1, 1))
    fed = tapi.Federation.from_dict(d, device="cpu")
    ref = unsharded(d)
    fed.engine.run_scanned(3)
    ref.engine.run_scanned(3)
    assert fed.engine.obs_state_summary() == ref.engine.obs_state_summary()
    assert torch.equal(fed.engine.rep, ref.engine.rep)
    assert torch.equal(fed.engine.scan_times, ref.engine.scan_times)
    tree = fed.engine.resumable_state()
    assert not placement.is_dtensor(tree["fleet"].rep)
    again = tapi.Federation.from_dict(d, device="cpu").engine
    again.restore_resumable(tree, rounds=fed.engine.round,
                            energy=fed.engine.energy_used)
    assert placement.is_dtensor(again.state.rep)
    assert rows(again.run_scanned(2)) == rows(ref.engine.run_scanned(2))


@pytest.mark.parametrize("execution", ["event", "scanned"])
def test_mesh_one_matches_the_jax_gspmd_engine(needs_jax, execution):
    """Mesh (1,) gspmd against the JAX package's gspmd engine at mesh (1,)
    on its injected draws, at `tests/test_torch_engine.py`'s tolerances."""
    d = spec_dict(LYAPUNOV, mesh=(1,), execution=execution)
    jfed = japi.Federation.from_dict(d)
    assert jfed.engine.placement.is_sharded
    tfed = mirror_jax_federation(jfed, tapi.FederationSpec.from_dict(d))
    assert tfed.engine.placement.is_gspmd
    if execution == "event":
        jt = jfed.run(eval_every=0.0, max_rounds=5)
        tt = tfed.run(eval_every=0.0, max_rounds=5)
    else:
        jt = jfed.engine.run_scanned(5)
        tt = tfed.engine.run_scanned(5)
    assert_same_trace(jt, tt, 5 + (execution == "scanned"))
    assert_same_state(jfed.engine.state,
                      tfed.engine.placement.full_state(tfed.engine.state))


@pytest.mark.parametrize("backend,mesh,refused", [
    ("gloo", (2,), "segfault"), ("gloo", (2, 2), "segfault"),
    ("nccl", (2, 2), None), ("nccl", (4, 2), None),
    ("nccl", (2,), None), ("nccl", (1, 1), None)],
    ids=["gloo-2", "gloo-2x2", "nccl-2x2", "nccl-4x2", "nccl-2", "nccl-1x1"])
def test_placement_refuses_what_fails_on_cards(monkeypatch, backend, mesh,
                                               refused):
    """On cards, no fallback: gloo ranks sharing a card (DTensor's
    all-gather segfaults) raise a `RuntimeError` naming the card's limit
    and what runs instead;
    meshes over NCCL, 1-D and multi-axis (F2 repaired: the round's
    reductions and its event choice run on tensors the process groups
    gathered, `placement.gather`), and one-rank meshes build."""
    G = int(np.prod(mesh))
    monkeypatch.setattr(placement, "_process_group", lambda shape: "group")
    monkeypatch.setattr(placement, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(placement, "device_mesh", lambda *a: "mesh")
    monkeypatch.setattr(placement.dist, "get_world_size", lambda g=None: G)
    monkeypatch.setattr(placement.dist, "get_rank", lambda g=None: 0)
    monkeypatch.setattr(placement.dist, "get_backend", lambda g=None: backend)
    spec = tapi.ShardingSpec(mesh=mesh, impl="gspmd")
    if refused is None:
        pl = placement.resolve(spec, n_devices=16, n_clusters=4,
                               device="cuda")
        assert pl.is_gspmd and pl.world_size == G
        return
    with pytest.raises(RuntimeError, match=refused) as err:
        placement.resolve(spec, n_devices=16, n_clusters=4, device="cuda")
    assert "a limit of the card's torch" in str(err.value)
    assert "impl='shard_map'" in str(err.value)


def _gspmd_placement(mesh):
    return placement.resolve(tapi.ShardingSpec(mesh=mesh, impl="gspmd"),
                             n_devices=16, n_clusters=4, device="cpu")


@pytest.mark.parametrize("mesh", [(1,), (1, 1)], ids=["1", "1x1"])
def test_placements_are_the_jax_named_shardings(mesh):
    """Each leaf group's placements: ``Shard(0)`` on its axis,
    ``Replicate()`` on the others (1-D: the cluster group replicated; 2-D:
    it shards over "cluster", the device group over "fleet")."""
    from torch.distributed.tensor import Replicate, Shard
    pl = _gspmd_placement(mesh)
    assert pl.is_sharded and pl.is_gspmd
    assert pl.mesh.mesh_dim_names == pl.axes == (
        ("fleet",) if len(mesh) == 1 else ("cluster", "fleet"))
    st = unsharded(spec_dict()).engine.state
    placed = pl.shard_state(st)
    want = {"fleet": (Shard(0),), "cluster": (Replicate(),),
            None: (Replicate(),)}
    if len(mesh) == 2:
        want = {"fleet": (Replicate(), Shard(0)),
                "cluster": (Shard(0), Replicate()),
                None: (Replicate(), Replicate())}
    for name, t in placed.tensors().items():
        axis = pl.group_axis(name.split(".")[0])
        assert tuple(t.placements) == want[axis], name
    back = pl.full_state(pl.pin_state(placed))
    for name, t in back.tensors().items():
        assert torch.equal(t, st.tensors()[name]), name


def test_sharding_rules_launch_each_operator_on_local_tensors():
    """A DTensor call of the trust kernels and of the per-member products
    is one call of the operator on the local tensors, whose result is the
    replicated output; it equals the plain call bit for bit."""
    from repro_torch.core.member_ops import gram, row_sq_sum
    from repro_torch.kernels.trust_aggregate import (trust_aggregate,
                                                     trust_aggregate_global)
    pl = _gspmd_placement((1,))
    g = torch.Generator().manual_seed(0)
    x = torch.randn((6, 40), generator=g)
    w = torch.rand((6,), generator=g)
    m = (torch.rand((6,), generator=g) > 0.3).float()
    stack = torch.randn((4, 40), generator=g)
    gw = torch.rand((4,), generator=g)
    c = torch.tensor(2, dtype=torch.int32)
    d = pl.distribute
    for fn, args in ((trust_aggregate, (x, w, m)), (trust_aggregate, (x, w)),
                     (trust_aggregate_global, (x, w, m, stack, gw, c)),
                     (gram, (x,)), (row_sq_sum, (x,))):
        got = fn(*[d(a) for a in args])
        assert placement.is_dtensor(got)
        assert got.placements == pl.placements(None)
        assert torch.equal(got.to_local(), fn(*args)), fn


@pytest.mark.parametrize("d,match", [
    ({"sharding": {"mesh": [3], "impl": "gspmd"}}, "does not divide"),
    ({"scale": "device-gspmd", "sharding": {"mesh": [3]}},
     "does not divide"),
    ({"sharding": {"mesh": [2, 3]}}, "does not divide"),
    ({"sharding": {"mesh": [2, 2], "axes": ["a", "b"]}}, "not a mesh axis"),
    ({"sharding": {"mesh": [2, 2], "cluster_axis": "fleet"}},
     "distinct mesh axes")],
    ids=["gspmd-3", "scale-3", "2x3", "axes", "same-axis"])
def test_malformed_meshes_give_the_jax_messages(d, match):
    spec = {**spec_dict(), **d}
    with pytest.raises(ValueError, match=match) as got:
        tapi.Federation.from_dict(spec, device="cpu")
    if jax is None:
        return
    # the JAX package's engine resolves impl='gspmd' as the port's does
    with pytest.raises(ValueError) as want:
        japi.Federation.from_dict(spec)
    assert str(got.value) == str(want.value)

    def message(sharding):
        with pytest.raises(ValueError) as e:
            sharding.validate(16, 4)
        return str(e.value)
    kw = {**d["sharding"], "impl": "gspmd"}
    assert message(tapi.ShardingSpec(**kw)) == message(
        jspec.ShardingSpec(**kw))


# ---------------------------------------------------------------------- #
# the jobs against the unsharded engine
# ---------------------------------------------------------------------- #
CASES = [(m, name) for m in JOBS for name in JOBS[m]["specs"]]


@pytest.mark.parametrize("mesh,name", CASES,
                         ids=[f"{'x'.join(map(str, m))}-{n}"
                              for m, n in CASES])
def test_sharded_meshes_agree_with_the_unsharded_engine(jobs, mesh, name):
    res = jobs[mesh]
    d = JOBS[mesh]["specs"][name]
    runs = [r["runs"][name] for r in res]
    # every rank's records are byte-equal
    for key in ("scanned", "event"):
        assert all(json.dumps(r[key]) == json.dumps(runs[0][key])
                   for r in runs), key
    assert {r["engine"] for r in runs} == {
        "DeviceScaleGspmdEngine" if d.get("scale") == "device-gspmd"
        else "DeviceScaleEngine"}
    kw = {}
    if name == "dqn":
        # rank 0 alone pretrains; every rank deploys its net, which the
        # unsharded engine runs too
        assert [r["pretrained"] for r in runs] == [True] + [False] * (
            len(runs) - 1)
        assert all(r["net"] == runs[0]["net"] for r in runs)
        ctl = tapi.DQNController.pretrain(**DQN["params"], device="cpu")
        assert {k: v.tolist() for k, v in sorted(
            ctl.agent.eval_params.items())} == runs[0]["net"]
        kw["controller"] = ctl
    got = (runs[0]["scanned"], runs[0]["event"])
    want = scanned_then_event(unsharded(d, **kw))
    assert_sharded_parity(got[0], want[0])
    assert_sharded_parity(got[1], want[1])
    # one fused launch a round on every rank (the two-step path: one masked
    # Eqn 6 and one unmasked Eqn 19), as the unsharded engine launches
    for r in runs:
        if name == "dp":
            assert r["launches"].get("trust_aggregate") == K
            assert r["launches"].get("trust_aggregate_dense") == K
        else:
            assert r["launches"].get("trust_aggregate_global") == K
        # the membership gathers are all-gathers DTensor inferred
        assert r["collectives"]["all_gather"]["calls"] >= K


def test_a_checkpoint_moves_between_mesh_two_and_unsharded(jobs):
    for r in jobs[(2,)]:
        run = r["runs"]["lyapunov"]
        assert_sharded_parity(run["cont_sharded"], run["cont_plain"])
        assert_sharded_parity(run["back_sharded"], run["back_plain"])


def test_placements_on_the_ranks(jobs):
    """1-D: twins / rep / channel ``Shard(0)``, the rest replicated; 2-D:
    the device group ``(Replicate(), Shard(0))``, the cluster group
    ``(Shard(0), Replicate())``."""
    one = jobs[(2,)][0]["runs"]["lyapunov"]["placements"]
    two = jobs[(2, 2)][0]["runs"]["lyapunov"]["placements"]
    assert one["rep"] == one["twins.loss"] == ["Shard(dim=0)"]
    assert one["cluster_flat"] == one["global_flat"] == ["Replicate()"]
    assert two["channel"] == ["Replicate()", "Shard(dim=0)"]
    assert two["cluster_ts"] == ["Shard(dim=0)", "Replicate()"]
    assert two["queue"] == ["Replicate()", "Replicate()"]


def test_cli_runs_a_two_by_two_mesh_under_a_four_rank_launch(jobs):
    res = jobs[(2, 2)]
    assert [r["cli_rc"] for r in res] == [0] * 4
    assert "summary:" in res[0]["cli_out"]
    assert all(r["cli_out"] == "" for r in res[1:])


def test_the_service_refuses_a_sharded_spec_naming_its_item(tmp_path,
                                                            capsys):
    """The service no longer refuses sharded specs: a mesh of one shard
    runs in the process (a one-rank group), a larger mesh resolves for a
    job of ranks (run in ``tests/test_torch_service_sharded.py``); the
    ``device-gspmd`` scale on one device runs as the device scale."""
    import argparse

    from repro_torch.serve.__main__ import _ranks, _resolve_spec, main

    def start(d, name, *extra):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(d))
        return main(["start", "--run-dir", str(tmp_path / name),
                     "--spec-file", str(path), "--device", "cpu",
                     "--foreground", *extra])
    path = tmp_path / "two.json"
    path.write_text(json.dumps(spec_dict(mesh=(2,))))
    two = _resolve_spec(argparse.Namespace(spec_file=str(path), seed=None))
    assert two.sharding.is_sharded and _ranks(two) == 2
    assert start(spec_dict(mesh=(1, 1)), "one", "--segment-rounds", "2",
                 "--max-segments", "1") == 0
    assert "not ported" not in capsys.readouterr().err
    assert start(spec_dict(FIXED, scale="device-gspmd"), "scale",
                 "--segment-rounds", "2", "--max-segments", "1") == 0


def _rank_free(seq):
    """A rank's collectives with each group as its ranks' offsets from its
    first: the same axis gives the same entry on every rank."""
    return [(kind, tuple(r - min(group) for r in group) if group else (),
             tuple(shape), dtype) for kind, group, shape, dtype in seq]


def test_every_rank_runs_the_same_collectives_in_order(jobs):
    """F2: at mesh (2, 2) every rank issues the same collectives (kind,
    mesh axis, shape, type) in the same order over three rounds of
    ``paper-mlp-fleet1k``, none of them a reduction DTensor inferred (the
    next event's ``argmin``, the straggler minimum and Eqn 19 take whole
    tensors through the process groups' all-gathers, `placement.gather`),
    and the records hold to the unsharded engine as the (2, 2) meshes
    above do."""
    res = jobs["seq"]
    seqs = [_rank_free(r["seq"]) for r in res]
    assert seqs[0], "no collective recorded"
    for r, s in zip(res[1:], seqs[1:]):
        assert s == seqs[0], f"rank {r['rank']} departs from rank 0"
    assert {k for k, *_ in seqs[0]} == {"all_gather"}, seqs[0]
    for r in res:
        assert r["rows"] == res[0]["rows"]
    got, want = res[0]["rows"], res[0]["plain"]
    assert len(got) == len(want) == SEQ_ROUNDS + 1
    for g, w in zip(got, want):
        assert (g[1], g[2], g[3], g[7]) == (w[1], w[2], w[3], w[7]), (g, w)
        np.testing.assert_allclose([g[0], g[4], g[5]], [w[0], w[4], w[5]],
                                   rtol=RTOL, atol=ATOL)
