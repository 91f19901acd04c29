"""The port's cluster-major engine (`repro_torch.api.cluster_engine`).

The contract, the JAX package's (``tests/test_cluster_engine.py``):
re-indexing the fleet cluster-major and running a round over ranks
changes *where* tensors live and *how* the global average is summed,
never *what* the federation does.

* The slot tables and the padding are the JAX package's.
* One rank against the JAX `ClusterMajorEngine` on a one-device mesh, on
  the JAX package's draws: the schedule exactly, values within 1e-5.
* 2 and 3 ranks (one ``spawn_local`` job each, gloo on the CPU) against
  one rank: every rank's trace equal, the schedule exact, values within
  1e-5 (the Eqn-19 sums reassociate); exactly two all-reduces a scanned
  round and three an event round; checkpoints move between the 2-rank
  engine and the unsharded one in both directions; a population sharded
  over 2 ranks against the unsharded population.
"""
import concurrent.futures
import json
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)

from repro_torch import api as tapi  # noqa: E402
from repro_torch.api import registry  # noqa: E402
from repro_torch.api.cluster_engine import ClusterMajorEngine  # noqa: E402
from repro_torch.launch.distributed import spawn_local  # noqa: E402
from repro_torch.pop import PopulationEngine, PopulationSpec  # noqa: E402

try:            # the card's machine has no JAX: only the cuda tests run there
    import jax
    from repro import api as japi
    from test_torch_engine import (JaxDraws, assert_same_state,
                                   assert_same_trace)
except ImportError:
    jax = None

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
JOB_TIMEOUT = 180                   # seconds, a spawn_local job
# an uneven membership: clusters of 10, 5 and 5 devices (S = 10)
ASSIGN = [0, 1, 0, 2, 0, 1, 0, 2, 0, 1, 0, 2, 0, 1, 0, 2, 0, 1, 2, 0]
LYAPUNOV = {"kind": "lyapunov", "params": {"budget": 4000, "horizon": 30}}
FIXED = {"kind": "fixed", "params": {"a": 3}}


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("the JAX package is not installed")


def spec_dict(mesh=(), clusters=3, devices=20, controller=LYAPUNOV,
              execution="scanned", **kw):
    d = dict(fleet={"n_devices": devices},
             clustering={"n_clusters": clusters}, controller=controller,
             aggregator={"kind": "trust"},
             task={"kind": "mlp", "params": {"n_samples": 512, "dim": 24,
                                             "hidden": 16}},
             local_batch=16, seed=5, lr=0.1, execution=execution,
             sim_seconds=1e9, sharding={"mesh": list(mesh)})
    d.update(kw)
    return d


def rows(trace):
    return [[r.t, r.round, r.cluster, r.a, r.loss, r.energy, r.acc]
            for r in trace.records]


def assert_close_rows(got, want, rtol=1e-5):
    """Schedule (round, cluster, a) exactly; t, loss, energy and accuracy
    within ``rtol``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[1:4] == w[1:4], (g, w)
        assert (g[6] is None) == (w[6] is None)
        np.testing.assert_allclose(
            [g[0], g[4], g[5], g[6] or 0.0], [w[0], w[4], w[5], w[6] or 0.0],
            rtol=rtol, atol=1e-6)


# ---------------------------------------------------------------------- #
# the G-rank jobs
# ---------------------------------------------------------------------- #
WORKER = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.launch.distributed import initialize_from_env
cfg = json.loads(sys.argv[1])
initialize_from_env(device=cfg["device"])
from repro_torch import api as tapi
from repro_torch.kernels import launches, reset_launches

calls = []
_all_reduce = dist.all_reduce


def counted(t, *a, **k):
    calls.append(t.numel())
    return _all_reduce(t, *a, **k)


dist.all_reduce = counted
G = dist.get_world_size()


def rows(tr):
    return [[r.t, r.round, r.cluster, r.a, r.loss, r.energy, r.acc]
            for r in tr.records]


spec = tapi.FederationSpec.from_dict(cfg["spec"])
fed = tapi.Federation.from_spec(spec, device=cfg["device"],
                                assign=cfg.get("assign"))
eng = fed.engine
out = {"rank": dist.get_rank(), "oos": eng._oos.tolist(),
       "soo": eng._slot_of_orig.tolist(), "C_pad": eng._C_pad,
       "n_pad": eng._n_pad, "type": type(eng).__name__}
n0 = len(calls)
reset_launches()
out["scanned"] = rows(eng.run_scanned(cfg["K"]))
out["scanned_calls"] = len(calls) - n0
out["launches"] = dict(launches)
n0 = len(calls)
out["event"] = rows(fed.run(max_rounds=cfg["E"], eval_every=0.0))
out["event_calls"] = len(calls) - n0
if cfg.get("ckpt"):
    tree = eng.resumable_state()
    plain = tapi.Federation.from_spec(
        spec.replace(sharding=tapi.ShardingSpec()), device=cfg["device"],
        assign=cfg.get("assign")).engine
    plain.restore_resumable(tree, rounds=eng.round, energy=eng.energy_used)
    out["cont_sharded"] = rows(eng.run_scanned(3))
    out["cont_plain"] = rows(plain.run_scanned(3))
    back = plain.resumable_state()
    eng.restore_resumable(back, rounds=plain.round, energy=plain.energy_used)
    out["back_sharded"] = rows(eng.run_scanned(2))
    out["back_plain"] = rows(plain.run_scanned(2))
if cfg.get("dqn"):
    # the adaptive-scanned-sharded preset at mesh (G,): rank 0 alone
    # pretrains, its net reaches every rank by one broadcast at build;
    # then the unsharded engine under the same controller
    dspec = tapi.SCENARIOS.get("adaptive-scanned-sharded")().replace(
        sharding=tapi.ShardingSpec(mesh=(G,)),
        controller=tapi.ControllerSpec("dqn", cfg["dqn"]))
    dfed = tapi.Federation.from_spec(dspec, device=cfg["device"])
    out["dqn_pretrained"] = dfed.controller.pretrain_aux is not None
    out["dqn_scanned"] = rows(dfed.engine.run_scanned(cfg["K"]))
    out["dqn_event"] = rows(dfed.run(max_rounds=cfg["E"], eval_every=0.0))
    plain = tapi.Federation.from_spec(
        dspec.replace(sharding=tapi.ShardingSpec()), device=cfg["device"],
        controller=dfed.controller)
    out["dqn_plain_scanned"] = rows(plain.engine.run_scanned(cfg["K"]))
    out["dqn_plain_event"] = rows(plain.run(max_rounds=cfg["E"],
                                            eval_every=0.0))
if cfg.get("pop"):
    from repro_torch.pop import PopulationEngine, PopulationSpec
    ps = PopulationSpec.from_dict({"base": cfg["pop"], "replicates": 4,
                                   "sharding": {"mesh": [G]}})
    pop = PopulationEngine.from_population(ps, device=cfg["device"])
    out["pop"] = [rows(t) for t in pop.run_scanned(4)]
    out["pop_energy"] = [pop.member_energy(b) for b in range(pop.B)]
    out["pop_rounds"] = [pop.member_rounds(b) for b in range(pop.B)]
    out["pop_members"] = [pop._lo, pop._hi]
print("RESULT" + json.dumps(out))
"""

JOBS = {
    # C = 3 over 2 ranks: one sentinel cluster, uneven member slots
    # (`run_scanned` K rounds, then the event heap `run` for E)
    2: dict(spec=spec_dict(mesh=(2,), execution="event"), assign=ASSIGN,
            K=5, E=3, ckpt=True, pop=spec_dict(devices=12),
            dqn={"episodes": 1, "horizon": 10}),
    # C = 4 over 3 ranks: two sentinel clusters, k-means membership
    3: dict(spec=spec_dict(mesh=(3,), clusters=4, devices=16,
                           execution="event"), K=5, E=3),
}


def run_job(G, device="cpu"):
    cfg = dict(JOBS[G], device=device)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = spawn_local(["-c", WORKER, json.dumps(cfg)], n_procs=G,
                      timeout=JOB_TIMEOUT, env=env)
    for o in out:
        assert o.returncode == 0, o.stderr[-4000:]
    return [json.loads(o.stdout.split("RESULT", 1)[1]) for o in out]


@pytest.fixture(scope="module", autouse=True)
def started_jobs():
    """Both jobs start with the module's first test (5 processes, each job
    within its own timeout) and run while the in-process tests do."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    yield {G: pool.submit(run_job, G) for G in JOBS}
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jobs(started_jobs):
    return {G: f.result() for G, f in started_jobs.items()}


def one_rank(G):
    """The job's federation on one rank, in this process."""
    cfg = JOBS[G]
    spec = tapi.FederationSpec.from_dict({**cfg["spec"],
                                          "sharding": {"mesh": [1]}})
    fed = tapi.Federation.from_spec(spec, device="cpu",
                                    assign=cfg.get("assign"))
    assert isinstance(fed.engine, ClusterMajorEngine)
    return rows(fed.engine.run_scanned(cfg["K"])), rows(
        fed.run(max_rounds=cfg["E"], eval_every=0.0))


# ---------------------------------------------------------------------- #
# in process: routing, guards, tables and one rank against the JAX engine
# ---------------------------------------------------------------------- #
def test_mesh_routes_to_cluster_major_and_guards():
    spec = tapi.FederationSpec.from_dict(spec_dict(mesh=(1,)))
    assert isinstance(tapi.Federation.from_spec(spec, device="cpu").engine,
                      ClusterMajorEngine)
    plain = tapi.FederationSpec.from_dict(spec_dict())
    assert type(tapi.Federation.from_spec(plain, device="cpu").engine) is \
        tapi.DeviceScaleEngine
    kw = dict(controller=registry.CONTROLLERS.get("fixed")({"a": 3}),
              task=registry.TASKS.get("mlp")(spec.task.params),
              device="cpu")
    data, parts = tapi.default_device_data(spec)
    with pytest.raises(ValueError, match="supports_mask=False"):
        ClusterMajorEngine(spec, data, parts,
                           aggregator=registry.AGGREGATORS.get("krum")({}),
                           **kw)


def mirror_cluster_major(d, assign=None):
    """The JAX cluster-major engine of ``d`` (a one-device mesh) and the
    port's one-rank engine on its data, assignment and original-order
    state, with the JAX package's draws injected."""
    from repro.api import registry as jreg
    from repro.api.engine import DeviceScaleEngine as JEngine
    jspec = japi.FederationSpec.from_dict(d)
    je = JEngine.from_spec(
        jspec, controller=jreg.CONTROLLERS.get(jspec.controller.kind)(
            jspec.controller.params),
        aggregator=jreg.AGGREGATORS.get("trust")({}),
        task=jreg.TASKS.get("mlp")(jspec.task.params), assign=assign)
    fleet = jax.device_get(je.resumable_state()["fleet"]._replace(key=None))
    te = tapi.Federation.from_spec(
        tapi.FederationSpec.from_dict(d), device="cpu", data=je.data,
        parts=je.parts, assign=je.assign,
        state=tapi.fleet_state_from_numpy(fleet, "cpu")).engine
    assert isinstance(te, ClusterMajorEngine)
    te.draws = JaxDraws(je)
    return je, te


@pytest.mark.parametrize("controller,execution,assign", [
    (LYAPUNOV, "scanned", None), (FIXED, "event", ASSIGN)],
    ids=["lyapunov-scanned", "fixed-event-uneven"])
def test_one_rank_matches_jax_cluster_major(needs_jax, caplog, controller,
                                            execution, assign):
    """One rank against the JAX engine on a one-device mesh: the slot
    tables, C_pad and n_pad (the uneven membership of the JAX package's
    test pads 20 devices to 30 slots, and the padding is logged), then 5
    rounds on the JAX package's draws, the trace and the final state."""
    d = (spec_dict(mesh=(1,), controller=controller, execution=execution)
         if assign else spec_dict(mesh=(1,), clusters=4, devices=16,
                                  controller=controller,
                                  execution=execution))
    with caplog.at_level(logging.INFO, logger="repro_torch.cluster"):
        je, te = mirror_cluster_major(
            d, None if assign is None else np.array(assign, np.int32))
    np.testing.assert_array_equal(te._oos.numpy(), np.asarray(je._oos))
    np.testing.assert_array_equal(te._slot_of_orig.numpy(),
                                  np.asarray(je._slot_of_orig))
    assert (te._C_pad, te._n_pad, te._S) == (je._C_pad, je._n_pad, je._S)
    if assign is not None:
        assert any("cluster-major padding: 3 clusters -> 3 and 20 devices "
                   "-> 30 slots" in r.getMessage() for r in caplog.records)
    if execution == "scanned":
        jt, tt = je.run_scanned(5), te.run_scanned(5)
    else:
        jt = je.run(eval_every=0.0, max_rounds=5)
        tt = te.run(eval_every=0.0, max_rounds=5)
    assert_same_trace(jt, tt, 5 + (execution == "scanned"))
    assert_same_state(jax.device_get(je.resumable_state()["fleet"]),
                      te._gather())


@pytest.mark.parametrize("G", sorted(JOBS))
def test_ranks_agree_and_match_one_rank(jobs, G):
    res = jobs[G]
    assert [r["rank"] for r in res] == list(range(G))
    assert all(r["type"] == "ClusterMajorEngine" for r in res)
    for key in ("scanned", "event"):
        assert all(r[key] == res[0][key] for r in res), key
    scanned, event = one_rank(G)
    assert_close_rows(res[0]["scanned"], scanned)
    assert_close_rows(res[0]["event"], event)
    assert len({r[3] for r in scanned}) > 1         # the controller varied a


@pytest.mark.parametrize("G", sorted(JOBS))
def test_two_all_reduces_a_scanned_round_three_an_event_round(jobs, G):
    cfg = JOBS[G]
    for r in jobs[G]:
        assert r["scanned_calls"] == 2 * cfg["K"]
        assert r["event_calls"] == 3 * cfg["E"]
    # on the CPU the wrappers count no launch (plain versions)
    assert all(v == 0 for v in jobs[G][0]["launches"].values())


def test_dqn_policy_is_rank_zeros_on_every_rank(jobs):
    """The adaptive-scanned-sharded preset over 2 ranks with a DQN: rank 0
    alone pretrains, every rank runs rank 0's net (the ranks' traces are
    equal), and the schedule is the unsharded engine's under that net."""
    res = jobs[2]
    assert [r["dqn_pretrained"] for r in res] == [True, False]
    for key in ("dqn_scanned", "dqn_event"):
        assert all(r[key] == res[0][key] for r in res), key
        assert_close_rows(res[0][key], res[0][key.replace("dqn_",
                                                          "dqn_plain_")])
    assert len(res[0]["dqn_scanned"]) == JOBS[2]["K"] + 1


def test_padding_tables_over_ranks(jobs):
    """C = 3 over 2 ranks pads to 4 clusters of S = 10 slots; C = 4 over 3
    to 6; the slot tables are the membership's, sentinel-padded (the JAX
    package's, `test_one_rank_tables_and_padding_log_match_reference`)."""
    two, three = jobs[2][0], jobs[3][0]
    assert (two["C_pad"], two["n_pad"]) == (4, 40)
    assert three["C_pad"] == 6 and three["n_pad"] % 6 == 0
    oos = np.array(two["oos"])
    table = np.full((3, 10), 20)
    for c in range(3):
        ids = [i for i, a in enumerate(ASSIGN) if a == c]
        table[c, :len(ids)] = ids
    np.testing.assert_array_equal(oos[:30], table.reshape(-1))
    assert (oos[30:] == 20).all()
    soo = np.array(two["soo"])
    np.testing.assert_array_equal(oos[soo], np.arange(20))


def test_checkpoint_moves_between_two_ranks_and_unsharded(jobs):
    """A checkpoint of the 2-rank engine restores into the unsharded one,
    and the unsharded one's back into the 2-rank engine: each pair then
    runs the same rounds."""
    for r in jobs[2]:
        assert_close_rows(r["cont_sharded"], r["cont_plain"])
        assert_close_rows(r["back_sharded"], r["back_plain"])
        assert r["cont_plain"][0][1] == JOBS[2]["K"] + JOBS[2]["E"] + 1


def test_sharded_population_matches_unsharded(jobs):
    """B = 4 replicates over 2 ranks (members 0-1 and 2-3) against the
    unsharded population: the schedule exactly, values to 1e-6 relative
    (as tests/test_torch_pop.py holds a member; the ranks run with one
    thread and this process with several)."""
    res = jobs[2]
    assert [r["pop_members"] for r in res] == [[0, 2], [2, 4]]
    assert all(r["pop"] == res[0]["pop"] for r in res)
    pspec = PopulationSpec.from_dict({"base": JOBS[2]["pop"],
                                      "replicates": 4})
    pop = PopulationEngine.from_population(pspec, device="cpu")
    want = [rows(t) for t in pop.run_scanned(4)]
    for got, w in zip(res[0]["pop"], want):
        assert_close_rows(got, w, rtol=1e-6)
    np.testing.assert_allclose(res[0]["pop_energy"],
                               [pop.member_energy(b) for b in range(4)],
                               rtol=1e-6)
    assert res[0]["pop_rounds"] == [4] * 4


# ---------------------------------------------------------------------- #
# on the card: two gloo ranks sharing cuda:0
# ---------------------------------------------------------------------- #
@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    res = run_job(2, device="cuda")
    assert all(r["scanned"] == res[0]["scanned"] for r in res)
    cfg = JOBS[2]
    assert sum(r["launches"]["trust_aggregate"] for r in res) == cfg["K"]
    assert all(r["launches"]["trust_aggregate_dense"] == cfg["K"]
               and r["launches"]["trust_aggregate_global"] == 0
               for r in res)
    spec = tapi.FederationSpec.from_dict({**cfg["spec"], "sharding": {}})
    plain = tapi.Federation.from_spec(spec, assign=cfg["assign"]).engine
    assert_close_rows(res[0]["scanned"], rows(plain.run_scanned(cfg["K"])))
