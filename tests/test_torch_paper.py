"""The port's legacy entry point and the paper's evaluation against the JAX
package's.

- `legacy_spec` and the `paper_mnist` config give the JAX package's dicts
  and fields;
- the `AsyncFederation` shim equals the spec path inside the port bit for
  bit (the port's copy of ``tests/test_api.py``'s parity checks), and the
  JAX package's shim on its own injected draws (scheduling and counters
  exactly; times, losses and energies within 1e-5 relative, accuracies
  within 1e-5, as the engine parity tests hold them);
- the system checks of ``tests/test_system.py`` on the port's own
  randomness;
- ``python -m repro_torch.paper --quick`` and a tiny robustness grid on the
  CPU: well-formed rows, the JSON keys of ``BENCH_robustness.json``, and
  each population member equal to its sequential run within 1e-6
  relative, NaN in the same places.
"""
import dataclasses
import json
import math
import os
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)

import repro_torch.core as tcore  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import dqn as tdqn  # noqa: E402
from repro_torch.core.autoencoder import anomaly_auc  # noqa: E402
from repro_torch.core.member_ops import row_sq_sum  # noqa: E402
from repro_torch.core.privacy import clip_client_updates  # noqa: E402
from repro_torch.core.trust import (gradient_diversity,  # noqa: E402
                                    learning_quality)
from repro_torch.paper import common, robustness  # noqa: E402

try:            # the card's machine has no JAX: its tests skip there
    import jax
    import jax.numpy as jnp
    import repro.core as jcore
    from repro.api import legacy_spec as jax_legacy_spec
    from repro.configs import paper_mnist as jax_paper_mnist
    from repro.core.autoencoder import anomaly_auc as jax_anomaly_auc
    from repro.data import dirichlet_partition, make_classification
    from test_torch_engine import mirror_jax_federation
except ImportError:
    jax = None

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("the JAX package is not installed")


# --------------------------------------------------------------------- #
# legacy_spec and the paper's config, across packages
# --------------------------------------------------------------------- #
LEGACY_CONFIGS = {
    "defaults": {},
    "fixed_1": {"fixed_frequency": 1},
    "fixed_10": {"fixed_frequency": 10},
    **{agg: {"aggregator": agg} for agg in
       ("fedavg", "krum", "multi_krum", "median", "trimmed_mean")},
    "dp": {"dp_clip": 5.0, "dp_noise": 0.05},
    "no_calibration": {"calibrate_dt": False},
    "malicious": {"malicious_frac": 0.25, "seed": 7, "sim_seconds": 4.0},
}


@pytest.mark.parametrize("name", list(LEGACY_CONFIGS))
def test_legacy_spec_dicts_equal_the_jax_packages(needs_jax, name):
    kw = LEGACY_CONFIGS[name]
    got = tapi.legacy_spec(tcore.AsyncFLConfig(**kw)).to_dict()
    want = jax_legacy_spec(jcore.AsyncFLConfig(**kw)).to_dict()
    assert got == want
    assert tapi.FederationSpec.from_dict(want).to_dict() == want


def test_paper_mnist_config_equals_the_jax_packages(needs_jax):
    from repro_torch.configs import paper_mnist
    for attr in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(paper_mnist, attr)) == \
            dataclasses.asdict(getattr(jax_paper_mnist, attr))
    assert paper_mnist.DQN._asdict() == jax_paper_mnist.DQN._asdict()
    assert get_config("paper-mnist") is paper_mnist.CONFIG
    assert get_smoke_config("paper_mnist") is paper_mnist.SMOKE


# --------------------------------------------------------------------- #
# the shim against the spec path inside the port, bit for bit
# --------------------------------------------------------------------- #
def _port_data(n=1536, dim=48, devices=8, seed=0):
    return common.fed_setup(n_devices=devices, n=n, dim=dim, seed=seed,
                            device="cpu")


def _assert_same_lists(a, b):
    assert a.times == b.times
    assert a.accs == b.accs              # float equality: bit for bit
    assert a.losses == b.losses
    assert a.energies == b.energies
    assert a.agg_counts == b.agg_counts


def test_shim_equals_the_spec_path_bit_for_bit():
    data, parts = _port_data()
    cfg = tcore.AsyncFLConfig(n_devices=8, n_clusters=2, local_batch=32,
                              sim_seconds=5.0, seed=11)
    legacy = tcore.AsyncFederation(cfg, data, parts,
                                   device="cpu").run(eval_every=1.5)
    tr = tapi.Federation.from_spec(tapi.legacy_spec(cfg), data=data,
                                   parts=parts,
                                   device="cpu").run(eval_every=1.5)
    _assert_same_lists(legacy, tr)
    assert len(tr.records) > 2
    # the sync baseline: one cluster at a fixed a = 5
    sync = tcore.run_sync_baseline(cfg, data, parts, device="cpu")
    spec = tapi.legacy_spec(dataclasses.replace(cfg, n_clusters=1,
                                                fixed_frequency=5))
    _assert_same_lists(sync, tapi.Federation.from_spec(
        spec, data=data, parts=parts, device="cpu").run())


def test_shim_with_an_agent_equals_the_spec_path_bit_for_bit():
    data, parts = _port_data(seed=2)
    out = common.train_dqn_agent(episodes=1, horizon=10, seed=2,
                                 device="cpu")
    cfg = tcore.AsyncFLConfig(n_devices=8, n_clusters=2, local_batch=32,
                              sim_seconds=3.0, seed=2)
    shim = tcore.AsyncFederation(cfg, data, parts, agent=out["agent"],
                                 dqn_cfg=out["dcfg"], device="cpu")
    assert isinstance(shim.controller, tapi.DQNController)
    legacy = shim.run(eval_every=1.0)
    tr = tapi.Federation.from_spec(
        tapi.legacy_spec(cfg), data=data, parts=parts, device="cpu",
        controller=tapi.DQNController(out["agent"], out["dcfg"])).run(
            eval_every=1.0)
    _assert_same_lists(legacy, tr)


def test_shim_exposes_engine_state():
    data, parts = _port_data(seed=5)
    cfg = tcore.AsyncFLConfig(n_devices=8, n_clusters=2, local_batch=32,
                              sim_seconds=2.0, malicious_frac=0.25, seed=5)
    fed = tcore.AsyncFederation(cfg, data, parts, device="cpu")
    fed.run(eval_every=1.0)
    assert fed.agg_count > 0 and fed.energy_used > 0
    assert fed.rep.shape == (8,) and fed.malicious.sum() == 2
    assert fed.agg_count == fed.round
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.AsyncFederation(cfg, data, parts)   # the card by default


# --------------------------------------------------------------------- #
# the shim against the JAX package's shim on its injected draws
# --------------------------------------------------------------------- #
def _jax_agent():
    """A JAX agent whose greedy head varies with the observation (its
    initial weights, the output layer scaled up), and the port's agent
    with the same network parameters."""
    jcfg = jcore.DQNConfig(buffer_size=64, batch_size=8)
    jag = jcore.init_dqn(jax.random.PRNGKey(0), jcfg)
    params = dict(jag.eval_params)
    last = sorted(k for k in params if k.startswith("w"))[-1]
    params[last] = params[last] * 50.0
    jag = jag._replace(eval_params=params)
    tcfg = tdqn.DQNConfig(buffer_size=64, batch_size=8)
    tag = tdqn.init_dqn(torch.Generator().manual_seed(0), tcfg)
    tag = tag._replace(eval_params=tdqn.dqn_params_from_numpy(
        jax.device_get(jag.eval_params)))
    return jag, jcfg, tag, tcfg


@pytest.mark.parametrize("scheme", ["dqn", "fixed", "sync"])
def test_shim_matches_the_jax_shim_on_injected_draws(needs_jax, scheme):
    key = jax.random.PRNGKey(3)
    jdata = make_classification(key, n=768, dim=32)
    jparts = dirichlet_partition(key, jdata.y, 6)
    cfg_kw = dict(n_devices=6, n_clusters=2, local_batch=16,
                  sim_seconds=4.0, malicious_frac=0.2, seed=3)
    if scheme == "fixed":
        cfg_kw["fixed_frequency"] = 3
    if scheme == "sync":           # run_sync_baseline's configuration
        cfg_kw.update(n_clusters=1, fixed_frequency=5, sim_seconds=12.0)
    agent = {}
    if scheme == "dqn":
        jag, jcfg, tag, tcfg = _jax_agent()
        agent = dict(j=dict(agent=jag, dqn_cfg=jcfg),
                     t=dict(agent=tag, dqn_cfg=tcfg))
    jshim = jcore.AsyncFederation(jcore.AsyncFLConfig(**cfg_kw), jdata,
                                  jparts, **agent.get("j", {}))
    tshim = tcore.AsyncFederation(tcore.AsyncFLConfig(**cfg_kw),
                                  jdata, jparts,
                                  device="cpu", **agent.get("t", {}))
    assert type(tshim.controller).__name__ == \
        type(jshim._fed.controller).__name__
    # the shim's own spec and controller, on the JAX engine's data, state
    # and draws
    tshim._fed = mirror_jax_federation(jshim._fed, tshim._fed.spec,
                                       controller=tshim._fed.controller)
    jt, tt = jshim.run(eval_every=0.5), tshim.run(eval_every=0.5)
    assert len(tt.times) == len(jt.times) > 3
    if scheme == "dqn":            # the agent's choice varied
        assert len({r.a for r in tt.records}) > 1
    assert tt.agg_counts == jt.agg_counts
    np.testing.assert_allclose(tt.times, jt.times, rtol=1e-5)
    np.testing.assert_allclose(tt.losses, jt.losses, rtol=1e-5)
    np.testing.assert_allclose(tt.energies, jt.energies, rtol=1e-5)
    np.testing.assert_allclose(tt.accs, jt.accs, rtol=0, atol=1e-5)
    assert tshim.agg_count == jshim.agg_count
    assert (tshim.malicious == np.asarray(jshim.malicious)).all()
    np.testing.assert_allclose(tshim.rep.numpy(), np.asarray(jshim.rep),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tshim.energy_used, jshim.energy_used,
                               rtol=1e-5)
    if scheme == "sync":
        _assert_same_lists(
            jcore.run_sync_baseline(dataclasses.replace(
                jcore.AsyncFLConfig(**cfg_kw), n_clusters=4,
                fixed_frequency=None), jdata, jparts), jt)


# --------------------------------------------------------------------- #
# tests/test_system.py's checks on the port's own randomness
# --------------------------------------------------------------------- #
def test_dqn_td_loss_falls_over_training():
    """The robust convergence criterion of the paper's Fig 2: the TD
    loss, early against late."""
    tds = common.train_dqn_agent(episodes=6, horizon=25, seed=0,
                                 device="cpu")["td_losses"]
    assert len(tds) == 150
    k = max(1, len(tds) // 10)
    assert np.mean(tds[-k:]) < np.mean(tds[:k])


def test_full_pipeline_end_to_end():
    data, parts = _port_data(n=1536, dim=48, devices=8, seed=0)
    out = common.train_dqn_agent(episodes=2, horizon=15, device="cpu")
    cfg = tcore.AsyncFLConfig(n_devices=8, n_clusters=2, local_batch=32,
                              sim_seconds=8.0)
    fed = tcore.AsyncFederation(cfg, data, parts, agent=out["agent"],
                                dqn_cfg=out["dcfg"], device="cpu")
    tr = fed.run(eval_every=2.0)
    assert tr.accs[-1] > 0.45
    assert fed.agg_count > 0
    assert fed.energy_used > 0


def test_adaptive_matches_or_beats_fixed_frequency():
    data, parts = _port_data(n=1024, dim=48, devices=6, seed=1)
    base = tcore.AsyncFLConfig(n_devices=6, n_clusters=2, local_batch=32,
                               sim_seconds=6.0, p_good=0.3)
    out = common.train_dqn_agent(episodes=2, horizon=15, p_good=0.3,
                                 device="cpu")
    tr_a = tcore.AsyncFederation(base, data, parts, agent=out["agent"],
                                 dqn_cfg=out["dcfg"],
                                 device="cpu").run(eval_every=3.0)
    tr_f = tcore.AsyncFederation(
        dataclasses.replace(base, fixed_frequency=1), data, parts,
        device="cpu").run(eval_every=3.0)
    assert tr_a.accs[-1] >= tr_f.accs[-1] - 0.15


def test_train_dqn_agent_record_matches_its_episodes():
    out = common.train_dqn_agent(episodes=3, horizon=8, seed=4,
                                 device="cpu")
    assert out["agg_counts"] == [8, 8, 8]
    assert len(out["td_losses"]) == 24 and len(out["rewards"]) == 3
    assert all(e > 0 for e in out["energies"])
    # a budget that ends every episode early: the record stops there
    tight = common.train_on_env(
        tdqn.init_dqn(torch.Generator().manual_seed(0), out["dcfg"]),
        out["dcfg"], out["params"]._replace(budget=1e-6), episodes=2,
        seed=1)[1]
    assert tight["ep_len"].tolist() == [1, 1]
    assert (tight["td_loss"][:, 1:] == 0).all()
    assert (tight["consumed"][:, 0] > 0).all()


# --------------------------------------------------------------------- #
# the figures and the grid at a tiny size
# --------------------------------------------------------------------- #
def test_paper_quick_prints_well_formed_rows(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["repro_torch.paper", "--quick",
                                      "--device", "cpu"])
    with pytest.raises(SystemExit) as done:
        runpy.run_module("repro_torch.paper", run_name="__main__")
    assert done.value.code == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "benchmark,metric,value"
    rows = [line.split(",") for line in lines[1:]]
    assert all(len(r) == 3 for r in rows), rows
    got = {(r[0], r[1]): float(r[2]) for r in rows}
    assert {("fig2", "td_loss_early"), ("fig2", "td_loss_late"),
            ("fig2", "converged"), ("fig2", "seconds"),
            ("fig3", "acc_calibrated"), ("fig3", "acc_with_deviation"),
            ("fig3", "seconds")} == set(got)
    assert all(math.isfinite(v) for v in got.values())


def _tiny_specs():
    specs = robustness._specs(fast=True)
    mlp = specs["mlp"].replace(
        fleet=dataclasses.replace(specs["mlp"].fleet, n_devices=8),
        task=tapi.TaskSpec("mlp", {"n_samples": 512, "dim": 16,
                                   "hidden": 16}),
        rounds=4, local_batch=16)
    ae = specs["autoencoder-anomaly"]
    ae = ae.replace(
        fleet=dataclasses.replace(ae.fleet, n_devices=8), rounds=4,
        task=tapi.TaskSpec("autoencoder-anomaly", {
            **ae.task.params, "n_samples": 512, "dim": 16, "hidden": 16}))
    return {"mlp": mlp, "autoencoder-anomaly": ae}


def test_tiny_robustness_grid_has_the_bench_layout(tmp_path, monkeypatch):
    tiny = _tiny_specs()
    monkeypatch.setattr(robustness, "_specs", lambda fast: tiny)
    out_path = tmp_path / "grid.json"
    out = robustness.run(out_path=str(out_path), device="cpu")
    with open(out_path) as f:
        assert json.load(f) == json.loads(json.dumps(out))
    with open(os.path.join(ROOT, "BENCH_robustness.json")) as f:
        bench = json.load(f)
    assert set(out) == set(bench)
    assert len(out["grid"]) == len(bench["grid"]) == 16
    for key in ("grid", "recovery"):
        for got, want in zip(out[key], bench[key]):
            assert set(got) == set(want)
            assert (got["workload"], got["fault"]) == \
                (want["workload"], want["fault"])
    assert set(bench["timing"][0]) <= set(out["timing"][0])
    assert [(r["workload"], r["fault"]) for r in out["recovery"]] == \
        [(r["workload"], r["fault"]) for r in bench["recovery"]]


def test_population_members_equal_their_sequential_runs():
    """The grid's trust/fedavg population against the two standalone
    runs: every record within 1e-6 relative (here bit for bit: the Eqn-4
    Gram product runs per member under vmap), NaN in the same places."""
    from repro_torch.pop import PopulationEngine
    base = _tiny_specs()["mlp"]
    members = robustness.cell_specs(base, robustness.FAULTS["mlp"]
                                    ["sign_flip"])
    traces = PopulationEngine(members, device="cpu").run_scanned(6)
    for tr, spec in zip(traces, members):
        ref = tapi.Federation.from_spec(spec, device="cpu").run_scanned(6)
        assert robustness.same_run(tr, ref)
        assert [r.loss for r in tr.records] == [r.loss for r in ref.records]
    assert robustness._close(float("nan"), float("nan"))
    assert not robustness._close(float("nan"), 1.0)
    assert robustness._close(1.0, 1.0 + 5e-7)
    assert not robustness._close(1.0, 1.0 + 2e-6)


MEMBER_FNS = {
    "gradient_diversity": lambda x, m: gradient_diversity(x, m),
    "learning_quality": lambda x, m: learning_quality(x, m),
    "dp_clip": lambda x, m: clip_client_updates(x, 1.0),
    "leaf_row_sq_sum": lambda x, m: row_sq_sum(x[:, 5:-7]),
}


def _members_bit_for_bit(name, M, N, device):
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((3, M, N), generator=g, device=device)
    mask = torch.ones((3, M), dtype=torch.bool, device=device)
    mask[1, -3:] = False
    fn = MEMBER_FNS[name]
    got = torch.func.vmap(fn)(x, mask)
    for b in range(3):
        assert torch.equal(got[b], fn(x[b], mask[b])), (name, b)


@pytest.mark.parametrize("name", list(MEMBER_FNS))
def test_member_reductions_under_vmap_are_each_members_bit_for_bit(name):
    """The round's row reductions over N and the Eqn-4 Gram product
    (`repro_torch.core.member_ops`) run each member's slice on its own
    under vmap, so a population member computes its standalone run's
    bits."""
    _members_bit_for_bit(name, 9, 4000, "cpu")


@pytest.mark.cuda
def test_member_reductions_under_vmap_on_the_card():
    """On the card a batched row sum or GEMM may split its work otherwise
    than the member's own; the per-member operators may not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    for name in MEMBER_FNS:
        _members_bit_for_bit(name, 9, 159010, "cuda")


def test_anomaly_auc_of_nan_scores_matches_the_jax_package(needs_jax):
    """A diverged autoencoder scores NaN: the AUC ranks NaN last and tied,
    as the JAX package's sort and search do (all NaN: 0.5), where it used
    to index past the end."""
    g = np.random.default_rng(0)
    for case in range(5):
        s = g.standard_normal(64).astype(np.float32)
        y = (g.random(64) < 0.3).astype(np.int32)
        if case == 1:
            s[:] = np.nan
        elif case == 2:
            s[g.random(64) < 0.3] = np.nan
        elif case == 3:
            s[3], s[10:14], s[20] = np.nan, np.inf, -np.inf
        elif case == 4:
            s[:], s[5] = np.inf, np.nan
        want = float(jax_anomaly_auc(jnp.asarray(s), jnp.asarray(y)))
        got = float(anomaly_auc(torch.from_numpy(s), torch.from_numpy(y)))
        assert abs(got - want) < 1e-6, (case, got, want)
