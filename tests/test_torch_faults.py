"""The port's fault model against the JAX package's, the engine's fault
gates round by round, and the scenario CLI.

`repro_torch.faults.FaultModel` gets the JAX fault model's own per-member
uniforms and normals (drawn from its keys, flattened in the port's
sorted-leaf layout): its Byzantine subsets must be bitwise the
reference's, its transformations equal within 1e-6.  The engine runs each
fault family alone, all together and under total dropout on the JAX
package's injected draws (`test_torch_engine.JaxDraws`): scheduling and
counters exactly, the state within 1e-5.  An inert `FaultSpec` gives a
round bitwise equal to the fault-free one and draws nothing new.  The CLI
runs every runnable preset for a few rounds on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)

from repro_torch import api as tapi  # noqa: E402
from repro_torch import rng as trng  # noqa: E402
from repro_torch.api import run as trun  # noqa: E402
from repro_torch.core.twin import TwinState  # noqa: E402
from repro_torch.faults import FaultModel, FaultSpec  # noqa: E402

from test_torch_engine import (FIXED, LYAPUNOV, assert_same_state,  # noqa: E402,F401,E501
                               assert_same_trace, build_pair, jax,
                               needs_jax, run_pair, spec_dict)

if jax is not None:
    import jax.numpy as jnp
    from repro.core.twin import TwinState as JTwinState
    from repro.faults import FaultSpec as JFaultSpec
    from repro.faults import model as jmodel

N_DEV = 12
ATOL = 1e-6
ALL_ON = dict(dropout=0.3, straggler_frac=0.3, twin_spike_prob=0.4,
              corrupt_mode="sign_flip", corrupt_frac=0.25, poison_frac=0.25,
              seed=3)


def pair(**kw):
    spec = dict(ALL_ON, **kw)
    return (FaultModel(FaultSpec(**spec), N_DEV, feat=6),
            jmodel.FaultModel(JFaultSpec(**spec), N_DEV))


def members_mask():
    """A padded member row: 5 devices and 2 sentinel slots."""
    m = np.array([7, 0, 11, 3, 5, N_DEV, N_DEV], np.int32)
    return m, m < N_DEV


def uniforms(jfm, tag, m, key):
    return jmodel._member_uniform(jfm._key(key, tag), jnp.asarray(m))


def test_byzantine_subsets_are_bitwise_the_references(needs_jax):
    for frac in (0.0, 0.1, 0.25, 0.5, 1.0):
        for seed in (0, 3, 11):
            t, j = pair(corrupt_frac=frac, poison_frac=frac, seed=seed)
            np.testing.assert_array_equal(t.corrupt_dev.numpy(),
                                          np.asarray(j.corrupt_dev))
            np.testing.assert_array_equal(t.poison_dev.numpy(),
                                          np.asarray(j.poison_dev))
            assert t.stats() == j.stats()
    t, j = pair(corrupt_mode="none")
    assert not t.may_corrupt and not j.may_corrupt
    assert t.corrupt_dev.sum() == 0
    t = FaultModel(FaultSpec(), N_DEV)
    assert not t.active and t.patterns is None


def test_drop_straggle_spike_match_jax(needs_jax):
    t, j = pair()
    m, mask = members_mask()
    jm, jmask = jnp.asarray(m), jnp.asarray(mask)
    key = jax.random.PRNGKey(4)
    tmask = torch.from_numpy(mask)
    for tag, name in ((jmodel._TAG_DROP, "drop"),
                      (jmodel._TAG_STRAGGLE, "straggle"),
                      (jmodel._TAG_SPIKE, "spike")):
        u = torch.from_numpy(np.array(uniforms(j, tag, m, key)))
        if name == "drop":
            np.testing.assert_array_equal(
                t.drop_mask(u, tmask).numpy(),
                np.asarray(j.drop_mask(key, jmask, jm)))
        elif name == "straggle":
            for dur in (1.5, 3.0):
                got = t.straggle(u, torch.tensor(dur), tmask)
                want = j.straggle(key, jnp.float32(dur), jmask, jm)
                assert float(got) == float(want)
        else:
            g = np.random.default_rng(1)
            fields = {f.name: g.random(len(m)).astype(np.float32)
                      for f in dataclasses.fields(TwinState)}
            got = t.spike_twins(u, TwinState(**{
                k: torch.from_numpy(v) for k, v in fields.items()}), tmask)
            want = j.spike_twins(key, JTwinState(**{
                k: jnp.asarray(v) for k, v in fields.items()}), jmask, jm)
            for f in fields:
                np.testing.assert_array_equal(getattr(got, f).numpy(),
                                              np.asarray(getattr(want, f)))


@pytest.mark.parametrize("mode", ["sign_flip", "gaussian", "scaled_norm"])
def test_corrupt_updates_match_jax_per_leaf(needs_jax, mode):
    """Gaussian noise is scaled per leaf in the JAX package: the port
    splits its flat rows at the leaf boundaries."""
    t, j = pair(corrupt_mode=mode, corrupt_frac=0.5, corrupt_scale=2.5)
    m, _ = members_mask()
    g = np.random.default_rng(5)
    shapes = {"b": (4,), "w": (3, 4)}
    stacked = {k: np.broadcast_to(g.standard_normal(sh), (len(m),) + sh)
               .astype(np.float32) for k, sh in shapes.items()}
    new = {k: (v + 0.1 * g.standard_normal(v.shape)).astype(np.float32)
           for k, v in stacked.items()}
    key = jax.random.PRNGKey(8)
    want = j.corrupt_updates(key, {k: jnp.asarray(v) for k, v in new.items()},
                             {k: jnp.asarray(v) for k, v in stacked.items()},
                             jnp.asarray(m))
    kc = j._key(key, jmodel._TAG_CORRUPT)
    normal = np.concatenate([np.asarray(jax.vmap(
        lambda mm, i=i, sh=sh: jax.random.normal(
            jax.random.fold_in(jax.random.fold_in(kc, i), mm), sh))(
                jnp.asarray(m))).reshape(len(m), -1)
        for i, sh in enumerate(shapes[k] for k in sorted(shapes))], 1)
    flat = lambda tr: torch.from_numpy(np.concatenate(
        [np.asarray(tr[k]).reshape(len(m), -1) for k in sorted(tr)], 1))
    segments = [(0, 4), (4, 12)]
    got = t.corrupt_updates(flat(new), flat(stacked), torch.from_numpy(m)
                            .to(torch.int64), segments,
                            torch.from_numpy(normal))
    np.testing.assert_allclose(got.numpy(), flat(want).numpy(), atol=ATOL)
    # honest members and padding keep stacked + (new - stacked), bit for bit
    honest = t.corrupt_dev[m.clip(0, N_DEV - 1)].numpy() * (m < N_DEV) == 0
    assert honest.any() and not honest.all()
    kept = flat(stacked) + (flat(new) - flat(stacked))
    np.testing.assert_array_equal(got.numpy()[honest], kept.numpy()[honest])


def test_poison_inputs_match_jax_on_its_patterns(needs_jax):
    t, j = pair(poison_frac=0.5, poison_scale=2.0)
    m, _ = members_mask()
    x = np.random.default_rng(6).standard_normal((len(m), 3, 6)).astype(
        np.float32)
    t.patterns = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(j._seed * 2654435761 % (2 ** 31)),
        (N_DEV + 1, 6), jnp.float32)))
    got = t.poison_inputs(torch.from_numpy(x), torch.from_numpy(m).long())
    want = j.poison_inputs(jax.random.PRNGKey(0), jnp.asarray(x),
                           jnp.asarray(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_fault_draws_are_keyed_by_device_id_and_fault_seed():
    """A device's fault uniform does not depend on its slot or the row's
    width, and the fault seed changes every fault draw."""
    s0, s1 = trng.fault_seed(0, 0), trng.fault_seed(0, 1)
    assert s0 != s1
    row = torch.tensor([5, 2, 9, 16])
    u = trng.uniform(s0, 3, trng.DROP, row, 0)
    assert torch.equal(trng.uniform(s0, 3, trng.DROP, torch.tensor([9, 5]),
                                    0), u[[2, 0]])
    assert not torch.equal(trng.uniform(s1, 3, trng.DROP, row, 0), u)
    assert not torch.equal(trng.uniform(s0, 3, trng.SPIKE, row, 0), u)
    z = trng.normals(s0, 3, trng.CORRUPT, row, 1000)
    assert z.shape == (4, 1000)
    assert torch.equal(trng.normals(s0, 3, trng.CORRUPT, row[2:3], 1000),
                       z[2:3])
    assert abs(float(z.mean())) < 0.1 and abs(float(z.std()) - 1) < 0.1


# ------------------------------------------------------------- the engine
FAMILIES = {
    "dropout": {"dropout": 0.3},
    "straggler": {"straggler_frac": 0.3, "straggler_factor": 3.0},
    "spike": {"twin_spike_prob": 0.4},
    "corrupt-gaussian": {"corrupt_mode": "gaussian", "corrupt_frac": 0.3},
    "poison": {"poison_frac": 0.3},
    "all": dict(ALL_ON, corrupt_mode="scaled_norm"),
}


@pytest.mark.parametrize("family,execution", [
    ("dropout", "event"), ("straggler", "scanned"), ("spike", "event"),
    ("corrupt-gaussian", "scanned"), ("poison", "event"),
    ("all", "event")], ids=lambda v: v)
def test_fault_families_round_by_round_parity(needs_jax, family,
                                              execution):
    d = spec_dict(LYAPUNOV if execution == "scanned" else FIXED,
                  execution=execution)
    d["faults"] = FAMILIES[family]
    run_pair(d, execution)


def test_all_faults_under_the_median_scanned(needs_jax):
    d = spec_dict(LYAPUNOV, execution="scanned",
                  aggregator={"kind": "median"})
    d["faults"] = ALL_ON
    run_pair(d, "scanned")


def test_total_dropout_reverts_every_round(needs_jax):
    """Every member drops: each round spends nothing and leaves the
    models, trust and twins as they were; the round counter and the
    channel advance."""
    d = spec_dict(FIXED)
    d["faults"] = {"dropout": 1.0}
    jfed, tfed = build_pair(d)
    before = tfed.engine.state.tensors()
    jt = jfed.run(eval_every=0.0, max_rounds=6)
    tt = tfed.run(eval_every=0.0, max_rounds=6)
    assert_same_trace(jt, tt, 6)
    assert_same_state(jfed.engine.state, tfed.engine.state)
    after = tfed.engine.state.tensors()
    assert int(after["round"]) == 6
    assert all(r.energy == 0.0 for r in tt.records)
    for k, v in before.items():
        if k not in ("round", "channel"):
            assert torch.equal(v, after[k]), k


def test_inert_fault_spec_gives_todays_round_bitwise(monkeypatch):
    """An inert spec (any seed, any scale) runs the fault-free round: the
    same bits on both entry points, no fault stream drawn, no fault field
    in the draws."""
    streams = []
    uniform = trng.uniform

    def spy(seed, round_, stream, dev, index):
        streams.append(stream)
        return uniform(seed, round_, stream, dev, index)

    monkeypatch.setattr(trng, "uniform", spy)
    base = tapi.Federation.from_dict(spec_dict(LYAPUNOV), device="cpu")
    d = spec_dict(LYAPUNOV)
    d["faults"] = {"seed": 7, "straggler_factor": 2.0, "corrupt_frac": 0.5,
                   "corrupt_mode": "none", "poison_scale": 9.0}
    inert = tapi.Federation.from_dict(d, device="cpu")
    assert not inert.engine.faults.active
    drawn = inert.engine.draws(inert.engine.state,
                               inert.engine._member_table[0])
    assert all(getattr(drawn, f) is None for f in
               ("dp_normal", "drop_u", "straggle_u", "spike_u",
                "corrupt_normal"))
    for fed in (base, inert):
        fed.records = (fed.run(max_rounds=4).records
                       + fed.run_scanned(4).records)
    assert [dataclasses.asdict(r) for r in base.records] == \
        [dataclasses.asdict(r) for r in inert.records]
    for k, v in base.engine.state.tensors().items():
        assert torch.equal(v, inert.engine.state.tensors()[k]), k
    assert set(streams) <= {trng.BATCH, trng.NOISE, trng.CHANNEL}


def test_fault_seed_changes_the_realised_faults():
    runs = []
    for seed in (0, 1):
        d = spec_dict(FIXED)
        d["faults"] = {"dropout": 0.5, "seed": seed}
        runs.append(tapi.Federation.from_dict(d, device="cpu")
                    .run(max_rounds=6).records)
    assert [r.energy for r in runs[0]] != [r.energy for r in runs[1]]


# ------------------------------------------------------------------ CLI
RUNNABLE = ["sync-baseline", "byzantine", "faulty-fleet", "dp",
            "heterogeneous", "adaptive", "adaptive-scanned",
            "autoencoder-anomaly"]


def test_presets_are_the_references(needs_jax):
    from repro.api import SCENARIOS as JSCENARIOS
    assert tapi.SCENARIOS.names() == JSCENARIOS.names()
    for name in tapi.SCENARIOS.names():
        assert tapi.SCENARIOS.get(name)().to_dict() == \
            JSCENARIOS.get(name)().to_dict(), name


@pytest.mark.parametrize("scenario", RUNNABLE)
def test_cli_runs_each_runnable_preset(scenario, capsys):
    rc = trun.main(["--scenario", scenario, "--device", "cpu", "--rounds",
                    "2", "--sim-seconds", "1", "--devices", "8",
                    "--eval-every", "1"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert f"scenario={scenario}" in out and "summary:" in out


@pytest.mark.parametrize("argv,item", [
    # a 1-D mesh runs under a launch of as many ranks since the
    # multi-device slice (tests/test_torch_placement.py), a multi-axis mesh
    # since the partitioner-inferred placement was ported
    # (tests/test_torch_gspmd.py): one that does not divide the clusters
    # exits 2 with the JAX package's message, one outside a launch with
    # the placement's
    (["--scenario", "adaptive-scanned-sharded", "--mesh", "8x1"],
     "does not divide"),
    # lm-modeA runs since the LM training slice; a datacenter spec with a
    # robust rule exits 2 with the JAX package's message
    (["--scenario", "lm-modeA", "--aggregator", "krum"],
     "not supported at datacenter scale"),
    (["--scenario", "dp", "--mesh", "4x2"], "spawn_local"),
    (["--scenario", "nope"], "unknown scenario"),
    (["--scenario", "dp", "--aggregator", "nope"], "unknown aggregator"),
    (["--scenario", "faulty-fleet", "--aggregator", "krum"],
     "masked variant")])
def test_cli_rejects_what_it_cannot_run_with_exit_2(argv, item, capsys):
    assert trun.main(argv + ["--device", "cpu"]) == 2
    assert item in capsys.readouterr().err
