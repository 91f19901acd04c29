"""The port's populations (`repro_torch.pop`) against its own standalone
runs and against the JAX package's `repro.pop`.

* `member_seed` and `PopulationSpec` expansion equal the JAX package's,
  so pool directories mean the same in both.
* The batched plain versions of the trust kernels equal ``jax.vmap`` of
  the Pallas functions (interpret mode), at the kernels' tolerances.
* Each member of a `PopulationEngine` reproduces the standalone
  ``Federation.from_spec(member_spec).run_scanned(K)`` run of its spec on
  the CPU, across controllers, every lifted axis and segmented runs: the
  schedule (cluster, a, round, agg_count) exactly, and the values (t,
  loss, acc, energy) within 1e-6 relative.  They are mostly the same
  bits; the one op found to break bitwise equality is Eqn 8's
  ``10.0 ** x`` (`core.energy.channel_rate`), whose vectorised CPU path
  over the batched (B, M) tensor and scalar path over a member's own
  (M,) tensor differ in the last ulp, so a member's energy can differ
  by an ulp a round.
* On the JAX members' own draws, the port's population matches
  `repro.pop.PopulationEngine` at `test_torch_engine`'s tolerances.
* One population round dispatches the same operations at B = 2 as at
  B = 4: no loop over members on the round's path.
"""
import collections
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (Federation, FederationSpec,  # noqa: E402
                             ShardingSpec)
from repro_torch.api.engine import fleet_state_from_numpy  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.kernels.trust_aggregate import (  # noqa: E402
    trust_aggregate, trust_aggregate_global)
from repro_torch.pop import (PopulationEngine, PopulationSpec,  # noqa: E402
                             member_seed)

try:            # the card's machine has no JAX: only its tests skip there
    import jax
    import jax.numpy as jnp
    from repro import pop as jpop
    from repro.kernels.trust_aggregate import trust_aggregate as jax_ta
    from repro.kernels.trust_aggregate import (
        trust_aggregate_global as jax_ta_global)
    from test_torch_engine import JaxDraws, assert_same_state, build_pair
except ImportError:
    jax = None

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
K = 5


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("the JAX package is not installed")


def spec_dict(seed=3, **kw):
    """`tests/test_pop.py`'s small spec: 8 devices, 2 clusters, the
    16-wide MLP."""
    d = dict(fleet={"n_devices": 8}, clustering={"n_clusters": 2},
             controller={"kind": "fixed", "params": {"a": 3}},
             aggregator={"kind": "trust"},
             task={"kind": "mlp", "params": {"n_samples": 256, "dim": 16,
                                             "hidden": 16}},
             execution="scanned", rounds=5, sim_seconds=1e9,
             local_batch=16, seed=seed)
    d.update(kw)
    return d


def spec(seed=3, **kw):
    return FederationSpec.from_dict(spec_dict(seed, **kw))


def tuples(trace):
    return [(r.t, r.round, r.cluster, r.a, r.loss, r.acc, r.energy,
             r.agg_count) for r in trace.records]


def assert_same_records(got, want, rtol=1e-6):
    """Schedule fields exactly, values within ``rtol`` (module doc)."""
    assert len(got.records) == len(want.records)
    for a, b in zip(got.records, want.records):
        assert (a.round, a.cluster, a.a, a.agg_count) == \
            (b.round, b.cluster, b.a, b.agg_count)
        assert (a.acc is None) == (b.acc is None)
        np.testing.assert_allclose(
            [a.t, a.loss, a.energy, a.acc or 0.0],
            [b.t, b.loss, b.energy, b.acc or 0.0], rtol=rtol, atol=0)


def assert_members_match_standalone(pop, traces, K):
    for b, s in enumerate(pop.specs):
        want = Federation.from_spec(s, device="cpu").run_scanned(K)
        assert_same_records(traces[b], want)


LYAPUNOV = {"kind": "lyapunov", "params": {"budget": 60.0, "horizon": 10}}
DQN = {"kind": "dqn", "params": {"episodes": 1, "horizon": 5}}
FAULTS = {"dropout": 0.2, "straggler_frac": 0.3, "twin_spike_prob": 0.2,
          "corrupt_mode": "gaussian", "corrupt_frac": 0.25,
          "corrupt_scale": 2.0, "poison_frac": 0.25, "poison_scale": 1.0}


# --------------------------------------------------------------------- #
# the spec layer against the JAX package's
# --------------------------------------------------------------------- #
def test_member_seed_matches_jax_on_200_pairs(needs_jax):
    g = np.random.default_rng(0)
    pairs = [(0, b) for b in range(8)] + [
        (int(s), int(b)) for s, b in zip(g.integers(0, 2 ** 31 - 1, 192),
                                         g.integers(0, 4096, 192))]
    assert [member_seed(s, b) for s, b in pairs] == \
        [jpop.member_seed(s, b) for s, b in pairs]
    assert [member_seed(0, b) for b in range(3)] == \
        [447923887, 390137614, 1055218036]


def test_population_spec_expansion_matches_jax(needs_jax):
    d = {"base": spec_dict(), "replicates": 2,
         "grid": {"lr": [0.1, 0.05], "channel.pkt_fail": [0.0, 0.2],
                  "controller.params.a": [2, 4]}}
    for derive in (True, False):
        d["derive_seeds"] = derive
        ours = PopulationSpec.from_dict(d)
        theirs = jpop.PopulationSpec.from_dict(d)
        assert ours.size == theirs.size == 16
        assert ours.to_dict() == theirs.to_dict()
        assert [m.to_dict() for m in ours.expand()] == \
            [m.to_dict() for m in theirs.expand()]
        again = PopulationSpec.from_dict(json.loads(json.dumps(
            ours.to_dict())))
        assert again.expand() == ours.expand()
    members = PopulationSpec.from_dict(d).replace(derive_seeds=True).expand()
    assert [m.lr for m in members[::2]] == [0.1] * 4 + [0.05] * 4
    assert [m.seed for m in members] == [member_seed(3, b)
                                         for b in range(16)]


def test_population_spec_validation_errors():
    with pytest.raises(ValueError, match="replicates"):
        PopulationSpec(base=spec(), replicates=0).validate()
    with pytest.raises(ValueError, match="grid"):
        PopulationSpec(base=spec(), grid={"lr": []}).validate()
    with pytest.raises(KeyError, match="no field"):
        PopulationSpec(base=spec(), grid={"nope": [1]}).expand()
    with pytest.raises(KeyError, match="unknown keys"):
        PopulationSpec.from_dict({"base": spec_dict(), "bogus": 1})
    # a sharded population validates as the JAX package's does, and runs
    # under a launch of as many ranks (tests/test_torch_placement.py)
    sharded = PopulationSpec.from_dict({"base": spec_dict(), "replicates": 2,
                                        "sharding": {"mesh": [2]}})
    assert sharded.to_dict()["sharding"]["mesh"] == (2,)
    assert sharded.validate() is sharded
    with pytest.raises(ValueError, match="does not divide the population"):
        sharded.replace(replicates=3).validate()
    with pytest.raises(ValueError, match="1-D mesh"):
        sharded.replace(sharding=ShardingSpec(mesh=(2, 1))).validate()
    with pytest.raises(ValueError, match="spawn_local"):
        PopulationEngine.from_population(sharded, device="cpu")


def test_structural_mismatch_and_mixed_dp_are_refused():
    with pytest.raises(ValueError, match="fleet.n_devices must be uniform"):
        PopulationEngine([spec(0), spec(1, fleet={"n_devices": 12})],
                         device="cpu")
    with pytest.raises(ValueError, match="controller.kind must be uniform"):
        PopulationEngine([spec(0), spec(1, controller=LYAPUNOV)],
                         device="cpu")
    dp = {"clip": 1.0, "noise": 0.5}
    with pytest.raises(ValueError, match="cannot combine with DP"):
        PopulationEngine([spec(0, privacy=dp),
                          spec(1, privacy=dp,
                               aggregator={"kind": "fedavg"})],
                         device="cpu")
    with pytest.raises(ValueError, match="mixed aggregator kinds"):
        PopulationEngine([spec(0), spec(1, aggregator={"kind": "median"})],
                         device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PopulationEngine([spec()])


# --------------------------------------------------------------------- #
# the batched plain versions against jax.vmap of the Pallas functions
# --------------------------------------------------------------------- #
def _pop_arrays(P, C, B, N, seed):
    g = np.random.default_rng(seed)
    x = g.standard_normal((P, C, N)).astype(np.float32)
    valid = g.integers(0, C + 1, P)
    valid[0] = C
    mask = (np.arange(C)[None, :] < valid[:, None]).astype(np.float32)
    x[mask == 0] = 1e30
    w = g.random((P, C)).astype(np.float32)
    w[::2] *= mask[::2]             # odd members leave weight on padding
    stack = g.standard_normal((P, B, N)).astype(np.float32)
    gw = g.random((P, B)).astype(np.float32)
    gw /= gw.sum(1, keepdims=True)
    c = np.array([(0, B - 1, B)[p % 3] for p in range(P)], np.int32)
    return x, w, mask, stack, gw, c


@pytest.mark.parametrize("P,C,B,N", [(3, 6, 4, 700), (4, 5, 3, 129),
                                     (1, 1, 2, 64)])
def test_batched_plain_versions_match_jax_vmap(needs_jax, P, C, B, N):
    """Fused, masked and dense, with ragged valid rows, padded rows of
    1e30 and c in {0, B - 1, B}; tolerances of `tests/test_kernels.py`."""
    x, w, mask, stack, gw, c = _pop_arrays(P, C, B, N, seed=P * C + N)
    t = torch.from_numpy
    want = jax.vmap(lambda *a: jax_ta_global(*a, interpret=True))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask > 0),
        jnp.asarray(stack), jnp.asarray(gw), jnp.asarray(c))
    got = ref.trust_aggregate_global_pop_ref(t(x), t(w), t(mask), t(stack),
                                             t(gw), t(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for m in (mask, None):
        ww = w * mask
        want = jax.vmap(lambda xs, ws, ms: jax_ta(
            xs, ws, ms, interpret=True), in_axes=(0, 0, None if m is None
                                                  else 0))(
            jnp.asarray(np.where(mask[..., None] > 0, x, 0.0)),
            jnp.asarray(ww), None if m is None else jnp.asarray(m > 0))
        xs = t(np.where(mask[..., None] > 0, x, 0.0).astype(np.float32))
        got = ref.trust_aggregate_pop_ref(xs, t(ww),
                                          None if m is None else t(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)


def test_kernels_under_vmap_take_the_batched_versions_on_the_cpu():
    """On CPU tensors the batching rules of the kernel operators run the
    batched plain versions, which equal the single ones per member; no
    kernel launch is counted."""
    x, w, mask, stack, gw, c = (torch.from_numpy(a) for a in
                                _pop_arrays(3, 6, 4, 97, seed=5))
    before = dict(launches)
    got = torch.func.vmap(trust_aggregate_global)(x, w, mask, stack, gw, c)
    assert torch.equal(got, torch.stack([
        ref.trust_aggregate_global_ref(x[p], w[p], mask[p], stack[p], gw[p],
                                       c[p]) for p in range(3)]))
    got = torch.func.vmap(trust_aggregate)(x, w, mask)
    assert torch.equal(got, torch.stack([ref.trust_aggregate_ref(
        x[p], w[p], mask[p]) for p in range(3)]))
    got = torch.func.vmap(trust_aggregate, in_dims=(0, 0, None))(
        stack, gw, None)
    assert torch.equal(got, torch.stack([ref.trust_aggregate_ref(
        stack[p], gw[p]) for p in range(3)]))
    assert launches == before


# --------------------------------------------------------------------- #
# members against their standalone runs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("controller", [
    {"kind": "fixed", "params": {"a": 3}}, LYAPUNOV, DQN],
    ids=["fixed", "lyapunov", "dqn"])
def test_members_match_standalone_runs(controller):
    pspec = PopulationSpec(base=spec(controller=controller),
                           grid={"lr": [0.05, 0.1]}, replicates=2)
    pop = PopulationEngine.from_population(pspec, device="cpu")
    traces = pop.run_scanned(K)
    assert len(traces) == 4 and all(len(t.records) == K + 1
                                    for t in traces)
    assert_members_match_standalone(pop, traces, K)
    assert len({tuples(t)[-1][4] for t in traces}) == 4   # distinct losses


@pytest.mark.parametrize("base,grid", [
    ({}, {"channel.pkt_fail": [0.0, 0.2], "controller.params.a": [2, 5]}),
    ({"controller": LYAPUNOV}, {"iota": [0.05, 0.3],
                                "clustering.alpha0": [0.3, 0.9],
                                "clustering.alpha_growth": [0.0, 0.1]}),
    ({"privacy": {"clip": 1.0, "noise": 0.5}},
     {"privacy.noise": [0.25, 0.5, 1.0]}),
    ({"faults": FAULTS}, {"faults.dropout": [0.1, 0.3],
                          "faults.corrupt_scale": [1.0, 3.0],
                          "faults.straggler_factor": [2.0, 4.0]}),
    ({"faults": {**FAULTS, "corrupt_mode": "sign_flip", "poison_frac": 0.0,
                 "twin_spike_scale": 6.0}},
     {"faults.twin_spike_prob": [0.1, 0.5], "faults.seed": [0, 7]}),
    ({}, {"aggregator.kind": ["trust", "fedavg"],
          "fleet.malicious_frac": [0.0, 0.25]}),
    ({"aggregator": {"kind": "median"}}, {"channel.p_good": [0.3, 0.8]}),
], ids=["pkt_fail+a", "lyapunov-knobs", "dp-noise", "fault-intensities",
        "fault-seed", "trust-fedavg", "median"])
def test_lifted_axes_match_standalone_runs(base, grid):
    pspec = PopulationSpec(base=spec(**base), grid=grid)
    pop = PopulationEngine.from_population(pspec, device="cpu")
    assert_members_match_standalone(pop, pop.run_scanned(K), K)


def test_autoencoder_population_matches_standalone_runs():
    task = {"kind": "autoencoder-anomaly",
            "params": {"n_samples": 256, "dim": 8, "hidden": 8, "code": 4}}
    pop = PopulationEngine.from_population(
        PopulationSpec(base=spec(task=task, controller=DQN), replicates=2),
        device="cpu")
    assert_members_match_standalone(pop, pop.run_scanned(K), K)


def test_segments_continue_one_run():
    pspec = PopulationSpec(base=spec(controller=LYAPUNOV),
                           grid={"lr": [0.05, 0.1]})
    one = PopulationEngine.from_population(pspec, device="cpu")
    whole = one.run_scanned(5, eval_final=False)
    two = PopulationEngine.from_population(pspec, device="cpu")
    parts = [two.run_scanned(2, eval_final=False),
             two.run_scanned(3, eval_final=False)]
    for b in range(2):
        assert tuples(parts[0][b]) + tuples(parts[1][b]) == \
            tuples(whole[b])
        assert two.member_energy(b) == one.member_energy(b)
    for k, v in one.state.tensors().items():
        assert torch.equal(v, two.state.tensors()[k]), k


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("base", [
    {"controller": LYAPUNOV}, {"privacy": {"clip": 1.0, "noise": 0.5}},
    {"faults": FAULTS, "controller": DQN}], ids=["lyapunov", "dp", "dqn+faults"])
def test_a_round_dispatches_the_same_ops_whatever_b(base):
    counts = []
    for B in (2, 4):
        pop = PopulationEngine.from_population(
            PopulationSpec(base=spec(**base), replicates=B), device="cpu")
        energy = torch.zeros(B)
        with _CountOps() as mode:
            pop._round(pop.state, pop._scan_times, pop._ctl_state(), energy)
        counts.append(mode.ops)
    assert counts[0] == counts[1]
    assert sum(counts[0].values()) > 100


# --------------------------------------------------------------------- #
# the port's population against the JAX package's
# --------------------------------------------------------------------- #
class StackedDraws:
    """The JAX members' own draws (`test_torch_engine.JaxDraws` each), for
    the batched state and (B, M) member table of a population round."""

    def __init__(self, per_member):
        self.per_member = per_member

    def __call__(self, state, members):
        out = []
        for b, draws in enumerate(self.per_member):
            st = dataclasses.replace(state, round=state.round[b],
                                     channel=state.channel[b])
            out.append(draws(st, members[b]))
        return type(out[0])(*[
            None if f[0] is None else torch.stack(list(f))
            for f in zip(*out)])


@pytest.mark.parametrize("controller", [LYAPUNOV, {"kind": "fixed",
                                                   "params": {"a": 3}}],
                         ids=["lyapunov", "fixed"])
def test_population_matches_jax_population_on_its_draws(needs_jax,
                                                        controller):
    pspec = {"base": spec_dict(controller=controller),
             "grid": {"lr": [0.05, 0.1]}}
    jspecs = jpop.PopulationSpec.from_dict(pspec).expand()
    pairs = [build_pair(s.to_dict()) for s in jspecs]
    jp = jpop.PopulationEngine(jspecs, federations=[j for j, _ in pairs])
    tp = PopulationEngine(PopulationSpec.from_dict(pspec).expand(),
                          device="cpu", federations=[t for _, t in pairs])
    # the JAX population's state, stacked, is the port's batched state
    jstate = jax.device_get(jp.state._replace(key=None))
    tp.state = fleet_state_from_numpy(jstate, "cpu", population=True)
    tp.draws = StackedDraws([JaxDraws(j.engine) for j, _ in pairs])
    jt, tt = jp.run_scanned(3), tp.run_scanned(3)
    for b in range(2):
        assert len(tt[b].records) == len(jt[b].records) == 4
        for a, r in zip(jt[b].records, tt[b].records):
            assert (r.round, r.cluster, r.a, r.agg_count) == \
                (a.round, a.cluster, a.a, a.agg_count)
            np.testing.assert_allclose([r.t, r.loss, r.energy],
                                       [a.t, a.loss, a.energy], rtol=1e-5)
        assert abs(tt[b].records[-1].acc - jt[b].records[-1].acc) < 1e-5
        # the member view reads a member back as a single-tenant tree
        fleet = tp.member(b).engine.resumable_state()["fleet"]
        member = fleet_state_from_numpy(fleet, "cpu")
        assert_same_state(jax.tree.map(lambda leaf: leaf[b],
                                       jax.device_get(jp.state)), member)


def test_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.pop, repro_torch.serve.pool;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro'];"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
