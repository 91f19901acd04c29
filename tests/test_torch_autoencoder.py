"""The port's autoencoder-anomaly task against the JAX package's.

Per function on the same numpy inputs: the autoencoder's reconstruction
errors, losses and code mean (single and stacked members), the rank AUC
(ties, one class alone, and 65,536 samples, where the JAX package's
float32 rank sums near their integer limit), and the task's batched
local SGD.  Tolerances: 1e-5 relative and absolute for float32 chains
summed in another order; the AUC to 1e-6 (the port sums ranks in
float64).  The engine round by round on injected draws
(`test_torch_engine.py`'s harness), and on the port's own draws the final
AUC within the JAX package's band over seeds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api as tapi  # noqa: E402
from repro_torch.core import autoencoder as tae  # noqa: E402
from repro_torch.data import (dirichlet_partition,  # noqa: E402
                              make_iot_telemetry)

try:            # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro import api as japi
    from repro.api.components import AutoencoderAnomalyTask as JaxTask
    from repro.core import autoencoder as jae
    from repro.data import SyntheticTelemetry as JaxTelemetry
    from test_torch_engine import (FIXED, LYAPUNOV, assert_same_state,
                                   build_pair)
except ImportError:
    jax = None


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("the JAX package is not installed")


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def random_params(g, dim, hidden, code, lead=()):
    shapes = {"w1": (dim, hidden), "b1": (hidden,), "w2": (hidden, code),
              "b2": (code,), "w3": (code, hidden), "b3": (hidden,),
              "w4": (hidden, dim), "b4": (dim,)}
    return {k: (g.standard_normal(lead + s) / np.sqrt(s[0])).astype(
        np.float32) for k, s in shapes.items()}


def ae_spec(controller, *, execution="event", seed=0):
    return dict(fleet={"n_devices": 16}, clustering={"n_clusters": 4},
                controller=controller, aggregator={"kind": "trust"},
                task={"kind": "autoencoder-anomaly",
                      "params": {"n_samples": 1024, "dim": 16, "n_types": 4,
                                 "latent": 2, "hidden": 32, "code": 4}},
                local_batch=16, seed=seed, lr=0.1, execution=execution,
                sim_seconds=1e9)


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #
def test_autoencoder_functions_match_jax(needs_jax):
    g = np.random.default_rng(0)
    p = random_params(g, 12, 16, 4)
    x = g.standard_normal((50, 12)).astype(np.float32)
    tp, jp = {k: T(v) for k, v in p.items()}, {k: jnp.asarray(v)
                                              for k, v in p.items()}
    close(tae.reconstruct(tp, T(x)), jae.reconstruct(jp, x))
    close(tae.reconstruction_errors(tp, T(x)),
          jae.reconstruction_errors(jp, x))
    close(tae.reconstruction_loss(tp, T(x)),
          jae.reconstruction_loss(jp, {"x": x}))
    close(tae.code_mean(tp, T(x)), jae.code_mean(jp, x))
    # stacked members: (M, ...) params over (M, B, dim) batches
    ps = random_params(g, 12, 16, 4, lead=(3,))
    xs = g.standard_normal((3, 10, 12)).astype(np.float32)
    tps = {k: T(v) for k, v in ps.items()}
    for i in range(3):
        jpi = {k: jnp.asarray(v[i]) for k, v in ps.items()}
        close(tae.reconstruction_errors(tps, T(xs))[i],
              jae.reconstruction_errors(jpi, xs[i]))
        close(tae.reconstruction_loss(tps, T(xs))[i],
              jae.reconstruction_loss(jpi, {"x": xs[i]}))
        close(tae.code_mean(tps, T(xs))[i], jae.code_mean(jpi, xs[i]))
    init = tae.init_mlp_autoencoder(torch.Generator().manual_seed(0), 12,
                                    16, 4)
    want = jae.init_mlp_autoencoder(jax.random.PRNGKey(0), 12, 16, 4)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


def _auc_case(name):
    g = np.random.default_rng(len(name))
    if name == "random":
        s = g.standard_normal(500)
        y = g.random(500) < 0.3
    elif name == "ties":
        s = np.round(g.standard_normal(400), 1)
        y = g.random(400) < 0.4
    elif name == "all-equal":
        s, y = np.ones(5), np.array([0, 0, 0, 1, 1])
    elif name == "ordered":
        s, y = np.array([.1, .2, .3, .8, .9]), np.array([0, 0, 0, 1, 1])
    elif name == "reversed":
        s, y = np.array([.9, .8, .7, .2, .1]), np.array([0, 0, 0, 1, 1])
    elif name == "one-class":
        s, y = g.standard_normal(9), np.zeros(9)
    else:                                      # the fleet's sample count
        s = g.standard_normal(65536) + 0.5 * (g.random(65536) < 0.05)
        y = s - np.round(s, 0) > 0.1
    return s.astype(np.float32), y.astype(np.int32)


@pytest.mark.parametrize("name", ["random", "ties", "all-equal", "ordered",
                                  "reversed", "one-class", "65536"])
def test_anomaly_auc_matches_jax(needs_jax, name):
    s, y = _auc_case(name)
    got = float(tae.anomaly_auc(T(s), T(y)))
    want = float(jae.anomaly_auc(jnp.asarray(s), jnp.asarray(y)))
    if name == "one-class":
        assert np.isnan(got) and np.isnan(want)
        return
    assert abs(got - want) <= 1e-6, (got, want)
    # the pair count it stands for (ties at half credit)
    pos, neg = s[y == 1], s[y == 0]
    if len(pos) * len(neg) <= 1e6:
        pairs = (pos[:, None] > neg[None, :]).mean() \
            + 0.5 * (pos[:, None] == neg[None, :]).mean()
        assert abs(got - pairs) <= 1e-9
    if name == "all-equal":
        assert got == 0.5
    if name in ("ordered", "reversed"):
        assert got == (1.0 if name == "ordered" else 0.0)


def test_autoencoder_task_matches_jax(needs_jax):
    """The task adapter: batched local SGD and per-member losses against
    the JAX package's vmapped ones, evaluation (AUC and loss), the code
    mean and the identity label corruption."""
    dim, hidden, code, M, B = 12, 16, 4, 5, 8
    g = np.random.default_rng(3)
    p = random_params(g, dim, hidden, code, lead=(M,))
    x = g.standard_normal((M, B, dim)).astype(np.float32)
    y = (g.random((M, B)) < 0.1).astype(np.int64)
    ttask, jtask = tapi.AutoencoderAnomalyTask(hidden, code), JaxTask(hidden,
                                                                      code)
    ttask.init(torch.Generator().manual_seed(0), dim)
    flat = torch.cat([T(p[k]).reshape(M, -1) for k in sorted(p)], 1)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y, jnp.int32)}
    close(ttask.losses(flat, T(x), T(y)), jtask.losses(jp, jb))
    for steps in (1, 3):
        got = ttask.local_train(flat, T(x), T(y), 0.1, steps)
        want = jtask.local_train(jp, jb, 0.1, jnp.int32(steps))
        close(got, np.concatenate([np.asarray(want[k]).reshape(M, -1)
                                   for k in sorted(want)], 1))
    data = make_iot_telemetry(torch.Generator().manual_seed(1), n=600,
                              dim=dim)
    j0 = {k: v[0] for k, v in jp.items()}
    te = ttask.evaluate(flat[0], data)
    je = jtask.evaluate(j0, JaxTelemetry(
        x=jnp.asarray(data.x.numpy()), y=jnp.asarray(data.y.numpy()),
        device_type=jnp.asarray(data.device_type.numpy())))
    assert abs(te["acc"] - je["acc"]) <= 1e-6
    close(te["loss"], je["loss"])
    close(ttask.hidden_mean(flat[0], data.x), jtask.hidden_mean(
        j0, jnp.asarray(data.x.numpy())))
    assert torch.equal(ttask.corrupt_labels(T(y)), T(y))


# --------------------------------------------------------------------- #
# the telemetry
# --------------------------------------------------------------------- #
def test_telemetry_generator_and_partition():
    """The port's generator (its own draws): shapes and dtypes, anomaly
    labels at about their rate, anomalies off their family's manifold,
    and a partition over the device types that is non-IID; the spec's
    default data dispatches on the task."""
    d = make_iot_telemetry(torch.Generator().manual_seed(1), n=4000, dim=32,
                           anomaly_frac=0.1, spike=4.0)
    assert d.x.shape == (4000, 32) and d.x.dtype == torch.float32
    assert d.y.dtype == d.device_type.dtype == torch.int64
    assert set(d.y.unique().tolist()) <= {0, 1}
    assert set(d.device_type.unique().tolist()) <= set(range(8))
    assert 0.07 < float(d.y.float().mean()) < 0.13
    x, y, t = d.x.numpy(), d.y.numpy().astype(bool), d.device_type.numpy()
    dists = np.empty(len(x))
    for fam in np.unique(t):
        m = t == fam
        dists[m] = np.linalg.norm(x[m] - x[m & ~y].mean(0), axis=1)
    assert dists[y].mean() > 1.5 * dists[~y].mean()
    parts = dirichlet_partition(t, 8, alpha=0.5, n_classes=8, seed=3)
    idx = np.concatenate(parts)
    assert len(idx) == 4000 and len(set(idx.tolist())) == 4000
    dominant = [np.bincount(t[p], minlength=8).max() / len(p)
                for p in parts if len(p)]
    assert np.mean(dominant) > 0.25
    spec = tapi.FederationSpec.from_dict(ae_spec(FIXED_PLAIN))
    data, parts = tapi.default_device_data(spec)
    assert data.x.shape == (1024, 16) and len(parts) == 16
    assert sorted(np.concatenate(parts).tolist()) == list(range(1024))


FIXED_PLAIN = {"kind": "fixed", "params": {"a": 5}}


# --------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("controller,execution", [
    ("fixed", "event"), ("lyapunov", "scanned")])
def test_autoencoder_engine_round_by_round_on_injected_draws(
        needs_jax, controller, execution):
    """The JAX package's telemetry, partition, assignment, state and
    draws: scheduling, ``a`` and counters exactly, loss and energy within
    1e-5, the final AUC within 1e-5, the state within 1e-5."""
    ctl = FIXED if controller == "fixed" else LYAPUNOV
    jfed, tfed = build_pair(ae_spec(ctl, execution=execution))
    assert hasattr(tfed.engine.data, "device_type")
    if execution == "event":
        jt = jfed.run(eval_every=0.0, max_rounds=10)
        tt = tfed.run(eval_every=0.0, max_rounds=10)
    else:
        jt = jfed.engine.run_scanned(10)
        tt = tfed.engine.run_scanned(10)
    assert len(tt.records) == len(jt.records) >= 10
    for a, b in zip(jt.records, tt.records):
        assert (b.round, b.cluster, b.a, b.agg_count) == \
            (a.round, a.cluster, a.a, a.agg_count)
        np.testing.assert_allclose([b.t, b.loss, b.energy],
                                   [a.t, a.loss, a.energy], rtol=1e-5)
        assert (a.acc is None) == (b.acc is None)
        if a.acc is not None:
            assert abs(a.acc - b.acc) < 1e-5
    assert_same_state(jfed.engine.state, tfed.engine.state)


def test_auc_within_jax_band_over_seeds(needs_jax):
    """On its own draws the port detects anomalies as the JAX package
    does: over seeds 0-2 (fixed a = 5, 30 scanned rounds) its mean final
    AUC is within 0.05 of the JAX package's and no run falls more than 0.1
    below the JAX package's worst."""
    jax_auc, port_auc = [], []
    for seed in range(3):
        d = ae_spec(FIXED_PLAIN, seed=seed)
        jax_auc.append(japi.Federation.from_dict(d).engine.run_scanned(
            30).records[-1].acc)
        port_auc.append(tapi.Federation.from_dict(d, device="cpu").engine
                        .run_scanned(30).records[-1].acc)
    assert abs(np.mean(port_auc) - np.mean(jax_auc)) <= 0.05, (port_auc,
                                                                jax_auc)
    assert min(port_auc) >= min(jax_auc) - 0.1, (port_auc, jax_auc)

