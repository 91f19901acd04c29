"""The port's round numerics against the JAX package on shared numpy inputs.

Random functions take their draws as arguments in the port; here they get
the draws the JAX functions made.  Tolerances: 1e-6 relative for float32
elementwise chains (a few ulps), 1e-5 where a reduction over many terms
is summed in another order; integer outcomes (assignments, the Alg.-2
bound, argmax actions, partitions) must match exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api.components import MLPTask as JaxMLPTask  # noqa: E402
from repro.control import policy as jpolicy  # noqa: E402
from repro.core import clustering as jclust  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import lyapunov as jlyap  # noqa: E402
from repro.core import mlp as jmlp  # noqa: E402
from repro.core import trust as jtrust  # noqa: E402
from repro.core import twin as jtwin  # noqa: E402
from repro.data import federated as jfed  # noqa: E402

from repro_torch import rng  # noqa: E402
from repro_torch.api.components import MLPTask  # noqa: E402
from repro_torch.control import policy as tpolicy  # noqa: E402
from repro_torch.control import queue as tqueue  # noqa: E402
from repro_torch.core import clustering as tclust  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import lyapunov as tlyap  # noqa: E402
from repro_torch.core import mlp as tmlp  # noqa: E402
from repro_torch.core import trust as ttrust  # noqa: E402
from repro_torch.core import twin as ttwin  # noqa: E402
from repro_torch.data import federated as tfed  # noqa: E402


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def random_twins(n, seed):
    g = np.random.default_rng(seed)
    f = lambda lo, hi: g.uniform(lo, hi, n).astype(np.float32)
    arrs = dict(loss=f(0.1, 3), freq=f(0.5, 2), freq_dev=f(0, 0.4),
                dev_estimate=f(0, 0.3), energy=f(0, 50),
                data_size=f(256, 4096), alpha=f(1, 9), beta=f(0, 3),
                router_entropy=f(0, 1))
    return (jtwin.TwinState(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            ttwin.TwinState(**{k: T(v) for k, v in arrs.items()}))


def same_twins(tt, jt, tol=1e-6):
    for k in jtwin.TwinState._fields:
        close(getattr(tt, k).numpy(), getattr(jt, k), tol)


# ------------------------------------------------------------------ trust
@pytest.mark.parametrize("masked", [False, True])
def test_trust_chain(masked):
    g = np.random.default_rng(3)
    upd = g.standard_normal((9, 300)).astype(np.float32)
    mask = np.arange(9) < (6 if masked else 9)
    jm, tm = (jnp.asarray(mask), T(mask)) if masked else (None, None)
    jq = jtrust.learning_quality(jnp.asarray(upd), jm)
    tq = ttrust.learning_quality(T(upd), tm)
    close(tq.numpy()[mask], np.asarray(jq)[mask], 1e-5)
    jd = jtrust.gradient_diversity(jnp.asarray(upd), jm)
    td = ttrust.gradient_diversity(T(upd), tm)
    close(td.numpy()[mask], np.asarray(jd)[mask], 1e-5)
    jtw, ttw = random_twins(9, 4)
    jb = jtrust.belief(jtw, jq, 0.05, jd)
    tb = ttrust.belief(ttw, T(np.asarray(jq)), 0.05, T(np.asarray(jd)))
    close(tb.numpy(), jb)
    rep = g.uniform(-0.5, 3, 9).astype(np.float32)
    close(ttrust.update_reputation(T(rep), tb, 0.05, 0.1).numpy(),
          jtrust.update_reputation(jnp.asarray(rep), jb, 0.05, 0.1))
    for r in (rep, np.full(9, -1.0, np.float32)):      # incl. degenerate
        close(ttrust.trust_weights(T(r), tm).numpy(),
              jtrust.trust_weights(jnp.asarray(r), jm))


def test_staleness_and_time_weighted_average():
    st = np.array([0, 3, 1, 7], np.float32)
    close(ttrust.staleness_weights(T(st)).numpy(),
          jtrust.staleness_weights(jnp.asarray(st)))
    stack = np.random.default_rng(5).standard_normal((4, 50)).astype(
        np.float32)
    tavg, tw = ttrust.time_weighted_average(T(stack), T(st))
    javg, jw = jtrust.time_weighted_average({"p": jnp.asarray(stack)},
                                            jnp.asarray(st))
    close(tavg.numpy(), javg["p"], 1e-5)
    close(tw.numpy(), jw)


# ------------------------------------------------------------------- twin
def test_twin_init_deviation_calibrate():
    key = jax.random.PRNGKey(7)
    kt, kd = jax.random.split(key)
    jt = jtwin.sample_deviation(kd, jtwin.init_twins(kt, 12), 0.2)
    dev = jax.random.uniform(kd, (12,), minval=0.0, maxval=0.2)
    tt = ttwin.sample_deviation(
        ttwin.init_twins(T(np.asarray(jt.freq)), T(np.asarray(jt.data_size))),
        T(np.asarray(dev)))
    same_twins(tt, jt)
    same_twins(ttwin.calibrate(tt), jtwin.calibrate(jt))
    close(ttwin.calibrated_freq(tt).numpy(), jtwin.calibrated_freq(jt))


def test_member_view_and_observe_with_sentinel():
    n = 10
    jt, tt = random_twins(n, 8)
    members = np.array([7, 2, 5, n, n], np.int64)    # two padding slots
    same_twins(ttwin.member_view(tt, T(members)),
               jtwin.member_view(jt, jnp.asarray(members, jnp.int32)))
    g = np.random.default_rng(9)
    losses = g.uniform(0, 2, 5).astype(np.float32)
    e = g.uniform(0, 9, 5).astype(np.float32)
    mal = (np.arange(n) % 4 == 0).astype(np.float32)
    same_twins(
        ttwin.observe_round_members(tt, T(members), T(losses), T(e),
                                    T(mal)),
        jtwin.observe_round_members(jt, jnp.asarray(members, jnp.int32),
                                    jnp.asarray(losses), jnp.asarray(e),
                                    jnp.asarray(mal)))


# ----------------------------------------------------------------- energy
def test_round_energy_with_injected_noise():
    g = np.random.default_rng(11)
    members = np.array([3, 0, 6, 9, 9], np.int32)     # 9 = sentinel
    ch = g.integers(0, 3, 5).astype(np.int32)
    freq = g.uniform(0.5, 2.4, 5).astype(np.float32)
    key = jax.random.PRNGKey(2)
    lam = jenergy.NOISE_MEAN_DB[jnp.asarray(ch)]
    noise = jax.vmap(lambda m, l: jax.random.poisson(
        jax.random.fold_in(key, m), l, ()))(jnp.asarray(members), lam)
    want = jenergy.round_energy(jnp.float32(3.0), jnp.asarray(freq),
                                jnp.asarray(ch), key,
                                members=jnp.asarray(members))
    got = tenergy.round_energy(torch.tensor(3.0), T(freq),
                               T(ch.astype(np.int64)),
                               T(np.asarray(noise, np.float32)))
    close(got.numpy(), want, 1e-5)
    close(tenergy.channel_transition(0.7).numpy(),
          jenergy.channel_transition(0.7))


def test_channel_and_noise_draws_follow_their_distributions():
    u = rng.uniform(0, torch.tensor(3), rng.CHANNEL, torch.arange(200000), 0)
    state = torch.arange(200000) % 3
    cdf = tenergy.channel_cdf(0.6)
    nxt = tenergy.step_channel(u, state, cdf)
    freq = torch.bincount(nxt, minlength=3).double() / nxt.numel()
    np.testing.assert_allclose(freq.numpy(), [0.6, 0.2, 0.2], atol=5e-3)
    noise = tenergy.draw_noise(u, state)
    for s, lam in enumerate(tenergy.NOISE_MEAN_DB):
        assert abs(noise[state == s].mean().item() - lam) < 1e-2


# ------------------------------------------------------------- clustering
def test_kmeans_and_cluster_devices_with_injected_seeds():
    key = jax.random.PRNGKey(5)
    jt = jtwin.sample_deviation(key, jtwin.init_twins(key, 64), 0.2)
    tt = ttwin.TwinState(**{k: T(np.array(getattr(jt, k)))
                            for k in jtwin.TwinState._fields})
    init_idx = jax.random.choice(key, 64, (6,), replace=False)
    j_assign, j_cent = jclust.cluster_devices(key, jt, 6)
    t_assign, t_cent = tclust.cluster_devices(
        tt, 6, T(np.asarray(init_idx).astype(np.int64)))
    np.testing.assert_array_equal(t_assign.numpy(), np.asarray(j_assign))
    close(t_cent.numpy(), j_cent, 1e-5)
    assign = np.asarray(j_assign).copy()
    assign[assign == 0] = 1                           # empty cluster 0
    filled = tclust.ensure_nonempty(assign, 6)
    np.testing.assert_array_equal(filled, jclust.ensure_nonempty(assign, 6))
    t_tab, t_mask = tclust.padded_membership(filled, 6)
    j_tab, j_mask = jclust.padded_membership(filled, 6)
    np.testing.assert_array_equal(t_tab.numpy(), np.asarray(j_tab))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))


def test_tolerance_bound_exact():
    g = np.random.default_rng(12)
    for _ in range(200):
        a = np.int32(g.integers(1, 11))
        freq, fmax = np.sort(g.uniform(0.4, 2.6, 2).astype(np.float32))
        alpha = np.float32(g.uniform(0.5, 1.0))
        t_min = np.float32(np.float32(a) / fmax)
        want = jclust.tolerance_bound(jnp.int32(a), jnp.float32(freq),
                                      jnp.float32(t_min), jnp.float32(alpha))
        got = tclust.tolerance_bound(torch.tensor(a), torch.tensor(freq),
                                     torch.tensor(t_min),
                                     torch.tensor(alpha))
        assert int(got) == int(want)


# ----------------------------------------------------- Lyapunov and policy
def test_queue_and_lyapunov_scores_argmax_exact():
    jq = jlyap.init_queue(300.0, 40)
    tq = tlyap.init_queue(300.0, 40)
    g = np.random.default_rng(13)
    for i in range(60):
        consumed = float(np.float32(g.uniform(0, 20)))
        loss, mf, good = (float(np.float32(v)) for v in
                          (g.uniform(0.05, 2.3), g.uniform(0.5, 2.5),
                           g.uniform(0, 1)))
        kw = dict(n_actions=10, kappa=0.08, f_star=0.1, v0=1.0,
                  v_growth=0.02)
        js = jpolicy.lyapunov_scores(jq.q, jnp.float32(i), jnp.float32(loss),
                                     jnp.float32(mf), jnp.float32(good), **kw)
        ts = tpolicy.lyapunov_scores(tq.q, i, loss, mf, good, **kw)
        close(ts.numpy(), js, 1e-5)
        assert int(torch.argmax(ts)) == int(jnp.argmax(js))
        jq, tq = jlyap.step_queue(jq, consumed), tlyap.step_queue(tq,
                                                                  consumed)
        assert float(tq.q) == float(jq.q)
    assert tqueue.per_slot_of(object()) == float("inf")
    assert float(tqueue.queue_advance(torch.tensor(3.0), 2.0,
                                      tqueue.NO_BUDGET)) == 0.0
    close(tlyap.v_schedule(7.0, 1.0, 0.02), jlyap.v_schedule(7.0, 1.0, 0.02))
    close(tlyap.drift_penalty_reward(2.0, 1.5, 7.0, tq, 1.3).item(),
          jlyap.drift_penalty_reward(2.0, 1.5, 7.0, jq, 1.3))


def test_scan_policies_match():
    obs = dict(round=5, cluster=1, queue=2.5, cluster_loss=1.3,
               cluster_freq=0.9, mean_freq=1.4, channel_good_frac=0.25,
               energy_used=10.0)
    jobs = jpolicy.CtlObs(**{k: jnp.float32(v) for k, v in obs.items()},
                          dqn_obs=jnp.zeros((48,)))
    tobs = tpolicy.CtlObs(**{k: torch.tensor(float(v))
                             for k, v in obs.items()})
    for jp, tp in ((jpolicy.fixed_policy(4), tpolicy.fixed_policy(4)),
                   (jpolicy.lyapunov_policy(), tpolicy.lyapunov_policy())):
        assert int(tp.step(tp.state, tobs)[0]) == int(jp.step(jp.state,
                                                              jobs)[0])


# -------------------------------------------------------------------- mlp
def test_mlp_loss_and_batched_sgd_match_vmap():
    dim, hidden, M, B = 20, 8, 5, 12
    g = np.random.default_rng(14)
    params = {"w1": g.standard_normal((M, dim, hidden)) / np.sqrt(dim),
              "b1": g.standard_normal((M, hidden)) * 0.1,
              "w2": g.standard_normal((M, hidden, 10)) / np.sqrt(hidden),
              "b2": g.standard_normal((M, 10)) * 0.1}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = g.standard_normal((M, B, dim)).astype(np.float32)
    y = g.integers(0, 10, (M, B))
    jtask, ttask = JaxMLPTask(hidden=hidden), MLPTask(hidden=hidden)
    ttask.init(torch.Generator().manual_seed(0), dim)
    flat = torch.cat([T(params[k]).reshape(M, -1) for k in sorted(params)],
                     1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y, jnp.int32)}
    close(ttask.losses(flat, T(x), T(y)).numpy(), jtask.losses(jp, jb),
          1e-5)
    close(tmlp.classifier_losses({k: T(v[0]) for k, v in params.items()},
                                 T(x[0]), T(y[0])).item(),
          jmlp.classifier_loss({k: v[0] for k, v in jp.items()},
                               {"x": jb["x"][0], "y": jb["y"][0]}), 1e-5)
    for steps in (1, 3):
        got = ttask.local_train(flat, T(x), T(y), 0.1, steps)
        want = jtask.local_train(jp, jb, 0.1, jnp.int32(steps))
        want = np.concatenate([np.asarray(want[k]).reshape(M, -1)
                               for k in sorted(want)], 1)
        close(got.numpy(), want, 1e-5)


# ------------------------------------------------------------------- data
def test_dirichlet_partition_and_padded_tables():
    key = jax.random.PRNGKey(3)
    labels = np.asarray(jax.random.randint(key, (500,), 0, 10))
    seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    want = jfed.dirichlet_partition(key, labels, 12, alpha=0.5)
    got = tfed.dirichlet_partition(labels, 12, alpha=0.5, seed=seed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    idx, length = tfed.padded_partition(got)
    j_idx, j_len = jfed.padded_partition(want)
    np.testing.assert_array_equal(idx[:-1].numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(length[:-1].numpy(), np.asarray(j_len))
    assert length[-1] == 1 and (idx[-1] == 0).all()    # the sentinel row
    members = torch.tensor([4, 0, 12])
    u = rng.uniform(1, 0, rng.BATCH, members[:, None],
                    torch.arange(64)[None, :])
    rows = tfed.sample_member_batch(u, idx, length, members)
    for i, m in enumerate(members.tolist()):
        shard = got[m] if m < 12 else np.array([0])
        assert set(rows[i].tolist()) <= set(shard.tolist())


def test_rng_draws_are_per_device_and_width_independent():
    a = rng.uniform(0, torch.tensor(4), rng.NOISE, torch.tensor([3, 9, 5]), 0)
    b = rng.uniform(0, torch.tensor(4), rng.NOISE, torch.tensor([9, 3]), 0)
    assert a[0] == b[1] and a[1] == b[0]
    big = rng.uniform(1, 2, rng.BATCH, torch.arange(100000), 0)
    assert 0.0 <= big.min() and big.max() < 1.0
    assert abs(big.mean().item() - 0.5) < 5e-3
    assert rng.uniform(2, 2, rng.BATCH, torch.arange(5), 0).ne(
        rng.uniform(1, 2, rng.BATCH, torch.arange(5), 0)).all()
