"""The port's DQN control plane against the JAX package's.

Per function, on the same numpy inputs and the JAX package's own draws:
the Q-network, epsilon-greedy selection, the replay ring buffer, one TD
step (parameters, target network and step counter), the DT environment's
reset and steps, the deployment observation, the distilled table and the
table policy.  Tolerances: 1e-5 relative and absolute for float32 values
that pass through products or reductions summed in another order; integer
outcomes (actions, replay pointers, channel states, tables) exactly.

The engine with the `dqn` controller round by round on injected draws
(`test_torch_engine.py`'s harness), with the JAX package's agent copied
over: actions must match exactly on the event heap and in `run_scanned`.
Training itself can match only by statistics, since the draws differ.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)

from repro_torch import api as tapi  # noqa: E402
from repro_torch import rng as trng  # noqa: E402
from repro_torch import control as tctl  # noqa: E402
from repro_torch.control import policy as tpolicy  # noqa: E402
from repro_torch.control import scanned_dqn as tscan  # noqa: E402
from repro_torch.core import dqn as tdqn  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import envs as tenvs  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402

try:            # the card's machine has no JAX: only the cuda test runs there
    import jax
    import jax.numpy as jnp
    from repro import api as japi
    from repro import control as jctl
    from repro.control import policy as jpolicy
    from repro.core import dqn as jdqn
    from repro.core import envs as jenvs
    from repro.core.energy import NOISE_MEAN_DB
    from test_torch_engine import JaxDraws, assert_same_state, spec_dict
except ImportError:
    jax = None

TOL = 1e-5


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("the JAX package is not installed")


def close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def port_state(js, cfg):
    """The port's `DQNState` from the JAX package's."""
    rep = js.replay
    t = lambda a, dt=torch.float32: torch.as_tensor(np.array(a), dtype=dt)
    return tdqn.DQNState(
        eval_params=tdqn.dqn_params_from_numpy(js.eval_params),
        target_params=tdqn.dqn_params_from_numpy(js.target_params),
        replay=tdqn.Replay(s=t(rep.s), a=t(rep.a, torch.int64), r=t(rep.r),
                           s2=t(rep.s2), ptr=t(rep.ptr, torch.int64),
                           full=t(rep.full, torch.bool)),
        step=t(js.step, torch.int64))


def assert_same_agent(ts, js):
    for k in js.eval_params:
        close(ts.eval_params[k], js.eval_params[k])
        close(ts.target_params[k], js.target_params[k])
    for f in ("s", "a", "r", "s2"):
        close(getattr(ts.replay, f), getattr(js.replay, f))
    assert int(ts.replay.ptr) == int(js.replay.ptr)
    assert bool(ts.replay.full) == bool(js.replay.full)
    assert int(ts.step) == int(js.step)


def filled_agent(cfg, seed, pushes, reward_scale=1.0):
    """A JAX agent whose replay holds ``pushes`` random transitions."""
    g = np.random.default_rng(seed)
    js = jdqn.init_dqn(jax.random.PRNGKey(seed), cfg)
    for _ in range(pushes):
        js = jdqn.store(js, jnp.asarray(g.normal(size=cfg.state_dim),
                                        jnp.float32),
                        jnp.int32(g.integers(cfg.n_actions)),
                        jnp.float32(g.normal() * reward_scale),
                        jnp.asarray(g.normal(size=cfg.state_dim),
                                    jnp.float32))
    return js


# --------------------------------------------------------------------- #
# the agent
# --------------------------------------------------------------------- #
def test_q_values_and_epsilon_greedy_select_match(needs_jax):
    cfg = jdqn.DQNConfig()
    js = jdqn.init_dqn(jax.random.PRNGKey(3), cfg)
    ts = port_state(js, cfg)
    s = np.random.default_rng(0).normal(size=(16, 48)).astype(np.float32)
    close(tdqn.q_values(ts.eval_params, torch.from_numpy(s)),
          jdqn.q_values(js.eval_params, jnp.asarray(s)))
    # steps 0 and 900 put epsilon at 0.1 and 1.0: both branches run
    for step in (0, 450, 900):
        js_k = js._replace(step=jnp.int32(step))
        ts_k = ts._replace(step=torch.tensor(step))
        for i in range(8):
            key = jax.random.PRNGKey(100 + i)
            kg, kr = jax.random.split(key)
            want = jdqn.select_action(key, js_k, cfg, jnp.asarray(s[i]))
            got = tdqn.select_action(
                ts_k, cfg, torch.from_numpy(s[i]),
                torch.tensor(float(jax.random.uniform(kg))),
                torch.tensor(int(jax.random.randint(kr, (), 0,
                                                    cfg.n_actions))))
            assert int(got) == int(want)
    close(tdqn.epsilon(cfg, torch.tensor(450)),
          jdqn.epsilon(cfg, jnp.int32(450)))


def test_replay_store_wraps_like_jax(needs_jax):
    cfg = jdqn.DQNConfig(buffer_size=5, state_dim=3, n_actions=4)
    js = jdqn.init_dqn(jax.random.PRNGKey(0), cfg)
    ts = port_state(js, cfg)
    g = np.random.default_rng(1)
    for k in range(12):
        s, s2 = (g.normal(size=3).astype(np.float32) for _ in range(2))
        a, r = k % 4, np.float32(g.normal())
        js = jdqn.store(js, jnp.asarray(s), jnp.int32(a), jnp.float32(r),
                        jnp.asarray(s2))
        ts = tdqn.store(ts, torch.from_numpy(s), torch.tensor(a),
                        torch.tensor(r), torch.from_numpy(s2))
        assert_same_agent(ts, js)
    assert int(ts.replay.ptr) == 12 % 5 and bool(ts.replay.full)


@pytest.mark.parametrize("step,pushes,clipped", [
    (0, 40, False), (7, 40, False), (50, 40, False), (3, 3, False),
    (9, 70, True)],
    ids=["sync", "no-sync", "sync-50", "few-rows", "clipped"])
def test_train_step_matches_jax(needs_jax, step, pushes, clipped):
    """One TD step from the same agent with the same replay rows: the
    gradient clip by the global norm (only the ``clipped`` case drives the
    norm past 5) and the target sync on the step count before the
    increment."""
    cfg = jdqn.DQNConfig(buffer_size=64, batch_size=16, lr=2e-3)
    js = filled_agent(cfg, step, pushes, 1e3 if clipped else 0.1)
    # small output weights keep the unclipped cases' norm under 5; the
    # target net apart from the eval net, so a sync shows
    shrink = 1.0 if clipped else 0.05
    js = js._replace(
        step=jnp.int32(step),
        eval_params={**js.eval_params, "w3": js.eval_params["w3"] * shrink},
        target_params=jax.tree.map(lambda p: p * 0.5 * shrink,
                                   js.target_params))
    ts = port_state(js, cfg)
    key = jax.random.PRNGKey(11)
    rep = js.replay
    limit = jnp.where(rep.full, rep.s.shape[0], jnp.maximum(rep.ptr, 1))
    idx = jax.random.randint(key, (cfg.batch_size,), 0, limit)
    js2, jloss = jdqn.train_step_fn(key, js, cfg)
    assert int(tdqn.replay_limit(ts.replay)) == int(limit)
    ts2, tloss = tdqn.train_step(
        ts, cfg, torch.as_tensor(np.array(idx), dtype=torch.int64))
    close(tloss, jloss)
    assert_same_agent(ts2, js2)
    g = jax.grad(jdqn._td_loss)(js.eval_params, js.target_params, cfg,
                                (rep.s[idx], rep.a[idx], rep.r[idx],
                                 rep.s2[idx]))
    gnorm = float(jnp.sqrt(sum(jnp.sum(v ** 2) for v in
                               jax.tree.leaves(g))))
    assert (gnorm > 5.0) == clipped, gnorm


# --------------------------------------------------------------------- #
# the DT environment
# --------------------------------------------------------------------- #
def channel_uniforms(prev, nxt, p_good):
    """Uniforms that `step_channel` maps from ``prev`` to ``nxt``: the
    middle of each next state's interval of the transition row."""
    cdf = tenergy.channel_cdf(p_good).numpy().astype(np.float64)
    prev, nxt = np.asarray(prev), np.asarray(nxt)
    hi = cdf[prev, nxt]
    lo = np.where(nxt > 0, cdf[prev, np.maximum(nxt - 1, 0)], 0.0)
    return torch.tensor((lo + hi) / 2, dtype=torch.float32)


def assert_same_env(ts, js):
    for f in dataclasses.fields(ts.twins):
        close(getattr(ts.twins, f.name), getattr(js.twins, f.name))
    for f in ("loss", "queue", "spent"):
        close(getattr(ts, f), getattr(js, f))
    for f in ("round", "last_action"):
        assert int(getattr(ts, f)) == int(getattr(js, f))
    np.testing.assert_array_equal(ts.channel.numpy(), np.asarray(js.channel))


@pytest.mark.parametrize("calibrate_dt", [True, False])
def test_env_reset_and_steps_match_jax(needs_jax, calibrate_dt):
    """`reset` and eight `step`s from the JAX package's draws, with a
    budget that runs out on the way (``done`` turns over)."""
    jp = jenvs.EnvParams(n_devices=12, horizon=20, budget=30.0,
                         calibrate_dt=calibrate_dt)
    tp = tenvs.EnvParams(**{**jp._asdict(),
                            "channel": tenergy.ChannelParams()})
    key = jax.random.PRNGKey(5)
    js, jobs = jenvs.reset(key, jp)
    _, kd, _, _ = jax.random.split(key, 4)
    draws = tenvs.ResetDraws(
        freq=torch.from_numpy(np.array(js.twins.freq)),
        data_size=torch.from_numpy(np.array(js.twins.data_size)),
        deviation=torch.from_numpy(np.array(jax.random.uniform(
            kd, (12,), minval=0.0, maxval=0.2))),
        channel_u=channel_uniforms(np.zeros(12, int), js.channel, 0.5))
    ts, tobs = tenvs.reset(tp, draws)
    assert torch.isinf(ts.twins.loss).all()
    assert_same_env(ts, js)
    close(tobs, jobs)
    dones = []
    for i, action in enumerate([9, 0, 4, 9, 9, 2, 7, 9]):
        _, kc, kn, ke = jax.random.split(js.key, 4)
        lam = NOISE_MEAN_DB[js.channel]
        sd = tenvs.StepDraws(
            loss_noise=torch.tensor(float(jax.random.normal(kn, ()))),
            comm_noise=torch.from_numpy(np.array(jax.random.poisson(
                ke, lam, js.channel.shape)).astype(np.float32)),
            channel_u=None)
        prev = np.array(js.channel)
        js, jobs, jr, jdone, jinfo = jenvs.step(js, jnp.int32(action), jp)
        sd = sd._replace(channel_u=channel_uniforms(prev, js.channel, 0.5))
        ts, tobs, tr, tdone, tinfo = tenvs.step(ts, torch.tensor(action),
                                                tp, sd)
        assert_same_env(ts, js)
        close(tobs, jobs)
        close(tr, jr)
        assert bool(tdone) == bool(jdone)
        dones.append(bool(tdone))
        for k in jinfo:
            close(tinfo[k], jinfo[k])
    assert dones[0] is False and dones[-1] is True


def test_own_env_draws_follow_their_distributions():
    """The port's reset and step draws: frequencies in [0.5, 2), data
    sizes in [256, 4096), deviations in [0, 0.2), standard normals, and
    the same numbers again for the same (seed, episode, step)."""
    p = tenvs.EnvParams(n_devices=4096)
    d = tenvs.draw_reset(3, 1, p, "cpu")
    assert 0.5 <= float(d.freq.min()) and float(d.freq.max()) < 2.0
    assert 256 <= float(d.data_size.min()) < 300
    assert float(d.data_size.max()) < 4096
    assert abs(float(d.deviation.mean()) - 0.1) < 0.005
    again = tenvs.draw_reset(3, 1, p, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(d, again))
    u = torch.rand((2, 20000), generator=torch.Generator().manual_seed(0))
    z = trng.normal(u[0], u[1])
    assert abs(float(z.mean())) < 0.03 and abs(float(z.std()) - 1) < 0.03


# --------------------------------------------------------------------- #
# Alg. 1 on the environment
# --------------------------------------------------------------------- #
def test_train_on_env_freezes_past_done():
    """A budget so tight every episode ends on its first step: the later
    steps write no replay entry, take no TD step and leave the whole carry
    (agent, replay pointer, step counter, env and its round, which keys
    the draws) as it was."""
    cfg = tdqn.DQNConfig(buffer_size=32, batch_size=8)
    p = tenvs.EnvParams(horizon=8, budget=1e-6)
    agent0 = tdqn.init_dqn(torch.Generator().manual_seed(0), cfg)
    agent, aux = tctl.train_on_env(agent0, cfg, p, episodes=3, seed=1)
    assert aux["ep_len"].tolist() == [1, 1, 1]
    assert int(agent.step) == 3 and int(agent.replay.ptr) == 3

    env, obs = tenvs.reset(p, tenvs.draw_reset(1, 0, p, "cpu"))
    carry = tscan.EpCarry(env=env, obs=obs, done=torch.tensor(False),
                          agent=agent0, ret=torch.tensor(0.0))
    carry = tscan.episode_step(carry, cfg, p,
                               tscan.draw_episode(1, 0, carry, cfg, p))
    assert bool(carry.done) and int(carry.env.round) == 1
    after = tscan.episode_step(carry, cfg, p,
                               tscan.draw_episode(1, 0, carry, cfg, p))
    for a, b in zip(_leaves(after), _leaves(carry), strict=True):
        assert torch.equal(a, b)


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    else:
        for t in tree:
            yield from _leaves(t)


def test_dqn_training_returns_within_jax_band(needs_jax):
    """On its own draws the port's Alg.-1 training earns returns like the
    JAX package's: over seeds 0-3 at the ``adaptive`` preset's settings
    (3 episodes of 20 steps), the mean return of each episode index lies
    within the JAX package's mean +- 3 standard deviations over the same
    seeds plus 0.1, and every episode runs its full length in both."""
    kw = dict(buffer_size=512, batch_size=32, lr=2e-3)
    jp, tp = jenvs.EnvParams(horizon=20), tenvs.EnvParams(horizon=20)
    jr, tr = [], []
    for seed in range(4):
        jcfg, tcfg = jdqn.DQNConfig(**kw), tdqn.DQNConfig(**kw)
        jag = jdqn.init_dqn(jax.random.PRNGKey(seed), jcfg)
        _, jaux = jctl.train_on_env(jax.random.PRNGKey(seed + 1), jag, jcfg,
                                    jp, episodes=3)
        tag = tdqn.init_dqn(torch.Generator().manual_seed(seed), tcfg)
        tag, taux = tctl.train_on_env(tag, tcfg, tp, episodes=3, seed=seed)
        assert int(tag.step) == 60
        assert np.asarray(jaux["ep_len"]).tolist() == [20] * 3
        assert taux["ep_len"].tolist() == [20] * 3
        jr.append(np.asarray(jaux["ep_return"]))
        tr.append(taux["ep_return"].numpy())
    jr, tr = np.stack(jr), np.stack(tr)
    band = 3 * jr.std(0) + 0.1
    assert (np.abs(tr.mean(0) - jr.mean(0)) <= band).all(), (tr, jr)


# --------------------------------------------------------------------- #
# policies
# --------------------------------------------------------------------- #
def test_deploy_obs_distill_and_table_policy_match(needs_jax):
    """`deploy_obs` on live-looking values, the distilled table (exactly)
    and, on grid points, the table policy against the DQN head (after
    tests/test_control.py's table test)."""
    cfg = jdqn.DQNConfig()
    js = jdqn.init_dqn(jax.random.PRNGKey(7), cfg)
    params = tdqn.dqn_params_from_numpy(js.eval_params)
    args = (1.3, 4.5, 0.27, 0.61, 27, [0.5, 0.25, 0.25], 1.1)
    want = jpolicy.deploy_obs(*(jnp.asarray(a, jnp.int32 if i == 4 else
                                            jnp.float32)
                                for i, a in enumerate(args)))
    got = tpolicy.deploy_obs(*(torch.tensor(a) for a in args))
    close(got, want)
    assert got.shape == (48,)

    for bins in ((6, 4, 3), (24, 16, 8)):
        jt = jpolicy.distill_table(js.eval_params, loss_bins=bins[0],
                                   round_bins=bins[1], good_bins=bins[2])
        tt = tpolicy.distill_table(params, loss_bins=bins[0],
                                   round_bins=bins[1], good_bins=bins[2])
        np.testing.assert_array_equal(tt.table.numpy(), np.asarray(jt.table))
        for f in ("loss_grid", "round_grid", "good_grid"):
            close(getattr(tt, f), getattr(jt, f), 1e-6)

    tt = tpolicy.distill_table(params, loss_bins=6, round_bins=4,
                               good_bins=3)
    dqn, tab = tpolicy.dqn_policy(params), tpolicy.table_policy(tt)
    assert dqn.needs_obs and not tab.needs_obs
    for i, loss in enumerate(tt.loss_grid.tolist()):
        for k, good in enumerate(tt.good_grid.tolist()):
            o = tpolicy._grid_obs(torch.tensor(loss), torch.tensor(0.0),
                                  torch.tensor(good), loss_max=2.3,
                                  horizon=100.0)
            obs = tpolicy.CtlObs(
                round=torch.tensor(0), cluster=torch.tensor(0),
                queue=torch.tensor(0.0), cluster_loss=torch.tensor(loss),
                cluster_freq=torch.tensor(1.0), mean_freq=torch.tensor(1.0),
                channel_good_frac=torch.tensor(good),
                energy_used=torch.tensor(0.0), dqn_obs=o)
            a_net, _ = dqn.step(dqn.state, obs)
            a_tab, _ = tab.step(tab.state, obs)
            assert int(a_tab) == int(a_net) == int(tt.table[i, 0, k])


# --------------------------------------------------------------------- #
# the engine with the dqn controller, round by round on injected draws
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def jax_agent():
    """An agent the JAX package pretrained on its DT environment."""
    jcfg = jdqn.DQNConfig(buffer_size=128, batch_size=16, lr=2e-3)
    jag = jdqn.init_dqn(jax.random.PRNGKey(2), jcfg)
    jag, _ = jctl.train_on_env(jax.random.PRNGKey(3), jag, jcfg,
                               jenvs.EnvParams(horizon=10), episodes=2)
    return jag, jcfg


def dqn_pair(execution):
    """JAX and port federations over one spec, one agent (the JAX
    package's) and the same draws."""
    jag, jcfg = jax_agent()
    d = spec_dict({"kind": "dqn", "params": {}}, execution=execution)
    jfed = japi.Federation.from_dict(
        {**d, "controller": {"kind": "dqn", "params": {"agent": jag,
                                                       "dqn_cfg": jcfg}}})
    je = jfed.engine
    tcfg = tdqn.DQNConfig(**jcfg._asdict())
    tag = tdqn.init_dqn(torch.Generator().manual_seed(0), tcfg)
    tag = tag._replace(eval_params=tdqn.dqn_params_from_numpy(
        jag.eval_params))
    # a live agent through the spec, as the JAX package's registry takes it
    tfed = tapi.Federation.from_dict(
        {**d, "controller": {"kind": "dqn", "params": {"agent": tag,
                                                       "dqn_cfg": tcfg}}},
        device="cpu", data=je.data, parts=je.parts, assign=je.assign,
        state=tapi.fleet_state_from_numpy(
            jax.device_get(je.state._replace(key=None)), "cpu"))
    assert tfed.controller.agent is tag
    tfed.engine.draws = JaxDraws(je)
    return jfed, tfed


@pytest.mark.parametrize("execution", ["event", "scanned"])
def test_dqn_engine_round_by_round_on_injected_draws(needs_jax, execution):
    jfed, tfed = dqn_pair(execution)
    # the observation of every cluster before the first round
    for c in range(4):
        close(tfed.engine._ctx(c).obs(), jfed.engine._obs(c))
    if execution == "event":
        jt = jfed.run(eval_every=0.0, max_rounds=12)
        tt = tfed.run(eval_every=0.0, max_rounds=12)
    else:
        jt = jfed.engine.run_scanned(12)
        tt = tfed.engine.run_scanned(12)
    assert len(tt.records) == len(jt.records) >= 12
    for a, b in zip(jt.records, tt.records):
        assert (b.round, b.cluster, b.a, b.agg_count) == \
            (a.round, a.cluster, a.a, a.agg_count)
        np.testing.assert_allclose([b.t, b.loss, b.energy],
                                   [a.t, a.loss, a.energy], rtol=1e-5)
    assert len({r.a for r in tt.records}) > 1       # the policy varies a
    assert_same_state(jfed.engine.state, tfed.engine.state)


@pytest.mark.cuda
def test_dqn_pretrain_on_the_card_matches_cpu():
    """The port's draws are the same on the card and the CPU: the same
    seed pretrains the same agent (to float32 sums taken in another
    order), and the scanned federation launches the fused kernel once a
    round."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    kw = dict(seed=0, episodes=2, horizon=10)
    cpu = tapi.DQNController.pretrain(device="cpu", **kw)
    gpu = tapi.DQNController.pretrain(device="cuda", **kw)
    assert cpu.pretrain_aux["ep_len"].tolist() == \
        gpu.pretrain_aux["ep_len"].cpu().tolist()
    s = torch.randn((64, 48), generator=torch.Generator().manual_seed(1))
    q_cpu = tdqn.q_values(cpu.agent.eval_params, s)
    q_gpu = tdqn.q_values(gpu.agent.eval_params, s.cuda()).cpu()
    np.testing.assert_allclose(q_gpu.numpy(), q_cpu.numpy(), rtol=1e-3,
                               atol=1e-3)
    d = {**spec_dict_plain(), "controller": {"kind": "dqn", "params": kw}}
    reset_launches()
    eng = tapi.Federation.from_dict(d).engine
    eng.run_scanned(6)
    assert launches["trust_aggregate_global"] == 6


@pytest.mark.cuda
def test_dqn_paths_add_no_host_reads_on_the_card():
    """Pretraining reads nothing back to the host, and the DQN policy adds
    no read to a scanned round: `run_scanned` synchronises as often under
    the DQN as under a fixed controller (once a round for ``a``, once at
    the end), counted by PyTorch's sync debug mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    import warnings

    def syncs(fn):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # (the mode's own notice that it is a prototype is not a sync)
        return sum("called a synchronizing" in str(w.message)
                   for w in seen)

    ctl = tapi.DQNController.pretrain(device="cuda", episodes=1, horizon=3)
    cfg, p = ctl.cfg, tenvs.EnvParams(horizon=10)
    agent = tdqn.init_dqn(torch.Generator().manual_seed(1), cfg, "cuda")
    assert syncs(lambda: tctl.train_on_env(agent, cfg, p, episodes=2)) == 0
    counts = {}
    for name, controller in (("dqn", {"kind": "dqn", "params": {
            "agent": ctl.agent, "dqn_cfg": cfg}}), ("fixed", {
                "kind": "fixed", "params": {"a": 3}})):
        eng = tapi.Federation.from_dict(
            {**spec_dict_plain(), "controller": controller}).engine
        eng.run_scanned(2, eval_final=False)              # warm-up
        counts[name] = syncs(lambda: eng.run_scanned(5, eval_final=False))
    assert counts["dqn"] == counts["fixed"] > 0, counts


def spec_dict_plain():
    return dict(fleet={"n_devices": 16}, clustering={"n_clusters": 4},
                task={"kind": "mlp", "params": {"n_samples": 1024, "dim": 32,
                                                "hidden": 16}},
                local_batch=16, sim_seconds=1e9)
