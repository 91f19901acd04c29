"""The port's federated LM training against the JAX package: the
optimizers, one mode-A and one mode-B step of `repro_torch.core.fl_step`
on carried-over state and the same tokens, the step's properties
(`tests/test_fl_step.py`'s), the datacenter engine through
`Federation.from_spec`, the spec checks and the two CLIs.

Inputs are drawn from seeds with numpy and handed to both packages.  The
JAX step is compiled once per mode, in a module fixture.  Tolerances:
the optimizers 1e-6 relative to each leaf's largest entry (float32 ops in
the same order; XLA may fuse them into FMAs); a whole step 1e-5 relative
to each leaf's largest entry (its gradients sum over the sequence in
another order, and the JAX package's jnp scan and attention against the
port's plain versions differ by float32 rounding), the losses 1e-5
relative, the trust weights 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (ClusteringSpec, ControllerSpec,  # noqa: E402
                             Federation, FederationSpec, FleetSpec,
                             TaskSpec, DATACENTER_SCALE)
from repro_torch.api import run as torch_run  # noqa: E402
from repro_torch.api.spec import unported  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import fl_step as tfl  # noqa: E402
from repro_torch.launch import train as torch_train  # noqa: E402
from repro_torch.models import ArchConfig as TArchConfig  # noqa: E402
from repro_torch.models import LM, weighted_lm_loss  # noqa: E402
from repro_torch import optim as topt  # noqa: E402

try:            # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core import fl_step as jfl
    from repro.optim import optimizers as jopt
except ImportError:
    jax = None

NC, C, N_MICRO, BM = 2, 2, 2, 1
# local steps a and sequence length of the compared step: mode A's 96
# tokens pass the window of 64; mode B's a = 1 and 32 tokens spare JAX
# compile time (the local-step scan, a shorter unrolled RG-LRU scan)
LOCAL_STEPS = {tfl.MODE_A: 2, tfl.MODE_B: 1}
SEQ = {tfl.MODE_A: 96, tfl.MODE_B: 32}


@pytest.fixture(scope="module")
def needs_jax():
    if jax is None:
        pytest.skip("the JAX package is not installed")


def _rg3(get):
    """recurrentgemma-2b's smoke config cut to one Griffin period (RG-LRU,
    RG-LRU, local attention with window 64)."""
    return dataclasses.replace(get("recurrentgemma-2b"), num_layers=3)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want), initial=0.0)
                 / (np.max(np.abs(want), initial=0.0) + 1e-30))


def _max_rel(got, want):
    """Largest `_rel` over the leaves of two nested trees."""
    if isinstance(want, dict):
        return max([_max_rel(got[k], want[k]) for k in want], default=0.0)
    if isinstance(want, (list, tuple)):
        return max([_max_rel(g, w) for g, w in zip(got, want)], default=0.0)
    return _rel(got, want)


# --------------------------------------------------------------------- #
# optimizers, leaf for leaf
# --------------------------------------------------------------------- #
OPTIMIZERS = [("sgd", {}), ("sgd", {"momentum": 0.9}), ("adam", {}),
              ("adamw", {}), ("adafactor", {})]


@pytest.mark.parametrize("name,kw", OPTIMIZERS)
def test_optimizers_match_the_jax_package(needs_jax, name, kw):
    g = np.random.default_rng(3)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 3, 4)}
    params = {k: g.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jo = jopt.REGISTRY[name](1e-2, **kw)
    to = topt.REGISTRY[name](1e-2, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(4):
        grads = {k: g.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        ju, js = jo.update({k: jnp.asarray(v) for k, v in grads.items()},
                           js, jp)
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in
                            grads.items()}, ts, tp)
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
        for k in shapes:
            assert _rel(tp[k], jp[k]) < 1e-6, (name, k)
            assert _rel(tu[k], ju[k]) < 1e-6, (name, k)
    if isinstance(ts, dict) and "t" in ts:
        assert int(ts["t"]) == int(js["t"]) == 4


def test_global_norm_and_clipping_match_the_jax_package(needs_jax):
    g = np.random.default_rng(4)
    tree = {"a": g.standard_normal((4, 3)).astype(np.float32) * 3,
            "b": g.standard_normal((5,)).astype(np.float32)}
    jn = jopt.global_norm({k: jnp.asarray(v) for k, v in tree.items()})
    tn = topt.global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    jc, _ = jopt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in tree.items()}, 1.0)
    tc, _ = topt.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in tree.items()}, 1.0)
    for k in tree:
        assert _rel(tc[k], jc[k]) < 1e-6


# --------------------------------------------------------------------- #
# one federated step against the JAX package's
# --------------------------------------------------------------------- #
def _state_and_batch(params_tree, mode, seed, vocab=512, books=1,
                     seq=None):
    """Per-client perturbed parameters, Adam moments of a few steps, and a
    token batch of ids below ``vocab``, as numpy: (..., Bm, seq) tokens,
    or (..., Bm, books, seq) for an audio model's codebooks."""
    g = np.random.default_rng(seed)
    pert = lambda x: (np.asarray(x) + g.standard_normal(x.shape) * 0.01
                      ).astype(np.float32)
    lead = (NC, C) if mode == tfl.MODE_A else (NC,)
    params = jax.tree.map(pert, params_tree)
    m = jax.tree.map(lambda x: (g.standard_normal(x.shape) * 1e-3
                                ).astype(np.float32), params_tree)
    v = jax.tree.map(lambda x: (g.random(x.shape) * 1e-5
                                ).astype(np.float32), params_tree)
    state = {"params": params,
             "opt": {"m": m, "v": v, "t": np.full(lead, 3, np.int32)},
             "round": 0}
    seq = SEQ[mode] if seq is None else seq
    shape = lead + (N_MICRO, BM) + ((books,) if books > 1 else ()) + (
        seq + 1,)
    toks = g.integers(0, vocab, shape)
    batch = {"tokens": toks[..., :-1].astype(np.int32),
             "labels": toks[..., 1:].astype(np.int32)}
    if mode == tfl.MODE_B:
        batch["weights"] = (g.random((NC, N_MICRO, BM)) + 0.5
                            ).astype(np.float32)
    rep = (g.random((NC, C)) + 0.1).astype(np.float32)
    stale = np.asarray([0.0, 2.0], np.float32)
    return state, batch, rep, stale


def _jax_step(mode, seed):
    cfg = _rg3(jax_smoke_config)
    opt = jopt.adam(3e-4)
    init = jfl.build_init_fn(cfg, opt, mode=mode, n_clusters=NC,
                             clients_per_cluster=C)
    fresh = init(jax.random.PRNGKey(seed))
    state, batch, rep, stale = _state_and_batch(fresh.params, mode, seed)
    js = jfl.TrainState(jax.tree.map(jnp.asarray, state["params"]),
                        jax.tree.map(jnp.asarray, state["opt"]),
                        jnp.zeros((), jnp.int32))
    step = jax.jit(jfl.build_train_step(cfg, opt, mode=mode,
                                        local_steps=LOCAL_STEPS[mode]))
    out, metrics = step(js, jax.tree.map(jnp.asarray, batch),
                        jnp.asarray(rep), jnp.asarray(stale))
    return {"inputs": (state, batch, rep, stale),
            "params": jax.tree.map(np.asarray, out.params),
            "opt": jax.tree.map(np.asarray, out.opt),
            "round": int(out.round),
            "metrics": {k: np.asarray(v) for k, v in metrics.items()}}


def _torch_step(mode, ref):
    cfg = _rg3(get_smoke_config)
    state, batch, rep, stale = ref["inputs"]
    ts = tfl.train_state_from_numpy(state, cfg, mode=mode, device="cpu")
    tb = {k: torch.from_numpy(np.asarray(v, np.int64 if k != "weights"
                                         else np.float32))
          for k, v in batch.items()}
    step = tfl.build_train_step(cfg, topt.adam(3e-4), mode=mode,
                                local_steps=LOCAL_STEPS[mode])
    out, metrics = step(ts, tb, torch.from_numpy(rep),
                        torch.from_numpy(stale))
    return tfl.train_state_to_numpy(out, cfg, mode=mode), metrics


@pytest.fixture(scope="module")
def mode_a(needs_jax):
    return _jax_step(jfl.MODE_A, seed=0)


@pytest.fixture(scope="module")
def mode_b(needs_jax):
    return _jax_step(jfl.MODE_B, seed=1)


def test_mode_a_step_matches_the_jax_package(mode_a):
    """One step, a = 2 local Adam steps of 2 microbatches per client, NC 2 x
    C 2: parameters, Adam m, v and t, loss, divergence, trust weights."""
    got, metrics = _torch_step(tfl.MODE_A, mode_a)
    assert _max_rel(got["params"], mode_a["params"]) < 1e-5
    assert _max_rel(got["opt"]["m"], mode_a["opt"]["m"]) < 1e-5
    assert _max_rel(got["opt"]["v"], mode_a["opt"]["v"]) < 1e-5
    np.testing.assert_array_equal(got["opt"]["t"], mode_a["opt"]["t"])
    assert got["round"] == mode_a["round"] == 1
    jm = mode_a["metrics"]
    np.testing.assert_allclose(metrics["loss"].numpy(), jm["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["divergence"].numpy(),
                               jm["divergence"], rtol=1e-5)
    np.testing.assert_allclose(metrics["trust_weights"].numpy(),
                               jm["trust_weights"], rtol=1e-6)


def test_mode_b_step_matches_the_jax_package(mode_b):
    """One mode-B step (trust as per-example loss weights, a = 1, 2
    microbatches of 32 tokens, NC 2): parameters, Adam m, v and t, loss."""
    got, metrics = _torch_step(tfl.MODE_B, mode_b)
    assert _max_rel(got["params"], mode_b["params"]) < 1e-5
    assert _max_rel(got["opt"]["m"], mode_b["opt"]["m"]) < 1e-5
    assert _max_rel(got["opt"]["v"], mode_b["opt"]["v"]) < 1e-5
    np.testing.assert_array_equal(got["opt"]["t"], mode_b["opt"]["t"])
    np.testing.assert_allclose(metrics["loss"].numpy(),
                               mode_b["metrics"]["loss"], rtol=1e-5)


def test_carried_state_round_trips(mode_a):
    state = mode_a["inputs"][0]
    cfg = _rg3(get_smoke_config)
    ts = tfl.train_state_from_numpy(state, cfg, mode=tfl.MODE_A)
    back = tfl.train_state_to_numpy(ts, cfg, mode=tfl.MODE_A)
    assert _max_rel(back["params"], state["params"]) == 0.0
    assert _max_rel(back["opt"], state["opt"]) == 0.0


# --------------------------------------------------------------------- #
# the step's properties (tests/test_fl_step.py)
# --------------------------------------------------------------------- #
CFG = TArchConfig(name="t", arch_type="dense", num_layers=2, d_model=32,
                  vocab_size=64, num_heads=2, num_kv_heads=1, d_ff=64)


def _batch_a(C=4, n_micro=2, bm=2, seq=8):
    g = torch.Generator().manual_seed(0)
    t = torch.randint(0, 64, (1, C, n_micro, bm, seq), generator=g)
    return {"tokens": t, "labels": (t + 1) % 64}


def test_mode_a_params_synced_after_step():
    opt = topt.sgd(0.05)
    state = tfl.build_init_fn(CFG, opt, mode=tfl.MODE_A, n_clusters=1,
                              clients_per_cluster=4, device="cpu")(0)
    step = tfl.build_train_step(CFG, opt, mode=tfl.MODE_A)
    state, _ = step(state, _batch_a(), torch.ones((1, 4)), torch.zeros((1,)))
    for leaf in state.params.values():
        torch.testing.assert_close(leaf[0, 0], leaf[0, 3], rtol=0, atol=0)


def test_mode_a_trust_weights_bias_aggregate():
    """A client with all the trust moves the aggregate."""
    opt = topt.sgd(0.5)
    init = tfl.build_init_fn(CFG, opt, mode=tfl.MODE_A, n_clusters=1,
                             clients_per_cluster=2, device="cpu")
    step = tfl.build_train_step(CFG, opt, mode=tfl.MODE_A)
    batch = _batch_a(C=2)
    s_eq, _ = step(init(0), batch, torch.tensor([[1.0, 1.0]]),
                   torch.zeros((1,)))
    s_0, _ = step(init(0), batch, torch.tensor([[1.0, 0.0]]),
                  torch.zeros((1,)))
    d = sum(float((s_eq.params[k] - s_0.params[k]).abs().sum())
            for k in s_eq.params)
    assert d > 0


def test_eqn19_fresh_cluster_dominates():
    params = {"w": torch.stack([torch.zeros((3,)), torch.ones((3,))])}
    fresh_first = tfl.inter_cluster_agg(params, torch.tensor([0.0, 5.0]))
    fresh_second = tfl.inter_cluster_agg(params, torch.tensor([5.0, 0.0]))
    assert float(fresh_first["w"][0]) < 0.3
    assert float(fresh_second["w"][0]) > 0.7


def test_mode_b_weighted_equals_manual_fedsgd():
    """Mode B with a = 1: the trust-weighted loss's step is trust-weighted
    FedSGD."""
    opt = topt.sgd(0.1)
    state = tfl.build_init_fn(CFG, opt, mode=tfl.MODE_B, n_clusters=1,
                              device="cpu")(0)
    p0 = {k: v[0].clone() for k, v in state.params.items()}
    g = torch.Generator().manual_seed(1)
    t = torch.randint(0, 64, (1, 1, 4, 8), generator=g)
    w = torch.tensor([[[0.5, 0.25, 0.25, 0.0]]]) * 4.0
    batch = {"tokens": t, "labels": (t + 1) % 64, "weights": w}
    step = tfl.build_train_step(CFG, opt, mode=tfl.MODE_B)
    s2, _ = step(state, batch, torch.ones((1, 1)), torch.zeros((1,)))
    model = LM(CFG, device="meta", seed=None)
    leaves = {k: v.clone().requires_grad_() for k, v in p0.items()}
    loss = weighted_lm_loss(model, {"tokens": t[0, 0],
                                    "labels": (t[0, 0] + 1) % 64},
                            w[0, 0], params=leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for (k, p), gg in zip(p0.items(), grads):
        torch.testing.assert_close(s2.params[k][0], p - 0.1 * gg,
                                   rtol=0, atol=1e-5)


def test_client_divergence_zero_for_identical():
    d = tfl.client_divergence({"w": torch.ones((1, 4, 8))})
    torch.testing.assert_close(d, torch.zeros((1, 4)), rtol=0, atol=1e-6)


# --------------------------------------------------------------------- #
# the datacenter engine, the spec checks and the CLIs
# --------------------------------------------------------------------- #
def _datacenter_spec(**kw):
    base = dict(scale=DATACENTER_SCALE, fleet=FleetSpec(n_devices=4),
                clustering=ClusteringSpec(n_clusters=2),
                controller=ControllerSpec("fixed", {"a": 1, "n_actions": 2}),
                task=TaskSpec("lm", {"seq": 8, "micro_batch": 2}), rounds=2)
    base.update(kw)
    return FederationSpec(**base)


def test_datacenter_scale_runs_and_records():
    """`tests/test_api.py`'s datacenter check on the port."""
    fed = Federation.from_spec(_datacenter_spec(), device="cpu")
    trace = fed.run()
    assert len(trace.records) == 2
    assert all(np.isfinite(r.loss) for r in trace.records)
    assert [r.cluster for r in trace.records] == [-1, -1]
    assert trace.records[0].acc is None and trace.records[-1].energy == 0.0
    with pytest.raises(ValueError, match="no scanned lowering"):
        fed.run_scanned(2)


def test_lm_mode_a_scenario_cli_runs(capsys):
    assert torch_run.main(["--scenario", "lm-modeA", "--rounds", "2",
                           "--device", "cpu"]) == 0
    rows = [r for r in capsys.readouterr().out.splitlines()
            if r.strip().startswith(("0.00,", "1.00,"))]
    assert len(rows) == 2


@pytest.mark.parametrize("override,message", [
    ({"privacy": {"clip": 1.0, "noise": 0.5}},
     "privacy (DP) is not implemented at datacenter scale"),
    ({"aggregator": {"kind": "krum"}},
     "aggregator 'krum' is not supported at datacenter scale"),
    ({"execution": "scanned"}, "execution='scanned' is device-scale only"),
])
def test_datacenter_checks_of_validate(override, message):
    spec = FederationSpec.from_dict({**_datacenter_spec().to_dict(),
                                     **override})
    with pytest.raises(ValueError) as e:
        spec.validate()
    assert message in str(e.value)


def test_scenario_cli_exits_2_on_a_datacenter_robust_rule(capsys):
    assert torch_run.main(["--scenario", "lm-modeA", "--device", "cpu",
                           "--aggregator", "krum"]) == 2
    assert ("error: aggregator 'krum' is not supported at datacenter scale"
            in capsys.readouterr().err)


def test_lm_task_on_the_device_scale_is_rejected():
    spec = FederationSpec(task=TaskSpec("lm", {}))
    with pytest.raises(ValueError, match="datacenter-scale"):
        spec.validate()


@pytest.mark.parametrize("params", [
    {"arch": "falcon-mamba-7b"},
    {"arch_type": "ssm", "block_pattern": ["mamba"], "ssm_state": 4},
])
def test_mamba_layers_train_at_the_datacenter_scale(params):
    """MAMBA layers train since the selective scan has a backward kernel:
    the specs the port once refused now pass `unported()` and
    `validate()`."""
    spec = _datacenter_spec(task=TaskSpec("lm", params))
    assert unported(spec) is None
    spec.validate()


@pytest.mark.parametrize("params", [
    {"num_experts": 4, "topk": 2, "moe_d_ff": 16},
    {"use_mla": True, "kv_lora_rank": 8, "qk_nope_dim": 8, "qk_rope_dim": 8,
     "v_head_dim": 8},
    {"arch": "musicgen-large"},
    {"arch": "grok-1-314b", "mode": "trust_fsdp"},
    {"arch": "deepseek-v2-236b", "mode": "trust_fsdp"},
])
def test_moe_mla_and_audio_layers_train_at_the_datacenter_scale(params):
    """MoE, MLA and audio-codebook models train since their backward is
    ported: the specs the port once refused pass `unported()` and
    `validate()`, and one round through `Federation.from_spec` records a
    finite loss (the audio model's batches carry its codebooks)."""
    spec = _datacenter_spec(task=TaskSpec("lm", params), rounds=1)
    assert unported(spec) is None
    spec.validate()
    trace = Federation.from_spec(spec, device="cpu").run()
    assert len(trace.records) == 1 and np.isfinite(trace.records[0].loss)


def test_train_cli_runs_on_the_cpu(capsys, tmp_path):
    torch_train.main(["--device", "cpu", "--steps", "2",
                      "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "step,a_i,loss,queue,seconds"
    assert [r.split(",")[0] for r in out[1:3]] == ["0", "1"]
    assert out[3].startswith("saved,")
