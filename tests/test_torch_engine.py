"""The port's device-scale federation against the JAX package's, end to end.

Parity: both engines start from the same data, partition, assignment and
initial `FleetState`, and the port's per-round draws are replaced by the
JAX package's own (derived from its state key exactly as
``repro/api/engine.py:488-492`` does).  Cluster, ``a`` and round must then
match exactly; loss, energy and accuracy within 1e-5 relative, and the
final reputations, twins and models within 1e-5 (float32 sums taken in
another order).  On its own randomness the port must land in the JAX
package's accuracy band.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api as tapi  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402

try:            # the card's machine has no JAX: only the cuda test runs there
    import jax
    import jax.numpy as jnp
    from repro import api as japi
    from repro.core.energy import NOISE_MEAN_DB, step_channel
    from repro.data.federated import sample_member_batch
    from repro.faults import model as jfaults
except ImportError:
    jax = None

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("the JAX package is not installed")


def spec_dict(controller, *, execution="event", seed=0, lr=0.1,
              aggregator=None):
    return dict(fleet={"n_devices": 16}, clustering={"n_clusters": 4},
                controller=controller,
                aggregator=aggregator or {"kind": "trust"},
                task={"kind": "mlp", "params": {"n_samples": 1024, "dim": 32,
                                                "hidden": 16}},
                local_batch=16, seed=seed, lr=lr, execution=execution,
                sim_seconds=1e9)


FIXED = {"kind": "fixed", "params": {"a": 5}}
LYAPUNOV = {"kind": "lyapunov", "params": {"budget": 400, "horizon": 30}}


class JaxDraws:
    """The JAX engine's draws for the port's round: the state key of round
    r is the first of ``split(key_{r-1}, 5)`` (6 with an active fault
    spec), whatever cluster ran.  The DP normals come from ``kdp``, one
    key a leaf, and the fault draws from ``kflt`` through the JAX fault
    model's own keys, all flattened in the port's sorted-leaf layout."""

    def __init__(self, jeng):
        self.jeng = jeng
        self.keys = [jeng.state.key]
        self.n_keys = 6 if jeng.faults.active else 5

    def __call__(self, state, members):
        r = int(state.round)
        while len(self.keys) <= r:
            self.keys.append(jax.random.split(self.keys[-1],
                                              self.n_keys)[0])
        ks = jax.random.split(self.keys[r], self.n_keys)
        kb, ke, kc2, kdp = ks[1], ks[2], ks[3], ks[4]
        je = self.jeng
        m = jnp.asarray(members.cpu().numpy().astype(np.int32))
        sel = sample_member_batch(kb, je._part_idx, je._part_len, m,
                                  je.spec.local_batch)
        ch = jnp.asarray(state.channel.cpu().numpy().astype(np.int32))
        lam = NOISE_MEAN_DB[ch.at[m].get(mode="fill", fill_value=0)]
        noise = jax.vmap(lambda mm, l: jax.random.poisson(
            jax.random.fold_in(ke, mm), l, ()))(m, lam)
        nxt = step_channel(kc2, ch, je._trans)
        as_t = lambda a, dt: torch.from_numpy(np.array(a).astype(dt))
        extra = {}
        shapes = [np.shape(v) for _, v in
                  sorted(je.state.global_params.items())]
        if je.spec.privacy.clip > 0.0:
            extra["dp_normal"] = as_t(np.concatenate([
                np.ravel(jax.random.normal(k, sh, jnp.float32))
                for k, sh in zip(jax.random.split(kdp, len(shapes)),
                                 shapes)]), np.float32)
        fm = je.faults
        if fm.active:
            kflt = ks[5]
            for on, name, tag in ((fm.may_drop, "drop_u", jfaults._TAG_DROP),
                                  (fm.may_straggle, "straggle_u",
                                   jfaults._TAG_STRAGGLE),
                                  (fm.may_spike, "spike_u",
                                   jfaults._TAG_SPIKE)):
                if on:
                    extra[name] = as_t(jfaults._member_uniform(
                        fm._key(kflt, tag), m), np.float32)
            if fm.may_corrupt and fm.spec.corrupt_mode == "gaussian":
                kc = fm._key(kflt, jfaults._TAG_CORRUPT)
                rows = []
                for i, sh in enumerate(shapes):
                    ki = jax.random.fold_in(kc, i)
                    rows.append(np.asarray(jax.vmap(
                        lambda mm: jax.random.normal(
                            jax.random.fold_in(ki, mm), sh,
                            jnp.float32))(m)).reshape(len(m), -1))
                extra["corrupt_normal"] = as_t(np.concatenate(rows, 1),
                                               np.float32)
        return tapi.RoundDraws(sel=as_t(sel, np.int64),
                               noise=as_t(noise, np.float32),
                               channel=as_t(nxt, np.int64), **extra)


def build_pair(d):
    jfed = japi.Federation.from_dict(d)
    tfed = mirror_jax_federation(jfed, tapi.FederationSpec.from_dict(d))
    return jfed, tfed


def mirror_jax_federation(jfed, spec, **kw):
    """The port's federation of ``spec`` on the JAX federation's data,
    partition, assignment, initial state, label flippers and poison
    patterns, with the JAX engine's draws injected; ``kw`` (a controller)
    passes through to `Federation.from_spec`."""
    je = jfed.engine
    state = jax.device_get(je.state._replace(key=None))
    tfed = tapi.Federation.from_spec(
        spec, device="cpu", data=je.data, parts=je.parts, assign=je.assign,
        state=tapi.fleet_state_from_numpy(state, "cpu"), **kw)
    tfed.engine.draws = JaxDraws(je)
    te = tfed.engine
    if je.malicious.any():          # the JAX package's label flippers
        te.malicious = je.malicious.copy()
        te._malicious_dev = torch.as_tensor(je.malicious,
                                            dtype=torch.float32)
        te._misbehaving_dev = torch.maximum(te._malicious_dev, torch.maximum(
            te.faults.corrupt_dev, te.faults.poison_dev))
    if je.faults.may_poison:        # the JAX fault model's frozen patterns
        feat = je._x.shape[-1]
        tfed.engine.faults.patterns = torch.from_numpy(np.array(
            jax.random.normal(jax.random.PRNGKey(
                je.faults._seed * 2654435761 % (2 ** 31)),
                (je.faults.n + 1, feat), jnp.float32)))
    return tfed


def assert_same_trace(jt, tt, n_records):
    """Scheduling and counters exactly; t, loss and energy within 1e-5
    relative; accuracy within 1e-5."""
    assert len(tt.records) == len(jt.records) == n_records
    for a, b in zip(jt.records, tt.records):
        assert (b.round, b.cluster, b.a, b.agg_count) == \
            (a.round, a.cluster, a.a, a.agg_count)
        np.testing.assert_allclose([b.t, b.loss, b.energy],
                                   [a.t, a.loss, a.energy], rtol=1e-5)
        assert (a.acc is None) == (b.acc is None)
        if a.acc is not None:
            assert abs(a.acc - b.acc) < 1e-5


def run_pair(d, execution, rounds=12):
    """Both federations of ``build_pair(d)`` over ``rounds`` rounds of
    ``execution``; their traces and final states must agree."""
    jfed, tfed = build_pair(d)
    if execution == "event":
        jt = jfed.run(eval_every=0.0, max_rounds=rounds)
        tt = tfed.run(eval_every=0.0, max_rounds=rounds)
    else:
        jt = jfed.engine.run_scanned(rounds)
        tt = tfed.engine.run_scanned(rounds)
    assert_same_trace(jt, tt, rounds + (execution == "scanned"))
    assert_same_state(jfed.engine.state, tfed.engine.state)
    return jfed, tfed, jt, tt


def assert_same_state(js, ts, tol=1e-5):
    close = lambda got, want: np.testing.assert_allclose(
        got.cpu().numpy(), np.asarray(want), rtol=tol, atol=tol)
    close(ts.rep, js.rep)
    np.testing.assert_array_equal(ts.channel.numpy(), np.asarray(js.channel))
    for f in dataclasses.fields(ts.twins):
        close(getattr(ts.twins, f.name), getattr(js.twins, f.name))
    close(ts.global_flat, np.concatenate(
        [np.asarray(js.global_params[k]).ravel()
         for k in sorted(js.global_params)]))
    C = ts.cluster_flat.shape[0]
    close(ts.cluster_flat, np.concatenate(
        [np.asarray(js.cluster_params[k]).reshape(C, -1)
         for k in sorted(js.cluster_params)], axis=1))
    close(ts.cluster_ts, js.cluster_ts)
    close(ts.queue, js.queue)
    assert int(ts.round) == int(js.round)


@pytest.mark.parametrize("controller,execution,aggregator", [
    (FIXED, "event", None), (LYAPUNOV, "event", None),
    (LYAPUNOV, "scanned", None),
    (FIXED, "scanned", {"kind": "fedavg"}),
    # the JAX package takes its two-step jnp path for this spec; the port
    # ignores the flag and runs its fused kernel to the same state
    (FIXED, "event", {"kind": "trust", "use_kernel": False})],
    ids=["fixed-event", "lyapunov-event", "lyapunov-scanned",
         "fedavg-scanned", "jax-two-step-event"])
def test_round_by_round_parity_on_injected_draws(needs_jax, controller,
                                                 execution, aggregator):
    jfed, tfed, _, _ = run_pair(spec_dict(controller, execution=execution,
                                          aggregator=aggregator), execution)
    if controller is LYAPUNOV:
        assert abs(float(tfed.controller.queue.q)
                   - float(jfed.controller.queue.q)) < 1e-4


def test_run_scanned_continues_across_calls():
    d = spec_dict(LYAPUNOV)
    once = tapi.Federation.from_dict(d, device="cpu").engine
    twice = tapi.Federation.from_dict(d, device="cpu").engine
    a = once.run_scanned(10, eval_final=False).records
    b = (twice.run_scanned(4, eval_final=False).records
         + twice.run_scanned(6, eval_final=False).records)
    assert [dataclasses.asdict(r) for r in a] == \
        [dataclasses.asdict(r) for r in b]
    assert torch.equal(once.state.global_flat, twice.state.global_flat)


def test_accuracy_within_jax_band_over_seeds(needs_jax):
    """On its own randomness (counter-based draws, torch generators) the
    port learns as the JAX package does: over seeds 0-2 its mean final
    accuracy is within 0.05 of the JAX package's and no run falls more
    than 0.1 below the JAX package's worst."""
    jax_acc, port_acc = [], []
    for seed in range(3):
        d = spec_dict({"kind": "fixed", "params": {"a": 8}}, seed=seed,
                      lr=0.3)
        jax_acc.append(japi.Federation.from_dict(d).engine.run_scanned(
            40).records[-1].acc)
        port_acc.append(tapi.Federation.from_dict(d, device="cpu").engine
                        .run_scanned(40).records[-1].acc)
    assert abs(np.mean(port_acc) - np.mean(jax_acc)) <= 0.05, (port_acc,
                                                                jax_acc)
    assert min(port_acc) >= min(jax_acc) - 0.1, (port_acc, jax_acc)


def test_spec_dict_and_trace_jsonl_roundtrip_across_packages(needs_jax,
                                                             tmp_path):
    jspec = japi.FederationSpec.from_dict(spec_dict(LYAPUNOV))
    tspec = tapi.FederationSpec.from_dict(jspec.to_dict())
    assert tspec.to_dict() == jspec.to_dict()
    assert japi.FederationSpec.from_dict(tspec.to_dict()) == jspec
    assert tapi.FederationSpec().to_dict() == japi.FederationSpec().to_dict()
    trace = tapi.Federation.from_spec(tspec, device="cpu").engine \
        .run_scanned(3)
    path = str(tmp_path / "trace.jsonl")
    with tapi.JsonlSink(path) as sink:
        for rec in trace.records:
            sink.append(rec)
    from repro.api.records import read_jsonl_trace as jax_read
    back = jax_read(path)
    assert back.to_dicts() == trace.to_dicts()
    assert tapi.read_jsonl_trace(path).to_dicts() == trace.to_dicts()


@pytest.mark.parametrize("change", [
    # the partitioner-inferred placement runs since its slice: mesh (2,)
    # under a 2-rank launch (tests/test_torch_gspmd.py), mesh (1,) here
    {"sharding": {"mesh": [1], "impl": "gspmd"}},
    # and its scale
    {"scale": "device-gspmd"},
])
def test_gspmd_specs_build_and_run(change):
    """Both specs the port refused before its partitioner-inferred
    placement build and run to the unsharded engine's records."""
    d = spec_dict(FIXED)
    d.update(change)
    fed = tapi.Federation.from_dict(d, device="cpu")
    assert type(fed.engine).__name__ == (
        "DeviceScaleGspmdEngine" if "scale" in change
        else "DeviceScaleEngine")
    ref = tapi.Federation.from_dict(spec_dict(FIXED), device="cpu")
    assert fed.run(eval_every=0.0, max_rounds=3).to_dicts() == \
        ref.run(eval_every=0.0, max_rounds=3).to_dicts()


@pytest.mark.parametrize("change", [
    {"aggregator": {"kind": "krum", "params": {}}},
    {"aggregator": {"kind": "median", "params": {}}},
    {"faults": {"straggler_frac": 0.3}},
    {"privacy": {"clip": 1.0, "noise": 0.1}},
    {"faults": {"dropout": 0.2}},
], ids=["krum", "median", "straggler", "privacy", "dropout"])
def test_formerly_unported_features_build_and_run(change):
    """The robust rules, DP and the fault model build and run on the CPU
    (they raised until the port ran them)."""
    d = spec_dict(FIXED)
    d.update(change)
    fed = tapi.Federation.from_dict(d, device="cpu")
    records = fed.run(max_rounds=3).records
    assert records and all(np.isfinite(r.loss) for r in records)
    assert int(fed.engine.state.round) == 3


def test_bare_spec_runs_through_the_default_dqn():
    """A bare `FederationSpec()` (controller ``dqn``, task ``mlp``) builds
    and runs on the CPU: the registry pretrains the DQN on the DT
    environment, on both entry points."""
    spec = tapi.FederationSpec().validate()
    fed = tapi.Federation.from_spec(spec, device="cpu")
    assert isinstance(fed.controller, tapi.DQNController)
    assert fed.controller.pretrain_aux["ep_return"].shape == (4,)
    event = fed.run(max_rounds=3)
    scanned = fed.run_scanned(3)
    records = event.records + scanned.records
    assert records and all(np.isfinite(r.loss) for r in records)
    assert all(1 <= r.a <= 10 for r in records)


def test_round_leaves_its_input_state_unchanged():
    """`_fleet_round` is pure, as the JAX package's is: every tensor of
    the state it was handed is unchanged after the round, and the new
    cluster stack shares no storage with the old one."""
    d = spec_dict(FIXED)
    d.update(fleet={"n_devices": 32}, clustering={"n_clusters": 4})
    eng = tapi.Federation.from_dict(d, device="cpu").engine
    before = {k: v.clone() for k, v in eng.state.tensors().items()}
    old = eng.state
    new, _ = eng._fleet_round(old, eng._cidx[1], 5)
    for k, v in old.tensors().items():
        assert torch.equal(v, before[k]), k
    assert not torch.equal(new.cluster_flat, old.cluster_flat)
    assert new.cluster_flat.untyped_storage().data_ptr() != \
        old.cluster_flat.untyped_storage().data_ptr()


def test_run_scanned_needs_a_scan_policy():
    class HostOnly:
        needs_ctx = False
        n_actions = 10

        def select(self, ctx):
            return 3

        def observe(self, ctx, consumed, loss):
            pass

    fed = tapi.Federation.from_dict(spec_dict(FIXED), device="cpu",
                                    controller=HostOnly())
    assert fed.run(max_rounds=2).records
    with pytest.raises(ValueError, match="no scan_policy"):
        fed.run_scanned(2)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert tapi.resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.Federation.from_dict(spec_dict(FIXED))
    assert tapi.resolve_device("cpu").type == "cpu"


def test_import_pulls_in_no_jax():
    code = ("import sys, repro_torch, repro_torch.api, repro_torch.kernels, "
            "repro_torch.models, repro_torch.configs, "
            "repro_torch.launch.serve, repro_torch.core.async_fl, "
            "repro_torch.configs.paper_mnist, repro_torch.paper, "
            "repro_torch.paper.figures, repro_torch.paper.robustness, "
            "repro_torch.paper.__main__, repro_torch.optim, "
            "repro_torch.core.fl_step, repro_torch.models.lm, "
            "repro_torch.launch.train, repro_torch.api.placement, "
            "repro_torch.api.cluster_engine, "
            "repro_torch.launch.distributed;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro'];"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.cuda
def test_engine_on_the_card_matches_cpu_and_launches_kernel():
    """The same spec on the card and on the CPU, on the port's own
    randomness (identical draws on both): scheduling and ``a`` match
    exactly, losses within 1e-3, and every round launched the fused
    kernel on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    d = spec_dict(LYAPUNOV)
    cpu = tapi.Federation.from_dict(d, device="cpu").engine.run_scanned(8)
    reset_launches()
    eng = tapi.Federation.from_dict(d).engine
    gpu = eng.run_scanned(8)
    assert launches["trust_aggregate_global"] == 8
    for a, b in zip(cpu.records, gpu.records):
        assert (a.round, a.cluster, a.a) == (b.round, b.cluster, b.a)
        assert abs(a.loss - b.loss) < 1e-3
    assert all(t.is_cuda for t in eng.state.tensors().values())
