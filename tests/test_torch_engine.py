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
    r is the first of ``split(key_{r-1}, 5)``, whatever cluster ran."""

    def __init__(self, jeng):
        self.jeng = jeng
        self.keys = [jeng.state.key]

    def __call__(self, state, members):
        r = int(state.round)
        while len(self.keys) <= r:
            self.keys.append(jax.random.split(self.keys[-1], 5)[0])
        _, kb, ke, kc2, _ = jax.random.split(self.keys[r], 5)
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
        return tapi.RoundDraws(sel=as_t(sel, np.int64),
                               noise=as_t(noise, np.float32),
                               channel=as_t(nxt, np.int64))


def build_pair(d):
    jfed = japi.Federation.from_dict(d)
    je = jfed.engine
    state = jax.device_get(je.state._replace(key=None))
    tfed = tapi.Federation.from_dict(
        d, device="cpu", data=je.data, parts=je.parts, assign=je.assign,
        state=tapi.fleet_state_from_numpy(state, "cpu"))
    tfed.engine.draws = JaxDraws(je)
    return jfed, tfed


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
    jfed, tfed = build_pair(spec_dict(controller, execution=execution,
                                      aggregator=aggregator))
    if execution == "event":
        jt = jfed.run(eval_every=0.0, max_rounds=12)
        tt = tfed.run(eval_every=0.0, max_rounds=12)
    else:
        jt = jfed.engine.run_scanned(12)
        tt = tfed.engine.run_scanned(12)
    assert len(tt.records) == len(jt.records) == (13 if execution ==
                                                   "scanned" else 12)
    for a, b in zip(jt.records, tt.records):
        assert (b.round, b.cluster, b.a, b.agg_count) == \
            (a.round, a.cluster, a.a, a.agg_count)
        np.testing.assert_allclose([b.t, b.loss, b.energy],
                                   [a.t, a.loss, a.energy], rtol=1e-5)
        assert (a.acc is None) == (b.acc is None)
        if a.acc is not None:
            assert abs(a.acc - b.acc) < 1e-5
    assert_same_state(jfed.engine.state, tfed.engine.state)
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
    {"controller": {"kind": "dqn", "params": {}}},
    {"aggregator": {"kind": "median", "params": {}}},
    {"task": {"kind": "autoencoder-anomaly", "params": {}}},
    {"privacy": {"clip": 1.0, "noise": 0.1}},
    {"faults": {"dropout": 0.2}},
    {"sharding": {"mesh": [2]}},
    {"scale": "datacenter", "task": {"kind": "lm", "params": {}}},
])
def test_unported_features_raise(change):
    d = spec_dict(FIXED)
    d.update(change)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tapi.Federation.from_dict(d, device="cpu")
    with pytest.raises(NotImplementedError):
        tapi.FederationSpec().validate()      # the default controller: dqn


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert tapi.resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.Federation.from_dict(spec_dict(FIXED))
    assert tapi.resolve_device("cpu").type == "cpu"


def test_import_pulls_in_no_jax():
    code = ("import sys, repro_torch, repro_torch.api, repro_torch.kernels;"
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
