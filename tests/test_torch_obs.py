"""The port's telemetry (`repro_torch.obs`) against the JAX package's.

The registry, the snapshot records and the span trees are copies of the
JAX package's: the same operations must give the same Prometheus text,
the same snapshots and the same tree structure, string for string.  The
load-bearing guarantee is **trace bit-parity**: attaching an `EngineObs`
adds no read inside a round, so an instrumented run's trace equals an
uninstrumented one's record for record, on the scanned and the event-loop
path.  On the CPU the port loads no kernel library, so its runs record no
compile event (the JAX package's record one a scan length).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)

from repro_torch import api as tapi  # noqa: E402
from repro_torch.api.records import JsonlSink, tail_jsonl  # noqa: E402
from repro_torch.kernels import build as kernel_build  # noqa: E402
from repro_torch.obs import (METRICS_SCHEMA, SPAN_SCHEMA,  # noqa: E402
                             EngineObs, MetricsRegistry, SpanRecorder,
                             fence, merge_snapshot_records, snapshot_record)

try:            # the card's machine has no JAX: only the cuda tests run there
    from repro import obs as jobs
except ImportError:
    jobs = None


@pytest.fixture
def needs_jax():
    if jobs is None:
        pytest.skip("the JAX package is not installed")


def spec_dict(execution="scanned", seed=5):
    return dict(fleet={"n_devices": 8}, clustering={"n_clusters": 2},
                controller={"kind": "fixed", "params": {"a": 3}},
                task={"kind": "mlp", "params": {"n_samples": 512, "dim": 16,
                                                "hidden": 8}},
                execution=execution, rounds=4, sim_seconds=1e9,
                local_batch=16, seed=seed)


class ListSink:
    def __init__(self):
        self.records = []

    def append(self, rec):
        self.records.append(rec)


# --------------------------------------------------------------------- #
# the registry: the same operations, the same text and snapshots
# --------------------------------------------------------------------- #
def _semantics(Reg):
    reg = Reg()
    c = reg.counter("rounds_total", "rounds")
    c.inc()
    c.inc(2, cluster="0")
    c.inc(3, cluster="1")
    g = reg.gauge("queue", "deficit")
    g.set(4.5)
    g.set(2.0)
    h = reg.histogram("dur", "round duration", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    errors = []
    for bad in (lambda: c.inc(-1), lambda: reg.gauge("rounds_total"),
                lambda: reg.histogram("bad", buckets=(1.0, 0.5)),
                lambda: reg.counter("0bad"), lambda: c.inc(1, **{"0": "x"})):
        try:
            bad()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert reg.counter("rounds_total") is c
    return reg, [c.value(), c.value(cluster="0"), c.total(), g.value(),
                 h.value(), errors]


def _cardinality(Reg):
    reg = Reg(max_series=2)
    c = reg.counter("per_device", "per-device tally")
    for i in range(5):
        c.inc(1, device=str(i))
    g = reg.gauge("per_cluster", "")
    for i in range(4):
        g.set(i * 0.5, cluster=str(i))
    return reg, [c.value(device="0"), c.value(overflow="true"), c.total(),
                 reg.get("metrics_dropped_series_total").value(
                     metric="per_device")]


def _golden(Reg):
    reg = Reg()
    reg.counter("fl_rounds_total", "rounds executed").inc(7)
    reg.gauge("fl_loss", "last loss").set(0.25)
    c2 = reg.counter("fl_cluster_rounds_total", "per cluster")
    c2.inc(4, cluster="0")
    c2.inc(3, cluster="1")
    h = reg.histogram("fl_dur", "duration", buckets=(0.5, 1.0))
    h.observe(0.3)
    h.observe(2.0)
    reg.gauge("fl_label", 'a "quoted"\nhelp').set(float("inf"),
                                                   k='v"\\x\n')
    reg.gauge("fl_big").set(1e16)
    return reg, []


def _roundtrip(Reg):
    reg = Reg()
    reg.counter("a_total", "a").inc(3, k="v")
    reg.gauge("b", "b").set(-1.5)
    reg.histogram("c", "c", buckets=(1.0,)).observe(0.5)
    back = Reg.from_snapshot(json.loads(json.dumps(reg.snapshot())))
    assert back.totals() == reg.totals()
    assert back.to_prometheus() == reg.to_prometheus()
    try:
        Reg.from_snapshot({"schema": "metrics/999"})
        err = None
    except ValueError as e:
        err = str(e)
    return back, [err]


@pytest.mark.parametrize("script", [_semantics, _cardinality, _golden,
                                    _roundtrip],
                         ids=["semantics", "cardinality", "golden",
                              "roundtrip"])
def test_registry_matches_jax_string_for_string(needs_jax, script):
    got, got_vals = script(MetricsRegistry)
    want, want_vals = script(jobs.MetricsRegistry)
    assert got_vals == want_vals
    assert got.to_prometheus() == want.to_prometheus()
    assert json.dumps(got.snapshot()) == json.dumps(want.snapshot())
    assert got.totals() == want.totals()


def test_prometheus_exposition_golden():
    reg, _ = _golden(MetricsRegistry)
    text = reg.to_prometheus()
    assert text.startswith("# TYPE fl_big gauge\nfl_big 1e+16\n")
    assert (
        "# HELP fl_dur duration\n"
        "# TYPE fl_dur histogram\n"
        'fl_dur_bucket{le="0.5"} 1\n'
        'fl_dur_bucket{le="1"} 1\n'
        'fl_dur_bucket{le="+Inf"} 2\n'
        "fl_dur_sum 2.3\n"
        "fl_dur_count 2\n") in text
    assert 'fl_label{k="v\\"\\\\x\\n"} +Inf\n' in text
    assert text.endswith("# TYPE fl_rounds_total counter\n"
                         "fl_rounds_total 7\n")


def test_merge_snapshot_records_matches_jax(needs_jax):
    def records(Reg, snap):
        service, chaos = Reg(), Reg()
        c = service.counter("fl_rounds_total", "rounds")
        k = chaos.counter("chaos_sigkills_total", "kills")
        c.inc(5)
        old = snap(service, source="service", ts=1.0)
        c.inc(5)
        new = snap(service, source="service", ts=2.0)
        k.inc(1)
        ch = snap(chaos, source="chaos", ts=1.5)
        return [old, {"schema": SPAN_SCHEMA, "name": "x"}, ch, new]

    got = merge_snapshot_records(records(MetricsRegistry, snapshot_record))
    want = jobs.merge_snapshot_records(records(jobs.MetricsRegistry,
                                               jobs.snapshot_record))
    assert got == want
    totals = MetricsRegistry.from_snapshot(got).totals()
    assert totals["fl_rounds_total"] == 10
    assert totals["chaos_sigkills_total"] == 1
    assert merge_snapshot_records([{"schema": "span/1"}]) is None


# --------------------------------------------------------------------- #
# spans
# --------------------------------------------------------------------- #
def _span_tree(Recorder):
    sink = ListSink()
    rec = Recorder(sink=sink)
    with rec.span("segment", segment=1, rounds=4):
        with rec.span("round", mode="scanned", rounds=4) as rd:
            rd.mark("dispatch")
        with rec.span("host_sync", rounds=4):
            pass
        with rec.span("checkpoint", segment=1) as ck:
            ck.attrs["bytes"] = 123
    with rec.span("eval"):
        pass
    assert rec.last("segment").child_dur("round") >= 0
    assert rec.last("nope") is None
    return sink.records


def _shape(node):
    """A span record without its clock readings."""
    return {"name": node["name"],
            "attrs": {k: (None if k.endswith("_s") else v)
                      for k, v in node.get("attrs", {}).items()},
            "children": [_shape(c) for c in node.get("children", [])],
            "keys": sorted(node)}


def test_span_trees_match_jax_structure(needs_jax):
    got = _span_tree(SpanRecorder)
    want = _span_tree(jobs.SpanRecorder)
    assert [r["schema"] for r in got] == [SPAN_SCHEMA] * 2
    assert [_shape(r) for r in got] == [_shape(r) for r in want]
    seg = got[0]
    assert seg["dur_s"] >= sum(c["dur_s"] for c in seg["children"])
    assert "dispatch_s" in seg["children"][0]["attrs"]


def test_fence_on_cpu_tensors_needs_no_sync(monkeypatch):
    def no_sync(*a, **k):
        raise AssertionError("fence synchronised for CPU tensors")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    tree = {"x": torch.ones(3), "n": 3, "rows": [torch.zeros(2), None],
            "state": tapi.FleetTree(*([torch.ones(1)] * 8))}
    assert fence(tree) is tree
    assert fence(None) is None and fence(7) == 7
    rec = SpanRecorder()
    with rec.span("fenced", fence_on=tree):
        pass
    assert rec.last("fenced").dur_s >= 0


def test_fence_synchronises_each_card_once(monkeypatch):
    """One `torch.cuda.synchronize` for each CUDA device among the
    tensor leaves (stand-in tensors report a CUDA device here)."""
    class FakeCuda:
        def __init__(self, i):
            self.device = torch.device("cuda", i)
    seen = []
    monkeypatch.setattr(torch, "is_tensor",
                        lambda x: isinstance(x, (FakeCuda, torch.Tensor)))
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)
    fence({"a": FakeCuda(0), "b": [FakeCuda(1), FakeCuda(0)],
           "c": torch.ones(1)})
    assert sorted(d.index for d in seen) == [0, 1]


# --------------------------------------------------------------------- #
# EngineObs: the port's rows fold as the JAX package's dict does
# --------------------------------------------------------------------- #
def test_on_segment_rows_match_jax_dict(needs_jax):
    rng = np.random.default_rng(0)
    K = 9
    rows = np.stack([np.cumsum(rng.uniform(0.1, 3.0, K)),
                     rng.integers(0, 4, K), rng.integers(1, 11, K),
                     rng.uniform(0.01, 12.0, K), rng.uniform(1.0, 50.0, K),
                     rng.uniform(0.1, 2.3, K)], axis=1).astype(np.float32)
    cols = ("t", "cluster", "a", "dur", "consumed", "loss")
    got, want = EngineObs(), jobs.EngineObs()
    got.on_segment(rows, K)
    want.on_segment({k: rows[:, i] for i, k in enumerate(cols)}, K)
    for obs in (got, want):
        obs.on_round(cluster=2, a=4, dur=0.5, consumed=3.25, loss=0.75)
        obs.on_state_summary({"queue_deficit": 1.5, "reputation_min": 0.25,
                              "reputation_mean": 0.5,
                              "reputation_max": 0.875,
                              "twin_beta_sum": 3.0})
        obs.on_eval(0.5, 0.875)
        obs.on_checkpoint(0.0125, 4096)
        obs.record_compile("trust_aggregate-0123.so", 0.25)
    assert got.registry.to_prometheus() == want.registry.to_prometheus()
    assert json.dumps(got.registry.snapshot()) \
        == json.dumps(want.registry.snapshot())


# --------------------------------------------------------------------- #
# bit-parity: telemetry must not perturb the trace
# --------------------------------------------------------------------- #
def test_scanned_trace_bit_parity_with_obs(tmp_path):
    plain = tapi.Federation.from_dict(spec_dict(), device="cpu")
    want = plain.engine.run_scanned(6).records

    path = str(tmp_path / "metrics.jsonl")
    obs = EngineObs(sink=JsonlSink(path), source="service")
    inst = tapi.Federation.from_dict(spec_dict(), device="cpu")
    inst.engine.set_obs(obs)
    got = inst.engine.run_scanned(6).records

    assert len(got) == len(want) == 7
    for a, b in zip(want, got):
        assert a == b                     # dataclass eq: floats exact
    assert all(torch.equal(a, b) for a, b in zip(
        plain.engine.state.tensors().values(),
        inst.engine.state.tensors().values()))
    totals = obs.registry.totals()
    assert totals["fl_rounds_total"] == 6
    assert totals["fl_evals_total"] == 1
    assert totals["fl_sim_seconds_total"] > 0
    # on the CPU no kernel library is loaded: no compile event (the JAX
    # package counts one compile of the scan here)
    assert totals["fl_compiles_total"] == 0
    rd = obs.spans.last("round")
    assert rd.attrs["mode"] == "scanned" and "dispatch_s" in rd.attrs
    assert obs.spans.last("host_sync") is not None
    assert obs.spans.last("eval") is not None
    obs.sink.close()
    schemas = [r.get("schema") for r in tail_jsonl(path, n=64)]
    assert SPAN_SCHEMA in schemas and "event/1" not in schemas
    inst.engine.set_obs(None)


def test_event_loop_trace_bit_parity_with_obs():
    plain = tapi.Federation.from_dict(spec_dict("event", seed=6),
                                      device="cpu")
    want = plain.run(eval_every=1.0, max_rounds=10).records

    obs = EngineObs()
    inst = tapi.Federation.from_dict(spec_dict("event", seed=6),
                                     device="cpu")
    inst.engine.set_obs(obs)
    got = inst.run(eval_every=1.0, max_rounds=10).records
    inst.engine.set_obs(None)

    assert len(got) == len(want) > 0
    for a, b in zip(want, got):
        assert a == b
    totals = obs.registry.totals()
    assert totals["fl_rounds_total"] == 10
    assert totals["fl_evals_total"] == len(got)
    assert totals["fl_energy_joules_total"] == inst.engine.energy_used


def test_library_loads_under_telemetry_are_compile_events():
    """`set_obs` listens to `kernels.build.load`: each library it builds
    or opens while telemetry is attached is one ``compile`` event named
    for the library; detaching stops listening."""
    sink = ListSink()
    obs = EngineObs(sink=sink)
    eng = tapi.Federation.from_dict(spec_dict(), device="cpu").engine
    before = list(kernel_build.load_listeners)
    eng.set_obs(obs)
    assert len(kernel_build.load_listeners) == len(before) + 1
    for listener in kernel_build.load_listeners[len(before):]:
        listener("trust_aggregate-0123abcd.so", 0.5)
    eng.set_obs(None)
    assert kernel_build.load_listeners == before
    events = [r for r in sink.records if r.get("schema") == "event/1"]
    assert [(e["event"], e["fn"], e["seconds"]) for e in events] == [
        ("compile", "trust_aggregate-0123abcd.so", 0.5)]
    assert obs.m_compiles.value(fn="trust_aggregate-0123abcd.so") == 1


def test_state_summary_is_read_only():
    fed = tapi.Federation.from_dict(spec_dict(seed=7), device="cpu")
    fed.engine.run_scanned(3, eval_final=False)
    before = {k: v.clone() for k, v in fed.engine.state.tensors().items()}
    summary = fed.engine.obs_state_summary()
    assert all(torch.equal(before[k], v)
               for k, v in fed.engine.state.tensors().items())
    st = fed.engine.state
    assert summary == {"queue_deficit": float(st.queue),
                       "reputation_min": float(st.rep.min()),
                       "reputation_mean": float(st.rep.mean()),
                       "reputation_max": float(st.rep.max()),
                       "twin_beta_sum": float(st.twins.beta.sum())}
    assert summary["reputation_min"] <= summary["reputation_mean"] \
        <= summary["reputation_max"]
    assert fed.engine.obs_state_summary() == summary


# --------------------------------------------------------------------- #
# serve integration: metrics.jsonl + status metrics block
# --------------------------------------------------------------------- #
def test_serve_metrics_file_and_status_block(tmp_path):
    from repro_torch.serve.__main__ import main
    from repro_torch.serve.service import load_run_metrics, service_status

    spec_file = tmp_path / "spec.json"
    spec_file.write_text(json.dumps(spec_dict()))
    run_dir = str(tmp_path / "run")
    assert main(["start", "--run-dir", run_dir, "--spec-file",
                 str(spec_file), "--segment-rounds", "3", "--max-segments",
                 "2", "--foreground", "--device", "cpu"]) == 0

    recs = tail_jsonl(os.path.join(run_dir, "metrics.jsonl"), n=64)
    schemas = {r.get("schema") for r in recs}
    assert {METRICS_SCHEMA, SPAN_SCHEMA} <= schemas
    assert "event/1" not in schemas          # no library loads on the CPU
    seg = [r for r in recs if r.get("schema") == SPAN_SCHEMA
           and r.get("name") == "segment"]
    assert len(seg) == 2
    assert [c["name"] for c in seg[-1]["children"]] \
        == ["round", "host_sync", "eval", "checkpoint"]

    st = service_status(run_dir)
    m = st["metrics"]
    assert m["fl_rounds_total"] == 6
    assert m["fl_checkpoints_total"] == 2
    assert m["service_segments_total"] == 2
    assert m["fl_evals_total"] == 2
    assert st["last_span"]["name"] == "segment"

    text = MetricsRegistry.from_snapshot(
        load_run_metrics(run_dir)).to_prometheus()
    assert "fl_rounds_total 6" in text
    assert "# TYPE fl_compiles_total counter" in text
    assert main(["metrics", "--run-dir", run_dir]) == 0
    assert main(["status", "--run-dir", run_dir, "--watch", "--once"]) == 0
