"""`EngineObs`: the bundle engines and the serve stack publish through (a
copy of the JAX package's ``repro.obs.instrument``: the same metric names,
help strings, buckets and hooks).

One `EngineObs` owns a `MetricsRegistry` + a `SpanRecorder` sharing a
single JSONL sink (the run dir's ``metrics.jsonl``).  Attach it with
``engine.set_obs(obs)``; the engine then reports

* per-round aggregates the **cheap** way: the scanned path hands over
  the (K, 6) per-round rows it already reads back once per segment, the
  rows its trace records are built from, so telemetry adds no device
  work and no read inside a round, and the trace stays bit-identical to
  an uninstrumented run;
* a per-segment state summary (deficit-queue level, trust-weight /
  reputation stats, Eqn-4 β tally) via one small *read-only* reduction
  over `FleetState` — it never touches the round;
* one-time compile events.  The port compiles no device program at run
  time; its counterpart is the kernel library that `kernels.build` builds
  with nvcc or loads from ``build/kernels/``: each load while telemetry is
  attached is one ``compile`` event named for the library.  The port has
  no HLO, so the ``fl_hlo_*`` gauges are declared and never set;
* fault bookkeeping: the `FaultModel`'s *static* tallies (Byzantine
  subset sizes, per-family rates) as gauges, plus a rounds-under-fault
  counter;
* the kernel launches by kernel and rank at each snapshot (the port's
  own gauge, ``fl_kernel_launches``: a service or pool child, or each
  rank of a sharded one, shows which kernels its path ran).

Metric names follow Prometheus conventions with an ``fl_`` prefix; the
serve supervisor adds ``service_*`` and the chaos harness ``chaos_*``
families into the same ``metrics.jsonl`` (see
`repro_torch.obs.metrics.merge_snapshot_records`).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from .metrics import MetricsRegistry, snapshot_record
from .spans import SpanRecorder

EVENT_SCHEMA = "event/1"        # one-time event records (compiles)
# the columns of the port's per-round segment rows
SEGMENT_COLUMNS = ("t", "cluster", "a", "dur", "consumed", "loss")


class EngineObs:
    """Registry + spans + sink, with the engine-facing publish hooks."""

    def __init__(self, sink=None, registry: Optional[MetricsRegistry] = None,
                 spans: Optional[SpanRecorder] = None,
                 source: str = "service", max_series: int = 64):
        self.sink = sink
        self.source = source
        self.registry = registry if registry is not None \
            else MetricsRegistry(max_series=max_series)
        self.spans = spans if spans is not None else SpanRecorder(sink=sink)
        r = self.registry
        self.m_rounds = r.counter(
            "fl_rounds_total", "federated rounds executed")
        self.m_cluster_rounds = r.counter(
            "fl_cluster_rounds_total", "rounds per cluster")
        self.m_actions = r.counter(
            "fl_actions_total", "controller aggregation-frequency choices")
        self.m_energy = r.counter(
            "fl_energy_joules_total", "cumulative fleet energy (Eqn 9-11)")
        self.m_sim = r.counter(
            "fl_sim_seconds_total", "simulated seconds advanced")
        self.m_round_dur = r.histogram(
            "fl_round_duration_sim_seconds",
            "per-round simulated duration",
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0))
        self.m_loss = r.gauge(
            "fl_train_loss", "last round's mean member training loss")
        self.m_eval_loss = r.gauge("fl_eval_loss", "last evaluation loss")
        self.m_eval_acc = r.gauge(
            "fl_eval_acc", "last evaluation accuracy / detection AUC")
        self.m_evals = r.counter("fl_evals_total", "evaluations run")
        self.m_queue = r.gauge(
            "fl_queue_deficit", "Eqn-12 virtual deficit-queue level")
        self.m_rep = r.gauge(
            "fl_reputation", "Eqn-4 trust-weight summary (label: stat)")
        self.m_beta = r.gauge(
            "fl_twin_beta_sum", "total Eqn-4 negative-interaction tally")
        self.m_compiles = r.counter(
            "fl_compiles_total", "device programs compiled")
        self.m_compile_s = r.counter(
            "fl_compile_seconds_total", "wall seconds spent compiling")
        self.m_hlo_coll = r.gauge(
            "fl_hlo_collective_ops", "collective op count in optimized HLO")
        self.m_hlo_flops = r.gauge(
            "fl_hlo_flops", "estimated FLOPs of the compiled program")
        self.m_ckpts = r.counter("fl_checkpoints_total", "checkpoints taken")
        self.m_ckpt_s = r.histogram(
            "fl_checkpoint_seconds", "checkpoint wall-clock latency")
        self.m_ckpt_last = r.gauge(
            "fl_checkpoint_last_seconds", "latency of the last checkpoint")
        self.m_ckpt_bytes = r.gauge(
            "fl_checkpoint_bytes", "size of the last checkpoint")
        self.m_fault_rounds = r.counter(
            "fl_fault_rounds_total", "rounds run under an active FaultSpec")

    # ------------------------------------------------------------------ #
    def span(self, name: str, fence_on=None, **attrs):
        return self.spans.span(name, fence_on=fence_on, **attrs)

    def flush_snapshot(self) -> None:
        """Append a registry snapshot record to the sink (the serve loop
        calls this once per segment; chaos after each kill/restart), with
        the kernel launches so far of this process, or of every rank of
        its job (``fl_kernel_launches``, by kernel and rank:
        `repro_torch.kernels.launches`; the plain versions on the CPU count
        none).  In a job every rank calls it at the same points: the
        ranks' counts are gathered."""
        from ..kernels.launch import launches
        from ..launch.distributed import every_rank
        g = self.registry.gauge(
            "fl_kernel_launches",
            "hand-written kernel launches of each rank (labels: kernel, "
            "rank)")
        for rank, counts in enumerate(every_rank(dict(launches))):
            for name, n in counts.items():
                g.set(n, kernel=name, rank=str(rank))
        if self.sink is not None:
            self.sink.append(snapshot_record(
                self.registry, source=self.source, ts=time.time()))

    # engine-facing hooks ---------------------------------------------- #
    def publish_static(self, engine) -> None:
        """One-time gauges at attach: fleet shape + fault-model statics."""
        r = self.registry
        spec = engine.spec
        r.gauge("fl_devices", "fleet size").set(spec.fleet.n_devices)
        r.gauge("fl_clusters", "cluster count").set(
            spec.clustering.n_clusters)
        fm = getattr(engine, "faults", None)
        if fm is not None:
            for k, v in fm.stats().items():
                r.gauge(f"fl_fault_{k}", "FaultModel static bookkeeping"
                        ).set(float(v))

    def on_segment(self, ys, K: int, engine=None) -> None:
        """Fold one scan segment's per-round host metrics into the registry.

        ``ys`` is the segment's (K, 6) float32 rows (t, cluster, a, dur,
        consumed, loss), as the port's engine reads them back, or the JAX
        package's dict of (K,) arrays under those names — the values the
        trace records are built from, so this costs numpy over K scalars
        and nothing device-side.
        """
        if not isinstance(ys, dict):
            rows = np.asarray(ys)
            ys = {k: rows[:, i] for i, k in enumerate(SEGMENT_COLUMNS)}
        self.m_rounds.inc(K)
        cl = np.asarray(ys["cluster"]).astype(np.int64)
        for c, n in zip(*np.unique(cl, return_counts=True)):
            self.m_cluster_rounds.inc(float(n), cluster=str(int(c)))
        av = np.asarray(ys["a"]).astype(np.int64)
        for a, n in zip(*np.unique(av, return_counts=True)):
            self.m_actions.inc(float(n), a=str(int(a)))
        dur = np.asarray(ys["dur"], np.float64)
        self.m_energy.inc(float(np.sum(np.asarray(ys["consumed"],
                                                  np.float64))))
        self.m_sim.inc(float(np.sum(dur)))
        for d in dur:
            self.m_round_dur.observe(float(d))
        self.m_loss.set(float(np.asarray(ys["loss"])[-1]))
        if engine is not None:
            fm = getattr(engine, "faults", None)
            if fm is not None and fm.active:
                self.m_fault_rounds.inc(K)
            self.on_state_summary(engine.obs_state_summary())

    def on_round(self, *, cluster: int, a: int, dur: float,
                 consumed: float, loss: float, engine=None) -> None:
        """Event-loop flavor of `on_segment`: one round at a time."""
        self.m_rounds.inc(1)
        self.m_cluster_rounds.inc(1, cluster=str(int(cluster)))
        self.m_actions.inc(1, a=str(int(a)))
        self.m_energy.inc(float(consumed))
        self.m_sim.inc(float(dur))
        self.m_round_dur.observe(float(dur))
        self.m_loss.set(float(loss))
        if engine is not None:
            fm = getattr(engine, "faults", None)
            if fm is not None and fm.active:
                self.m_fault_rounds.inc(1)

    def on_state_summary(self, summary: dict) -> None:
        self.m_queue.set(summary["queue_deficit"])
        for stat in ("min", "mean", "max"):
            self.m_rep.set(summary[f"reputation_{stat}"], stat=stat)
        self.m_beta.set(summary["twin_beta_sum"])

    def on_eval(self, loss: float, acc=None) -> None:
        self.m_evals.inc(1)
        self.m_eval_loss.set(float(loss))
        if acc is not None:
            self.m_eval_acc.set(float(acc))

    def on_checkpoint(self, seconds: float, nbytes: int = 0) -> None:
        self.m_ckpts.inc(1)
        self.m_ckpt_s.observe(float(seconds))
        self.m_ckpt_last.set(float(seconds))
        if nbytes:
            self.m_ckpt_bytes.set(float(nbytes))

    def record_compile(self, fn_name: str, seconds: float,
                       hlo_text: Optional[str] = None) -> None:
        """One-time compile event: counters + an ``event/1`` record in
        metrics.jsonl.  ``hlo_text`` is the JAX package's optimized HLO;
        the port has none, and passes None."""
        del hlo_text
        self.m_compiles.inc(1, fn=fn_name)
        self.m_compile_s.inc(float(seconds), fn=fn_name)
        event = {"schema": EVENT_SCHEMA, "event": "compile",
                 "ts": time.time(), "fn": fn_name,
                 "seconds": float(seconds)}
        if self.sink is not None:
            self.sink.append(event)
