"""Fleet telemetry of the port: metrics registry, timing spans, engine
instrumentation (the JAX package's ``repro.obs``, same records).

`MetricsRegistry` (zero-dep counters / gauges / histograms -> dict
snapshot / Prometheus text), `SpanRecorder` (nesting ``span("segment"|
"round"|"checkpoint"|"eval"|"host_sync")`` timing trees fenced with
`torch.cuda.synchronize`), and `EngineObs` (the bundle
`DeviceScaleEngine.set_obs` / the serve stack publish through, emitting
schema-versioned records into a run dir's ``metrics.jsonl``).
"""
from .metrics import (DEFAULT_BUCKETS, METRICS_SCHEMA, Metric,
                      MetricsRegistry, load_metrics_file,
                      merge_snapshot_records, snapshot_record)
from .spans import SPAN_SCHEMA, Span, SpanRecorder, fence
from .instrument import EVENT_SCHEMA, EngineObs

__all__ = [
    "DEFAULT_BUCKETS", "METRICS_SCHEMA", "Metric", "MetricsRegistry",
    "load_metrics_file", "merge_snapshot_records", "snapshot_record",
    "SPAN_SCHEMA", "Span", "SpanRecorder", "fence",
    "EVENT_SCHEMA", "EngineObs",
]
