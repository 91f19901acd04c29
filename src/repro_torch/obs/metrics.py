"""A zero-dependency metrics registry: counters, gauges, histograms (a
copy of the JAX package's ``repro.obs.metrics``: same names, snapshots and
Prometheus text).

The fleet telemetry substrate (API.md "Observability").  Engines, the
serve supervisor, the chaos harness, and `FaultModel` bookkeeping all
publish into one `MetricsRegistry`; the registry snapshots to a plain
dict (JSON-serializable, schema-versioned — the ``metrics.jsonl`` record
form) and renders the Prometheus text exposition format, so the same
numbers feed the live terminal dashboard (``python -m repro_torch.serve
status --watch``) and an external scraper polling ``python -m
repro_torch.serve metrics``.

Design constraints, in order:

* **Never in the hot path's way.**  Publishing is host-side Python over
  scalars already read back (the engine folds a segment's per-round
  metrics in once, from the rows its trace is built from) — nothing here
  touches the device, and instrumented runs launch the *identical* device
  work (tests/test_torch_obs.py pins trace bit-parity with telemetry on vs
  off).
* **Bounded cardinality.**  Each family caps its label sets
  (``max_series``, default 64); past the cap, new label sets collapse
  into one reserved ``{"overflow": "true"}`` series and the registry's
  ``metrics_dropped_series_total`` self-counter ticks — a per-cluster
  label on a 4096-cluster fleet degrades gracefully instead of eating
  the process.
* **Round-trippable.**  ``snapshot()`` -> ``MetricsRegistry.
  from_snapshot`` is lossless, which is what lets a *separate* CLI
  process re-expose a run dir's last snapshot to Prometheus without
  talking to the live service.
"""
from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

METRICS_SCHEMA = "metrics/1"            # snapshot record schema version

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_OVERFLOW = (("overflow", "true"),)

DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class _Hist:
    """State of one histogram series: bucket counts + sum + count."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)     # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0


class Metric:
    """One metric family: a name + kind + help + labeled series.

    ``inc``/``set``/``observe`` take the label values as keyword
    arguments (``m.inc(2, cluster="3")``); unlabeled use is the empty
    label set.  Counters only go up (negative increments raise), gauges
    set, histograms observe into fixed buckets.
    """

    def __init__(self, registry: "MetricsRegistry", name: str, kind: str,
                 help: str = "", buckets: Optional[Sequence[float]] = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.registry = registry
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets: Tuple[float, ...] = ()
        if kind == "histogram":
            bk = tuple(float(b) for b in (buckets or DEFAULT_BUCKETS))
            if list(bk) != sorted(bk):
                raise ValueError(f"histogram {name}: buckets must ascend")
            self.buckets = bk
        self._series: Dict[Tuple[Tuple[str, str], ...], object] = {}

    # ------------------------------------------------------------------ #
    def _slot(self, labels: Dict[str, str]):
        key = _label_key(labels)
        if key not in self._series:
            for k, _ in key:
                if not _LABEL_RE.match(k):
                    raise ValueError(f"invalid label name {k!r}")
            if len(self._series) >= self.registry.max_series \
                    and key != _OVERFLOW:
                # cardinality guard: collapse into the overflow series
                self.registry._dropped(self.name)
                key = _OVERFLOW
                if key in self._series:
                    return key
            self._series[key] = (_Hist(len(self.buckets))
                                 if self.kind == "histogram" else 0.0)
        return key

    def inc(self, value: float = 1.0, **labels) -> None:
        assert self.kind == "counter", f"{self.name} is a {self.kind}"
        if value < 0:
            raise ValueError(f"counter {self.name}: negative inc {value}")
        key = self._slot(labels)
        self._series[key] += value

    def set(self, value: float, **labels) -> None:
        assert self.kind == "gauge", f"{self.name} is a {self.kind}"
        key = self._slot(labels)
        self._series[key] = float(value)

    def observe(self, value: float, **labels) -> None:
        assert self.kind == "histogram", f"{self.name} is a {self.kind}"
        key = self._slot(labels)
        h = self._series[key]
        i = 0
        for i, edge in enumerate(self.buckets):
            if value <= edge:
                break
        else:
            i = len(self.buckets)
        h.counts[i] += 1
        h.sum += float(value)
        h.count += 1

    def value(self, **labels) -> float:
        """Current value of one series (counter/gauge); 0.0 if unseen."""
        v = self._series.get(_label_key(labels), 0.0)
        return v.count if isinstance(v, _Hist) else float(v)

    def total(self) -> float:
        """Sum over all series (histograms: total observation count)."""
        return sum(v.count if isinstance(v, _Hist) else float(v)
                   for v in self._series.values())

    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict:
        series: List[dict] = []
        for key, v in sorted(self._series.items()):
            d: dict = {"labels": dict(key)}
            if isinstance(v, _Hist):
                d.update(counts=list(v.counts), sum=v.sum, count=v.count)
            else:
                d["value"] = float(v)
            series.append(d)
        out = {"kind": self.kind, "help": self.help, "series": series}
        if self.kind == "histogram":
            out["buckets"] = list(self.buckets)
        return out

    def load_dict(self, d: dict) -> None:
        for s in d.get("series", []):
            key = _label_key(s.get("labels", {}))
            if self.kind == "histogram":
                h = _Hist(len(self.buckets))
                h.counts = list(s.get("counts", h.counts))
                h.sum = float(s.get("sum", 0.0))
                h.count = int(s.get("count", 0))
                self._series[key] = h
            else:
                self._series[key] = float(s.get("value", 0.0))


class MetricsRegistry:
    """A named collection of metric families (see module docstring)."""

    def __init__(self, max_series: int = 64):
        self.max_series = int(max_series)
        self._metrics: Dict[str, Metric] = {}
        self._drop_counts: Dict[str, int] = {}

    # declaration ------------------------------------------------------ #
    def _declare(self, name, kind, help, buckets=None) -> Metric:
        m = self._metrics.get(name)
        if m is not None:
            if m.kind != kind:
                raise ValueError(
                    f"metric {name} already registered as {m.kind}")
            return m
        m = Metric(self, name, kind, help, buckets)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Metric:
        return self._declare(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> Metric:
        return self._declare(name, "gauge", help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Metric:
        return self._declare(name, "histogram", help, buckets)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def _dropped(self, name: str) -> None:
        self._drop_counts[name] = self._drop_counts.get(name, 0) + 1
        c = self._declare("metrics_dropped_series_total", "counter",
                          "label sets collapsed by the cardinality guard")
        c._series[_label_key({"metric": name})] = \
            c._series.get(_label_key({"metric": name}), 0.0) + 1.0

    def __iter__(self) -> Iterable[Metric]:
        return iter(self._metrics.values())

    # snapshots -------------------------------------------------------- #
    def snapshot(self) -> dict:
        """Schema-versioned, JSON-round-trippable state of every family."""
        return {"schema": METRICS_SCHEMA,
                "families": {n: m.to_dict()
                             for n, m in sorted(self._metrics.items())}}

    @classmethod
    def from_snapshot(cls, snap: dict,
                      max_series: int = 4096) -> "MetricsRegistry":
        reg = cls(max_series=max_series)
        reg.load_snapshot(snap)
        return reg

    def load_snapshot(self, snap: dict) -> None:
        if snap.get("schema", METRICS_SCHEMA) != METRICS_SCHEMA:
            raise ValueError(
                f"unsupported metrics schema {snap.get('schema')!r}")
        for name, fam in snap.get("families", {}).items():
            m = self._declare(name, fam.get("kind", "gauge"),
                              fam.get("help", ""), fam.get("buckets"))
            m.load_dict(fam)

    def totals(self) -> Dict[str, float]:
        """Flat {name: total} view — the dashboard/status summary form."""
        return {n: m.total() for n, m in sorted(self._metrics.items())}

    # Prometheus text exposition --------------------------------------- #
    def to_prometheus(self) -> str:
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, v in sorted(m._series.items()):
                if isinstance(v, _Hist):
                    cum = 0
                    for i, edge in enumerate(m.buckets):
                        cum += v.counts[i]
                        k2 = key + (("le", _fmt_value(edge)),)
                        lines.append(f"{name}_bucket"
                                     f"{_fmt_labels(tuple(sorted(k2)))}"
                                     f" {cum}")
                    cum += v.counts[-1]
                    k2 = key + (("le", "+Inf"),)
                    lines.append(f"{name}_bucket"
                                 f"{_fmt_labels(tuple(sorted(k2)))} {cum}")
                    lines.append(f"{name}_sum{_fmt_labels(key)} "
                                 f"{_fmt_value(v.sum)}")
                    lines.append(f"{name}_count{_fmt_labels(key)} "
                                 f"{v.count}")
                else:
                    lines.append(
                        f"{name}{_fmt_labels(key)} {_fmt_value(v)}")
        return "\n".join(lines) + ("\n" if lines else "")


# --------------------------------------------------------------------- #
# snapshot streams (the metrics.jsonl record form)
# --------------------------------------------------------------------- #
def snapshot_record(registry: MetricsRegistry, *, source: str,
                    ts: float) -> dict:
    """One ``metrics.jsonl`` snapshot record for this registry."""
    rec = registry.snapshot()
    rec.update(source=str(source), ts=float(ts))
    return rec


def merge_snapshot_records(records: Iterable[dict]) -> Optional[dict]:
    """Fold a stream of snapshot records into one merged snapshot.

    Multiple *sources* write snapshots into the same ``metrics.jsonl``
    (the service between segments, the chaos supervisor around kills);
    each source's **latest** record wins for that source, and families
    merge across sources (sources use disjoint name prefixes —
    ``fl_``/``service_`` vs ``chaos_`` — so a later source never
    clobbers an earlier one's counters).  Returns None when no snapshot
    records are present.
    """
    latest: Dict[str, dict] = {}
    for rec in records:
        if rec.get("schema") == METRICS_SCHEMA:
            latest[str(rec.get("source", ""))] = rec
    if not latest:
        return None
    families: Dict[str, dict] = {}
    for _, rec in sorted(latest.items(),
                         key=lambda kv: kv[1].get("ts", 0.0)):
        families.update(rec.get("families", {}))
    ts = max(r.get("ts", 0.0) for r in latest.values())
    return {"schema": METRICS_SCHEMA, "source": "merged", "ts": ts,
            "families": families}


def load_metrics_file(path: str, *, tail: int = 512
                      ) -> Optional[MetricsRegistry]:
    """Registry rebuilt from the last snapshot(s) of a metrics.jsonl.

    Reads only the file's tail (`repro_torch.api.records.tail_jsonl`), so
    a scrape of a long-serving run dir stays O(tail)."""
    from repro_torch.api.records import tail_jsonl
    merged = merge_snapshot_records(tail_jsonl(path, n=tail))
    if merged is None:
        return None
    return MetricsRegistry.from_snapshot(merged)


def dumps(snapshot: dict) -> str:
    return json.dumps(snapshot, separators=(",", ":"))
