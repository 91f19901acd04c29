"""Terminal dashboard for ``python -m repro_torch.serve status --watch`` (a
copy of the JAX package's ``repro.serve.dashboard``: the same status dict
renders the same frame).

Pure text rendering over the `service_status` dict — no curses, no
dependencies: the watch loop repaints with an ANSI clear between frames
and everything here works equally on a dead run dir (the status reader
reconstructs metrics and spans from the files alone, via `tail_jsonl`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

WIDTH = 66


def _fmt(v: Any, nd: int = 3) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1e5 or abs(v) < 1e-3:
            return f"{v:.2e}"
        return f"{v:.{nd}f}".rstrip("0").rstrip(".")
    return str(v)


def _row(label: str, value: Any, label2: str = "",
         value2: Any = None) -> str:
    left = f"  {label:<18} {_fmt(value):<13}"
    if label2:
        return f"{left}{label2:<18} {_fmt(value2)}"
    return left


def _span_lines(span: Dict[str, Any], indent: int = 0,
                out: Optional[List[str]] = None) -> List[str]:
    """Indented one-line-per-node view of a span tree record."""
    if out is None:
        out = []
    dur = span.get("dur_s", 0.0)
    attrs = span.get("attrs", {})
    extra = ""
    if "dispatch_s" in attrs:           # fenced round: dispatch vs compute
        extra = (f"  (dispatch {_fmt(attrs['dispatch_s'])}s, "
                 f"device {_fmt(dur - attrs['dispatch_s'])}s)")
    elif "bytes" in attrs:
        extra = f"  ({int(attrs['bytes']):,} B)"
    out.append(f"  {'  ' * indent}{span.get('name', '?'):<{14 - 2 * indent}}"
               f" {_fmt(dur):>9}s{extra}")
    for child in span.get("children", []):
        _span_lines(child, indent + 1, out)
    return out


def render(status: Dict[str, Any]) -> str:
    """One dashboard frame from a `service_status` dict."""
    state = status.get("state") or {}
    m = status.get("metrics") or {}
    recs = status.get("last_records") or []
    last = recs[-1] if recs else {}

    live = "LIVE" if status.get("alive") else "DOWN"
    lines = ["=" * WIDTH]
    lines.append(f"  repro.serve [{live}]  {status.get('run_dir', '')}")
    lines.append(f"  status={state.get('status', '?')}"
                 f"  pid={status.get('pid') or '-'}"
                 f"  scenario={state.get('scenario', '?')}")
    lines.append("-" * WIDTH)
    lines.append(_row("rounds", state.get("rounds"),
                      "segment", state.get("segment")))
    rps = state.get("rounds_per_sec")
    if rps is None:                     # final "stopped" state omits it
        rps = m.get("service_rounds_per_sec")
    lines.append(_row("rounds/sec", rps,
                      "sim seconds", m.get("fl_sim_seconds_total")))
    lines.append(_row("loss", last.get("loss"),
                      "acc/AUC", last.get("acc")))
    lines.append(_row("energy [J]", state.get("energy"),
                      "queue deficit", m.get("fl_queue_deficit")))
    lines.append(_row("ckpt count", m.get("fl_checkpoints_total"),
                      "ckpt latency [s]",
                      m.get("fl_checkpoint_last_seconds")))
    lines.append(_row("compiles", m.get("fl_compiles_total"),
                      "compile secs", m.get("fl_compile_seconds_total")))
    lines.append(_row("fault rounds", m.get("fl_fault_rounds_total"),
                      "evals", m.get("fl_evals_total")))
    lines.append(_row("chaos kills", m.get("chaos_sigkills_total"),
                      "chaos restarts", m.get("chaos_restarts_total")))
    span = status.get("last_span")
    if span:
        lines.append("-" * WIDTH)
        lines.append("  last segment span tree:")
        lines.extend(_span_lines(span))
    if recs:
        lines.append("-" * WIDTH)
        lines.append("  recent rounds (t / cluster / a / loss):")
        for r in recs[-3:]:
            lines.append(f"    t={_fmt(r.get('t'))}"
                         f"  c={r.get('cluster')}  a={r.get('a')}"
                         f"  loss={_fmt(r.get('loss'))}")
    lines.append("=" * WIDTH)
    return "\n".join(lines)
