"""Structured timing spans with device fencing (a copy of the JAX
package's ``repro.obs.spans``; `fence` waits with `torch.cuda.synchronize`).

``SpanRecorder.span(name)`` is a context manager producing a *tree* of
timed spans — ``segment`` wraps ``round``/``checkpoint`` wraps
``host_sync``/``eval`` — so a serve segment's wall-clock decomposes into
host-dispatch vs device-compute vs checkpoint-I/O instead of one opaque
number.  The honesty comes from **fencing**: passing ``fence_on=tree``
makes the span synchronize the card the tree's tensors live on before
stamping its end time, so a span that dispatched async device work is
charged for the compute it launched, not just the Python time it spent
enqueueing it.  A ``Span.mark("dispatch")`` inside the body records the
dispatch→fence split as an attribute.

Completed **root** spans are emitted to an optional sink (the run dir's
``metrics.jsonl``, via the same `JsonlSink` machinery as ``trace.jsonl``)
as schema-versioned records::

    {"schema": "span/1", "ts": <unix>, "name": "segment", "dur_s": ...,
     "attrs": {...}, "children": [{"name": "round", ...}, ...]}

Child spans nest inside their parent's ``children`` and are not emitted
separately.  The recorder is not thread-safe; each engine/serve process
owns its own.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch

SPAN_SCHEMA = "span/1"


def _tensors(tree: Any):
    """Every tensor leaf of a tree of dicts, lists, tuples and
    dataclasses."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def fence(tree: Any) -> Any:
    """Wait for the card's work on ``tree``: one `torch.cuda.synchronize`
    for each CUDA device among its tensor leaves.  CPU tensors and trees
    without tensors need no wait."""
    devices = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


class Span:
    """One timed node in the tree.  ``dur_s`` is set on exit."""

    __slots__ = ("name", "ts", "dur_s", "attrs", "children", "_t0")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.ts = time.time()
        self._t0 = time.perf_counter()
        self.dur_s: float = 0.0
        self.attrs = dict(attrs)
        self.children: List["Span"] = []

    def mark(self, label: str) -> float:
        """Record elapsed-so-far as attr ``<label>_s`` (e.g. the
        dispatch→fence boundary inside a fenced round span)."""
        dt = time.perf_counter() - self._t0
        self.attrs[f"{label}_s"] = dt
        return dt

    def child_dur(self, name: str) -> float:
        return sum(c.dur_s for c in self.children if c.name == name)

    def to_dict(self) -> dict:
        d: dict = {"name": self.name, "ts": self.ts, "dur_s": self.dur_s}
        if self.attrs:
            d["attrs"] = self.attrs
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class SpanRecorder:
    """Builds span trees; emits completed roots to ``sink`` and retains
    the last ``max_retained`` roots in ``.finished`` for in-process
    consumers (benchmarks, tests, the dashboard's same-process path)."""

    def __init__(self, sink=None, retain: bool = True,
                 max_retained: int = 256):
        self.sink = sink
        self.retain = bool(retain)
        self.finished: deque = deque(maxlen=int(max_retained))
        self._stack: List[Span] = []

    @property
    def current(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None

    @contextmanager
    def span(self, name: str, fence_on: Any = None, **attrs):
        sp = Span(name, attrs)
        self._stack.append(sp)
        try:
            yield sp
        finally:
            if fence_on is not None:
                fence(fence_on)
            sp.dur_s = time.perf_counter() - sp._t0
            self._stack.pop()
            if self._stack:
                self._stack[-1].children.append(sp)
            else:
                if self.retain:
                    self.finished.append(sp)
                if self.sink is not None:
                    self.sink.append({"schema": SPAN_SCHEMA, **sp.to_dict()})

    def last(self, name: Optional[str] = None) -> Optional[Span]:
        """Most recent finished root span (optionally by name)."""
        for sp in reversed(self.finished):
            if name is None or sp.name == name:
                return sp
        return None
