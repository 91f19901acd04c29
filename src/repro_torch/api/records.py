"""The one trace schema both execution scales emit (a copy of the JAX
package's ``repro.api.records``: same dataclasses, same JSONL format, so
each package reads the other's traces).

`RoundRecord` is a single evaluation point; `FLTrace` is the sequence plus
the list-style views (`times`, `accs`, ...) that the legacy
``core.async_fl.FLTrace`` exposed, so existing benchmark/plot code ports by
attribute access alone.

For runs of unbounded length (the service mode) a trace can
*stream* instead of accumulate: construct it with a ``sink`` (any object
with ``append(RoundRecord)``, e.g. `JsonlSink`) and ``retain=False`` and
every record is handed to the sink without being held in memory —
``summary()`` still works off the last record and the running count.  The
batch default (``retain=True``, no sink) is unchanged.  `read_jsonl_trace`
loads a streamed file back into an in-memory trace; `tail_jsonl` reads the
last records of an arbitrarily long file without loading it (the service
``status`` command's live-metrics path).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, List, Optional


@dataclasses.dataclass
class RoundRecord:
    t: float                    # simulated seconds (device) / round (lm)
    round: int                  # global round counter
    cluster: int                # cluster that triggered this record
    a: int                      # local-update count a_i chosen that round
    loss: float
    acc: Optional[float]        # None for tasks without a notion of accuracy
    energy: float               # cumulative simulated energy [J]
    agg_count: int              # global aggregations so far

    @classmethod
    def from_dict(cls, d: dict) -> "RoundRecord":
        return cls(**{f.name: d.get(f.name)
                      for f in dataclasses.fields(cls)})


class JsonlSink:
    """Append-only JSONL writer: one record dict per line.

    Accepts dataclass records (`RoundRecord`) or plain dicts (the
    ``metrics.jsonl`` span/snapshot/event records).  The file handle
    stays open across appends (a segment flushes K records in a burst)
    and every line is flushed immediately, so an external ``tail -f`` —
    or the service ``status`` command — sees records as they land.
    Appending to an existing file continues it, which is exactly what a
    resumed run wants.  Every append stat-checks the path against the
    open handle's inode and re-opens if the file was rotated or unlinked
    underneath it, so log rotation of a long-serving run can't silently
    drop records into an orphaned handle.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._f = None

    def _ensure_open(self) -> None:
        if self._f is not None:
            # rotation check: same inode+device still at our path?
            try:
                st = os.stat(self.path)
                fst = os.fstat(self._f.fileno())
                if (st.st_ino, st.st_dev) == (fst.st_ino, fst.st_dev):
                    return
            except OSError:
                pass                    # unlinked / renamed away
            self._f.close()
            self._f = None
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(self.path, "a")

    def append(self, rec) -> None:
        if dataclasses.is_dataclass(rec):
            rec = dataclasses.asdict(rec)
        self._ensure_open()
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclasses.dataclass
class FLTrace:
    records: List[RoundRecord] = dataclasses.field(default_factory=list)
    sink: Optional[Any] = None       # .append(RoundRecord) tap, e.g. JsonlSink
    retain: bool = True              # False: stream-only (records stays empty)
    n_records: int = dataclasses.field(default=0, init=False)
    last: Optional[RoundRecord] = dataclasses.field(default=None, init=False)

    def __post_init__(self):
        self.n_records = len(self.records)
        self.last = self.records[-1] if self.records else None

    def append(self, rec: RoundRecord):
        self.n_records += 1
        self.last = rec
        if self.sink is not None:
            self.sink.append(rec)
        if self.retain:
            self.records.append(rec)

    # legacy list views ------------------------------------------------ #
    @property
    def times(self):
        return [r.t for r in self.records]

    @property
    def accs(self):
        return [r.acc for r in self.records]

    @property
    def losses(self):
        return [r.loss for r in self.records]

    @property
    def energies(self):
        return [r.energy for r in self.records]

    @property
    def agg_counts(self):
        return [r.agg_count for r in self.records]

    # ------------------------------------------------------------------ #
    def to_dicts(self):
        return [dataclasses.asdict(r) for r in self.records]

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dicts(), **kw)

    def summary(self) -> dict:
        if self.last is None:
            return {}
        last = self.last
        return {"final_loss": last.loss, "final_acc": last.acc,
                "energy": last.energy, "aggregations": last.agg_count,
                "rounds": last.round, "evals": self.n_records}


# --------------------------------------------------------------------- #
# JSONL trace files (the streamed form)
# --------------------------------------------------------------------- #
def read_jsonl_trace(path: str) -> FLTrace:
    """Load a streamed trace file back into an in-memory `FLTrace`.

    A torn **final** line — the signature of a writer killed
    mid-`JsonlSink.append` (the chaos harness produces these on every
    SIGKILL) — is skipped, so status/resume on a crashed run dir works.
    An unparseable line *followed by* further records is real corruption
    and still raises.
    """
    trace = FLTrace()
    torn: Optional[json.JSONDecodeError] = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if torn is not None:        # bad line was not the last one
                raise torn
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                torn = e
                continue
            trace.append(RoundRecord.from_dict(rec))
    return trace


def tail_jsonl(path: str, n: int = 10, block: int = 8192) -> List[dict]:
    """Last ``n`` records of a JSONL file, reading only its tail.

    Seeks backward in ``block``-byte chunks until enough newlines are in
    hand, so ``status`` on a multi-gigabyte trace stays O(n) — the whole
    point of streaming the trace in the first place.  Returns parsed dicts
    oldest-first; a torn final line (a writer mid-append) is skipped.
    """
    try:
        size = os.path.getsize(path)
    except OSError:
        return []
    if size == 0:
        return []
    chunks = []
    newlines = 0
    with open(path, "rb") as f:
        pos = size
        while pos > 0 and newlines <= n:
            step = min(block, pos)
            pos -= step
            f.seek(pos)
            chunk = f.read(step)
            chunks.append(chunk)
            newlines += chunk.count(b"\n")
    data = b"".join(reversed(chunks))
    out = []
    for line in data.splitlines()[-(n + 1):]:
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            continue                  # torn head (partial first line) / tail
    return out[-n:]
