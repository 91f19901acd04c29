"""The long-running federation service: run-dir layout + segment loop (a
copy of the JAX package's ``repro.serve.service``: the same run dir, file
names and formats, so each package's read-only tools read the other's run
dirs; `run_service` also takes the ``device`` the federation runs on).

A service instance is a directory (``--run-dir``):

    run_dir/
      spec.json        the resolved FederationSpec (config round-trip form)
      serve.json       live service state (status/pid/rounds/last metrics)
      serve.pid        pid of the running service process
      serve.log        stdout+stderr of a daemonized service
      trace.jsonl      streamed RoundRecords (one JSON object per line)
      control/         drop-box: ``stop.req`` / ``checkpoint.req`` files
      checkpoints/     ckpt_XXXXXXXX.npz + .json manifests (runner.py)

Coordination is deliberately file-based: the CLI talks to a running
service through atomically-written JSON (``serve.json``), the pidfile,
and request files the loop polls **between segments** — no sockets, no
threads next to the card's work.  SIGTERM/SIGINT set the same stop flag
the ``stop.req`` file does, so ``kill <pid>`` and ``python -m
repro_torch.serve stop`` both produce a final checkpoint before exit.

`run_service` is the in-process entry: build the federation from
``spec.json``, optionally adopt the newest checkpoint, stream the trace,
and loop segments until stopped or ``max_segments``.

A sharded spec (a mesh of G > 1 shards) runs as a job of G ranks under
one supervising process (`repro_torch.launch.distributed.run_job`; the
CLI starts it), whose pid is the pidfile's and the state's.  Every rank
runs the loop: the segments and the checkpoints' gathers are collectives.
Rank 0 owns the run dir: the trace, the state, the metrics and the
checkpoints, whole and in the unsharded layout (`runner.save_resumable`).
At each segment boundary rank 0 reads the stop flag, ``max_segments`` and
``control/stop.req`` and broadcasts the decision, so every rank leaves
after the same segment; a resume restores every rank from the
checkpoint rank 0 picked.  Daemonization is
the CLI's job (`__main__.py` re-execs ``start --foreground`` under
``start_new_session``); this module never forks — CUDA cannot be used in
a child forked after it was initialised.
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import Any, Dict, Optional

from repro_torch.api import Federation, FederationSpec
from repro_torch.api.records import JsonlSink, tail_jsonl
from repro_torch.launch.distributed import (ENV_JOB, agree, in_job,
                                            job_rank)
from repro_torch.obs import (SPAN_SCHEMA, EngineObs, MetricsRegistry,
                             merge_snapshot_records)

from .runner import (SegmentRunner, latest_resumable,
                     truncate_jsonl_trace)

SPEC_FILE = "spec.json"
STATE_FILE = "serve.json"
PID_FILE = "serve.pid"
LOG_FILE = "serve.log"
TRACE_FILE = "trace.jsonl"
METRICS_FILE = "metrics.jsonl"
CONTROL_DIR = "control"
CKPT_DIR = "checkpoints"
STOP_REQ = "stop.req"
CKPT_REQ = "checkpoint.req"


# --------------------------------------------------------------------- #
# run-dir primitives
# --------------------------------------------------------------------- #
def atomic_write_json(path: str, obj: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_json(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def child_env() -> Dict[str, str]:
    """This process's environment with the directory that holds
    `repro_torch` first on ``PYTHONPATH``, for the ``python -m
    repro_torch.serve`` children the CLI and the chaos harness spawn."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    return env


def pid_alive(pid: Optional[int]) -> bool:
    """Whether ``pid`` runs (a zombie, dead but not yet reaped, does
    not)."""
    if not pid:
        return False
    try:
        os.kill(int(pid), 0)
    except (OSError, ValueError):
        return False
    try:
        with open(f"/proc/{int(pid)}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return True


def job_pid() -> int:
    """The pid that stands for this process's service or pool: its job's
    supervisor for a rank of a sharded one, else its own."""
    return int(os.environ.get(ENV_JOB, os.getpid()))


def job_pids() -> list:
    """Every rank's pid, in rank order (a collective in a job)."""
    import torch.distributed as dist
    if not (in_job() and dist.is_initialized()):
        return [os.getpid()]
    pids = [None] * dist.get_world_size()
    dist.all_gather_object(pids, os.getpid())
    return pids


def stop_agreed(lead: bool, stopping: Dict[str, bool], rd: "RunDir",
                done: bool) -> bool:
    """Whether every rank leaves now: rank 0 (``lead``) takes
    ``control/stop.req`` (consumed whatever else stops the loop, so a
    ``stop``'s request does not stop the next ``resume`` at once), reads
    the stop flag and ``done`` (``max_segments`` reached), and broadcasts
    its decision (`agree`)."""
    stop = lead and (rd.take_request(STOP_REQ) or stopping["flag"] or done)
    return agree(stop)


class RunDir:
    """Path helpers + the small file protocol of one service instance."""

    def __init__(self, root: str):
        self.root = str(root)

    def path(self, name: str) -> str:
        return os.path.join(self.root, name)

    @property
    def spec_path(self):
        return self.path(SPEC_FILE)

    @property
    def trace_path(self):
        return self.path(TRACE_FILE)

    @property
    def metrics_path(self):
        return self.path(METRICS_FILE)

    @property
    def ckpt_dir(self):
        return self.path(CKPT_DIR)

    def ensure(self) -> "RunDir":
        os.makedirs(self.path(CONTROL_DIR), exist_ok=True)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        return self

    # spec ------------------------------------------------------------- #
    def write_spec(self, spec: FederationSpec) -> None:
        atomic_write_json(self.spec_path, spec.to_dict())

    def load_spec(self) -> FederationSpec:
        d = read_json(self.spec_path)
        if d is None:
            raise FileNotFoundError(
                f"{self.spec_path} missing or unreadable — is "
                f"{self.root!r} a service run dir?")
        return FederationSpec.from_dict(d)

    # state / pid ------------------------------------------------------ #
    def write_state(self, **kw) -> Dict[str, Any]:
        state = dict(kw)
        state["updated"] = time.time()
        atomic_write_json(self.path(STATE_FILE), state)
        return state

    def read_state(self) -> Optional[Dict[str, Any]]:
        return read_json(self.path(STATE_FILE))

    def write_pid(self) -> None:
        with open(self.path(PID_FILE), "w") as f:
            f.write(str(os.getpid()))

    def read_pid(self) -> Optional[int]:
        try:
            with open(self.path(PID_FILE)) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def clear_pid(self) -> None:
        try:
            os.remove(self.path(PID_FILE))
        except OSError:
            pass

    def running_pid(self) -> Optional[int]:
        """Pid of a live service process; a stale pidfile (SIGKILLed
        daemon never reaches its ``finally`` cleanup) is removed so the
        run dir is immediately restartable."""
        pid = self.read_pid()
        if pid_alive(pid):
            return pid
        if pid is not None:
            self.clear_pid()
        return None

    # control drop-box ------------------------------------------------- #
    def request(self, name: str) -> None:
        with open(os.path.join(self.path(CONTROL_DIR), name), "w") as f:
            f.write(str(time.time()))

    def take_request(self, name: str) -> bool:
        """Consume a request file if present (one poll, between segments)."""
        try:
            os.remove(os.path.join(self.path(CONTROL_DIR), name))
        except OSError:
            return False
        return True


# --------------------------------------------------------------------- #
# the service loop
# --------------------------------------------------------------------- #
def run_service(run_dir: str, *, segment_rounds: int = 25,
                max_segments: Optional[int] = None, keep: Optional[int] = 3,
                resume: bool = False, device=None,
                log=print) -> Dict[str, Any]:
    """Run the segment loop in this process until stopped, on ``device``
    (the card unless the caller asks for another).

    ``resume=False`` expects an empty checkpoint dir (a fresh ``start``);
    ``resume=True`` requires one and continues from the newest checkpoint,
    first truncating ``trace.jsonl`` back to the checkpointed round so the
    continued stream equals an uninterrupted run's.  Returns the final
    service state dict.
    """
    rd = RunDir(run_dir).ensure()
    spec = rd.load_spec()
    lead = job_rank() == 0              # rank 0 owns the run dir
    if not lead:
        log = _quiet

    stopping = {"flag": False}

    def _on_signal(signum, frame):
        stopping["flag"] = True

    prev = {sig: signal.signal(sig, _on_signal)
            for sig in (signal.SIGTERM, signal.SIGINT)}
    if not in_job():                    # a job's supervisor holds it
        rd.write_pid()
    fed = None
    try:
        fed = Federation.from_spec(spec, device=device)
        runner = SegmentRunner(fed, rd.ckpt_dir,
                               segment_rounds=segment_rounds, keep=keep,
                               write=lead)
        if resume:
            found = agree(latest_resumable(rd.ckpt_dir) if lead else None)
            if found is None:
                raise FileNotFoundError(
                    f"resume: no complete checkpoint under {rd.ckpt_dir}")
            manifest = runner.resume_from(found[0])
            dropped = (truncate_jsonl_trace(rd.trace_path,
                                            manifest["rounds"])
                       if lead else 0)
            log(f"resumed from round {manifest['rounds']} "
                f"(segment {runner.segment}"
                + (f", dropped {dropped} unreplayed trace records"
                   if dropped else "") + ")")

        fed.engine.set_trace_sink(JsonlSink(rd.trace_path) if lead
                                  else None, retain=False)

        # telemetry: spans + registry snapshots stream into metrics.jsonl
        # beside the trace; the engine publishes through the same bundle
        obs = EngineObs(sink=JsonlSink(rd.metrics_path) if lead else None,
                        source="service")
        fed.engine.set_obs(obs)
        runner.obs = obs
        if resume:
            obs.registry.counter(
                "service_resumes_total", "checkpointed resumes").inc(1)
        ranks = {"ranks": job_pids()} if in_job() else {}

        def publish(status: str, **extra) -> Dict[str, Any]:
            if not lead:
                return {}
            last = (tail_jsonl(rd.trace_path, n=1) or [None])[-1]
            return rd.write_state(
                status=status, pid=job_pid(), scenario=spec.task.kind,
                segment=runner.segment, segment_rounds=segment_rounds,
                rounds=runner.rounds, energy=runner.energy,
                last_loss=(last or {}).get("loss"),
                last_acc=(last or {}).get("acc"), **ranks, **extra)

        publish("running")
        t0 = time.monotonic()
        base_segment = runner.segment   # max_segments counts THIS run's
        while not stop_agreed(          # segments, not the lifetime total
                lead, stopping, rd, max_segments is not None
                and runner.segment - base_segment >= max_segments):
            seg_t0 = time.monotonic()
            runner.run_segment()        # K rounds + checkpoint
            if lead:
                rd.take_request(CKPT_REQ)   # just checkpointed: consume
            dt = time.monotonic() - seg_t0
            rps = round(segment_rounds / max(dt, 1e-9), 3)
            obs.registry.gauge(
                "service_rounds_per_sec",
                "wall-clock throughput of the last segment").set(rps)
            obs.flush_snapshot()        # one metrics.jsonl record/segment
            publish("running", rounds_per_sec=rps)
            log(f"segment {runner.segment}: round {runner.rounds}, "
                f"energy {runner.energy:.1f} J, {dt:.2f}s")
        obs.flush_snapshot()            # farewell snapshot
        state = publish("stopped",
                        wall_seconds=round(time.monotonic() - t0, 3))
        log(f"stopped after {runner.segment} segments "
            f"({runner.rounds} rounds)")
        return state
    except BaseException as e:
        if lead:
            rd.write_state(status="failed", pid=job_pid(),
                           error=f"{type(e).__name__}: {e}")
        raise
    finally:
        if fed is not None:     # stop listening to kernel-library loads
            fed.engine.set_obs(None)
        if not in_job():
            rd.clear_pid()
        for sig, handler in prev.items():
            signal.signal(sig, handler)


def _quiet(*args, **kwargs) -> None:
    """The log of a rank other than 0: rank 0 speaks for the job."""


# --------------------------------------------------------------------- #
# status (read-only, works with or without a live process)
# --------------------------------------------------------------------- #
def load_run_metrics(run_dir: str, *, tail: int = 512
                     ) -> Optional[Dict[str, Any]]:
    """Merged last metrics snapshot of a run dir's ``metrics.jsonl``.

    Reads only the file's tail, folds the latest snapshot record of each
    source (service / chaos) into one family dict — the input both the
    Prometheus dump (`MetricsRegistry.from_snapshot`) and the dashboard
    consume.  None when the run has no metrics yet."""
    rd = RunDir(run_dir)
    return merge_snapshot_records(tail_jsonl(rd.metrics_path, n=tail))


def last_spans(run_dir: str, *, n: int = 2, tail: int = 256) -> list:
    """The last ``n`` span-tree records (schema ``span/1``) of a run
    dir's ``metrics.jsonl`` — typically the most recent segment trees."""
    rd = RunDir(run_dir)
    spans = [r for r in tail_jsonl(rd.metrics_path, n=tail)
             if r.get("schema") == SPAN_SCHEMA]
    return spans[-n:]


def service_status(run_dir: str, tail: int = 5) -> Dict[str, Any]:
    """Status snapshot: serve.json + liveness + trace tail + checkpoints
    + the telemetry summary (metric totals and the last segment's span
    tree, both read off ``metrics.jsonl`` — no live process needed)."""
    rd = RunDir(run_dir)
    state = rd.read_state() or {}
    pid = rd.running_pid()
    if pid is None and state.get("status") == "running":
        state["status"] = "dead"        # crashed without a farewell write
    latest = latest_resumable(rd.ckpt_dir)
    snap = load_run_metrics(run_dir)
    metrics: Optional[Dict[str, Any]] = None
    if snap is not None:
        metrics = MetricsRegistry.from_snapshot(snap).totals()
    spans = last_spans(run_dir, n=1)
    return {
        "run_dir": rd.root,
        "alive": pid is not None,
        "pid": pid,
        "state": state,
        "last_records": tail_jsonl(rd.trace_path, n=tail),
        "latest_checkpoint": latest[0] if latest else None,
        "checkpoint_manifest": latest[1] if latest else None,
        "metrics": metrics,
        "last_span": spans[-1] if spans else None,
    }
