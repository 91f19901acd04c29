"""Chaos harness: SIGKILL the service mid-run, supervise the recovery (a
copy of the JAX package's ``repro.serve.chaos``; the children are
``python -m repro_torch.serve`` on the ``device`` passed through, spawned,
never forked: CUDA cannot be used in a child forked after it started).

`run_supervised` drives a run dir to ``total_segments`` checkpointed
segments through repeated child processes, injecting ``kills`` SIGKILLs
along the way — each lands right after a fresh checkpoint, i.e. while the
next segment (and possibly a checkpoint write) is in flight, the worst
spot short of corrupting the npz on purpose.  SIGKILL skips every
``finally`` in the service: no farewell state write, no pidfile cleanup,
possibly a torn ``.tmp`` or half-written npz.  Recovery leans on exactly
the guarantees the serve layer advertises:

* `RunDir.running_pid` clears the stale pidfile, so ``resume`` is not
  refused;
* `latest_resumable` returns the newest checkpoint whose CRC32 digest
  still matches, silently stepping over torn writes;
* ``resume`` truncates ``trace.jsonl`` back to the checkpointed round, so
  the reconstructed trace is record-identical to an uninterrupted run
  (``tests/test_torch_serve.py`` byte-compares the two).

Restarts use capped exponential backoff; a child that dies repeatedly
without advancing the checkpoint frontier exhausts ``max_restarts`` and
raises — a crash-*loop* is a bug, a crash is routine.

A sharded spec's child stands for a job of G ranks (`__main__.py`): the
harness kills the child's whole process group, which every rank shares,
waits until none of the ranks the state names is alive (``left_alive``
in the kill's event lists any that outlived ``kill_timeout``), and the
restarted child starts a new job.

CLI: ``python -m repro_torch.serve chaos --run-dir ... --total-segments 4
--kills 2`` (see `__main__.py`).  The summary also gives each child's
start-up: seconds from its spawn to its pidfile (``pidfile_s``) and to its
``running`` state, the federation built or restored (``running_s``).
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

from repro_torch.api.records import JsonlSink
from repro_torch.obs import MetricsRegistry, snapshot_record

from .runner import latest_resumable
from .service import LOG_FILE, METRICS_FILE, RunDir, child_env, pid_alive


def segments_done(ckpt_dir: str) -> int:
    """Segment counter of the newest *verified* checkpoint (0 if none)."""
    found = latest_resumable(ckpt_dir)
    return int(found[1].get("segment", 0)) if found else 0


def spawn_service(run_dir: str, *, segment_rounds: int, max_segments: int,
                  keep: int = 0, scenario: Optional[str] = None,
                  spec_file: Optional[str] = None,
                  seed: Optional[int] = None,
                  device: Optional[str] = None) -> subprocess.Popen:
    """Spawn one ``--foreground`` service child for the run dir.

    Picks ``resume`` when a verified checkpoint exists, else ``start``
    (with the scenario/spec flags).  ``start_new_session`` isolates the
    child so the harness's SIGKILL never leaks to the supervisor."""
    rd = RunDir(run_dir).ensure()
    if latest_resumable(rd.ckpt_dir) is not None:
        argv = ["resume"]
    else:
        argv = ["start"]
        if spec_file:
            argv += ["--spec-file", spec_file]
        elif scenario:
            argv += ["--scenario", scenario]
        if seed is not None:
            argv += ["--seed", str(seed)]
    argv += ["--run-dir", run_dir, "--foreground",
             "--segment-rounds", str(segment_rounds),
             "--max-segments", str(max_segments), "--keep", str(keep)]
    if device is not None:
        argv += ["--device", str(device)]
    log = open(rd.path(LOG_FILE), "a")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.serve"] + argv,
            stdout=log, stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL, start_new_session=True,
            env=child_env())
    finally:
        log.close()


def run_supervised(run_dir: str, *, total_segments: int,
                   segment_rounds: int = 5, kills: int = 0,
                   keep: int = 0, scenario: Optional[str] = None,
                   spec_file: Optional[str] = None,
                   seed: Optional[int] = None, max_restarts: int = 8,
                   backoff0: float = 0.1, backoff_cap: float = 5.0,
                   poll: float = 0.05, kill_timeout: float = 600.0,
                   device: Optional[str] = None,
                   log=print) -> Dict[str, Any]:
    """Supervise the run dir to ``total_segments`` verified segments.

    While ``kills`` remain, each child is SIGKILLed as soon as it lands a
    checkpoint beyond the frontier; afterwards children run to completion.
    Any abnormal child exit (killed or crashed) triggers a restart after
    capped exponential backoff — but only ``max_restarts`` times without
    forward progress, so a deterministic crash surfaces instead of
    looping.  Returns a summary dict (segments/rounds/kills/restarts,
    and each child's start-up seconds).
    """
    rd = RunDir(run_dir)
    kills_left = int(kills)
    restarts = 0
    stalls = 0                          # consecutive restarts w/o progress
    backoff = backoff0
    events: List[Dict[str, Any]] = []
    startups: List[Dict[str, Optional[float]]] = []
    # supervisor-side telemetry: restart/kill counters snapshot into the
    # run dir's metrics.jsonl under source="chaos" — the child's
    # source="service" snapshots merge with these at read time
    # (`load_run_metrics`), so one file tells the whole recovery story
    reg = MetricsRegistry()
    m_kills = reg.counter("chaos_sigkills_total",
                          "SIGKILLs injected by the chaos harness")
    m_restarts = reg.counter("chaos_restarts_total",
                             "service children restarted")
    m_segments = reg.gauge("chaos_segments",
                           "verified checkpoint frontier")
    msink = JsonlSink(rd.path(METRICS_FILE))

    def snap() -> None:
        m_segments.set(segments_done(rd.ckpt_dir))
        msink.append(snapshot_record(reg, source="chaos", ts=time.time()))
    while segments_done(rd.ckpt_dir) < total_segments:
        done = segments_done(rd.ckpt_dir)
        t_spawn = time.monotonic()
        proc = spawn_service(
            run_dir, segment_rounds=segment_rounds,
            max_segments=total_segments - done, keep=keep,
            scenario=scenario, spec_file=spec_file, seed=seed,
            device=device)
        startup: Dict[str, Optional[float]] = {"pidfile_s": None,
                                               "running_s": None}
        startups.append(startup)

        def note_startup() -> None:
            if startup["pidfile_s"] is None and rd.read_pid() == proc.pid:
                startup["pidfile_s"] = time.monotonic() - t_spawn
            if startup["running_s"] is None:
                st = rd.read_state() or {}
                if st.get("pid") == proc.pid and \
                        st.get("status") == "running":
                    startup["running_s"] = time.monotonic() - t_spawn
        if kills_left > 0:
            deadline = time.monotonic() + kill_timeout
            while (proc.poll() is None
                   and segments_done(rd.ckpt_dir) <= done
                   and time.monotonic() < deadline):
                note_startup()
                time.sleep(poll)
            if proc.poll() is None:
                ranks = (rd.read_state() or {}).get("ranks", [])
                os.killpg(proc.pid, signal.SIGKILL)     # every rank too
                proc.wait()
                until = time.monotonic() + kill_timeout
                while (any(pid_alive(p) for p in ranks)
                       and time.monotonic() < until):
                    time.sleep(poll)
                kills_left -= 1
                m_kills.inc(1)
                snap()
                events.append({"event": "sigkill", "pid": proc.pid,
                               "ranks": ranks,
                               "left_alive": [p for p in ranks
                                              if pid_alive(p)],
                               "after_segment":
                                   segments_done(rd.ckpt_dir)})
                log(f"chaos: SIGKILLed pid {proc.pid} after segment "
                    f"{segments_done(rd.ckpt_dir)}")
        else:
            while proc.poll() is None:
                note_startup()
                time.sleep(poll)
        if segments_done(rd.ckpt_dir) >= total_segments:
            break
        if segments_done(rd.ckpt_dir) > done:
            stalls = 0                  # forward progress resets the cap
            backoff = backoff0
        else:
            stalls += 1
            if stalls > max_restarts:
                raise RuntimeError(
                    f"chaos: {max_restarts} restarts without progress in "
                    f"{run_dir} (exit {proc.returncode}); see "
                    f"{rd.path(LOG_FILE)}")
        # restart whatever the exit code: a clean exit with segments still
        # owed (stop request raced the count) resumes just like a crash
        restarts += 1
        m_restarts.inc(1)
        snap()
        events.append({"event": "restart", "backoff": backoff,
                       "exit": proc.returncode})
        time.sleep(backoff)
        backoff = min(backoff * 2.0, backoff_cap)
    snap()                              # final frontier + counter state
    found = latest_resumable(rd.ckpt_dir)
    return {
        "run_dir": run_dir,
        "segments": segments_done(rd.ckpt_dir),
        "rounds": int(found[1]["rounds"]) if found else 0,
        "kills": int(kills) - kills_left,
        "restarts": restarts,
        "events": events,
        "startups": startups,
    }
