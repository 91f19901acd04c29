"""Service CLI of the port — the long-running federation front end (the
JAX package's ``python -m repro.serve``: the same subcommands, flags, exit
codes and run dirs, plus ``--device``).

    # start the anomaly-detection service on the card, in the background
    PYTHONPATH=src python -m repro_torch.serve start --run-dir /tmp/fl \\
        --scenario autoencoder-anomaly --segment-rounds 25

    PYTHONPATH=src python -m repro_torch.serve status     --run-dir /tmp/fl
    PYTHONPATH=src python -m repro_torch.serve checkpoint --run-dir /tmp/fl
    PYTHONPATH=src python -m repro_torch.serve stop       --run-dir /tmp/fl
    PYTHONPATH=src python -m repro_torch.serve resume     --run-dir /tmp/fl

``--device`` (``start``, ``resume``, ``chaos``) picks where the federation
runs: ``cuda`` by default, ``cpu`` for the plain versions of the kernels;
without a card, only ``--device cpu`` runs.  A scenario or spec the port
does not run yet (a sharded spec or population among them) exits with
code 2 naming its ROADMAP item.

``pool start|resume|status|stop`` drive a population of federations in
one process (`pool.run_pool`) into per-member run dirs, with the same
flags and ``--device``:

    PYTHONPATH=src python -m repro_torch.serve pool start --run-dir /tmp/p \
        --spec-file population.json --segment-rounds 10
    PYTHONPATH=src python -m repro_torch.serve pool status --run-dir /tmp/p

``start`` resolves a scenario spec, writes it to ``spec.json``, and
(by default) re-execs itself as a detached ``start --foreground`` child —
a spawn, not a fork: CUDA cannot be used in a forked child once it has
started.  The child
owns the pidfile and the segment loop (`service.run_service`); the parent
waits for the pidfile and returns.  ``--foreground`` runs the loop in
this process instead (CI smoke tests, systemd-style supervisors).

``stop`` drops ``control/stop.req`` *and* sends SIGTERM — either alone
suffices; the loop finishes its current segment, writes a final
checkpoint, and exits.  ``resume`` continues a stopped run-dir from its
newest checkpoint, bit-exactly.  ``checkpoint`` on a live service
requests one and waits for it; on a stopped run-dir it prints the newest
checkpoint path (exit 1 if none exists).  ``chaos`` runs the supervised
crash-recovery harness (`chaos.py`).

Waiting commands (``checkpoint --wait`` semantics, ``stop``) poll with
capped exponential backoff instead of a tight fixed sleep, and a timeout
exits with the dedicated code ``EXIT_TIMEOUT`` (3) so supervisors can
tell "still busy" from "failed".  All commands tolerate the stale
pidfile a SIGKILLed daemon leaves behind (`RunDir.running_pid` cleans
it), so a chaos-killed run dir is immediately resumable.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

from repro_torch.device import resolve_device

from .runner import latest_resumable
from .service import (CKPT_REQ, LOG_FILE, STOP_REQ, RunDir, child_env,
                      pid_alive, run_service, service_status)

EXIT_TIMEOUT = 3                        # waited past --timeout; retryable
EXIT_UNPORTED = 2                       # the port does not run this yet


def _poll(predicate, timeout: float, *, first: float = 0.05,
          cap: float = 1.0):
    """Poll ``predicate`` with capped exponential backoff until it returns
    non-None or ``timeout`` elapses.  Returns the predicate's value, or
    None on timeout.  The backoff keeps short waits snappy (50 ms first
    check) without hammering the filesystem during a long segment."""
    deadline = time.monotonic() + timeout
    delay = first
    while True:
        val = predicate()
        if val is not None:
            return val
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return None
        time.sleep(min(delay, remaining, cap))
        delay = min(delay * 2.0, cap)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="long-running federation service with checkpointed "
                    "resume")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--run-dir", required=True,
                       help="service instance directory")
        return p

    def device_flag(p):
        p.add_argument("--device", default="cuda",
                       help="where the federation runs: the card "
                            "(default) or 'cpu' for the plain versions of "
                            "the kernels")
        return p

    def loop_flags(p):
        p.add_argument("--segment-rounds", type=int, default=25,
                       help="rounds per scanned segment (checkpoint "
                            "cadence)")
        p.add_argument("--max-segments", type=int, default=None,
                       help="stop after N segments (default: run until "
                            "stopped)")
        p.add_argument("--keep", type=int, default=3,
                       help="checkpoints retained on disk (0 = all)")
        p.add_argument("--foreground", action="store_true",
                       help="run the loop in this process instead of "
                            "daemonizing")
        return device_flag(p)

    p = loop_flags(common(sub.add_parser(
        "start", help="start a fresh service instance")))
    p.add_argument("--scenario", default="autoencoder-anomaly",
                   help="scenario preset for the spec (ignored when the "
                        "run dir already has spec.json)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--spec-file", default=None,
                   help="JSON spec file instead of --scenario")

    loop_flags(common(sub.add_parser(
        "resume", help="continue a stopped run from its newest "
                       "checkpoint")))

    p = common(sub.add_parser("status", help="print service status JSON"))
    p.add_argument("--tail", type=int, default=5,
                   help="trace records to include")
    p.add_argument("--watch", action="store_true",
                   help="render a refreshing terminal dashboard instead "
                        "of JSON")
    p.add_argument("--interval", type=float, default=2.0,
                   help="dashboard refresh period in seconds")
    p.add_argument("--once", action="store_true",
                   help="with --watch: render a single frame and exit "
                        "(CI / piping)")

    common(sub.add_parser(
        "metrics", help="dump the run dir's last metrics snapshot in "
                        "Prometheus text-exposition format"))

    p = common(sub.add_parser(
        "checkpoint", help="request/locate a checkpoint"))
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds to wait for a live service to finish "
                        "its segment")

    p = common(sub.add_parser("stop", help="stop a running service"))
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds to wait for the final segment + "
                        "checkpoint")

    p = sub.add_parser(
        "pool", help="multi-tenant supervisor: one process drives a "
                     "population of federations into per-member run dirs")
    pool_sub = p.add_subparsers(dest="pool_cmd", required=True)
    p = loop_flags(common(pool_sub.add_parser(
        "start", help="start a fresh pool instance")))
    p.add_argument("--scenario", default="autoencoder-anomaly",
                   help="base-spec scenario preset (ignored when the run "
                        "dir already has pool.json)")
    p.add_argument("--seed", type=int, default=None,
                   help="base seed (member seeds derive via fold_in)")
    p.add_argument("--replicates", type=int, default=4,
                   help="seed replicates of the base spec (population "
                        "size when no --spec-file grid)")
    p.add_argument("--spec-file", default=None,
                   help="PopulationSpec JSON file instead of --scenario")
    loop_flags(common(pool_sub.add_parser(
        "resume", help="continue a stopped pool from the newest common "
                       "verified checkpoint")))
    p = common(pool_sub.add_parser(
        "status", help="print pool status JSON (per-member summary)"))
    p.add_argument("--tail", type=int, default=1,
                   help="trace records per member to include")
    p = common(pool_sub.add_parser("stop", help="stop a running pool"))
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds to wait for the final segment + "
                        "checkpoint sweep")

    p = common(sub.add_parser(
        "chaos", help="supervised crash-recovery harness: run to N "
                      "segments, SIGKILLing the service along the way"))
    p.add_argument("--scenario", default="autoencoder-anomaly")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--spec-file", default=None)
    p.add_argument("--segment-rounds", type=int, default=5)
    p.add_argument("--total-segments", type=int, default=4,
                   help="verified segments to reach before exiting")
    p.add_argument("--kills", type=int, default=2,
                   help="SIGKILL injections before letting it finish")
    p.add_argument("--keep", type=int, default=0,
                   help="checkpoints retained (0 = all)")
    p.add_argument("--max-restarts", type=int, default=8,
                   help="consecutive no-progress restarts tolerated")
    device_flag(p)
    return ap


# --------------------------------------------------------------------- #
def _resolve_spec(args):
    from repro_torch.api import scenarios  # noqa: F401  (SCENARIOS)
    from repro_torch.api.registry import SCENARIOS
    from repro_torch.api.spec import (DEVICE_SCALE, GSPMD_DEVICE_SCALE,
                                      FederationSpec)
    if args.spec_file:
        with open(args.spec_file) as f:
            spec = FederationSpec.from_dict(json.load(f))
    else:
        spec = SCENARIOS.get(args.scenario)()
    if args.seed is not None:
        spec = spec.replace(seed=args.seed)
    spec.validate()
    if spec.sharding.is_sharded:
        # a segment's checkpoint would be every rank's shard of it
        raise NotImplementedError(
            f"not ported yet: a sharded service (mesh {spec.sharding.mesh}; "
            "multi-device, ROADMAP.md, queue 1, item 9)")
    if spec.scale not in (DEVICE_SCALE, GSPMD_DEVICE_SCALE):
        # a segment is run_scanned(K), which only the device scale has
        raise NotImplementedError(
            f"not ported yet: the service mode of the {spec.scale!r} scale "
            "(its segments are device-scale run_scanned calls; ROADMAP.md, "
            "queue 1, item 10)")
    return spec


def _loop_argv(args) -> list:
    argv = ["--run-dir", args.run_dir, "--foreground",
            "--segment-rounds", str(args.segment_rounds),
            "--keep", str(args.keep), "--device", args.device]
    if args.max_segments is not None:
        argv += ["--max-segments", str(args.max_segments)]
    return argv


def _spawn(rd: RunDir, child_argv: list) -> int:
    """Detach a ``--foreground`` child (spawn, not fork — CUDA)."""
    with open(rd.path(LOG_FILE), "a") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.serve"] + child_argv,
            stdout=log, stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL, start_new_session=True,
            env=child_env())
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline:
        if rd.running_pid() == proc.pid:
            print(f"started pid {proc.pid} run-dir {rd.root}")
            return 0
        if proc.poll() is not None:
            print(f"error: service exited with code {proc.returncode}; "
                  f"see {rd.path(LOG_FILE)}", file=sys.stderr)
            return 1
        time.sleep(0.05)
    print(f"error: service pid {proc.pid} did not report ready; see "
          f"{rd.path(LOG_FILE)}", file=sys.stderr)
    return 1


def _no_device(args) -> bool:
    """Print `resolve_device`'s error when ``--device`` is not there (no
    card and no ``--device cpu``): the port never runs on the CPU
    unasked."""
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return True
    return False


def _refuse_if_running(rd: RunDir) -> bool:
    pid = rd.running_pid()
    if pid is not None:
        print(f"error: service already running (pid {pid}) in {rd.root}",
              file=sys.stderr)
        return True
    return False


# --------------------------------------------------------------------- #
def cmd_start(args) -> int:
    if _no_device(args):
        return 1
    rd = RunDir(args.run_dir).ensure()
    if _refuse_if_running(rd):
        return 1
    keep = args.keep if args.keep > 0 else None
    if os.path.exists(rd.spec_path):
        pass                            # re-exec'd child / explicit reuse
    else:
        if latest_resumable(rd.ckpt_dir) is not None:
            print(f"error: {rd.root} has checkpoints but no spec.json; "
                  "refusing to guess — use a fresh --run-dir",
                  file=sys.stderr)
            return 1
        try:
            rd.write_spec(_resolve_spec(args))
        except NotImplementedError as e:
            print(f"error: {e}", file=sys.stderr)
            return EXIT_UNPORTED
        except (KeyError, ValueError, OSError) as e:
            print(f"error: {e.args[0] if e.args else e}", file=sys.stderr)
            return 1
    if latest_resumable(rd.ckpt_dir) is not None:
        print(f"error: {rd.root} already has checkpoints; use "
              "`python -m repro_torch.serve resume` (or a fresh "
              "--run-dir)", file=sys.stderr)
        return 1
    if not args.foreground:
        return _spawn(rd, ["start"] + _loop_argv(args))
    run_service(rd.root, segment_rounds=args.segment_rounds,
                max_segments=args.max_segments, keep=keep, resume=False,
                device=args.device)
    return 0


def cmd_resume(args) -> int:
    if _no_device(args):
        return 1
    rd = RunDir(args.run_dir)
    if _refuse_if_running(rd):
        return 1
    if latest_resumable(rd.ckpt_dir) is None:
        print(f"error: no complete checkpoint under {rd.ckpt_dir}",
              file=sys.stderr)
        return 1
    keep = args.keep if args.keep > 0 else None
    if not args.foreground:
        return _spawn(rd, ["resume"] + _loop_argv(args))
    run_service(rd.root, segment_rounds=args.segment_rounds,
                max_segments=args.max_segments, keep=keep, resume=True,
                device=args.device)
    return 0


def cmd_status(args) -> int:
    if not getattr(args, "watch", False):
        print(json.dumps(service_status(args.run_dir, tail=args.tail),
                         indent=2))
        return 0
    from .dashboard import render
    try:
        while True:
            frame = render(service_status(args.run_dir, tail=args.tail))
            if args.once:
                print(frame)
                return 0
            # repaint in place: clear screen + home, then the frame
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def cmd_metrics(args) -> int:
    from repro_torch.obs import MetricsRegistry
    from .service import load_run_metrics
    snap = load_run_metrics(args.run_dir)
    if snap is None:
        print(f"error: no metrics snapshots under {args.run_dir} "
              "(has the service completed a segment?)", file=sys.stderr)
        return 1
    sys.stdout.write(MetricsRegistry.from_snapshot(snap).to_prometheus())
    return 0


def cmd_checkpoint(args) -> int:
    rd = RunDir(args.run_dir)
    pid = rd.running_pid()
    before = latest_resumable(rd.ckpt_dir)
    if pid is None:                     # stopped: just locate the newest
        if before is None:
            print(f"error: no complete checkpoint under {rd.ckpt_dir}",
                  file=sys.stderr)
            return 1
        print(before[0])
        return 0
    rd.ensure().request(CKPT_REQ)
    before_step = before[1]["step"] if before else -1

    def fresh_ckpt():
        now = latest_resumable(rd.ckpt_dir)
        if now is not None and now[1]["step"] > before_step:
            return now
        if not pid_alive(pid):          # service exited meanwhile: its
            now = latest_resumable(rd.ckpt_dir)   # farewell ckpt counts
            return now if now is not None else ("dead",)
        return None

    got = _poll(fresh_ckpt, args.timeout)
    if got is None:
        print(f"error: no checkpoint within {args.timeout:.0f}s (segment "
              "in flight?) — retry with a larger --timeout",
              file=sys.stderr)
        return EXIT_TIMEOUT
    if got == ("dead",):
        print("error: service died without leaving a checkpoint",
              file=sys.stderr)
        return 1
    print(got[0])
    return 0


def cmd_stop(args) -> int:
    rd = RunDir(args.run_dir)
    pid = rd.running_pid()
    if pid is None:
        print("service not running")
        return 0
    rd.ensure().request(STOP_REQ)
    try:
        os.kill(pid, signal.SIGTERM)
    except OSError:
        pass
    gone = _poll(lambda: (True if not pid_alive(pid) else None),
                 args.timeout)
    if gone:
        state = rd.read_state() or {}
        print(f"stopped pid {pid} at round {state.get('rounds')}")
        return 0
    print(f"error: pid {pid} still alive after {args.timeout:.0f}s "
          "(segment in flight?) — retry or kill -9", file=sys.stderr)
    return EXIT_TIMEOUT


def cmd_chaos(args) -> int:
    from .chaos import run_supervised
    if _no_device(args):
        return 1
    rd = RunDir(args.run_dir)
    if _refuse_if_running(rd):
        return 1
    if latest_resumable(rd.ckpt_dir) is None:
        # a spec the children cannot run fails here, not in a restart loop
        try:
            _resolve_spec(args)
        except NotImplementedError as e:
            print(f"error: {e}", file=sys.stderr)
            return EXIT_UNPORTED
        except (KeyError, ValueError, OSError) as e:
            print(f"error: {e.args[0] if e.args else e}", file=sys.stderr)
            return 1
    try:
        summary = run_supervised(
            args.run_dir, total_segments=args.total_segments,
            segment_rounds=args.segment_rounds, kills=args.kills,
            keep=args.keep, scenario=args.scenario,
            spec_file=args.spec_file, seed=args.seed,
            max_restarts=args.max_restarts, device=args.device,
            log=lambda m: print(m, file=sys.stderr))  # stdout: JSON only
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(summary, indent=2))
    return 0


# --------------------------------------------------------------------- #
# pool (multi-tenant) commands
# --------------------------------------------------------------------- #
def _resolve_pool_spec(args):
    from repro_torch.api import scenarios  # noqa: F401  (SCENARIOS)
    from repro_torch.api.registry import SCENARIOS
    from repro_torch.pop import PopulationSpec
    if args.spec_file:
        with open(args.spec_file) as f:
            pspec = PopulationSpec.from_dict(json.load(f))
    else:
        base = SCENARIOS.get(args.scenario)()
        pspec = PopulationSpec(base=base, replicates=args.replicates)
    if args.seed is not None:
        pspec = pspec.replace(base=pspec.base.replace(seed=args.seed))
    from .pool import runnable_pool_spec
    return runnable_pool_spec(pspec)


def _pool_member_dirs(root: str, size: int) -> list:
    from .pool import member_dir
    return [member_dir(root, b) for b in range(size)]


def _checked_pool_spec(root: str):
    """The validated ``pool.json`` of ``root`` and 0, or None and the exit
    code: 1 when it is missing, `EXIT_UNPORTED` when the port cannot run
    it (a sharded population names its ROADMAP item)."""
    from .pool import load_pool_spec, runnable_pool_spec
    try:
        return runnable_pool_spec(load_pool_spec(root)), 0
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return None, 1
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return None, EXIT_UNPORTED


def cmd_pool_start(args) -> int:
    from .pool import (POOL_SPEC_FILE, common_checkpoint_step,
                       ensure_pool_dir, run_pool, write_pool_spec)
    if _no_device(args):
        return 1
    rd = ensure_pool_dir(args.run_dir)
    if _refuse_if_running(rd):
        return 1
    keep = args.keep if args.keep > 0 else None
    if not os.path.exists(rd.path(POOL_SPEC_FILE)):
        try:
            write_pool_spec(rd.root, _resolve_pool_spec(args))
        except NotImplementedError as e:
            print(f"error: {e}", file=sys.stderr)
            return EXIT_UNPORTED
        except (KeyError, ValueError, OSError) as e:
            print(f"error: {e.args[0] if e.args else e}", file=sys.stderr)
            return 1
    pspec, rc = _checked_pool_spec(rd.root)
    if pspec is None:
        return rc
    if common_checkpoint_step(_pool_member_dirs(rd.root, pspec.size)) \
            is not None:
        print(f"error: {rd.root} already has member checkpoints; use "
              "`python -m repro_torch.serve pool resume` (or a fresh "
              "--run-dir)", file=sys.stderr)
        return 1
    if not args.foreground:
        return _spawn(rd, ["pool", "start"] + _loop_argv(args))
    run_pool(rd.root, segment_rounds=args.segment_rounds,
             max_segments=args.max_segments, keep=keep, resume=False,
             device=args.device)
    return 0


def cmd_pool_resume(args) -> int:
    from .pool import common_checkpoint_step, run_pool
    if _no_device(args):
        return 1
    rd = RunDir(args.run_dir)
    if _refuse_if_running(rd):
        return 1
    pspec, rc = _checked_pool_spec(rd.root)
    if pspec is None:
        return rc
    if common_checkpoint_step(_pool_member_dirs(rd.root, pspec.size)) \
            is None:
        print(f"error: no common verified checkpoint across the "
              f"{pspec.size} member dirs under {rd.root}",
              file=sys.stderr)
        return 1
    keep = args.keep if args.keep > 0 else None
    if not args.foreground:
        return _spawn(rd, ["pool", "resume"] + _loop_argv(args))
    run_pool(rd.root, segment_rounds=args.segment_rounds,
             max_segments=args.max_segments, keep=keep, resume=True,
             device=args.device)
    return 0


def cmd_pool_status(args) -> int:
    from .pool import pool_status
    print(json.dumps(pool_status(args.run_dir, tail=args.tail), indent=2))
    return 0


def cmd_pool(args) -> int:
    return {"start": cmd_pool_start, "resume": cmd_pool_resume,
            "status": cmd_pool_status,
            "stop": cmd_stop}[args.pool_cmd](args)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"start": cmd_start, "resume": cmd_resume,
            "status": cmd_status, "metrics": cmd_metrics,
            "checkpoint": cmd_checkpoint, "pool": cmd_pool,
            "stop": cmd_stop, "chaos": cmd_chaos}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
