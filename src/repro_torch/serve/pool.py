"""Multi-tenant sweep serving: one process, B checkpointed federations.

The port's counterpart of the JAX package's ``repro.serve.pool``, with the
same directory layout and formats, so each package's ``pool status``
reads the other's pool dir.  A pool instance is a directory
(``--run-dir``):

    pool_dir/
      pool.json        the resolved PopulationSpec (config round-trip form)
      serve.json       live pool state (status/pid/segment/rounds)
      serve.pid        pid of the running supervisor process
      serve.log        stdout+stderr of a daemonized supervisor
      metrics.jsonl    pool telemetry (``pop``-labeled series + span trees)
      control/         drop-box: ``stop.req`` (polled between segments)
      members/
        000/           a full single-tenant run dir per member:
          spec.json      the member's expanded FederationSpec
          trace.jsonl    the member's streamed RoundRecords
          checkpoints/   ckpt_XXXXXXXX.npz + manifests (runner.py format)
        001/ ...

Every member directory speaks the single-tenant file protocol:
``python -m repro_torch.serve status --run-dir pool_dir/members/000``
works, and a member's checkpoints have the leaf names and manifest of a
standalone service run of the same expanded spec.  What the pool adds is
the shared cadence: one `PopulationEngine.run_scanned` call advances all
B tenants together (one batched round a round), then each member
checkpoints into its own dir.

Resume picks the **maximum step every member has a verified checkpoint
for**: a crash mid-checkpoint-sweep leaves a ragged frontier (members
written before the crash are one segment ahead), and restoring the ragged
maxima would tear the shared cadence.  Each member restores from that
common step and its trace is truncated back to it, so the continued
per-member streams equal an uninterrupted run's
(`tests/test_torch_pool.py` holds this against a single-tenant service
run).  A member checkpoint of the JAX package (a typed PRNG-key leaf) is
refused, as `runner.restore_resumable` refuses a single-tenant one.

Telemetry publishes through `repro_torch.obs` with the member index as a
``pop`` label; the registry's cardinality guard collapses huge
populations into the overflow series instead of unbounded growth.
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import Any, Dict, List, Optional

from repro_torch.api.records import JsonlSink, tail_jsonl
from repro_torch.checkpoint import load_checkpoint, typed_key_leaves
from repro_torch.obs import EngineObs
from repro_torch.pop import PopulationEngine, PopulationSpec
from repro_torch.pop.spec import SHARDED_ITEM

from .runner import (_resumable_tree, list_resumable, save_resumable,
                     truncate_jsonl_trace, verify_checkpoint)
from .service import (CKPT_REQ, CONTROL_DIR, STOP_REQ, RunDir,
                      atomic_write_json, read_json)

POOL_SPEC_FILE = "pool.json"
MEMBERS_DIR = "members"


# --------------------------------------------------------------------- #
# pool run-dir primitives
# --------------------------------------------------------------------- #
def member_dir(pool_dir: str, b: int) -> str:
    return os.path.join(str(pool_dir), MEMBERS_DIR, f"{b:03d}")


def write_pool_spec(pool_dir: str, pspec: PopulationSpec) -> None:
    atomic_write_json(os.path.join(str(pool_dir), POOL_SPEC_FILE),
                      pspec.to_dict())


def load_pool_spec(pool_dir: str) -> PopulationSpec:
    path = os.path.join(str(pool_dir), POOL_SPEC_FILE)
    d = read_json(path)
    if d is None:
        raise FileNotFoundError(
            f"{path} missing or unreadable — is {pool_dir!r} a pool run "
            "dir?")
    return PopulationSpec.from_dict(d)


def runnable_pool_spec(pspec: PopulationSpec) -> PopulationSpec:
    """``pspec`` validated, or `NotImplementedError` for what the pool
    cannot run: a sharded population (the pool's members run in one
    process; a sharded population runs through
    `PopulationEngine.from_population` under a G-rank launch)."""
    pspec = pspec.validate()
    if pspec.sharding.is_sharded:
        raise NotImplementedError(
            f"not ported yet: a sharded pool (mesh {pspec.sharding.mesh}; "
            f"multi-device, {SHARDED_ITEM})")
    return pspec


def ensure_pool_dir(pool_dir: str) -> RunDir:
    """Pool-root layout: control drop-box + members/, but no root-level
    checkpoints dir — checkpoints live per tenant."""
    rd = RunDir(pool_dir)
    os.makedirs(rd.path(CONTROL_DIR), exist_ok=True)
    os.makedirs(rd.path(MEMBERS_DIR), exist_ok=True)
    return rd


def common_checkpoint_step(member_dirs: List[str]) -> Optional[int]:
    """The newest step for which *every* member has a verified checkpoint
    (None when no step is shared).  The pool checkpoints members
    sequentially after each segment, so a crash leaves a ragged frontier;
    the common step is the last cadence point the whole population
    reached."""
    common: Optional[set] = None
    for d in member_dirs:
        ckpt_dir = os.path.join(d, "checkpoints")
        steps = {s for s, p in list_resumable(ckpt_dir)
                 if verify_checkpoint(p)}
        common = steps if common is None else (common & steps)
        if not common:
            return None
    return max(common) if common else None


def restore_member_at(pop: PopulationEngine, b: int, ckpt_dir: str,
                      step: int) -> Dict[str, Any]:
    """Restore population member ``b`` from its checkpoint at ``step``
    (not necessarily the newest — resume targets the common step);
    returns the manifest."""
    path = next((p for s, p in list_resumable(ckpt_dir) if s == step),
                None)
    if path is None:
        raise FileNotFoundError(
            f"member {b}: no checkpoint at step {step} under {ckpt_dir}")
    keys = typed_key_leaves(path)
    if keys:
        raise ValueError(
            f"{path} is a JAX package checkpoint (typed PRNG-key leaves "
            f"{keys}): the port reads it but cannot resume it, since its "
            "draws are a function of (seed, round, device) and cannot "
            "continue that key's stream; resume the pool with `python -m "
            "repro.serve pool resume`")
    member = pop.member(b)
    tree = load_checkpoint(path, like=_resumable_tree(member))
    with open(path[: -len(".npz")] + ".json") as f:
        manifest = json.load(f)
    member.engine.restore_resumable(
        {"fleet": tree["fleet"], "times": tree["times"]},
        rounds=manifest["rounds"], energy=manifest["energy"])
    restore_policy = getattr(member.controller, "restore_policy_state",
                             None)
    if restore_policy is not None:
        restore_policy(tree["policy"])
    return manifest


# --------------------------------------------------------------------- #
# the supervisor loop
# --------------------------------------------------------------------- #
def run_pool(pool_dir: str, *, segment_rounds: int = 25,
             max_segments: Optional[int] = None, keep: Optional[int] = 3,
             resume: bool = False, device=None, log=print) -> Dict[str, Any]:
    """Drive a population through checkpointed segments until stopped, on
    ``device`` (the card unless the caller asks for another).

    Mirrors `service.run_service`: signals and ``control/stop.req`` both
    set the same stop flag, every segment ends with a full checkpoint
    sweep, and the final state dict is returned.  ``resume=True``
    restores every member from the maximum common verified step and
    truncates each member's trace back to it.
    """
    rd = ensure_pool_dir(pool_dir)
    pspec = runnable_pool_spec(load_pool_spec(pool_dir))
    specs = pspec.expand()
    B = len(specs)

    stopping = {"flag": False}

    def _on_signal(signum, frame):
        stopping["flag"] = True

    prev = {sig: signal.signal(sig, _on_signal)
            for sig in (signal.SIGTERM, signal.SIGINT)}
    rd.write_pid()
    try:
        mrds = []
        for b, spec in enumerate(specs):
            mrd = RunDir(member_dir(pool_dir, b)).ensure()
            if not os.path.exists(mrd.spec_path):
                mrd.write_spec(spec)
            mrds.append(mrd)

        pop = PopulationEngine(specs, device=device)

        obs = EngineObs(sink=JsonlSink(rd.metrics_path), source="pool")
        segment = 0
        if resume:
            step = common_checkpoint_step([m.root for m in mrds])
            if step is None:
                raise FileNotFoundError(
                    f"resume: no common verified checkpoint across the "
                    f"{B} member dirs under {rd.path(MEMBERS_DIR)}")
            dropped = 0
            for b, mrd in enumerate(mrds):
                manifest = restore_member_at(pop, b, mrd.ckpt_dir, step)
                dropped += truncate_jsonl_trace(mrd.trace_path, step)
            segment = int(manifest.get("segment", 0))
            obs.registry.counter(
                "pool_resumes_total", "checkpointed pool resumes").inc(1)
            log(f"resumed {B} members from round {step} (segment "
                f"{segment}" + (f", dropped {dropped} unreplayed trace "
                                "records" if dropped else "") + ")")

        for b, mrd in enumerate(mrds):
            pop.set_member_sink(b, JsonlSink(mrd.trace_path),
                                retain=False)

        g_loss = obs.registry.gauge(
            "pool_member_loss", "last reported loss per pool member")
        g_energy = obs.registry.gauge(
            "pool_member_energy", "cumulative energy per pool member [J]")

        def publish(status: str, **extra) -> Dict[str, Any]:
            return rd.write_state(
                status=status, pid=os.getpid(), members=B,
                scenario=pspec.base.task.kind, segment=segment,
                segment_rounds=segment_rounds,
                rounds=pop.member_rounds(0),
                energy=round(sum(pop.member_energy(b)
                                 for b in range(B)), 6), **extra)

        publish("running")
        t0 = time.monotonic()
        base_segment = segment          # max_segments counts THIS run's
        while not stopping["flag"]:     # segments, not the lifetime total
            if (max_segments is not None
                    and segment - base_segment >= max_segments):
                break
            if rd.take_request(STOP_REQ):
                break
            seg_t0 = time.monotonic()
            with obs.span("pool_segment", segment=segment + 1,
                          rounds=segment_rounds, members=B):
                pop.run_scanned(segment_rounds, eval_final=True)
                segment += 1
                with obs.span("pool_checkpoint", segment=segment) as sp:
                    total = 0
                    for b, mrd in enumerate(mrds):
                        path = save_resumable(pop.member(b), mrd.ckpt_dir,
                                              segment=segment, keep=keep)
                        try:
                            total += os.path.getsize(path)
                        except OSError:
                            pass
                    sp.attrs["bytes"] = total
                obs.on_checkpoint(sp.dur_s, total)
            rd.take_request(CKPT_REQ)   # just checkpointed: consume
            dt = time.monotonic() - seg_t0
            rps = round(B * segment_rounds / max(dt, 1e-9), 3)
            obs.registry.gauge(
                "pool_rounds_per_sec",
                "population round throughput of the last segment "
                "(members x rounds / wall-clock)").set(rps)
            for b, mrd in enumerate(mrds):
                last = (tail_jsonl(mrd.trace_path, n=1) or [{}])[-1]
                if last.get("loss") is not None:
                    g_loss.set(float(last["loss"]), pop=str(b))
                g_energy.set(pop.member_energy(b), pop=str(b))
            obs.registry.counter(
                "pool_segments_total", "pool segments completed").inc(1)
            obs.flush_snapshot()        # one metrics.jsonl record/segment
            publish("running", rounds_per_sec=rps)
            log(f"segment {segment}: round {pop.member_rounds(0)} x {B} "
                f"members, {dt:.2f}s ({rps:.1f} member-rounds/s)")
        obs.flush_snapshot()            # farewell snapshot
        state = publish("stopped",
                        wall_seconds=round(time.monotonic() - t0, 3))
        log(f"stopped after {segment} segments "
            f"({pop.member_rounds(0)} rounds x {B} members)")
        return state
    except BaseException as e:
        rd.write_state(status="failed", pid=os.getpid(),
                       error=f"{type(e).__name__}: {e}")
        raise
    finally:
        rd.clear_pid()
        for sig, handler in prev.items():
            signal.signal(sig, handler)


# --------------------------------------------------------------------- #
# status (read-only, works with or without a live process)
# --------------------------------------------------------------------- #
def pool_status(pool_dir: str, tail: int = 1) -> Dict[str, Any]:
    """Pool snapshot: serve.json + liveness + a per-member summary
    (latest verified checkpoint step, last trace record)."""
    rd = RunDir(pool_dir)
    state = rd.read_state() or {}
    pid = rd.running_pid()
    if pid is None and state.get("status") == "running":
        state["status"] = "dead"        # crashed without a farewell write
    members = []
    mroot = rd.path(MEMBERS_DIR)
    if os.path.isdir(mroot):
        for name in sorted(os.listdir(mroot)):
            mrd = RunDir(os.path.join(mroot, name))
            if not os.path.isdir(mrd.root):
                continue
            steps = [s for s, p in list_resumable(mrd.ckpt_dir)
                     if verify_checkpoint(p)]
            members.append({
                "member": name,
                "run_dir": mrd.root,
                "checkpoint_step": max(steps) if steps else None,
                "last_records": tail_jsonl(mrd.trace_path, n=tail),
            })
    return {
        "run_dir": rd.root,
        "alive": pid is not None,
        "pid": pid,
        "state": state,
        "members": members,
    }
