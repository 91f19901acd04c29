"""Segmented execution with checkpointed resume (the service's core loop;
a copy of the JAX package's ``repro.serve.runner``: the same manifest, the
same verify / prune / legacy rules).

`SegmentRunner` drives `DeviceScaleEngine.run_scanned(K)` in repeated
K-round segments and checkpoints the **full resumable state** after each:

* the `FleetState` — twins, reputations, channel, cluster/global params,
  the Eqn-12 Lyapunov backlog and the round counter, under the JAX
  package's leaf names (`repro_torch.api.engine.FleetTree`).  The port's
  draws are a function of (seed, round, device), so there is no PRNG key
  to save; a JAX package checkpoint, whose typed key leaf marks a random
  stream the port cannot continue, is refused on resume;
* the per-cluster event-time vector `run_scanned` carries across calls;
* the controller's scan-policy carry (the deployed DQN net; fixed and
  Lyapunov carries are empty — the backlog lives in `FleetState.queue`);
* a JSON manifest sidecar with the round counter and the float64 energy
  tally.  The tally cannot ride in the npz, which holds the state's f32
  tensors, but Python's JSON repr round-trips doubles exactly, so the
  manifest is the bit-exact home.

Both files land atomically (``.tmp`` + ``os.replace``); a checkpoint is
*complete* only when its manifest exists, so `latest_resumable` skips an
npz whose manifest write was lost to a crash.  The manifest additionally
records the npz's byte size and CRC32 content digest; `latest_resumable`
walks newest-first and returns the first checkpoint whose bytes still
match (``verify_checkpoint``), so a truncated or bit-rotted npz degrades
to the previous good checkpoint instead of a crash-loop on restore.
Restore builds a **fresh**
federation from the same spec (device data, cluster assignments, and the
malicious mask all derive deterministically from ``spec.seed``), then
overwrites the resumable leaves — after which continuing produces the
exact trace an uninterrupted segmented run would
(`tests/test_torch_serve.py` asserts equality down to the f64 energy
column).
"""
from __future__ import annotations

import json
import os
import re
import zlib
from typing import Any, Dict, Optional, Tuple

from repro_torch.checkpoint import (load_checkpoint, save_checkpoint,
                                    typed_key_leaves)

_MANIFEST_RE = re.compile(r"ckpt_(\d+)\.npz$")


def _manifest_path(npz_path: str) -> str:
    return npz_path[: -len(".npz")] + ".json"


def _atomic_write_json(path: str, obj: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _file_digest(path: str) -> Tuple[int, int]:
    """(byte size, CRC32) of a file, streamed in 1 MiB chunks."""
    size, crc = 0, 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            size += len(chunk)
            crc = zlib.crc32(chunk, crc)
    return size, crc & 0xFFFFFFFF


def verify_checkpoint(npz_path: str) -> bool:
    """True when the npz's bytes still match its manifest digest.

    Legacy manifests (pre-digest) verify by existence alone — they were
    written before the integrity field, and rejecting them would strand
    old runs.  A missing npz or manifest is corrupt, not legacy.
    """
    mpath = _manifest_path(npz_path)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return False
    if "crc32" not in manifest:
        return os.path.exists(npz_path)
    try:
        size, crc = _file_digest(npz_path)
    except OSError:
        return False
    return (size == manifest.get("bytes") and crc == manifest["crc32"])


def _resumable_tree(federation) -> Dict[str, Any]:
    engine = federation.engine
    tree = dict(engine.resumable_state())          # fleet + event times
    tree["policy"] = federation.controller.scan_policy().state
    return tree


def save_resumable(federation, ckpt_dir: str, *, segment: int,
                   keep: Optional[int] = 3,
                   write: bool = True) -> Optional[str]:
    """Checkpoint a federation's full resumable state; returns the npz path.

    ``keep`` bounds disk use for unbounded runs: after a successful write,
    all but the newest ``keep`` complete checkpoints are deleted (None
    keeps everything).

    A sharded federation's resumable state is whole, in the unsharded
    layout, and gathering it is a collective: every rank calls this, and
    only the rank given ``write`` (rank 0) writes the checkpoint; the
    others return None.
    """
    engine = federation.engine
    step = int(engine.round)
    tree = _resumable_tree(federation)
    if not write:
        return None
    fname = save_checkpoint(ckpt_dir, step, tree)
    # manifest second: its presence marks the checkpoint complete, the
    # exact-f64 energy tally lives here (npz would truncate it to f32),
    # and the digest is what restore verifies the npz bytes against
    size, crc = _file_digest(fname)
    _atomic_write_json(_manifest_path(fname), {
        "step": step,
        "rounds": step,
        "energy": float(engine.energy_used),
        "segment": int(segment),
        "bytes": size,
        "crc32": crc,
    })
    if keep is not None:
        prune_checkpoints(ckpt_dir, keep=keep)
    return fname


def list_resumable(ckpt_dir: str):
    """Complete checkpoints (npz + manifest) in the directory, oldest
    first, as ``(step, npz_path)`` pairs."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for f in os.listdir(ckpt_dir):
        m = _MANIFEST_RE.match(f)
        if not m:
            continue
        path = os.path.join(ckpt_dir, f)
        if os.path.exists(_manifest_path(path)):
            out.append((int(m.group(1)), path))
    return sorted(out)


def latest_resumable(ckpt_dir: str
                     ) -> Optional[Tuple[str, Dict[str, Any]]]:
    """Newest *verified* checkpoint as ``(npz_path, manifest)``, or None.

    Walks newest-first, skipping any checkpoint whose npz bytes no longer
    match the manifest digest — the automatic fallback that lets a service
    resume from the last good state after a torn or corrupted write."""
    for _, path in reversed(list_resumable(ckpt_dir)):
        if verify_checkpoint(path):
            with open(_manifest_path(path)) as f:
                return path, json.load(f)
    return None


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Delete all but the newest ``keep`` *verified* checkpoints.

    Corrupt checkpoints are deleted outright (they can never be restored),
    so after pruning the ``keep`` newest survivors are all restorable."""
    verified = [p for _, p in list_resumable(ckpt_dir)
                if verify_checkpoint(p)]
    doomed = verified[:-keep or None]
    doomed += [p for _, p in list_resumable(ckpt_dir) if p not in verified]
    for path in doomed:
        for victim in (path, _manifest_path(path)):
            try:
                os.remove(victim)
            except OSError:
                pass


def restore_resumable(federation, ckpt_dir: str,
                      path: Optional[str] = None) -> Dict[str, Any]:
    """Restore a federation to the newest checkpoint (or to the one at
    ``path``: the one every rank of a sharded service restores from);
    returns its manifest.

    The federation must have been built from the *same spec* (same seed:
    data, assignments, and masks regenerate deterministically) — only the
    resumable leaves are overwritten.
    """
    if path is None:
        found = latest_resumable(ckpt_dir)
        if found is None:
            raise FileNotFoundError(
                f"no complete checkpoint under {ckpt_dir}")
        path = found[0]
    with open(_manifest_path(path)) as f:
        manifest = json.load(f)
    keys = typed_key_leaves(path)
    if keys:
        raise ValueError(
            f"{path} is a JAX package checkpoint (typed PRNG-key leaves "
            f"{keys}): the port reads it but cannot resume it, since its "
            "draws are a function of (seed, round, device) and cannot "
            "continue that key's stream; resume it with `python -m "
            "repro.serve resume`")
    tree = load_checkpoint(path, like=_resumable_tree(federation))
    federation.engine.restore_resumable(
        {"fleet": tree["fleet"], "times": tree["times"]},
        rounds=manifest["rounds"], energy=manifest["energy"])
    restore_policy = getattr(federation.controller,
                             "restore_policy_state", None)
    if restore_policy is not None:      # DQN: adopt the deployed net
        restore_policy(tree["policy"])
    return manifest


def truncate_jsonl_trace(path: str, max_round: int) -> int:
    """Drop trace records newer than the checkpoint being resumed from.

    A crash can land between trace appends and the segment checkpoint;
    on resume the re-run segment would then duplicate those rounds.  The
    file is rewritten through a temp + ``os.replace`` keeping records with
    ``round <= max_round`` (streaming, so multi-GB traces stay cheap).
    Returns the number of dropped records; a missing file is a no-op.
    """
    if not os.path.exists(path):
        return 0
    tmp = path + ".tmp"
    dropped = 0
    with open(path) as src, open(tmp, "w") as dst:
        for line in src:
            stripped = line.strip()
            if not stripped:
                continue
            try:
                rec = json.loads(stripped)
            except json.JSONDecodeError:
                dropped += 1            # torn final line from a crash
                continue
            if rec.get("round", 0) > max_round:
                dropped += 1
                continue
            dst.write(stripped + "\n")
        dst.flush()
        os.fsync(dst.fileno())
    os.replace(tmp, path)
    return dropped


class SegmentRunner:
    """Run a federation in checkpointed K-round segments.

    Thin and synchronous — the service layer owns signals, pidfiles, and
    status; tests drive this class directly for the bit-parity guarantees.
    """

    def __init__(self, federation, ckpt_dir: str, *,
                 segment_rounds: int = 25, keep: Optional[int] = 3,
                 eval_final: bool = True, obs=None, write: bool = True):
        self.federation = federation
        self.ckpt_dir = str(ckpt_dir)
        self.segment_rounds = int(segment_rounds)
        self.keep = keep
        self.eval_final = eval_final
        self.write = write          # False: a rank other than 0 (above)
        self.segment = 0
        # optional `repro_torch.obs.EngineObs`: wraps the segment/checkpoint in
        # timing spans and feeds the checkpoint-latency metrics; the
        # engine-side hooks attach separately via `engine.set_obs`
        self.obs = obs

    # ------------------------------------------------------------------ #
    def maybe_resume(self) -> Optional[Dict[str, Any]]:
        """Adopt the newest checkpoint if one exists; returns its manifest
        (None for a fresh start)."""
        if latest_resumable(self.ckpt_dir) is None:
            return None
        return self.resume_from(None)

    def resume_from(self, path: Optional[str]) -> Dict[str, Any]:
        """Adopt the checkpoint at ``path`` (None: the newest); returns its
        manifest."""
        manifest = restore_resumable(self.federation, self.ckpt_dir, path)
        self.segment = int(manifest.get("segment", 0))
        return manifest

    def run_segment(self):
        """One K-round scanned segment followed by a checkpoint.

        Under telemetry the whole thing nests in a ``span("segment")``
        whose children are the engine's fenced round/host_sync/eval spans
        and the ``span("checkpoint")`` below — one emitted timing tree
        per segment in ``metrics.jsonl``."""
        if self.obs is None:
            trace = self.federation.engine.run_scanned(
                self.segment_rounds, eval_final=self.eval_final)
            self.segment += 1
            self.checkpoint()
            return trace
        with self.obs.span("segment", segment=self.segment + 1,
                           rounds=self.segment_rounds):
            trace = self.federation.engine.run_scanned(
                self.segment_rounds, eval_final=self.eval_final)
            self.segment += 1
            self.checkpoint()
        self.obs.registry.counter(
            "service_segments_total", "segments completed").inc(1)
        return trace

    def checkpoint(self) -> Optional[str]:
        if self.obs is None:
            return save_resumable(self.federation, self.ckpt_dir,
                                  segment=self.segment, keep=self.keep,
                                  write=self.write)
        with self.obs.span("checkpoint", segment=self.segment) as sp:
            path = save_resumable(self.federation, self.ckpt_dir,
                                  segment=self.segment, keep=self.keep,
                                  write=self.write)
            try:
                sp.attrs["bytes"] = os.path.getsize(path)
            except (OSError, TypeError):
                pass
        self.obs.on_checkpoint(sp.dur_s, sp.attrs.get("bytes", 0))
        return path

    # ------------------------------------------------------------------ #
    @property
    def rounds(self) -> int:
        return int(self.federation.engine.round)

    @property
    def energy(self) -> float:
        return float(self.federation.engine.energy_used)
