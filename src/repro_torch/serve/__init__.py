"""repro_torch.serve — long-running federation service with checkpointed
resume, on the card (the JAX package's ``repro.serve``, without the
population pool: ROADMAP.md, queue 1, item 8).

The batch API (`repro_torch.api.Federation.run`) answers "run this
experiment"; this package answers "keep this federation running":
segments of `run_scanned(K)` rounds, a full resumable checkpoint after
each, a streamed JSONL trace, and a file-protocol CLI (``python -m
repro_torch.serve``) with start / status / metrics / checkpoint / resume /
stop / chaos.  Resume is bit-exact against the port's own uninterrupted
run — even across a SIGKILL: manifests carry a CRC32 content digest,
restore falls back to the newest *verified* checkpoint, and the chaos
harness (`chaos.run_supervised`) exercises the whole kill → verify →
resume path under supervision.  Telemetry (`repro_torch.obs`) streams
into ``metrics.jsonl`` beside the trace: ``status --watch`` renders the
live dashboard and ``metrics`` dumps the Prometheus snapshot.  Run dirs
have the JAX package's layout and formats, so each package's read-only
tools (status, metrics, trace, checkpoint verification) read the
other's; a JAX package checkpoint is read but not resumed.
"""
from .chaos import run_supervised, spawn_service
from .runner import (SegmentRunner, latest_resumable, list_resumable,
                     prune_checkpoints, restore_resumable, save_resumable,
                     truncate_jsonl_trace, verify_checkpoint)
from .service import (RunDir, last_spans, load_run_metrics, run_service,
                      service_status)

__all__ = ["SegmentRunner", "latest_resumable", "list_resumable",
           "prune_checkpoints", "restore_resumable", "save_resumable",
           "truncate_jsonl_trace", "verify_checkpoint", "RunDir",
           "run_service", "service_status", "run_supervised",
           "spawn_service", "load_run_metrics", "last_spans"]
