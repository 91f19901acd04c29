"""Sharded serving of a model that no one card holds: one NCCL rank a card.

    python3 scripts/serve_cards.py [--arch qwen1.5-32b] [--mesh 1x4]

qwen1.5-32b at its full 64 layers in float32 (141 GB of weights; a
quarter a rank on a ('data', 'model') mesh (1, 4)) at the serving plans'
layout (`repro_torch.launch.plans.decode_plan`'s parameter specs and
cache layout: its 40 query and 40 K/V heads split over ``model``): each
rank draws its shards on its card from seed 0, a layer at a time
(`repro_torch.models.transformer.seeded_params`), then runs
`fl_step.build_prefill_step` on batch 4 x 4096 tokens (`chip_smoke.py`'s
serving prompts) and 32 greedy decode steps through
`fl_step.build_serve_step`, its cache ``4096 + 32`` positions long.  The
check is serving phases 5-7's: the first decode step (position 4096)
against a prefill of the 4097 tokens, its last logits, within 2e-2.
Prints each rank's peak memory (< 80 GB), the prefill seconds, the decode
tokens/s, each rank's collectives a decode step by kind and bytes and
the launches of the prefill, with the card's name and power limit; the
last line is one JSON object.  Needs as many cards as the mesh has
ranks.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

GEN = 32                # decode steps
TOL = 2e-2              # serving phases 5-7's decode / prefill bound
PEAK_GIB = 80e9 / 2 ** 30


def worker(job: dict) -> None:
    """One rank: its shards from the seed, the prefill, the decode loop,
    the 4097-token prefill; one JSON line."""
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import fl_step as fl
    from repro_torch.core import sharding as shd
    from repro_torch.launch import plans
    from repro_torch.launch.distributed import initialize_from_env
    from repro_torch.launch.mesh import host_mesh_for
    rank = initialize_from_env("cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(job["arch"])
    mesh = host_mesh_for(job["mesh"], device="cuda")
    plan = plans.decode_plan(job["arch"], "decode_32k", mesh,
                             param_dtype=torch.float32)
    specs, layout = plan.in_specs[0], plan.options["layout"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    placed, local = cs.placed_seeded(cfg, specs, mesh, dev, rank)
    build_s = time.perf_counter() - t0
    bax = layout["batch_axis"]
    put = lambda t: shd.distribute(t, (bax,) + (None,) * (t.dim() - 1),
                                   mesh)
    prefill = fl.build_prefill_step(cfg, cs.SERVE_PROMPT + GEN)
    step = fl.build_serve_step(cfg)
    tokens = cs.serve_prompts(cfg, dev)
    out, fed, cache, pre_s, step_s, pre, dec, coll = cs.serve_calls(
        lambda t: prefill(placed, put(t)),
        lambda c, t, i: step(placed, c, put(t), i), tokens, GEN)
    del cache
    torch.cuda.empty_cache()
    full = torch.cat([tokens, fed[0][:, None]], dim=-1)
    whole, _ = fl.build_prefill_step(cfg, full.shape[-1])(placed, put(full))
    gap = float((out[1] - whole).abs().max())
    res = {"rank": rank, "backend": dist.get_backend(),
           "params_gib": sum(v.numel() * v.element_size()
                             for v in local.values()) / 2 ** 30,
           "build_s": build_s, "prefill_s": pre_s, "step_s": step_s,
           "launches_prefill": pre, "launches_decode": dec,
           "collectives_a_step": coll, "gap": gap,
           "batch": tokens.shape[0],
           "finite": all(bool(torch.isfinite(x).all()) for x in out),
           "same_logits": None,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out[-1].cpu())
    res["same_logits"] = all(torch.equal(every[0], e) for e in every)
    print("SERVECARDS" + json.dumps(res), flush=True)
    dist.destroy_process_group()


def main(arch: str, mesh: str, timeout: float) -> int:
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.distributed import spawn_local
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    device = smi.splitlines()[0] if smi else None
    print(device, flush=True)
    shape = [int(m) for m in mesh.split("x")]
    G = math.prod(shape)
    if torch.cuda.device_count() < G:
        print(f"{G} ranks need {G} cards, this machine has "
              f"{torch.cuda.device_count()}")
        return 2
    build.build_all(["flash_attention.cu", "rglru_scan.cu",
                     "selective_scan.cu"])          # once, before the ranks
    t0 = time.perf_counter()
    res = spawn_local([os.path.abspath(__file__), "--worker",
                       json.dumps({"arch": arch, "mesh": shape})],
                      n_procs=G, timeout=timeout)
    wall = time.perf_counter() - t0
    bad = [r for r in res if r.returncode != 0]
    if bad:
        print(f"a rank failed ({bad[0].returncode}):\n"
              f"{bad[0].stderr[-6000:]}", flush=True)
        return 1
    ranks = [json.loads(r.stdout.split("SERVECARDS", 1)[1]) for r in res]
    r0 = ranks[0]
    steps = r0["step_s"]
    ok = (all(r["gap"] <= TOL and r["finite"] and r["same_logits"]
              and r["peak_gib"] < PEAK_GIB for r in ranks)
          and all(r["launches_prefill"] == r0["launches_prefill"]
                  and not r["launches_decode"] for r in ranks))
    out = {"arch": arch, "mesh": shape, "device": device, "ok": ok,
           "backend": r0["backend"], "job_wall_s": wall,
           "gap": max(r["gap"] for r in ranks), "tolerance": TOL,
           "prefill_s": [r["prefill_s"] for r in ranks],
           "decode_tokens_per_s": len(steps) * r0["batch"] / sum(steps),
           "decode_step_s_median": statistics.median(steps),
           "build_s": [r["build_s"] for r in ranks],
           "params_gib": [r["params_gib"] for r in ranks],
           "peak_gib": [r["peak_gib"] for r in ranks],
           "launches_prefill": [r["launches_prefill"] for r in ranks],
           "collectives_a_step": [r["collectives_a_step"] for r in ranks]}
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-32b")
    ap.add_argument("--mesh", default="1x4",
                    help="('data', 'model') mesh, one card a rank")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the job may take")
    ap.add_argument("--worker", metavar="JSON", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(json.loads(args.worker))
        sys.exit(0)
    sys.exit(main(args.arch, args.mesh, args.timeout))
