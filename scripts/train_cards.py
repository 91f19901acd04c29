"""The sharded federated LM training step across cards: one NCCL rank a
card.

    python3 scripts/train_cards.py [--meshes 4x1 1x4 2x2]   # on four cards

`chip_smoke.py`'s phase 11 runs mesh (1, 1) on one card.  This script
starts its hidden ``--train-sharded-worker`` as one job a
``('data', 'model')`` mesh, 4 ranks each: recurrentgemma-2b (three
layers, full width) in mode A with 4 clients in one cluster, and
deepseek-v2-236b (two layers of 16 experts, full width) in mode B with 4
rows a microbatch, so every mesh splits the same state and batch; at
(2, 2) also deepseek-v2 with capacity factor 4 twice, on the plain
dispatch and on the expert-parallel branch, the second held to the first
(with no assignment past capacity the two dispatches compute the same
function).  Every run is two sharded rounds from seed 0 under Adafactor;
rank 0 then runs the unsharded step from the same seed on its card and
holds the sharded round-1 parameters to it (1e-5 of each leaf's largest
entry, losses likewise).  An MoE run's unsharded round 1 replays the
sharded round's expert choices (`chip_smoke.moe_routing`) and reports
how many its own router would have chosen otherwise: the collectives
reassociate the router's inputs, and a near tie then picks another
expert, which moves that expert's gradient by far more than 1e-5.  Prints, a run, the kernels' launches a round on
each rank beside the unsharded step's, the seconds of the warm second
round sharded and unsharded, each rank's peak memory, and each rank's
collectives a round by kind and bytes (the step's own and DTensor's), as
one JSON line as each job ends, with the card's name and power limit; the
last line is one JSON object.  A job that outlives its timeout ends the
script with each rank's last words and its Python stack (`faulthandler`,
15 s before the timeout).  Needs four cards.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

MESHES = ("4x1", "1x4", "2x2")  # one job each, in this order
SMOKE = os.path.join(ROOT, "chip_smoke.py")     # its --train-sharded-worker
LM_SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu",
              "rglru_scan.cu", "rglru_scan_bwd.cu")
DEEPSEEK_TASK = {"micro_batch": 4, "n_micro": 1}
ROUNDS = 2              # round 1 compared, round 2 timed warm
TOL = 1e-5


def runs_for(mesh: list, opts=("adafactor",)) -> list:
    """The runs of one mesh's job, one set an optimizer (the first keeps
    the plain tags)."""
    out = []
    for i, opt in enumerate(opts):
        for run in _runs(mesh):
            if i:
                run = {**run, "tag": run["tag"].replace("@", f"_{opt}@"),
                       **({"compare_with": run["compare_with"].replace(
                           "@", f"_{opt}@")} if "compare_with" in run
                          else {})}
            out.append({**run, "opt": opt})
    return out


def _runs(mesh: list) -> list:
    tag = "x".join(map(str, mesh))
    rg = {"scenario": "RECURRENTGEMMA_2B_TRAIN", "mesh": mesh, "NC": 1,
          "C": 4, "rounds": ROUNDS}
    ds = {"scenario": "DEEPSEEK_V2_236B_TRAIN", "mesh": mesh, "NC": 1,
          "task": DEEPSEEK_TASK, "rounds": ROUNDS}
    runs = [{**rg, "tag": f"recurrentgemma_2b_mode_a@{tag}"},
            {**ds, "tag": f"deepseek_v2_236b_mode_b@{tag}"}]
    if mesh == [2, 2]:
        plain = f"deepseek_v2_236b_mode_b_cf4@{tag}"
        runs += [{**ds, "tag": plain, "cf": 4.0},
                 {**ds, "tag": f"deepseek_v2_236b_mode_b_ep@{tag}",
                  "cf": 4.0, "ep": True, "compare_with": plain}]
    return runs


def summary(ranks: list, tag: str) -> dict:
    """One run's figures from every rank's record."""
    import chip_smoke as cs
    rs = [r["runs"][tag] for r in ranks]
    r0 = rs[0]
    loss = r0["rounds"][0]["loss"]
    want = r0["loss_vs"]
    lrel = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(cs.flat_losses(loss),
                               cs.flat_losses(want)))
    ok = (r0["compare"]["max_rel"] <= TOL and lrel <= TOL
          and all(r["layout"] and not r["off_card"] for r in rs))
    out = {"ok": ok, "against": r0["against"], "compare": r0["compare"],
           "loss_rel": lrel, "loss": loss,
           "round_s": [[x["s"] for x in r["rounds"]] for r in rs],
           "launches_a_round": [r["rounds"][0]["launches"] for r in rs],
           "peak_gib": [r.get("peak_gib") for r in rs],
           "collectives_a_round": [cs.per_round_collectives(r["rounds"][1])
                                   for r in rs]}
    if "plain_rounds" in r0:
        out["unsharded_round_s"] = [x["s"] for x in r0["plain_rounds"]]
        if "routing_replayed" in r0["plain_rounds"][0]:
            out["routing_replayed"] = r0["plain_rounds"][0][
                "routing_replayed"]
        out["unsharded_launches_a_round"] = r0["plain_rounds"][0][
            "launches"]
    return out


def main(timeout: float, meshes, models=None, opts=("adafactor",)) -> int:
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.distributed import spawn_local
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    build.build_all(LM_SOURCES)             # once, before the ranks
    cards = torch.cuda.device_count()
    out = {"device": smi.splitlines()[0] if smi else None, "cards": cards,
           "meshes": {}}
    ok = True
    for shape in meshes:
        mesh = [int(m) for m in shape.split("x")]
        G = math.prod(mesh)
        if cards < G:
            print(f"{G} ranks need {G} cards, this machine has {cards}")
            return 2
        stacks = tempfile.mkdtemp(prefix="train_stacks_")
        cfg = {"runs": [r for r in runs_for(mesh, opts) if not models or any(
                   r["tag"].startswith(m) for m in models)],
               "stacks": {"dir": stacks, "after_s": max(timeout - 15, 1)}}
        t0 = time.perf_counter()
        try:
            res = spawn_local([SMOKE, "--train-sharded-worker",
                               json.dumps(cfg)], n_procs=G, timeout=timeout)
        except subprocess.TimeoutExpired as e:
            dumps = "".join(
                f"{f}: " + open(os.path.join(stacks, f)).read()
                for f in sorted(os.listdir(stacks)))
            print(f"mesh {shape}: no end within {timeout} s; where the "
                  f"ranks were:\n{e.stderr}\n{dumps}", flush=True)
            out["meshes"][shape] = {"hung": True, "after_s": timeout}
            ok = False
            continue
        finally:
            shutil.rmtree(stacks, ignore_errors=True)
        wall = time.perf_counter() - t0
        bad = [r for r in res if r.returncode != 0]
        if bad:
            print(f"mesh {shape}: a rank failed ({bad[0].returncode}):\n"
                  f"{bad[0].stderr[-4000:]}", flush=True)
            out["meshes"][shape] = {"failed": bad[0].stderr[-2000:]}
            ok = False
            continue
        ranks = [json.loads(r.stdout.split("TRAINSHARDED", 1)[1])
                 for r in res]
        entry = {"backend": ranks[0]["backend"], "job_wall_s": wall,
                 "runs": {}}
        for run in cfg["runs"]:
            s = summary(ranks, run["tag"])
            ok = ok and s["ok"]
            entry["runs"][run["tag"]] = s
            print(json.dumps({run["tag"]: s, "device": out["device"]}),
                  flush=True)
        out["meshes"][shape] = entry
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--meshes", nargs="+", default=list(MESHES),
                    help="('data', 'model') meshes to run, one job each "
                         "(default: 4x1 1x4 2x2)")
    ap.add_argument("--timeout", type=float, default=420.0,
                    help="seconds a job may take")
    ap.add_argument("--models", nargs="+", default=None,
                    help="run only the runs whose tag starts with one of "
                         "these (recurrentgemma_2b, deepseek_v2_236b)")
    ap.add_argument("--opts", nargs="+", default=["adafactor"],
                    help="optimizers, each a set of runs (adafactor, the "
                         "training plan's; sgd, adam)")
    args = ap.parse_args()
    sys.exit(main(args.timeout, args.meshes, args.models, args.opts))
