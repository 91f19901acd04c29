"""The partitioner-inferred placement across cards: one NCCL rank a card.

    python3 scripts/gspmd_cards.py [--meshes 2 4 2x2]   # on four cards
    python3 scripts/gspmd_cards.py --meshes 2x2 --repeat 8 \
        --specs paper-mlp-fleet1k                         # F2's check

`chip_smoke.py`'s phase 10b runs meshes (1,) and (1, 1) only: on one card
the ranks would share it over gloo, whose all-gather of CUDA tensors
DTensor cannot use (`scripts/dtensor_probe.py`).  With a card a rank the
backend is NCCL: this script starts `chip_smoke.py`'s hidden
``--gspmd-worker`` as one job a mesh, 2 ranks for (2,), 4 for (4,) and
(2, 2) (which hung while DTensor inferred the round's reductions:
ROADMAP.md, F2; ``--repeat`` runs a mesh's job that many times), each
running ``paper-mlp-fleet1k``,
``dp-fleet1k`` and ``paper-adaptive-fleet1k`` (or ``--specs``), and holds rank 0's records to its
unsharded engine on the same card (the schedule exactly, t, loss and
energy within 1e-5 relative; the DQN's under the same net) and every
rank's records to rank 0's, byte for byte; each rank's trust launches a
round to the unsharded engine's.  Prints DTensor's collectives a round by
kind and bytes, the steady rounds/s of each mesh beside the unsharded
engine's, each rank's peak memory and the card's name and power limit,
one JSON line a spec and mesh as each job ends; the last line is one
JSON object.  A job that outlives its 240 s ends the script with where
each rank was: its last words and its Python stack (`faulthandler`, 15 s
before the timeout).  Needs as many cards as ranks.
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

MESHES = ("2", "4", "2x2")      # one job each, in this order
SMOKE = os.path.join(ROOT, "chip_smoke.py")     # its --gspmd-worker


def main(timeout: float = 240.0, meshes=MESHES, repeat: int = 1,
         specs=None) -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.launch.distributed import spawn_local
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    from repro_torch.kernels import build
    build.build_all(["trust_aggregate.cu"])     # once, before the ranks
    cards = torch.cuda.device_count()
    out = {"device": smi.splitlines()[0] if smi else None, "cards": cards,
           "meshes": {}}
    ok = True
    for shape, turn in [(m, i) for m in meshes for i in range(repeat)]:
        mesh = [int(m) for m in shape.split("x")]
        G = math.prod(mesh)
        meshes_ = [mesh]
        if cards < G:
            print(f"{G} ranks need {G} cards, this machine has {cards}")
            return 2
        # each rank's Python stack, written 15 s before the job's timeout
        stacks = tempfile.mkdtemp(prefix="gspmd_stacks_")
        cfg = {"meshes": meshes_, "specs": list(specs or cs.GSPMD_SPECS),
               "stacks": {"dir": stacks, "after_s": max(timeout - 15, 1)}}
        t0 = time.perf_counter()
        try:
            res = spawn_local([SMOKE, "--gspmd-worker", json.dumps(cfg)],
                              n_procs=G, timeout=timeout)
        except subprocess.TimeoutExpired as e:
            dumps = "".join(
                f"{f}: " + open(os.path.join(stacks, f)).read()
                for f in sorted(os.listdir(stacks)))
            print(f"{G} ranks, mesh {mesh} (run {turn + 1} of {repeat}): "
                  f"no end within {timeout} s; where the ranks were:\n"
                  f"{e.stderr}\n{dumps}", flush=True)
            return 1
        finally:
            shutil.rmtree(stacks, ignore_errors=True)
        wall = time.perf_counter() - t0
        bad = [r for r in res if r.returncode != 0]
        if bad:
            print(f"{G} ranks: a rank failed ({bad[0].returncode}):\n"
                  f"{bad[0].stderr[-4000:]}")
            return 1
        ranks = [json.loads(r.stdout.split("GSPMDRESULT", 1)[1])
                 for r in res]
        for key in ranks[0]["runs"]:
            rs = [r["runs"][key] for r in ranks]
            r0 = rs[0]
            name, tag = key.split("@")
            entry = {"backend": ranks[0]["backend"], "job_wall_s": wall,
                     "peak_gib": [r["peak_gib"] for r in ranks]}
            for path in ("scanned", "event"):
                if path not in r0:
                    continue
                rounds = cs.GSPMD_K if path == "scanned" else cs.GSPMD_E
                same = all(json.dumps(r[path]) == json.dumps(r0[path])
                           for r in rs)
                agree = cs.rows_agree(r0[path], r0[f"plain_{path}"])
                trust = ("trust_aggregate", "trust_aggregate_dense",
                         "trust_aggregate_global")
                launched = all(r[f"{path}_launches"][k]
                               == r[f"plain_{path}_launches"][k]
                               for r in rs for k in trust)
                ok = ok and same and agree and launched
                entry[path] = {
                    "ranks_byte_equal": same, "agrees_with_unsharded": agree,
                    "launches_as_unsharded": launched,
                    "launches_a_round": {k: r0[f"{path}_launches"][k]
                                         / rounds for k in trust
                                         if r0[f"{path}_launches"][k]},
                    "collectives_a_round": [cs.per_round(
                        r[f"{path}_collectives"], rounds) for r in rs],
                    "rounds_per_s_incl_eval": rounds / r0[f"{path}_s"]}
                if not agree:
                    entry[path]["first_rows"] = [r0[path][:3],
                                                 r0[f"plain_{path}"][:3]]
            if "steady_rounds_per_s" in r0:
                entry["steady_rounds_per_s"] = r0["steady_rounds_per_s"]
                st = r0["steady_rounds_per_s"]
                print(f"{name} mesh ({tag.replace('x', ', ')},) steady "
                      "rounds/s, rank 0, median [min, max]: " + "; ".join(
                          f"{k} {v['median']} [{v['min']}, {v['max']}]"
                          for k, v in st.items()) + f" ({smi})", flush=True)
            if repeat > 1:
                tag_ = f"{tag}#{turn + 1}"
                entry["run"] = turn + 1
            else:
                tag_ = tag
            out["meshes"].setdefault(tag_, {})[name] = entry
            print(json.dumps({f"{name}@{tag_}": entry}), flush=True)
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--meshes", nargs="+", default=list(MESHES),
                    help="mesh shapes to run, one job each (default: "
                         "2 4 2x2)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="jobs a mesh, one after another")
    ap.add_argument("--specs", nargs="+", default=None,
                    help="specs a job runs (default: chip_smoke's "
                         "GSPMD_SPECS)")
    ap.add_argument("--timeout", type=float, default=240.0,
                    help="seconds a job may take")
    args = ap.parse_args()
    sys.exit(main(timeout=args.timeout, meshes=args.meshes,
                  repeat=args.repeat, specs=args.specs))
