"""The fused trust kernel against other versions of its source, in turns.

    python3 scripts/fused_sweep.py DIR [DIR ...]

Each DIR holds a ``trust_aggregate.cu`` with this checkout's C interface
(a timing-only variant needs no correctness).  At the federation paths'
two shapes of the fused kernel (``anomaly-fleet1k``: C 111, B 16, N 5,288;
``paper-mlp-fleet1k``: C 99, B 16, N 159,010) this checkout's kernel is
checked against its plain version, then timed warm (from a CUDA graph)
and cold (L2 flushed) in turns with `mv` + `addmv` and each DIR's kernel:
`chip_smoke.fused_times`, without the rest of `chip_smoke.py`.  Then
ptxas's registers and spills of each source's fused kernel.  A DIR that
holds a copy of the source with one constant or one plan rule changed
times that choice against the checkout's.  Needs one NVIDIA GPU; prints
the card's name and power limit first.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts the repository's src/ on the path)

SHAPES = {"anomaly-fleet1k": (111, 16, 5288),
          "paper-mlp-fleet1k": (99, 16, 159010)}


def main() -> None:
    dirs = sys.argv[1:]
    if not torch.cuda.is_available():
        sys.exit("fused_sweep: no CUDA device; this script runs on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    out = {}
    for name, (M, B, N) in SHAPES.items():
        r = chip_smoke.fused_times(M, B, N, dev, dirs)
        out[name] = {k: r[k] for k in ("shape", "plan", "cold_ms", "warm_ms",
                                        "bound_ms")}
        out[name]["medians_in_turns_ms"] = {
            mode: {k: statistics.median(v) for k, v in t.items()}
            for mode, t in r["in_turns_ms"].items()}
        chip_smoke.free_library_memory()
    from repro_torch.kernels import build
    for d in [chip_smoke.HERE_CSRC] + dirs:
        for row in build.ptxas_report("trust_aggregate.cu", d):
            if "global" in row["kernel"]:
                print(f"ptxas {d}: {json.dumps(row)}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
