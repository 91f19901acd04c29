"""The three backward kernels against other versions of their sources.

    python3 scripts/bwd_sweep.py [--ssm] [DIR ...]

Each DIR holds a ``flash_attention_bwd.cu``, ``rglru_scan_bwd.cu`` and/or
``selective_scan_bwd.cu`` with this checkout's C interface (a timing-only
variant needs no correctness).  Runs ``chip_smoke.py``'s two
training-kernel phases alone: this checkout's backward kernels against
their plain versions at the training shapes of recurrentgemma-2b and
falcon-mamba-7b and at shapes that cross their partitions (two calls bit
for bit equal), then each DIR's kernels timed in turns with the
checkout's (old, new, new, old), warm and cold, then the checkout's beside
its plain version, the library call and the bound.  Then ptxas's
registers and spills of each source.  A DIR that holds a copy of a source
with one constant changed times that choice against the checkout's (a
``selective_scan_bwd.cu`` given the forward's chunk states).  ``--ssm``
runs the selective scan's phase alone.
Needs one NVIDIA GPU; prints the card's name and power limit first.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts the repository's src/ on the path)


def main() -> None:
    ssm_only = sys.argv[1:2] == ["--ssm"]
    dirs = sys.argv[2:] if ssm_only else sys.argv[1:]
    if not torch.cuda.is_available():
        sys.exit("bwd_sweep: no CUDA device; this script runs on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    sources = [os.path.basename(p) for p in (
        chip_smoke.FA_SOURCE, chip_smoke.SCAN_SOURCE, chip_smoke.SSM_SOURCE,
        chip_smoke.FA_BWD_SOURCE, chip_smoke.SCAN_BWD_SOURCE,
        chip_smoke.SSM_BWD_SOURCE)]
    build.build_all(sources)
    dev = torch.device("cuda")
    r = {} if ssm_only else chip_smoke.train_kernel_phase(
        get_config(chip_smoke.ARCH), dev, dirs)
    chip_smoke.free_library_memory()
    m = chip_smoke.ssm_bwd_phase(get_config(chip_smoke.MAMBA_ARCH), dev,
                                 dirs)
    for d in [chip_smoke.HERE_CSRC] + dirs:
        for src in sources[5:] if ssm_only else sources[3:]:
            for row in build.ptxas_report(src, d):
                print(f"ptxas {d}/{src}: {json.dumps(row)}", flush=True)
    print(json.dumps({"device": smi.stdout.strip(), "err": r.get("err"),
                      "t": r.get("t"), "turns": r.get("turns"),
                      "bound_ms": r.get("bound"),
                      "selective_scan_bwd": {
                          "err": m["err"], "t": m["t"], "turns": m["turns"],
                          "bound_ms": m["bound"],
                          "warps_per_sm": m["warps_per_sm"]}}), flush=True)


if __name__ == "__main__":
    main()
