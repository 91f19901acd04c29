"""Where a round of the port's main path spends its time, on the card.

    python3 scripts/port_profile.py [--rounds 20]

Builds the federation `chip_smoke.py` drives (``paper-mlp-fleet1k``,
`repro_torch.api.scenarios.PAPER_MLP_FLEET1K`),
warms it up with 5 scanned rounds, then:

* times ``run_scanned(rounds)`` (no final evaluation) and an event-heap
  ``run(max_rounds=rounds)`` with a fixed a=5, host clock around work that
  ends in a synchronize: steady rounds/s;
* profiles one more ``run_scanned(rounds)`` with `torch.profiler` and
  prints the device's busy and idle share of the window, the kernels per
  round, and the kernels with the most device time.

Needs one NVIDIA GPU.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("port_profile: needs an NVIDIA GPU")
    from repro_torch.api import ControllerSpec, Federation, FederationSpec
    from repro_torch.api.scenarios import PAPER_MLP_FLEET1K
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    K = args.rounds
    spec = FederationSpec.from_dict(PAPER_MLP_FLEET1K)
    fed = Federation.from_spec(spec)
    fed.run_scanned(5, eval_final=False)            # warm-up
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    fed.run_scanned(K, eval_final=False)
    torch.cuda.synchronize()
    t_scan = time.perf_counter() - t0
    fixed = Federation.from_spec(
        spec.replace(controller=ControllerSpec("fixed", {"a": 5}),
                     sim_seconds=1e9),
        data=fed.engine.data, parts=fed.engine.parts)
    fixed.run(max_rounds=2, eval_every=1e9)          # warm-up
    t0 = time.perf_counter()
    fixed.run(max_rounds=K, eval_every=1e9)
    torch.cuda.synchronize()
    t_event = time.perf_counter() - t0
    print(f"steady run_scanned({K}), lyapunov: {K / t_scan:.3f} rounds/s "
          f"({1e3 * t_scan / K:.3f} ms/round)", flush=True)
    print(f"steady run(max_rounds={K}), fixed a=5, no evals: "
          f"{K / t_event:.3f} rounds/s ({1e3 * t_event / K:.3f} ms/round)",
          flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        tr = fed.run_scanned(K, eval_final=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    n_kernels = sum(e.count for e in events)
    a_mean = sum(r.a for r in tr.records) / len(tr.records)
    print(f"profiled run_scanned({K}): wall {1e3 * wall:.3f} ms, device "
          f"busy {dev_us / 1e3:.3f} ms ({100 * dev_us / 1e6 / wall:.2f} %), "
          f"idle {100 * (1 - dev_us / 1e6 / wall):.2f} %; "
          f"{n_kernels / K:.1f} device ops per round at mean a "
          f"{a_mean:.2f}", flush=True)
    print("top device time by kernel (ms over the window, calls):")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}  "
              f"{e.key[:110]}")


if __name__ == "__main__":
    main()
