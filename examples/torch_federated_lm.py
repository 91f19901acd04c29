"""End-to-end driver of the PyTorch port: federated training of a reduced
assigned architecture with the full FL control plane, then serving it
with batched decode requests (the counterpart of
``examples/federated_lm.py``).

    PYTHONPATH=src python examples/torch_federated_lm.py --arch gemma-2b \
        --steps 200 [--device cpu]

``--device`` defaults to the card; ``cpu`` runs the kernels' plain
versions.
"""
import argparse
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)

    print(f"== federated training ({args.arch}, {args.steps} steps) ==")
    subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                    "--arch", args.arch, "--steps", str(args.steps),
                    "--clients", "4", "--clusters", "2",
                    "--device", args.device], check=True, env=env)
    print("== serving (prefill + batched decode) ==")
    subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                    "--arch", args.arch, "--batch", "4",
                    "--prompt-len", "32", "--gen", "32",
                    "--device", args.device], check=True, env=env)


if __name__ == "__main__":
    main()
