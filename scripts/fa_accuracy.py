"""The attention kernel's error against a float64 reference on a served
model's own inputs, beside the float32 plain version's, and against
other versions of its source.

    python3 scripts/fa_accuracy.py [--arch gemma-7b] [DIR ...]

Builds ``flash_attention.cu`` (this checkout's and each DIR's, same C
interface), serves ``--arch`` at full width cut to its first layer
(batch 4, 4096-token Zipf prompts, seed 0: the first layer's weights and
inputs are those of the full model in ``chip_smoke.py`` phase 7), keeps
the q, k, v that layer hands the kernel, and prints for each source the
largest error against a float64 attention over buckets of query rows
(row i sees i + 1 keys: an error that grows with the rows is one that
grows along the key loop), with the plain float32 version's, then each
DIR's source timed in turns with this checkout's at that shape (old,
new, new, old).  Also at recurrentgemma-2b's serving shape (4, 4096, 10
heads over 1, d 256, window 2048) on random inputs of unit scale, and,
timed only (a float64 reference there would hold 34 GB of scores a batch
row), at deepseek-v2's MLA prefill shape (4, 4096, 128 heads, d 192, dv
128).  Needs one NVIDIA GPU; prints the card's name and power limit
first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts the repository's src/ on the path)

BUCKETS = (0, 16, 128, 512, 1024, 2048, 3072, 4096)


def exact(q, k, v, window: int, softcap: float) -> torch.Tensor:
    """Causal attention in float64, one batch row at a time."""
    B, S, H, d = q.shape
    Kv = k.shape[2]
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    out = []
    for b in range(B):
        qg = q[b:b + 1].double().reshape(1, S, Kv, H // Kv, d)
        s = torch.einsum("bskgd,btkd->bkgst", qg, k[b:b + 1].double())
        s = s * d ** -0.5
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        w = torch.softmax(torch.where(mask, s, -1e300), dim=-1)
        del s
        out.append(torch.einsum("bkgst,btkd->bskgd", w, v[b:b + 1].double())
                   .reshape(1, S, H, v.shape[3]))
    return torch.cat(out)


def errors(got, want) -> dict:
    e = (got.double() - want).abs()
    rows = [(a, min(b, e.shape[1])) for a, b in zip(BUCKETS, BUCKETS[1:])
            if a < e.shape[1]]
    return {"max": e.max().item(), "mean": e.mean().item(),
            "max_by_rows": {f"{a}-{b}": e[:, a:b].max().item()
                            for a, b in rows}}


def compare(name, q, k, v, window, softcap, libs, timed_only=False
            ) -> dict:
    from repro_torch.kernels import flash_attention
    B, S, H, d = q.shape
    Kv, dv = k.shape[2], v.shape[3]
    out = {"case": name, "shape": [B, S, H, Kv, d, dv], "window": window,
           "softcap": softcap}
    want = None
    if not timed_only:
        want = exact(q, k, v, window, softcap)
        out["plain_f32"] = errors(chip_smoke.plain_attention(
            q, k, v, window=window, softcap=softcap), want)
        out["kernel"] = errors(flash_attention(q, k, v, window=window,
                                               softcap=softcap), want)
    res = torch.empty((B, S, H, dv), device=q.device)

    def call(lib):
        def run():
            status = lib.fa_forward_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), res.data_ptr(), B,
                S, H, Kv, d, dv, d ** -0.5, window, softcap,
                torch.cuda.current_stream().cuda_stream)
            chip_smoke.check(status == 0, f"fa_forward_f32 failed: {status}")
        return run

    for where, lib in libs.items():
        if want is not None:
            call(lib)()
            out[f"kernel of {where}"] = errors(res, want)
        out[f"in turns with {where}, ms"] = chip_smoke.in_turns(
            {"old": call(lib),
             "new": lambda: flash_attention(q, k, v, window=window,
                                            softcap=softcap)})
    print(json.dumps(out), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("dirs", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("fa_accuracy: no CUDA device; this script runs on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.launch.serve import generate
    build.build_all(["flash_attention.cu"])
    libs = chip_smoke.other_libraries("flash_attention.cu", args.dirs,
                                      "flash_attention")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(args.arch), num_layers=1)
    seen = {}
    attention = ops.attention

    def keep(*a, **kw):
        seen.setdefault("qkv", (a, kw))
        return attention(*a, **kw)

    ops.attention = keep
    try:
        generate(cfg, chip_smoke.SERVE_BATCH, chip_smoke.SERVE_PROMPT, 2,
                 temperature=0.0, seed=0, device=dev)
    finally:
        ops.attention = attention
    (q, k, v), kw = seen.pop("qkv")
    torch.cuda.empty_cache()
    compare(f"{args.arch}, first layer's own inputs", q, k, v,
            kw.get("window", 0), kw.get("softcap", 0.0), libs)
    del q, k, v
    g = torch.Generator(device=dev).manual_seed(5)
    B, S = chip_smoke.SERVE_BATCH, chip_smoke.SERVE_PROMPT
    q = torch.randn((B, S, 10, 256), generator=g, device=dev)
    k = torch.randn((B, S, 1, 256), generator=g, device=dev)
    v = torch.randn((B, S, 1, 256), generator=g, device=dev)
    compare("random, unit scale, recurrentgemma-2b's heads", q, k, v, 2048,
            0.0, libs)
    del q, k, v
    q, k, v = chip_smoke.attn_inputs(B, S, 128, 128, 192, torch.float32,
                                     dev, 97, dv=128)
    compare("MLA's prefill, timed only", q, k, v, 0, 0.0, libs,
            timed_only=True)
    for d in [chip_smoke.HERE_CSRC] + args.dirs:
        for row in build.ptxas_report("flash_attention.cu", d):
            print(f"ptxas {d}/flash_attention.cu: {json.dumps(row)}",
                  flush=True)


if __name__ == "__main__":
    main()
