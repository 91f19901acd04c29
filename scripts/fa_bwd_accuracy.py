"""The attention backward kernel's error against a float64 gradient on a
training model's own inputs, by how long each output's sum runs, beside
the float32 plain version's, and against other versions of its source.

    python3 scripts/fa_bwd_accuracy.py [--arch A [A ...]] [DIR ...]

Builds ``flash_attention.cu`` and ``flash_attention_bwd.cu`` (and each
DIR's ``flash_attention_bwd.cu``, same C interface), takes the card's
training scenario of each ``--arch`` (``DEEPSEEK_V2_236B_TRAIN``: MLA, 128
heads, d 192, dv 128; ``MUSICGEN_LARGE_TRAIN``: 32 heads of 64) cut to
its first layer, seed 0, and runs the loss and its gradient on the
scenario's first Zipf microbatch (4096 positions, seed 0), keeping the
q, k, v that layer hands the attention kernel and the gradient that
reaches its output (dO, "live").  A second dO adds the live one's mean
over positions to every position ("coherent"): sums over many rows then
grow, as the forward's output did over repeated tokens.  For each, the
kernel's dq, dk, dv against a float64 gradient (autograd of a float64
attention, over head slices), beside the plain float32 backward's, each
error over the gradient's largest entry, by buckets of the rows an
output sums over: dq row i adds i + 1 keys, dk and dv row j add S - j
queries.  An error that grows with the bucket above the plain version's
grows along the kernel's loop.  Each DIR's backward is also held to the
float64 gradient and timed in turns with this checkout's (old, new, new,
old).  Needs one NVIDIA GPU; prints the card's name and power limit
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

BUCKETS = (0, 16, 128, 512, 1024, 2048, 3072, 4097)
SCENARIOS = {"deepseek-v2-236b": "DEEPSEEK_V2_236B_TRAIN",
             "musicgen-large": "MUSICGEN_LARGE_TRAIN"}
HEADS_A_SLICE = 16      # float64 scores of 16 heads at S 4096: 2.1 GB


def exact_grads(q, k, v, do):
    """dq, dk, dv of causal attention in float64 (H = Kv), head slice by
    head slice."""
    B, S, H, d = q.shape
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    grads = [torch.empty(x.shape, dtype=torch.float64, device=x.device)
             for x in (q, k, v)]
    for h0 in range(0, H, HEADS_A_SLICE):
        hs = slice(h0, min(H, h0 + HEADS_A_SLICE))
        leaves = [x[:, :, hs].double().requires_grad_() for x in (q, k, v)]
        s = torch.einsum("bshd,bthd->bhst", leaves[0], leaves[1]) * d ** -0.5
        w = torch.softmax(torch.where(mask, s, -1e300), dim=-1)
        out = torch.einsum("bhst,bthd->bshd", w, leaves[2])
        for g_, x in zip(grads, torch.autograd.grad(
                out, leaves, do[:, :, hs].double())):
            g_[:, :, hs] = x
        del s, w, out, leaves
    return grads


def errors(got, want, reverse: bool) -> dict:
    """Largest error over the gradient's largest entry, overall and by
    bucket of the rows each output sums over (``reverse``: row j sums S -
    j rows, else j + 1); also each bucket's over its own largest entry."""
    top = want.abs().max().clamp_min(1e-300)
    e = (got.double() - want).abs().amax(dim=(0, 2, 3))      # (S,)
    w = want.abs().amax(dim=(0, 2, 3))
    S = e.shape[0]
    length = (S - torch.arange(S, device=e.device) if reverse
              else torch.arange(S, device=e.device) + 1)
    out = {"max": (e.max() / top).item(), "by_rows_summed": {},
           "by_rows_summed_of_own_max": {}}
    for a, b in zip(BUCKETS, BUCKETS[1:]):
        sel = (length > a) & (length <= b)
        if sel.any():
            key = f"{a + 1}-{b}"
            out["by_rows_summed"][key] = (e[sel].max() / top).item()
            out["by_rows_summed_of_own_max"][key] = (
                e[sel].max() / w[sel].max().clamp_min(1e-300)).item()
    return out


def all_errors(got, want) -> dict:
    return {name: errors(g_, w_, reverse=name != "dq")
            for name, g_, w_ in zip(("dq", "dk", "dv"), got, want)}


def live_inputs(arch: str, dev):
    """q, k, v and dO of the first layer's attention in one microbatch of
    the arch's training scenario cut to one layer."""
    from repro_torch.api import FederationSpec, scenarios
    from repro_torch.api.components import LMTask
    from repro_torch.kernels import ops
    from repro_torch.models import LM, lm_loss
    spec = FederationSpec.from_dict(getattr(scenarios, SCENARIOS[arch]))
    params = {k: v for k, v in spec.task.params.items() if k != "mode"}
    task = LMTask(**params)
    cfg = dataclasses.replace(task.cfg, num_layers=1)
    task.cfg = cfg
    batch = task.make_batch(torch.Generator().manual_seed(0), 1, 1,
                            device=dev)
    mb = {k: v[0, 0, 0] for k, v in batch.items()}
    model = LM(cfg, device=dev, seed=0, trainable=True)
    seen = {}
    attention = ops.attention

    def keep(q, k, v, **kw):
        seen["qkv"] = tuple(x.detach().contiguous() for x in (q, k, v))
        out = attention(q, k, v, **kw)
        out.register_hook(lambda g: seen.setdefault("do", g.detach()
                                                    .contiguous()))
        return out

    ops.attention = keep
    try:
        lm_loss(model, mb, remat=False).backward()
    finally:
        ops.attention = attention
    del model
    torch.cuda.empty_cache()
    return (*seen["qkv"], seen["do"])


def compare(arch, q, k, v, do, what, libs) -> dict:
    from repro_torch.kernels.flash_attention import (_forward,
                                                     bwd_scratch_floats,
                                                     flash_attention_bwd)
    B, S, H, d = q.shape
    Kv, dv = k.shape[2], v.shape[3]
    out_, lse = _forward(q, k, v, 0, 0.0, True)
    want = exact_grads(q, k, v, do)
    res = {"arch": arch, "dO": what, "shape": [B, S, H, Kv, d, dv],
           "kernel": all_errors(flash_attention_bwd(q, k, v, out_, lse, do),
                                want)}
    po, pl = chip_smoke.plain_lse(q, k, v)
    res["plain_f32"] = all_errors(chip_smoke.plain_bwd(q, k, v, po, pl, do),
                                  want)
    del po, pl
    scratch = torch.empty((bwd_scratch_floats(B, S, H, Kv, d, dv),),
                          device=q.device)
    outs = [torch.empty_like(x) for x in (q, k, v)]

    def call(lib):
        def run():
            status = lib.fa_backward_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out_.data_ptr(),
                do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                *[x.data_ptr() for x in outs], B, S, H, Kv, d, dv,
                d ** -0.5, 0, 0.0, torch.cuda.current_stream().cuda_stream)
            chip_smoke.check(status == 0, f"fa_backward_f32: {status}")
        return run

    for where, lib in libs.items():
        call(lib)()
        res[f"kernel of {where}"] = all_errors(outs, want)
        res[f"in turns with {where}, ms"] = chip_smoke.in_turns(
            {"old": call(lib),
             "new": lambda: flash_attention_bwd(q, k, v, out_, lse, do)},
            reps=3, windows=3, warmup=1)
    print(json.dumps(res), flush=True)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="+", default=list(SCENARIOS),
                    choices=list(SCENARIOS))
    ap.add_argument("dirs", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("fa_bwd_accuracy: no CUDA device; this script runs on the "
                 "card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    from repro_torch.kernels import build
    build.build_all(["flash_attention.cu", "flash_attention_bwd.cu"])
    libs = chip_smoke.other_libraries("flash_attention_bwd.cu", args.dirs,
                                      "flash_attention", "_bwd_signatures")
    dev = torch.device("cuda")
    for arch in args.arch:
        q, k, v, do = live_inputs(arch, dev)
        coherent = do + do.mean(dim=1, keepdim=True)
        for what, d_out in (("live", do), ("coherent", coherent)):
            compare(arch, q, k, v, d_out, what, libs)
        del q, k, v, do, coherent
        torch.cuda.empty_cache()
    for d in [chip_smoke.HERE_CSRC] + args.dirs:
        for row in build.ptxas_report("flash_attention_bwd.cu", d):
            print(f"ptxas {d}/flash_attention_bwd.cu: {json.dumps(row)}",
                  flush=True)


if __name__ == "__main__":
    main()
