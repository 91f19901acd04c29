"""Which aten ops of a federated LM training step DTensor can shard.

    python3 scripts/train_probe.py [--device cuda|cpu] [--out FILE]

Runs one smoke-size step of each of the four kinds of LM training the
sharded step covers -- recurrentgemma-2b mode A (RG-LRU and local
attention), falcon-mamba-7b mode A (the selective scan), grok-1-314b
mode B (MoE, ``fsdp_tp``) and deepseek-v2-236b mode B (MLA, MoE,
``ep_tp``) -- under Adafactor (the training plan's optimizer) and Adam,
with a dispatch mode that records every aten op the step runs.  Each op
is then looked up in this torch's DTensor sharding propagator: a
strategy, a rule, a custom handler of DTensor's dispatcher, or none
(factories, ops with no tensor argument, are listed apart: there is
nothing of theirs to shard).
An op with none is one that DTensor propagation over the step would
refuse on this torch (``NotImplementedError``), so it decides between
propagation and explicit collectives for the sharded step
(`repro_torch.core.sharding`).

Then it holds the one part of the step that runs on DTensors, the
optimizer update of a sharded leaf (`sharding.sharded_update`), at a
one-rank mesh against the plain update on the same leaf, and lists the
ops that reached DTensor there.  On a card, the LM kernels are built
from this checkout first.  A summary as one JSON object on the last
line; ``--out`` writes every op with its counts.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

KINDS = (("recurrentgemma-2b", "fedavg_replica"),
         ("falcon-mamba-7b", "fedavg_replica"),
         ("grok-1-314b", "trust_fsdp"),
         ("deepseek-v2-236b", "trust_fsdp"))
LM_SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu",
              "rglru_scan.cu", "rglru_scan_bwd.cu", "selective_scan.cu",
              "selective_scan_bwd.cu")


class Record(TorchDispatchMode):
    """Every aten op dispatched inside, by overload name, with a count;
    ``dtensor_only`` keeps only ops that had a DTensor argument."""

    def __init__(self, dtensor_only: bool = False):
        super().__init__()
        self.ops, self.dtensor_only = {}, dtensor_only
        self.funcs, self.factories = {}, set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        flat = torch.utils._pytree.tree_leaves((args, kwargs or {}))
        if not any(isinstance(a, torch.Tensor) for a in flat):
            self.factories.add(str(func))   # a factory: no tensor to shard
        if self.dtensor_only:
            from torch.distributed.tensor import DTensor
            if DTensor in types:
                name = str(func)
                self.ops[name] = self.ops.get(name, 0) + 1
                self.funcs[name] = func
                return NotImplemented
        else:
            name = str(func)
            self.ops[name] = self.ops.get(name, 0) + 1
            self.funcs[name] = func
        return func(*args, **(kwargs or {}))


def dtensor_support(func) -> str:
    """How this torch's DTensor handles ``func``: ``strategy``, ``rule``,
    ``custom`` (its dispatcher's own handler) or ``none``."""
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    prop = disp.sharding_propagator
    if func in getattr(disp, "_custom_op_handlers", {}):
        return "custom"
    for table in ("op_strategy_funcs", "op_single_dim_strategy_funcs"):
        if func in getattr(prop, table, {}):
            return "strategy"
    if func in getattr(prop, "op_to_rules", {}):
        return "rule"
    return "none"


def one_step(arch: str, mode: str, opt_name: str, dev) -> dict:
    import numpy as np
    from repro_torch import optim
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import fl_step as fl
    cfg = get_smoke_config(arch)
    opt = optim.REGISTRY[opt_name](1e-3)
    NC, C, n_micro, bm, seq = 1, 2, 2, 2, 32
    init = fl.build_init_fn(cfg, opt, mode=mode, n_clusters=NC,
                            clients_per_cluster=C, device=dev)
    state = init(0)
    g = np.random.default_rng(0)
    lead = (NC, C, n_micro, bm) if mode == fl.MODE_A else (NC, n_micro, bm)
    toks = torch.as_tensor(g.integers(0, cfg.vocab_size, lead + (seq + 1,)),
                           device=dev)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if mode == fl.MODE_B:
        batch["weights"] = torch.as_tensor(
            g.random(lead).astype(np.float32) + 0.5, device=dev)
    rep = torch.ones((NC, C), device=dev)
    stale = torch.zeros((NC,), device=dev)
    step = fl.build_train_step(cfg, opt, mode=mode)
    rec = Record()
    t0 = time.perf_counter()
    with rec:
        _, metrics = step(state, batch, rep, stale)
    loss = metrics["loss"].float()
    return {"ops": rec.ops, "funcs": rec.funcs, "factories": rec.factories,
            "seconds": time.perf_counter() - t0,
            "finite": bool(torch.isfinite(loss).all())}


def optimizer_on_dtensor(dev) -> dict:
    """The optimizer's update of a leaf at its placements on a one-rank
    mesh, its state and gradient wrapped as DTensors here (as
    `sharding.sharded_update` wraps a sharded leaf's), against the plain
    update of the same leaf."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import optim
    from repro_torch.api.placement import replicated_constants
    from repro_torch.core import sharding
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 1, device=dev)
    spec = (None, "model")

    def wrap(t, s):
        if not s and t.dim() == 0:
            return t                       # the step count: a constant
        return DTensor.from_local(t, mesh, sharding.placements(s, mesh),
                                  run_check=False)
    out = {}
    g = torch.Generator(device="cpu").manual_seed(0)
    p = torch.randn((64, 48), generator=g).to(dev)
    grad = torch.randn((64, 48), generator=g).to(dev)
    for name in ("adafactor", "adam"):
        opt = optim.REGISTRY[name](1e-3)
        st = opt.init({"w": p})
        want, _ = opt.update({"w": grad}, st, {"w": p})
        rec = Record(dtensor_only=True)
        with rec, replicated_constants():
            got, _ = opt.update(
                {"w": wrap(grad, spec)},
                sharding.map_tree(wrap, st, sharding.state_spec(st, spec)),
                {"w": wrap(p, spec)})
        got = sharding.local(got["w"])
        out[name] = {"equal": bool(torch.equal(got, want["w"])),
                     "max_abs": float((got - want["w"]).abs().max()),
                     "ops": rec.ops,
                     "unsupported": sorted(
                         k for k, f in rec.funcs.items()
                         if dtensor_support(f) == "none")}
    if dist.is_initialized():
        dist.destroy_process_group()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this file")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        build.build_all(LM_SOURCES)
        print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    res = {"torch": torch.__version__, "device": str(dev), "steps": {},
           "ops": {}}
    funcs, factories = {}, set()
    for arch, mode in KINDS:
        for opt_name in ("adafactor", "adam"):
            r = one_step(arch, mode, opt_name, dev)
            funcs.update(r.pop("funcs"))
            factories |= r.pop("factories")
            res["steps"][f"{arch}/{opt_name}"] = {
                "seconds": r["seconds"], "finite": r["finite"],
                "n_ops": len(r["ops"])}
            for k, n in r["ops"].items():
                res["ops"].setdefault(k, {})[f"{arch}/{opt_name}"] = n
            print(f"{arch} {mode} {opt_name}: {len(r['ops'])} ops, "
                  f"{r['seconds']:.2f} s, finite {r['finite']}", flush=True)
    support = {k: dtensor_support(f) for k, f in funcs.items()}
    res["support"] = support
    res["factories"] = sorted(factories)
    res["unsupported"] = {k: sorted(res["ops"][k]) for k, s in
                          sorted(support.items())
                          if s == "none" and k not in factories}
    for k, where in res["unsupported"].items():
        print(f"no DTensor strategy: {k} ({', '.join(where)})", flush=True)
    res["optimizer_on_dtensor"] = optimizer_on_dtensor(dev)
    for k, v in res["optimizer_on_dtensor"].items():
        print(f"optimizer {k} on DTensor: equal {v['equal']}, max abs "
              f"{v['max_abs']}, unsupported {v['unsupported']}", flush=True)
    line = json.dumps(res, sort_keys=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(json.dumps({k: res[k] for k in ("torch", "device", "steps",
                                          "unsupported", "factories")}
                     | {"optimizer_on_dtensor": {
                         k: {n: v[n] for n in ("equal", "max_abs",
                                               "unsupported")}
                         for k, v in res["optimizer_on_dtensor"].items()}},
                     sort_keys=True))
    ok = all(s["finite"] for s in res["steps"].values()) and all(
        v["max_abs"] < 1e-6 for v in res["optimizer_on_dtensor"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
