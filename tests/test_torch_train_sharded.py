"""The sharded federated LM training step of the port
(`repro_torch.core.sharding`, `repro_torch.core.fl_step` on placed state).

* One ``spawn_local`` job of 4 gloo ranks on the CPU, started with the
  file's first test so it overlaps the in-process ones: the four kinds at
  smoke size on a ``('data', 'model')`` mesh (2, 2) -- recurrentgemma-2b
  and falcon-mamba-7b in mode A, grok-1-314b (``fsdp_tp``) and
  deepseek-v2-236b (``ep_tp``, MLA) in mode B -- against the unsharded
  step from the same seeded state; mode A on ``('pod', 'data',
  'model')`` = (2, 2, 1); query heads that do not split whole over
  ``model`` (recurrentgemma's and MLA's at mesh (1, 4) with 2 heads); the
  expert-parallel branch in the step against the plain dispatch where
  neither drops a token; one sharded mode-A step on
  `train_state_from_numpy` weights against the JAX package's jitted
  ``build_train_step``; and the expert-parallel ``moe_forward`` against the
  JAX package's under ``jax.sharding.set_mesh`` on 4 forced host devices
  (one subprocess), routing equal.
* In process: mesh (1, 1) is the unsharded step bit for bit.

Every sharded case holds the losses, the metrics and every parameter to
1e-5 of the leaf's largest entry, under Adafactor (the training plan's
optimizer).  Each case also records the whole gradient each client's
update is given, and holds it to the unsharded step's at 1e-5, and holds
the sharded step to the unsharded step fed the sharded step's gradients
(the same update of the same gradients) at 1e-5.  (Adam's first step
divides each gradient by its own size, so an entry whose gradient is
near zero takes a step of either sign from float32 reassociation alone;
the JAX case runs Adam from a state with moments, as
``tests/test_torch_train.py`` does.)  Adafactor's first step from zero
moments updates a stacked group's 1-D leaves -- the JAX package's (G, n)
leaf, its moments factored into rows (G,) and columns (n,) -- in
proportion to each gradient entry over the column's mean square across
the G layers, so a zero-initialised bias of such a group carries its
gradient's reassociation, magnified where the column is small:
falcon-mamba-7b's two MAMBA layers from zero moments (``fm-a-2x2``) read
1.1e-5 at ``layers.1.mamba.dt_bias``, its gradient 3.3e-6 apart and every
gradient within 4.7e-6 (of the leaf's largest).  That
case holds the gradients and the update of the same gradients at 1e-5,
and reports its parameters' gap without a bound; ``fm-a-2x2-warm`` runs
it from a state one unsharded step in, whose moments both runs share,
and holds the parameters at 1e-5 too.  The same case checks that a
stacked group of >= 2-D leaves sharded on ``model`` is gathered whole a
leaf at a time: no leaf's whole gradient is alive when the next one's is
given to the optimizer.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import fl_step as jfl  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import fl_step as tfl  # noqa: E402
from repro_torch.core import sharding as shd  # noqa: E402
from repro_torch.launch.distributed import spawn_local  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.transformer import named_from_tree  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TOL = 1e-5
JOB_TIMEOUT = 240               # seconds, the 4-rank job
KINDS = ("recurrentgemma-2b", "falcon-mamba-7b", "grok-1-314b",
         "deepseek-v2-236b")
# the JAX case: recurrentgemma-2b's smoke config cut to one Griffin period
JAX_NC, JAX_C, JAX_MICRO, JAX_BM, JAX_SEQ, JAX_STEPS = 2, 2, 2, 1, 32, 2
EP_B, EP_S = 4, 12              # the MoE's tokens: 48, 24 a data shard

# the job: each case on the 4 ranks, every number on rank 0
CASES = {
    "rg-a-2x2": dict(arch=KINDS[0], mesh=[2, 2], NC=1, C=2),
    "fm-a-2x2": dict(arch=KINDS[1], mesh=[2, 2], NC=1, C=2,
                     amplified=True),
    "fm-a-2x2-warm": dict(arch=KINDS[1], mesh=[2, 2], NC=1, C=2, warm=True),
    "grok-b-2x2": dict(arch=KINDS[2], mesh=[2, 2], NC=1, bm=4),
    "ds-b-2x2": dict(arch=KINDS[3], mesh=[2, 2], NC=1, bm=4),
    "rg-a-2x2x1": dict(arch=KINDS[0], mesh=[2, 2, 1], NC=2, C=2),
    "rg-a-1x4-h2": dict(arch=KINDS[0], mesh=[1, 4], NC=1, C=2, heads=2),
    "ds-b-1x4-h2": dict(arch=KINDS[3], mesh=[1, 4], NC=1, bm=2, heads=2),
    "ds-b-2x2-ep": dict(arch=KINDS[3], mesh=[2, 2], NC=1, bm=4, ep=True,
                        cf=8.0),
}

WORKER = r"""
import json, os, pickle, sys, weakref
import numpy as np
import torch
torch.set_num_threads(1)
cfg_job = json.loads(sys.argv[1])
sys.path.insert(0, cfg_job["src"])
from repro_torch.launch.distributed import initialize_from_env
initialize_from_env("cpu")
import dataclasses
import torch.distributed as dist
from repro_torch import optim
from repro_torch.configs import get_smoke_config
from repro_torch.core import fl_step as fl, sharding as shd
from repro_torch.launch.mesh import axis_size, host_mesh_for
from repro_torch.models import moe as moe_mod
from repro_torch.models.moe import moe_forward
from repro_torch.models.transformer import param_specs

clone = lambda tree: shd.map_tree(lambda t: t.clone(), tree)


def rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def state_specs(cfg, mode, mesh, state, opt_name):
    pod_axis = "pod" if axis_size(mesh, "pod") > 1 else None
    return fl.train_state_specs(cfg, state, mode=mode, opt_name=opt_name,
                                pod_axis=pod_axis,
                                tp_size=axis_size(mesh, "model"))


def place_and_step(cfg, mode, mesh, opt, opt_name, state, batch, rep,
                   stale, **kw):
    pod_axis = "pod" if axis_size(mesh, "pod") > 1 else None
    specs = state_specs(cfg, mode, mesh, state, opt_name)
    placed = shd.distribute_state(
        fl.TrainState(clone(state.params), clone(state.opt), 0), specs, mesh)
    bsp = fl.batch_specs(cfg, batch, mode=mode, pod_axis=pod_axis)
    step = fl.build_train_step(cfg, opt, mode=mode, **kw)
    out, m = step(placed, shd.distribute_batch(batch, bsp, mesh), rep, stale)
    layout = all(tuple(v.placements) == shd.placements(specs.params[k], mesh)
                 for k, v in out.params.items())
    return shd.full_state(out), m, layout, specs


def recording(opt, rec):
    # opt, recording the whole gradient each client's update is given (a
    # client a dict, in the order the step updates them), or, where
    # rec["replay"] holds such a list, updating with those gradients
    # instead; at each leaf of a stacked group of >= 2-D leaves
    # (unclipped): how many earlier leaves' whole gradients are still
    # alive, and whether the leaf came whole where it is sharded
    rec.update(grads=[], refs=[], live=0, gathered=0)

    def take(gs):
        cur = rec["grads"][-1] if rec["grads"] else None
        if cur is None or any(k in cur for k in gs):
            rec["grads"].append({})
        if rec.get("replay") is not None:
            src = rec["replay"][len(rec["grads"]) - 1]
            gs = {k: src[k].to(g.dtype) for k, g in gs.items()}
        rec["grads"][-1].update({k: g.detach().clone()
                                 for k, g in gs.items()})
        return gs

    def update(grads, state, params=None, groups=()):
        return opt.update(take(grads), state, params, groups=groups)

    def unclipped(grads, state):
        for k, g in grads.items():
            rec["live"] = max(rec["live"],
                              sum(r() is not None for r in rec["refs"]))
            rec["refs"].append(weakref.ref(g))
            rec["gathered"] += (k in rec.get("sharded", ()) and
                                tuple(g.shape) == rec["shapes"][k])
        return opt.unclipped(take(grads), state)
    return optim.Optimizer(opt.init, update, unclipped, opt.clipped)


def client_ids(specs, mode, lead, mesh):
    # the clients (clusters in mode B) this rank steps, in its order
    k = next(iter(specs.params))
    n = lead[0] * (lead[1] if mode == fl.MODE_A else 1)
    ids = torch.arange(n).reshape(lead[:2 if mode == fl.MODE_A else 1])
    return shd.local_chunk(ids, specs.params[k][:ids.dim()],
                           mesh).flatten().tolist()


def seeded_case(case):
    cfg = get_smoke_config(case["arch"])
    if "heads" in case:
        cfg = dataclasses.replace(
            cfg, num_heads=case["heads"],
            num_kv_heads=min(cfg.num_kv_heads, case["heads"]))
    if "cf" in case:
        cfg = dataclasses.replace(cfg, capacity_factor=case["cf"])
    mode = cfg.fl_mode
    mesh = host_mesh_for(case["mesh"], device="cpu")
    NC, C = case["NC"], case.get("C", 1)
    opt = optim.adafactor(1e-2)
    state = fl.build_init_fn(cfg, opt, mode=mode, n_clusters=NC,
                             clients_per_cluster=C, device="cpu")(3)
    g = np.random.default_rng(5)
    n_micro, bm, seq = 2, case.get("bm", 2), 24
    lead = (NC, C, n_micro, bm) if mode == fl.MODE_A else (NC, n_micro, bm)
    toks = torch.as_tensor(g.integers(0, cfg.vocab_size, lead + (seq + 1,)))
    batch = {"tokens": toks[..., :-1].contiguous(),
             "labels": toks[..., 1:].contiguous()}
    if mode == fl.MODE_B:
        batch["weights"] = torch.as_tensor(
            g.random(lead).astype(np.float32) + 0.5)
    rep = torch.as_tensor(g.random((NC, C)).astype(np.float32) + 0.1)
    stale = torch.as_tensor(np.arange(NC, dtype=np.float32))
    if case.get("warm"):        # from a state one unsharded step in
        state, _ = fl.build_train_step(cfg, opt, mode=mode)(
            fl.TrainState(clone(state.params), clone(state.opt), 0), batch,
            rep, stale)
    nl = 2 if mode == fl.MODE_A else 1
    specs = state_specs(cfg, mode, mesh, state, "adafactor")
    rec = {"shapes": {k: tuple(v.shape[nl:])
                      for k, v in state.params.items()},
           "sharded": {k for k, v in state.params.items() if shd.local_chunk(
               v, specs.params[k], mesh).shape[nl:] != v.shape[nl:]}}
    got, m, layout, _ = place_and_step(
        cfg, mode, mesh, recording(opt, rec), "adafactor", state, batch,
        rep, stale, ep=case.get("ep", False))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (client_ids(specs, mode, lead, mesh),
                                   rec["grads"]))
    sharded = {}
    for ids, grads in every:
        sharded.update(zip(ids, grads))
    wrec = {}
    want, mw = fl.build_train_step(cfg, recording(opt, wrec), mode=mode)(
        fl.TrainState(clone(state.params), clone(state.opt), 0), batch,
        rep, stale)
    rrec = {"replay": [sharded[i] for i in range(len(sharded))]}
    fed, _ = fl.build_train_step(cfg, recording(opt, rrec), mode=mode)(
        fl.TrainState(clone(state.params), clone(state.opt), 0), batch,
        rep, stale)
    errs = {k: rel(got.params[k], want.params[k]) for k in want.params}
    grad = {f"{i}:{k}": rel(sharded[i][k], w[k])
            for i, w in enumerate(wrec["grads"]) for k in w}
    return {"param_rel": max(errs.values()),
            "worst": max(errs, key=errs.get),
            "grad_rel": max(grad.values()),
            "grad_worst": max(grad, key=grad.get),
            "fed_rel": max(rel(got.params[k], fed.params[k])
                           for k in fed.params),
            "clients": len(wrec["grads"]),
            "live": rec["live"], "gathered": rec["gathered"],
            "metrics_rel": {k: rel(m[k], mw[k]) for k in mw},
            "layout": layout, "round": got.round}


def jax_case(d):
    with open(os.path.join(d, "jax_in.pkl"), "rb") as f:
        inp = pickle.load(f)
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                              num_layers=3)
    mode = fl.MODE_A
    state = fl.train_state_from_numpy(inp["state"], cfg, mode=mode,
                                      device="cpu")
    batch = {k: torch.from_numpy(np.asarray(v, np.int64))
             for k, v in inp["batch"].items()}
    got, m, layout, _ = place_and_step(
        cfg, mode, host_mesh_for([2, 2], device="cpu"), optim.adam(3e-4),
        "adam", state, batch, torch.from_numpy(inp["rep"]),
        torch.from_numpy(inp["stale"]), local_steps=inp["steps"])
    if dist.get_rank() == 0:
        with open(os.path.join(d, "jax_out.pkl"), "wb") as f:
            pickle.dump({"params": {k: v.numpy() for k, v in
                                    got.params.items()},
                         "metrics": {k: v.numpy() for k, v in m.items()}},
                        f)
    return {"layout": layout}


def recorded(rec, call):
    # call() with the MoE block's routing (gate_idx) and dispatch (slot,
    # keep, cap) written into rec
    route, dispatch = moe_mod.route, moe_mod.dispatch

    def routed(*a, **k):
        out = route(*a, **k)
        rec["gate_idx"] = out[2]
        return out

    def dispatched(xt, e_flat, E, cap):
        out = dispatch(xt, e_flat, E, cap)
        rec.update(slot=out[1], keep=out[2], cap=cap)
        return out
    moe_mod.route, moe_mod.dispatch = routed, dispatched
    try:
        return call()
    finally:
        moe_mod.route, moe_mod.dispatch = route, dispatch


def moe_case(d):
    with open(os.path.join(d, "moe_in.pkl"), "rb") as f:
        inp = pickle.load(f)
    cfg = get_smoke_config("deepseek-v2-236b")
    mesh = host_mesh_for([2, 2], device="cpu")
    names = {f"layers.1.moe.{k}": v for k, v in inp["p"].items()}
    out = {}
    for ep_size in (2, 16):     # experts over data; d_ff over both axes
        specs = param_specs(names, cfg, fsdp="data", tp_size=2,
                            ep_size=ep_size)
        sh = shd.Shards(mesh, {k: shd.compute_spec(k, s)
                               for k, s in specs.items()},
                        tokens=("data",), ep=True).sub("layers.1.moe")
        p = {k.split(".", 3)[3]: shd.local_chunk(torch.from_numpy(v),
                                                 specs[k], mesh)
             for k, v in names.items()}
        x = shd.local_chunk(torch.from_numpy(inp["x"]),
                            ("data", None, None), mesh)
        rec = {}
        y, aux = recorded(rec, lambda: moe_forward(p, cfg, x, shards=sh))
        mine = {"y": y.detach().numpy(), "aux": float(aux),
                "gate_idx": rec["gate_idx"].numpy(),
                "slot": rec["slot"].numpy(), "keep": rec["keep"].numpy(),
                "cap": rec["cap"], "data": sh.index(("data",))}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        out[ep_size] = every
    if dist.get_rank() == 0:
        with open(os.path.join(d, "moe_out.pkl"), "wb") as f:
            pickle.dump(out, f)
    return {}


res = {name: seeded_case(case) for name, case in cfg_job["cases"].items()}
res["jax"] = jax_case(cfg_job["dir"])
res["moe"] = moe_case(cfg_job["dir"])
if dist.get_rank() == 0:
    print("RESULT" + json.dumps(res), flush=True)
dist.destroy_process_group()
"""

# the JAX package's expert-parallel branch under set_mesh, 4 host devices
JAX_EP = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
import jax.experimental.shard_map as legacy
from repro.configs import get_smoke_config
from repro.models import moe
# the branch calls jax.experimental.shard_map.shard_map with check_vma,
# the keyword of jax.shard_map: this jax's experimental one takes check_rep
legacy.shard_map = jax.shard_map
d = sys.argv[1]
with open(os.path.join(d, "moe_in.pkl"), "rb") as f:
    inp = pickle.load(f)
cfg = get_smoke_config("deepseek-v2-236b")
p = jax.tree.map(jnp.asarray, inp["p"])
p["shared"] = {k[len("shared."):]: p.pop(k) for k in list(p)
               if k.startswith("shared.")}
x = jnp.asarray(inp["x"])
mesh = jax.make_mesh((2, 2), ("data", "model"))
f = jax.jit(lambda p, x: moe.moe_forward(p, cfg, x))
with jax.sharding.set_mesh(mesh):
    hlo = f.lower(p, x).as_text()
    y, aux = f(p, x)
B, S, D = x.shape
E, K, T, nd = cfg.num_experts, cfg.topk, B * S, 2
xt = x.reshape(T, D)
probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], axis=-1)
_, gate_idx = jax.lax.top_k(probs, K)
cap = int(max(1, (T // nd) * K * cfg.capacity_factor // E))
e_flat, Tl = gate_idx.reshape(T * K), T // nd
shards = [moe._dispatch_local(xt[i * Tl:(i + 1) * Tl],
                              e_flat[i * Tl * K:(i + 1) * Tl * K], E, cap,
                              x.dtype) for i in range(nd)]
with open(os.path.join(d, "moe_jax.pkl"), "wb") as f:
    pickle.dump({"y": np.asarray(y), "aux": float(aux),
                 "all_to_all": "all-to-all" in hlo or "all_to_all" in hlo,
                 "gate_idx": np.asarray(gate_idx), "cap": cap,
                 "slot": [np.asarray(s[1]) for s in shards],
                 "keep": [np.asarray(s[2]) for s in shards]}, f)
"""

# F3: the JAX package's own training step under Adafactor at fm-a-2x2's
# config (falcon-mamba-7b smoke, mode A, NC 1 x C 2, 2 microbatches of 2 x
# 24 tokens, zero moments), sharded on a (2, 2) ('data', 'model') mesh of 4
# forced host devices against the same step unsharded; each parameter's
# largest difference over its leaf's largest entry, under Adafactor and
# under SGD
JAX_F3 = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.core import fl_step as fl
from repro.optim import adafactor, sgd

cfg = get_smoke_config("falcon-mamba-7b")
mode, NC, C, n_micro, bm, seq = cfg.fl_mode, 1, 2, 2, 2, 24
g = np.random.default_rng(5)
toks = g.integers(0, cfg.vocab_size,
                  (NC, C, n_micro, bm, seq + 1)).astype(np.int32)
batch = {"tokens": jnp.asarray(toks[..., :-1]),
         "labels": jnp.asarray(toks[..., 1:])}
rep = jnp.asarray(g.random((NC, C)).astype(np.float32) + 0.1)
stale = jnp.zeros((NC,), jnp.float32)
mesh = jax.make_mesh((2, 2), ("data", "model"))
ns = lambda s: jax.tree.map(lambda x: NamedSharding(mesh, x), s,
                            is_leaf=lambda x: isinstance(x, P))
out = {}
for name, opt in (("adafactor", adafactor(1e-2)), ("sgd", sgd(1e-2))):
    state = fl.build_init_fn(cfg, opt, mode=mode, n_clusters=NC,
                             clients_per_cluster=C)(jax.random.PRNGKey(3))
    step = fl.build_train_step(cfg, opt, mode=mode)
    plain = jax.jit(step)(state, batch, rep, stale)[0]
    specs = fl.train_state_specs(cfg, jax.eval_shape(lambda: state),
                                 mode=mode, opt_name=name, pod_axis=None,
                                 tp_size=2)
    bsp = fl.batch_specs(cfg, batch, mode=mode, pod_axis=None)
    with mesh:
        sharded = jax.jit(step, in_shardings=(
            ns(specs), ns(bsp), ns(P(None, None)), ns(P(None))),
            out_shardings=(ns(specs), None))(state, batch, rep, stale)[0]
    errs = {}
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(
            plain.params)[0], jax.tree.leaves(sharded.params)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        errs[jax.tree_util.keystr(path)] = float(
            np.abs(b - a).max() / max(np.abs(a).max(), 1e-30))
    worst = max(errs, key=errs.get)
    out[name] = {"rel": errs[worst], "worst": worst}
print("F3" + json.dumps(out))
"""



def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want), initial=0.0)
                 / (np.max(np.abs(want), initial=0.0) + 1e-30))


def _jax_inputs(seed=0):
    """A mode-A state of one Griffin period with perturbed clients and Adam
    moments of a few steps, a batch, reputations and staleness, as numpy
    (``tests/test_torch_train.py``'s recipe)."""
    cfg = dataclasses.replace(jax_smoke_config("recurrentgemma-2b"),
                              num_layers=3)
    opt = jopt.adam(3e-4)
    init = jfl.build_init_fn(cfg, opt, mode=jfl.MODE_A, n_clusters=JAX_NC,
                             clients_per_cluster=JAX_C)
    tree = init(jax.random.PRNGKey(seed)).params
    g = np.random.default_rng(seed)
    pert = lambda x: (np.asarray(x) + g.standard_normal(x.shape) * 0.01
                      ).astype(np.float32)
    params = jax.tree.map(pert, tree)
    m = jax.tree.map(lambda x: (g.standard_normal(x.shape) * 1e-3
                                ).astype(np.float32), tree)
    v = jax.tree.map(lambda x: (g.random(x.shape) * 1e-5
                                ).astype(np.float32), tree)
    lead = (JAX_NC, JAX_C)
    state = {"params": params,
             "opt": {"m": m, "v": v, "t": np.full(lead, 3, np.int32)},
             "round": 0}
    toks = g.integers(0, 512, lead + (JAX_MICRO, JAX_BM, JAX_SEQ + 1))
    batch = {"tokens": toks[..., :-1].astype(np.int32),
             "labels": toks[..., 1:].astype(np.int32)}
    rep = (g.random(lead) + 0.1).astype(np.float32)
    stale = np.asarray([0.0, 2.0], np.float32)
    return cfg, opt, {"state": state, "batch": batch, "rep": rep,
                      "stale": stale, "steps": JAX_STEPS}


def _moe_inputs(seed=1):
    cfg = get_smoke_config("deepseek-v2-236b")
    g = np.random.default_rng(seed)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    Fs = cfg.num_shared_experts * F
    w = lambda *s: (g.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
    p = {"router": (g.standard_normal((D, E)) * 0.02).astype(np.float32),
         "wg": w(E, D, F), "wu": w(E, D, F), "wd": w(E, F, D),
         "shared.wg": w(D, Fs), "shared.wu": w(D, Fs),
         "shared.wd": w(Fs, D)}
    x = g.standard_normal((EP_B, EP_S, D)).astype(np.float32)
    return {"p": p, "x": x}


def _run_job(d):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = spawn_local(["-c", WORKER, json.dumps(
        {"src": SRC, "dir": d, "cases": CASES})], n_procs=4,
        timeout=JOB_TIMEOUT, env=env)
    for o in out:
        assert o.returncode == 0, o.stderr[-4000:]
    return json.loads(out[0].stdout.split("RESULT", 1)[1])


def _run_jax_f3():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_F3], env=env,
                       capture_output=True, text=True, timeout=JOB_TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.split("F3", 1)[1])


def _run_jax_ep(d):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_EP, d], env=env,
                       capture_output=True, text=True, timeout=JOB_TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(os.path.join(d, "moe_jax.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module", autouse=True)
def started():
    """The inputs written, then the 4-rank job and the JAX subprocess
    started with the module's first test; the JAX step runs meanwhile."""
    with tempfile.TemporaryDirectory(prefix="train_sharded_") as d:
        cfg, opt, inp = _jax_inputs()
        with open(os.path.join(d, "jax_in.pkl"), "wb") as f:
            pickle.dump(inp, f)
        with open(os.path.join(d, "moe_in.pkl"), "wb") as f:
            pickle.dump(_moe_inputs(), f)
        pool = concurrent.futures.ThreadPoolExecutor(3)
        yield {"dir": d, "cfg": cfg, "opt": opt, "inp": inp,
               "job": pool.submit(_run_job, d),
               "jax_ep": pool.submit(_run_jax_ep, d),
               "jax_f3": pool.submit(_run_jax_f3)}
        pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def job(started):
    return started["job"].result()


# ---------------------------------------------------------------------- #
# in process: mesh (1, 1) is the unsharded step
# ---------------------------------------------------------------------- #
def _seeded(arch, NC=1, C=2):
    cfg = get_smoke_config(arch)
    mode = cfg.fl_mode
    opt = topt.adafactor(1e-2)
    state = tfl.build_init_fn(cfg, opt, mode=mode, n_clusters=NC,
                              clients_per_cluster=C, device="cpu")(7)
    g = np.random.default_rng(7)
    lead = (NC, C, 2, 2) if mode == tfl.MODE_A else (NC, 2, 2)
    toks = torch.as_tensor(g.integers(0, cfg.vocab_size, lead + (17,)))
    batch = {"tokens": toks[..., :-1].contiguous(),
             "labels": toks[..., 1:].contiguous()}
    if mode == tfl.MODE_B:
        batch["weights"] = torch.as_tensor(
            g.random(lead).astype(np.float32) + 0.5)
    rep = torch.as_tensor(g.random((NC, C)).astype(np.float32) + 0.1)
    return cfg, mode, opt, state, batch, rep, torch.zeros((NC,))


@pytest.mark.parametrize("arch", KINDS)
def test_mesh_1x1_is_the_unsharded_step_bit_for_bit(arch):
    cfg, mode, opt, state, batch, rep, stale = _seeded(arch)
    mesh = make_host_mesh(1, 1, device="cpu")
    specs = tfl.train_state_specs(cfg, state, mode=mode,
                                  opt_name="adafactor", tp_size=1)
    placed = shd.distribute_state(tfl.TrainState(
        shd.map_tree(torch.clone, state.params),
        shd.map_tree(torch.clone, state.opt), 0), specs, mesh)
    step = tfl.build_train_step(cfg, opt, mode=mode)
    out, m = step(placed, batch, rep, stale)
    # the state stays at its placements, the same tensors, updated in place
    for k, v in out.params.items():
        assert shd.is_dtensor(v) and v is placed.params[k]
        assert tuple(v.placements) == shd.placements(specs.params[k], mesh)
    got = shd.full_state(out)
    want, mw = step(state, batch, rep, stale)
    assert got.round == want.round == 1
    for k in want.params:
        assert torch.equal(got.params[k], want.params[k]), k
    flat = lambda t: {"/".join(p): v for p, v in _leaves(t)}
    go, wo = flat(got.opt), flat(want.opt)
    assert set(go) == set(wo)
    for k in wo:
        assert torch.equal(go[k], wo[k]), k
    for k in mw:
        assert torch.equal(m[k], mw[k]), k


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def test_distribute_and_full_round_trip_the_specs():
    cfg, mode, opt, state, batch, rep, stale = _seeded(KINDS[3])
    mesh = make_host_mesh(1, 1, device="cpu")
    specs = tfl.train_state_specs(cfg, state, mode=mode,
                                  opt_name="adafactor", tp_size=1)
    placed = shd.distribute_state(state, specs, mesh)
    back = shd.full_state(placed)
    for k, v in state.params.items():
        assert torch.equal(back.params[k], v)
        assert shd.spec_of(placed.params[k]) == specs.params[k]
    with pytest.raises(ValueError, match="does not divide"):
        shd.local_chunk(torch.zeros(3, 4), (None, "model"),
                        _FakeMesh({"data": 1, "model": 3}))
    with pytest.raises(ValueError, match="major to minor"):
        shd.placements(((("model", "data")),), mesh)
    with pytest.raises(ValueError, match="does not have"):
        shd.placements(("pod",), mesh)


class _FakeMesh:
    """What `local_chunk` reads of a mesh, without a process group."""

    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = list(sizes.values())

    def size(self, i):
        return self._sizes[i]

    def get_local_rank(self, i):
        return 0


def test_compute_specs_gather_fsdp_but_keep_experts_and_joint_dims():
    assert shd.compute_spec("layers.0.attn.wq", ("data", "model")) == (
        None, "model")
    assert shd.compute_spec("layers.1.moe.wg", ("data", None, "model")) == (
        "data", None, "model")
    assert shd.compute_spec("layers.1.moe.wd",
                            (None, ("data", "model"), None)) == (
        None, ("data", "model"), None)
    assert shd.compute_spec("layers.1.moe.shared.wg", ("data", "model")) \
        == (None, "model")
    assert shd.grad_axes(("data", "model"), ("data", "model")) == ()
    assert shd.grad_axes((None,), ("data", "model")) == ("data", "model")


# ---------------------------------------------------------------------- #
# the 4-rank job
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_holds_to_the_unsharded_step(job, name):
    r = job[name]
    assert r["layout"], f"{name}: the state left its specs' placements"
    assert r["round"] == 1
    assert r["clients"] >= 1
    assert r["grad_rel"] <= TOL, (name, r["grad_worst"], r["grad_rel"])
    assert r["fed_rel"] <= TOL, (name, r["fed_rel"])
    if not CASES[name].get("amplified"):
        assert r["param_rel"] <= TOL, (name, r["worst"], r["param_rel"])
    for k, e in r["metrics_rel"].items():
        assert e <= TOL, (name, k, e)


def test_jax_sharded_adafactor_departs_as_the_port_does(started, job):
    """F3 closed: the JAX package's own sharded Adafactor step departs from
    its unsharded step at fm-a-2x2's config by the same order as the
    port's sharded step from the port's (within 10x either way; measured
    8.1e-6 at ``mamba.conv_b`` against the port's 1.1e-5 at
    ``layers.1.mamba.dt_bias``), while its SGD step stays within the 1e-5
    the port's sharded steps are held to (1.6e-6) and below its Adafactor
    step: the magnification is Adafactor's, in the reference as in the
    port."""
    ref = started["jax_f3"].result()
    port = job["fm-a-2x2"]["param_rel"]
    assert ref["sgd"]["rel"] <= TOL, ref["sgd"]
    assert ref["adafactor"]["rel"] > ref["sgd"]["rel"], ref
    assert 0.1 <= ref["adafactor"]["rel"] / port <= 10, (ref, port)


def test_a_sharded_group_is_gathered_a_leaf_at_a_time(job):
    # falcon-mamba-7b's two MAMBA layers: stacked groups of >= 2-D leaves,
    # sharded on model at (2, 2)
    r = job["fm-a-2x2"]
    assert r["gathered"] >= 2 * r["clients"], r
    assert r["live"] == 0, r


def test_sharded_mode_a_step_holds_to_the_jax_step(started, job):
    cfg, opt, inp = started["cfg"], started["opt"], started["inp"]
    state = inp["state"]
    js = jfl.TrainState(jax.tree.map(jnp.asarray, state["params"]),
                        jax.tree.map(jnp.asarray, state["opt"]),
                        jnp.zeros((), jnp.int32))
    step = jax.jit(jfl.build_train_step(cfg, opt, mode=jfl.MODE_A,
                                        local_steps=JAX_STEPS))
    out, metrics = step(js, jax.tree.map(jnp.asarray, inp["batch"]),
                        jnp.asarray(inp["rep"]), jnp.asarray(inp["stale"]))
    want = named_from_tree(jax.tree.map(np.asarray, out.params),
                           dataclasses.replace(get_smoke_config(
                               "recurrentgemma-2b"), num_layers=3), lead=2)
    assert job["jax"]["layout"]
    with open(os.path.join(started["dir"], "jax_out.pkl"), "rb") as f:
        got = pickle.load(f)
    assert set(got["params"]) == set(want)
    for k in want:
        assert _rel(got["params"][k], want[k]) <= TOL, k
    for k in ("loss", "divergence", "trust_weights"):
        assert _rel(got["metrics"][k], metrics[k]) <= TOL, k


def test_expert_parallel_branch_holds_to_the_jax_package(started, job):
    ref = started["jax_ep"].result()
    assert ref["all_to_all"], "the JAX package's EP branch did not fire"
    with open(os.path.join(started["dir"], "moe_out.pkl"), "rb") as f:
        got = pickle.load(f)
    K = get_smoke_config("deepseek-v2-236b").topk
    Tl = EP_B * EP_S // 2
    for ep_size, ranks in got.items():
        y = np.concatenate([next(r["y"] for r in ranks if r["data"] == d)
                            for d in range(2)])
        assert _rel(y, ref["y"]) <= TOL, ep_size
        for r in ranks:
            d = r["data"]
            assert abs(r["aux"] - ref["aux"]) <= TOL * abs(ref["aux"])
            assert r["cap"] == ref["cap"]
            np.testing.assert_array_equal(
                r["gate_idx"], ref["gate_idx"][d * Tl:(d + 1) * Tl])
            np.testing.assert_array_equal(r["slot"], ref["slot"][d])
            np.testing.assert_array_equal(r["keep"], ref["keep"][d])
    assert K == ref["gate_idx"].shape[1]
