"""The port's launch tools: `repro_torch.launch.op_stats`, `dryrun`,
`profile`, the H100 figures of `repro_torch.launch.mesh`, and the kernel
wrappers' meta routes and cost functions.

Three subprocesses start with the module's first test and run while the
in-process tests do:

* the port's estimates on fake process groups (4 ranks, then 256, then
  512): gemma-2b's smoke config at ('data', 'model') = (2, 2), once at a
  small batch (the plan a real job runs below) and once at ``train_4k``'s
  own shape (the plan the JAX package compiles below); then every shape of
  gemma-2b, recurrentgemma-2b and falcon-mamba-7b at full width, cut to
  one period of their block patterns, on the fake 16x16 and 2x16x16
  meshes, under a dispatch mode that fails on any read back to the host;
* a 4-rank gloo job that runs the small plan for real on the CPU under the
  same counter: its operations and collective bytes equal the fake mesh's
  estimate exactly, its peak within 10 %;
* the JAX package's own dry run of the same ``train_4k`` plan at smoke
  config on a (2, 2) mesh of 4 forced host devices: per-device argument
  bytes equal (up to two documented layout differences), and operations
  within 2 % once each side's attention term is taken out by its stated
  formula.
"""
import concurrent.futures
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)

from repro_torch.kernels import (flash_attention, launches,  # noqa: E402
                                 reset_launches, rglru_scan, selective_scan)
# the wrapper modules (the package exports the functions of their names)
fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
rg_mod = importlib.import_module("repro_torch.kernels.rglru_scan")
ss_mod = importlib.import_module("repro_torch.kernels.selective_scan")
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.launch.op_stats import OpStats  # noqa: E402
from repro_torch.launch.distributed import spawn_local  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TIMEOUT = 300
SMALL = dict(seq=64, global_batch=8)      # the plan the gloo job runs
SWEEP_ARCHS = {"gemma-2b": 2, "recurrentgemma-2b": 3, "falcon-mamba-7b": 2}
PEAK_TOL = 0.10
FLOP_TOL = 0.02

FAKE = r"""
import json, sys, dataclasses
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.distributed import device_mesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.plans import SHAPES, applicable, make_plan
from repro_torch.models.transformer import layer_groups
small, sweep = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {}


class NoHostRead(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default,
                    torch.ops.aten.item.default):
            raise RuntimeError(f"a read back to the host: {func}")
        return func(*args, **(kwargs or {}))


def stats_of(st, n_arg):
    return {"flops": st.flops, "matmul": st.matmul_flops,
            "kernel": dict(st.kernel_flops), "arg": n_arg,
            "peak": st.peak_bytes, "peak_by": st.summary()["peak"],
            "coll": {k: v["bytes"] for k, v in st.collectives.items()}}


dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = device_mesh((2, 2), ("data", "model"), "cpu")
cfg = get_smoke_config("gemma-2b")
plan = make_plan("gemma-2b", "train_4k", mesh, cfg=cfg, **small)
out["small"] = stats_of(*dryrun.estimate(plan, mesh))
plan = make_plan("gemma-2b", "train_4k", mesh, cfg=cfg)
st, n_arg = dryrun.estimate(plan, mesh)
out["full"] = stats_of(st, n_arg)
state, batch = dryrun.placed_args(plan, mesh)[:2]
# F1's layout: each leaf of a stacked group of 1-D leaves keeps the group's
# column, where the JAX package's stacked leaf keeps one
dup = 0
for grp in layer_groups(cfg, state.params):
    if state.params[grp[0]].dim() - 2 == 1 and len(grp) > 1:
        c = state.opt["acc"][grp[0]]["c"].to_local()
        dup += (len(grp) - 1) * c.numel() * c.element_size()
tok = batch["tokens"].to_local()             # (NC, C_rank, n_micro, bm, S)
out["full"].update(dup_columns=dup, clients=tok.shape[0] * tok.shape[1],
                   n_micro=tok.shape[2], bm=tok.shape[3], S=tok.shape[4],
                   L=cfg.num_layers, H=cfg.num_heads, d=cfg.head_dim)
dist.destroy_process_group()
out["sweep"] = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi, fake=True)
    tag = "2x16x16" if multi else "16x16"
    for arch, layers in sweep.items():
        cut = dataclasses.replace(get_config(arch), num_layers=layers)
        for shape in SHAPES:
            skip = applicable(arch, shape)
            if skip:
                out["sweep"][f"{arch}/{shape}@{tag}"] = skip
                continue
            try:
                with NoHostRead():
                    dryrun.estimate(make_plan(arch, shape, mesh, cfg=cut),
                                    mesh)
                out["sweep"][f"{arch}/{shape}@{tag}"] = "ok"
            except Exception as e:      # noqa: BLE001 -- reported below
                out["sweep"][f"{arch}/{shape}@{tag}"] = repr(e)[:500]
    dist.destroy_process_group()
print("FAKE" + json.dumps(out))
"""

GLOO = r"""
import json, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.launch.distributed import initialize_from_env
initialize_from_env("cpu")
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.plans import make_plan
small = json.loads(sys.argv[1])
mesh = make_host_mesh(2, 2, device="cpu")
plan = make_plan("gemma-2b", "train_4k", mesh,
                 cfg=get_smoke_config("gemma-2b"), device="cpu", **small)
st, n_arg = dryrun.estimate(plan, mesh)
if dist.get_rank() == 0:
    print("GLOO" + json.dumps({
        "flops": st.flops, "arg": n_arg, "peak": st.peak_bytes,
        "coll": {k: v["bytes"] for k, v in st.collectives.items()}}))
dist.destroy_process_group()
"""

JAX = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.configs import get_smoke_config
from repro.launch import plans
from repro.launch.hlo_stats import analyze_module
plans.get_config = get_smoke_config        # the plan at smoke config
mesh = jax.make_mesh((2, 2), ("data", "model"))
plan = plans.make_plan("gemma-2b", "train_4k", mesh)
with mesh:
    c = jax.jit(plan.step_fn, in_shardings=plan.in_shardings,
                out_shardings=plan.out_shardings,
                donate_argnums=plan.donate).lower(*plan.args).compile()
print("JAX" + json.dumps({"arg": c.memory_analysis().argument_size_in_bytes,
                          "flops": analyze_module(c.as_text()).flops}))
"""


def _env(**kw):
    return dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", **kw)


def _run(code, tag, *args, **env):
    r = subprocess.run([sys.executable, "-c", code, *args], env=_env(**env),
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.split(tag, 1)[1])


def _gloo():
    out = spawn_local(["-c", GLOO, json.dumps(SMALL)], n_procs=4,
                      timeout=TIMEOUT, env=_env())
    for o in out:
        assert o.returncode == 0, o.stderr[-4000:]
    return json.loads(out[0].stdout.split("GLOO", 1)[1])


@pytest.fixture(scope="module", autouse=True)
def started():
    pool = concurrent.futures.ThreadPoolExecutor(3)
    try:
        import jax  # noqa: F401
        jax_job = pool.submit(_run, JAX, "JAX", JAX_PLATFORMS="cpu")
    except ImportError:         # the card's machine has no JAX
        jax_job = None
    yield {"fake": pool.submit(_run, FAKE, "FAKE", json.dumps(SMALL),
                               json.dumps(SWEEP_ARCHS)),
           "gloo": pool.submit(_gloo), "jax": jax_job}
    pool.shutdown(wait=True)


# ---------------------------------------------------------------------- #
# the dry run against a real job and against the JAX package
# ---------------------------------------------------------------------- #
def test_the_estimate_is_what_a_real_gloo_job_counts(started):
    est = started["fake"].result()["small"]
    real = started["gloo"].result()
    assert est["flops"] == real["flops"] > 0
    assert est["coll"] == real["coll"] and sum(real["coll"].values()) > 0
    assert est["arg"] == real["arg"]
    assert abs(est["peak"] - real["peak"]) <= PEAK_TOL * real["peak"], (
        est["peak"], real["peak"])


def test_the_estimate_holds_to_the_jax_packages_dry_run(started):
    """Per-device argument bytes equal once the two layouts' known
    differences are counted: the port keeps a stacked 1-D group's column
    in each of its leaves (F1's layout; the JAX stack one), and the JAX
    state's round counter is a 4-byte device scalar (a Python int in the
    port).  Operations within 2 % once each side's attention term is taken
    out: the port's is what its kernels report (the reachable causal
    pairs); the JAX package's ``_sdpa`` builds the whole S x S score matrix
    of each query chunk (``q_chunk`` 1024 at 4096 tokens) and multiplies
    it nine times an attention layer and microbatch: QK and PV in the
    forward, both again in the layer's recompute, QK in the query chunk's
    own recompute (its output unused), and dQ, dK, dV, dP in the
    backward, each 2 bm H_rank S^2 d operations."""
    if started["jax"] is None:
        pytest.skip("the JAX package is not installed")
    j = started["jax"].result()
    p = started["fake"].result()["full"]
    assert p["arg"] - p["dup_columns"] + 4 == j["arg"], (p, j)
    heads = p["H"] // 2                              # model axis of 2
    jax_attn = 9 * 2 * p["bm"] * heads * p["S"] ** 2 * p["d"] * \
        p["n_micro"] * p["L"] * p["clients"]
    rest = j["flops"] - jax_attn
    assert abs(p["matmul"] - rest) <= FLOP_TOL * rest, (p["matmul"], rest)
    assert p["flops"] == p["matmul"] + sum(p["kernel"].values())


@pytest.mark.parametrize("arch", sorted(SWEEP_ARCHS))
def test_every_shape_traces_on_the_production_meshes(started, arch):
    """Every shape of the architecture, on 256 and 512 fake ranks, ends
    ``ok`` or with the JAX package's own skip, and decode reads nothing
    back to the host (a dispatch mode that fails on any read)."""
    from repro_torch.launch.plans import LONG_SKIP_REASON, SHAPES
    sweep = started["fake"].result()["sweep"]
    for tag in ("16x16", "2x16x16"):
        for shape in SHAPES:
            got = sweep[f"{arch}/{shape}@{tag}"]
            assert got in ("ok", LONG_SKIP_REASON), (arch, shape, tag, got)


def test_the_jax_packages_skips_are_the_ports():
    from repro.launch.plans import applicable as japplicable
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.plans import SHAPES, applicable
    for arch in ARCH_IDS:
        for shape in SHAPES:
            assert applicable(arch, shape) == japplicable(arch, shape)


# ---------------------------------------------------------------------- #
# in process: decode with no host read, the meta routes, the counter
# ---------------------------------------------------------------------- #
class _NoHostRead(torch.utils._python_dispatch.TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default,
                    torch.ops.aten.item.default):
            raise AssertionError(f"a read back to the host: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-2b",
                                  "deepseek-v2-236b", "musicgen-large"])
def test_decode_reads_no_step_back_to_the_host(arch):
    """F6: a decode step given its position on the device writes the ring
    cache's slot there (the MoE's counts too): no read back, and the same
    logits and cache as the step given a Python int."""
    import copy
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import LM
    cfg = get_smoke_config(arch)
    lm = LM(cfg, seed=0)
    shape = (2, cfg.num_codebooks, 20) if cfg.num_codebooks > 1 else (2, 20)
    toks = torch.randint(0, cfg.vocab_size, shape,
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        _, cache = lm.prefill(toks, cache_len=16)   # a ring past its width
        other = copy.deepcopy(cache)
        tok = toks[..., -1]
        for i in range(3):
            want, _ = lm.decode_step(cache, tok, 20 + i)
            with _NoHostRead():
                got, _ = lm.decode_step(other, tok, torch.tensor(20 + i))
            assert torch.equal(got, want)
        for a, b in zip(cache, other):
            for k in a:
                assert torch.equal(a[k], b[k]), k


def test_meta_routes_give_the_kernels_shapes_and_launch_nothing():
    meta = dict(device="meta")
    reset_launches()
    q = torch.empty(2, 40, 4, 32, dtype=torch.bfloat16, **meta)
    k = torch.empty(2, 40, 2, 32, dtype=torch.bfloat16, **meta)
    v = torch.empty(2, 40, 2, 16, dtype=torch.bfloat16, **meta)
    out, lse = fa_mod._forward(q, k, v, 8, 0.0, with_lse=True)
    assert out.shape == (2, 40, 4, 16) and out.dtype == torch.bfloat16
    assert lse.shape == (2, 4, 40) and lse.dtype == torch.float32
    dq, dk, dv = fa_mod.flash_attention_bwd(q, k, v, out, lse, out)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    a = torch.empty(2, 40, 8, **meta)
    hs, h = rglru_scan(a, a)
    assert hs.shape == a.shape and h.shape == (2, 8)
    xc = torch.empty(1, 40, 8, dtype=torch.bfloat16, **meta)
    Bc = torch.empty(1, 40, 4, dtype=torch.bfloat16, **meta)
    A = torch.empty(8, 4, **meta)
    y, hl, ch = ss_mod._forward(xc, xc, Bc, Bc, A, states=True)
    assert y.dtype == torch.bfloat16 and hl.shape == (1, 8, 4)
    assert ch.shape == (2, 1, 4, 8) and ch.dtype == torch.float32
    grads = ss_mod.selective_scan_bwd(xc, xc, Bc, Bc, A, xc)
    assert [g.shape for g in grads] == [t.shape for t in (xc, xc, Bc, Bc, A)]
    assert not any(launches.values())
    assert flash_attention(q, k, v).device.type == "meta"
    assert selective_scan(xc, xc, Bc, Bc, A)[0].device.type == "meta"


@pytest.mark.parametrize("S,window", [(40, 0), (40, 8), (40, 40), (1, 3)])
def test_the_attention_cost_counts_the_reachable_pairs(S, window):
    pos = np.arange(S)
    keep = pos[None, :] <= pos[:, None]
    if window > 0:
        keep &= pos[None, :] > pos[:, None] - window
    assert fa_mod.reachable_pairs(S, window) == int(keep.sum())
    B, H, Kv, d, dv = 2, 4, 2, 32, 16
    flops, n_bytes = fa_mod.forward_cost(B, S, H, Kv, d, dv, window, 2,
                                         lse=True)
    assert flops == B * H * int(keep.sum()) * 2 * (d + dv)
    assert n_bytes == 2 * B * S * (H * d + Kv * (d + dv) + H * dv) + \
        4 * B * H * S
    bflops, _ = fa_mod.backward_cost(B, S, H, Kv, d, dv, window)
    assert bflops == B * H * int(keep.sum()) * 2 * (3 * d + 2 * dv)


def test_the_counter_reports_kernels_and_not_their_plain_versions():
    """On the CPU a kernel's plain version runs inside its report: the
    counter takes the wrapper's operations and bytes, not the plain
    version's products, and its outputs count as live storages."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 24, 2, 16, generator=g)
    a = torch.rand(1, 24, 8, generator=g)
    w = torch.randn(16, 8, generator=g)
    with OpStats() as st:
        out = flash_attention(q, q, q)
        rglru_scan(a, a)
        y = out.reshape(24, 32) @ torch.randn(32, 8, generator=g)
    assert st.kernel_calls == {"flash_attention": 1, "rglru_scan": 1}
    assert st.kernel_flops["flash_attention"] == \
        fa_mod.forward_cost(1, 24, 2, 2, 16, 16)[0]
    assert st.kernel_flops["rglru_scan"] == rg_mod.forward_cost(1, 24, 8)[0]
    assert st.matmul_flops == 2 * 24 * 32 * 8
    assert st.traffic["kernel:flash_attention"] == \
        fa_mod.forward_cost(1, 24, 2, 2, 16, 16)[1]
    assert st.peak_bytes >= out.numel() * 4 + y.numel() * 4
    del w


def test_the_h100_figures_and_link_rates():
    assert lmesh.CARD == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert lmesh.peak_flops_bf16() == 989e12
    assert lmesh.hbm_bytes_per_s() == 3.35e12
    assert lmesh.link_bytes_per_s(range(8)) == 450e9       # one node
    assert lmesh.link_bytes_per_s(range(0, 16)) == 50e9    # two nodes
    assert lmesh.link_bytes_per_s([3, 11]) == 50e9


def test_the_new_modules_import_no_jax():
    code = ("import sys\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.profile\n"
            "import repro_torch.launch.op_stats\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_the_dryrun_cli_writes_one_record_a_plan(tmp_path):
    """The CLI on the fake 16x16 mesh at full width: one JSONL record, the
    JAX record's keys where the quantity is the same."""
    out = tmp_path / "d.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "falcon-mamba-7b", "--shape", "decode_32k", "--out", str(out)],
        env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    for key in ("arch", "shape", "kind", "chips", "bytes_per_device",
                "collectives", "op_hist", "t_compute", "t_memory",
                "t_collective", "flops_per_dev", "bytes_per_dev",
                "peak_bytes_per_device", "device"):
        assert key in rec, key
    assert rec["chips"] == 256 and rec["device"] == lmesh.CARD
    assert {"argument", "total"} <= set(rec["bytes_per_device"])
    assert rec["kernel_flops_per_dev"] == {}     # decode runs no kernel


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_a_materialized_plan_runs_and_counts_as_its_estimate(shape):
    """`plans.materialize` makes a plan's arguments real (the model drawn
    from the seed, an empty cache, drawn tokens) and the step runs on them
    at mesh (1, 1), its operations as the meta estimate counts them (the
    profile's ``--device`` run, on the CPU at a smoke config; a prefill of
    32 x 32768 tokens through the plain attention is out of a CPU's
    reach)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun, plans
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 1, device="cpu")
    cfg = get_smoke_config("gemma-2b")
    kw = dict(seq=32, global_batch=2) if shape == "train_4k" else {}
    if shape != "train_4k":       # a serving shape's batch and cache, cut
        cfg = dataclasses.replace(cfg, num_layers=1)
    plan = plans.make_plan("gemma-2b", shape, mesh, cfg=cfg, **kw)
    if shape != "train_4k":
        plan.options["build"]["cfg"] = cfg
    est, _ = dryrun.estimate(plan, mesh)
    real = plans.materialize(plan, "cpu", seed=0)
    assert all(t.device.type == "cpu" for t in torch.utils._pytree.tree_flatten(
        [a._asdict() if hasattr(a, "_asdict") else a
         for a in real.args])[0] if isinstance(t, torch.Tensor))
    counted = dryrun.trace(real, dryrun.placed_args(real, mesh))
    assert counted.flops == est.flops > 0
