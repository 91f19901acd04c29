"""Sharded serving of the port (`repro_torch.core.fl_step.build_prefill_step`
and ``build_serve_step`` on placed parameters and caches, the serving
plans' layouts).

* One ``spawn_local`` job of 4 gloo ranks on the CPU, started with the
  file's first test so it overlaps the in-process ones: smoke configs at
  meshes (1, 4), (2, 2) and (4, 1), one case a cache layout and mesh --
  K/V heads on ``model`` (gemma-7b), their slots where the heads do not
  split (granite-3-8b, 2 K/V heads over 4), MLA's latent slots in the
  absorbed and the expanded decode (deepseek-v2-236b), the recurrent
  states' channels (recurrentgemma-2b, falcon-mamba-7b), one K/V head
  whole on every rank with the query heads computed whole in decode
  (gemma-2b), and FSDP'd dense weights with the MoE routed over the
  call's whole batch (grok-1-314b).  Each case: a prefill, then 4 decode
  steps fed the unsharded run's greedy tokens, against the unsharded
  `LM.prefill` / `decode_step` on the same seeded weights (each decode
  step's on the sharded run's cache before it, gathered: `sharded`): the
  logits within 1e-5 of the largest logit, the prefill's cache gathered
  within one bfloat16 rounding of each leaf's largest entry (the float32
  states within 1e-5 of it), every cache leaf at its `cache_specs`
  placements, the same logits on every rank.
* One case a layout also held to the JAX package's own ``prefill`` /
  ``decode_step`` on the same weights (the tolerances of
  ``tests/test_torch_lm_arch.py``).
* In process: mesh (1, 1) is the unsharded call bit for bit; a
  context-parallel cache whose slots the axis does not divide is refused.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import pickle
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import fl_step as tfl  # noqa: E402
from repro_torch.core import sharding as shd  # noqa: E402
from repro_torch.launch import plans  # noqa: E402
from repro_torch.launch.distributed import spawn_local  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import LM, params_to_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TOL = 1e-5                     # of the largest logit / state entry
BF16_ROUNDING = 2.0 ** -8      # of a bfloat16 leaf's largest entry
JOB_TIMEOUT = 240              # seconds, the 4-rank job
B, S, STEPS = 4, 12, 4         # batch, prompt, decode steps
CACHE_LEN = S + STEPS          # 16: the 4 ranks split its slots

# name -> (arch, mesh, config changes); JAX: the case is also held to
# the JAX package's serving
CASES = {
    "kv-heads-1x4": ("gemma-7b", [1, 4], {}),
    "kv-slots-1x4": ("granite-3-8b", [1, 4], {}),
    "mla-absorbed-1x4": ("deepseek-v2-236b", [1, 4], {}),
    "mla-expanded-1x4": ("deepseek-v2-236b", [1, 4],
                         {"mla_absorbed": False}),
    "rglru-1x4": ("recurrentgemma-2b", [1, 4], {}),
    "mamba-1x4": ("falcon-mamba-7b", [1, 4], {}),
    "mqa-1x4": ("gemma-2b", [1, 4], {}),
    "moe-fsdp-2x2": ("grok-1-314b", [2, 2], {}),
    "kv-heads-2x2": ("granite-3-8b", [2, 2], {}),
    "mla-absorbed-2x2": ("deepseek-v2-236b", [2, 2], {}),
    "rglru-2x2": ("recurrentgemma-2b", [2, 2], {}),
    "moe-fsdp-4x1": ("grok-1-314b", [4, 1], {}),
    "mamba-4x1": ("falcon-mamba-7b", [4, 1], {}),
    "kv-heads-4x1": ("gemma-7b", [4, 1], {}),
}
JAX_CASES = ("kv-heads-1x4", "kv-slots-1x4", "mla-absorbed-1x4",
             "mla-expanded-1x4", "rglru-1x4", "mamba-1x4", "mqa-1x4",
             "moe-fsdp-2x2")


def case_cfg(arch, changes):
    return dataclasses.replace(get_smoke_config(arch), **changes)


def seeded(cfg):
    """The case's weights and prompt, from the seed."""
    model = LM(cfg, device="cpu", seed=3)
    shape = (B, cfg.num_codebooks, S) if cfg.num_codebooks > 1 else (B, S)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, shape, generator=g)
    return model, tokens


def unsharded(cfg):
    """The unsharded prefill and decode: the last logits of each call,
    the greedy tokens fed to the next, the prefill's cache (a copy) and
    the final cache."""
    model, tokens = seeded(cfg)
    with torch.no_grad():
        logits, cache = model.prefill(tokens, CACHE_LEN)
        first = [{k: t.clone() for k, t in c.items()} for c in cache]
        out, fed = [logits], []
        for i in range(STEPS):
            tok = out[-1].argmax(-1)
            fed.append(tok)
            logits, cache = model.decode_step(cache, tok, S + i)
            out.append(logits)
    return model, tokens, out, fed, first, cache


def sharded(cfg, mesh, model, tokens, fed):
    """The same calls through the serving steps on ``mesh`` -> (their
    logits, the reference logits of each call, the prefill's cache and
    the final cache gathered whole, whether every cache leaf sat at its
    `cache_specs` placements).  A decode step's reference is the
    unsharded `LM.decode_step` on the sharded run's cache before it
    (gathered): the K/V cache is bfloat16, and a sharded projection may
    round an entry to the neighbouring bfloat16 value, which the next
    steps read; the prefill's reference is the unsharded prefill."""
    from repro_torch.launch.mesh import axis_size
    from repro_torch.models.transformer import cache_specs
    params = {k: p.detach() for k, p in model.named_parameters()}
    _, pspecs = plans._serve_param_specs(cfg, axis_size(mesh, "model"),
                                         params)
    layout = tfl.cache_layout(cfg, B, axis_size(mesh, "data"),
                              axis_size(mesh, "model"))
    bax = layout["batch_axis"]
    placed = shd.distribute_tree(params, pspecs, mesh)
    put = lambda t: shd.distribute(      # noqa: E731
        t, (bax,) + (None,) * (t.dim() - 1), mesh)
    logits, cache = tfl.build_prefill_step(cfg, CACHE_LEN)(placed,
                                                           put(tokens))
    specs = cache_specs([dict(c) for c in cache], **layout)
    at_specs = all(tuple(t.placements) == shd.placements(s, mesh)
                   for c, cs in zip(cache, specs) for t, s in
                   zip(c.values(), cs.values()))
    with torch.no_grad():
        ref = [model.prefill(tokens, CACHE_LEN)[0]]
    whole = lambda c: shd.map_tree(          # noqa: E731
        lambda t: t.clone(), shd.full_tree(c))   # copies: steps write
    out, first = [logits], whole(cache)
    step = tfl.build_serve_step(cfg)
    for i, tok in enumerate(fed):
        before = whole(cache)
        with torch.no_grad():
            ref.append(model.decode_step(before, tok, S + i)[0])
        logits, cache = step(placed, cache, put(tok), S + i)
        out.append(logits)
    return out, ref, first, shd.full_tree(cache), at_specs


def compare(out, ref, caches, want_caches):
    """-> (worst logit error / largest logit, worst bfloat16 cache leaf's
    error / (2^-8 of its largest entry), worst float32 state error /
    largest entry, whether the positions agree)."""
    lg = max(float((a - b).abs().max() / b.abs().max())
             for a, b in zip(out, ref))
    bf, state, pos = 0.0, 0.0, True
    for cache, want in zip(caches, want_caches):
        for c, w in zip(cache, want):
            for k, t in c.items():
                t, u = t.detach().float(), w[k].detach()
                big = u.float().abs().max().clamp(min=1e-30)
                if k == "pos":
                    pos &= bool(torch.equal(t, u.float()))
                elif u.dtype == torch.bfloat16:
                    bf = max(bf, float((t - u.float()).abs().max()
                                       / (big * BF16_ROUNDING)))
                else:
                    state = max(state, float((t - u).abs().max() / big))
    return lg, bf, state, pos


WORKER = r"""
import json, os, pickle, sys
import torch
torch.set_num_threads(1)
job = json.loads(sys.argv[1])
sys.path.insert(0, job["src"]); sys.path.insert(0, job["tests"])
from repro_torch.launch.distributed import initialize_from_env
initialize_from_env("cpu")
import torch.distributed as dist
from repro_torch.launch.mesh import host_mesh_for
import test_torch_serve_sharded as t

res, logits = {}, {}
for name, (arch, mesh_shape, changes) in t.CASES.items():
    cfg = t.case_cfg(arch, changes)
    model, tokens, _, fed, first, _ = t.unsharded(cfg)
    mesh = host_mesh_for(mesh_shape, device="cpu")
    out, ref, got_first, _, at_specs = t.sharded(cfg, mesh, model, tokens,
                                                 fed)
    lg, bf, state, pos = t.compare(out, ref, [got_first], [first])
    res[name] = {"logits": lg, "bf16": bf, "state": state, "pos": pos,
                 "at_specs": at_specs, "same_on_ranks": True}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, [o.numpy() for o in out])
    res[name]["same_on_ranks"] = all(
        all((a == b).all() for a, b in zip(every[0], e)) for e in every)
    logits[name] = [o.numpy() for o in out]
if dist.get_rank() == 0:
    with open(os.path.join(job["dir"], "logits.pkl"), "wb") as f:
        pickle.dump(logits, f)
    print("RESULT" + json.dumps(res), flush=True)
dist.destroy_process_group()
"""


def _run_job(d):
    job = {"src": SRC, "tests": os.path.dirname(os.path.abspath(__file__)),
           "dir": d}
    res = spawn_local(["-c", WORKER, json.dumps(job)], n_procs=4,
                      timeout=JOB_TIMEOUT,
                      env={"OMP_NUM_THREADS": "1", "PYTHONPATH": SRC})
    out = res[0].stdout
    assert "RESULT" in out, (out[-2000:], res[0].stderr[-4000:])
    with open(os.path.join(d, "logits.pkl"), "rb") as f:
        logits = pickle.load(f)
    return json.loads(out.split("RESULT", 1)[1].splitlines()[0]), logits


@pytest.fixture(scope="module")
def started():
    d = tempfile.mkdtemp(prefix="serve_sharded_")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(_run_job, d)
    yield fut
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def job(started):
    return started.result()


@pytest.fixture(autouse=True)
def _start_early(started):
    """Every test asks for the job so it starts with the file's first."""


# ---------------------------------------------------------------------- #
# in process
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "deepseek-v2-236b",
                                  "grok-1-314b"])
def test_mesh_1x1_is_the_unsharded_call_bit_for_bit(arch):
    cfg = case_cfg(arch, {})
    model, tokens, want, fed, want_first, want_cache = unsharded(cfg)
    out, _, first, cache, at_specs = sharded(
        cfg, make_host_mesh(1, 1, device="cpu"), model, tokens, fed)
    assert at_specs
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    for got, wanted in ((first, want_first), (cache, want_cache)):
        for c, w in zip(got, wanted):
            assert c.keys() == w.keys()
            for k in c:
                assert torch.equal(c[k], w[k]), k


def test_a_context_parallel_cache_must_split_whole():
    """A slot dim the axis does not divide is refused with its widths."""
    k = torch.zeros(1, 6, 2, 4)
    with pytest.raises(ValueError, match="6 slots does not split over "
                                         "the 4 ranks"):
        tattn._ring_cache(6, (1, 4), k=k, v=k)
    got = tattn._ring_cache(6, (1, 3), k=k + 1.0, v=k)
    assert got["k"].shape == (1, 2, 2, 4) and got["pos"].shape == (6,)


# ---------------------------------------------------------------------- #
# the 4-rank job
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_holds_to_the_unsharded_call(job, name):
    r = job[0][name]
    assert r["at_specs"], f"{name}: a cache leaf left its specs"
    assert r["same_on_ranks"], f"{name}: the ranks' logits differ"
    assert r["logits"] <= TOL, (name, r["logits"])
    assert r["bf16"] <= 1.0, (name, r["bf16"])
    assert r["state"] <= TOL, (name, r["state"])
    assert r["pos"], name


# ---------------------------------------------------------------------- #
# the JAX package's serving, one case a layout
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_logits():
    """The JAX package's prefill and decode of each JAX case, on the
    port's seeded weights and the unsharded run's greedy tokens."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import transformer as jt
    out = {}
    for name in JAX_CASES:
        arch, _, changes = CASES[name]
        cfg = case_cfg(arch, changes)
        jcfg = dataclasses.replace(jax_smoke(arch), **changes)
        model, tokens, _, fed, _, _ = unsharded(cfg)
        jp = jax.tree.map(jnp.asarray, params_to_numpy(model))
        pre = jax.jit(lambda p, x, c=jcfg: jt.prefill(p, c, x,
                                                      cache_len=CACHE_LEN))
        dec = jax.jit(lambda p, k, x, i, c=jcfg: jt.decode_step(p, k, c, x,
                                                                i))
        logits, cache = pre(jp, jnp.asarray(tokens.numpy()))
        got = [np.asarray(logits)]
        for i, tok in enumerate(fed):
            logits, cache = dec(jp, cache, jnp.asarray(tok.numpy()),
                                jnp.int32(S + i))
            got.append(np.asarray(logits))
        out[name] = got
    return out


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_serving_holds_to_the_jax_package(job, jax_logits, name):
    from test_torch_lm_arch import DECODE_TOL, PREFILL_TOL, close
    got, want = job[1][name], jax_logits[name]
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, PREFILL_TOL if i == 0 else DECODE_TOL)
