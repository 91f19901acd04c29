"""Training at the plans' bfloat16 (`repro_torch.launch.plans.train_plan`:
parameters in bfloat16 but `F32_LEAVES`), against the JAX package's.

Until this slice every backward kernel of the port took float32 only, so
the port refused the JAX package's planned training at its own dtype.  On
the CPU the wrappers now take bfloat16 through their plain versions
(computing in float32 from upcast inputs, the gradients in the inputs'
types), as the kernels do on the card:

* the loss and every gradient leaf of ``lm_loss`` at bfloat16 parameters,
  through the kernels' wrappers (`torch.autograd.Function` s), against
  ``jax.value_and_grad`` of the JAX package's ``lm_loss`` on the same
  bfloat16 parameters: recurrentgemma-2b's smoke widths cut to one Griffin
  period (mode A's model; attention and the RG-LRU) and falcon-mamba-7b's
  smoke config (the selective scan);
* the training plan's step at bfloat16 (`train_plan` at a smoke config on
  a one-rank mesh) runs and its loss is the JAX package's ``lm_loss`` of
  the same parameters and batch;
* the plain backwards at bfloat16 are the float32 ones of the upcast
  inputs, rounded once.

Tolerances.  The loss within 1e-2 relative (measured 2.5e-5 and
2.7e-6).  Each gradient leaf is held to the JAX package's own bfloat16
spread at that leaf: ``theirs``, the distance of the JAX package's
bfloat16 gradient from its float32 gradient of the same parameters,
against the float32 gradient's largest entry, floored at 2**-8 (one
bfloat16 rounding).  The port's bfloat16 gradient must lie within twice
that spread of the JAX package's float32 gradient, and within twice it of
the JAX package's bfloat16 gradient, leaf by leaf.  At these smoke widths
``theirs`` reads 1.06e-2 to 3.7e-2 (recurrentgemma) and 1.84e-2 to
9.9e-2 (falcon-mamba); the port's distance from the float32 gradient is
at most 1.39 ``theirs`` (falcon-mamba's ``layers.1.mamba.A_log``, 5.8e-2
against 4.2e-2; recurrentgemma's worst 1.38 at ``layers.0.rglru.b_i``),
its distance from the bfloat16 gradient at most 1.52 (recurrentgemma's
``final_norm``, 1.62e-2 against 1.06e-2; falcon-mamba's worst 1.25 at
``layers.1.ln1``).  Two bfloat16 gradients differ by up to the sum of
their spreads: the port's kernels keep float32 inside where the jnp
layers round each product to bfloat16.
recurrentgemma runs 72 tokens, past its window of 64.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import (flash_attention_bwd, rglru_scan_bwd,  # noqa
                                 selective_scan_bwd)
from repro_torch.launch.plans import F32_LEAVES  # noqa: E402
from repro_torch.models import lm_loss  # noqa: E402
from repro_torch.models.transformer import LM, named_from_tree  # noqa: E402

try:            # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import init_params, lm_loss as jax_lm_loss
except ImportError:
    jax = None

LOSS_TOL = 1e-2
SPREAD = 2.0           # times the JAX package's own bfloat16 spread
SPREAD_FLOOR = 2.0 ** -8


def _rg3(get):
    return dataclasses.replace(get("recurrentgemma-2b"), num_layers=3)


CASES = {"recurrentgemma-2b-3": (_rg3, 72), "falcon-mamba-7b": (None, 24)}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One jitted JAX value_and_grad of lm_loss at bfloat16 parameters."""
    if jax is None:
        pytest.skip("the JAX package is not installed")
    cut, seq = CASES[request.param]
    get = (lambda g: cut(g)) if cut else (lambda g: g(request.param))
    jcfg, tcfg = get(jax_smoke_config), get(get_smoke_config)
    params = init_params(jax.random.PRNGKey(2), jcfg, jnp.bfloat16)
    g = np.random.default_rng(7)
    toks = g.integers(0, jcfg.vocab_size, (2, seq + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm_loss(p, jcfg, b, remat=True)))
    jb = jax.tree.map(jnp.asarray, batch)
    loss, grads = value_and_grad(params, jb)
    grads32 = value_and_grad(jax.tree.map(
        lambda x: x.astype(jnp.float32), params), jb)[1]
    names = named_from_tree(jax.tree.map(np.asarray, params), tcfg)
    dtypes = {k: str(v.dtype) for k, v in names.items()}
    named = lambda tree: {k: _f32(v) for k, v in named_from_tree(
        jax.tree.map(np.asarray, tree), tcfg).items()}
    return {"cfg": tcfg, "jcfg": jcfg, "batch": batch, "loss": float(loss),
            "params": {k: _f32(v) for k, v in names.items()},
            "dtypes": dtypes, "grads": named(grads),
            "grads32": named(grads32)}


def _torch_params(case, requires_grad=False):
    """The JAX package's parameters in the port's names and dtypes:
    bfloat16 but the float32 leaves (bfloat16 -> float32 -> bfloat16 is
    exact)."""
    out = {}
    for k, v in case["params"].items():
        t = torch.from_numpy(v.copy())
        if case["dtypes"][k] == "bfloat16":
            t = t.to(torch.bfloat16)
        out[k] = t.requires_grad_(requires_grad)
    return out


def test_the_plans_keep_the_jax_packages_float32_leaves(case):
    for k, dt in case["dtypes"].items():
        want = "float32" if k.rsplit(".", 1)[-1] in F32_LEAVES else "bfloat16"
        assert dt == want, (k, dt)


def test_bf16_loss_and_gradients_match_the_jax_package(case):
    params = _torch_params(case, requires_grad=True)
    model = LM(case["cfg"], device="meta", seed=None)
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in case["batch"].items()}
    loss = lm_loss(model, batch, params=params, remat=True)
    assert abs(float(loss.detach()) - case["loss"]) <= \
        LOSS_TOL * abs(case["loss"])
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names])
    for k, g in zip(names, grads):
        assert g.dtype == params[k].dtype, (k, g.dtype)
        g = g.float().numpy()
        theirs = _rel(case["grads"][k], case["grads32"][k])
        bound = SPREAD * max(theirs, SPREAD_FLOOR)
        ours = _rel(g, case["grads32"][k])
        assert ours <= bound, (k, "from float32", ours, theirs)
        ours = _rel(g, case["grads"][k])
        assert ours <= bound, (k, "from bfloat16", ours, theirs)


def test_the_bf16_training_plan_steps_on_the_jax_packages_loss(case):
    """`train_plan` at a smoke config, bfloat16, on a one-rank mesh: one
    client, one microbatch of the case's batch; its loss is the JAX
    package's ``lm_loss`` of the same bfloat16 parameters."""
    from repro_torch.core import fl_step as fl
    from repro_torch.core import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.plans import train_plan
    mesh = make_host_mesh(1, 1, device="cpu")
    arch = "recurrentgemma-2b" if case["cfg"].lru_width else \
        "falcon-mamba-7b"
    S = case["batch"]["tokens"].shape[1]
    plan = train_plan(arch, "train_4k", mesh, cfg=case["cfg"], seq=S,
                      global_batch=2, device="cpu")
    state, batch, rep, stale = plan.args
    lead = tuple(state.params["embed"].shape[:-2])
    mine = _torch_params(case)
    state = fl.TrainState(
        {k: mine[k].expand(lead + tuple(v.shape[len(lead):])).clone()
         for k, v in state.params.items()}, state.opt, state.round)
    toks = torch.from_numpy(case["batch"]["tokens"].astype(np.int64))
    labs = torch.from_numpy(case["batch"]["labels"].astype(np.int64))
    shape = batch["tokens"].shape
    batch = {"tokens": toks.reshape(shape).to(batch["tokens"].dtype),
             "labels": labs.reshape(shape).to(batch["labels"].dtype)}
    plan = dataclasses.replace(plan, args=(state, batch, rep, stale))
    args = dryrun.placed_args(plan, mesh)
    out, m = plan.step_fn(*args)
    got = float(np.asarray(m["loss"]).reshape(-1)[0])
    assert abs(got - case["loss"]) <= LOSS_TOL * abs(case["loss"])
    changed = shd.full_state(out).params
    assert all(changed[k].dtype == state.params[k].dtype for k in changed)


# --------------------------------------------------------------------- #
# the plain backwards at bfloat16
# --------------------------------------------------------------------- #
def test_plain_backwards_at_bf16_are_the_float32_ones_rounded():
    g = torch.Generator().manual_seed(3)
    bf = lambda *s: torch.randn(*s, generator=g).to(torch.bfloat16)
    q, k, v = bf(1, 40, 4, 16), bf(1, 40, 2, 16), bf(1, 40, 2, 16)
    out, lse = ref.flash_attention_lse_ref(q, k, v, window=16)
    do = bf(1, 40, 4, 16)
    got = flash_attention_bwd(q, k, v, out, lse, do, window=16)
    want = ref.flash_attention_bwd_ref(*(t.float() for t in (q, k, v, out)),
                                       lse, do.float(), window=16)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))
    a = torch.rand(2, 30, 8, generator=g).to(torch.bfloat16)
    hs, dhs = bf(2, 30, 8), bf(2, 30, 8)
    dh = torch.randn(2, 8, generator=g)
    got = rglru_scan_bwd(a, hs, dhs, dh)
    want = ref.rglru_scan_bwd_ref(a.float(), hs.float(), dhs.float(), dh)
    for x, y in zip(got, want):
        assert x.dtype == torch.bfloat16
        assert torch.equal(x, y.to(torch.bfloat16))
    xc, dt, dy = bf(1, 20, 6), bf(1, 20, 6).abs() * 0.1, bf(1, 20, 6)
    Bc, Cc = bf(1, 20, 4), bf(1, 20, 4)
    A = -torch.rand(6, 4, generator=g)
    got = selective_scan_bwd(xc, dt, Bc, Cc, A, dy)
    want = ref.selective_scan_bwd_ref(*(t.float() for t in (xc, dt, Bc, Cc)),
                                      A, dy.float())
    for x, y, t in zip(got, want, (xc, dt, Bc, Cc, A)):
        assert x.dtype == t.dtype
        assert torch.equal(x, y.to(t.dtype))
