"""Gradients of the port's language models against the JAX package's.

The JAX package has no backward kernel: its training differentiates the
jnp layers (``_sdpa`` with ``causal_mask``, the ``lax.scan`` of
``rglru_forward``).  Here, on numpy inputs drawn from seeds:

* the plain backward versions (`repro_torch.kernels.ref`) against
  ``torch.autograd`` of the plain forwards and against ``jax.vjp`` of the
  jnp layers (sliding window, softcap, grouped K/V heads, ragged S);
* the wrappers' `torch.autograd.Function`s on the CPU (the plain backward)
  against the same;
* `lm_loss`'s value and gradient against ``jax.value_and_grad(lm_loss)``
  on carried-over parameters: recurrentgemma-2b's smoke widths cut to one
  Griffin period (3 layers) at seq 96 > window 64, and gemma-2b's smoke
  config (global attention);
  (and falcon-mamba-7b's smoke config, two MAMBA layers);
* `cuda`-marked twins: the backward kernels against the plain versions on
  the card, and `selective_scan`'s gradient through its backward kernel
  there.

Tolerances: the backward formulas against autograd or ``jax.vjp`` of the
same forward, 2e-5 relative to each gradient's largest entry (float32 sums
in another order); the whole model's gradients 1e-4 relative to each
leaf's largest entry and the loss 1e-5 relative (sums over the sequence
and the vocabulary in another order, through three layers); the kernels on
the card against the plain backward, 1e-4 relative (the kernels sum over
keys and queries in tiles, on FMAs).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import (flash_attention, launches,  # noqa: E402
                                 reset_launches, rglru_scan, selective_scan)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import lm_loss, params_from_numpy  # noqa: E402
from repro_torch.models import params_to_numpy  # noqa: E402
from repro_torch.models.rglru import rglru_forward  # noqa: E402

try:            # the card's machine has no JAX: only the cuda tests run
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import init_params, lm_loss as jax_lm_loss
    from repro.models.attention import _sdpa, causal_mask
    from repro.models.rglru import init_rglru
    from repro.models.rglru import rglru_forward as jax_rglru_forward
except ImportError:
    jax = None

FORMULA_TOL = 2e-5


@pytest.fixture(scope="module")
def needs_jax():
    if jax is None:
        pytest.skip("the JAX package is not installed")


def _rel(got, want):
    got = np.asarray(got.detach() if hasattr(got, "detach") else got,
                     np.float64)
    want = np.asarray(want.detach() if hasattr(want, "detach") else want,
                      np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want), initial=0.0)
                 / (np.max(np.abs(want), initial=0.0) + 1e-30))


def _attn_case(B, S, H, Kv, d, dv, seed):
    g = np.random.default_rng(seed)
    q = (g.standard_normal((B, S, H, d)) * 0.5).astype(np.float32)
    k = (g.standard_normal((B, S, Kv, d)) * 0.5).astype(np.float32)
    v = g.standard_normal((B, S, Kv, dv)).astype(np.float32)
    do = g.standard_normal((B, S, H, dv)).astype(np.float32)
    return q, k, v, do


# (B, S, H, Kv, d, dv, window, softcap): a window shorter than S, a cap,
# grouped K/V heads (4 over 2 and 4 over 1), ragged S, dv != d
ATTN_CASES = [(1, 96, 4, 1, 32, 32, 64, 0.0), (2, 77, 4, 2, 16, 24, 0, 0.0),
              (1, 50, 4, 4, 16, 16, 7, 30.0), (1, 45, 6, 2, 8, 8, 0, 5.0)]


@pytest.mark.parametrize("B,S,H,Kv,d,dv,window,softcap", ATTN_CASES)
def test_attention_backward_matches_autograd_and_jax(
        needs_jax, B, S, H, Kv, d, dv, window, softcap):
    q, k, v, do = _attn_case(B, S, H, Kv, d, dv, seed=S + H)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    # autograd of the plain forward
    out = ref.flash_attention_ref(tq, tk, tv, window=window,
                                  softcap=softcap)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    # the plain backward by its formulas
    o, lse = ref.flash_attention_lse_ref(tq.detach(), tk.detach(),
                                         tv.detach(), window=window,
                                         softcap=softcap)
    got = ref.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                      o, lse, torch.from_numpy(do),
                                      window=window, softcap=softcap)
    # the wrapper's autograd.Function on the CPU
    fn = torch.autograd.grad(
        flash_attention(tq, tk, tv, window=window, softcap=softcap),
        (tq, tk, tv), torch.from_numpy(do))
    # jax.vjp of the jnp attention the JAX package trains through
    mask = causal_mask(S, S, window=window)[None, None, None]

    @jax.jit
    def jax_vjp(a, b, c, dout):
        out_, vjp = jax.vjp(
            lambda a_, b_, c_: _sdpa(a_, b_, c_, mask, d ** -0.5, softcap),
            a, b, c)
        return out_, vjp(dout)
    jout, jgrads = jax_vjp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(do))
    assert _rel(o, jout) < FORMULA_TOL
    for name, g_, w_, f_, j_ in zip("qkv", got, want, fn, jgrads):
        assert _rel(g_, w_) < FORMULA_TOL, name
        assert _rel(g_, j_) < FORMULA_TOL, name
        assert _rel(f_, g_) == 0.0, name


def _attention_bwd_with(mm, q, k, v, o, lse, do, window, softcap):
    """The attention backward with its five products (S, dP, dV, dK, dQ)
    taken by ``mm``, D, the softmax rebuilt from lse and dS in f32, and
    dK and dV summed over a group's heads in f32: the numerics of
    ``csrc/flash_attention_bwd.cu``.  -> (dq, dk, dv)."""
    B, S, H, d = q.shape
    Kv, dv = k.shape[2], v.shape[3]
    g = H // Kv
    qg = q.reshape(B, S, Kv, g, d).permute(0, 2, 3, 1, 4)    # (B,Kv,g,S,d)
    dog = do.reshape(B, S, Kv, g, dv).permute(0, 2, 3, 1, 4)
    kk = k.permute(0, 2, 1, 3)[:, :, None]                    # (B,Kv,1,S,d)
    vv = v.permute(0, 2, 1, 3)[:, :, None]
    s = mm(qg, kk.transpose(-1, -2)) * d ** -0.5
    th = None
    if softcap > 0:
        th = torch.tanh(s / softcap)
        s = th * softcap
    pos = torch.arange(S)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    p = torch.where(mask, torch.exp(s - lse.reshape(B, Kv, g, S, 1)), 0.0)
    delta = (do * o).sum(-1).reshape(B, S, Kv, g).permute(0, 2, 3, 1)
    ds = p * (mm(dog, vv.transpose(-1, -2)) - delta[..., None])
    if th is not None:
        ds = ds * (1.0 - th * th)
    dq = mm(ds, kk) * d ** -0.5
    dk = mm(ds.transpose(-1, -2), qg).sum(2) * d ** -0.5       # (B,Kv,S,d)
    dvv = mm(p.transpose(-1, -2), dog).sum(2)
    return (dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, d),
            dk.permute(0, 2, 1, 3), dvv.permute(0, 2, 1, 3))


@pytest.mark.parametrize("B,S,H,Kv,d,dv,window,softcap,peak", [
    c + (1.0,) for c in ATTN_CASES] + [(1, 64, 4, 1, 32, 32, 0, 0.0, 16.0)])
def test_backward_3xtf32_split_meets_the_tolerance(B, S, H, Kv, d, dv,
                                                   window, softcap, peak):
    """The backward kernel's five products on the TF32 tensor cores,
    emulated: with the 3xTF32 split every gradient stays within 1e-4 of
    its largest entry of the plain backward (the card's bound), with one
    TF32 product some gradient does not.  ``peak`` scales q: at 16 the
    softmax is peaked and dS = p (dP - D) cancels."""
    from test_torch_lm_kernels import _mm_3xtf32, _mm_tf32
    q, k, v, do = (torch.from_numpy(x) for x in
                   _attn_case(B, S, H, Kv, d, dv, seed=S + H))
    q = q * peak
    o, lse = ref.flash_attention_lse_ref(q, k, v, window=window,
                                         softcap=softcap)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, window=window,
                                       softcap=softcap)
    split = _attention_bwd_with(_mm_3xtf32, q, k, v, o, lse, do, window,
                                softcap)
    one = _attention_bwd_with(_mm_tf32, q, k, v, o, lse, do, window,
                              softcap)
    for name, g_, w_ in zip("qkv", split, want):
        assert _rel(g_, w_) < 1e-4, name
    assert max(_rel(g_, w_) for g_, w_ in zip(one, want)) >= 1e-4


def _scan_case(B, S, W, seed):
    g = np.random.default_rng(seed)
    a = (0.9 + 0.1 * g.random((B, S, W))).astype(np.float32)
    bx = g.standard_normal((B, S, W)).astype(np.float32)
    dhs = g.standard_normal((B, S, W)).astype(np.float32)
    dh = g.standard_normal((B, W)).astype(np.float32)
    return a, bx, dhs, dh


@pytest.mark.parametrize("B,S,W", [(2, 96, 16), (1, 1, 3), (3, 37, 10)])
def test_rglru_scan_backward_matches_autograd_and_jax(needs_jax, B, S, W):
    a, bx, dhs, dh = _scan_case(B, S, W, seed=S + W)
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(bx)
    tb.requires_grad_()
    hs, hl = ref.rglru_scan_ref(ta, tb)
    want = torch.autograd.grad((hs, hl), (ta, tb), (torch.from_numpy(dhs),
                                                   torch.from_numpy(dh)))
    got = ref.rglru_scan_bwd_ref(ta.detach(), hs.detach(),
                                 torch.from_numpy(dhs), torch.from_numpy(dh))
    hs2, hl2 = rglru_scan(ta, tb)
    fn = torch.autograd.grad((hs2, hl2), (ta, tb), (torch.from_numpy(dhs),
                                                    torch.from_numpy(dh)))

    def jax_scan(a_, bx_):        # rglru_forward's recurrence
        def step(h, inp):
            h = inp[0] * h + inp[1]
            return h, h
        h_last, hs_ = jax.lax.scan(step, jnp.zeros((B, W)),
                                   (a_.swapaxes(0, 1), bx_.swapaxes(0, 1)))
        return hs_.swapaxes(0, 1), h_last
    _, vjp = jax.vjp(jax.jit(jax_scan), jnp.asarray(a), jnp.asarray(bx))
    jgrads = vjp((jnp.asarray(dhs), jnp.asarray(dh)))
    for name, g_, w_, f_, j_ in zip(("a", "bx"), got, want, fn, jgrads):
        assert _rel(g_, w_) < FORMULA_TOL, name
        assert _rel(g_, j_) < FORMULA_TOL, name
        assert _rel(f_, g_) == 0.0, name


def test_rglru_layer_gradients_match_jax(needs_jax):
    """The whole RG-LRU block (gates, conv, the scan through the wrapper's
    plain backward, output projection) against ``jax.vjp`` of the JAX
    package's ``rglru_forward``."""
    cfg = dataclasses.replace(jax_smoke_config("recurrentgemma-2b"),
                              num_layers=3)
    p = jax.tree.map(np.asarray, init_rglru(jax.random.PRNGKey(1), cfg))
    g = np.random.default_rng(5)
    x = g.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    dy = g.standard_normal((2, 12, cfg.d_model)).astype(np.float32)

    @jax.jit
    def jax_vjp(pp, xx, dd):
        y_, vjp = jax.vjp(lambda p_, x_: jax_rglru_forward(p_, cfg, x_),
                          pp, xx)
        return y_, vjp(dd)
    jy, (jp, jx) = jax_vjp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           jnp.asarray(dy))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    ty = rglru_forward(tp, get_smoke_config("recurrentgemma-2b"), tx)
    grads = torch.autograd.grad(ty, [tx] + list(tp.values()),
                                torch.from_numpy(dy))
    assert _rel(ty, jy) < 1e-5
    assert _rel(grads[0], jx) < 1e-4
    for (k, _), gr in zip(tp.items(), grads[1:]):
        assert _rel(gr, jp[k]) < 1e-4, k


# --------------------------------------------------------------------- #
# lm_loss, value and gradient
# --------------------------------------------------------------------- #
def _rg3(get):
    return dataclasses.replace(get("recurrentgemma-2b"), num_layers=3)


LM_CASES = {"recurrentgemma-2b-3": (_rg3, 96), "gemma-2b": (None, 48),
            "falcon-mamba-7b": (None, 24)}


@pytest.fixture(scope="module", params=sorted(LM_CASES))
def lm_case(request, needs_jax):
    """One JAX value_and_grad of lm_loss a config (compiled once)."""
    cut, seq = LM_CASES[request.param]
    get = (lambda g: cut(g)) if cut else (lambda g: g(request.param))
    jcfg, tcfg = get(jax_smoke_config), get(get_smoke_config)
    params = jax.tree.map(np.asarray,
                          init_params(jax.random.PRNGKey(2), jcfg))
    g = np.random.default_rng(7)
    toks = g.integers(0, jcfg.vocab_size, (2, seq + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm_loss(p, jcfg, b, remat=True)))(
            jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, batch))
    return {"cfg": tcfg, "params": params, "batch": batch,
            "loss": float(loss), "grads": jax.tree.map(np.asarray, grads)}


@pytest.mark.parametrize("remat", [True, False])
def test_lm_loss_value_and_gradient_match_jax(lm_case, remat):
    model = params_from_numpy(lm_case["params"], lm_case["cfg"],
                              trainable=True)
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in lm_case["batch"].items()}
    loss = lm_loss(model, batch, remat=remat)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert abs(float(loss.detach()) - lm_case["loss"]) <= \
        1e-5 * abs(lm_case["loss"])
    with torch.no_grad():            # the gradients in the parameters' tree
        for p, g in zip(model.parameters(), grads):
            p.copy_(g)
    got = params_to_numpy(model)
    want = lm_case["grads"]

    def walk(a, b, path):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        else:
            assert _rel(a, b) < 1e-4, path
    walk(got, want, "")


def test_params_round_trip_to_the_jax_tree(lm_case):
    model = params_from_numpy(lm_case["params"], lm_case["cfg"])
    back = params_to_numpy(model)
    leaves = jax.tree.leaves(jax.tree.map(lambda a, b: _rel(a, b) == 0.0,
                                          back, lm_case["params"]))
    assert leaves and all(leaves)


# --------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------- #
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Kv,d,dv,window,softcap", ATTN_CASES + [
    (1, 1000, 10, 1, 256, 256, 300, 0.0),
    # across the kernel's tiles of 32 and its per-head partials: S = 1, 31,
    # 33 and 4097, H / Kv = 10, 5 and 1, d = 48
    (1, 1, 10, 1, 256, 256, 2048, 0.0), (1, 31, 5, 1, 48, 48, 0, 0.0),
    (2, 33, 10, 2, 64, 64, 16, 0.0), (1, 33, 3, 3, 48, 32, 0, 0.0),
    (1, 4097, 10, 1, 256, 256, 2048, 0.0)])
def test_cuda_attention_backward_matches_plain_version(B, S, H, Kv, d, dv,
                                                       window, softcap):
    dev = _card()
    q, k, v, do = (torch.from_numpy(x).to(dev) for x in
                   _attn_case(B, S, H, Kv, d, dv, seed=S + H))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    reset_launches()
    out = flash_attention(*leaves, window=window, softcap=softcap)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == 1
    assert launches["flash_attention_bwd"] == 1
    o, lse = ref.flash_attention_lse_ref(q, k, v, window=window,
                                         softcap=softcap)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, window=window,
                                       softcap=softcap)
    if S == 1:      # one key: dq = dk = 0 exactly, both sides hold rounding
        top = float(want[2].abs().max())
        assert _rel(got[2].cpu(), want[2].cpu()) < 1e-4
        for g_, w_ in zip(got[:2], want[:2]):
            assert float((g_ - w_).abs().max()) < 1e-4 * top
        return
    for g_, w_ in zip(got, want):
        assert _rel(g_.cpu(), w_.cpu()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W", [(1, 4096, 2560), (2, 97, 2561),
                                   (1, 5, 3), (2, 1, 2560), (1, 129, 2564),
                                   (1, 4097, 2568)])
def test_cuda_rglru_scan_backward_matches_plain_version(B, S, W):
    dev = _card()
    a, bx, dhs, dh = (torch.from_numpy(x).to(dev)
                      for x in _scan_case(B, S, W, seed=S + W))
    leaves = [a.clone().requires_grad_(), bx.clone().requires_grad_()]
    reset_launches()
    hs, hl = rglru_scan(*leaves)
    got = torch.autograd.grad((hs, hl), leaves, (dhs, dh))
    torch.cuda.synchronize()
    assert launches["rglru_scan"] == 1 and launches["rglru_scan_bwd"] == 1
    want = ref.rglru_scan_bwd_ref(a, hs.detach(), dhs, dh)
    for g_, w_ in zip(got, want):
        assert _rel(g_.cpu(), w_.cpu()) < 1e-4


@pytest.mark.cuda
def test_cuda_selective_scan_gradient_goes_through_its_backward_kernel():
    """A gradient of the selective scan on the card launches the backward
    kernel once, and its gradients agree with the plain backward."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    xc = torch.randn((1, 8, 16), generator=g, device=dev)
    dt = torch.rand((1, 8, 16), generator=g, device=dev)
    Bc, Cc = (torch.randn((1, 8, 4), generator=g, device=dev)
              for _ in range(2))
    A = -torch.rand((16, 4), generator=g, device=dev)
    dy = torch.randn((1, 8, 16), generator=g, device=dev)
    leaves = [t.clone().requires_grad_() for t in (xc, dt, Bc, Cc, A)]
    before = launches["selective_scan_bwd"]
    y, _ = selective_scan(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert launches["selective_scan_bwd"] == before + 1
    want = ref.selective_scan_bwd_ref(xc, dt, Bc, Cc, A, dy)
    for g_, w_ in zip(got, want):
        assert _rel(g_.cpu(), w_.cpu()) < 1e-4
    with torch.no_grad():
        y, _ = selective_scan(xc, dt, Bc, Cc, A)
    assert y.shape == xc.shape
