"""Federated training of the MoE, MLA and audio models against the JAX
package: one mode-B step of grok-1-314b's and deepseek-v2-236b's smoke
configs and one mode-A step of musicgen-large's, on carried-over state and
the same tokens, at tests/test_torch_train.py's tolerances (each leaf
within 1e-5 of its largest entry; the loss and the divergence 1e-5
relative, the trust weights 1e-6).

Routing is held exactly first.  Both packages' MoE blocks are wrapped to
record each call's expert choices (``gate_idx``) and the slots the
dispatch gives them, at every layer, microbatch and local step of the
step, the per-layer checkpoint's recomputes included; the JAX package's
through ``jax.debug.callback``, which under the step's ``vmap`` over
clusters runs once a cluster, cluster after cluster at each call.  The two
sequences must be equal: the step's gradients differentiate the same
dispatch in both.

Also here: the audio model's batches (``LMTask.make_batch``) in the JAX
package's codebook shapes, the plain attention backward at MLA's smoke
widths (d 24, dv 16) against ``jax.grad`` of the JAX package's ``_sdpa``
(2e-5), an MLA layer against ``jax.vjp`` of its ``mla_forward``, the
``routing`` keyword of `moe_forward`, the training CLI on the three
models, and (``cuda``-marked, on the card) the backward kernel at ragged
shapes with d != dv.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_grad import FORMULA_TOL, _attn_case, _card  # noqa: E402
from test_torch_lm_grad import _rel as _grad_rel  # noqa: E402
from test_torch_train import (C, NC, _max_rel,  # noqa: E402
                              _state_and_batch, needs_jax)  # noqa: F401
from repro_torch import optim as topt  # noqa: E402
from repro_torch.api.components import LMTask  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import fl_step as tfl  # noqa: E402
from repro_torch.kernels import (flash_attention, launches,  # noqa: E402
                                 ref, reset_launches)
from repro_torch.launch import train as torch_train  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.attention import mla_forward  # noqa: E402

try:            # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro.api.components import LMTask as JaxLMTask
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core import fl_step as jfl
    from repro.models import attention as jattn
    from repro.models import moe as jmoe
    from repro.models import transformer as jtr
    from repro.optim import optimizers as jopt
except ImportError:
    jax = None

LOCAL_STEPS = 2
SEQ = 32
BOOKS = 4       # musicgen-large's codebooks


# --------------------------------------------------------------------- #
# routing, recorded in both packages
# --------------------------------------------------------------------- #
def _record_jax_routing(monkeypatch, calls):
    """Wrap the JAX package's MoE block: each call appends (gate_idx,
    slot) as int64 numpy arrays, through a debug callback."""
    inner = jtr.moe_forward

    def wrapped(p, cfg, x):
        B, S, D = x.shape
        T, E, K = B * S, cfg.num_experts, cfg.topk
        xt = x.reshape(T, D)
        probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], -1)
        _, gate_idx = jax.lax.top_k(probs, K)
        cap = int(max(1, (T * K * cfg.capacity_factor) // E))
        _, slot, _ = jmoe._dispatch_local(xt, gate_idx.reshape(-1), E, cap,
                                          x.dtype)
        jax.debug.callback(lambda g, s: calls.append(
            (np.asarray(g, np.int64), np.asarray(s, np.int64))),
            gate_idx, slot)
        return inner(p, cfg, x)

    monkeypatch.setattr(jtr, "moe_forward", wrapped)


def _record_torch_routing(monkeypatch, calls):
    inner = ttr.moe_forward

    def wrapped(p, cfg, x, **kw):
        xt = x.reshape(-1, x.shape[-1])
        _, _, gate_idx = tmoe.route(p, cfg, xt)
        _, slot, _ = tmoe.dispatch(xt, gate_idx.reshape(-1), cfg.num_experts,
                                   tmoe.capacity(xt.shape[0], cfg))
        calls.append((gate_idx.numpy(), slot.numpy()))
        return inner(p, cfg, x, **kw)

    monkeypatch.setattr(ttr, "moe_forward", wrapped)


def _cluster_major(calls, groups):
    """The JAX records of a step vmapped over ``groups`` clusters (call i
    of cluster n at i * groups + n) in the port's order (cluster by
    cluster)."""
    per = len(calls) // groups
    return [calls[i * groups + n] for n in range(groups) for i in range(per)]


def _step_pair(arch, mode, monkeypatch, seed, books=1):
    """One step of both packages on the same carried-over state and tokens
    -> (numpy JAX state, JAX metrics, numpy port state, port metrics, JAX
    routing records, port routing records)."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    opt = jopt.adam(3e-4)
    fresh = jfl.build_init_fn(jcfg, opt, mode=mode, n_clusters=NC,
                              clients_per_cluster=C)(jax.random.PRNGKey(0))
    state, batch, rep, stale = _state_and_batch(
        fresh.params, mode, seed, vocab=cfg.vocab_size, books=books, seq=SEQ)
    jcalls, tcalls = [], []
    _record_jax_routing(monkeypatch, jcalls)
    _record_torch_routing(monkeypatch, tcalls)
    js = jfl.TrainState(jax.tree.map(jnp.asarray, state["params"]),
                        jax.tree.map(jnp.asarray, state["opt"]),
                        jnp.zeros((), jnp.int32))
    step = jax.jit(jfl.build_train_step(jcfg, opt, mode=mode,
                                        local_steps=LOCAL_STEPS))
    jout, jm = step(js, jax.tree.map(jnp.asarray, batch), jnp.asarray(rep),
                    jnp.asarray(stale))
    jax.block_until_ready(jout)
    ts = tfl.train_state_from_numpy(state, cfg, mode=mode, device="cpu")
    tb = {k: torch.from_numpy(np.asarray(v, np.int64 if k != "weights"
                                         else np.float32))
          for k, v in batch.items()}
    out, metrics = tfl.build_train_step(
        cfg, topt.adam(3e-4), mode=mode, local_steps=LOCAL_STEPS)(
            ts, tb, torch.from_numpy(rep), torch.from_numpy(stale))
    want = {"params": jax.tree.map(np.asarray, jout.params),
            "opt": jax.tree.map(np.asarray, jout.opt)}
    return (want, {k: np.asarray(v) for k, v in jm.items()},
            tfl.train_state_to_numpy(out, cfg, mode=mode), metrics,
            jcalls, tcalls)


def _assert_state_matches(got, want):
    assert _max_rel(got["params"], want["params"]) < 1e-5
    assert _max_rel(got["opt"]["m"], want["opt"]["m"]) < 1e-5
    assert _max_rel(got["opt"]["v"], want["opt"]["v"]) < 1e-5
    np.testing.assert_array_equal(got["opt"]["t"], want["opt"]["t"])


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "grok-1-314b"])
def test_mode_b_step_matches_the_jax_package(needs_jax, monkeypatch, arch):
    """a = 2 local Adam steps of 2 microbatches, NC 2, trust as per-example
    loss weights: the routing at every MoE call, then the parameters,
    Adam m, v and t, and the loss."""
    cfg = get_smoke_config(arch)
    want, jm, got, metrics, jcalls, tcalls = _step_pair(
        arch, tfl.MODE_B, monkeypatch, seed=6)
    moe_layers = cfg.num_layers - cfg.first_dense_layers
    # clusters x local steps x microbatches x MoE layers, each twice (the
    # per-layer checkpoint's recompute routes again)
    assert len(tcalls) == NC * LOCAL_STEPS * 2 * moe_layers * 2
    assert len(jcalls) == len(tcalls)
    for i, ((jg, js), (tg, ts)) in enumerate(zip(_cluster_major(jcalls, NC),
                                                 tcalls)):
        np.testing.assert_array_equal(tg, jg, err_msg=f"gate_idx, call {i}")
        np.testing.assert_array_equal(ts, js, err_msg=f"slots, call {i}")
    _assert_state_matches(got, want)
    np.testing.assert_allclose(metrics["loss"].numpy(), jm["loss"],
                               rtol=1e-5)


def test_audio_mode_a_step_matches_the_jax_package(needs_jax, monkeypatch):
    """musicgen-large: (K, S) token batches, the (K, V, D) embedding sum
    and (K, D, V) heads; a = 2, 2 microbatches, NC 2 x C 2."""
    want, jm, got, metrics, jcalls, tcalls = _step_pair(
        "musicgen-large", tfl.MODE_A, monkeypatch, seed=7, books=BOOKS)
    assert jcalls == tcalls == []          # no MoE block
    _assert_state_matches(got, want)
    np.testing.assert_allclose(metrics["loss"].numpy(), jm["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["divergence"].numpy(),
                               jm["divergence"], rtol=1e-5)
    np.testing.assert_allclose(metrics["trust_weights"].numpy(),
                               jm["trust_weights"], rtol=1e-6)


@pytest.mark.parametrize("mode", [tfl.MODE_A, tfl.MODE_B])
def test_audio_batches_have_the_jax_packages_shapes(needs_jax, mode):
    """`LMTask.make_batch` puts musicgen's 4 codebooks before the sequence,
    (NC, C, n_micro, Bm, K, S) in mode A and (NC, n_micro, Bm, K, S) in
    mode B, its per-example weights staying (NC, n_micro, Bm)."""
    kw = dict(arch="musicgen-large", mode=mode, seq=12, micro_batch=2,
              n_micro=3)
    got = LMTask(**kw).make_batch(torch.Generator().manual_seed(0), NC, C)
    want = JaxLMTask(**kw).make_batch(jax.random.PRNGKey(0), NC, C)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
    lead = (NC, C) if mode == tfl.MODE_A else (NC,)
    assert tuple(got["tokens"].shape) == lead + (3, 2, BOOKS, 12)
    assert int(got["tokens"].max()) < get_smoke_config(
        "musicgen-large").vocab_size
    assert torch.equal(got["tokens"][..., 1:], got["labels"][..., :-1])


# --------------------------------------------------------------------- #
# MLA's attention and layer, and the routing keyword
# --------------------------------------------------------------------- #
def test_mla_attention_backward_matches_jax_grad(needs_jax):
    """The plain backward at MLA's smoke widths (4 heads, d = qk_nope +
    qk_rope = 24, dv 16, scale 24^-0.5) and the wrapper's
    autograd.Function on the CPU against jax.vjp of ``_sdpa``."""
    cfg = get_smoke_config("deepseek-v2-236b")
    d, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    assert (d, dv) == (24, 16)
    B, S, H = 2, 40, cfg.num_heads
    q, k, v, do = _attn_case(B, S, H, H, d, dv, seed=11)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = ref.flash_attention_lse_ref(tq.detach(), tk.detach(),
                                         tv.detach())
    got = ref.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                      o, lse, torch.from_numpy(do))
    fn = torch.autograd.grad(flash_attention(tq, tk, tv), (tq, tk, tv),
                             torch.from_numpy(do))
    mask = jattn.causal_mask(S, S)[None, None, None]
    jout, vjp = jax.vjp(lambda a, b, c: jattn._sdpa(a, b, c, mask,
                                                     d ** -0.5, 0.0),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert _grad_rel(o, jout) < FORMULA_TOL
    for name, g_, f_, j_ in zip("qkv", got, fn, vjp(jnp.asarray(do))):
        assert _grad_rel(g_, j_) < FORMULA_TOL, name
        assert _grad_rel(f_, g_) == 0.0, name


def test_mla_layer_gradients_match_jax_vjp(needs_jax):
    """deepseek-v2's smoke MLA block (q_lora, kv_norm, the shared roped key
    expanded over the heads) under autograd against jax.vjp of the JAX
    package's ``mla_forward``, every parameter and the input."""
    cfg = get_smoke_config("deepseek-v2-236b")
    from repro.models.attention import init_attn as jax_init_attn
    jp = jax.tree.map(np.asarray, jax_init_attn(
        jax.random.PRNGKey(3), jax_smoke_config("deepseek-v2-236b")))
    g = np.random.default_rng(12)
    x = g.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    dy = g.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y = mla_forward(tp, cfg, tx, "attn")
    grads = torch.autograd.grad(y, [tx] + list(tp.values()),
                                torch.from_numpy(dy))
    jcfg = jax_smoke_config("deepseek-v2-236b")
    jy, vjp = jax.vjp(lambda xx, pp: jattn.mla_forward(pp, jcfg, xx, "attn"),
                      jnp.asarray(x), jax.tree.map(jnp.asarray, jp))
    jdx, jdp = vjp(jnp.asarray(dy))
    assert _grad_rel(y, jy) < 1e-5
    assert _grad_rel(grads[0], jdx) < 1e-5
    for (name, _), g_ in zip(tp.items(), grads[1:]):
        assert _grad_rel(g_, jdp[name]) < 1e-5, name


def test_moe_routing_keyword_replays_a_dispatch():
    """``routing`` hands `moe_forward` another pass's expert choices: its
    own choices give its own output, and the gradient flows through the
    gate values of the choices given."""
    cfg = get_smoke_config("deepseek-v2-236b")
    gen = torch.Generator().manual_seed(4)
    drawn = tmoe.init_moe(cfg, gen)
    p = {k: v for k, v in drawn.items() if k != "shared"}
    p.update({f"shared.{k}": v for k, v in drawn["shared"].items()})
    p["router"].requires_grad_()
    x = torch.randn((2, 20, cfg.d_model), generator=gen)
    y, aux = tmoe.moe_forward(p, cfg, x)
    own = tmoe.route(p, cfg, x.reshape(-1, cfg.d_model))[2]
    y2, aux2 = tmoe.moe_forward(p, cfg, x, routing=own)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    other = (own + 1) % cfg.num_experts           # every choice moved
    y3, _ = tmoe.moe_forward(p, cfg, x, routing=other)
    assert not torch.allclose(y3, y)
    (gr,) = torch.autograd.grad(y3.sum(), [p["router"]])
    assert gr.abs().max() > 0


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v2-236b",
                                  "musicgen-large"])
def test_train_cli_trains_the_moe_mla_and_audio_models(capsys, arch):
    """``python -m repro_torch.launch.train --arch ...`` on the CPU: mode A,
    as the JAX package's CLI."""
    torch_train.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                      "--seq", "8", "--batch", "1", "--clusters", "1",
                      "--clients", "1", "--local-steps", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "step,a_i,loss,queue,seconds"
    rows = [r.split(",") for r in out[1:3]]
    assert [r[0] for r in rows] == ["0", "1"]
    assert all(np.isfinite(float(r[2])) for r in rows)


# --------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Kv,d,dv", [
    (1, 33, 4, 4, 24, 16), (2, 1, 4, 1, 24, 16), (1, 4097, 4, 4, 24, 16),
    (1, 33, 8, 2, 192, 64), (1, 1, 4, 4, 192, 64), (1, 4097, 4, 1, 192, 64),
    (2, 33, 4, 1, 72, 40), (1, 1, 2, 2, 72, 40), (1, 4097, 8, 2, 72, 40),
    (1, 300, 8, 8, 192, 128), (1, 200, 4, 4, 64, 64)])
def test_cuda_attention_backward_with_d_unlike_dv(B, S, H, Kv, d, dv):
    """The backward kernel where d != dv (MLA's d 192 / dv 128 and ragged
    pairs, d 72 not a multiple of 16; S = 1, 33, 4097; H / Kv = 1, 4)
    against the plain version, within 1e-4 of each gradient's largest
    entry (dv's where S = 1, whose dq and dk are zero)."""
    dev = _card()
    q, k, v, do = (torch.from_numpy(x).to(dev) for x in
                   _attn_case(B, S, H, Kv, d, dv, seed=S + d))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    reset_launches()
    got = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == launches["flash_attention_bwd"] == 1
    o, lse = ref.flash_attention_lse_ref(q, k, v)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    top = float(want[2].abs().max())
    for name, g_, w_ in zip("qkv", got, want):
        if S == 1 and name != "v":
            assert float((g_ - w_).abs().max()) < 1e-4 * top, name
        else:
            assert _grad_rel(g_.cpu(), w_.cpu()) < 1e-4, name


# --------------------------------------------------------------------- #
# the card's scenarios
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,arch,cut", [
    ("DEEPSEEK_V2_236B_TRAIN", "deepseek-v2-236b",
     {"num_layers": 2, "num_experts": 16}),
    ("MUSICGEN_LARGE_TRAIN", "musicgen-large", {"num_layers": 4})])
def test_training_scenarios_are_the_full_width_configs_cut(name, arch, cut):
    """The card's training scenarios are the full-width configs with only
    the cuts their docstring lists, in the config's own FL mode, and pass
    `validate()`."""
    import dataclasses
    from repro_torch.api import FederationSpec
    from repro_torch.api import scenarios
    from repro_torch.api.components import lm_task_config
    from repro_torch.configs import get_config
    spec_dict = getattr(scenarios, name)
    spec = FederationSpec.from_dict(spec_dict).validate()
    params = spec.task.params
    got = lm_task_config(**params)
    full = get_config(arch)
    want = dataclasses.replace(full, name=f"{arch}-train", **cut)
    assert got == want
    assert LMTask(**params).mode == full.fl_mode
    assert (params["seq"], params["micro_batch"], params["n_micro"]) == (
        4096, 1, 2)
