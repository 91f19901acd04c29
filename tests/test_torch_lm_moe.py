"""The port's MoE architectures against the JAX package at smoke size:
grok-1-314b (8 experts top-2 at full width, logit softcap 30) and
deepseek-v2-236b (MLA, a dense first layer, routed experts top-2 and a
shared expert).  Prefill logits and cache, two greedy decode steps (MLA's
absorbed and naive decodes both), the full-sequence forward with its
Switch aux loss, the loss, and the MoE block's routing under capacity
overflow.

The harness (`Served`: a jitted JAX prefill and decode steps once per
architecture, a module fixture) and the tolerances are
tests/test_torch_lm_arch.py's; the aux loss is held within 1e-5.
Routing is held exactly: given the JAX package's expert choices
(``gate_idx``, its draw), the port's slots, keep mask and dispatch buffer
equal the reference's bit for bit.  Both sides draw their own choices in
the end-to-end comparisons, from float32 router logits that agree to
rounding, so a choice could differ only at a near-tie of two experts'
probabilities.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)

from test_torch_lm_arch import (BATCH, DECODE_TOL, PREFILL_TOL,  # noqa: E402
                                STEPS, Served, close, compare_cache,
                                prompts)
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import LM, lm_loss, params_to_numpy  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

try:            # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import forward as jax_forward
    from repro.models import lm_loss as jax_lm_loss
    from repro.models import moe as jmoe
except ImportError:
    jax = None

AUX_TOL = 1e-5
ARCHS = ["grok-1-314b", "deepseek-v2-236b"]
VARIANTS = {"grok-1-314b": (("decode", {}),),
            "deepseek-v2-236b": (("decode", {}),
                                 ("naive", {"mla_absorbed": False}))}


@pytest.fixture(scope="module")
def needs_jax():
    if jax is None:
        pytest.skip("the JAX package is not installed")


@pytest.fixture(scope="module")
def served(needs_jax):
    """arch -> its `Served`, built at the first test that asks."""
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = Served(arch, seed=10 + ARCHS.index(arch),
                                 variants=VARIANTS[arch])
        return built[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS + ["grok_1_314b"])
def test_configs_match_the_jax_package(needs_jax, arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(jax_smoke_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(served, arch):
    served = served(arch)
    log, jlog = served.prefill
    assert tuple(log.shape) == (BATCH, served.cfg.vocab_size)
    close(log, jlog, PREFILL_TOL)
    got, want = served.cache
    assert len(got) == len(want) == served.cfg.num_layers
    for c, jc in zip(got, want):
        compare_cache(c, jc)


@pytest.mark.parametrize("arch,variant,i", [
    (arch, variant, i) for arch in ARCHS for variant, _ in VARIANTS[arch]
    for i in range(STEPS)])
def test_greedy_decode_steps_match_jax(served, arch, variant, i):
    """Two decode steps at B = 2: capacity is 1 a expert (2 tokens x top-2
    over 4 experts), so assignments overflow on both sides alike.  MLA
    decodes both with the absorbed matrices (deepseek's setting) and by
    expanding K/V from the latent."""
    served = served(arch)
    assert tmoe.capacity(BATCH, served.cfg) == 1
    log, jlog = served.steps[variant][i]
    close(log, jlog, DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_exactly(served, arch):
    """Three levels below a layer (``moe.shared.wg``), the dense prefix
    layer and the stacked groups of MoE layers."""
    served = served(arch)
    back = params_to_numpy(served.model)
    assert jax.tree.structure(back) == jax.tree.structure(served.tree)
    jax.tree.map(np.testing.assert_array_equal, back, served.tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_aux_loss_match_jax(served, arch):
    """The full-sequence forward's logits at every position and the MoE
    layers' summed Switch loss (the JAX package's ``forward(...)[1]``),
    then the loss with its aux term."""
    served = served(arch)
    jcfg = served.jcfg
    toks = jnp.asarray(served.toks)
    jlog, jaux = jax.jit(lambda p, t: jax_forward(p, jcfg, t, remat=False))(
        served.jparams, toks)
    labels = prompts(served.cfg, served.toks.shape[-1], seed=3)
    jloss = jax.jit(lambda p, b: jax_lm_loss(p, jcfg, b, remat=False))(
        served.jparams, {"tokens": toks, "labels": jnp.asarray(labels)})
    t = torch.from_numpy(served.toks).long()
    with torch.inference_mode():
        log, aux = served.model.forward_aux(t)
        loss = lm_loss(served.model, {"tokens": t,
                                      "labels": torch.from_numpy(labels)},
                       remat=False)
    close(log, jlog, PREFILL_TOL)
    assert float(aux) > 0 and abs(float(aux) - float(jaux)) < AUX_TOL
    assert abs(float(loss) - float(jloss)) < AUX_TOL


def test_deepseek_keeps_its_first_layer_dense():
    cfg = get_smoke_config("deepseek-v2-236b")
    model = LM(cfg, device="cpu", seed=0)
    assert [layer.is_moe for layer in model.layers] == [False, True, True]
    assert model.layers[0].mlp["wg"].shape == (cfg.d_model, cfg.d_ff)
    shared = model.layers[1].moe["shared"]
    assert shared["wg"].shape == (cfg.d_model,
                                  cfg.num_shared_experts * cfg.moe_d_ff)
    assert "layers.2.moe.shared.wd" in dict(model.named_parameters())


def _moe_inputs(arch, rows):
    """One MoE layer's JAX parameters and an (2, 1, D) decode input whose
    two tokens are ``rows`` of one draw (equal rows choose equal experts,
    so with capacity 1 the second token's assignments overflow)."""
    jcfg = jax_smoke_config(arch)
    jp = jmoe.init_moe(jax.random.PRNGKey(5), jcfg)
    draw = np.random.default_rng(6).standard_normal(
        (2, jcfg.d_model)).astype(np.float32)
    x = draw[list(rows)][:, None, :]
    return jcfg, jp, x


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("rows", [(0, 0), (0, 1)])
def test_moe_block_matches_jax_under_overflow(needs_jax, arch, rows):
    """The MoE block at decode's B = 2 (capacity 1): output, aux loss, and
    the dispatch given the reference's expert choices — slots, keep mask
    and buffer exactly."""
    jcfg, jp, x = _moe_inputs(arch, rows)
    cfg = get_smoke_config(arch)
    E, K = cfg.num_experts, cfg.topk
    cap = tmoe.capacity(2, cfg)
    assert cap == int(max(1, (2 * K * jcfg.capacity_factor) // E)) == 1
    jy, jaux = jax.jit(lambda p, x_: jmoe.moe_forward(p, jcfg, x_))(
        jp, jnp.asarray(x))
    tree = jax.tree.map(np.array, jp)
    p = {k: torch.from_numpy(v) for k, v in tree.items() if k != "shared"}
    p.update({f"shared.{k}": torch.from_numpy(v)
              for k, v in tree.get("shared", {}).items()})
    with torch.inference_mode():
        y, aux = tmoe.moe_forward(p, cfg, torch.from_numpy(x))
    close(y, jy, PREFILL_TOL)
    assert abs(float(aux) - float(jaux)) < AUX_TOL

    # the dispatch, on the reference's draw of expert choices
    xt = jnp.asarray(x.reshape(2, -1))
    probs = jax.nn.softmax(xt @ jp["router"], axis=-1)
    _, gate_idx = jax.lax.top_k(probs, K)
    e_flat = gate_idx.reshape(-1)
    jbuf, jslot, jkeep = jmoe._dispatch_local(xt, e_flat, E, cap,
                                              jnp.float32)
    buf, slot, keep = tmoe.dispatch(
        torch.from_numpy(np.array(xt)),
        torch.from_numpy(np.array(e_flat)).long(), E, cap)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    if rows[0] == rows[1]:      # the second token's choices are dropped
        assert keep.tolist() == [True] * K + [False] * K


def test_capacity_counts_the_tokens_of_the_call():
    """The reference's Python float arithmetic: grok's full config has 1
    slot an expert at decode's 4 tokens (and at 1), 2 at 8, and 5,120 at a
    4 x 4,096 prefill."""
    grok, ds = get_config("grok-1-314b"), get_config("deepseek-v2-236b")
    assert [tmoe.capacity(t, grok) for t in (1, 4, 8)] == [1, 1, 2]
    assert tmoe.capacity(4 * 4096, grok) == 5120
    assert tmoe.capacity(4 * 4096, ds) == 768
    assert tmoe.capacity(4 * 4097, ds) == int(4 * 4097 * 6 * 1.25 // 160)
