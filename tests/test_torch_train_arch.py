"""Training of the attention variants that the dense configs add: one
federated mode-A step of qwen1.5-32b's smoke config (qkv bias) and of
chameleon-34b's (qk-norm) against the JAX package's ``build_train_step``
on carried-over state and the same tokens, at tests/test_torch_train.py's
tolerances (1e-5 relative to each leaf's largest entry; the loss and the
divergence 1e-5 relative, the trust weights 1e-6).  The bias and norm
weights are perturbed with the rest, so their gradients count.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train import (C, NC, _max_rel,  # noqa: E402
                              _state_and_batch, needs_jax)  # noqa: F401
from repro_torch import optim as topt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import fl_step as tfl  # noqa: E402

try:            # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core import fl_step as jfl
    from repro.optim import optimizers as jopt
except ImportError:
    jax = None

LOCAL_STEPS = 2


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "chameleon-34b"])
def test_mode_a_step_matches_the_jax_package(needs_jax, arch):  # noqa: F811
    cfg = get_smoke_config(arch)
    assert cfg.qkv_bias or cfg.qk_norm
    jcfg = jax_smoke_config(arch)
    opt = jopt.adam(3e-4)
    fresh = jfl.build_init_fn(jcfg, opt, mode=jfl.MODE_A, n_clusters=NC,
                              clients_per_cluster=C)(jax.random.PRNGKey(0))
    state, batch, rep, stale = _state_and_batch(fresh.params, tfl.MODE_A,
                                                seed=4)
    js = jfl.TrainState(jax.tree.map(jnp.asarray, state["params"]),
                        jax.tree.map(jnp.asarray, state["opt"]),
                        jnp.zeros((), jnp.int32))
    step = jax.jit(jfl.build_train_step(jcfg, opt, mode=jfl.MODE_A,
                                        local_steps=LOCAL_STEPS))
    jout, jm = step(js, jax.tree.map(jnp.asarray, batch), jnp.asarray(rep),
                    jnp.asarray(stale))

    ts = tfl.train_state_from_numpy(state, cfg, mode=tfl.MODE_A,
                                    device="cpu")
    tb = {k: torch.from_numpy(np.asarray(v, np.int64))
          for k, v in batch.items()}
    out, metrics = tfl.build_train_step(
        cfg, topt.adam(3e-4), mode=tfl.MODE_A, local_steps=LOCAL_STEPS)(
            ts, tb, torch.from_numpy(rep), torch.from_numpy(stale))
    got = tfl.train_state_to_numpy(out, cfg, mode=tfl.MODE_A)
    want = jax.tree.map(np.asarray, jout.params)
    assert _max_rel(got["params"], want) < 1e-5
    assert _max_rel(got["opt"]["m"], jax.tree.map(np.asarray,
                                                  jout.opt["m"])) < 1e-5
    assert _max_rel(got["opt"]["v"], jax.tree.map(np.asarray,
                                                  jout.opt["v"])) < 1e-5
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(
        jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["divergence"].numpy(), np.asarray(
        jm["divergence"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["trust_weights"].numpy(), np.asarray(
        jm["trust_weights"]), rtol=1e-6)
