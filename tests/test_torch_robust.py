"""The port's differential privacy and robust aggregation rules against the
JAX package's.

Each function of `repro_torch.core.privacy` and `repro_torch.core.robust`
gets the same seeded numpy inputs as its JAX counterpart (which works on
parameter trees; the port on the flat rows of the same tree): atol 1e-6
for the rules, with ragged masks, even and odd valid counts and exact ties
for krum.  Then the engine, round by round on the JAX package's injected
draws (`test_torch_engine.JaxDraws`), under DP (trust and fedavg) and
under each robust rule: scheduling and counters exactly, the state within
1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api as tapi  # noqa: E402
from repro_torch.core import privacy as tprivacy  # noqa: E402
from repro_torch.core import robust as trobust  # noqa: E402

from test_torch_engine import (FIXED, LYAPUNOV, jax, needs_jax,  # noqa: E402,F401
                               run_pair, spec_dict)

if jax is not None:
    import jax.numpy as jnp
    from repro.core import privacy as jprivacy
    from repro.core import robust as jrobust

ATOL = 1e-6


def tree(C, seed):
    """A two-leaf parameter tree with a leading client dim, and its flat
    (C, N) rows in the port's sorted-leaf layout."""
    g = np.random.default_rng(seed)
    t = {"w": g.standard_normal((C, 3, 4)).astype(np.float32),
         "b": g.standard_normal((C, 5)).astype(np.float32)}
    flat = np.concatenate([t[k].reshape(C, -1) for k in sorted(t)], 1)
    return t, flat


def jflat(out):
    """A JAX result tree without the client dim -> its flat (N,) row."""
    return np.concatenate([np.asarray(out[k]).ravel() for k in sorted(out)])


def jtree(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


@pytest.mark.parametrize("C", [1, 2, 7, 8])
def test_unmasked_rules_match_jax(needs_jax, C):
    t, flat = tree(C, C)
    x = torch.from_numpy(flat)
    for name in ("median", "trimmed_mean", "krum", "multi_krum"):
        got = trobust.AGGREGATORS[name](x)
        want = jflat(jrobust.AGGREGATORS[name](jtree(t)))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("valid", [[1], [0, 3], [1, 2, 5, 6], [0, 1, 2, 3, 4],
                                   list(range(8))])
@pytest.mark.parametrize("rule", ["median", "trimmed_mean"])
def test_masked_rules_match_jax_on_ragged_masks(needs_jax, rule, valid):
    """The padded variants against the JAX package's padded ones and its
    plain rules on the compacted rows; odd and even valid counts, padded
    rows holding large values."""
    t, flat = tree(8, 11)
    mask = np.zeros(8, bool)
    mask[valid] = True
    flat = np.where(mask[:, None], flat, 1e30).astype(np.float32)
    t = {k: np.where(mask.reshape((-1,) + (1,) * (v.ndim - 1)), v,
                     np.float32(1e30)) for k, v in t.items()}
    got = trobust.MASKED_AGGREGATORS[rule](torch.from_numpy(flat),
                                           torch.from_numpy(mask))
    want = jflat(jrobust.MASKED_AGGREGATORS[rule](jtree(t),
                                                  jnp.asarray(mask)))
    compact = jflat(jrobust.AGGREGATORS[rule](
        {k: jnp.asarray(v[mask]) for k, v in t.items()}))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), compact, atol=ATOL)


def test_median_of_even_count_averages_the_middle_pair():
    x = torch.tensor([[1.0, 4.0], [3.0, -2.0], [2.0, 0.0], [10.0, 1.0]])
    np.testing.assert_array_equal(trobust.coordinate_median(x).numpy(),
                                  [2.5, 0.5])


@pytest.mark.parametrize("f", [0, 1, 2])
def test_krum_ties_pick_the_first_client_as_jax_does(needs_jax, f):
    """Duplicated clients tie exactly on their scores: both packages pick
    the first of them, and multi-krum's stable ranking keeps their order."""
    t, flat = tree(6, 3)
    for k in t:
        t[k][4] = t[k][1]
        t[k][5] = t[k][1]
    flat[4] = flat[1]
    flat[5] = flat[1]
    x = torch.from_numpy(flat)
    scores = trobust.krum_scores(x, f)
    want = np.asarray(jrobust.krum_scores(jnp.asarray(flat), f))
    np.testing.assert_allclose(scores.numpy(), want, rtol=1e-6)
    assert int(torch.argmin(scores)) == int(np.argmin(want))
    assert torch.equal(torch.argsort(scores, stable=True),
                       torch.from_numpy(np.array(jnp.argsort(want))))
    np.testing.assert_allclose(trobust.krum(x, f).numpy(),
                               jflat(jrobust.krum(jtree(t), f)), atol=ATOL)
    for m in (None, 2):
        np.testing.assert_allclose(
            trobust.multi_krum(x, f, m).numpy(),
            jflat(jrobust.multi_krum(jtree(t), f, m)), atol=ATOL)


def test_krum_distances_in_blocks_are_exact(monkeypatch):
    """The block size changes no bit of the distances."""
    x = torch.from_numpy(tree(9, 4)[1])
    whole = trobust.pairwise_sq_dists(x)
    monkeypatch.setattr(trobust, "KRUM_BLOCK_ELEMS", 2 * x.shape[1])
    assert torch.equal(trobust.pairwise_sq_dists(x), whole)
    np.testing.assert_allclose(
        whole.numpy(), ((x[:, None] - x[None]) ** 2).sum(-1).numpy(),
        rtol=1e-6)


def test_clip_matches_jax(needs_jax):
    t, flat = tree(5, 8)
    flat[2] *= 1e-3                      # one row inside the clip ball
    t = {k: v.copy() for k, v in t.items()}
    for k in t:
        t[k][2] *= 1e-3
    got = tprivacy.clip_client_updates(torch.from_numpy(flat), 1.5)
    want = jprivacy.clip_client_updates(jtree(t), 1.5)
    np.testing.assert_allclose(
        got.numpy(), np.concatenate([np.asarray(want[k]).reshape(5, -1)
                                     for k in sorted(want)], 1), atol=ATOL)
    one = tprivacy.clip_update(torch.from_numpy(flat[0]), 1.5)
    np.testing.assert_allclose(one.numpy(), got[0].numpy(), atol=ATOL)
    assert torch.linalg.vector_norm(got, dim=1).max() <= 1.5 + 1e-5


@pytest.mark.parametrize("n_clients", [None, 3.0])
def test_dp_aggregate_matches_jax_on_its_normals(needs_jax, n_clients):
    """The same draws: the port gets the JAX package's normals, one key a
    leaf, flattened in the sorted-leaf layout.  Padded rows (mask 0, weight
    0) contribute nothing."""
    t, flat = tree(6, 21)
    g = np.random.default_rng(2)
    cur = {k: g.standard_normal(v.shape[1:]).astype(np.float32)
           for k, v in t.items()}
    mask = np.array([1, 1, 0, 1, 0, 0], np.float32)
    w = (g.random(6).astype(np.float32) * mask)
    w /= w.sum()
    key = jax.random.PRNGKey(9)
    want = jprivacy.dp_aggregate(key, jtree(t), jtree(cur), jnp.asarray(w),
                                 1.0, 0.5, n_clients=n_clients)
    shapes = [cur[k].shape for k in sorted(cur)]
    normals = np.concatenate([np.ravel(jax.random.normal(k, sh, jnp.float32))
                              for k, sh in zip(jax.random.split(key, 2),
                                               shapes)])
    cur_flat = np.concatenate([cur[k].ravel() for k in sorted(cur)])
    got = tprivacy.dp_aggregate(
        torch.from_numpy(flat - cur_flat[None]), torch.from_numpy(w),
        torch.from_numpy(mask), torch.from_numpy(cur_flat), 1.0, 0.5,
        6 if n_clients is None else n_clients, torch.from_numpy(normals))
    np.testing.assert_allclose(got.numpy(), jflat(want), atol=ATOL)


# ------------------------------------------------------------- the engine
@pytest.mark.parametrize("aggregator,controller,execution", [
    ({"kind": "trust"}, FIXED, "event"),
    ({"kind": "fedavg"}, LYAPUNOV, "scanned"),
], ids=["trust-event", "fedavg-scanned"])
def test_dp_round_by_round_parity(needs_jax, aggregator, controller,
                                  execution):
    d = spec_dict(controller, execution=execution, aggregator=aggregator)
    d["privacy"] = {"clip": 1.0, "noise": 0.5}
    _, tfed, _, _ = run_pair(d, execution)
    assert not tfed.engine._fuse_global


@pytest.mark.parametrize("rule", ["median", "trimmed_mean"])
@pytest.mark.parametrize("execution", ["event", "scanned"])
def test_masked_rules_round_by_round_parity(needs_jax, rule, execution):
    d = spec_dict(FIXED, execution=execution, aggregator={"kind": rule})
    _, tfed, _, _ = run_pair(d, execution)
    assert tfed.engine._padded and not tfed.engine._fuse_global


@pytest.mark.parametrize("rule,params", [("krum", {}),
                                         ("multi_krum", {"f": 2})])
def test_krum_round_by_round_parity_on_the_event_heap(needs_jax, rule,
                                                      params):
    d = spec_dict(FIXED, aggregator={"kind": rule, "params": params})
    d["fleet"] = {"n_devices": 16, "malicious_frac": 0.25}
    _, tfed, _, _ = run_pair(d, "event")
    assert not tfed.engine._padded
    assert [len(m) for m in tfed.engine._members] == \
        np.bincount(tfed.engine.assign, minlength=4).tolist()


def test_scanned_krum_raises_as_the_reference_does():
    d = spec_dict(FIXED, execution="scanned", aggregator={"kind": "krum"})
    with pytest.raises(ValueError, match="masked variant"):
        tapi.Federation.from_dict(d, device="cpu")
    fed = tapi.Federation.from_dict(
        spec_dict(FIXED, aggregator={"kind": "multi_krum"}), device="cpu")
    with pytest.raises(ValueError, match="supports_mask=False"):
        fed.run_scanned(2)


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_cuda_kernels_at_the_two_step_shapes():
    """On the card, the two kernels of the two-step path at
    ``dp-fleet1k``'s shapes against their plain versions (tolerance 1e-6
    relative to 1 + |plain|, f32): the masked kernel at C 99, N 159,010
    (Eqn 6 of `dp_aggregate` over clipped deltas, padded rows holding
    1e30), the unmasked one at B 16, N 159,010 (Eqn 19 of
    `time_weighted_average`); each wrapper call counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    from repro_torch.core.trust import time_weighted_average
    from repro_torch.kernels import launches, ref, reset_launches
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    N = 159010
    mask = (torch.arange(99, device=dev) < 80).to(torch.float32)
    x = torch.randn((99, N), generator=g, device=dev) * 1e-2
    x[80:] = 1e30
    w = torch.rand((99,), generator=g, device=dev) * mask
    w = w / w.sum()
    cur = torch.randn((N,), generator=g, device=dev)
    normals = torch.randn((N,), generator=g, device=dev)
    reset_launches()
    got = tprivacy.dp_aggregate(x, w, mask, cur, 1.0, 0.5, mask.sum(),
                                normals)
    clipped = tprivacy.clip_client_updates(x, 1.0)
    want = cur + (ref.trust_aggregate_ref(clipped, w, mask)
                  + 0.5 / 80 * normals)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    stack = torch.randn((16, N), generator=g, device=dev)
    st = torch.randint(0, 9, (16,), generator=g, device=dev).float()
    avg, gw = time_weighted_average(stack, st)
    torch.testing.assert_close(avg, ref.trust_aggregate_ref(stack, gw),
                               atol=1e-6, rtol=1e-6)
    torch.cuda.synchronize()
    assert launches["trust_aggregate"] == 1
    assert launches["trust_aggregate_dense"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("change,counts", [
    ({"privacy": {"clip": 1.0, "noise": 0.5}},
     {"trust_aggregate": 6, "trust_aggregate_dense": 6}),
    ({"aggregator": {"kind": "median"}, "faults": {"dropout": 0.3,
                                                   "straggler_frac": 0.3}},
     {"trust_aggregate_dense": 6}),
    ({"aggregator": {"kind": "krum"}}, {"trust_aggregate_dense": 6}),
], ids=["dp", "median-faults", "krum"])
def test_two_step_path_on_the_card_matches_cpu(change, counts):
    """The same spec on the card and on the CPU on the port's own draws:
    scheduling and ``a`` exactly, losses within 1e-3 (finite under krum,
    whose pick of one client can flip between near-equal scores summed in
    another order: `test_cuda_krum_matches_cpu` holds the rule itself),
    and every round launched the two-step path's kernels (no fused
    launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    from repro_torch.kernels import launches, reset_launches
    d = spec_dict(FIXED)
    d.update(change)
    cpu = tapi.Federation.from_dict(d, device="cpu").run(max_rounds=6)
    reset_launches()
    fed = tapi.Federation.from_dict(d)
    gpu = fed.run(max_rounds=6)
    torch.cuda.synchronize()
    assert {k: v for k, v in launches.items() if v} == counts
    for a, b in zip(cpu.records, gpu.records):
        assert (a.round, a.cluster, a.a) == (b.round, b.cluster, b.a)
        assert np.isfinite(b.loss)
        if "krum" not in str(change):
            assert abs(a.loss - b.loss) < 1e-3
    assert all(t.is_cuda for t in fed.engine.state.tensors().values())


@pytest.mark.cuda
def test_cuda_krum_matches_cpu():
    """Krum's scores on the card against the CPU's on the same rows (rtol
    1e-5), the same picks, and the robust rules' aggregates within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    x = torch.from_numpy(tree(40, 13)[1].repeat(800, axis=1))
    x = x + torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    mask = torch.arange(40) < 27
    xc = x.cuda()
    for f in (1, 5):
        torch.testing.assert_close(trobust.krum_scores(xc, f).cpu(),
                                   trobust.krum_scores(x, f), rtol=1e-5,
                                   atol=0)
        for rule in ("krum", "multi_krum"):
            torch.testing.assert_close(trobust.AGGREGATORS[rule](xc, f).cpu(),
                                       trobust.AGGREGATORS[rule](x, f),
                                       atol=1e-6, rtol=1e-6)
    for rule, fn in trobust.MASKED_AGGREGATORS.items():
        torch.testing.assert_close(fn(xc, mask.cuda()).cpu(), fn(x, mask),
                                   atol=1e-6, rtol=1e-6)
