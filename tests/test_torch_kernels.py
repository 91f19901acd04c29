"""The port's trust-aggregation kernels against the JAX package's Pallas
kernels (run with interpret=True), on the same numpy inputs.

On the CPU the port's wrappers compute their plain versions
(`repro_torch.kernels.ref`); the `cuda`-marked test holds the CUDA kernels
against those plain versions on the card.  Tolerances are
`tests/test_kernels.py`'s: 1e-6 (f32) and 2e-2 (bf16) for Eqn 6, 1e-5
for the fused Eqn 6 + Eqn 19 kernel.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (flatten_rows, launches, layout_of,  # noqa: E402
                                 leaf_views, trust_aggregate,
                                 trust_aggregate_global,
                                 trust_aggregate_global_tree,
                                 trust_aggregate_tree)
from repro_torch.kernels import ref  # noqa: E402

try:            # the card's machine has no JAX: only the cuda test runs there
    import jax
    import jax.numpy as jnp
    from repro.kernels import trust_aggregate as jax_trust_aggregate
    from repro.kernels import ops as jax_ops
    from repro.kernels.trust_aggregate import (
        trust_aggregate_global as jax_trust_aggregate_global)
except ImportError:
    jax = None


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("the JAX package is not installed")


def _inputs(C, N, valid, seed, pad_value=1e30):
    g = np.random.default_rng(seed)
    x = g.standard_normal((C, N)).astype(np.float32)
    x[valid:] = pad_value
    mask = (np.arange(C) < valid).astype(np.float32)
    w = g.random(C).astype(np.float32)
    w = (w / w[:valid].sum()).astype(np.float32) * mask
    return x, w, mask


def _tol(dtype):
    return 1e-6 if dtype == "float32" else 2e-2


@pytest.mark.parametrize("C,N,dtype", [
    (4, 1000, "float32"), (16, 3000, "float32"), (8, 2000, "bfloat16"),
    (2, 100, "float32"), (1, 129, "float32"),
])
def test_dense_matches_pallas(needs_jax, C, N, dtype):
    x, w, _ = _inputs(C, N, C, seed=C * N)
    want = jax_trust_aggregate(jnp.asarray(x).astype(dtype), jnp.asarray(w),
                               interpret=True)
    got = trust_aggregate(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(w))
    assert got.dtype == getattr(torch, dtype) and got.shape == (N,)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("C,valid,N,dtype", [
    (6, 3, 777, "float32"), (12, 11, 3000, "float32"), (5, 1, 64, "float32"),
    (9, 4, 1500, "bfloat16"),
])
def test_masked_matches_pallas_with_padded_rows(needs_jax, C, valid, N,
                                                dtype):
    """Padded rows hold 1e30 and contribute exactly zero in both."""
    x, w, mask = _inputs(C, N, valid, seed=C * 7919 + N)
    want = jax_trust_aggregate(jnp.asarray(x).astype(dtype), jnp.asarray(w),
                               jnp.asarray(mask > 0), interpret=True)
    got = trust_aggregate(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(w), torch.from_numpy(mask))
    assert np.isfinite(got.float().numpy()).all()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=_tol(dtype), rtol=_tol(dtype))


def test_mask_wins_over_nonzero_padded_weights():
    got = trust_aggregate(torch.ones(4, 256), torch.full((4,), 0.25),
                          torch.tensor([1.0, 1.0, 0.0, 0.0]))
    np.testing.assert_allclose(got.numpy(), 0.5, atol=1e-7)


@pytest.mark.parametrize("C,valid,B,N,pad_weight", [
    (10, 9, 6, 3000, False), (4, 2, 2, 64, False), (1, 1, 3, 513, False),
    (8, 5, 4, 700, True),
])
def test_global_matches_pallas(needs_jax, C, valid, B, N, pad_weight):
    """With ``pad_weight`` the padded 1e30 rows also carry non-zero
    weights: the mask wins in both."""
    x, w, mask = _inputs(C, N, valid, seed=C * 31 + B * 7 + N)
    if pad_weight:
        w = (w + 0.5 * (1 - mask)).astype(np.float32)
    g = np.random.default_rng(N)
    stack = g.standard_normal((B, N)).astype(np.float32)
    gw = g.random(B).astype(np.float32)
    gw /= gw.sum()
    for c in (0, B - 1):
        want = jax_trust_aggregate_global(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask > 0),
            jnp.asarray(stack), jnp.asarray(gw), c, interpret=True)
        got = trust_aggregate_global(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(mask),
            torch.from_numpy(stack), torch.from_numpy(gw),
            torch.tensor(c, dtype=torch.int32))
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def _mlp_tree(rows, seed, dim=12, hidden=5, classes=3):
    g = np.random.default_rng(seed)
    shapes = {"w1": (dim, hidden), "b1": (hidden,), "w2": (hidden, classes),
              "b2": (classes,)}
    return {k: g.standard_normal((rows,) + s).astype(np.float32)
            for k, s in shapes.items()}


def test_tree_wrappers_match_pallas(needs_jax):
    members = _mlp_tree(5, 0)
    stack = _mlp_tree(3, 1)
    mask = np.array([1, 1, 1, 0, 0], np.float32)
    w = np.array([0.5, 0.3, 0.2, 0.0, 0.0], np.float32)
    gw = np.array([0.2, 0.5, 0.3], np.float32)
    t = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}
    j = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}
    got = trust_aggregate_tree(t(members), torch.from_numpy(w),
                               torch.from_numpy(mask))
    want = jax_ops.trust_aggregate_tree(j(members), jnp.asarray(w),
                                        jnp.asarray(mask > 0),
                                        interpret=True)
    for k in members:
        assert got[k].shape == members[k].shape[1:]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=1e-6)
    got = trust_aggregate_global_tree(t(members), torch.from_numpy(w),
                                      torch.from_numpy(mask), t(stack),
                                      torch.from_numpy(gw), 2)
    want = jax_ops.trust_aggregate_global_tree(
        j(members), jnp.asarray(w), jnp.asarray(mask > 0), j(stack),
        jnp.asarray(gw), 2, interpret=True)
    for k in stack:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-5)


def test_flat_leaf_order_matches_jax(needs_jax):
    """Sorted keys (b1, b2, w1, w2) = jax.tree.leaves order, element for
    element, and the views read the leaves back."""
    from repro.api.engine import _flatten_params
    tree = _mlp_tree(4, 2)
    got = flatten_rows({k: torch.from_numpy(v) for k, v in tree.items()})
    want = _flatten_params({k: jnp.asarray(v) for k, v in tree.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [k for k, _, _ in layout_of(tree, lead=1)] == ["b1", "b2", "w1",
                                                          "w2"]
    views = leaf_views(got, layout_of(tree, lead=1))
    for k, v in tree.items():
        np.testing.assert_array_equal(views[k].numpy(), v)


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = dict(launches)
    trust_aggregate(torch.ones(2, 8), torch.full((2,), 0.5))
    trust_aggregate_global(torch.ones(2, 8), torch.full((2,), 0.5),
                           torch.ones(2), torch.ones(3, 8),
                           torch.full((3,), 1 / 3),
                           torch.tensor(0, dtype=torch.int32))
    assert launches == before


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """The CUDA kernels against their plain versions on the card, at the
    main path's shape and at ragged ones (padded 1e30 rows, C = 1,
    N not a multiple of 4 or 128, c at both ends of the stack), with zero
    and with non-zero weights left on the padded rows (the mask wins)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    ta = importlib.import_module("repro_torch.kernels.trust_aggregate")
    dev = torch.device("cuda")
    for C, valid, B, N in [(99, 80, 16, 159010), (1, 1, 3, 1001),
                           (7, 4, 5, 130), (300, 299, 2, 257)]:
        x, w0, mask = (torch.from_numpy(a).to(dev)
                       for a in _inputs(C, N, valid, seed=N))
        stack = torch.randn(B, N, device=dev)
        gw = torch.softmax(torch.randn(B, device=dev), 0)
        for w in (w0, w0 + 0.5 * (1 - mask)):
            for dtype, tol in ((torch.float32, 1e-6),
                               (torch.bfloat16, 2e-2)):
                got = ta.trust_aggregate(x.to(dtype), w, mask)
                want = ref.trust_aggregate_ref(x.to(dtype), w, mask)
                assert torch.isfinite(got.float()).all()
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol, rtol=tol)
            for c in (0, B - 1):
                ct = torch.tensor(c, dtype=torch.int32, device=dev)
                got = ta.trust_aggregate_global(x, w, mask, stack, gw, ct)
                assert torch.isfinite(got).all()
                torch.testing.assert_close(
                    got,
                    ref.trust_aggregate_global_ref(x, w, mask, stack, gw,
                                                   ct),
                    atol=1e-5, rtol=1e-5)
        xs = x[:valid].contiguous()
        torch.testing.assert_close(ta.trust_aggregate(xs, w0[:valid]),
                                   ref.trust_aggregate_ref(xs, w0[:valid]),
                                   atol=1e-6, rtol=1e-6)
    torch.cuda.synchronize()


# (C, valid rows, N, storage offset in elements): rows at every alignment
# (N = 0, 1, 2, 3 mod 8, and the main path's N), C = 1, C = 300 (the row
# compaction in chunks), tiny N, inputs that do not start on a 16-byte
# boundary
ALIGN_CASES = [(6, 4, 1024, 0), (6, 4, 1025, 0), (6, 4, 1026, 0),
               (6, 4, 1027, 0), (99, 60, 159010, 0), (1, 1, 1001, 0),
               (300, 299, 257, 0), (300, 170, 4099, 0), (4, 2, 1, 0),
               (4, 3, 3, 0), (7, 5, 130, 1), (7, 5, 131, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("C,valid,N,shift", ALIGN_CASES)
def test_cuda_masked_kernel_at_every_row_alignment(C, valid, N, shift):
    """The masked and dense CUDA kernel against its plain version in f32
    and bf16, padded rows of 1e30 with zero and with non-zero weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    ta = importlib.import_module("repro_torch.kernels.trust_aggregate")
    dev = torch.device("cuda")
    x, w0, mask = _inputs(C, N, valid, seed=C + N + shift)
    mask_t = torch.from_numpy(mask).to(dev)
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
        flat = torch.empty(shift + C * N, dtype=dtype, device=dev)
        flat[shift:] = torch.from_numpy(x).reshape(-1).to(dev, dtype)
        xd = flat[shift:].view(C, N)
        for w in (w0, w0 + 0.5 * (1 - mask)):
            wt = torch.from_numpy(w.astype(np.float32)).to(dev)
            got = ta.trust_aggregate(xd, wt, mask_t)
            assert torch.isfinite(got.float()).all()
            torch.testing.assert_close(
                got.float(), ref.trust_aggregate_ref(xd, wt, mask_t).float(),
                atol=tol, rtol=tol)
        rows = xd[:valid]
        wt = torch.from_numpy(w0[:valid]).to(dev)
        torch.testing.assert_close(
            ta.trust_aggregate(rows, wt).float(),
            ref.trust_aggregate_ref(rows, wt).float(), atol=tol, rtol=tol)
    torch.cuda.synchronize()


# (C, valid rows, N, storage offset in elements) of the fused kernel: rows
# at every alignment (16-, 8- and 4-byte loads), no valid member at all,
# the anomaly task's and the main path's shapes (one launch a cluster of 8
# and of 2 blocks), C = 300 (the row table built in two passes), tiny N
GLOBAL_CASES = [(6, 4, 1024, 0), (6, 4, 1025, 0), (6, 4, 1026, 0),
                (6, 4, 1027, 0), (6, 4, 1024, 2), (6, 4, 1026, 1),
                (5, 0, 700, 0), (111, 111, 5288, 0), (111, 70, 5288, 1),
                (99, 99, 159010, 0), (99, 60, 159010, 2), (300, 299, 257, 0),
                (300, 170, 4099, 3), (1, 1, 1001, 0), (4, 2, 1, 0),
                (4, 3, 3, 0), (7, 5, 131, 3)]


def _global_inputs(C, valid, B, N, shift, dev):
    """Member updates and cluster stack stored ``shift`` elements past an
    allocation's start; padded member rows hold 1e30; weights finite also
    without a valid row."""
    g = np.random.default_rng(C * 1009 + N * 7 + B + shift)
    x = g.standard_normal((C, N)).astype(np.float32)
    x[valid:] = 1e30
    mask = (np.arange(C) < valid).astype(np.float32)
    w = g.random(C).astype(np.float32) * mask
    w = (w / max(w.sum(), 1e-30)).astype(np.float32)
    stack = g.standard_normal((B, N)).astype(np.float32)
    gw = g.random(B).astype(np.float32)
    gw /= gw.sum()

    def at_offset(a):
        flat = torch.empty(shift + a.size, device=dev)
        flat[shift:] = torch.from_numpy(a).reshape(-1).to(dev)
        return flat[shift:].view(a.shape)

    t = lambda a: torch.from_numpy(a).to(dev)
    return at_offset(x), t(w), t(mask), at_offset(stack), t(gw)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 16])
@pytest.mark.parametrize("C,valid,N,shift", GLOBAL_CASES)
def test_cuda_global_kernel_at_every_row_alignment(C, valid, N, shift, B):
    """The fused kernel against its plain version for c = 0, B // 2,
    B - 1 and B (out of range: no substitution), with zero and with
    non-zero weights left on the padded 1e30 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    ta = importlib.import_module("repro_torch.kernels.trust_aggregate")
    dev = torch.device("cuda")
    x, w0, mask, stack, gw = _global_inputs(C, valid, B, N, shift, dev)
    for w in (w0, w0 + 0.5 * (1 - mask)):
        for c in sorted({0, B // 2, B - 1, B}):
            ct = torch.tensor(c, dtype=torch.int32, device=dev)
            got = ta.trust_aggregate_global(x, w, mask, stack, gw, ct)
            assert torch.isfinite(got).all()
            torch.testing.assert_close(
                got, ref.trust_aggregate_global_ref(x, w, mask, stack, gw,
                                                    ct),
                atol=1e-5, rtol=1e-5)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_global_kernel_is_deterministic_and_capturable():
    """Two calls give the same bits; one call captured in a CUDA graph and
    replayed gives the eager call's bits, also after c changes in place
    (the kernel reads c on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    ta = importlib.import_module("repro_torch.kernels.trust_aggregate")
    dev = torch.device("cuda")
    for C, valid, B, N in [(111, 111, 16, 5288), (99, 90, 16, 159010),
                           (300, 299, 2, 4099)]:
        x, w, mask, stack, gw = _global_inputs(C, valid, B, N, 0, dev)
        ct = torch.tensor(B // 2, dtype=torch.int32, device=dev)
        first = ta.trust_aggregate_global(x, w, mask, stack, gw, ct)
        assert torch.equal(first,
                           ta.trust_aggregate_global(x, w, mask, stack, gw,
                                                     ct))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ta.trust_aggregate_global(x, w, mask, stack, gw, ct)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = ta.trust_aggregate_global(x, w, mask, stack, gw, ct)
        for c in (B // 2, 0, B):
            ct.fill_(c)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(captured, ta.trust_aggregate_global(
                x, w, mask, stack, gw, ct))
        del graph
    torch.cuda.synchronize()


# --------------------------------------------------------------------- #
# the population-batched kernels: P federations in one launch
# --------------------------------------------------------------------- #
def _pop_inputs(P, C, B, N, dev, seed):
    """P members' fused-kernel inputs with ragged valid rows (one member
    without any), padded rows of 1e30 with zero or non-zero weights, and
    rows c that cover 0, B - 1 and B (no member row)."""
    g = np.random.default_rng(seed)
    x = g.standard_normal((P, C, N)).astype(np.float32)
    valid = [int(v) for v in g.integers(0, C + 1, P)]
    valid[0] = C
    if P > 2:
        valid[1] = 0
    mask = np.stack([(np.arange(C) < v).astype(np.float32) for v in valid])
    w = g.random((P, C)).astype(np.float32)
    w = w / np.maximum((w * mask).sum(1, keepdims=True), 1e-30)
    w = (w * np.where(np.arange(P)[:, None] % 2 == 0, mask, 1.0)).astype(
        np.float32)
    x[mask == 0] = 1e30
    stack = g.standard_normal((P, B, N)).astype(np.float32)
    gw = g.random((P, B)).astype(np.float32)
    gw /= gw.sum(1, keepdims=True)
    c = np.array([(0, B - 1, B)[p % 3] for p in range(P)], np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(x), t(w), t(mask), t(stack), t(gw), t(c)


POP_CASES = [(8, 99, 16, 159010), (8, 111, 16, 5288), (1, 7, 5, 130),
             (3, 300, 2, 257), (8, 6, 4, 1027)]


@pytest.mark.cuda
@pytest.mark.parametrize("P,C,B,N", POP_CASES)
def test_cuda_population_kernels_match_plain_and_single(P, C, B, N):
    """The batched kernels against their batched plain versions, and every
    slice bitwise against the single kernel launched on that member's
    tensors (the same launch plan, the same order of rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    ta = importlib.import_module("repro_torch.kernels.trust_aggregate")
    dev = torch.device("cuda")
    x, w, mask, stack, gw, c = _pop_inputs(P, C, B, N, dev, seed=P + C + N)
    got = ta.trust_aggregate_global_pop(x, w, mask, stack, gw, c)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got, ref.trust_aggregate_global_pop_ref(x, w, mask, stack, gw, c),
        atol=1e-5, rtol=1e-5)
    for p in range(P):
        assert torch.equal(got[p], ta.trust_aggregate_global(
            x[p], w[p], mask[p], stack[p], gw[p], c[p]))
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
        xd = x.to(dtype)
        for m in (mask, None):
            ww = w * mask if m is None else w
            got = ta.trust_aggregate_pop(xd, ww, m)
            want = ref.trust_aggregate_pop_ref(xd.float(), ww, m)
            torch.testing.assert_close(got.float(), want, atol=tol,
                                       rtol=tol)
            for p in range(P):
                assert torch.equal(got[p], ta.trust_aggregate(
                    xd[p], ww[p], None if m is None else m[p]))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_population_kernel_under_vmap_and_in_a_graph():
    """``torch.func.vmap`` of the fused wrapper launches the batched
    kernel once; the batched launch captured in a CUDA graph replays the
    eager call's bits, also after the rows c change in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    ta = importlib.import_module("repro_torch.kernels.trust_aggregate")
    dev = torch.device("cuda")
    x, w, mask, stack, gw, c = _pop_inputs(8, 99, 16, 159010, dev, seed=1)
    before = dict(launches)
    got = torch.func.vmap(ta.trust_aggregate_global)(x, w, mask, stack, gw,
                                                     c)
    assert launches["trust_aggregate_global_pop"] == \
        before["trust_aggregate_global_pop"] + 1
    assert launches["trust_aggregate_global"] == \
        before["trust_aggregate_global"]
    assert torch.equal(got, ta.trust_aggregate_global_pop(x, w, mask, stack,
                                                          gw, c))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ta.trust_aggregate_global_pop(x, w, mask, stack, gw, c)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ta.trust_aggregate_global_pop(x, w, mask, stack, gw, c)
    for shift in (0, 1, 2):
        c.copy_((c + shift) % 17)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, ta.trust_aggregate_global_pop(
            x, w, mask, stack, gw, c))
    del graph
    torch.cuda.synchronize()
