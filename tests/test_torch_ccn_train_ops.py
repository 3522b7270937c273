"""The port's CCN backward ops against the JAX package, on the CPU (where
the kernel wrappers run their plain PyTorch versions): the adjoints of
contract_18, the fused backward wrappers against JAX's Pallas backward
kernels in interpret mode, the gradient through each autograd Function
against jax.grad through JAX's fused ops, and the gather-form promotion
backward against torch's own autograd through indexing.

Tolerances: the forward-shaped results (adjoint parts, backward kernels'
outputs) at atol = rtol = 1e-5, as f32 gathers and sums in another order;
gradients at 1e-5 x the largest |gradient|, since an entry sums up to K^3
products whose rounding scales with the largest term, not with the entry."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.graphs import GraphRecord as JGraphRecord
from hgnn2_tpu.nn import ccn as jccn
from hgnn2_tpu.ops import contractions as jC
from hgnn2_tpu.ops.pallas import ccn_fused as jfused

from hgnn2_torch.data import qm9
from hgnn2_torch.graphs import GraphRecord
from hgnn2_torch.nn import ccn
from hgnn2_torch.ops import ccn_fused
from hgnn2_torch.ops import contractions as P
from tests.test_torch_ccn_ops import _k8_arrays

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_RTOL = 1e-5


@pytest.fixture(scope="module")
def batches():
    """The same 20 molecules batched by both packages (graphs of at most
    33 vertices, so JAX's kernels fit their halo of 32; several straddle
    its 128-vertex blocks)."""
    recs = qm9.synthetic_qm9_like(20, seed=0)
    jrecs = jqm9.synthetic_qm9_like(20, seed=0)
    kw = dict(task=0, vertex_capacity=256, batch_size=24)
    return (ccn.make_ccn_batch(recs, device="cpu", **kw),
            jccn.make_ccn_batch(jrecs, **kw))


def _masked(cb, shape_tail, seed):
    rng = np.random.default_rng(seed)
    V, K = cb.nbr.shape
    m = cb.row_mask.numpy()
    mask = m[:, :, None] if len(shape_tail) == 1 else (
        m[:, :, None, None] * m[:, None, :, None])
    return rng.standard_normal((V, K) + shape_tail).astype(np.float32) * mask


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(want).max())


@pytest.mark.parametrize("compat", [False, True])
def test_contract_18_transpose_matches_jax_and_vjp(compat):
    """The four parts and gbar against JAX's, and gbar against torch's VJP
    of contract_18, with ragged degrees."""
    V, K, C = 9, 4, 3
    rng = np.random.default_rng(0)
    deg = rng.integers(1, K + 1, V).astype(np.float32)
    m = (np.arange(K)[None, :] < deg[:, None]).astype(np.float32)
    g = _randn((V, K, K, 18 * C), 1)
    t = _randn((V, K, K, K, C), 2)
    tdeg, tm, tg = map(torch.from_numpy, (deg, m, g))

    parts = P.contract_18_transpose_parts(tg, tdeg, tm, compat=compat)
    jparts = jC.contract_18_transpose_parts(jnp.asarray(g), jnp.asarray(deg),
                                            jnp.asarray(m), compat=compat)
    for got, want in zip(parts, jparts):
        assert got.shape == (V, K, K, C)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    gbar = P.contract_18_transpose(tg, tdeg, tm, compat=compat)
    want = jC.contract_18_transpose(jnp.asarray(g), jnp.asarray(deg),
                                    jnp.asarray(m), compat=compat)
    np.testing.assert_allclose(gbar.numpy(), np.asarray(want), **TOL)

    tt = torch.from_numpy(t).requires_grad_()
    (P.contract_18(tt, tdeg, tm, compat=compat) * tg).sum().backward()
    np.testing.assert_allclose(gbar.numpy(), tt.grad.numpy(), atol=1e-4, rtol=1e-4)


def test_contract_1d_transpose_matches_vjp():
    t = torch.from_numpy(_randn((7, 4, 4, 3), 3)).requires_grad_()
    g = torch.from_numpy(_randn((7, 4, 6), 4))
    (P.contract_1d(t) * g).sum().backward()
    np.testing.assert_allclose(P.contract_1d_transpose(g).numpy(),
                               t.grad.numpy(), **TOL)


@pytest.fixture(scope="module")
def edge_batches():
    """Batches at K2's tile edges, built by both packages: the 20 molecules
    at their exact vertex count (V = 215, no multiple of 4, so the last of
    K2's tiles is ragged at every Vt) and degree-capped graphs with K = 8
    (test_torch_ccn_ops._k8_arrays)."""
    recs = qm9.synthetic_qm9_like(20, seed=0)
    jrecs = jqm9.synthetic_qm9_like(20, seed=0)
    y = np.zeros(1, np.float32)
    arrays = _k8_arrays()
    out = {"ragged": (ccn.make_ccn_batch(recs, task=0, device="cpu"),
                      jccn.make_ccn_batch(jrecs, task=0)),
           "k8": (ccn.make_ccn_batch([GraphRecord(x=x, adj=a, y=y) for x, a in arrays],
                                     task=0, device="cpu"),
                  jccn.make_ccn_batch([JGraphRecord(x=x, adj=a, y=y) for x, a in arrays],
                                      task=0))}
    assert out["ragged"][0].nbr.shape[0] % 4 and out["k8"][0].nbr.shape[1] == 8
    return out


@pytest.mark.parametrize("kind, C", [("bucket", 5), ("bucket", 2), ("ragged", 5),
                                     ("ragged", 2), ("k8", 5), ("k8", 2)],
                         ids=["5", "2", "ragged-5", "ragged-2", "k8-5", "k8-2"])
def test_fused_1d_backward_matches_jax(request, kind, C):
    cb, jb = (request.getfixturevalue("batches") if kind == "bucket"
              else request.getfixturevalue("edge_batches")[kind])
    V, K = cb.nbr.shape
    g = _randn((V, K, 2 * C), C)
    got = ccn_fused.fused_contract_1d_backward(cb.chi_idx, cb.rslot, cb.nbr,
                                               torch.from_numpy(g))
    want = jfused.fused_contract_1d_backward(
        jb.chi_idx, jb.rslot, jb.nbr, jnp.asarray(g), halo=32, interpret=True)
    assert got.shape == (V, K, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind, compat", [("bucket", False), ("bucket", True),
                                          ("ragged", False), ("k8", False)],
                         ids=["False", "True", "ragged-False", "k8-False"])
def test_fused_2d_backward_matches_jax(request, kind, compat):
    """Against JAX's Pallas backward in interpret mode; at K = 8 against
    the closed form that kernel equals, _promote_2d_bwd(contract_18_transpose
    (g)), since interpret mode unrolls the kernel's K^3 gathers a vertex
    and compiles for longer than the whole suite may take."""
    cb, jb = (request.getfixturevalue("batches") if kind == "bucket"
              else request.getfixturevalue("edge_batches")[kind])
    V, K = cb.nbr.shape
    g = _randn((V, K, K, 18 * 2), 6)
    got = ccn_fused.fused_contract_backward(
        cb.chi_idx, cb.rslot, cb.nbr, torch.from_numpy(g), cb.deg,
        cb.row_mask, compat=compat)
    if kind == "k8":
        want = jC._promote_2d_bwd(
            (jb.chi_idx, jb.rslot, jb.nbr),
            jC.contract_18_transpose(jnp.asarray(g), jb.deg, jb.row_mask,
                                     compat=compat))[3]
    else:
        want = jfused.fused_contract_backward(
            jb.chi_idx, jb.rslot, jb.nbr, jnp.asarray(g), jb.deg,
            jb.row_mask, compat=compat, halo=32, interpret=True)
    assert got.shape == (V, K, K, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
    # through the four parts of contract_18's adjoint, as the kernel forms
    # them, the plain chain gives the same bits
    parts = P.contract_18_transpose_parts(torch.from_numpy(g), cb.deg,
                                          cb.row_mask, compat=compat)
    np.testing.assert_array_equal(
        P.promote_2d_bwd(cb.chi_idx, cb.rslot, cb.nbr,
                         P.gbar_from_parts(*parts)).numpy(),
        got.numpy())


def test_promote_contract_1d_grad_matches_jax(batches):
    cb, jb = batches
    V, K = cb.nbr.shape
    f0, w = _masked(cb, (3,), 7), _randn((V, K, 6), 8)
    f = torch.from_numpy(f0).requires_grad_()
    (ccn_fused.promote_contract_1d(cb.chi_idx, cb.nbr, f, cb.rslot)
     * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda ff: (jfused.promote_contract_1d_pallas(
        jb.chi_idx, jb.nbr, ff, rslot=jb.rslot, halo=32, interpret=True)
        * w).sum())(jnp.asarray(f0))
    _assert_grad_close(f.grad.numpy(), want)


def test_promote_contract_18_grad_matches_jax(batches):
    """The autograd plumbing around K3/K4 (both channel layouts of the
    backward are held to JAX's kernel above)."""
    cb, jb = batches
    V, K = cb.nbr.shape
    f0, w = _masked(cb, (K, 2), 9), _randn((V, K, K, 36), 10)
    f = torch.from_numpy(f0).requires_grad_()
    (ccn_fused.promote_contract_18(cb.chi_idx, cb.nbr, f, cb.deg, cb.row_mask,
                                   cb.rslot, compat=False)
     * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda ff: (jfused.promote_contract_18_pallas(
        jb.chi_idx, jb.nbr, ff, jb.deg, jb.row_mask, rslot=jb.rslot,
        compat=False, halo=32, interpret=True) * w).sum())(jnp.asarray(f0))
    _assert_grad_close(f.grad.numpy(), want)


@pytest.mark.parametrize("order", [1, 2])
def test_promote_gather_backward_matches_autograd(batches, order):
    """promote_*(rslot=) backward (the gather) == torch autograd through
    the plain indexing (a scatter-add), and both forwards agree."""
    cb, _ = batches
    V, K = cb.nbr.shape
    promote = P.promote_1d if order == 1 else P.promote_2d
    tail = (3,) if order == 1 else (K, 3)
    f0 = torch.from_numpy(_masked(cb, tail, 11))
    w = torch.from_numpy(_randn((V, K) + (K,) * order + (3,), 12))
    grads = []
    for rslot in (None, cb.rslot):
        f = f0.clone().requires_grad_()
        t = promote(cb.chi_idx, cb.nbr, f, rslot=rslot)
        (t * w).sum().backward()
        grads.append((t.detach(), f.grad))
    np.testing.assert_array_equal(grads[0][0].numpy(), grads[1][0].numpy())
    _assert_grad_close(grads[1][1].numpy(), grads[0][1].numpy())


@pytest.mark.parametrize("C", [1, 2, 5, 16, 64, 256, 1024])
@pytest.mark.parametrize("K", range(1, ccn_fused.MAX_K + 1))
def test_k2_tile_geometry(K, C):
    """K2's tile (ccn_fused._k12_tile, shared with K1): one thread
    per (vertex, slot, channel), at least K (one vertex's slots at one
    channel) and at most the kernel's 256 a block; K floats a thread in
    shared memory (slot k's share of df[v, :, c]), within 48 KB
    without an opt-in (and the H100's 227 KB); every channel in exactly
    one tile, and all of them in one where K * C fits the block."""
    vt, ct, smem = ccn_fused._k12_tile(K, C)
    assert vt >= 1 and 1 <= ct <= C
    assert K <= vt * K * ct <= ccn_fused.K12_THREADS == 256
    assert smem == 4 * vt * K * ct * K <= 48 * 1024 <= 227 * 1024
    covered = [c for c0 in range(0, C, ct) for c in range(c0, min(c0 + ct, C))]
    assert covered == list(range(C))
    assert (ct == C) == (K * C <= 256)
    # the kernel's block-local indices are ints, and the channel tiles
    # are the grid's y axis (at most 65,535 blocks)
    assert vt * K * K * ct < 2 ** 31 and -(-C // ct) <= 65535


@pytest.mark.parametrize("K", range(1, ccn_fused.MAX_K + 1))
def test_k4_tile_geometry(K):
    """K4's tile (ccn_fused._k4_tile) at the widths 1, 2, 5, 18 and 256:
    one thread per (vertex, slot, channel), at least K (one vertex's slots
    at one channel) and at most the kernel's 128 a block; K^2 floats a
    thread in shared memory (its slot's share of df[v, :, :, c]), within
    48 KB without an opt-in; every channel in exactly one tile, and all of
    them in one where K * C fits the block; and no limit on V, whose
    tiles are the grid's x axis, nor on C, whose tiles are its y axis (at
    most 65,535 blocks)."""
    for C in (1, 2, 5, 18, 256):
        vt, ct, smem = ccn_fused._k4_tile(K, C)
        threads = vt * K * ct
        assert vt >= 1 and 1 <= ct <= C, (K, C)
        assert K <= threads <= ccn_fused.K4_THREADS == 128, (K, C)
        assert smem == 4 * threads * K * K <= 48 * 1024, (K, C)
        covered = [c for c0 in range(0, C, ct) for c in range(c0, min(c0 + ct, C))]
        assert covered == list(range(C)), (K, C)
        assert (ct == C) == (K * C <= 128), (K, C)
        assert -(-(2 ** 31 - 1) // vt) < 2 ** 31 and -(-C // ct) <= 65535, (K, C)


def test_backward_wrappers_validate_inputs(batches):
    cb, _ = batches
    V, K = cb.nbr.shape
    g = torch.zeros((V, K, 4))
    with pytest.raises(TypeError, match="rslot"):
        ccn_fused.fused_contract_1d_backward(cb.chi_idx, cb.rslot.long(), cb.nbr, g)
    with pytest.raises(ValueError, match=r"\(V, K, 2C\)"):
        ccn_fused.fused_contract_1d_backward(cb.chi_idx, cb.rslot, cb.nbr,
                                             torch.zeros((V, K, 3)))
    with pytest.raises(ValueError, match=r"\(V, K, K, 18C\)"):
        ccn_fused.fused_contract_backward(cb.chi_idx, cb.rslot, cb.nbr,
                                          torch.zeros((V, K, K, 5)), cb.deg,
                                          cb.row_mask)
    assert ccn_fused.fused_contract_1d_backward.launches == 0
    assert ccn_fused.fused_contract_backward.launches == 0
