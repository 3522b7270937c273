"""The port's CCN data path and fused-op wrappers against the JAX package,
on the CPU (where the wrappers run their plain PyTorch versions).

Records and batch tables must be bit-equal. The fused ops are held to
JAX's closed forms and to its Pallas kernels in interpret mode at
atol = rtol = 1e-5: both sides are f32 gathers and sums that differ only
in summation order."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import ccn as jccn
from hgnn2_tpu.ops import contractions as jC
from hgnn2_tpu.ops import sparse as jsparse
from hgnn2_tpu.ops.pallas import ccn_fused as jfused

from hgnn2_torch.data import qm9
from hgnn2_torch.nn import ccn
from hgnn2_torch.ops import ccn_fused, sparse

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def records():
    return qm9.synthetic_qm9_like(20, seed=0)


@pytest.fixture(scope="module")
def batches(records):
    """The same 20 molecules batched by both packages."""
    jrecs = jqm9.synthetic_qm9_like(20, seed=0)
    return (ccn.make_ccn_batch(records, task=0, device="cpu"),
            jccn.make_ccn_batch(jrecs, task=0))


def _features(cb, shape_tail, seed):
    rng = np.random.default_rng(seed)
    V, K = cb.chi_idx.shape[:2]
    m = cb.row_mask.numpy()
    mask = m[:, :, None] if len(shape_tail) == 1 else m[:, :, None, None] * m[:, None, :, None]
    return (rng.standard_normal((V, K) + shape_tail).astype(np.float32) * mask)


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_records_bit_equal(seed):
    mine = qm9.synthetic_qm9_like(15, seed=seed)
    ref = jqm9.synthetic_qm9_like(15, seed=seed)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        for field in ("x", "adj", "y"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        assert a.n_nodes == b.n_nodes and a.max_degree() == b.max_degree()
    np.testing.assert_array_equal(qm9.rng_structural_mix(),
                                  jqm9.rng_structural_mix())


@pytest.mark.parametrize("padded", [False, True])
def test_make_ccn_batch_fields_equal(records, padded):
    jrecs = jqm9.synthetic_qm9_like(20, seed=0)
    kw = dict(k_max=6, vertex_capacity=512, batch_size=24) if padded else {}
    mine = ccn.make_ccn_batch(records, task=0, device="cpu", **kw)
    ref = jccn.make_ccn_batch(jrecs, task=0, **kw)
    assert mine.n_graphs == ref.n_graphs
    for field in dataclasses.fields(mine):
        if field.name == "n_graphs":
            continue
        t, want = getattr(mine, field.name), np.asarray(getattr(ref, field.name))
        name = field.name
        assert t.device.type == "cpu"
        assert t.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(t.numpy(), want, err_msg=name)


def test_graph_readout_matches_segment_sum(batches):
    cb, jb = batches
    x = np.random.default_rng(2).standard_normal((cb.x.shape[0], 3)).astype(np.float32)
    got = sparse.graph_readout(torch.from_numpy(x), cb.gid, cb.n_graphs)
    want = jsparse.graph_readout(jnp.asarray(x), jb.gid, jb.n_graphs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("C", [5, 2])
def test_fused_1d_matches_jax(batches, C):
    cb, jb = batches
    f = _features(cb, (C,), seed=C)
    got = ccn_fused.fused_contract_1d_forward(cb.chi_idx, cb.nbr, torch.from_numpy(f))
    closed = jC.contract_1d(jC.promote_1d(jb.chi_idx, jb.nbr, jnp.asarray(f)))
    pallas = jfused.fused_contract_1d_forward(jb.chi_idx, jb.nbr, jnp.asarray(f),
                                              halo=32, interpret=True)
    assert got.shape == (cb.x.shape[0], cb.nbr.shape[1], 2 * C)
    np.testing.assert_allclose(got.numpy(), np.asarray(closed), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("compat", [False, True])
def test_fused_2d_matches_jax(batches, compat):
    cb, jb = batches
    f = _features(cb, (cb.nbr.shape[1], 3), seed=11)
    got = ccn_fused.fused_contract_forward(
        cb.chi_idx, cb.nbr, torch.from_numpy(f), cb.deg, cb.row_mask, compat=compat)
    closed = jC.contract_18(jC.promote_2d(jb.chi_idx, jb.nbr, jnp.asarray(f)),
                            jb.deg, jb.row_mask, compat=compat)
    pallas = jfused.fused_contract_forward(
        jb.chi_idx, jb.nbr, jnp.asarray(f), jb.deg, jb.row_mask, compat=compat,
        halo=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(closed), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    # padding rows (gid == B) come out exactly zero
    pad = (cb.gid == cb.n_graphs).numpy()
    if pad.any():
        assert not got.numpy()[pad].any()


@pytest.mark.parametrize("two_d", [False, True])
def test_kernel_rejects_high_k(two_d):
    K = ccn_fused.MAX_K + 1
    chi = torch.zeros((4, K, K), dtype=torch.int32)
    nbr = torch.zeros((4, K), dtype=torch.int32)
    with pytest.raises(ValueError, match="K=9"):
        if two_d:
            ccn_fused.fused_contract_forward(
                chi, nbr, torch.zeros((4, K, K, 1)), torch.zeros(4),
                torch.zeros((4, K)))
        else:
            ccn_fused.fused_contract_1d_forward(chi, nbr, torch.zeros((4, K, 1)))


def test_wrappers_validate_inputs(batches):
    cb, _ = batches
    V, K = cb.nbr.shape
    f = torch.zeros((V, K, 2))
    with pytest.raises(TypeError, match="nbr"):
        ccn_fused.fused_contract_1d_forward(cb.chi_idx, cb.nbr.long(), f)
    with pytest.raises(TypeError, match="f must be float32"):
        ccn_fused.fused_contract_1d_forward(cb.chi_idx, cb.nbr, f.double())
    with pytest.raises(ValueError, match="chi_idx must be"):
        ccn_fused.fused_contract_1d_forward(cb.chi_idx[:-1], cb.nbr, f)
    # a tensor that is neither on the CPU nor on CUDA is refused, never
    # routed to the plain version
    with pytest.raises(ValueError, match="unsupported device"):
        ccn_fused.fused_contract_1d_forward(
            cb.chi_idx.to("meta"), cb.nbr.to("meta"), f.to("meta"))
    assert ccn_fused.fused_contract_1d_forward.launches == 0
    assert ccn_fused.fused_contract_forward.launches == 0


def test_use_kernel_rule():
    assert ccn_fused.use_kernel(5, "cuda")
    assert ccn_fused.use_kernel(8, "cuda")
    assert not ccn_fused.use_kernel(9, "cuda")
    assert not ccn_fused.use_kernel(5, "cpu")
