"""CCN-1D and CCN-2D end to end: the port's models with flax-initialised
weights carried over by hgnn2_torch.convert, against the JAX models'
eval forward with the Pallas kernels in interpret mode.

Tolerance rtol = 1e-4, atol = 1e-5: the layers chain f32 gathers, sums and
Linear products whose summation order differs between the two packages,
and the differences compound over the layers and the readout."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import torch

from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import ccn as jccn

from hgnn2_torch import convert
from hgnn2_torch.data import qm9
from hgnn2_torch.nn import ccn

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def batches():
    recs = qm9.synthetic_qm9_like(20, seed=1)
    jrecs = jqm9.synthetic_qm9_like(20, seed=1)
    kw = dict(task=0, vertex_capacity=256, batch_size=24)
    return ccn.make_ccn_batch(recs, device="cpu", **kw), jccn.make_ccn_batch(jrecs, **kw)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port(model_cls, variables, **kw):
    model = model_cls(**kw)
    model.load_state_dict(convert.ccn_params_from_flax(_numpy_tree(variables)))
    return model.eval()


@pytest.mark.parametrize("kernel", [False, True])
def test_ccn1d_matches_jax(batches, kernel):
    cb, jb = batches
    base = jccn.CCN1D(hidden=2, n_layers=3)
    variables = base.init(jax.random.key(0), jb, train=False)
    fused = jccn.CCN1D(hidden=2, n_layers=3, pallas_kernel=True,
                       kernel_halo=32, interpret=True)
    want = np.asarray(fused.apply(variables, jb, train=False))
    model = _port(ccn.CCN1D, variables, n_features=5, hidden=2, n_layers=3,
                  kernel=kernel)
    with torch.inference_mode():
        got = model(cb).numpy()
    assert got.shape == want.shape == (24, 1)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("compat", [False, True])
def test_ccn2d_matches_jax(batches, compat):
    cb, jb = batches
    base = jccn.CCN2D(hidden=2, n_layers=2, compat_contractions=compat)
    variables = base.init(jax.random.key(1), jb, train=False)
    fused = jccn.CCN2D(hidden=2, n_layers=2, compat_contractions=compat,
                       pallas_kernel=True, kernel_halo=32, interpret=True)
    want = np.asarray(fused.apply(variables, jb, train=False))
    model = _port(ccn.CCN2D, variables, n_features=5, hidden=2, n_layers=2,
                  kernel=True, compat_contractions=compat)
    with torch.inference_mode():
        got = model(cb).numpy()
    assert got.shape == want.shape == (24, 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_ref_init_draws_n0_01():
    gen = torch.Generator().manual_seed(0)
    model = ccn.CCN1D(n_features=5, hidden=64, n_layers=2, generator=gen)
    w = torch.cat([p.detach().flatten() for p in model.parameters()])
    assert abs(float(w.mean())) < 0.01
    assert abs(float(w.std()) - 0.1) < 0.01
