"""The port's dense power-GNN path against the JAX package, on the CPU:
dense batches and the dense loader's batches and order (bit-equal), the
collinear-points set (equal records), graph_op, spatial normalization
and the GRU update, GNNSimple in train and eval mode with its BN running
stats, bf16 against f32, the flax converter, and GNNSimple against the
port's PackedGNN. Weights are JAX's init, carried over by
hgnn2_torch.convert.

Tolerances: graph_op, the GRU update and spatial normalization within
1e-6 (f32 matmuls and sums in another order); GNNSimple within 1e-5
(differences compound over the layers, BN's division by the batch std
and the readout sum); bf16 within 5 % of mean |f32 output| (the bar of
tests/test_precision.py); GNNSimple against PackedGNN within 2e-4 (the
bar of tests/test_packed_models.py: dense matmuls against segment sums).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from hgnn2_tpu import graphs as jgraphs
from hgnn2_tpu.data import batching as jbatching
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.data import synthetic as jsynthetic
from hgnn2_tpu.nn import bundles as jbundles
from hgnn2_tpu.nn import layers as jlayers
from hgnn2_tpu.nn import models as jmodels
from hgnn2_tpu.ops import dense as jdense

from hgnn2_torch import convert, graphs
from hgnn2_torch.data import batching, qm9, synthetic
from hgnn2_torch.nn import layers, models, packed
from hgnn2_torch.nn.bundles import DenseBundle
from hgnn2_torch.ops import dense

torch.set_num_threads(2)

OP_TOL = dict(atol=1e-6, rtol=1e-6)
MODEL_TOL = dict(atol=1e-5, rtol=1e-5)
DB_FIELDS = ("x", "adj", "node_mask", "y", "n_nodes")
LG_FIELDS = ("lg_src", "lg_dst", "lg_w", "lg_rev", "edge_mask", "n_edges")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_bit_equal(db, jdb):
    for name in DB_FIELDS:
        got, want = getattr(db, name).numpy(), np.asarray(getattr(jdb, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert not db.has_line_graph and db.batch_size == jdb.batch_size


@pytest.fixture(scope="module")
def dense_batch():
    """12 molecules padded to 32 nodes and 16 graph slots."""
    kw = dict(n_max=32, batch_size=16, task=0)
    return (graphs.make_dense_batch(qm9.synthetic_qm9_like(12, seed=4),
                                    device="cpu", **kw),
            jgraphs.make_dense_batch(jqm9.synthetic_qm9_like(12, seed=4), **kw))


@pytest.mark.parametrize("data", ["qm9", "collinear"])
def test_make_dense_batch_bit_equal(dense_batch, data):
    """Node and graph-count padding with one task column (float targets),
    and unpadded int labels."""
    if data == "qm9":
        db, jdb = dense_batch
    else:
        recs = synthetic.three_collinear_points(7, n_max=12, seed=5)
        jrecs = jsynthetic.three_collinear_points(7, n_max=12, seed=5)
        db = graphs.make_dense_batch(recs, device="cpu")
        jdb = jgraphs.make_dense_batch(jrecs)
        assert db.y.dtype == torch.int32
    _assert_bit_equal(db, jdb)
    moved = db.to("cpu")
    assert all(torch.equal(getattr(moved, f), getattr(db, f)) for f in DB_FIELDS)
    lgb = graphs.make_dense_batch(qm9.synthetic_qm9_like(2), with_line_graph=True,
                                  device="cpu")
    jlgb = jgraphs.make_dense_batch(jqm9.synthetic_qm9_like(2), with_line_graph=True)
    assert lgb.has_line_graph and jlgb.has_line_graph
    for name in DB_FIELDS + LG_FIELDS:
        got, want = getattr(lgb, name).numpy(), np.asarray(getattr(jlgb, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_three_collinear_points_matches_jax():
    kw = dict(n_max=20, dim=4, p=0.6, c=0.4, seed=9)
    recs = synthetic.three_collinear_points(25, **kw)
    jrecs = jsynthetic.three_collinear_points(25, **kw)
    assert len(recs) == len(jrecs) == 25
    for r, jr in zip(recs, jrecs):
        for f in ("x", "adj", "y"):
            got, want = np.asarray(getattr(r, f)), np.asarray(getattr(jr, f))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shuffle", [False, True])
def test_dense_loader_matches_jax(shuffle):
    """300 molecules at batch 64 (node buckets 16 and 32 both appear): the
    batches and their order over 2 epochs, inside a CachedLoader."""
    kw = dict(task=0, shuffle=shuffle, seed=3)
    loader = batching.CachedLoader(batching.DenseLoader(
        qm9.synthetic_qm9_like(300, seed=1), 64, device="cpu", **kw),
        shuffle=shuffle, seed=2, redeal_every=1 if shuffle else 0)
    jloader = jbatching.CachedLoader(jbatching.DenseLoader(
        jqm9.synthetic_qm9_like(300, seed=1), 64, **kw),
        shuffle=shuffle, seed=2, redeal_every=1 if shuffle else 0)
    assert len(loader) == len(jloader) == 5
    buckets = set()
    for _ in range(2):
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == 5
        for db, jdb in zip(got, want):
            _assert_bit_equal(db, jdb)
            buckets.add(db.x.shape[1])
    assert buckets == {16, 32}


@pytest.mark.parametrize("J", [1, 2, 3])
def test_graph_op_matches_jax(dense_batch, J, rng):
    """graph_op with and without the identity block's mask, on features
    that are nonzero at padded nodes (so the mask matters), against JAX's
    graph_op and the materialized operator stack."""
    db, jdb = dense_batch
    x = rng.standard_normal(db.x.shape[:2] + (3,)).astype(np.float32)
    ap, deg = dense.adjacency_powers(db.adj, J), dense.degrees(db.adj)
    jap, jdeg = jdense.adjacency_powers(jdb.adj, J), jdense.degrees(jdb.adj)
    np.testing.assert_allclose(ap.numpy(), np.asarray(jap), **OP_TOL)
    for mask in (None, db.node_mask):
        got = dense.graph_op(ap, deg, torch.from_numpy(x), mask)
        want = jdense.graph_op(jap, jdeg, jnp.asarray(x),
                               None if mask is None else jdb.node_mask)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    eye = torch.eye(db.x.shape[1]) * db.node_mask[:, :, None]
    W = torch.stack([eye, torch.diag_embed(deg), *ap.unbind(1)], dim=-1)
    np.testing.assert_allclose(dense.graph_op_materialized(W, torch.from_numpy(x)).numpy(),
                               got.numpy(), **OP_TOL)
    bundle = DenseBundle.from_batch(db, J)
    np.testing.assert_allclose(bundle.graph_op(torch.from_numpy(x)).numpy(),
                               got.numpy(), **OP_TOL)
    # the line-graph side of the bundle on the same molecules
    kw = dict(n_max=32, with_line_graph=True, batch_size=16, task=0)
    lgb = DenseBundle.from_batch(graphs.make_dense_batch(
        qm9.synthetic_qm9_like(12, seed=4), device="cpu", **kw), J,
        with_line_graph=True)
    jlgb = jbundles.DenseBundle.from_batch(jgraphs.make_dense_batch(
        jqm9.synthetic_qm9_like(12, seed=4), **kw), J, with_line_graph=True)
    xl = rng.standard_normal(lgb.w.shape + (3,)).astype(np.float32)
    np.testing.assert_allclose(lgb.lg_graph_op(torch.from_numpy(xl)).numpy(),
                               np.asarray(jlgb.lg_graph_op(jnp.asarray(xl))),
                               **OP_TOL)


def test_gru_update_and_spatial_normalization_match_jax(rng):
    x = rng.standard_normal((4, 7, 9)).astype(np.float32)
    h = rng.standard_normal((4, 7, 6)).astype(np.float32)
    mask = (rng.random((4, 7)) < 0.7).astype(np.float32)
    mask[3] = 0.0  # a padding graph: count clamps to 1
    jgru = jlayers.GRUUpdate(6)
    variables = jgru.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(h))
    gru = layers.GRUUpdate(9, 6)
    gru.load_state_dict(convert.variables_from_flax(_np(variables)))
    np.testing.assert_allclose(
        gru(torch.from_numpy(x), torch.from_numpy(h)).detach().numpy(),
        np.asarray(jgru.apply(variables, jnp.asarray(x), jnp.asarray(h))),
        **OP_TOL)
    np.testing.assert_allclose(
        layers.spatial_normalization(torch.from_numpy(x), torch.from_numpy(mask)).numpy(),
        np.asarray(jlayers.spatial_normalization(jnp.asarray(x), jnp.asarray(mask))),
        **OP_TOL)


def _models(jdb, in_features, dtype=None, **kw):
    """A flax GNNSimple and the port's, both with JAX's init."""
    compat = kw.pop("compat", False)
    jm = jmodels.GNNSimple(
        compat=jlayers.CompatConfig.reference() if compat else jlayers.CompatConfig(),
        dtype=None if dtype is None else jnp.bfloat16, **kw)
    variables = _np(jm.init(jax.random.key(0), jdb, train=True))
    m = models.GNNSimple(
        in_features=in_features,
        compat=layers.CompatConfig.reference() if compat else layers.CompatConfig(),
        dtype=dtype, **kw)
    m.load_state_dict(convert.dense_variables_from_flax(variables))
    return jm, variables, m


@pytest.mark.parametrize("J,gru,compat", [
    (1, False, False), (2, True, False), (1, True, True), (2, False, True)])
def test_gnn_simple_matches_jax(dense_batch, J, gru, compat):
    """L=3 h=3: a train-mode forward (batch statistics), the BN running
    stats it leaves, and an eval-mode forward from them. Under compat the
    padded rows leak through BN and the readout adds bias x N."""
    db, jdb = dense_batch
    jm, variables, m = _models(jdb, 5, n_features=3, n_layers=3, J=J, gru=gru,
                               compat=compat)
    want, upd = jm.apply(variables, jdb, train=True, mutable=["batch_stats"])
    got = m.train()(db)
    assert got.shape == (16, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODEL_TOL)
    stats = convert.dense_variables_to_flax(m.state_dict())["batch_stats"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(_np(upd["batch_stats"])):
        keys = [p.key for p in path]
        mine = stats
        for k in keys:
            mine = mine[k]
        np.testing.assert_allclose(mine, leaf, **MODEL_TOL, err_msg=str(keys))
    variables = dict(variables, batch_stats=upd["batch_stats"])
    want = jm.apply(variables, jdb, train=False)
    with torch.no_grad():
        got = m.eval()(db)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_gnn_simple_bf16_close_to_f32(dense_batch):
    """bf16 compute against f32 on the same weights, and against JAX's
    bf16 model; the output and the BN running stats stay f32."""
    db, jdb = dense_batch
    jm, variables, m16 = _models(jdb, 5, dtype=torch.bfloat16, n_features=3,
                                 n_layers=4, J=1)
    m32 = models.GNNSimple(in_features=5, n_features=3, n_layers=4, J=1)
    m32.load_state_dict(m16.state_dict())
    with torch.no_grad():
        out32, out16 = m32.train()(db), m16.train()(db)
    assert out16.dtype == torch.float32
    scale = float(out32.abs().mean()) + 1e-6
    assert float((out16 - out32).abs().max()) / scale < 0.05
    want, _ = jm.apply(variables, jdb, train=True, mutable=["batch_stats"])
    assert float((out16 - torch.tensor(np.asarray(want))).abs().max()) / scale < 0.05
    assert all(v.dtype == torch.float32 for v in m16.state_dict().values())


def test_dense_convert_round_trip(dense_batch):
    """flax -> state_dict -> flax gives the same nested tree, GRU and
    scalar-affine BN included."""
    _, jdb = dense_batch
    _, variables, m = _models(jdb, 5, n_features=2, n_layers=3, J=2, gru=True,
                              compat=True)
    back = convert.dense_variables_to_flax(m.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(variables)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        mine = back
        for p in path:
            mine = mine[p.key]
        np.testing.assert_array_equal(mine, leaf)
    assert back["params"]["layer0"]["bn"]["scale"].shape == ()
    assert "layer0.gru.ih.weight" in m.state_dict()


def test_gnn_simple_matches_packed_gnn():
    """The port's GNNSimple on a dense batch and its PackedGNN on a packed
    batch of the same molecules, with the same weights under the packed
    models' names."""
    recs = qm9.synthetic_qm9_like(6, seed=0)
    db = graphs.make_dense_batch(recs, task=0, device="cpu")
    pb = graphs.make_packed_batch(recs, task=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    m = models.GNNSimple(in_features=5, n_features=3, n_layers=3, J=2,
                         generator=gen)
    mp = packed.PackedGNN(n_features=3, n_layers=3, in_features=5, J=2)
    # layer0.cv1.weight -> layer0_cv1.weight, layerlast.fc.bias -> fc.bias
    state = {}
    for k, v in m.state_dict().items():
        module, sub, field = k.split(".")
        state[f"{sub}.{field}" if module == "layerlast" else
              f"{module}_{sub}.{field}"] = v
    mp.load_state_dict(state)
    np.testing.assert_allclose(mp.train()(pb).detach().numpy(),
                               m.train()(db).detach().numpy(), atol=2e-4)
