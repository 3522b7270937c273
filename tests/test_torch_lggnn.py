"""The port's dense line-graph GNN path against the JAX package, on the
CPU: line-graph dense batches and the dense loader's line-graph batches
(bit-equal), the edge operators of ops/dense.py with padding included,
DenseBundle's index-form exchange against JAX's one-hot and fused
bundles, the materialized bundle, the dense operator oracles (bit-equal,
the original implementation's buggy builder included), GNNLineGraph in
train and eval mode with its node and edge BN running stats, a line-graph
layer's whole outputs (padded rows included), bf16 against f32, and the
flax converter. Weights are JAX's init, carried over by
hgnn2_torch.convert.

Tolerances: the edge operators within atol = rtol = 1e-6 (f32 matmuls
and sums in another order); the exchange against JAX's fused bundle
within 1e-5 x max |value| (its matmuls also sum the zero blocks);
GNNLineGraph and its layers within 1e-5 x max |value| (differences
compound over the layers and BN's division by the batch std); bf16
within 5 % of mean |f32 output| (the bar of tests/test_precision.py).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from hgnn2_tpu import graphs as jgraphs
from hgnn2_tpu import operators as joperators
from hgnn2_tpu.data import batching as jbatching
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import bundles as jbundles
from hgnn2_tpu.nn import layers as jlayers
from hgnn2_tpu.nn import models as jmodels
from hgnn2_tpu.ops import dense as jdense

from hgnn2_torch import convert, graphs, operators
from hgnn2_torch.data import batching, qm9
from hgnn2_torch.nn import bundles, layers, models
from hgnn2_torch.ops import dense

torch.set_num_threads(2)

OP_TOL = dict(atol=1e-6, rtol=1e-6)
MODEL_RTOL = 1e-5  # times max |value| of the tensor compared
LG_FIELDS = ("x", "adj", "node_mask", "y", "n_nodes", "lg_src", "lg_dst",
             "lg_w", "lg_rev", "edge_mask", "n_edges")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=MODEL_RTOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, msg
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=msg)


def _assert_bit_equal(db, jdb):
    assert db.has_line_graph and jdb.has_line_graph
    for name in LG_FIELDS:
        got, want = getattr(db, name).numpy(), np.asarray(getattr(jdb, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.fixture(scope="module")
def lg_batch():
    """12 molecules padded to 32 nodes, 64 directed edges and 16 graph
    slots, in both packages."""
    kw = dict(n_max=32, m_max=64, with_line_graph=True, batch_size=16, task=0)
    return (graphs.make_dense_batch(qm9.synthetic_qm9_like(12, seed=4),
                                    device="cpu", **kw),
            jgraphs.make_dense_batch(jqm9.synthetic_qm9_like(12, seed=4), **kw))


def test_make_dense_batch_line_graph_bit_equal(lg_batch):
    """Padded edges hold src = dst = rev = 0, w = 0 and edge_mask 0; the
    default M is the batch's most edges; .to() passes None through."""
    db, jdb = lg_batch
    _assert_bit_equal(db, jdb)
    recs = qm9.synthetic_qm9_like(5, seed=8)
    _assert_bit_equal(graphs.make_dense_batch(recs, with_line_graph=True,
                                              device="cpu"),
                      jgraphs.make_dense_batch(jqm9.synthetic_qm9_like(5, seed=8),
                                               with_line_graph=True))
    moved = graphs.make_dense_batch(recs, device="cpu").to("cpu")
    assert not moved.has_line_graph and moved.lg_rev is None
    assert torch.equal(db.to("cpu").lg_rev, db.lg_rev)


@pytest.mark.parametrize("shuffle", [False, True])
def test_dense_loader_line_graph_matches_jax(shuffle):
    """300 molecules at batch 64 with line graphs: the batches and their
    order over 2 epochs inside a CachedLoader; node buckets 16 and 32 and
    edge buckets 32 and 64 all appear."""
    kw = dict(task=0, shuffle=shuffle, seed=3, with_line_graph=True)
    loader = batching.CachedLoader(batching.DenseLoader(
        qm9.synthetic_qm9_like(300, seed=1), 64, device="cpu", **kw),
        shuffle=shuffle, seed=2, redeal_every=1 if shuffle else 0)
    jloader = jbatching.CachedLoader(jbatching.DenseLoader(
        jqm9.synthetic_qm9_like(300, seed=1), 64, **kw),
        shuffle=shuffle, seed=2, redeal_every=1 if shuffle else 0)
    assert batching.DEFAULT_EDGE_BUCKETS == jbatching.DEFAULT_EDGE_BUCKETS
    n_buckets, m_buckets = set(), set()
    for _ in range(2):
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == 5
        for db, jdb in zip(got, want):
            _assert_bit_equal(db, jdb)
            n_buckets.add(db.x.shape[1])
            m_buckets.add(db.lg_src.shape[1])
    assert n_buckets == {16, 32} and m_buckets == {32, 64}


def _edge_inputs(db, jdb, rng, F=3):
    """Scatter matrices of both packages and edge/node features that are
    nonzero at padded rows (so masking and the padded gathers show)."""
    B, M = db.lg_w.shape
    N = db.x.shape[1]
    s_src, s_dst = dense.edge_scatter_matrices(db.lg_src, db.lg_dst,
                                               db.edge_mask, N)
    js_src, js_dst = jdense.edge_scatter_matrices(jdb.lg_src, jdb.lg_dst,
                                                  jdb.edge_mask, N)
    xl = rng.standard_normal((B, M, F)).astype(np.float32)
    x = rng.standard_normal((B, N, F)).astype(np.float32)
    return (s_src, s_dst), (js_src, js_dst), xl, x


def test_edge_ops_match_jax(lg_batch, rng):
    """edge_scatter_matrices (bit-equal), edge_to_node, node_to_edge,
    incidence_(t_)apply both signs, nb_apply and nb_degrees against JAX's
    on whole tensors, padded rows included: a padded edge gathers edge 0
    through rev = 0, so its nb_apply row is -w[0] xl[0]."""
    db, jdb = lg_batch
    (s_src, s_dst), (js_src, js_dst), xl, x = _edge_inputs(db, jdb, rng)
    np.testing.assert_array_equal(s_src.numpy(), np.asarray(js_src))
    np.testing.assert_array_equal(s_dst.numpy(), np.asarray(js_dst))
    txl, tx = torch.from_numpy(xl), torch.from_numpy(x)
    np.testing.assert_allclose(dense.edge_to_node(s_dst, txl).numpy(),
                               np.asarray(jdense.edge_to_node(js_dst, xl)), **OP_TOL)
    np.testing.assert_allclose(dense.node_to_edge(s_src, tx).numpy(),
                               np.asarray(jdense.node_to_edge(js_src, x)), **OP_TOL)
    for signed in (False, True):
        np.testing.assert_allclose(
            dense.incidence_apply(s_src, s_dst, txl, signed).numpy(),
            np.asarray(jdense.incidence_apply(js_src, js_dst, xl, signed)),
            **OP_TOL)
        np.testing.assert_allclose(
            dense.incidence_t_apply(s_src, s_dst, tx, signed).numpy(),
            np.asarray(jdense.incidence_t_apply(js_src, js_dst, x, signed)),
            **OP_TOL)
    got = dense.nb_apply(s_src, s_dst, db.lg_w, db.lg_rev, txl)
    want = np.asarray(jdense.nb_apply(js_src, js_dst, jdb.lg_w, jdb.lg_rev, xl))
    np.testing.assert_allclose(got.numpy(), want, **OP_TOL)
    b, m = 0, int(db.n_edges[0])  # a padded edge of graph 0
    np.testing.assert_allclose(got[b, m].numpy(),
                               -db.lg_w[b, 0].item() * xl[b, 0], **OP_TOL)
    assert np.abs(want[:12][np.asarray(jdb.edge_mask)[:12] == 0]).max() > 0
    dl = dense.nb_degrees(s_src, s_dst, db.lg_w, db.lg_rev.long())
    np.testing.assert_allclose(
        dl.numpy(),
        np.asarray(jdense.nb_degrees(js_src, js_dst, jdb.lg_w, jdb.lg_rev)),
        **OP_TOL)


@pytest.mark.parametrize("J", [1, 2, 3])
def test_lg_graph_op_matches_jax(lg_batch, rng, J):
    """lg_graph_op with and without the identity block's mask, and
    DenseBundle.lg_graph_op, against JAX's, padded rows included."""
    db, jdb = lg_batch
    (s_src, s_dst), (js_src, js_dst), xl, _ = _edge_inputs(db, jdb, rng)
    dl = dense.nb_degrees(s_src, s_dst, db.lg_w, db.lg_rev) * db.edge_mask
    jdl = jdense.nb_degrees(js_src, js_dst, jdb.lg_w, jdb.lg_rev) * jdb.edge_mask
    for mask in (None, db.edge_mask):
        got = dense.lg_graph_op(s_src, s_dst, db.lg_w, db.lg_rev, dl,
                                torch.from_numpy(xl), J, mask)
        want = jdense.lg_graph_op(js_src, js_dst, jdb.lg_w, jdb.lg_rev, jdl, xl,
                                  J, None if mask is None else jdb.edge_mask)
        assert got.shape == (16, 64, (J + 2) * 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    bundle = bundles.DenseBundle.from_batch(db, J, with_line_graph=True)
    jbundle = jbundles.DenseBundle.from_batch(jdb, J, with_line_graph=True)
    assert bundle.rev.dtype == torch.int32 and bundle.has_line_graph
    np.testing.assert_allclose(bundle.lg_graph_op(torch.from_numpy(xl)).numpy(),
                               np.asarray(jbundle.lg_graph_op(xl)), **OP_TOL)
    np.testing.assert_allclose(bundle.edge_features().numpy(),
                               np.asarray(jbundle.edge_features()), **OP_TOL)
    assert not bundles.DenseBundle.from_batch(db, J).has_line_graph


def test_fused_bundle_matches_unfused_and_jax(lg_batch, rng):
    """The port's update inputs at J = 2, [graph_op x | pm_pd xl] and
    [lg_graph_op xl | pm_pd_t x], against JAX's FusedLGBundle node_input
    and edge_input, with equal widths and with the first layer's
    mismatched ones (x 5 wide, xl 1)."""
    db, jdb = lg_batch
    b = bundles.DenseBundle.from_batch(db, 2, with_line_graph=True)
    jb = jbundles.DenseBundle.from_batch(jdb, 2, with_line_graph=True)
    jfb = jbundles.FusedLGBundle.from_dense(jb)
    B, N, M = db.x.shape[0], db.x.shape[1], db.lg_src.shape[1]
    for fx, fl in ((3, 3), (5, 1)):
        x = torch.from_numpy(rng.standard_normal((B, N, fx)).astype(np.float32))
        xl = torch.from_numpy(rng.standard_normal((B, M, fl)).astype(np.float32))
        _close(torch.cat([b.graph_op(x), b.pm_pd(xl)], -1),
               jfb.node_input(x.numpy(), xl.numpy()))
        _close(torch.cat([b.lg_graph_op(xl), b.pm_pd_t(x)], -1),
               jfb.edge_input(x.numpy(), xl.numpy()))


def _materialized(recs, N, M, J):
    """MaterializedBundle over the port's dense operator builders, padded
    to (N, M) with zeros."""
    B = len(recs)
    W = np.zeros((B, N, N, J + 2), np.float32)
    WL = np.zeros((B, M, M, J + 2), np.float32)
    Pm = np.zeros((B, N, M), np.float32)
    Pd = np.zeros((B, N, M), np.float32)
    for i, r in enumerate(recs):
        n, m = r.n_nodes, r.n_dir_edges
        W[i, :n, :n] = operators.operator_stack_dense(r.adj, J)
        WL[i, :m, :m], Pm[i, :n, :m], Pd[i, :n, :m] = (
            operators.line_graph_operator_stack_dense(r.adj, J))
    return bundles.MaterializedBundle(*map(torch.from_numpy, (W, WL, Pm, Pd)))


@pytest.mark.parametrize("J", [1, 2])
def test_materialized_bundle_matches_dense_bundle(rng, J):
    """The materialized oracle over operators.*_dense and DenseBundle on
    the real rows of every op, and GNNLineGraph through either bundle."""
    recs = qm9.synthetic_qm9_like(10, seed=5)
    db = graphs.make_dense_batch(recs, n_max=32, m_max=64,
                                 with_line_graph=True, task=0, device="cpu")
    mb = _materialized(recs, 32, 64, J)
    b = bundles.DenseBundle.from_batch(db, J, with_line_graph=True)
    x = torch.from_numpy(rng.standard_normal((10, 32, 3)).astype(np.float32))
    xl = torch.from_numpy(rng.standard_normal((10, 64, 3)).astype(np.float32))
    nmask, emask = db.node_mask[..., None], db.edge_mask[..., None]
    x, xl = x * nmask, xl * emask  # states are zero at padding in the oracle
    for name, arg, rows in (("graph_op", x, nmask), ("pm_pd", xl, nmask),
                            ("lg_graph_op", xl, emask), ("pm_pd_t", x, emask)):
        got = getattr(b, name)(arg) * rows
        np.testing.assert_allclose(got.numpy(), getattr(mb, name)(arg).numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(b.edge_features().numpy(),
                               mb.edge_features().numpy(), atol=1e-6)
    m = models.GNNLineGraph(in_features=5, n_features=2, n_layers=3, J=J,
                            order=2, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        _close(m.train()(db, bundle=mb), m.train()(db))


@pytest.mark.parametrize("n,p,J", [(6, 0.5, 1), (9, 0.4, 2), (12, 0.3, 3)])
def test_dense_operator_oracles_bit_equal(rng, n, p, J):
    """The dense builders equal JAX's bit for bit, line_graph_dense_compat
    (the original implementation's overwritten edge slots) included."""
    a = (rng.random((n, n)) < p).astype(np.float32)
    a *= rng.integers(1, 4, size=(n, n)).astype(np.float32)
    a = np.triu(a, k=1)
    a[0, 1] = max(a[0, 1], 1.0)
    A = a + a.T
    lg, jlg = operators.build_line_graph(A), joperators.build_line_graph(A)
    pairs = [(operators.degrees(A), joperators.degrees(A)),
             (operators.operator_stack_dense(A, J),
              joperators.operator_stack_dense(A, J)),
             (operators.nb_adjacency_dense(lg), joperators.nb_adjacency_dense(jlg)),
             *zip(operators.incidence_dense(lg, n),
                  joperators.incidence_dense(jlg, n)),
             *zip(operators.line_graph_operator_stack_dense(A, J),
                  joperators.line_graph_operator_stack_dense(A, J)),
             *zip(operators.line_graph_dense_compat(A, J),
                  joperators.line_graph_dense_compat(A, J))]
    for got, want in pairs:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _models(jdb, in_features, dtype=None, **kw):
    """A flax GNNLineGraph and the port's, both with JAX's init; fused_ops
    is JAX's option (the port's exchange has one form)."""
    compat = kw.pop("compat", False)
    jm = jmodels.GNNLineGraph(
        compat=jlayers.CompatConfig.reference() if compat else jlayers.CompatConfig(),
        dtype=None if dtype is None else jnp.bfloat16,
        fused_ops=kw.pop("fused_ops", False), **kw)
    variables = _np(jm.init(jax.random.key(0), jdb, train=True))
    m = models.GNNLineGraph(
        in_features=in_features,
        compat=layers.CompatConfig.reference() if compat else layers.CompatConfig(),
        dtype=dtype, **kw)
    m.load_state_dict(convert.dense_variables_from_flax(variables))
    return jm, variables, m


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("order,J,compat,fused", [
    (1, 1, False, False), (2, 1, False, False), (3, 2, False, False),
    (2, 2, True, False), (1, 1, False, True), (2, 1, True, True)])
def test_gnn_line_graph_matches_jax(lg_batch, order, J, compat, fused):
    """L=3 h=2: a train-mode forward (batch statistics), the node and edge
    BN running stats it leaves, and an eval-mode forward from them, against
    JAX's model with fused_ops off and on. Under compat the padded rows
    leak through BN and the readout adds bias x N."""
    db, jdb = lg_batch
    jm, variables, m = _models(jdb, 5, n_features=2, n_layers=3, J=J,
                               order=order, compat=compat, fused_ops=fused)
    want, upd = jm.apply(variables, jdb, train=True, mutable=["batch_stats"])
    got = m.train()(db)
    assert got.shape == (16, 1)
    _close(got, want)
    stats = convert.dense_variables_to_flax(m.state_dict())["batch_stats"]
    n_stats = 0
    for path, leaf in _leaves(_np(upd["batch_stats"])):
        mine = stats
        for k in path:
            mine = mine[k]
        _close(mine, leaf, msg=str(path))
        n_stats += 1
    assert n_stats == 2 * 2 * 2  # 2 layers x node/edge BN x mean/std
    variables = dict(variables, batch_stats=upd["batch_stats"])
    want = jm.apply(variables, jdb, train=False)
    with torch.no_grad():
        got = m.eval()(db)
    _close(got, want)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_lg_layer_whole_outputs_match_jax(lg_batch, rng, order):
    """One line-graph layer's node and edge states, padded rows included,
    under the reference compat flags (BN does not re-zero the padding, so
    the padded edge rows carry what the rev = 0 gathers put there)."""
    db, jdb = lg_batch
    compat = dict(jax=jlayers.CompatConfig.reference(),
                  torch=layers.CompatConfig.reference())
    x = rng.standard_normal((16, 32, 4)).astype(np.float32)
    xl = rng.standard_normal((16, 64, 4)).astype(np.float32)
    jb = jbundles.DenseBundle.from_batch(jdb, 1, with_line_graph=True)
    jl = jlayers.LGLayer(3, order, compat["jax"])
    args = (jb, jnp.asarray(x), jnp.asarray(xl), jdb.node_mask, jdb.edge_mask,
            True)
    variables = _np(jl.init(jax.random.key(2), *args))
    (jz, jzl), _ = jl.apply(variables, *args, mutable=["batch_stats"])
    layer = layers.LGLayer(4, 4, 3, J=1, order=order, compat=compat["torch"])
    layer.load_state_dict(convert.variables_from_flax(variables))
    b = bundles.DenseBundle.from_batch(db, 1, with_line_graph=True)
    z, zl = layer.train()(b, torch.from_numpy(x), torch.from_numpy(xl),
                          db.node_mask, db.edge_mask)
    _close(z, jz)
    _close(zl, jzl)
    assert float(zl.detach()[db.edge_mask == 0].abs().max()) > 0


def test_gnn_line_graph_bf16_close_to_f32(lg_batch):
    """L=4 h=3 in bf16 against f32 on the same weights and against JAX's
    bf16 model; the output and the BN running stats stay f32."""
    db, jdb = lg_batch
    jm, variables, m16 = _models(jdb, 5, dtype=torch.bfloat16, n_features=3,
                                 n_layers=4, J=1, order=2)
    m32 = models.GNNLineGraph(in_features=5, n_features=3, n_layers=4, J=1,
                              order=2)
    m32.load_state_dict(m16.state_dict())
    with torch.no_grad():
        out32, out16 = m32.train()(db), m16.train()(db)
    assert out16.dtype == torch.float32
    scale = float(out32.abs().mean()) + 1e-6
    assert float((out16 - out32).abs().max()) / scale < 0.05
    want, _ = jm.apply(variables, jdb, train=True, mutable=["batch_stats"])
    assert float((out16 - torch.tensor(np.asarray(want))).abs().max()) / scale < 0.05
    assert all(v.dtype == torch.float32 for v in m16.state_dict().values())


def test_line_graph_convert_round_trip(lg_batch):
    """flax -> state_dict -> flax gives the same nested tree for
    GNNLineGraph, scalar-affine BN included."""
    _, jdb = lg_batch
    _, variables, m = _models(jdb, 5, n_features=2, n_layers=3, J=2, order=1,
                              compat=True)
    back = convert.dense_variables_to_flax(m.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(variables)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        mine = back
        for p in path:
            mine = mine[p.key]
        np.testing.assert_array_equal(mine, leaf)
    assert back["params"]["layer1"]["edge_bn"]["scale"].shape == ()
    assert "layer0.node_cv1.weight" in m.state_dict()
