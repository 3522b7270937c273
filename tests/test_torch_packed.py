"""The port's packed path against the JAX package, on the CPU: line graphs
and packed batches (bit-equal), the segment-sum operators, MaskedBatchNorm
and the packed models PackedLGGNN / PackedGNN with flax-initialised
weights carried over by hgnn2_torch.convert.

Tolerances: the operators within atol 1e-6 and MaskedBatchNorm within
1e-6 (f32 gathers and sums in another order); the models within atol
1e-5, since the differences compound over the layers, BatchNorm's
division by the batch std and the readout."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from hgnn2_tpu import graphs as jgraphs
from hgnn2_tpu import operators as joperators
from hgnn2_tpu.cli import common as jcommon
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import layers as jlayers
from hgnn2_tpu.nn import packed as jpacked
from hgnn2_tpu.ops import sparse as jsparse
from hgnn2_tpu.parallel import spmd as jspmd
from hgnn2_tpu.training.config import TrainConfig as JTrainConfig

from hgnn2_torch import convert, graphs, operators
from hgnn2_torch.cli import common
from hgnn2_torch.data import qm9
from hgnn2_torch.nn import layers, packed
from hgnn2_torch.ops import sparse
from hgnn2_torch.parallel import spmd
from hgnn2_torch.training.config import TrainConfig

from tests.conftest import random_adjacency

torch.set_num_threads(2)

OP_TOL = dict(atol=1e-6, rtol=1e-6)
BN_TOL = dict(atol=1e-6, rtol=1e-6)
MODEL_TOL = dict(atol=1e-5, rtol=1e-5)
PB_FIELDS = ("x", "node_gid", "node_mask", "src", "dst", "w", "rev",
             "edge_gid", "edge_mask", "y", "gmask")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def batches():
    """9 molecules with node/edge padding and 12 graph slots."""
    recs = qm9.synthetic_qm9_like(9, seed=3)
    jrecs = jqm9.synthetic_qm9_like(9, seed=3)
    kw = dict(node_capacity=200, edge_capacity=320, task=0, batch_size=12)
    return (graphs.make_packed_batch(recs, device="cpu", **kw),
            jgraphs.make_packed_batch(jrecs, **kw))


def _assert_bit_equal(pb, jpb):
    assert pb.n_graphs == jpb.n_graphs
    for name in PB_FIELDS:
        got, want = getattr(pb, name).numpy(), np.asarray(getattr(jpb, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("use_native", [True, False])
def test_build_line_graph_bit_equal(rng, use_native):
    adjs = [random_adjacency(rng, n) for n in (2, 5, 9, 14)]
    adjs += [r.adj for r in qm9.synthetic_qm9_like(5, seed=8)]
    adjs.append(np.zeros((4, 4), np.float32))  # no edges
    for A in adjs:
        lg = operators.build_line_graph(A)
        jlg = joperators.build_line_graph(A, use_native=use_native)
        for f in ("src", "dst", "w", "rev"):
            got, want = getattr(lg, f), np.asarray(getattr(jlg, f))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert lg.num_edges == jlg.num_edges


def test_record_line_graph_memoized():
    rec = qm9.synthetic_qm9_like(1, seed=2)[0]
    jrec = jqm9.synthetic_qm9_like(1, seed=2)[0]
    assert rec.line_graph() is rec.line_graph()
    assert rec.n_dir_edges == jrec.n_dir_edges == 2 * int(np.count_nonzero(
        np.triu(rec.adj, 1)))


def test_make_packed_batch_bit_equal(batches):
    pb, jpb = batches
    _assert_bit_equal(pb, jpb)
    assert pb.num_node_slots == 200 and pb.num_edge_slots == 320
    # padding: edges at V-1 with w = 0, self-referential rev, gid B
    n_e = int(pb.edge_mask.sum())
    assert (pb.src[n_e:] == 199).all() and (pb.w[n_e:] == 0).all()
    assert (pb.rev[n_e:] == torch.arange(n_e, 320, dtype=torch.int32)).all()
    assert (pb.edge_gid[n_e:] == 12).all()


def test_make_packed_batch_unpadded_and_empty():
    recs = qm9.synthetic_qm9_like(5, seed=1)
    _assert_bit_equal(graphs.make_packed_batch(recs, device="cpu"),
                      jgraphs.make_packed_batch(jqm9.synthetic_qm9_like(5, seed=1)))
    kw = dict(node_capacity=8, edge_capacity=8, batch_size=3, feature_dim=5)
    _assert_bit_equal(graphs.make_packed_batch([], device="cpu", **kw),
                      jgraphs.make_packed_batch([], **kw))
    with pytest.raises(ValueError, match="edge capacity"):
        graphs.make_packed_batch(recs, edge_capacity=4, device="cpu")


def test_packed_batch_to_keeps_fields(batches):
    pb, _ = batches
    moved = pb.to("cpu")
    assert moved.n_graphs == pb.n_graphs
    for name in PB_FIELDS:
        assert torch.equal(getattr(moved, name), getattr(pb, name))


def test_sparse_ops_match_jax(batches, rng):
    pb, jpb = batches
    V, C = pb.num_node_slots, pb.num_edge_slots
    x = rng.standard_normal((V, 3)).astype(np.float32)
    xl = rng.standard_normal((C, 3)).astype(np.float32)
    tx, txl = torch.from_numpy(x), torch.from_numpy(xl)
    e = (pb.src, pb.dst, pb.w)
    je = (jpb.src, jpb.dst, jpb.w)
    ne = (pb.src, pb.dst, pb.w, pb.rev, pb.edge_mask)
    jne = (jpb.src, jpb.dst, jpb.w, jpb.rev, jpb.edge_mask)
    pairs = {
        "spmm": (sparse.spmm(*e, tx, V), jsparse.spmm(*je, x, V)),
        "degrees": (sparse.degrees(pb.src, pb.w, V),
                    jsparse.degrees(jpb.src, jpb.w, V)),
        "graph_op": (sparse.graph_op(*e, tx, V, 3), jsparse.graph_op(*je, x, V, 3)),
        "nb_apply": (sparse.nb_apply(*ne, txl, V), jsparse.nb_apply(*jne, xl, V)),
        "nb_degrees": (sparse.nb_degrees(*ne, V), jsparse.nb_degrees(*jne, V)),
        "lg_graph_op": (sparse.lg_graph_op(*ne, txl, V, 2),
                        jsparse.lg_graph_op(*jne, xl, V, 2)),
        "graph_readout": (sparse.graph_readout(tx, pb.node_gid, pb.n_graphs),
                          jsparse.graph_readout(x, jpb.node_gid, jpb.n_graphs)),
    }
    for signed in (False, True):
        pairs[f"incidence_apply signed={signed}"] = (
            sparse.incidence_apply(pb.src, pb.dst, pb.edge_mask, txl, V, signed),
            jsparse.incidence_apply(jpb.src, jpb.dst, jpb.edge_mask, xl, V, signed))
        pairs[f"incidence_t_apply signed={signed}"] = (
            sparse.incidence_t_apply(pb.src, pb.dst, pb.edge_mask, tx, signed),
            jsparse.incidence_t_apply(jpb.src, jpb.dst, jpb.edge_mask, x, signed))
    for name, (got, want) in pairs.items():
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("compat", [False, True])
def test_masked_batch_norm_matches_jax(rng, compat):
    cfg = layers.CompatConfig.reference() if compat else layers.CompatConfig()
    jcfg = jlayers.CompatConfig.reference() if compat else jlayers.CompatConfig()
    h = (rng.standard_normal((2, 11, 4)) * 3 + 1).astype(np.float32)
    mask = (rng.random((2, 11)) < 0.7).astype(np.float32)
    jbn = jlayers.MaskedBatchNorm(compat=jcfg)
    variables = _np(jbn.init(jax.random.key(3), h, mask, True))
    bn = layers.MaskedBatchNorm(4, compat=cfg)
    state = convert.packed_variables_from_flax(
        {"params": {"bn": variables["params"]},
         "batch_stats": {"bn": variables["batch_stats"]}})
    bn.load_state_dict({k.removeprefix("bn."): v for k, v in state.items()})
    assert bn.scale.dim() == (0 if compat else 1)
    assert float(bn.std[0]) == (0.0 if compat else 1.0)

    want, upd = jbn.apply(variables, h, mask, True, mutable=["batch_stats"])
    with torch.no_grad():
        got = bn.train()(torch.from_numpy(h), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BN_TOL)
    for f in ("mean", "std"):
        np.testing.assert_allclose(getattr(bn, f).numpy(),
                                   np.asarray(upd["batch_stats"][f]), **BN_TOL)

    want = jbn.apply({**variables, **_np(upd)}, h, mask, False)
    with torch.no_grad():
        got = bn.eval()(torch.from_numpy(h), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BN_TOL)


def test_masked_batch_norm_axis_name_not_ported(rng):
    """Named for the refusal it held before the sharded trainer was
    ported: axis_name now pools the statistics over the ranks of mesh
    axes, whose shards reach the module laid end to end, so on one batch
    it computes what the module without it does (tests/
    test_torch_sharded.py holds it to JAX's under shard_map); an unknown
    axis raises."""
    h = torch.from_numpy(rng.standard_normal((1, 20, 3)).astype(np.float32))
    mask = torch.from_numpy((rng.random((1, 20)) < 0.6).astype(np.float32))
    plain = layers.MaskedBatchNorm(3, generator=torch.Generator().manual_seed(1))
    for axis in ("edge", ("data", "edge")):
        bn = layers.MaskedBatchNorm(3, axis_name=axis)
        bn.load_state_dict(plain.state_dict())
        assert torch.equal(bn.train()(h, mask), plain.train()(h, mask))
    with pytest.raises(ValueError, match="mesh axes"):
        layers.MaskedBatchNorm(3, axis_name="model")


def _models(kind, order, compat):
    cfg = layers.CompatConfig.reference() if compat else layers.CompatConfig()
    jcfg = jlayers.CompatConfig.reference() if compat else jlayers.CompatConfig()
    if kind == "lggnn":
        return (jpacked.PackedLGGNN(n_features=3, n_layers=3, J=1, order=order,
                                    compat=jcfg),
                packed.PackedLGGNN(3, 3, in_features=5, J=1, order=order,
                                   compat=cfg))
    return (jpacked.PackedGNN(n_features=2, n_layers=4, J=2, compat=jcfg),
            packed.PackedGNN(2, 4, in_features=5, J=2, compat=cfg))


def _assert_stats_equal(model, batch_stats):
    state = model.state_dict()
    for name, leaves in batch_stats.items():
        for f, want in leaves.items():
            np.testing.assert_allclose(state[f"{name}.{f}"].numpy(),
                                       np.asarray(want), **BN_TOL,
                                       err_msg=f"{name}.{f}")


@pytest.mark.parametrize("kind,order,compat", [
    ("lggnn", 1, False), ("lggnn", 2, False), ("lggnn", 3, False),
    ("lggnn", 2, True), ("gnn", 0, False), ("gnn", 0, True)])
def test_packed_model_matches_jax(batches, kind, order, compat):
    """A train-mode forward (batch statistics, updated running stats),
    then an eval-mode forward on the updated stats."""
    pb, jpb = batches
    jmodel, model = _models(kind, order, compat)
    variables = _np(jmodel.init(jax.random.key(order), jpb, train=True))
    model.load_state_dict(convert.packed_variables_from_flax(variables))

    want, upd = jmodel.apply(variables, jpb, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = model.train()(pb)
    assert got.shape == want.shape == (12, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    _assert_stats_equal(model, upd["batch_stats"])

    want = jmodel.apply({**variables, **_np(upd)}, jpb, train=False)
    with torch.no_grad():
        got = model.eval()(pb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_packed_gnn_graph_op_fn(batches):
    """PackedGNN with a bare graph_op_fn (here the edge-partitioned one)."""
    pb, jpb = batches
    jmodel, model = _models("gnn", 0, False)
    variables = _np(jmodel.init(jax.random.key(5), jpb, train=False))
    model.load_state_dict(convert.packed_variables_from_flax(variables))
    V = pb.num_node_slots
    gop = spmd.partitioned_graph_op(spmd.EdgeMesh(["cpu"] * 4), V, 2)
    with torch.no_grad():
        got = model.eval()(pb, graph_op_fn=lambda x: gop(pb.src, pb.dst, pb.w, x))
    want = jmodel.apply(variables, jpb, train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_convert_round_trip(batches):
    _, jpb = batches
    jmodel, model = _models("lggnn", 2, True)
    variables = _np(jmodel.init(jax.random.key(0), jpb, train=True))
    back = convert.packed_variables_to_flax(
        convert.packed_variables_from_flax(variables))
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)
    model.load_state_dict(convert.packed_variables_from_flax(variables))
    assert set(model.state_dict()) == set(
        convert.packed_variables_from_flax(variables))


@pytest.mark.parametrize("arch", ["lggnn", "gnn"])
def test_build_packed_model_matches_jax_shapes(batches, arch):
    """The model of a TrainConfig has the flax model's parameter names
    and shapes."""
    _, jpb = batches
    cfg, jcfg = TrainConfig(), JTrainConfig()
    for c in (cfg, jcfg):
        c.model.arch, c.model.n_features, c.model.n_layers = arch, 4, 3
        c.model.order, c.model.J = 3, 2
    model = common.build_packed_model(cfg, "regression", 5)
    jmodel = jcommon.build_packed_model(jcfg, "regression")
    want = convert.packed_variables_from_flax(
        _np(jmodel.init(jax.random.key(0), jpb, train=True)))
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    with pytest.raises(ValueError, match="no packed variant"):
        cfg.model.arch = "ccn1d"
        common.build_packed_model(cfg, "regression", 5)


def test_pad_edges_for_partition_matches_jax(batches):
    pb, _ = batches
    arrays = {k: getattr(pb, k).numpy()[:317] for k in
              ("src", "dst", "w", "rev", "edge_gid", "edge_mask")}
    got = spmd.pad_edges_for_partition(arrays, 4, 200)
    want = jspmd.pad_edges_for_partition(arrays, 4, 200)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == (320,)
        np.testing.assert_array_equal(got[k], want[k])
