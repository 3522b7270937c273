"""Halo-exchange partitioning of one giant graph (hgnn2_torch.parallel.halo)
against the JAX package's (hgnn2_tpu/parallel/halo.py, on the 8 virtual
CPU devices, 4 halo ranks on the 'edge' axis) and against the port's
unpartitioned ops and models, the port's 4 ranks all on the CPU.

Tolerances: the host tables are numpy in both packages and equal bit for
bit; the SpMM and its gradient 1e-6 (f32 sums in another order); whole
models' losses rtol 1e-5 and gradients by relative L2 < 1e-3, the bar of
JAX's own halo tests (tests/test_halo.py), whose model-level gradient gap
is f32 reduction-order noise through the BN statistics; the exchanged
bytes equal JAX's."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from hgnn2_tpu import graphs as jgraphs
from hgnn2_tpu.nn import packed as jpacked
from hgnn2_tpu.parallel import halo as jhalo
from hgnn2_tpu.parallel import spmd as jspmd

from hgnn2_torch import convert, graphs
from hgnn2_torch.nn import packed
from hgnn2_torch.ops import sparse
from hgnn2_torch.parallel import halo, spmd

torch.set_num_threads(2)

S = 4
MEAN, STD = 0.5, 2.0


@pytest.fixture(scope="module")
def mesh():
    return jspmd.make_mesh(8, edge_axis=S)


def _grid():
    return spmd.RankGrid(1, S, "cpu")


def _graph(rng, V=64, E=512):
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    w = rng.random(E).astype(np.float32)
    return src, dst, w


def _locality_records(rng, V=64, reach=2, n_long=6, F=5):
    """One connected graph of mostly local edges (a ring of
    neighbourhoods) plus a few long-range ones, as each package's
    GraphRecord (tests/test_halo.py's graph)."""
    a = np.zeros((V, V), np.float32)
    for v in range(V):
        for d in range(1, reach + 1):
            a[v, (v + d) % V] = 1.0
    for _ in range(n_long):
        i, j = rng.integers(0, V, 2)
        if i != j:
            a[i, j] = 1.0
    a = np.maximum(np.triu(a, 1), np.triu(a.T, 1))
    a = a + a.T
    x = rng.standard_normal((V, F)).astype(np.float32)
    y = np.array([1.5] * 13, np.float32)
    return (graphs.GraphRecord(x=x, adj=a, y=y),
            jgraphs.GraphRecord(x=x, adj=a, y=y))


@pytest.mark.parametrize("V,E,n_shards", [(64, 512, 4), (32, 40, 8)])
def test_build_halo_partition_bit_equal(rng, V, E, n_shards):
    src, dst, w = _graph(rng, V, E)
    got = halo.build_halo_partition(src, dst, w, V, n_shards, to_device=False)
    want = jhalo.build_halo_partition(src, dst, w, V, n_shards,
                                      to_device=False)
    for f in ("src_local", "dst_local", "w", "export_idx", "import_flat"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.nodes_per_shard, got.n_imports, got.n_shards) == (
        want.nodes_per_shard, want.n_imports, want.n_shards)
    dev = halo.build_halo_partition(src, dst, w, V, n_shards, device="cpu")
    np.testing.assert_array_equal(dev.dst_local.numpy(), want.dst_local)
    with pytest.raises(ValueError, match="n_shards"):
        halo.build_halo_partition(src, dst, w, V + 1, n_shards)


@pytest.mark.parametrize("V,reach,n_long", [(64, 2, 6), (256, 3, 8)])
def test_build_halo_lg_bundle_bit_equal(rng, V, reach, n_long):
    rec, jrec = _locality_records(rng, V, reach, n_long)
    got = halo.build_halo_lg_bundle(
        graphs.make_packed_batch([rec], task=0, device="cpu"), S, device="cpu")
    want = jhalo.build_halo_lg_bundle(jgraphs.make_packed_batch([jrec], task=0),
                                      S)
    assert got.arrays.keys() == want.arrays.keys()
    for k, a in got.arrays.items():
        b = np.asarray(want.arrays[k])
        assert a.numpy().dtype == b.dtype, k
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    np.testing.assert_array_equal(got.gmask.numpy(), np.asarray(want.gmask))
    assert got.halo_sizes == want.halo_sizes
    assert (got.n_graphs, got.nodes_per_shard, got.n_shards) == (
        want.n_graphs, want.nodes_per_shard, want.n_shards)


def _spmm_inputs(rng, V, E, F):
    src, dst, w = _graph(rng, V=V, E=E)
    x = rng.standard_normal((V, F)).astype(np.float32)
    return src, dst, w, x


def test_halo_spmm_matches_jax_and_full(mesh, rng):
    V, F = 64, 5
    src, dst, w, x = _spmm_inputs(rng, V, 512, F)
    part = halo.build_halo_partition(src, dst, w, V, S, device="cpu")
    got = halo.halo_partitioned_spmm(_grid(), part)(
        torch.from_numpy(x.reshape(S, V // S, F))).numpy().reshape(V, F)
    jpart = jhalo.build_halo_partition(src, dst, w, V, S)
    with jax.sharding.set_mesh(mesh):
        want = np.asarray(jax.jit(jhalo.halo_partitioned_spmm(mesh, jpart))(
            jnp.asarray(x.reshape(S, V // S, F)))).reshape(V, F)
    full = sparse.spmm(*(torch.from_numpy(a) for a in (src, dst, w, x)), V)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, full.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="halo ranks"):
        halo.halo_partitioned_spmm(spmd.RankGrid(1, 2, "cpu"), part)


def test_halo_spmm_gradients(mesh, rng):
    V, F = 32, 3
    src, dst, w, x = _spmm_inputs(rng, V, 200, F)
    part = halo.build_halo_partition(src, dst, w, V, S, device="cpu")
    xs = torch.from_numpy(x.reshape(S, V // S, F)).requires_grad_()
    (halo.halo_partitioned_spmm(_grid(), part)(xs) ** 2).sum().backward()
    got = xs.grad.numpy().reshape(V, F)
    jpart = jhalo.build_halo_partition(src, dst, w, V, S)
    with jax.sharding.set_mesh(mesh):
        f = jhalo.halo_partitioned_spmm(mesh, jpart)
        want = np.asarray(jax.grad(lambda xx: (f(xx) ** 2).sum())(
            jnp.asarray(x.reshape(S, V // S, F)))).reshape(V, F)
    xf = torch.from_numpy(x).requires_grad_()
    (sparse.spmm(*(torch.from_numpy(a) for a in (src, dst, w)), xf, V) ** 2
     ).sum().backward()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, xf.grad.numpy(), atol=1e-6)


def _models(arch):
    if arch == "lggnn":
        kw = dict(n_features=2, n_layers=3, J=1, order=2)
        return jpacked.PackedLGGNN, packed.PackedLGGNN, kw
    return jpacked.PackedGNN, packed.PackedGNN, dict(n_features=2, n_layers=3,
                                                      J=1)


def _flat_grads(tree) -> np.ndarray:
    return np.concatenate([np.asarray(v).ravel() for _, v in sorted(
        _leaves(tree))])


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _port_grads(model) -> np.ndarray:
    return _flat_grads(convert.packed_variables_to_flax(
        {n: p.grad for n, p in model.named_parameters()})["params"])


@pytest.mark.parametrize("arch", ["lggnn", "gnn"])
def test_halo_packed_loss_matches_jax_and_unpartitioned(mesh, rng, arch):
    """A whole train-mode loss of PackedLGGNN (and PackedGNN, which takes
    the bundle's graph_op) over 4 halo ranks: against JAX's halo loss on
    the virtual mesh and the port's unpartitioned model, from JAX's init;
    the BN running statistics it leaves against the unpartitioned run's."""
    rec, jrec = _locality_records(rng, V=64)
    jpb = jgraphs.make_packed_batch([jrec], task=0)
    jcls, cls, kw = _models(arch)
    variables = jax.tree.map(np.asarray, jcls(**kw).init(
        jax.random.key(0), jpb, train=True))
    jmodel = jcls(bn_axis="edge", **kw)
    jbundle = jhalo.build_halo_lg_bundle(jpb, S)
    with jax.sharding.set_mesh(mesh):
        jloss = jhalo.halo_packed_loss(jmodel, mesh, jbundle, mean=MEAN,
                                       std=STD)
        want, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jloss({**variables, "params": p})))(variables["params"])

    def port_model(bn_axis):
        m = cls(in_features=5, bn_axis=bn_axis, **kw)
        m.load_state_dict(convert.packed_variables_from_flax(variables))
        return m

    pb = graphs.make_packed_batch([rec], task=0, device="cpu")
    model = port_model("edge")
    loss = halo.halo_packed_loss(model, _grid(),
                                 halo.build_halo_lg_bundle(pb, S, device="cpu"),
                                 mean=MEAN, std=STD)()
    loss.backward()
    single = port_model(None).train()
    per = spmd.per_graph_loss(single(pb), pb.y, "regression", MEAN, STD)
    ref = (per * pb.gmask).sum() / pb.gmask.sum()
    ref.backward()

    loss, ref = float(loss.detach()), float(ref.detach())
    np.testing.assert_allclose(loss, float(want), rtol=1e-5)
    np.testing.assert_allclose(loss, ref, rtol=1e-5)
    g = _port_grads(model)
    for other in (_flat_grads(jax.tree.map(np.asarray, jgrads)),
                  _port_grads(single)):
        assert np.linalg.norm(g - other) / np.linalg.norm(other) < 1e-3
    for (n, b), (_, b1) in zip(model.named_buffers(), single.named_buffers()):
        np.testing.assert_allclose(b.numpy(), b1.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_halo_comm_bytes_match_jax_and_far_below_psum(mesh, rng):
    """On a locality-friendly giant graph the halo forward's exchanges,
    their widths and bytes equal JAX's, and a train step's bytes are a
    small fraction of the all-reduce path's (PartitionedPackedOps over 4
    ranks of an EdgeMesh) on the same graph and model."""
    rec, jrec = _locality_records(rng, V=256, reach=3, n_long=8)
    jpb = jgraphs.make_packed_batch([jrec], task=0)
    kw = dict(n_features=4, n_layers=3, J=1, order=2)
    variables = jpacked.PackedLGGNN(**kw).init(jax.random.key(0), jpb,
                                               train=True)
    jbundle = jhalo.build_halo_lg_bundle(jpb, S)
    jlog = jhalo.new_comm_log()
    with jax.sharding.set_mesh(mesh):
        jloss = jhalo.halo_packed_loss(jpacked.PackedLGGNN(bn_axis="edge", **kw),
                                       mesh, jbundle, comm_log=jlog)
        jax.eval_shape(jloss, variables)
    want = jhalo.halo_comm_bytes(jlog, jbundle, S)

    pb = graphs.make_packed_batch([rec], task=0, device="cpu")
    bundle = halo.build_halo_lg_bundle(pb, S, device="cpu")
    model = packed.PackedLGGNN(in_features=5, bn_axis="edge", **kw)
    log = halo.new_comm_log()
    with torch.no_grad():
        halo.halo_packed_loss(model, _grid(), bundle, comm_log=log)()
    assert log == jlog
    got = halo.halo_comm_bytes(log, bundle, S)
    assert got == want
    assert got["n_node_halo_fwd"] > 0 and got["n_edge_halo_fwd"] > 0

    ops = spmd.PartitionedPackedOps(spmd.EdgeMesh(["cpu"] * S), pb, J=1)
    with torch.no_grad():
        packed.PackedLGGNN(in_features=5, **kw).train()(pb, ops=ops)
    ratio = (got["train_step_bytes_per_chip"]
             / ops.comm_bytes_per_step()["train_step_bytes_per_chip"])
    assert ratio < 0.25, ratio


def test_halo_volume_much_smaller_than_full_block(rng):
    """For a locality-friendly graph the halo is a small fraction of V
    (tests/test_halo.py's ring of cliques), and the tables equal JAX's."""
    V, n_shards = 1024, 8
    src_l, dst_l = [], []
    for v in range(V):
        for _ in range(6):
            src_l.append(v)
            dst_l.append((v + int(rng.integers(-8, 9))) % V)
    for _ in range(40):  # long-range
        src_l.append(int(rng.integers(0, V)))
        dst_l.append(int(rng.integers(0, V)))
    src, dst = np.array(src_l, np.int32), np.array(dst_l, np.int32)
    w = np.ones(len(src), np.float32)
    part = halo.build_halo_partition(src, dst, w, V, n_shards, to_device=False)
    want = jhalo.build_halo_partition(src, dst, w, V, n_shards, to_device=False)
    np.testing.assert_array_equal(part.import_flat, want.import_flat)
    assert part.n_imports / (V // n_shards) < 0.35
