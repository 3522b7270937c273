"""The ring all-reduce (K5's plain twin and wrapper) and the port's
edge-partitioned packed path against the JAX package on the CPU: JAX's
Pallas ring in interpret mode under shard_map on a one-axis mesh of the
8 virtual CPU devices, and its partitioned_packed_ops.

Tolerances: the ring within atol 1e-6 (the same adds in the same order,
so in practice equal); the partitioned operators and models within atol
1e-5 of JAX's and of the single-device bundle (segment sums split over
ranks, in another order)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from hgnn2_tpu import graphs as jgraphs
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import packed as jpacked
from hgnn2_tpu.ops.pallas.ring import ring_psum as jring_psum
from hgnn2_tpu.parallel import spmd as jspmd

from hgnn2_torch import convert, graphs
from hgnn2_torch.data import qm9
from hgnn2_torch.nn import packed
from hgnn2_torch.ops import ring
from hgnn2_torch.parallel import spmd

torch.set_num_threads(2)

RING_TOL = dict(atol=1e-6, rtol=0)
PART_TOL = dict(atol=1e-5, rtol=1e-5)


def _edge_mesh(S):
    return Mesh(np.array(jax.devices()[:S]), ("edge",))


@pytest.mark.parametrize("S", [2, 4, 8])
def test_ring_reference_matches_jax_ring(rng, S):
    x = rng.standard_normal((S, 16, 8)).astype(np.float32)
    want = shard_map(
        lambda b: jring_psum(b, "edge", S, interpret=True), mesh=_edge_mesh(S),
        in_specs=P("edge"), out_specs=P("edge"), check_rep=False)(jnp.asarray(x))
    want = np.asarray(want)
    parts = [torch.from_numpy(x[r]) for r in range(S)]
    got = ring.ring_psum_reference(parts)
    wrapped = ring.ring_psum(parts)  # CPU tensors: the twin
    for r in range(S):
        np.testing.assert_allclose(got[r].numpy(), want[r], **RING_TOL)
        assert torch.equal(wrapped[r], got[r])
    # each rank sums in its own ring order: x_r + x_{r-1} + ... + x_{r-S+1}
    acc = x[1] + x[0]
    for k in range(2, S):
        acc = acc + x[(1 - k) % S]
    np.testing.assert_array_equal(got[1].numpy(), acc)


def test_ring_single_rank_is_identity():
    x = torch.randn(5, 3)
    (out,) = ring.ring_psum([x])
    assert out is x
    assert ring.ring_psum_reference([x])[0] is x


def test_ring_refuses_grad_and_mixed_inputs():
    a = torch.randn(4, 2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        ring.ring_psum([a, a.detach()])
    with torch.no_grad():
        assert torch.equal(ring.ring_psum([a, a])[0], 2 * a.detach())
    with pytest.raises(ValueError, match="float32"):
        ring.ring_psum([torch.zeros(3), torch.zeros(4)])
    with pytest.raises(NotImplementedError, match="across devices"):
        ring.ring_psum([torch.zeros(3), torch.zeros(3, device="meta")])


def test_edge_mesh_single_device_only():
    assert spmd.EdgeMesh(["cpu"] * 4).size == 4
    with pytest.raises(NotImplementedError, match="slice F"):
        spmd.EdgeMesh(["cuda:0", "cuda:1"])


@pytest.fixture(scope="module")
def batches():
    """7 molecules; edge capacity divisible by 8, so every S <= 8 splits."""
    recs = qm9.synthetic_qm9_like(7, seed=6)
    tot_e = sum(r.n_dir_edges for r in recs)
    kw = dict(node_capacity=160, edge_capacity=((tot_e + 12) // 8) * 8, task=0)
    return (graphs.make_packed_batch(recs, device="cpu", **kw),
            jgraphs.make_packed_batch(jqm9.synthetic_qm9_like(7, seed=6), **kw))


def test_edge_capacity_must_divide(batches):
    pb, _ = batches
    with pytest.raises(ValueError, match="not divisible"):
        spmd.partitioned_packed_ops(spmd.EdgeMesh(["cpu"] * 3), pb, J=1)


def test_partitioned_spmm_matches_jax(batches, rng):
    pb, jpb = batches
    V = pb.num_node_slots
    x = rng.standard_normal((V, 3)).astype(np.float32)
    mesh = _edge_mesh(4)
    with jax.sharding.set_mesh(mesh):
        want = jspmd.partitioned_graph_op(mesh, V, 2)(jpb.src, jpb.dst, jpb.w, x)
        want_spmm = jspmd.partitioned_spmm(mesh, V)(jpb.src, jpb.dst, jpb.w, x)
    emesh = spmd.EdgeMesh(["cpu"] * 4)
    tx = torch.from_numpy(x)
    got = spmd.partitioned_graph_op(emesh, V, 2)(pb.src, pb.dst, pb.w, tx)
    got_spmm = spmd.partitioned_spmm(emesh, V)(pb.src, pb.dst, pb.w, tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PART_TOL)
    np.testing.assert_allclose(got_spmm.numpy(), np.asarray(want_spmm), **PART_TOL)


@pytest.mark.parametrize("S", [2, 4])
def test_partitioned_ops_match_jax_ring_and_local(batches, rng, S):
    pb, jpb = batches
    V, C = pb.num_node_slots, pb.num_edge_slots
    x = rng.standard_normal((V, 3)).astype(np.float32)
    xl = rng.standard_normal((C, 2)).astype(np.float32)
    mesh = _edge_mesh(S)
    with jax.sharding.set_mesh(mesh):
        jops = jspmd.partitioned_packed_ops(mesh, jpb, J=2, use_ring=True,
                                            ring_interpret=True)
        want = {"graph_op": jops.graph_op(x), "lg_graph_op": jops.lg_graph_op(xl),
                "pm": jops.pm(xl), "pd": jops.pd(xl)}
    local = packed.SparsePackedOps(pb, 2)
    tx, txl = torch.from_numpy(x), torch.from_numpy(xl)
    for use_ring in (True, False):
        ops = spmd.partitioned_packed_ops(spmd.EdgeMesh(["cpu"] * S), pb, J=2,
                                          use_ring=use_ring)
        got = {"graph_op": ops.graph_op(tx), "lg_graph_op": ops.lg_graph_op(txl),
               "pm": ops.pm(txl), "pd": ops.pd(txl)}
        for name, w in want.items():
            msg = f"{name} use_ring={use_ring}"
            np.testing.assert_allclose(got[name].numpy(), np.asarray(w),
                                       **PART_TOL, err_msg=msg)
            np.testing.assert_allclose(got[name].numpy(),
                                       getattr(local, name)(
                                           txl if name != "graph_op" else tx).numpy(),
                                       **PART_TOL, err_msg=msg)
        np.testing.assert_allclose(ops.nb_degrees().numpy(),
                                   local.nb_degrees().numpy(), **PART_TOL)
        assert ops.comm_bytes_per_step() == jops.comm_bytes_per_step()
        assert ops.psum_widths == jops.psum_widths


def test_partitioned_lggnn_forward_matches_jax_ring(batches):
    """A whole PackedLGGNN eval forward through the ring at S = 4: 18
    all-reduces at J = 1, n_layers = 3."""
    pb, jpb = batches
    jmodel = jpacked.PackedLGGNN(n_features=3, n_layers=3, J=1, order=2)
    variables = jax.tree.map(np.asarray,
                             jmodel.init(jax.random.key(4), jpb, train=True))
    mesh = _edge_mesh(4)
    with jax.sharding.set_mesh(mesh):
        jops = jspmd.partitioned_packed_ops(mesh, jpb, J=1, use_ring=True,
                                            ring_interpret=True)
        # one jit: 17 interpret-mode rings compile together, not one by one
        want = np.asarray(jax.jit(lambda v: jmodel.apply(
            v, jpb, train=False, ops=jops))(variables))
    model = packed.PackedLGGNN(3, 3, in_features=5, J=1, order=2).eval()
    model.load_state_dict(convert.packed_variables_from_flax(variables))
    with torch.no_grad():
        local = model(pb).numpy()
        for use_ring in (True, False):
            ops = spmd.partitioned_packed_ops(spmd.EdgeMesh(["cpu"] * 4), pb,
                                              J=1, use_ring=use_ring)
            got = model(pb, ops=ops).numpy()
            np.testing.assert_allclose(got, want, **PART_TOL)
            np.testing.assert_allclose(got, local, **PART_TOL)
            assert ops.comm_bytes_per_step() == jops.comm_bytes_per_step()
            assert ops.comm_bytes_per_step()["n_allreduce_fwd"] == 18


def test_partitioned_plain_reduce_is_differentiable(batches):
    """Only the ring refuses grad mode; the plain reduce trains."""
    pb, _ = batches
    model = packed.PackedGNN(2, 3, in_features=5).train()
    ops = spmd.partitioned_packed_ops(spmd.EdgeMesh(["cpu"] * 2), pb, J=1)
    model(pb, ops=ops).sum().backward()
    assert all(p.grad is not None for p in model.parameters())
    ring_ops = spmd.partitioned_packed_ops(spmd.EdgeMesh(["cpu"] * 2), pb, J=1,
                                           use_ring=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        model(pb, ops=ring_ops)
