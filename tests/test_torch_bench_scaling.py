"""The port's scaling harness (hgnn2_torch/scripts/bench_scaling.py)
against the JAX package's bench_scaling.py on the CPU: its inputs, each
mode's comm accounting (bytes, halo rows, forward all-reduces) against
JAX's functions on the conftest's 8 virtual CPU devices at 1, 2 and 4
ranks, the accounting at the JAX script's default sizes against its
committed BENCH_SCALING.json at 1, 2, 4 and 8 ranks, the first three SGD
steps of every mode from JAX's weights, the hybrid's [2, 2] and [2, 4]
meshes, and a whole run's JSON. The JAX script's modes are inline in its
main(), so this file writes their steps out as the script does.

Tolerances: inputs, bytes, rows and counts exact; losses rtol 1e-5 (f32
sums in another order: the port's ranks run as one flattened batch, JAX's
per shard, then psum)."""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import optax
import torch
from jax.sharding import Mesh

from hgnn2_tpu import graphs as jgraphs
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import packed as jpacked
from hgnn2_tpu.parallel import halo as jhalo
from hgnn2_tpu.parallel import spmd as jspmd
from hgnn2_tpu.training import sharded as jsharded

from hgnn2_torch import convert, graphs
from hgnn2_torch.scripts import bench_scaling as bsc

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, H = bsc.L, bsc.H
N_MOLS, N_NODES = 48, 256  # the tiny sizes of the JAX comparisons


def _mesh(n_data, n_edge):
    return Mesh(np.array(jax.devices()[:n_data * n_edge]).reshape(
        n_data, n_edge), ("data", "edge"))


def jax_giant(Vg):
    """bench_scaling.py:227-241 and the bare SpMM's draws after it
    (:348-353, at the default 16 a node and 128 features)."""
    rng = np.random.default_rng(0)
    a = np.zeros((Vg, Vg), np.float32)
    for v in range(Vg):
        for dd in range(1, 4):
            a[v, (v + dd) % Vg] = 1.0
    for _ in range(Vg // 64):
        i, j = rng.integers(0, Vg, 2)
        if i != j:
            a[i, j] = 1.0
    a = np.maximum(np.triu(a, 1), np.triu(a.T, 1))
    a = a + a.T
    giant = jgraphs.GraphRecord(
        x=rng.standard_normal((Vg, 5)).astype(np.float32),
        adj=a, y=np.array([1.0] * 13, np.float32))
    E = Vg * 16
    src = np.sort(rng.integers(0, Vg, E)).astype(np.int32)
    dst = rng.integers(0, Vg, E).astype(np.int32)
    w = rng.random(E).astype(np.float32)
    x = rng.standard_normal((Vg, 128)).astype(np.float32)
    return giant, (src, dst, w, x)


def test_inputs_match_jax():
    """The molecules (seed 1), the giant graph and the bare SpMM's draws
    from the generator after it equal the JAX script's."""
    for a, b in zip(bsc.molecules(N_MOLS), jqm9.synthetic_qm9_like(N_MOLS,
                                                                     seed=1)):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.adj, b.adj)
    giant, rng = bsc.giant_graph(N_NODES)
    jgiant, jbare = jax_giant(N_NODES)
    np.testing.assert_array_equal(giant.x, jgiant.x)
    np.testing.assert_array_equal(giant.adj, jgiant.adj)
    np.testing.assert_array_equal(giant.y, jgiant.y)
    for a, b in zip(bsc.bare_spmm_inputs(rng, N_NODES, N_NODES * 16, 128),
                    jbare):
        np.testing.assert_array_equal(a, b)


def _sgd_losses(step, params, opt_state, *args, n=3):
    out = []
    for _ in range(n):
        params, opt_state, loss = step(params, opt_state, *args)
        out.append(float(loss))
    return out


def _jax_molecule_aligned(jrecs, d):
    """bench_scaling.py:118-145: (variables, 3 losses, n_params)."""
    mesh = _mesh(1, d)
    tot_v = sum(r.n_nodes for r in jrecs)
    tot_e = sum(r.line_graph().num_edges for r in jrecs)
    stacked = jspmd.make_packed_shards(
        jrecs, d, node_capacity=-(-tot_v // d) + 32,
        edge_capacity=-(-tot_e // d) + 32,
        graphs_per_shard=-(-len(jrecs) // d) + 8, task=0)
    model = jpacked.PackedLGGNN(n_features=H, n_layers=L, J=1, order=2,
                                bn_axis="edge")
    init_model = jpacked.PackedLGGNN(n_features=H, n_layers=L, J=1, order=2)
    tx = optax.sgd(1e-3)
    with jax.sharding.set_mesh(mesh):
        local0 = jax.tree_util.tree_map(lambda v: v[0], stacked)
        variables = init_model.init(jax.random.key(0), local0, train=True)
        params = variables["params"]
        rest = {k: v for k, v in variables.items() if k != "params"}
        loss_fn = jspmd.sharded_packed_loss(model, mesh)

        @jax.jit
        def step(params, opt_state, stacked):
            loss, grads = jax.value_and_grad(
                lambda p: loss_fn({"params": p, **rest}, stacked))(params)
            updates, opt_state = tx.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss

        losses = _sgd_losses(step, params, tx.init(params), stacked)
    n_params = int(sum(np.prod(l.shape)
                       for l in jax.tree_util.tree_leaves(params)))
    return variables, losses, n_params


def _jax_hybrid(jrecs, d):
    """bench_scaling.py:179-208: (variables, 3 losses, n_params)."""
    n_dp, n_es = 2, d // 2
    mesh = _mesh(n_dp, n_es)
    loader = jsharded.ShardedPackedLoader(jrecs, batch_size=len(jrecs),
                                          n_shards=n_es, task=0, n_data=n_dp)
    stacked = loader.peek_sample()
    model = jpacked.PackedLGGNN(n_features=H, n_layers=L, J=1, order=2,
                                bn_axis=("data", "edge"))
    init_model = jpacked.PackedLGGNN(n_features=H, n_layers=L, J=1, order=2)
    tx = optax.sgd(1e-3)
    with jax.sharding.set_mesh(mesh):
        local0 = jax.tree_util.tree_map(lambda v: v[(0, 0)], stacked)
        variables = init_model.init(jax.random.key(0), local0, train=True)
        p = variables["params"]
        b = variables.get("batch_stats", {})
        o = tx.init(p)
        train_step, _ = jsharded.make_sharded_step_fns(
            model, mesh, tx, axes=("data", "edge"))
        losses = []
        for _ in range(3):
            p, b, o, mets = train_step(p, b, o, stacked)
            losses.append(float(mets["loss"]))
    leaves = jax.tree_util.tree_leaves(variables["params"])
    n_params = int(sum(np.prod(l.shape) for l in leaves))
    return variables, losses, n_params


def _jax_halo(jgiant, d):
    """bench_scaling.py:249-274: (variables, 3 losses, accounting)."""
    mesh = _mesh(1, d)
    pbg = jgraphs.make_packed_batch([jgiant], task=0)
    bundle = jhalo.build_halo_lg_bundle(pbg, d)
    model = jpacked.PackedLGGNN(n_features=H, n_layers=L, J=1, order=2,
                                bn_axis="edge")
    init_model = jpacked.PackedLGGNN(n_features=H, n_layers=L, J=1, order=2)
    comm_log = jhalo.new_comm_log()
    tx = optax.sgd(1e-3)
    with jax.sharding.set_mesh(mesh):
        variables = init_model.init(jax.random.key(0), pbg, train=True)
        params = variables["params"]
        rest = {k: v for k, v in variables.items() if k != "params"}
        loss_fn = jhalo.halo_packed_loss(model, mesh, bundle,
                                         comm_log=comm_log)
        jax.eval_shape(lambda p: loss_fn({"params": p, **rest}), params)
        acct = jhalo.halo_comm_bytes(comm_log, bundle, d)

        @jax.jit
        def hstep(params, opt_state):
            loss, grads = jax.value_and_grad(
                lambda p: loss_fn({"params": p, **rest}))(params)
            updates, opt_state = tx.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss

        losses = _sgd_losses(hstep, params, tx.init(params))
    return variables, losses, acct


def _jax_psum(jrecs, d):
    """bench_scaling.py:295-331: (variables, 3 losses, accounting)."""
    mesh = _mesh(1, d)
    tot_v = sum(r.n_nodes for r in jrecs)
    tot_e = sum(r.line_graph().num_edges for r in jrecs)
    pbig = jgraphs.make_packed_batch(
        jrecs, node_capacity=((tot_v + 63) // 64) * 64,
        edge_capacity=((tot_e + 63) // 64) * 64, task=0)
    model = jpacked.PackedLGGNN(n_features=H, n_layers=L, J=1, order=2)
    tx = optax.sgd(1e-3)
    with jax.sharding.set_mesh(mesh):
        ops = jspmd.partitioned_packed_ops(mesh, pbig, J=1)
        variables = model.init(jax.random.key(0), pbig, train=True, ops=ops)
        params = variables["params"]
        rest = {k: v for k, v in variables.items() if k != "params"}

        def loss(p):
            out, _ = model.apply({"params": p, **rest}, pbig, train=True,
                                 ops=ops, mutable=["batch_stats"])
            per = (out[:, 0] - pbig.y) ** 2
            return (per * pbig.gmask).sum() / pbig.gmask.sum()

        @jax.jit
        def step(params, opt_state):
            l, grads = jax.value_and_grad(loss)(params)
            updates, opt_state = tx.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, l

        ops.psum_widths.clear()
        jax.eval_shape(loss, params)
        acct = ops.comm_bytes_per_step()
        losses = _sgd_losses(step, params, tx.init(params))
    return variables, losses, acct


def _state(variables):
    return convert.packed_variables_from_flax(jax.tree.map(np.asarray,
                                                           variables))


def _steps(step, n=3):
    return [float(step()) for _ in range(n)]


@pytest.mark.parametrize("mode,d", [
    ("molecule_aligned", 1), ("molecule_aligned", 2), ("molecule_aligned", 4),
    ("hybrid", 4), ("halo_giant_graph", 1), ("halo_giant_graph", 2),
    ("halo_giant_graph", 4), ("psum_fallback", 1), ("psum_fallback", 2),
    ("psum_fallback", 4)])
def test_mode_matches_jax(mode, d):
    """Each mode at d ranks from JAX's initial weights: the first three
    SGD steps' losses against the JAX script's step on the virtual
    devices, and the comm accounting against JAX's functions (the BN
    formula over JAX's parameter count, halo_comm_bytes,
    PartitionedPackedOps.comm_bytes_per_step)."""
    recs, jrecs = bsc.molecules(N_MOLS), jqm9.synthetic_qm9_like(N_MOLS,
                                                                 seed=1)
    if mode == "molecule_aligned":
        variables, want, n_params = _jax_molecule_aligned(jrecs, d)
        step, comm = bsc.molecule_aligned(recs, d, "cpu", _state(variables))
        ring = 2.0 * (d - 1) / d
        assert comm == (2 * ring * (2 * (L - 1) * (4 * H + 1) + 2) * 4
                        + ring * 4 * n_params)
    elif mode == "hybrid":
        variables, want, n_params = _jax_hybrid(jrecs, d)
        step, comm, shape = bsc.hybrid(recs, d, "cpu", _state(variables))
        assert shape == [2, d // 2]
        assert comm == bsc.bn_comm_bytes(d, n_params)
    elif mode == "halo_giant_graph":
        jgiant, _ = jax_giant(N_NODES)
        variables, want, jacct = _jax_halo(jgiant, d)
        giant, _ = bsc.giant_graph(N_NODES)
        pbg = graphs.make_packed_batch([giant], task=0, device="cpu")
        step, acct = bsc.halo_giant(pbg, d, "cpu", _state(variables))
        assert acct == jacct
    else:
        variables, want, jacct = _jax_psum(jrecs, d)
        tot_v = sum(r.n_nodes for r in recs)
        tot_e = sum(r.n_dir_edges for r in recs)
        pbig = graphs.make_packed_batch(
            recs, node_capacity=((tot_v + 63) // 64) * 64,
            edge_capacity=((tot_e + 63) // 64) * 64, task=0, device="cpu")
        step, acct = bsc.psum_fallback(pbig, d, "cpu", _state(variables))
        assert acct == jacct and acct["n_allreduce_fwd"] == 17
    np.testing.assert_allclose(_steps(step), want, rtol=1e-5)


def test_accounting_equals_committed_bench_scaling():
    """At the JAX script's defaults (1,024 molecules, a 2,048-node giant
    graph) the accounting equals its committed BENCH_SCALING.json at 1,
    2, 4 and 8 ranks: the molecule-aligned and hybrid bytes, the halo
    bytes and rows, the fallback's bytes and 17 forward all-reduces; the
    hybrid's meshes are [2, 2] and [2, 4]. Shape arithmetic: no step
    runs."""
    with open(os.path.join(ROOT, "BENCH_SCALING.json")) as f:
        want = json.load(f)["lggnn"]
    recs = bsc.molecules(1024)
    assert sum(r.n_dir_edges for r in recs) == want["dir_edges"]
    giant, _ = bsc.giant_graph(2048)
    pbg = graphs.make_packed_batch([giant], task=0, device="cpu")
    assert pbg.num_edge_slots == want["halo_giant_graph"]["dir_edges"]
    tot_v = sum(r.n_nodes for r in recs)
    tot_e = sum(r.n_dir_edges for r in recs)
    pbig = graphs.make_packed_batch(
        recs, node_capacity=((tot_v + 63) // 64) * 64,
        edge_capacity=((tot_e + 63) // 64) * 64, task=0, device="cpu")
    params = bsc.n_params(bsc.lggnn())
    for d in (1, 2, 4, 8):
        row = want["molecule_aligned"]["devices"][str(d)]
        assert bsc.bn_comm_bytes(d, params) == row["comm_bytes_per_step"]
        _, comm = bsc.molecule_aligned(recs, d, "cpu")
        assert comm == row["comm_bytes_per_step"]
        if d >= 4:
            row = want["hybrid_dp_x_edge"]["devices"][str(d)]
            _, comm, shape = bsc.hybrid(recs, d, "cpu")
            assert (comm, shape) == (row["comm_bytes_per_step"], row["mesh"])
        row = want["halo_giant_graph"]["devices"][str(d)]
        _, acct = bsc.halo_giant(pbg, d, "cpu")
        assert (acct["train_step_bytes_per_chip"], acct["node_halo_rows"],
                acct["edge_halo_rows"]) == (row["comm_bytes_per_step"],
                                            row["halo_rows_node"],
                                            row["halo_rows_edge"])
        row = want["psum_fallback"]["devices"][str(d)]
        _, acct = bsc.psum_fallback(pbig, d, "cpu")
        assert (acct["train_step_bytes_per_chip"], acct["n_allreduce_fwd"]) \
            == (row["comm_bytes_per_step"], row["allreduces_fwd"])


def test_main_writes_the_ports_json(tmp_path):
    """A whole run at a tiny size on the CPU, then --project_from on its
    JSON: every mode's rows at the counts [1, 2, 4] (the hybrid at 4),
    the note, the link bandwidth labelled an assumption from the
    specification, the projection; the re-anchored run keeps the earlier
    rows and adds this run's one-rank times."""
    out = tmp_path / "bench_scaling_torch"
    argv = ["--device", "cpu", "--molecules", "32", "--nodes", "64",
            "--steps", "1", "--ranks", "4", "--out", str(out)]
    got = bsc.main(argv)
    assert got["assumed_link_bytes_per_s"]["source"] == "spec"
    assert got["assumed_link_bytes_per_s"]["value"] == 450e9
    assert "not scaling" in got["note"] and got["device"] == "cpu"
    lg = got["lggnn"]
    for mode in ("molecule_aligned", "halo_giant_graph", "psum_fallback"):
        assert sorted(lg[mode]["devices"]) == [1, 2, 4]
        assert lg[mode]["devices"][1]["comm_bytes_per_step"] == 0
    assert sorted(lg["hybrid_dp_x_edge"]["devices"]) == [4]
    assert sorted(got["bare_spmm"]["devices"]) == [1, 2, 4]
    assert sorted(got["projection"]["molecule_aligned"]) == [2, 4]
    with open(out / "scaling.json") as f:
        saved = json.load(f)
    again = bsc.main(argv + ["--project_from", str(out / "scaling.json"),
                             "--link_gbps", "100"])
    assert again["lggnn"] == saved["lggnn"]
    assert set(again["t1_this_backend_s"]) == {
        "molecule_aligned", "halo_giant_graph", "psum_fallback", "device"}
    assert again["assumed_link_bytes_per_s"]["value"] == 100e9
    assert sorted(again["projection"]["psum_fallback"]) == [2, 4]
    with pytest.raises(SystemExit):
        bsc.main(["--device", "cpu", "--out", str(tmp_path / "scaling")])
