"""Several processes (hgnn2_torch.parallel.multihost and
hgnn2_torch.scripts.dryrun_multihost) against the JAX package's
single-process meshes on the 8 virtual CPU devices.

The dry run starts 2 gloo processes on the CPU (torch only; the JAX side
runs in this process meanwhile) that train its three phases at a small
width from JAX's init: dp (GNNLineGraph over a "data" axis across the
processes), edge (PackedLGGNN over a 4-rank "edge" axis, 2 ranks a
process) and hybrid (a (2, 2) grid, data = processes). JAX runs the same
global batches and weights on a 2-device data mesh, a 4-rank edge mesh
and a (2, 2) mesh; its SGD keeps each step's gradients in its state.
Held: each step's loss rtol 1e-5; the step-0 gradients within 1e-4 x the
largest |grad| (none counted once a process too many); the BN running
stats after the steps rtol 1e-5 (atol 1e-6) and the parameters atol
1e-5; the processes' losses equal to 1e-6. Without spawning:
shard_records, setup_distributed's environment handling, global_mesh's
process groups and the refusal of unequal local shapes."""

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import Mesh

from hgnn2_tpu import graphs as jgraphs
from hgnn2_tpu.nn import models as jmodels
from hgnn2_tpu.nn import packed as jpacked
from hgnn2_tpu.parallel import multihost as jmultihost
from hgnn2_tpu.parallel import spmd as jspmd
from hgnn2_tpu.training import sharded as jsharded

from hgnn2_torch import convert, graphs
from hgnn2_torch.data import qm9
from hgnn2_torch.parallel import multihost, spmd
from hgnn2_torch.scripts import dryrun_multihost as dry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 2 processes x 2 ranks, 2 steps, L=3, h=2
ARGS = dry.parse_args(["--device", "cpu"])
KW = dict(n_features=ARGS.features, n_layers=ARGS.layers, J=1, order=2)


def _mesh(dp, S):
    return Mesh(np.array(jax.devices()[:dp * S]).reshape(dp, S),
                ("data", "edge"))


def _to_jax(batch, cls):
    fields = {f: getattr(batch, f) for f in cls.__dataclass_fields__}
    return cls(**{k: jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
                  else v for k, v in fields.items()})


def _keeping_sgd(lr):
    """SGD whose state holds the last step's gradients."""

    def init(params):
        return {"g": jax.tree.map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        return jax.tree.map(lambda g: -lr * g, grads), {"g": grads}

    return optax.GradientTransformation(init, update)


def _jax_dp(variables, gbatch):
    """JAX's DP steps on the global batch sharded over a 2-device data
    mesh: (losses, step-0 grads, final variables)."""
    model = jmodels.GNNLineGraph(**KW)

    def loss_fn(p, bstats, b):
        out, upd = model.apply({"params": p, "batch_stats": bstats}, b,
                               train=True, mutable=["batch_stats"])
        gm = (b.n_nodes > 0).astype(jnp.float32)
        return (((out[:, 0] - b.y) ** 2) * gm).sum() / gm.sum(), upd["batch_stats"]

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    mesh = jspmd.make_mesh(2)
    params, bstats = variables["params"], variables["batch_stats"]
    losses, g0 = [], None
    with jax.sharding.set_mesh(mesh):
        b = jspmd.shard_batch(mesh, gbatch)
        for _ in range(ARGS.steps):
            (loss, bstats), g = step(params, bstats, b)
            losses.append(float(loss))
            g0 = g if g0 is None else g0
            params = jax.tree.map(lambda p, gg: p - dry.DP_LR * gg, params, g)
    return losses, g0, {"params": params, "batch_stats": bstats}


def _jax_sharded(variables, stacked, mesh, axes):
    model = jpacked.PackedLGGNN(bn_axis="edge" if axes == ("edge",) else axes,
                                **KW)
    tx = _keeping_sgd(dry.PACKED_LR)
    params, bstats = variables["params"], variables["batch_stats"]
    opt, losses, g0 = tx.init(params), [], None
    with jax.sharding.set_mesh(mesh):
        step, _ = jsharded.make_sharded_step_fns(model, mesh, tx, "regression",
                                                 0.0, 1.0, axes)
        for _ in range(ARGS.steps):
            params, bstats, opt, mets = step(params, bstats, opt, stacked)
            losses.append(float(mets["loss"]))
            g0 = opt["g"] if g0 is None else g0
    return losses, g0, {"params": params, "batch_stats": bstats}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _check(phase, recs, want):
    losses, g0, final = want
    grads = convert.variables_from_flax({"params": _np(g0)})
    state = convert.variables_from_flax(_np(final))
    top = max(float(g.abs().max()) for g in grads.values())
    for p, rec in enumerate(recs):
        msg = f"{phase}, process {p}"
        np.testing.assert_allclose(rec["losses"], losses, rtol=1e-5,
                                   err_msg=msg)
        assert rec["grads"].keys() == grads.keys()
        for k, g in rec["grads"].items():
            np.testing.assert_allclose(g.numpy(), grads[k].numpy(), rtol=0,
                                       atol=1e-4 * top, err_msg=f"{msg} {k}")
        assert rec["state"].keys() == state.keys()
        for k, v in rec["state"].items():
            tol = (dict(rtol=1e-5, atol=1e-6) if k.endswith((".mean", ".std"))
                   else dict(rtol=0, atol=1e-5))
            np.testing.assert_allclose(v.numpy(), state[k].numpy(),
                                       err_msg=f"{msg} {k}", **tol)
        np.testing.assert_allclose(rec["losses"], recs[0]["losses"], rtol=0,
                                   atol=1e-6, err_msg=msg)


def test_two_process_dp_edge_and_hybrid_match_jax(tmp_path):
    dp_parts = dry.dp_batches(ARGS)
    gbatch = jax.tree.map(lambda *xs: jnp.concatenate(xs), *[
        _to_jax(b, jgraphs.DenseGraphBatch) for b in dp_parts])
    estacked = _to_jax(dry.edge_stacked(ARGS), jgraphs.PackedGraphBatch)
    hstacked = _to_jax(dry.hybrid_data(ARGS)[1], jgraphs.PackedGraphBatch)
    inits = {
        "dp": jmodels.GNNLineGraph(**KW).init(jax.random.key(0), gbatch,
                                              train=True),
        "edge": jpacked.PackedLGGNN(**KW).init(
            jax.random.key(1), jax.tree.map(lambda v: v[0], estacked),
            train=True),
        "hybrid": jpacked.PackedLGGNN(**KW).init(
            jax.random.key(2), jax.tree.map(lambda v: v[0, 0], hstacked),
            train=True)}
    weights, out = tmp_path / "weights", tmp_path / "out"
    weights.mkdir()
    for phase, v in inits.items():
        torch.save(convert.variables_from_flax(_np(v)), weights / f"{phase}.pt")
    proc = subprocess.Popen(
        [sys.executable, "-m", "hgnn2_torch.scripts.dryrun_multihost",
         "--device", "cpu", "--weights", str(weights), "--out", str(out),
         "--timeout", "240"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        want = {"dp": _jax_dp(_np(inits["dp"]), gbatch),
                "edge": _jax_sharded(_np(inits["edge"]), estacked, _mesh(1, 4),
                                     ("edge",)),
                "hybrid": _jax_sharded(_np(inits["hybrid"]), hstacked,
                                       _mesh(2, 2), spmd.AXES)}
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stderr[-4000:]
    assert "dryrun_multihost ok: 2 processes" in stdout, stdout
    for phase in dry.PHASES:
        recs = [torch.load(out / f"{phase}_{p}.pt", weights_only=False)
                for p in range(ARGS.processes)]
        _check(phase, recs, want[phase])
        # the cross-process traffic a step: every psum and one gradient sum
        assert recs[0]["comm"]["grad_calls"] == 1
        assert recs[0]["comm"]["psum_calls"] > 0


def test_shard_records_matches_jax():
    recs = list(range(11))
    for P in (2, 3):
        for p in range(P):
            assert (multihost.shard_records(recs, P, p)
                    == jmultihost.shard_records(recs, P, p))
    assert multihost.shard_records(recs) == recs  # one process


def test_setup_distributed_environment(monkeypatch):
    calls = []
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    for var in ("HGNN2_COORDINATOR", "HGNN2_NUM_PROCESSES", "HGNN2_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    multihost.setup_distributed()  # nothing set: one process, a no-op
    assert calls == [] and multihost.process_count() == 1
    monkeypatch.setenv("HGNN2_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("HGNN2_NUM_PROCESSES", "2")
    monkeypatch.setenv("HGNN2_PROCESS_ID", "1")
    multihost.setup_distributed(backend="nccl")
    (args, kw), = calls
    assert args == ("nccl",)
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == (
        "tcp://localhost:1234", 2, 1)
    multihost.setup_distributed("tcp://h:9", 4, 3)  # arguments win
    assert calls[-1][1]["init_method"] == "tcp://h:9"
    assert (calls[-1][1]["world_size"], calls[-1][1]["rank"]) == (4, 3)
    monkeypatch.delenv("HGNN2_PROCESS_ID")
    with pytest.raises(ValueError, match="process's id"):
        multihost.setup_distributed()


@pytest.mark.parametrize("P,R,names,shape,local,groups", [
    (2, 1, ("data",), None, (1, 1), {0: {"data": None}}),
    (2, 2, ("edge",), None, (1, 2), {0: {"edge": None}}),
    (2, 2, spmd.AXES, (2, 2), (1, 2), {1: {"data": None}}),
    (4, 1, spmd.AXES, (2, 2), (1, 1),
     {1: {"edge": (0, 1), "data": (1, 3)}, 2: {"edge": (2, 3), "data": (0, 2)}}),
])
def test_global_mesh_groups(monkeypatch, P, R, names, shape, local, groups):
    """Which axes cross processes, and the process group along each
    (None: every process), for each process p of P with R ranks."""
    monkeypatch.setattr(multihost, "process_count", lambda: P)
    monkeypatch.setattr(multihost.dist, "new_group", lambda ranks: tuple(ranks))
    for p, want in groups.items():
        monkeypatch.setattr(multihost, "process_index", lambda p=p: p)
        grid = multihost.global_mesh(names, shape, local_ranks=R, device="cpu")
        assert grid.groups == want and grid.n_processes == P
        assert (grid.local["data"], grid.local["edge"]) == local
        assert grid.size == P * R
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="fit neither"):  # 3 ranks, rows of 2
        multihost.global_mesh(spmd.AXES, (3, 2), local_ranks=3, device="cpu")


def test_make_global_batch_refuses_unequal_shapes(monkeypatch):
    """Another process's local batch of another shape (simulated in the
    all-reduce of the shape signatures): every process raises before a
    step's first collective; equal shapes pass and move to the device."""
    grid = spmd.RankGrid(2, 1, "cpu", groups={"data": None}, local=(1, 1),
                         n_processes=2)
    recs = qm9.synthetic_qm9_like(4, seed=0)
    batch = graphs.make_dense_batch(recs, n_max=32, batch_size=4, task=0,
                                    device="cpu")
    other = graphs.make_dense_batch(recs, n_max=16 * 3, batch_size=4, task=0,
                                    device="cpu")
    monkeypatch.setattr(multihost.dist, "get_backend", lambda: "gloo")

    def seen_with(peer):
        def all_reduce(t, op=None, group=None):
            h = zlib.crc32(repr(
                [(tuple(x.shape), str(x.dtype))
                 for x in multihost._tensors(peer)]).encode())
            t.copy_(torch.maximum(t, torch.tensor([h, -h])))
        return all_reduce

    monkeypatch.setattr(multihost.dist, "all_reduce", seen_with(batch))
    got = multihost.make_global_batch(grid, batch)
    assert torch.equal(got.x, batch.x)
    monkeypatch.setattr(multihost.dist, "all_reduce", seen_with(other))
    with pytest.raises(ValueError, match="different shapes"):
        multihost.make_global_batch(grid, batch)
