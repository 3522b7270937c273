"""Molecule-aligned sharded training of the packed models (--edge_shards,
--dp M --edge_shards N) in the port against the JAX package on the CPU,
JAX's shard_maps running on the 8 virtual CPU devices and the port's
ranks all on the CPU: partition_records, make_packed_shards and
ShardedPackedLoader bit-equal (empty shards and the overflow error
included); MaskedBatchNorm(axis_name=) against JAX's under shard_map;
sharded_packed_loss and its gradients; a few make_sharded_step_fns
steps; whole run_experiment runs; scanned against stepwise epochs;
predict --packed on a sharded run's checkpoint; the flattening of the
ranks' shards (graph-id padding, padded edges); plain --dp's refusal;
bench_torch.py --edge_shards at a tiny size (resume:
tests/test_torch_ccn_parallel.py). Weights are JAX's init, carried over by
hgnn2_torch.convert.

Tolerances, each f32 summed in another order by the two packages (the
port sums over the ranks' flattened batch, JAX per shard, then psums):
BN outputs and running stats rtol 1e-5 (atol 1e-6); losses rtol 1e-5;
gradients within 1e-5 x the largest |grad|; steps with
SGD with momentum, as JAX's sharded tests train: parameters atol 1e-6 +
rtol 1e-5, BN stats atol 1e-5 + rtol 1e-5; epoch histories rtol 1e-4, the line-graph model's
valid and test metrics rtol 1e-2 (its eval-mode BN reads running means
that Adamax or SGD walk by rounding; tests/test_torch_packed_train.py)."""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from hgnn2_tpu.cli import common as jcommon
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import layers as jlayers
from hgnn2_tpu.nn import packed as jpacked
from hgnn2_tpu.parallel import spmd as jspmd
from hgnn2_tpu.training import optim as joptim
from hgnn2_tpu.training import sharded as jsharded
from hgnn2_tpu.training.config import OptimConfig as JOptimConfig
from hgnn2_tpu.training.config import TrainConfig as JTrainConfig

import bench_torch
from hgnn2_torch import convert, graphs
from hgnn2_torch.cli import common, main_gnn_qm9, predict
from hgnn2_torch.data import qm9
from hgnn2_torch.nn import layers, packed
from hgnn2_torch.parallel import spmd
from hgnn2_torch.training import optim, sharded
from hgnn2_torch.training.config import OptimConfig, TrainConfig

torch.set_num_threads(2)

PB_FIELDS = ("x", "node_gid", "node_mask", "src", "dst", "w", "rev",
             "edge_gid", "edge_mask", "y", "gmask")
BN_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _mesh(dp, S):
    return Mesh(np.array(jax.devices()[:dp * S]).reshape(dp, S),
                ("data", "edge"))


def _assert_stacks_equal(got, want):
    assert got.n_graphs == want.n_graphs
    for name in PB_FIELDS:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# ------------------------------------------------------------ (a) shards


@pytest.mark.parametrize("n,S", [(13, 2), (11, 4)])
def test_partition_records_identical(n, S):
    recs, jrecs = qm9.synthetic_qm9_like(n, seed=4), jqm9.synthetic_qm9_like(n, seed=4)
    got = spmd.partition_records(recs, S)
    want = jspmd.partition_records(jrecs, S)
    pos = {id(r): i for i, r in enumerate(recs)}
    jpos = {id(r): i for i, r in enumerate(jrecs)}
    assert [[pos[id(r)] for r in s] for s in got] == \
        [[jpos[id(r)] for r in s] for s in want]


@pytest.mark.parametrize("n,S", [(9, 2), (3, 4)])
def test_make_packed_shards_bit_equal(n, S):
    """3 molecules over 4 shards leaves one all-padding shard."""
    kw = dict(node_capacity=140, edge_capacity=300, graphs_per_shard=5, task=0)
    got = spmd.make_packed_shards(qm9.synthetic_qm9_like(n, seed=2), S,
                                  device="cpu", **kw)
    want = jspmd.make_packed_shards(jqm9.synthetic_qm9_like(n, seed=2), S, **kw)
    assert got.x.shape[0] == S
    _assert_stacks_equal(got, want)
    if n < S:
        assert float(got.gmask[-1].sum()) == 0.0
    with pytest.raises(ValueError, match="graphs_per_shard"):  # pigeonholes
        spmd.make_packed_shards(qm9.synthetic_qm9_like(n, seed=2), S,
                                device="cpu",
                                **{**kw, "graphs_per_shard": -(-n // S) - 1})


@pytest.mark.parametrize("n_data,S", [(1, 2), (1, 4), (2, 2)])
def test_sharded_packed_loader_bit_equal(n_data, S):
    """37 molecules in minibatches of 12: capacities, every stacked batch
    and two shuffled epochs' orders equal JAX's."""
    kw = dict(task=0, shuffle=True, seed=3, n_data=n_data)
    loader = sharded.ShardedPackedLoader(qm9.synthetic_qm9_like(37, seed=1),
                                         12, S, device="cpu", **kw)
    jloader = jsharded.ShardedPackedLoader(jqm9.synthetic_qm9_like(37, seed=1),
                                           12, S, **kw)
    assert len(loader) == len(jloader) == 4
    assert (loader.node_capacity, loader.edge_capacity,
            loader.graphs_per_shard) == (jloader.node_capacity,
                                         jloader.edge_capacity,
                                         jloader.graphs_per_shard)
    for got, want in zip(loader.batches(), jloader.batches()):
        assert got.x.shape[:loader.lead] == ((n_data, S) if n_data > 1 else (S,))
        _assert_stacks_equal(got, want)
    for _ in range(2):
        np.testing.assert_array_equal(loader.epoch_order(),
                                      jloader.epoch_order())
    loader.release()
    assert len(loader) == 4 and loader.batches() == []


# ------------------------------------------------------------- (b) BN


@pytest.mark.parametrize("lead", [(4,), (2, 2)])
def test_masked_batch_norm_axis_name_matches_jax(rng, lead):
    """Shards of 13 positions, some all padding: JAX's module under
    shard_map (psums over "edge", or ("data", "edge")) against the port's
    over the shards laid end to end."""
    R, Vl, F = int(np.prod(lead)), 13, 4
    h = (rng.standard_normal(lead + (1, Vl, F)) * 3 + 1).astype(np.float32)
    mask = (rng.random(lead + (1, Vl)) < 0.6).astype(np.float32)
    mask.reshape(R, Vl)[-1] = 0.0
    axes = ("data", "edge") if len(lead) == 2 else ("edge",)
    zero = (0,) * len(lead)
    variables = _np(jlayers.MaskedBatchNorm().init(
        jax.random.key(2), h[zero], mask[zero], True))
    variables["params"] = {k: v + 0.3 for k, v in variables["params"].items()}
    jbn = jlayers.MaskedBatchNorm(axis_name=axes if len(lead) == 2 else "edge")

    def local(hh, mm):
        out, upd = jbn.apply(variables, hh[zero], mm[zero], True,
                             mutable=["batch_stats"])
        return out.reshape((1,) * len(lead) + out.shape), upd["batch_stats"]

    spec = P(*axes)
    want, stats = shard_map(local, mesh=_mesh(*((1,) + lead)[-2:]),
                            in_specs=(spec, spec), out_specs=(spec, P()),
                            check_rep=False)(h, mask)
    bn = layers.MaskedBatchNorm(F, axis_name=axes if len(lead) == 2 else "edge")
    bn.load_state_dict({"scale": torch.from_numpy(variables["params"]["scale"]),
                        "bias": torch.from_numpy(variables["params"]["bias"]),
                        "mean": torch.zeros(F), "std": torch.ones(F)})
    with torch.no_grad():
        got = bn.train()(torch.from_numpy(h.reshape(1, R * Vl, F)),
                         torch.from_numpy(mask.reshape(1, R * Vl)))
    np.testing.assert_allclose(got.numpy().reshape(h.shape), np.asarray(want),
                               **BN_TOL)
    for f in ("mean", "std"):
        np.testing.assert_allclose(getattr(bn, f).numpy(),
                                   np.asarray(stats[f]), **BN_TOL)


# ----------------------------------------------------- (c) loss, grads


def _models(arch):
    """(JAX's class, the port's, their shared keywords): PackedLGGNN L=3
    h=2 order 2, or PackedGNN L=4 h=2 J=2."""
    if arch == "lggnn":
        return (jpacked.PackedLGGNN, packed.PackedLGGNN,
                dict(n_features=2, n_layers=3, J=1, order=2))
    return (jpacked.PackedGNN, packed.PackedGNN,
            dict(n_features=2, n_layers=4, J=2))


@pytest.fixture(scope="module")
def stacks():
    """30 molecules over 2 and 4 shards at the loader's capacities."""
    out = {}
    for S in (2, 4):
        mine = sharded.ShardedPackedLoader(qm9.synthetic_qm9_like(30, seed=6),
                                           15, S, task=0, device="cpu")
        ref = jsharded.ShardedPackedLoader(jqm9.synthetic_qm9_like(30, seed=6),
                                           15, S, task=0)
        out[S] = mine.batches(), ref.batches()
    ys = np.array([r.y[0] for r in qm9.synthetic_qm9_like(30, seed=6)])
    return out, float(ys.mean()), float(ys.std())


@pytest.mark.parametrize("arch,S", [("lggnn", 2), ("gnn", 4)])
def test_sharded_packed_loss_and_grads_match_jax(stacks, arch, S):
    out, mean, std = stacks
    (mine, ref), mesh = out[S], _mesh(1, S)
    jcls, cls, kw = _models(arch)
    jmodel = jcls(bn_axis="edge", **kw)
    local = jax.tree.map(lambda v: v[0], ref[0])
    variables = _np(jcls(**kw).init(jax.random.key(5), local, train=True))
    model = cls(in_features=5, bn_axis="edge", **kw)
    model.load_state_dict(convert.packed_variables_from_flax(variables))

    with jax.sharding.set_mesh(mesh):
        jloss = jspmd.sharded_packed_loss(jmodel, mesh, "regression", mean, std)
        want, jgrads = jax.jit(jax.value_and_grad(lambda p: jloss(
            {"params": p, "batch_stats": variables["batch_stats"]},
            ref[0])))(variables["params"])
    loss = spmd.sharded_packed_loss(model, spmd.RankGrid(1, S, "cpu"),
                                    "regression", mean, std)(mine[0])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    grads = dict(_leaves(convert.packed_variables_to_flax(
        {n: p.grad for n, p in model.named_parameters()})["params"]))
    jgrads = dict(_leaves(_np(jgrads)))
    top = max(np.abs(g).max() for g in jgrads.values())
    assert grads.keys() == jgrads.keys()
    for path, g in grads.items():
        np.testing.assert_allclose(g, jgrads[path], rtol=0, atol=1e-5 * top,
                                   err_msg=str(path))


# ---------------------------------------------------------- (d) steps


@pytest.mark.parametrize("n_data,S", [(2, 2)])
def test_sharded_steps_match_jax(n_data, S):
    """4 steps of make_sharded_step_fns over the two batches of a
    ShardedPackedLoader (PackedLGGNN, L=3, h=2), SGD with momentum 0.9 at
    lr 1e-3 halved every epoch of 2 steps, as JAX's sharded tests train
    (tests/test_parallel.py): Adamax's sign-like update would walk the
    cv2 biases, pure shifts before BN with rounding-level gradients, by
    lr a step in the direction each package's sum order rounds to. Each
    step's metrics, then the parameters (atol 1e-6 + rtol 1e-5) and the
    BN running stats after them."""
    recs = qm9.synthetic_qm9_like(30, seed=8)
    ys = np.array([r.y[0] for r in recs])
    mean, std = float(ys.mean()), float(ys.std())
    axes = ("data", "edge") if n_data > 1 else ("edge",)
    bn_axis = axes if n_data > 1 else "edge"
    mine = sharded.ShardedPackedLoader(recs, 15, S, task=0, n_data=n_data,
                                       device="cpu").batches()
    ref = jsharded.ShardedPackedLoader(jqm9.synthetic_qm9_like(30, seed=8), 15,
                                       S, task=0, n_data=n_data).batches()
    jcls, cls, kw = _models("lggnn")
    jmodel = jcls(bn_axis=bn_axis, **kw)
    local = jax.tree.map(lambda v: v[(0,) * len(axes)], ref[0])
    variables = _np(jcls(**kw).init(jax.random.key(1), local, train=True))
    ocfg = dict(optim="sgd", lr=1e-3, momentum=0.9, lr_damping=0.5,
                epoch_step=1)
    tx = joptim.build_optimizer(JOptimConfig(**ocfg), 2)
    mesh = _mesh(n_data, S)
    params, bstats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    model = cls(in_features=5, bn_axis=bn_axis, **kw)
    model.load_state_dict(convert.packed_variables_from_flax(variables))
    opt, sched = optim.build_optimizer(OptimConfig(**ocfg), 2, model.parameters())
    grid = spmd.RankGrid(n_data, S, "cpu")
    step, _ = sharded.make_sharded_step_fns(model, grid, opt, sched,
                                            "regression", mean, std, axes)
    with jax.sharding.set_mesh(mesh):
        jstep, _ = jsharded.make_sharded_step_fns(jmodel, mesh, tx, "regression",
                                                  mean, std, axes)
        for t in range(4):
            params, bstats, opt_state, jm = jstep(params, bstats, opt_state,
                                                  ref[t % 2])
            m = step(mine[t % 2])
            for k in ("loss", "mae", "count"):
                np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                           rtol=1e-5, err_msg=f"step {t} {k}")
    final = convert.packed_variables_to_flax(model.state_dict())
    for tree, want, tol in (("params", params, 1e-6),
                            ("batch_stats", bstats, 1e-5)):
        want = dict(_leaves(_np(want)))
        for path, p in _leaves(final[tree]):
            np.testing.assert_allclose(p, want[path], rtol=1e-5, atol=tol,
                                       err_msg=str(path))


# ------------------------------------------------- (e) run_experiment


def _cfgs(tmp_path, tag, arch, dp, es, **extra):
    """JAX's and the port's TrainConfig of one sharded run: JAX's test
    sizes (tests/test_parallel.py), 48 molecules in batches of 16, L=3,
    h=2, order 2, 2 epochs of SGD at lr 1e-5."""
    cfgs = []
    for cls, dev in ((JTrainConfig, None), (TrainConfig, "cpu")):
        cfg = cls(batch_size=16, epochs=2, dp=dp, edge_shards=es,
                  log_path=str(tmp_path / f"{tag}_{dev or 'jax'}"), **extra)
        if dev:
            cfg.device = dev
        cfg.model.arch, cfg.model.n_layers, cfg.model.n_features = arch, 3, 2
        cfg.model.order = 2
        cfg.optim.optim, cfg.optim.lr, cfg.optim.momentum = "sgd", 1e-5, 0.0
        cfg.data.dataset, cfg.data.n_synthetic = "qm9_synthetic", 48
        cfgs.append(cfg)
    return cfgs


def _recorded_inits(monkeypatch, classes):
    """The initial variables of every JAX model init that follows."""
    inits = []
    for cls in classes:
        orig = cls.init

        def record(self, *args, orig=orig, **kwargs):
            inits.append(_np(orig(self, *args, **kwargs)))
            return inits[-1]

        monkeypatch.setattr(cls, "init", record)
    return inits


def _assert_histories(got, want, eval_rtol=1e-4):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            if k != "epoch_time_s":
                rtol = eval_rtol if k.startswith(("valid_", "test_")) else 1e-4
                np.testing.assert_allclose(a[k], b[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("arch,dp,es", [("lggnn", 1, 4), ("gnn", 1, 2),
                                        ("lggnn", 2, 2)])
def test_run_experiment_sharded_matches_jax(tmp_path, monkeypatch, arch, dp, es):
    inits = _recorded_inits(monkeypatch, (jpacked.PackedLGGNN, jpacked.PackedGNN))
    jcfg, cfg = _cfgs(tmp_path, "run", arch, dp, es)
    _, want = jcommon.run_experiment(jcfg)
    model, got = common.run_experiment(cfg, init_params=inits[0])
    bn_axis = ("data", "edge") if dp > 1 else "edge"
    assert isinstance(model, packed.PackedLGGNN if arch == "lggnn"
                      else packed.PackedGNN)
    bn = model.layer0_node_bn if arch == "lggnn" else model.layer0_bn
    assert model.bn_axis == bn.axis_name == bn_axis
    _assert_histories(got, want, 1e-2 if arch == "lggnn" else 1e-4)
    assert (tmp_path / "run_cpu" / "target_stats.npz").exists()


# ------------------------------------------------------- (f) scan; (g)


@pytest.mark.parametrize("dp,es", [(1, 2), (2, 2)])
def test_scanned_equals_stepwise(tmp_path, dp, es):
    """The scanned epochs (make_sharded_scan_epoch) and the stepwise ones
    run the same body over the same order: equal histories and weights."""
    runs = []
    for scan in (True, False):
        _, cfg = _cfgs(tmp_path, f"scan{scan}", "lggnn", dp, es,
                       scan_epochs=scan)
        cfg.optim.optim = "adamax"
        model, history = common.run_experiment(cfg)
        runs.append((model.state_dict(), history))
    (sa, ha), (sb, hb) = runs
    for a, b in zip(ha, hb):
        for k in a:
            if k != "epoch_time_s":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    for k, v in sa.items():
        torch.testing.assert_close(v, sb[k], rtol=0, atol=1e-7, msg=k)


def test_predict_packed_on_sharded_checkpoint(tmp_path):
    """main_gnn_qm9 --lg --edge_shards 2 --ckpt, then predict --packed on
    its checkpoint: the predictions are the trained model's eval forward
    over the same molecules."""
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "preds.npz")
    model, _ = main_gnn_qm9.main([
        "--lg", "--update", "2", "--L", "3", "--h", "2", "--bs", "16",
        "--epochs", "1", "--n_synthetic", "40", "--edge_shards", "2",
        "--ckpt", ckpt, "--device", "cpu", "--log_path", str(tmp_path / "log")])
    result = predict.main(["--ckpt", ckpt, "--arch", "lggnn", "--packed",
                           "--L", "3", "--h", "2", "--update", "2",
                           "--n_synthetic", "40", "--bs", "16", "--device",
                           "cpu", "--out", out])
    preds = np.load(out)["predictions"]
    assert result["n"] == 40 and preds.shape == (40,)
    ts = common.saved_target_stats(ckpt)
    model.eval()
    with torch.no_grad():
        want = model(graphs.make_packed_batch(
            qm9.synthetic_qm9_like(40, seed=0), task=0, device="cpu"))
    np.testing.assert_allclose(preds, want[:, 0].numpy() * ts.std[0]
                               + ts.mean[0], rtol=1e-5, atol=1e-5)


# ----------------------------------------------------- (h) flattening


def test_flatten_shards_traps():
    """5 molecules over 4 shards of 3 graph slots (padding graphs in every
    shard, one shard holding a single molecule): padding graph ids go to
    the one drop slot R Gl, not onto the next shard's first graph; real
    ids, vertex and edge indices move by their shard's block; padded edges
    point at their own shard's last node and at themselves; an eval
    forward over the flattened batch equals one a shard."""
    S, Gl, Vl, El = 4, 3, 60, 140
    stacked = spmd.make_packed_shards(qm9.synthetic_qm9_like(5, seed=9), S, Vl,
                                      El, Gl, task=0, device="cpu")
    flat = spmd.flatten_shards(stacked)
    assert flat.n_graphs == S * Gl and flat.x.shape == (S * Vl, 5)
    for r in range(S):
        v, e = slice(r * Vl, (r + 1) * Vl), slice(r * El, (r + 1) * El)
        real_v = stacked.node_mask[r] > 0
        gid = flat.node_gid[v]
        assert torch.equal(gid[real_v], stacked.node_gid[r][real_v] + r * Gl)
        assert bool((gid[~real_v] == S * Gl).all())
        real_e = stacked.edge_mask[r] > 0
        assert torch.equal(flat.edge_gid[e][real_e],
                           stacked.edge_gid[r][real_e] + r * Gl)
        assert bool((flat.edge_gid[e][~real_e] == S * Gl).all())
        for f in ("src", "dst"):
            assert torch.equal(getattr(flat, f)[e], getattr(stacked, f)[r] + r * Vl)
            assert bool((getattr(flat, f)[e][~real_e] == r * Vl + Vl - 1).all())
        rev = flat.rev[e]
        assert torch.equal(rev, stacked.rev[r] + r * El)
        assert torch.equal(rev[~real_e], torch.arange(r * El, (r + 1) * El,
                                                      dtype=rev.dtype)[~real_e])
    assert int(stacked.gmask.sum()) == 5 and bool((stacked.gmask.sum(1) < Gl).all())
    model = packed.PackedLGGNN(2, 3, in_features=5, J=1, order=2,
                               bn_axis="edge").eval()
    with torch.no_grad():
        got = model(flat).reshape(S, Gl, -1)
        for r in range(S):
            one = graphs.PackedGraphBatch(**{
                f: getattr(stacked, f)[r] for f in PB_FIELDS}, n_graphs=Gl)
            torch.testing.assert_close(got[r], model(one), rtol=1e-6, atol=1e-6)


def test_local_partitioned_spmm_matches_jax(rng):
    stacked = spmd.make_packed_shards(qm9.synthetic_qm9_like(9, seed=3), 4, 70,
                                      150, 4, task=0, device="cpu")
    jst = jspmd.make_packed_shards(jqm9.synthetic_qm9_like(9, seed=3), 4, 70,
                                   150, 4, task=0)
    x = rng.standard_normal((4, 70, 3)).astype(np.float32)
    mesh = _mesh(1, 4)
    with jax.sharding.set_mesh(mesh):
        want = jspmd.local_partitioned_spmm(mesh, 70)(jst.src, jst.dst, jst.w, x)
    got = spmd.local_partitioned_spmm(spmd.RankGrid(1, 4, "cpu"), 70)(
        stacked.src, stacked.dst, stacked.w, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# --------------------------------------------------------------- (i)


def test_rank_grid_checks_the_stacks():
    """A stack whose rank dims are not the grid's along the step's axes
    is refused, as JAX's shard_map refuses it; so are unknown axes."""
    stacked = spmd.make_packed_shards(qm9.synthetic_qm9_like(6, seed=1), 2, 60,
                                      140, 3, task=0, device="cpu")
    grid = spmd.RankGrid(1, 2, "cpu")
    grid.check(stacked, "edge")
    with pytest.raises(ValueError, match="stacked ranks"):
        spmd.RankGrid(1, 4, "cpu").check(stacked, "edge")
    with pytest.raises(ValueError, match="stacked ranks"):
        spmd.sharded_packed_loss(packed.PackedGNN(1, 2, in_features=5),
                                 spmd.RankGrid(2, 3, "cpu"))(stacked)
    with pytest.raises(ValueError, match="mesh axes"):
        grid.check(stacked, "model")
    assert float(spmd.psum(torch.ones(2, 3), ("data", "edge"), 1).sum()) == 6.0


def test_plain_dp_still_raises_naming_f3(tmp_path):
    """Named for the refusal it held before step F3 was ported: --dp 2
    without edge shards now trains the dense line-graph GNN data-parallel
    (tests/test_torch_dp.py holds it to JAX's), not the sharded trainer;
    --dp 0 --edge_shards 0 on the CPU counts one device."""
    _, cfg = _cfgs(tmp_path, "dp", "lggnn", 2, 1)
    model, history = common.run_experiment(cfg)
    assert type(model).__name__ == "GNNLineGraph" and len(history) == 2
    _, cfg = _cfgs(tmp_path, "dp0", "lggnn", 0, 0)  # 0: the CPU counts 1
    assert len(common.run_experiment(cfg)[1]) == 2


def test_bench_torch_sharded_runs_on_cpu():
    """bench_torch.main --edge_shards 2 --dp 2 at a tiny size: one JSON
    line with the sharded rates beside the unsharded packed ones."""
    out = io.StringIO()
    with redirect_stdout(out):
        result = bench_torch.main(["--layout", "packed", "--arch", "lggnn",
                                   "--edge_shards", "2", "--dp", "2",
                                   "--device", "cpu", "--molecules", "64",
                                   "--batch", "16", "--epochs", "1"])
    lines = out.getvalue().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert result["metric"] == \
        "lggnn_qm9_L5_packed_dp2_es2_train_throughput_end_to_end"
    assert result["edge_shards"] == 2 and result["dp"] == 2
    assert result["steps_per_epoch"] == 4
    for key in ("value", "eager_value", "ms_per_step", "eager_ms_per_step"):
        assert result[key] > 0 and result["unsharded"][key] > 0
