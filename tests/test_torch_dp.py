"""Data parallelism over dense batches (--dp M: hgnn2_torch.parallel.spmd's
make_mesh, shard_batch, ShardedLoader, make_dp_train_step; fit(mesh=);
run_experiment) against the JAX package's on the 8 virtual CPU devices,
the port's ranks all on the CPU (tests/test_parallel.py:33-87, 285-368).

SGD throughout: Adamax's sign-like update amplifies reduction-order
noise (tests/test_parallel.py:37, 67-72). Held: a DP step against the
single-device step and JAX's DP step, loss rtol 1e-5 and parameters atol
1e-5; whole runs (gnn L=3 h=2, 64 molecules, 2 epochs, SGD lr 1e-4) at
dp=8 against dp=1 and against JAX's dp=8 run from the same init, every
epoch metric rtol 1e-4; scanned DP == stepwise DP == single device, rtol
1e-4; JAX's refusals, word for word."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import torch

from hgnn2_tpu import graphs as jgraphs
from hgnn2_tpu.cli import common as jcommon
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import models as jmodels
from hgnn2_tpu.parallel import spmd as jspmd
from hgnn2_tpu.training import optim as joptim
from hgnn2_tpu.training import train as jtrain
from hgnn2_tpu.training.config import OptimConfig as JOptimConfig
from hgnn2_tpu.training.config import TrainConfig as JTrainConfig

from hgnn2_torch import convert, graphs
from hgnn2_torch.cli import common, main_gnn_qm9
from hgnn2_torch.data import qm9
from hgnn2_torch.nn import models
from hgnn2_torch.parallel import spmd
from hgnn2_torch.training import optim, train
from hgnn2_torch.training.config import OptimConfig, TrainConfig

torch.set_num_threads(2)

SGD = dict(optim="sgd", lr=1e-2, momentum=0.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_make_mesh_and_shard_batch():
    """Grid shapes and JAX's ValueError; shard_batch checks the split."""
    grid = spmd.make_mesh(8, edge_axis=2, devices="cpu")
    assert grid.shape == dict(jspmd.make_mesh(8, edge_axis=2).shape)
    assert spmd.make_mesh(devices=["cpu"] * 8).shape == {"data": 8, "edge": 1}
    assert spmd.make_mesh(devices="cpu").size == 1  # the CPU counts 1
    with pytest.raises(ValueError) as mine:
        spmd.make_mesh(6, edge_axis=4, devices="cpu")
    with pytest.raises(ValueError) as ref:
        jspmd.make_mesh(6, edge_axis=4)
    assert str(mine.value) == str(ref.value)
    with pytest.raises(NotImplementedError, match="F4"):
        spmd.make_mesh(2, devices=["cpu", "meta"])
    recs = qm9.synthetic_qm9_like(6, seed=0)
    batch = graphs.make_dense_batch(recs, n_max=32, task=0, device="cpu")
    sharded = spmd.shard_batch(spmd.make_mesh(2, devices="cpu"), batch)
    assert torch.equal(sharded.x, batch.x) and sharded.lg_src is None
    with pytest.raises(ValueError, match="not divisible by the 4 data ranks"):
        spmd.shard_batch(spmd.make_mesh(4, devices="cpu"), batch)
    loader = spmd.ShardedLoader([batch, batch], spmd.make_mesh(2, devices="cpu"))
    assert len(loader) == 2 and all(torch.equal(b.y, batch.y) for b in loader)


def test_dp_step_matches_single_device_and_jax():
    """One DP step over an 8-rank mesh (JAX: 8 devices) against the
    single-device step, from JAX's init (GNNLineGraph L=3 h=2 order 1)."""
    recs, jrecs = qm9.synthetic_qm9_like(8, seed=0), jqm9.synthetic_qm9_like(8, seed=0)
    kw = dict(n_max=32, with_line_graph=True, batch_size=8, task=0)
    batch = graphs.make_dense_batch(recs, device="cpu", **kw)
    jbatch = jgraphs.make_dense_batch(jrecs, **kw)
    jm = jmodels.GNNLineGraph(n_features=2, n_layers=3, J=1, order=1)
    tx = joptim.build_optimizer(JOptimConfig(**SGD), steps_per_epoch=1)
    state0 = jtrain.TrainState.create(jm, jbatch, tx, jax.random.key(0))
    jstep = jtrain.make_train_step("regression", 0.0, 1.0)
    jmesh = jspmd.make_mesh(8, edge_axis=1)
    with jax.sharding.set_mesh(jmesh):
        jstate, jmets = jstep(jspmd.replicate(jmesh, state0),
                              jspmd.shard_batch(jmesh, jbatch))
    want = convert.variables_from_flax(_np({"params": jstate.params,
                                            "batch_stats": jstate.batch_stats}))

    def port_step(mesh):
        model = models.GNNLineGraph(in_features=5, n_features=2, n_layers=3,
                                    J=1, order=1)
        model.load_state_dict(convert.variables_from_flax(_np(
            {"params": state0.params, "batch_stats": state0.batch_stats})))
        opt, sched = optim.build_optimizer(OptimConfig(**SGD), 1,
                                           model.parameters())
        step = train.make_train_step(model, opt, sched, "regression", 0.0, 1.0)
        if mesh is None:
            return model, step(batch)
        step = spmd.make_dp_train_step(step, mesh)
        return model, step(spmd.shard_batch(mesh, batch))

    dp_model, dp_mets = port_step(spmd.make_mesh(8, devices=["cpu"] * 8))
    one_model, one_mets = port_step(None)
    for mets in (one_mets, jmets):
        np.testing.assert_allclose(float(dp_mets["loss"]), float(mets["loss"]),
                                   rtol=1e-5)
    got = dp_model.state_dict()
    for ref in (one_model.state_dict(), want):
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)


def _cfgs(tmp_path, tag, dp, scan=True):
    """JAX's and the port's TrainConfig of tests/test_parallel.py's runs:
    gnn L=3 h=2, SGD lr 1e-4, 64 molecules in batches of 16, 2 epochs, no
    batch shuffling (one order for every run)."""
    cfgs = []
    for cls in (JTrainConfig, TrainConfig):
        cfg = cls(batch_size=16, epochs=2, dp=dp, scan_epochs=scan,
                  log_path=str(tmp_path / f"{tag}_{cls.__module__[:9]}"))
        cfg.model.arch, cfg.model.n_layers, cfg.model.n_features = "gnn", 3, 2
        cfg.optim.optim, cfg.optim.lr, cfg.optim.momentum = "sgd", 1e-4, 0.0
        cfg.data.dataset, cfg.data.n_synthetic = "qm9_synthetic", 64
        cfg.data.shuffle_batches = False
        cfgs.append(cfg)
    cfgs[1].device = "cpu"
    return cfgs


def _close(got, want):
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            if k != "epoch_time_s":
                assert np.isfinite(a[k]), k
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)


def test_run_experiment_dp_matches_single_device_and_jax(tmp_path, monkeypatch):
    """dp=8 through run_experiment (ShardedLoader under CachedLoader,
    fit(mesh=)) against dp=1 and JAX's dp=8 run on its 8 virtual
    devices, every run from JAX's init."""
    inits = []
    create = jtrain.TrainState.create

    def record(*args, **kwargs):
        state = create(*args, **kwargs)
        inits.append(_np({"params": state.params,
                          "batch_stats": state.batch_stats}))
        return state

    monkeypatch.setattr(jtrain.TrainState, "create", record)
    jcfg, cfg = _cfgs(tmp_path, "dp8", 8)
    _, jhist = jcommon.run_experiment(jcfg)
    _, h8 = common.run_experiment(cfg, init_params=inits[0])
    _, h1 = common.run_experiment(_cfgs(tmp_path, "dp1", 1)[1],
                                  init_params=inits[0])
    _close(h8, jhist)
    _close(h8, h1)


def test_scanned_dp_equals_stepwise_and_single_device(tmp_path):
    """Scanned epochs compose with the mesh: scanned dp=8 == stepwise
    dp=8 == scanned single device, epoch for epoch."""
    h_scan = common.run_experiment(_cfgs(tmp_path, "scan", 8)[1])[1]
    h_step = common.run_experiment(_cfgs(tmp_path, "step", 8, False)[1])[1]
    h_one = common.run_experiment(_cfgs(tmp_path, "one", 1)[1])[1]
    _close(h_scan, h_step)
    _close(h_scan, h_one)


@pytest.mark.parametrize("change", ["batch", "ccn1d", "packed"])
def test_dp_refusals_match_jax(tmp_path, change):
    """An indivisible batch, CCN and packed models under --dp raise JAX's
    ValueErrors, word for word."""
    errors = []
    for cfg in _cfgs(tmp_path, change, 8):
        cfg.data.n_synthetic = 32
        if change == "batch":
            cfg.batch_size = 30
        elif change == "ccn1d":
            cfg.model.arch, cfg.dp = "ccn1d", 2
        else:
            cfg.model.packed, cfg.dp = True, 2
        with pytest.raises(ValueError) as err:
            (jcommon if isinstance(cfg, JTrainConfig) else common
             ).run_experiment(cfg)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert {"batch": "not divisible", "ccn1d": "scale CCN with --edge_shards",
            "packed": "--packed batches"}[change] in errors[1]


def test_dp_flag_trains_and_fit_refuses_a_grid_over_processes(tmp_path):
    """main_gnn_qm9 --lg --dp 2 trains; --dp 0 on the CPU counts one
    device; fit refuses a grid that spans processes."""
    argv = ["--device", "cpu", "--epochs", "1", "--L", "2", "--h", "2",
            "--n_synthetic", "20", "--bs", "4", "--lg", "--optim", "sgd",
            "--lr", "1e-4"]
    for dp in ("2", "0"):
        _, history = main_gnn_qm9.main(argv + ["--dp", dp, "--log_path",
                                               str(tmp_path / dp)])
        assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
    grid = spmd.RankGrid(2, 1, "cpu", groups={"data": None}, local=(1, 1),
                         n_processes=2)
    with pytest.raises(NotImplementedError, match="over processes"):
        train.fit(models.GNNSimple(5, 2, 2), lambda split: None,
                  TrainConfig(device="cpu"), mesh=grid)


def test_dp_step_over_processes_is_the_step_built_over_the_grid():
    """Over processes make_dp_train_step returns the step built over the
    grid (make_train_step(grid=), eager: gloo cannot be captured) and
    refuses one built without it; in one process it returns any step."""
    model = models.GNNSimple(5, 2, 2)
    opt, sched = optim.build_optimizer(OptimConfig(**SGD), 1,
                                       model.parameters())
    grid = spmd.RankGrid(2, 1, "cpu", groups={"data": None}, local=(1, 1),
                         n_processes=2)
    plain = train.make_train_step(model, opt, sched)
    with pytest.raises(ValueError, match="built over it"):
        spmd.make_dp_train_step(plain, grid)
    step = train.make_train_step(model, opt, sched, grid=grid)
    assert spmd.make_dp_train_step(step, grid) is step and step.graphs.eager
    assert spmd.make_dp_train_step(plain, spmd.make_mesh(2, devices="cpu")) \
        is plain and not plain.graphs.eager
