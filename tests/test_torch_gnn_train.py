"""Training the port's power GNN against the JAX package, on the CPU:
step-0 gradients and a 20-step Adamax trajectory against make_train_step,
evaluate against JAX's evaluate, whole main_gnn_qm9 and main_generate runs
against JAX's, the refusals of later slices' options, and bench_torch.py
at a tiny size. Weights are JAX's init, carried over by
hgnn2_torch.convert.

Tolerances, each f32 computed in another order by the two packages:
losses rtol 1e-5 and step-0 gradients within 1e-5 x max |grad| of each
tensor; parameters after 20 Adamax steps atol 1e-6 (each step moves a
weight by about lr whatever its gradient's size, so agreement is bounded
by lr times the relative error of mu/nu, not by the weight's size), plus
the allowance of tests/test_torch_trajectory_slack.py on the steps at
which an entry's exact gradient is zero by structure or lies in Adamax's
eps band; BN
running stats rtol 1e-5 (atol 1e-5); evaluate's metrics rtol 1e-6; epoch
histories rtol 1e-4 (means over 2 epochs)."""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from hgnn2_tpu import graphs as jgraphs
from hgnn2_tpu.cli import main_generate as jmain_generate
from hgnn2_tpu.cli import main_gnn_qm9 as jmain_gnn_qm9
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import layers as jlayers
from hgnn2_tpu.nn import models as jmodels
from hgnn2_tpu.training import optim as joptim
from hgnn2_tpu.training import train as jtrain
from hgnn2_tpu.training.config import OptimConfig as JOptimConfig

import bench_torch
from hgnn2_torch import convert, graphs
from hgnn2_torch.cli import common, main_generate, main_gnn_qm9
from hgnn2_torch.data import qm9
from hgnn2_torch.nn import layers, models
from hgnn2_torch.training import optim, train
from hgnn2_torch.training.config import OptimConfig
from test_torch_trajectory_slack import TrajectorySlack

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=()):
    """(path, leaf) over a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def train_batches():
    """Two batches of 20 molecules padded to 32 nodes and 24 graphs."""
    recs = qm9.synthetic_qm9_like(40, seed=2)
    jrecs = jqm9.synthetic_qm9_like(40, seed=2)
    kw = dict(n_max=32, batch_size=24, task=0)
    mine = [graphs.make_dense_batch(recs[i:i + 20], device="cpu", **kw)
            for i in (0, 20)]
    ref = [jgraphs.make_dense_batch(jrecs[i:i + 20], **kw) for i in (0, 20)]
    ys = np.array([r.y[0] for r in recs])
    return mine, ref, float(ys.mean()), float(ys.std())


@pytest.mark.parametrize("J,gru,compat", [(1, False, False), (2, True, True)])
def test_training_trajectory_matches_jax(train_batches, J, gru, compat):
    """GNNSimple(L=4, h=2): step-0 gradients, then 20 Adamax steps
    alternating the batches (lr halved every epoch of 2 steps) against
    make_train_step: each step's loss and MAE, the final parameters and
    BN running stats.

    Adamax steps a weight by lr * mu / nu with nu = max(b2 nu, |g| + 1e-8),
    so where the exact gradient is zero the step's size and sign follow
    the rounding of its f32 gradient, which differs between the packages.
    The bias of cv1 or cv2 of a unit whose ReLU is on at every real node
    is such a weight on that step: the loss does not depend on it (BN
    subtracts any shift), and its BN running mean follows it. So each
    entry is held to atol 1e-6 plus, for each step on which its exact
    gradient was zero by structure, twice Adamax's largest move then, and
    for each other step on which its gradient lay within 100 x Adamax's
    eps of zero in both packages, that step's lr
    (tests/test_torch_trajectory_slack.py); a BN running mean (atol 1e-5
    + rtol 1e-5) gets its unit's bias's allowance."""
    mine, ref, mean, std = train_batches
    kw = dict(n_features=2, n_layers=4, J=J, gru=gru)
    jm = jmodels.GNNSimple(compat=jlayers.CompatConfig.reference() if compat
                           else jlayers.CompatConfig(), **kw)
    model = models.GNNSimple(in_features=5, compat=layers.CompatConfig.reference()
                             if compat else layers.CompatConfig(), **kw)
    ocfg = dict(optim="adamax", lr=1e-3, lr_damping=0.5, epoch_step=1)
    tx = joptim.build_optimizer(JOptimConfig(**ocfg), 2)
    state = jtrain.TrainState.create(jm, ref[0], tx, jax.random.key(0))
    model.load_state_dict(convert.dense_variables_from_flax(
        _np({"params": state.params, "batch_stats": state.batch_stats})))
    opt, sched = optim.build_optimizer(OptimConfig(**ocfg), 2, model.parameters())

    @jax.jit
    def grad_fn(state, batch):
        def loss_fn(params):
            out, _ = jtrain._forward(state, params, batch, train=True)
            return jtrain._loss_and_metrics(
                out, batch.y, jtrain._graph_mask(batch), "regression", mean,
                std)[0]
        return jax.grad(loss_fn)(state.params)

    step = jtrain.make_train_step("regression", mean, std)
    slack, jsteps = TrajectorySlack(model, convert.dense_variables_to_flax), []
    for t in range(20):
        jgrads = _np(grad_fn(state, ref[t % 2]))
        jsteps.append(jgrads)
        lr = opt.param_groups[0]["lr"]
        state, jm_ = step(state, ref[t % 2])
        with slack.step(lr):
            m = train.train_step(model, opt, sched, mine[t % 2], mean=mean,
                                 std=std)
        for k in ("loss", "mae"):
            np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=1e-5,
                                       err_msg=f"step {t} {k}")
        if t == 0:
            grads = convert.dense_variables_to_flax(
                {n: p.grad for n, p in model.named_parameters()})["params"]
            for path, g in _leaves(grads):
                want = _get(jgrads, path)
                np.testing.assert_allclose(g, want, rtol=1e-5,
                                           atol=1e-5 * np.abs(want).max(),
                                           err_msg=str(path))
    slack = slack.allowance(jsteps)
    final = convert.dense_variables_to_flax(model.state_dict())
    for path, p in _leaves(final["params"]):
        want = _get(_np(state.params), path)
        assert np.all(np.abs(p - want) <= 1e-6 + slack[path]), path
    for path, s in _leaves(final["batch_stats"]):
        want = _get(_np(state.batch_stats), path)
        atol = 1e-5 + 1e-5 * np.abs(want)
        if path[-1] == "mean":  # BN's features are concat(cv2, cv1)
            layer = path[:-2]
            atol = atol + np.concatenate([slack[layer + ("cv2", "bias")],
                                          slack[layer + ("cv1", "bias")]])
        assert np.all(np.abs(s - want) <= atol), path


def test_evaluate_matches_jax(train_batches):
    """evaluate's count-weighted means over two batches with different
    real-graph counts (20 and 11), against JAX's evaluate."""
    mine, ref, mean, std = train_batches
    recs = qm9.synthetic_qm9_like(11, seed=7)
    mine = [mine[0], graphs.make_dense_batch(recs, n_max=32, batch_size=24,
                                             task=0, device="cpu")]
    ref = [ref[0], jgraphs.make_dense_batch(jqm9.synthetic_qm9_like(11, seed=7),
                                            n_max=32, batch_size=24, task=0)]
    jm = jmodels.GNNSimple(n_features=2, n_layers=3)
    tx = joptim.build_optimizer(JOptimConfig(), 1)
    state = jtrain.TrainState.create(jm, ref[0], tx, jax.random.key(1))
    model = models.GNNSimple(in_features=5, n_features=2, n_layers=3)
    model.load_state_dict(convert.dense_variables_from_flax(
        _np({"params": state.params, "batch_stats": state.batch_stats})))
    want = jtrain.evaluate(state, ref, jtrain.make_eval_step("regression", mean, std))
    got = train.evaluate(model, mine, "regression", mean, std)
    assert got.keys() == want.keys() == {"loss", "mae"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert train.evaluate(model, [], "regression", mean, std) == {}


def _run_both(monkeypatch, tmp_path, jmain, main, argv):
    """JAX's CLI run, then the port's on the CPU from JAX's initial
    weights. Returns both histories."""
    created = []
    create = jtrain.TrainState.create

    def record_init(*args, **kwargs):
        created.append(create(*args, **kwargs))
        return created[-1]

    monkeypatch.setattr(jtrain.TrainState, "create", record_init)
    _, want = jmain.main(argv + ["--log_path", str(tmp_path / "jax")])
    init = _np({"params": created[0].params,
                "batch_stats": created[0].batch_stats})
    run = common.run_experiment
    monkeypatch.setattr(common, "run_experiment",
                        lambda cfg: run(cfg, init_params=init))
    model, got = main.main(argv + ["--device", "cpu", "--log_path",
                                   str(tmp_path / "torch")])
    assert isinstance(model, models.GNNSimple)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            if k != "epoch_time_s":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    assert (tmp_path / "torch" / "results.jsonl").exists()
    return model


def test_main_gnn_qm9_matches_jax_main(tmp_path, monkeypatch):
    """The main path at L=4 h=2 on 200 synthetic molecules, 2 epochs of
    batch 32 (node buckets 16 and 32), compat reference on."""
    model = _run_both(monkeypatch, tmp_path, jmain_gnn_qm9, main_gnn_qm9,
                      ["--L", "4", "--h", "2", "--bs", "32", "--epochs", "2",
                       "--n_synthetic", "200", "--compat_reference", "--sp"])
    assert model.layer0.bn.scale.shape == ()
    assert (tmp_path / "torch" / "target_stats.npz").exists()


def test_main_generate_matches_jax_main(tmp_path, monkeypatch):
    """Collinear-points classification at L=3 h=2, J=2 with the GRU update,
    on 100 graphs of up to 20 nodes, 2 epochs of batch 16."""
    model = _run_both(monkeypatch, tmp_path, jmain_generate, main_generate,
                      ["--n", "100", "--Nmax", "20", "--L", "3", "--h", "2",
                       "--J", "2", "--gru", "--bs", "16", "--epochs", "2"])
    assert model.layer0.gru is not None and model.J == 2
    assert not (tmp_path / "torch" / "target_stats.npz").exists()


def test_main_gnn_qm9_refuses_the_line_graph_gnn(tmp_path):
    """Named for the refusal it held before the line-graph GNN was ported:
    --lg now trains a GNNLineGraph on the CPU (tests/test_torch_lggnn_train.py
    holds such runs to JAX's)."""
    model, history = main_gnn_qm9.main(
        ["--lg", "--update", "2", "--L", "3", "--h", "1", "--bs", "8",
         "--epochs", "1", "--device", "cpu", "--n_synthetic", "16",
         "--log_path", str(tmp_path)])
    assert isinstance(model, models.GNNLineGraph) and model.order == 2
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])


def test_bench_torch_runs_on_cpu():
    """bench_torch.main at a tiny size prints one JSON line with
    bench.py's keys (less the baseline ratios), the device and TF32."""
    out = io.StringIO()
    with redirect_stdout(out):
        result = bench_torch.main(["--device", "cpu", "--molecules", "120",
                                   "--batch", "32", "--epochs", "1"])
    lines = out.getvalue().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert result["device"] == {"name": "cpu", "power_limit": None}
    assert result["tf32"] is False and result["steps_per_epoch"] == 4
    assert result["value"] > 0 and result["device_upper_bound_mol_per_s"] > 0
    assert "vs_baseline" not in result


def test_bench_torch_ccn_runs_on_cpu():
    """bench_torch.main --arch ccn1d at a tiny size: CCN-1D (L=20, h=2)
    through the same scanned epochs, eager epochs and one-batch bound,
    one JSON line with the shape groups and the eager rate beside the
    headline."""
    out = io.StringIO()
    with redirect_stdout(out):
        result = bench_torch.main(["--arch", "ccn1d", "--device", "cpu",
                                   "--molecules", "60", "--batch", "16",
                                   "--epochs", "1"])
    lines = out.getvalue().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert result["metric"] == "ccn1d_qm9_L20_train_throughput_end_to_end"
    assert result["steps_per_epoch"] == 4 and result["batch"] == 16
    assert result["shape_groups"] >= 1 and result["graphs"] == 0
    assert result["value"] > 0 and result["eager_value"] > 0
    assert result["device_upper_bound_mol_per_s"] > 0

