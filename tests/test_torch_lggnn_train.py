"""Training the port's line-graph GNN against the JAX package, on the
CPU: step-0 gradients and a 20-step Adamax trajectory against
make_train_step, the epoch order over interleaved (node, edge) bucket
groups against run_epoch_scanned, whole main_gnn_qm9 --lg and
main_generate --lg runs against JAX's main, and bench_torch.py --arch
lggnn at a tiny size. Weights are JAX's init, carried over by
hgnn2_torch.convert.

Tolerances: losses rtol 1e-5; step-0 gradients within 1e-5 x the
model's max |grad| (not each tensor's own: a cv2 bias is a pure shift
before BN, so its gradient is 0 in exact arithmetic and rounding alone
in f32, and JAX's own gradients of some tensors move by more than 1e-5
of their max when the molecules of a batch are reversed); parameters
after 20 Adamax steps atol 1e-6, plus, for an entry whose exact gradient
is zero by structure on a step (a node_cv2/edge_cv2 bias, a cv1 bias whose
ReLU is on at every real position, and the like), twice Adamax's largest
move on that step (tests/test_torch_trajectory_slack.py: Adamax turns such
a gradient's rounding into a step of up to about lr whose sign follows
the last bits), and the step's lr where its gradient lay within 100 x
Adamax's eps of zero in both packages; BN running stats atol 1e-5 + rtol 1e-5 (a running mean
also gets its unit's bias's allowance); epoch histories rtol 1e-4, but the valid and test metrics
of the QM9 run rtol 2e-3, against JAX's run and against the port's own
run on 4 CPU threads in place of 2. The cv2 biases take Adamax steps of
about lr whose sign follows the rounding of their gradients, and
eval-mode BN's running mean does not cancel that walk, so these metrics
move between two runs of the same package that differ only in the CPU's
thread count, while train-mode metrics do not."""

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
from hgnn2_tpu.data import batching as jbatching
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import layers as jlayers
from hgnn2_tpu.nn import models as jmodels
from hgnn2_tpu.training import optim as joptim
from hgnn2_tpu.training import train as jtrain
from hgnn2_tpu.training.config import OptimConfig as JOptimConfig

import bench_torch
from hgnn2_torch import convert, graphs
from hgnn2_torch.cli import common, main_generate, main_gnn_qm9
from hgnn2_torch.data import batching, qm9
from hgnn2_torch.nn import layers, models
from hgnn2_torch.training import optim, train
from hgnn2_torch.training.config import OptimConfig, TrainConfig
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
    """Two batches of 20 molecules padded to 32 nodes, 64 directed edges
    and 24 graphs."""
    recs = qm9.synthetic_qm9_like(40, seed=2)
    jrecs = jqm9.synthetic_qm9_like(40, seed=2)
    kw = dict(n_max=32, m_max=64, with_line_graph=True, batch_size=24, task=0)
    mine = [graphs.make_dense_batch(recs[i:i + 20], device="cpu", **kw)
            for i in (0, 20)]
    ref = [jgraphs.make_dense_batch(jrecs[i:i + 20], **kw) for i in (0, 20)]
    ys = np.array([r.y[0] for r in recs])
    return mine, ref, float(ys.mean()), float(ys.std())


@pytest.mark.parametrize("order,J,compat", [(2, 1, False), (3, 2, True)])
def test_training_trajectory_matches_jax(train_batches, order, J, compat):
    """GNNLineGraph(L=4, h=2): step-0 gradients, then 20 Adamax steps
    alternating the batches (lr halved every epoch of 2 steps) against
    make_train_step: each step's loss and MAE, the final parameters and
    the node and edge BN running stats."""
    mine, ref, mean, std = train_batches
    kw = dict(n_features=2, n_layers=4, J=J, order=order)
    jm = jmodels.GNNLineGraph(compat=jlayers.CompatConfig.reference() if compat
                              else jlayers.CompatConfig(), **kw)
    model = models.GNNLineGraph(in_features=5, compat=layers.CompatConfig.reference()
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
            top = max(np.abs(g).max() for _, g in _leaves(jgrads))
            for path, g in _leaves(grads):
                np.testing.assert_allclose(g, _get(jgrads, path), rtol=0,
                                           atol=1e-5 * top, err_msg=str(path))
    slack = slack.allowance(jsteps)
    final = convert.dense_variables_to_flax(model.state_dict())
    for path, p in _leaves(final["params"]):
        want = _get(_np(state.params), path)
        assert np.all(np.abs(p - want) <= 1e-6 + slack[path]), path
    n_stats = 0
    for path, s in _leaves(final["batch_stats"]):
        want = _get(_np(state.batch_stats), path)
        atol = 1e-5 + 1e-5 * np.abs(want)
        if path[-1] == "mean":  # {node,edge}_bn's features: concat(cv2, cv1)
            layer, prefix = path[:-2], path[-2][:-len("bn")]
            atol = atol + np.concatenate(
                [slack[layer + (prefix + "cv2", "bias")],
                 slack[layer + (prefix + "cv1", "bias")]])
        assert np.all(np.abs(s - want) <= atol), path
        n_stats += 1
    assert n_stats == 3 * 2 * 2  # 3 layers x node/edge BN x mean/std


@pytest.mark.parametrize("scan", [True, False])
def test_fit_epoch_order_over_interleaved_groups_matches_jax(monkeypatch, scan):
    """Line-graph batches sorted by node count put an M = 64 batch between
    M = 32 batches of the same node bucket; fit groups them by (N, M) as
    JAX's group_stacked_batches does and visits them in run_epoch_scanned's
    order with scan_epochs, in CachedLoader's order without."""
    recs, jrecs = qm9.synthetic_qm9_like(48, seed=3), jqm9.synthetic_qm9_like(48, seed=3)
    kw = dict(task=0, with_line_graph=True)
    loader = batching.CachedLoader(
        batching.DenseLoader(recs, 2, device="cpu", **kw), shuffle=True, seed=7)
    shapes = [(b.x.shape[1], b.lg_src.shape[1]) for b in loader.batches()]
    runs = [s for i, s in enumerate(shapes) if i == 0 or s != shapes[i - 1]]
    assert len(runs) > len(set(shapes)) >= 3  # groups interleave
    seen = []

    def record(model, opt, batch, *args):  # every train program's body
        seen.append(batch.y.numpy())
        return {"loss": torch.zeros(())}

    monkeypatch.setattr(train, "_train_body", record)
    cfg = TrainConfig(batch_size=2, epochs=3, seed=7, scan_epochs=scan)
    train.fit(models.GNNLineGraph(in_features=5, n_features=1, n_layers=2),
              lambda split: loader if split == "train" else None, cfg)

    jloader = jbatching.CachedLoader(jbatching.DenseLoader(jrecs, 2, **kw),
                                     shuffle=True, seed=7)
    want = []
    if scan:
        groups = jtrain.group_stacked_batches(jloader.batches())
        assert len(groups) == len(set(shapes))

        def scan_fn(state, stacked, order):
            want.extend(np.asarray(stacked.y[i]) for i in np.asarray(order))
            return state, {"count": jnp.float32(1.0)}

        rng = np.random.default_rng(7)
        for _ in range(3):
            jtrain.run_epoch_scanned(None, groups, scan_fn, rng)
    else:
        for _ in range(3):
            want.extend(np.asarray(b.y) for b in jloader)
    assert len(seen) == len(want) == 3 * 24
    for a, b in zip(seen, want):
        np.testing.assert_array_equal(a, b)


def _run_both(monkeypatch, tmp_path, jmain, main, argv, eval_rtol=1e-4):
    """JAX's CLI run, then the port's on the CPU from JAX's initial
    weights. Returns the port's model after checking both histories.
    eval_rtol: the bar of the valid and test metrics, which the port's
    run on 4 CPU threads must then meet too."""
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
    runs = [got]
    if eval_rtol != 1e-4:
        torch.set_num_threads(4)
        try:
            runs.append(main.main(argv + ["--device", "cpu", "--log_path",
                                          str(tmp_path / "torch4")])[1])
        finally:
            torch.set_num_threads(2)
    assert isinstance(model, models.GNNLineGraph)
    assert len(want) == 2
    for run in runs:
        assert len(run) == 2
        for a, b in zip(run, want):
            assert a.keys() == b.keys()
            for k in a:
                if k != "epoch_time_s":
                    rtol = eval_rtol if k.startswith(("valid_", "test_")) else 1e-4
                    np.testing.assert_allclose(a[k], b[k], rtol=rtol, err_msg=k)
    assert (tmp_path / "torch" / "results.jsonl").exists()
    return model


def test_main_gnn_qm9_line_graph_matches_jax_main(tmp_path, monkeypatch):
    """The line-graph recipe's update order 2 at L=4 h=2 on 200 synthetic
    molecules, 2 epochs of batch 32 (node buckets 16 and 32, edge buckets
    32 and 64); valid and test metrics rtol 2e-3 (module doc)."""
    model = _run_both(monkeypatch, tmp_path, jmain_gnn_qm9, main_gnn_qm9,
                      ["--lg", "--update", "2", "--L", "4", "--h", "2",
                       "--bs", "32", "--epochs", "2", "--n_synthetic", "200"],
                      eval_rtol=2e-3)
    assert model.order == 2 and model.layer2.edge_bn.scale.shape == (4,)
    assert (tmp_path / "torch" / "target_stats.npz").exists()


def test_main_generate_line_graph_matches_jax_main(tmp_path, monkeypatch):
    """Collinear-points classification with the line-graph GNN, update
    order 3, J=2, reference compat, L=3 h=2, on 60 graphs of up to 12
    nodes, 2 epochs of batch 16."""
    model = _run_both(monkeypatch, tmp_path, jmain_generate, main_generate,
                      ["--lg", "--update", "3", "--n", "60", "--Nmax", "12",
                       "--L", "3", "--h", "2", "--J", "2",
                       "--compat_reference", "--bs", "16", "--epochs", "2"])
    assert model.order == 3 and model.J == 2
    assert model.layer0.node_bn.scale.shape == ()


def test_bench_torch_line_graph_runs_on_cpu():
    """bench_torch.main --arch lggnn at a tiny size prints one JSON line
    naming the arch, with the device and TF32."""
    out = io.StringIO()
    with redirect_stdout(out):
        result = bench_torch.main(["--arch", "lggnn", "--device", "cpu",
                                   "--molecules", "120", "--batch", "32",
                                   "--epochs", "1"])
    lines = out.getvalue().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert result["arch"] == "lggnn"
    assert result["metric"] == "lggnn_qm9_L5_train_throughput_end_to_end"
    assert result["device"] == {"name": "cpu", "power_limit": None}
    assert result["tf32"] is False and result["steps_per_epoch"] == 4
    assert result["value"] > 0 and result["device_upper_bound_mol_per_s"] > 0
