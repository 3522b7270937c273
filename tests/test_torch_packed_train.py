"""Packed training (--packed) of the port against the JAX package, on the
CPU: PackedLoader batches and the _PACKED_BUCKETS ladder bit-equal to
JAX's, step-0 gradients and a 20-step Adamax trajectory of PackedGNN and
PackedLGGNN (update order 2) against make_train_step on packed batches,
the one-group epoch order against run_epoch_scanned, whole
main_gnn_qm9 --packed runs (with and without --lg --update 2) against
JAX's main, the --dp refusal, and bench_torch.py --layout packed at a
tiny size. Weights are JAX's init, carried over by hgnn2_torch.convert.

Tolerances, each f32 computed in another order by the two packages (the
segment sums add edges in another order): losses rtol 1e-5; step-0
gradients within 1e-5 x the model's max |grad|; the trajectory rule of
tests/test_torch_lggnn_train.py (parameters after 20 Adamax steps atol
1e-6 plus the allowance of tests/test_torch_trajectory_slack.py on the
steps at which the entry's exact gradient is zero by structure or lies
in Adamax's eps band; BN
running stats atol 1e-5 + rtol 1e-5,
a running mean with its unit's bias's allowance); epoch histories rtol
1e-4, but the valid and test metrics of the line-graph run rtol 1e-2,
against JAX's run and against the port's own run on 4 CPU threads in
place of 2. Its cv2 biases are pure shifts before BN, so Adamax walks
them by about lr with the sign of their gradients' rounding, and
eval-mode BN's running mean does not cancel that walk (PERF.md §6).
The dense line-graph run's 2e-3 is not enough here: with JAX's initial
weights the packed run's valid_loss moves by 4.0e-3 relative between two
runs of the port that differ only in the CPU's thread count (1 and 4),
and by up to 5.2e-3 against JAX's, while its train metrics agree within
4e-7 in every case."""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from hgnn2_tpu.cli import main_gnn_qm9 as jmain_gnn_qm9
from hgnn2_tpu.data import batching as jbatching
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import packed as jpacked
from hgnn2_tpu.training import optim as joptim
from hgnn2_tpu.training import train as jtrain
from hgnn2_tpu.training.config import OptimConfig as JOptimConfig

import bench_torch
from hgnn2_torch import convert
from hgnn2_torch.cli import common, main_gnn_qm9
from hgnn2_torch.data import batching, qm9
from hgnn2_torch.nn import packed
from hgnn2_torch.training import optim, train
from hgnn2_torch.training.config import OptimConfig, TrainConfig
from test_torch_trajectory_slack import TrajectorySlack

torch.set_num_threads(2)

PB_FIELDS = ("x", "node_gid", "node_mask", "src", "dst", "w", "rev",
             "edge_gid", "edge_mask", "y", "gmask")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=()):
    """(path, leaf) over a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_bit_equal(pb, jpb):
    assert pb.n_graphs == jpb.n_graphs
    for name in PB_FIELDS:
        got, want = getattr(pb, name).numpy(), np.asarray(getattr(jpb, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("uniform_caps,shuffle", [(True, True), (False, False)])
def test_packed_loader_bit_equal(uniform_caps, shuffle):
    """70 molecules in batches of 16 (the last padded to 16 graphs), two
    epochs: every field of every batch equals JAX's, with the epoch's one
    capacity or each batch's own bucket."""
    assert batching._PACKED_BUCKETS == jbatching._PACKED_BUCKETS
    kw = dict(batch_size=16, task=0, shuffle=shuffle, seed=3,
              uniform_caps=uniform_caps)
    loader = batching.PackedLoader(qm9.synthetic_qm9_like(70, seed=5),
                                   device="cpu", **kw)
    jloader = jbatching.PackedLoader(jqm9.synthetic_qm9_like(70, seed=5), **kw)
    assert len(loader) == len(jloader) == 5
    for _ in range(2):  # the second epoch reshuffles with seed + 1
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == 5
        for pb, jpb in zip(got, want):
            _assert_bit_equal(pb, jpb)
    caps = {(pb.num_node_slots, pb.num_edge_slots) for pb in got}
    assert (len(caps) == 1) == uniform_caps
    assert all(c in batching._PACKED_BUCKETS for cap in caps for c in cap)


def test_fit_epoch_order_of_one_packed_group_matches_jax(monkeypatch):
    """With uniform caps a packed split is one shape group: fit visits it
    in run_epoch_scanned's order (one permutation an epoch)."""
    kw = dict(task=0)
    loader = batching.CachedLoader(batching.PackedLoader(
        qm9.synthetic_qm9_like(48, seed=3), 4, device="cpu", **kw),
        shuffle=True, seed=7)
    assert len(train.group_batches(loader.batches())) == 1
    seen = []

    def record(model, opt, batch, *args):  # every train program's body
        seen.append(batch.y.numpy())
        return {"loss": torch.zeros(())}

    monkeypatch.setattr(train, "_train_body", record)
    cfg = TrainConfig(batch_size=4, epochs=3, seed=7)
    train.fit(packed.PackedGNN(n_features=1, n_layers=2, in_features=5),
              lambda split: loader if split == "train" else None, cfg)

    jloader = jbatching.CachedLoader(jbatching.PackedLoader(
        jqm9.synthetic_qm9_like(48, seed=3), 4, **kw), shuffle=True, seed=7)
    groups = jtrain.group_stacked_batches(jloader.batches())
    assert len(groups) == 1
    want = []

    def scan_fn(state, stacked, order):
        want.extend(np.asarray(stacked.y[i]) for i in np.asarray(order))
        return state, {"count": jnp.float32(1.0)}

    rng = np.random.default_rng(7)
    for _ in range(3):
        jtrain.run_epoch_scanned(None, groups, scan_fn, rng)
    assert len(seen) == len(want) == 3 * 12
    for a, b in zip(seen, want):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def packed_batches():
    """40 molecules in two packed batches of 24 graph slots (24 and 16
    real), at the loader's uniform capacities."""
    kw = dict(task=0)
    mine = list(batching.PackedLoader(qm9.synthetic_qm9_like(40, seed=2), 24,
                                      device="cpu", **kw))
    ref = list(jbatching.PackedLoader(jqm9.synthetic_qm9_like(40, seed=2), 24,
                                      **kw))
    ys = np.array([r.y[0] for r in qm9.synthetic_qm9_like(40, seed=2)])
    return mine, ref, float(ys.mean()), float(ys.std())


@pytest.mark.parametrize("arch,J", [("gnn", 2), ("lggnn", 1)])
def test_packed_training_trajectory_matches_jax(packed_batches, arch, J):
    """PackedGNN(L=4, h=2, J=2) and PackedLGGNN(L=3, h=2, order 2):
    step-0 gradients, then 20 Adamax steps alternating the batches (lr
    halved every epoch of 2 steps) against make_train_step: each step's
    loss and MAE, the final parameters and BN running stats."""
    mine, ref, mean, std = packed_batches
    if arch == "gnn":
        kw = dict(n_features=2, n_layers=4, J=J)
        jm, model = jpacked.PackedGNN(**kw), packed.PackedGNN(in_features=5, **kw)
        n_bn = 3
    else:
        kw = dict(n_features=2, n_layers=3, J=J, order=2)
        jm, model = (jpacked.PackedLGGNN(**kw),
                     packed.PackedLGGNN(in_features=5, **kw))
        n_bn = 2 * 2
    ocfg = dict(optim="adamax", lr=1e-3, lr_damping=0.5, epoch_step=1)
    tx = joptim.build_optimizer(JOptimConfig(**ocfg), 2)
    state = jtrain.TrainState.create(jm, ref[0], tx, jax.random.key(0))
    model.load_state_dict(convert.packed_variables_from_flax(
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
    slack, jsteps = TrajectorySlack(model, convert.packed_variables_to_flax), []
    for t in range(20):
        jsteps.append(_np(grad_fn(state, ref[t % 2])))
        jgrads = dict(_leaves(jsteps[-1]))
        lr = opt.param_groups[0]["lr"]
        state, jm_ = step(state, ref[t % 2])
        with slack.step(lr):
            m = train.train_step(model, opt, sched, mine[t % 2], mean=mean,
                                 std=std)
        for k in ("loss", "mae"):
            np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=1e-5,
                                       err_msg=f"step {t} {k}")
        grads = dict(_leaves(convert.packed_variables_to_flax(
            {n: p.grad for n, p in model.named_parameters()})["params"]))
        assert grads.keys() == jgrads.keys()
        if t == 0:
            top = max(np.abs(g).max() for g in jgrads.values())
            for path, g in grads.items():
                np.testing.assert_allclose(g, jgrads[path], rtol=0,
                                           atol=1e-5 * top, err_msg=str(path))
    slack = slack.allowance(jsteps)
    final = convert.packed_variables_to_flax(model.state_dict())
    want = dict(_leaves(_np(state.params)))
    for path, p in _leaves(final["params"]):
        assert np.all(np.abs(p - want[path]) <= 1e-6 + slack[path]), path
    want = dict(_leaves(_np(state.batch_stats)))
    for path, s in _leaves(final["batch_stats"]):
        atol = 1e-5 + 1e-5 * np.abs(want[path])
        if path[-1] == "mean":  # {prefix}bn's features: concat(cv2, cv1)
            prefix = path[-2][:-len("bn")]
            atol = atol + np.concatenate([slack[(prefix + "cv2", "bias")],
                                          slack[(prefix + "cv1", "bias")]])
        assert np.all(np.abs(s - want[path]) <= atol), path
    assert len(want) == 2 * n_bn


def _run_both(monkeypatch, tmp_path, argv, eval_rtol=1e-4):
    """JAX's main_gnn_qm9 run, then the port's on the CPU from JAX's
    initial weights; both histories held to each other. eval_rtol: the
    bar of the valid and test metrics, which the port's run on 4 CPU
    threads must then meet too. Returns the port's model."""
    created = []
    create = jtrain.TrainState.create

    def record_init(*args, **kwargs):
        created.append(create(*args, **kwargs))
        return created[-1]

    monkeypatch.setattr(jtrain.TrainState, "create", record_init)
    _, want = jmain_gnn_qm9.main(argv + ["--log_path", str(tmp_path / "jax")])
    init = _np({"params": created[0].params,
                "batch_stats": created[0].batch_stats})
    run = common.run_experiment
    monkeypatch.setattr(common, "run_experiment",
                        lambda cfg: run(cfg, init_params=init))
    model, got = main_gnn_qm9.main(argv + ["--device", "cpu", "--log_path",
                                           str(tmp_path / "torch")])
    runs = [got]
    if eval_rtol != 1e-4:
        torch.set_num_threads(4)
        try:
            runs.append(main_gnn_qm9.main(argv + [
                "--device", "cpu", "--log_path", str(tmp_path / "torch4")])[1])
        finally:
            torch.set_num_threads(2)
    assert len(want) == 2
    for run in runs:
        assert len(run) == 2
        for a, b in zip(run, want):
            assert a.keys() == b.keys()
            for k in a:
                if k != "epoch_time_s":
                    rtol = (eval_rtol if k.startswith(("valid_", "test_"))
                            else 1e-4)
                    np.testing.assert_allclose(a[k], b[k], rtol=rtol, err_msg=k)
    assert (tmp_path / "torch" / "target_stats.npz").exists()
    return model


@pytest.mark.parametrize("lg", [False, True])
def test_main_gnn_qm9_packed_matches_jax_main(tmp_path, monkeypatch, lg):
    """main_gnn_qm9 --packed at L=4 h=2 (--lg --update 2: the packed
    line-graph GNN) on 200 synthetic molecules, 2 epochs of batch 32 over
    cached packed batches; the line-graph run's valid and test metrics
    rtol 1e-2 (module doc)."""
    argv = ["--packed", "--L", "4", "--h", "2", "--bs", "32", "--epochs", "2",
            "--n_synthetic", "200"]
    if lg:
        argv += ["--lg", "--update", "2"]
    model = _run_both(monkeypatch, tmp_path, argv,
                      eval_rtol=1e-2 if lg else 1e-4)
    assert isinstance(model, packed.PackedLGGNN if lg else packed.PackedGNN)
    if lg:
        assert model.order == 2


def test_packed_refuses_dp(tmp_path):
    """--packed batches cannot be split batch-wise: dp > 1 raises JAX's
    ValueError, which points at --edge_shards."""
    cfg = TrainConfig(batch_size=4, epochs=1, device="cpu", dp=2,
                      log_path=str(tmp_path))
    cfg.data.dataset, cfg.data.n_synthetic = "qm9_synthetic", 8
    cfg.model.packed = True
    with pytest.raises(ValueError, match="--edge_shards"):
        common.run_experiment(cfg)


def test_bench_torch_packed_runs_on_cpu():
    """bench_torch.main --layout packed at a tiny size prints one JSON
    line whose metric names the layout."""
    out = io.StringIO()
    with redirect_stdout(out):
        result = bench_torch.main(["--layout", "packed", "--arch", "lggnn",
                                   "--device", "cpu", "--molecules", "120",
                                   "--batch", "32", "--epochs", "1"])
    lines = out.getvalue().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert result["layout"] == "packed" and result["arch"] == "lggnn"
    assert result["metric"] == "lggnn_qm9_L5_packed_train_throughput_end_to_end"
    assert result["tf32"] is False and result["steps_per_epoch"] == 4
    assert result["value"] > 0 and result["device_upper_bound_mol_per_s"] > 0
