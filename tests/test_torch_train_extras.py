"""The training extras of the port against the JAX package, on the CPU:
Checkpointer (a round trip bit for bit, retention, the schedule's count),
a --ckpt run and a --resume run against JAX's same two runs,
recalibrate_bn against JAX's (dense and packed, grouped and per batch),
--bn_recalib's appended row against JAX's, GracefulShutdown and fit's
stop at an epoch boundary, prefetch, plot_history, the profiling helpers
and runtime.setup, and the port's imports. Weights are JAX's init,
carried over by hgnn2_torch.convert.

Tolerances: recalibrated BN statistics rtol 1e-5, atol 1e-6 (the same f32
batch statistics, summed in another order); epoch histories rtol 1e-4,
as in tests/test_torch_gnn_train.py."""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import torch

from hgnn2_tpu import profiling as jprofiling
from hgnn2_tpu.cli import main_gnn_qm9 as jmain_gnn_qm9
from hgnn2_tpu.data import batching as jbatching
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import models as jmodels
from hgnn2_tpu.nn import packed as jpacked
from hgnn2_tpu.training import optim as joptim
from hgnn2_tpu.training import train as jtrain
from hgnn2_tpu.training.config import OptimConfig as JOptimConfig

from hgnn2_torch import convert, profiling, runtime
from hgnn2_torch.cli import common, main_gnn_qm9
from hgnn2_torch.data import batching, qm9, synthetic
from hgnn2_torch.nn import ccn, models, packed
from hgnn2_torch.training import metrics, optim, plots, train
from hgnn2_torch.training.checkpoint import Checkpointer
from hgnn2_torch.training.config import OptimConfig, TrainConfig
from hgnn2_torch.training.preemption import GracefulShutdown
from hgnn2_torch.training.prefetch import prefetch

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


def _steps(model, opt, sched, batches, n):
    for t in range(n):
        train.train_step(model, opt, sched, batches[t % len(batches)])


def test_checkpointer_round_trip_bit_for_bit(tmp_path):
    """Save after each of 4 epochs with max_to_keep 3; restore into a
    fresh model, Adamax and schedule: every tensor equal bit for bit, the
    schedule's count and lr where they stopped, and the next step of both
    identical."""
    batches = list(batching.PackedLoader(qm9.synthetic_qm9_like(32, seed=1),
                                         16, task=0, device="cpu"))
    ocfg = OptimConfig(optim="adamax", lr=1e-3, lr_damping=0.5, epoch_step=1)

    def fresh():
        model = packed.PackedGNN(n_features=2, n_layers=3, in_features=5,
                                 generator=torch.Generator().manual_seed(0))
        return (model, *optim.build_optimizer(ocfg, 2, model.parameters()))

    model, opt, sched = fresh()
    ckpt = Checkpointer(str(tmp_path), max_to_keep=3)
    assert ckpt.latest_step() is None and ckpt.restore(model) is None
    for epoch in range(1, 5):
        _steps(model, opt, sched, batches, 2)
        ckpt.save(model, opt, sched, epoch)
    assert ckpt.all_steps() == [2, 3, 4] and ckpt.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["2", "3", "4"]

    model2, opt2, sched2 = fresh()
    assert ckpt.restore(model2, opt2, sched2) == 4
    payload, step = ckpt.restore_tree()
    assert step == 4 and payload["step"] == 8 and payload["epoch"] == 4
    assert sched2.last_epoch == sched.last_epoch == 8
    assert opt2.param_groups[0]["lr"] == opt.param_groups[0]["lr"] == 1e-3 / 16
    for a, b in ((model.state_dict(), model2.state_dict()),
                 (opt.state_dict()["state"], opt2.state_dict()["state"])):
        flat_a, flat_b = dict(_leaves(a)), dict(_leaves(b))
        assert flat_a.keys() == flat_b.keys()
        for k, v in flat_a.items():
            assert torch.equal(v, flat_b[k]), k
    _steps(model, opt, sched, batches[:1], 1)
    _steps(model2, opt2, sched2, batches[:1], 1)
    for k, v in model.state_dict().items():
        assert torch.equal(v, model2.state_dict()[k]), k


def test_checkpointer_skips_steps_at_or_below_the_latest_as_orbax(tmp_path):
    """Steps 4-6 saved, then 1-6 again with other values, into JAX's
    Checkpointer (orbax) and the port's: both keep [4, 5, 6] and the first
    values at step 6; the port's save says it skipped."""
    from hgnn2_tpu.training.checkpoint import Checkpointer as JCheckpointer

    jck = JCheckpointer(str(tmp_path / "jax"))
    ck = Checkpointer(str(tmp_path / "torch"))
    tree = lambda v: {"w": np.full(3, v, np.float32), "epoch": 0}
    for step in (4, 5, 6):
        jck.save_tree(tree(step), step)
        assert ck.save_tree({"w": torch.tensor(tree(step)["w"])}, step)
    for step in range(1, 7):
        jck.save_tree(tree(10 + step), step)
        assert not ck.save_tree({"w": torch.tensor(tree(10 + step)["w"])}, step)
    assert ck.all_steps() == list(jck.manager.all_steps()) == [4, 5, 6]
    jpayload, jstep = jck.restore_tree(tree(0))
    payload, step = ck.restore_tree()
    assert step == jstep == 6
    np.testing.assert_array_equal(payload["w"].numpy(), jpayload["w"])
    np.testing.assert_array_equal(jpayload["w"], tree(6)["w"])


def test_run_without_resume_leaves_another_runs_checkpoints_whole(tmp_path):
    """main_gnn_qm9 --ckpt for 3 epochs, then a 2-epoch run with another lr
    into the same directory without --resume: the directory still holds
    the first run's steps 1-3, its step 3 bit for bit, so a later
    --resume goes on from the first run."""
    argv = ["--L", "3", "--h", "2", "--bs", "32", "--n_synthetic", "160",
            "--device", "cpu", "--ckpt", str(tmp_path / "ck")]
    main_gnn_qm9.main(argv + ["--epochs", "3",
                              "--log_path", str(tmp_path / "a")])
    ck = Checkpointer(str(tmp_path / "ck"))
    before, _ = ck.restore_tree()
    main_gnn_qm9.main(argv + ["--epochs", "2", "--lr", "1e-2",
                              "--log_path", str(tmp_path / "b")])
    after, step = ck.restore_tree()
    assert ck.all_steps() == [1, 2, 3] and step == 3
    assert after["epoch"] == before["epoch"] == 3
    for k, v in before["model"].items():
        assert torch.equal(v, after["model"][k]), k


def _init_recorder(monkeypatch):
    """Records every TrainState JAX creates; returns the list."""
    created = []
    create = jtrain.TrainState.create

    def record_init(*args, **kwargs):
        created.append(create(*args, **kwargs))
        return created[-1]

    monkeypatch.setattr(jtrain.TrainState, "create", record_init)
    return created


def _port_from(monkeypatch, state):
    """Makes the port's run_experiment start from JAX's initial state."""
    init = _np({"params": state.params, "batch_stats": state.batch_stats})
    run = common.run_experiment
    monkeypatch.setattr(common, "run_experiment",
                        lambda cfg: run(cfg, init_params=init))


def _assert_histories(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            if k != "epoch_time_s":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)


def test_checkpoint_and_resume_match_jax(tmp_path, monkeypatch):
    """main_gnn_qm9 --ckpt for 2 epochs, then --resume to 4, the lr halved
    every epoch: the port's two runs against JAX's. The resumed run starts
    at epoch 3 with the optimizer and schedule where they stopped, and,
    as in JAX, with the shuffle generator and the loader's epoch counters
    started afresh."""
    created = _init_recorder(monkeypatch)
    argv = ["--L", "3", "--h", "2", "--bs", "32", "--n_synthetic", "160",
            "--step", "1", "--lrdamping", "0.5"]
    want = [jmain_gnn_qm9.main(argv + [
        "--ckpt", str(tmp_path / "jck"), "--log_path", str(tmp_path / f"j{i}"),
        "--epochs", str(epochs)] + extra)[1]
        for i, (epochs, extra) in enumerate(((2, []), (4, ["--resume"])))]
    _port_from(monkeypatch, created[0])
    got = [main_gnn_qm9.main(argv + [
        "--device", "cpu", "--ckpt", str(tmp_path / "ck"),
        "--log_path", str(tmp_path / f"t{i}"), "--epochs", str(epochs)] + extra)[1]
        for i, (epochs, extra) in enumerate(((2, []), (4, ["--resume"])))]
    assert [len(h) for h in want] == [2, 2]
    for g, w in zip(got, want):
        _assert_histories(g, w)
    assert Checkpointer(str(tmp_path / "ck")).all_steps() == [2, 3, 4]
    assert (tmp_path / "ck" / common.TARGET_STATS_FILE).exists()
    # the schedule went on from the checkpoint's count: lr / 2^4 at the end
    payload, _ = Checkpointer(str(tmp_path / "ck")).restore_tree()
    assert payload["optimizer"]["param_groups"][0]["lr"] == pytest.approx(
        3e-4 * 0.5 ** 4)


@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_recalibrate_bn_matches_jax(layout):
    """GNNSimple(L=3, h=3) over dense batches of two node buckets and
    PackedLGGNN(L=3, h=2, order 2) over packed batches of per-batch
    capacities, from JAX's init after 4 Adamax steps: the recalibrated BN
    statistics of the grouped and the per-batch paths against JAX's."""
    recs, jrecs = qm9.synthetic_qm9_like(64, seed=7), jqm9.synthetic_qm9_like(64, seed=7)
    if layout == "dense":
        mine = list(batching.DenseLoader(recs, 16, task=0, device="cpu"))
        ref = list(jbatching.DenseLoader(jrecs, 16, task=0))
        jm = jmodels.GNNSimple(n_features=3, n_layers=3)
        model = models.GNNSimple(in_features=5, n_features=3, n_layers=3)
    else:
        kw = dict(task=0, uniform_caps=False)
        mine = list(batching.PackedLoader(recs, 16, device="cpu", **kw))
        ref = list(jbatching.PackedLoader(jrecs, 16, **kw))
        jm = jpacked.PackedLGGNN(n_features=2, n_layers=3, order=2)
        model = packed.PackedLGGNN(in_features=5, n_features=2, n_layers=3,
                                   order=2)
    groups = train.group_batches(mine)
    assert len(groups) > 1
    tx = joptim.build_optimizer(JOptimConfig(lr=1e-2), 4)
    state = jtrain.TrainState.create(jm, ref[0], tx, jax.random.key(2))
    step = jtrain.make_train_step("regression", 0.0, 1.0)
    for b in ref:
        state, _ = step(state, b)
    variables = _np({"params": state.params, "batch_stats": state.batch_stats})
    want = {
        path: dict(_leaves(_np(jtrain.recalibrate_bn(state, **src).batch_stats)))
        for path, src in (
            ("groups", dict(groups=jtrain.group_stacked_batches(ref))),
            ("loader", dict(loader=ref)))}
    stacked = train.group_stacked_batches(mine)
    for path, src in (("groups", dict(groups=stacked)), ("loader", dict(loader=mine))):
        model.load_state_dict(convert.variables_from_flax(variables))
        assert train.recalibrate_bn(model, **src) is model and not model.training
        got = dict(_leaves(convert.variables_to_flax(
            model.state_dict())["batch_stats"]))
        assert got.keys() == want[path].keys()
        for k, v in got.items():
            np.testing.assert_allclose(v, want[path][k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{path} {k}")
            np.testing.assert_allclose(v, want["groups"][k], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{path} {k}")
    before = dict(_leaves(variables["batch_stats"]))
    assert any(not np.allclose(before[k], v) for k, v in got.items())


def test_recalibrate_bn_without_bn_is_a_no_op():
    batches = list(batching.CCNLoader(qm9.synthetic_qm9_like(8, seed=0), 4,
                                      task=0, device="cpu"))
    model = ccn.CCN1D(n_features=5, hidden=2, n_layers=1).train()
    assert train.recalibrate_bn(model, loader=batches) is model
    assert model.training


def test_fit_bn_recalibrate_matches_jax(tmp_path, monkeypatch):
    """main_gnn_qm9 --bn_recalib --no_scan (stepwise epochs through
    prefetch, then the per-batch recalibration over the cached loader):
    the two epochs and the appended recalibrated row against JAX's."""
    created = _init_recorder(monkeypatch)
    argv = ["--L", "3", "--h", "2", "--bs", "32", "--n_synthetic", "200",
            "--epochs", "2", "--bn_recalib", "--no_scan"]
    _, want = jmain_gnn_qm9.main(argv + ["--log_path", str(tmp_path / "jax")])
    _port_from(monkeypatch, created[0])
    _, got = main_gnn_qm9.main(argv + ["--device", "cpu", "--log_path",
                                       str(tmp_path / "torch")])
    assert len(want) == 3 and want[-1]["bn_recalibrated"] == 1.0
    _assert_histories(got, want)
    rows = plots.load_history(str(tmp_path / "torch"))
    assert [r["epoch"] for r in rows] == [1, 2, 3]


def test_graceful_shutdown_latches_sigterm():
    prev = signal.getsignal(signal.SIGTERM)
    with GracefulShutdown() as s:
        assert not s.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert s.requested
    assert signal.getsignal(signal.SIGTERM) is prev


def test_fit_stops_at_the_epoch_boundary_after_a_signal(tmp_path):
    """A SIGTERM during the third epoch: fit finishes that epoch, saves it
    and returns; the latest checkpoint is the last epoch run."""
    tr = synthetic.split_80_10_10(qm9.synthetic_qm9_like(48, seed=0))[0]
    base = batching.DenseLoader(tr, 16, task=0, device="cpu")
    calls = {"n": 0}

    class SignallingLoader:
        def __len__(self):
            return len(base)

        def __iter__(self):
            calls["n"] += 1
            if calls["n"] == 4:  # the sample, then the third epoch
                os.kill(os.getpid(), signal.SIGTERM)
            return iter(base)

    ckpt = Checkpointer(str(tmp_path))
    model = models.GNNSimple(in_features=5, n_features=2, n_layers=3)
    cfg = TrainConfig(batch_size=16, epochs=50)
    _, history = train.fit(model, lambda s: SignallingLoader()
                           if s == "train" else None, cfg, checkpointer=ckpt)
    assert len(history) == 3 and ckpt.latest_step() == len(history)


def test_prefetch_keeps_order_and_reraises():
    assert list(prefetch(iter(range(50)), size=3)) == list(range(50))

    def gen():
        yield 1
        yield 2
        raise ValueError("boom")

    items = []
    with pytest.raises(ValueError, match="boom"):
        for x in prefetch(gen(), size=1):
            items.append(x)
    assert items == [1, 2]


def test_plot_history_writes_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    logger = metrics.ExperimentLogger(str(tmp_path))
    for epoch in (1, 2):
        logger.log_epoch(epoch, train_loss=1.0 / epoch, valid_loss=1.2 / epoch,
                         train_mae=0.5 / epoch)
    paths = plots.plot_history(str(tmp_path))
    assert [os.path.basename(p) for p in paths] == ["loss.png", "error.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)


def test_profiling_matches_jax_and_has_no_cpu_peaks():
    """AggregationRoofline's formulas equal JAX's for both layouts;
    time_steps and force_sync run on CPU tensors; every peak, MFU and
    bandwidth share is None without a card; runtime.setup keeps TF32 off."""
    timing = profiling.StepTiming(steps=4, total_s=0.5)
    jtiming = jprofiling.StepTiming(steps=4, total_s=0.5)
    assert timing.per_step_s == jtiming.per_step_s
    assert timing.throughput(32) == jtiming.throughput(32)
    for block in (None, (8, 32)):
        r = profiling.AggregationRoofline(1000, 300, 16, dense_block=block)
        jr = jprofiling.AggregationRoofline(1000, 300, 16, dense_block=block)
        assert r.flops(3) == jr.flops(3)
        assert r.bytes_moved() == jr.bytes_moved()
        assert r.bytes_moved(2) == jr.bytes_moved(2)
        assert r.bytes_per_edge() == jr.bytes_per_edge()
        assert r.edges_per_s(timing) == jr.edges_per_s(jtiming)
    x = torch.ones(4)
    t = profiling.time_steps(lambda a: {"y": [a * 2]}, x, steps=3, warmup=1)
    assert t.steps == 3 and t.total_s >= 0
    profiling.force_sync({"a": (x, [x])})
    assert not torch.cuda.is_available()
    assert profiling.chip_peak_flops() is None
    assert profiling.chip_peak_flops("float32") is None
    assert profiling.mfu(1e12) is None
    assert profiling.chip_peak_hbm_bytes_per_s() is None
    assert profiling.hbm_utilization(1e12) is None
    runtime.setup()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_runtime_deterministic_is_scoped():
    """runtime.deterministic turns deterministic algorithms on (warn-only)
    for its block and restores the flags after it, also when the block
    raises; index_add_ has a deterministic form, so nothing is named."""
    assert not torch.are_deterministic_algorithms_enabled()
    with runtime.deterministic() as refused:
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
        out = torch.zeros(3).index_add_(0, torch.tensor([0, 0, 2]),
                                        torch.ones(3))
    assert refused == [] and out.tolist() == [2.0, 0.0, 1.0]
    assert not torch.are_deterministic_algorithms_enabled()
    with pytest.raises(ValueError, match="inside"):
        with runtime.deterministic():
            raise ValueError("inside")
    assert not torch.are_deterministic_algorithms_enabled()
    assert not torch.is_deterministic_algorithms_warn_only_enabled()


def test_port_imports_no_jax_or_matplotlib():
    """Importing every module of the port (the ingestion, native library,
    serving, export, predict and preprocess modules among them),
    chip_smoke.py and bench_torch.py loads neither JAX, flax, the JAX
    package nor matplotlib, and builds no native library."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import pkgutil, importlib, sys, hgnn2_torch\n"
        "for m in pkgutil.walk_packages(hgnn2_torch.__path__, 'hgnn2_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, bench_torch\n"
        "from hgnn2_torch import native\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'hgnn2_tpu', 'matplotlib')]\n"
        "new = ['hgnn2_torch.' + m for m in ('data.smiles', 'data.qm9', "
        "'native', 'serving', 'cli.export', 'cli.predict', 'cli.preprocess')]\n"
        "print(bad, [m for m in new if m not in sys.modules], native._lib)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[] [] None"
