"""The CUDA graphs of hgnn2_torch.training.train against the eager steps,
on the card (marked requires_cuda; each skips without a card). The file
imports the port (and the benchmark's kernel table) only, so it runs
where JAX is not installed:

    python -m pytest tests/test_torch_cuda_graphs.py -q

From the same weights and the same batch order: two epochs through
run_epoch_scanned (captured) and through the eager run_epoch over
groups_in_order, then evaluate_scanned against evaluate and the
captured BN recalibration against the eager one; make_multi_train_step
against its steps one by one; Adam and SGD captured against eager;
a fit whose optimizer is reset each epoch
and whose checkpoint is restored, captured after both; one graph pool a
model; the port's hgnn2.* spans add no device row. GNNSimple's dense
steps are expected bit-equal and held to rtol 1e-6; PackedGNN's and
CCN1D's (K1 and K2) sum with index_add_'s atomics, whose order changes
from run to run, and are held to 1e-4 of each value's scale."""

import numpy as np
import pytest
import torch

from hgnn2_torch.data import batching, qm9
from hgnn2_torch.nn import ccn, models, packed
from hgnn2_torch.training import optim, train
from hgnn2_torch.training.checkpoint import Checkpointer
from hgnn2_torch.training.config import OptimConfig, TrainConfig

OCFG = dict(optim="adamax", lr=1e-3, lr_damping=0.5, epoch_step=1)
RTOL = {"gnn": 1e-6, "packed": 1e-4, "ccn1d": 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs are captured only there")
    return torch.device("cuda")


def _setup(arch: str, device, n: int = 96, bs: int = 16):
    """Batches on the card and a model at L=2, h=2 with seeded weights
    (CCN1D with its kernels K1 and K2); mean and std."""
    recs = qm9.synthetic_qm9_like(n, seed=5)
    ys = np.array([r.y[0] for r in recs])
    gen = torch.Generator().manual_seed(0)
    if arch == "gnn":
        loader = batching.DenseLoader(recs, bs, task=0, device=device)
        model = models.GNNSimple(in_features=5, n_features=2, n_layers=2,
                                 generator=gen)
    elif arch == "packed":
        loader = batching.PackedLoader(recs, bs, task=0, uniform_caps=False,
                                       device=device)
        model = packed.PackedGNN(in_features=5, n_features=2, n_layers=2,
                                 generator=gen)
    else:
        loader = batching.CCNLoader(recs, bs // 3, task=0, device=device)
        model = ccn.CCN1D(n_features=5, hidden=2, n_layers=2, kernel=True,
                          generator=gen)
    return list(loader), model.to(device), float(ys.mean()), float(ys.std())


def _run(arch: str, device, captured: bool):
    batches, model, mean, std = _setup(arch, device)
    opt, sched = optim.build_optimizer(OptimConfig(**OCFG), len(batches),
                                       model.parameters())
    rng = np.random.default_rng(3)
    if captured:
        groups = train.group_stacked_batches(batches)
        assert len(groups) >= 2
        fn = train.make_scanned_epoch(model, opt, sched, "regression", mean, std)
        hist = [train.run_epoch_scanned(groups, fn, rng) for _ in range(2)]
        assert fn.graphs.replays == 2 * len(batches)
        assert len(fn.graphs.graphs) == len(groups)
        ev = train.evaluate_scanned(groups, train.make_scanned_eval(
            model, "regression", mean, std))
        train.recalibrate_bn(model, groups=groups)
    else:
        groups = train.group_batches(batches)
        hist = [train.run_epoch(model, opt, sched,
                                train.groups_in_order(groups, rng),
                                "regression", mean, std) for _ in range(2)]
        flat = [b for g in groups for b in g]
        ev = train.evaluate(model, flat, "regression", mean, std)
        train.recalibrate_bn(model, loader=flat)
    return hist + [ev], {k: v.cpu() for k, v in model.state_dict().items()}


def _same(a: dict, b: dict, rtol: float) -> None:
    for k, v in b.items():
        torch.testing.assert_close(a[k], v, rtol=rtol,
                                   atol=rtol * float(v.abs().max()), msg=k)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["gnn", "packed", "ccn1d"])
def test_captured_training_matches_eager_on_the_card(cuda, arch):
    (rows1, state1), (rows0, state0) = (_run(arch, cuda, c) for c in (True, False))
    for a, b in zip(rows1, rows0):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL[arch], err_msg=k)
    _same(state1, state0, RTOL[arch])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_captured_epochs_match_eager_for_adam_and_sgd(cuda, name):
    """The other two optimizers build_optimizer makes for the card (Adam
    capturable, SGD with momentum reading a device lr): two captured
    epochs of GNNSimple against two eager ones, across a decay."""
    runs = []
    for captured in (True, False):
        batches, model, mean, std = _setup("gnn", cuda)
        cfg = OptimConfig(**dict(OCFG, optim=name))
        opt, sched = optim.build_optimizer(cfg, len(batches), model.parameters())
        rng = np.random.default_rng(3)
        if captured:
            groups = train.group_stacked_batches(batches)
            fn = train.make_scanned_epoch(model, opt, sched, "regression",
                                          mean, std)
            rows = [train.run_epoch_scanned(groups, fn, rng) for _ in range(2)]
        else:
            groups = train.group_batches(batches)
            rows = [train.run_epoch(model, opt, sched,
                                    train.groups_in_order(groups, rng),
                                    "regression", mean, std) for _ in range(2)]
        runs.append((rows, {k: v.cpu() for k, v in model.state_dict().items()}))
    for a, b in zip(runs[0][0], runs[1][0]):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL["gnn"], err_msg=k)
    _same(runs[0][1], runs[1][1], RTOL["gnn"])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["gnn", "ccn1d"])
def test_multi_train_step_matches_eager_steps_on_the_card(cuda, arch):
    """make_multi_train_step(n_inner=3), one graph, against 3 eager steps,
    twice, across the schedule's halving (4 steps an epoch)."""
    runs = []
    for multi in (True, False):
        batches, model, mean, std = _setup(arch, cuda)
        opt, sched = optim.build_optimizer(OptimConfig(**OCFG), 4,
                                           model.parameters())
        step = train.make_multi_train_step(model, opt, sched, "regression",
                                           mean, std, n_inner=3)
        for _ in range(2):
            if multi:
                step(batches[0])
            else:
                for _ in range(3):
                    train.train_step(model, opt, sched, batches[0],
                                     "regression", mean, std)
        assert sched.last_epoch == 6
        runs.append({k: v.cpu() for k, v in model.state_dict().items()})
    _same(runs[0], runs[1], RTOL[arch])


@pytest.mark.requires_cuda
def test_fit_captures_after_the_restore_and_resets_in_place(cuda, tmp_path):
    """fit with reset_each_epoch (optim.reset, in place) in the captured
    epochs: three epochs in one run against two, saved, and a third
    resumed from the checkpoint, whose fit captures after the restore.
    The optimizer is reset at each epoch's start, so the resumed epoch
    starts where the uninterrupted one did and must end where it did."""
    batches, model, mean, std = _setup("gnn", cuda)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    loader = batching.CachedLoader(_Fixed(batches), shuffle=False)

    def make_loader(split):
        return loader if split == "train" else None

    cfg = TrainConfig(batch_size=16, epochs=3, seed=0)
    cfg.optim.reset_each_epoch = True
    _, full = train.fit(model, make_loader, cfg, mean=mean, std=std)
    model.load_state_dict(init)
    ck = Checkpointer(str(tmp_path))
    cfg.epochs = 2
    train.fit(model, make_loader, cfg, mean=mean, std=std, checkpointer=ck)
    model.load_state_dict(init)  # the restore must bring the trained weights
    cfg.epochs, cfg.resume = 3, True
    _, resumed = train.fit(model, make_loader, cfg, mean=mean, std=std,
                           checkpointer=ck)
    assert len(resumed) == 1
    for k, v in full[-1].items():
        if k != "epoch_time_s":
            np.testing.assert_allclose(resumed[0][k], v, rtol=1e-6, err_msg=k)


@pytest.mark.requires_cuda
def test_a_models_graphs_share_one_pool(cuda):
    """Every program of a model captures into the model's one pool, made
    at its first capture; another model gets its own. pool_bytes reads
    the pool's segments, the same from every program of the model."""
    batches, model, mean, std = _setup("gnn", cuda)
    opt, sched = optim.build_optimizer(OptimConfig(**OCFG), len(batches),
                                       model.parameters())
    groups = train.group_stacked_batches(batches)
    fn = train.make_scanned_epoch(model, opt, sched, "regression", mean, std)
    assert fn.graphs.pool_bytes == 0
    train.run_epoch_scanned(groups, fn)
    pool = train._POOLS[model]
    first = fn.graphs.pool_bytes
    assert first > 0
    ev = train.make_scanned_eval(model, "regression", mean, std)
    train.evaluate_scanned(groups, ev)
    assert train._POOLS[model] is pool
    assert ev.graphs.pool_bytes == fn.graphs.pool_bytes >= first
    other = _setup("gnn", cuda)[1]
    train.evaluate_scanned(groups, train.make_scanned_eval(
        other, "regression", mean, std))
    assert tuple(train._POOLS[other]) != tuple(pool)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("program", ["step", "epoch"])
def test_spans_add_no_device_row(cuda, program, monkeypatch):
    """A captured GNNSimple step (make_train_step) or scanned epoch,
    replayed under torch.profiler with the port's hgnn2.* spans and again
    with their gate patched off: no device event or kernel-table row is
    named hgnn2.*, and the kernel table counts the same kernels."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import frozen
    from hgnn2_torch import profiling

    batches, model, mean, std = _setup("gnn", cuda)
    opt, sched = optim.build_optimizer(OptimConfig(**OCFG), len(batches),
                                       model.parameters())
    if program == "step":
        step = train.make_train_step(model, opt, sched, "regression", mean, std)
        run = lambda: [step(batches[0]) for _ in range(3)]  # noqa: E731
        replays = 3
    else:
        groups = train.group_stacked_batches(batches)
        fn = train.make_scanned_epoch(model, opt, sched, "regression", mean, std)
        run = lambda: train.run_epoch_scanned(groups, fn)  # noqa: E731
        replays = len(batches)
    run()  # the captures
    torch.cuda.synchronize()

    def kernels() -> int:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        cpu = torch.autograd.DeviceType.CPU
        assert not [e.name for e in prof.events() if e.device_type != cpu
                    and e.name.startswith("hgnn2.")]
        rows = frozen.parse_kernel_stats(prof)
        assert not [r for r in rows if r["op_name"].startswith("hgnn2.")]
        return sum(r["occurrences"] for r in rows if r["category"] == "kernel")

    on = kernels()
    assert [s.name for s in profiling.spans()].count(
        "hgnn2.graph.replay") == replays
    monkeypatch.setattr(profiling, "span", lambda name: profiling._OFF)
    assert kernels() == on > 0


class _Fixed:
    """A loader over fixed batches (CachedLoader's inner loader)."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)
