"""The port's compiled-program counterparts against the JAX package, on
the CPU: group_stacked_batches, run_epoch_scanned (batch order, epoch
metrics, parameters), evaluate_scanned, the scanned BN recalibration,
make_multi_train_step and time_scan_steps, for GNNSimple, PackedGNN and
CCN1D at L=2, h=2 over two epochs; optim.reset against a rebuilt
optimizer and optim.load_state across the two devices' layouts. On the
CPU each program's body runs eagerly; the CUDA graphs themselves are
held to the eager steps on the card by tests/test_torch_cuda_graphs.py
(marked requires_cuda, skipped without a card) and chip_smoke.py phase
10.

Tolerances, as tests/test_torch_gnn_train.py's: epoch metrics rtol 1e-4;
parameters atol 1e-6 plus the allowance of
tests/test_torch_trajectory_slack.py on the steps at which an entry's
exact gradient is zero by structure (Adamax steps such a weight by up to
about lr with its rounding's sign) or lies in Adamax's eps band (a BN
running mean gets its unit's biases' allowance); evaluate_scanned rtol 1e-6; BN
statistics rtol 1e-5, atol 1e-6; a step's metrics rtol 1e-5."""

import copy
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import torch

from hgnn2_tpu.data import batching as jbatching
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import ccn as jccn
from hgnn2_tpu.nn import models as jmodels
from hgnn2_tpu.nn import packed as jpacked
from hgnn2_tpu.training import optim as joptim
from hgnn2_tpu.training import train as jtrain
from hgnn2_tpu.training.config import OptimConfig as JOptimConfig

from hgnn2_torch import convert, profiling
from hgnn2_torch.data import batching, qm9
from hgnn2_torch.nn import ccn, models, packed
from hgnn2_torch.training import optim, train
from hgnn2_torch.training.config import OptimConfig
from test_torch_trajectory_slack import TrajectorySlack

torch.set_num_threads(2)

OCFG = dict(optim="adamax", lr=1e-3, lr_damping=0.5, epoch_step=1)
EPOCHS, SEED = 2, 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _setup(arch: str, n: int = 48, bs: int | None = None):
    """Both packages' batches of ``n`` molecules, models at L=2, h=2,
    mean and std, and the state-dict converters of the arch. The default
    batch (8 molecules, 5 for CCN) makes several shape groups."""
    bs = bs or (5 if arch == "ccn1d" else 8)
    recs, jrecs = qm9.synthetic_qm9_like(n, seed=5), jqm9.synthetic_qm9_like(n, seed=5)
    ys = np.array([r.y[0] for r in recs])
    if arch == "gnn":
        mine = list(batching.DenseLoader(recs, bs, task=0, device="cpu"))
        ref = list(jbatching.DenseLoader(jrecs, bs, task=0))
        jm = jmodels.GNNSimple(n_features=2, n_layers=2)
        model = models.GNNSimple(in_features=5, n_features=2, n_layers=2)
        conv = (convert.dense_variables_from_flax, convert.dense_variables_to_flax)
    elif arch == "packed":
        kw = dict(task=0, uniform_caps=False)
        mine = list(batching.PackedLoader(recs, bs, device="cpu", **kw))
        ref = list(jbatching.PackedLoader(jrecs, bs, **kw))
        jm = jpacked.PackedGNN(n_features=2, n_layers=2)
        model = packed.PackedGNN(in_features=5, n_features=2, n_layers=2)
        conv = (convert.packed_variables_from_flax, convert.packed_variables_to_flax)
    else:
        mine = list(batching.CCNLoader(recs, bs, task=0, device="cpu"))
        ref = list(jbatching.CCNLoader(jrecs, bs, task=0))
        jm = jccn.CCN1D(hidden=2, n_layers=2)
        model = ccn.CCN1D(n_features=5, hidden=2, n_layers=2)
        conv = (convert.ccn_params_from_flax,
                lambda sd: {"params": convert.ccn_params_to_flax(sd)})
    return mine, ref, jm, model, conv, float(ys.mean()), float(ys.std())


def _variables(state) -> dict:
    return _np({"params": state.params, "batch_stats": state.batch_stats})


@pytest.mark.parametrize("arch", ["gnn", "packed", "ccn1d"])
def test_group_stacked_batches_matches_jax(arch):
    """The same groups in the same order, each field's stack bit-equal to
    JAX's (None where JAX's batch has no such field)."""
    mine, ref, *_ = _setup(arch)
    got, want = train.group_stacked_batches(mine), jtrain.group_stacked_batches(ref)
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        for f in dataclasses.fields(g):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if a is None or not isinstance(a, torch.Tensor):
                assert a == b, f.name
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f.name)
    sizes = [train._group_size(g) for g in got]
    assert sum(sizes) == len(mine)


@pytest.fixture(scope="module", params=["gnn", "packed", "ccn1d"])
def trained(request):
    """Two epochs of both packages' scanned training from JAX's init, in
    order default_rng(SEED): the port's run_epoch_scanned with its step
    body spied on (batch, lr and gradients of every step), JAX's
    run_epoch_scanned, and JAX's gradients along the same order."""
    arch = request.param
    mine, ref, jm, model, (to_port, to_flax), mean, std = _setup(arch)
    tx = joptim.build_optimizer(JOptimConfig(**OCFG), len(ref))
    state = jtrain.TrainState.create(jm, ref[0], tx, jax.random.key(0))
    init = _variables(state)
    model.load_state_dict(to_port(init))
    opt, sched = optim.build_optimizer(OptimConfig(**OCFG), len(mine),
                                       model.parameters())
    groups = train.group_stacked_batches(mine)
    steps = []  # y of every port step
    slack = TrajectorySlack(model, to_flax)
    real = train._train_body

    def spy(model, optimizer, batch, *args):
        with slack.step(optimizer.param_groups[0]["lr"]):
            out = real(model, optimizer, batch, *args)
        steps.append(batch.y.numpy().copy())
        return out

    scan_fn = train.make_scanned_epoch(model, opt, sched, "regression", mean, std)
    rng = np.random.default_rng(SEED)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "_train_body", spy)
        got = [train.run_epoch_scanned(groups, scan_fn, rng) for _ in range(EPOCHS)]

    jgroups = jtrain.group_stacked_batches(ref)
    jscan = jtrain.make_scanned_epoch("regression", mean, std)
    rng, jstate, want = np.random.default_rng(SEED), state, []
    for _ in range(EPOCHS):
        jstate, m = jtrain.run_epoch_scanned(jstate, jgroups, jscan, rng)
        want.append(m)

    @jax.jit
    def grad_fn(state, batch):
        def loss_fn(params):
            out, _ = jtrain._forward(state, params, batch, train=True)
            return jtrain._loss_and_metrics(
                out, batch.y, jtrain._graph_mask(batch), "regression", mean,
                std)[0]
        return jax.grad(loss_fn)(state.params)

    jstep = jtrain.make_train_step("regression", mean, std)
    rng, sstate, jsteps = np.random.default_rng(SEED), state, []
    sizes = [train._group_size(g) for g in groups]
    for _ in range(EPOCHS):
        for g, order in list(train._epoch_order(sizes, rng)):
            for i in order:
                b = jax.tree.map(lambda x: x[i], jgroups[g])
                jsteps.append((np.asarray(b.y), _np(grad_fn(sstate, b))))
                sstate, _ = jstep(sstate, b)
    return dict(arch=arch, model=model, state=jstate, got=got, want=want,
                steps=steps, jsteps=jsteps, slack=slack, groups=groups, jgroups=jgroups,
                to_port=to_port, to_flax=to_flax, mean=mean, std=std,
                fresh=lambda: _setup(arch)[3])


def test_run_epoch_scanned_matches_jax(trained):
    """The port's scanned epochs visit JAX's batches in JAX's order, and
    give JAX's count-weighted epoch metrics and final parameters and BN
    running stats (with the rounding-level allowance of the docstring)."""
    t = trained
    assert len(t["steps"]) == len(t["jsteps"]) == EPOCHS * sum(
        train._group_size(g) for g in t["groups"])
    for y, (jy, _) in zip(t["steps"], t["jsteps"]):
        np.testing.assert_array_equal(y, jy)
    for got, want in zip(t["got"], t["want"]):
        assert got.keys() == want.keys() == {"loss", "mae"}
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    slack = t["slack"].allowance([jgrads for _, jgrads in t["jsteps"]])
    final = t["to_flax"](t["model"].state_dict())
    want = _variables(t["state"])
    for path, p in _leaves(final["params"]):
        w = dict(_leaves(want["params"]))[path]
        assert np.all(np.abs(p - w) <= 1e-6 + slack[path]), path
    stats = dict(_leaves(want["batch_stats"]))
    for path, s in _leaves(final.get("batch_stats", {})):
        atol = 1e-5 + 1e-5 * np.abs(stats[path])
        if path[-1] == "mean":  # a BN's features: concat(cv2, cv1)
            unit = path[:-2] if t["arch"] == "gnn" else (path[-2][:-2],)
            cv = [unit[:-1] + (unit[-1] + c,) if t["arch"] == "packed"
                  else unit + (c,) for c in ("cv2", "cv1")]
            atol = atol + np.concatenate([slack[c + ("bias",)] for c in cv])
        assert np.all(np.abs(s - stats[path]) <= atol), path


def _jax_weights(t):
    model = t["fresh"]()
    model.load_state_dict(t["to_port"](_variables(t["state"])))
    return model


def test_evaluate_scanned_matches_jax(trained):
    """evaluate_scanned over the stacked groups, from JAX's trained
    weights, against JAX's evaluate_scanned and the port's eager
    evaluate over the same batches."""
    t = trained
    model = _jax_weights(t)
    fn = train.make_scanned_eval(model, "regression", t["mean"], t["std"])
    got = train.evaluate_scanned(t["groups"], fn)
    want = jtrain.evaluate_scanned(
        t["state"], t["jgroups"],
        jtrain.make_scanned_eval("regression", t["mean"], t["std"]))
    assert got.keys() == want.keys() == {"loss", "mae"}
    eager = train.evaluate(model, [train._select(g, torch.tensor([i]))
                                   for g in t["groups"]
                                   for i in range(train._group_size(g))],
                           "regression", t["mean"], t["std"])
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k], eager[k], rtol=1e-6, err_msg=k)
    assert train.evaluate_scanned([], fn) == {}


def test_recalibrate_bn_scanned_matches_jax(trained):
    """recalibrate_bn(groups=) over the stacked groups against JAX's
    scanned recalibration from the same weights, and against the port's
    eager per-batch path; a model without BN is left as it is."""
    t = trained
    model = _jax_weights(t)
    before = t["to_flax"](model.state_dict())
    assert train.recalibrate_bn(model, groups=t["groups"]) is model
    got = dict(_leaves(t["to_flax"](model.state_dict()).get("batch_stats", {})))
    if t["arch"] == "ccn1d":
        assert not got and not t["state"].batch_stats
        return
    assert not model.training
    want = dict(_leaves(_np(jtrain.recalibrate_bn(
        t["state"], groups=t["jgroups"]).batch_stats)))
    eager = _jax_weights(t)
    train.recalibrate_bn(eager, loader=[
        train._select(g, torch.tensor([i])) for g in t["groups"]
        for i in range(train._group_size(g))])
    eager = dict(_leaves(t["to_flax"](eager.state_dict())["batch_stats"]))
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6, err_msg=str(k))
        np.testing.assert_allclose(eager[k], v, rtol=1e-5, atol=1e-6, err_msg=str(k))
    old = dict(_leaves(before["batch_stats"]))
    assert any(not np.allclose(old[k], v) for k, v in got.items())


def _ccn_one_batch():
    mine, ref, jm, model, (to_port, to_flax), mean, std = _setup("ccn1d", n=16,
                                                                  bs=16)
    tx = joptim.build_optimizer(JOptimConfig(**OCFG), 4)
    state = jtrain.TrainState.create(jm, ref[0], tx, jax.random.key(1))
    model.load_state_dict(to_port(_variables(state)))
    opt, sched = optim.build_optimizer(OptimConfig(**OCFG), 4, model.parameters())
    return mine[0], ref[0], model, opt, sched, state, to_flax, mean, std


def test_make_multi_train_step_matches_jax():
    """CCN1D (no BN, so no weight has a rounding-level gradient): two calls
    of make_multi_train_step(n_inner=3) against JAX's, with 4 steps an
    epoch, so the lr halves inside the second call; each call's last
    metrics and the parameters after each call."""
    batch, jbatch, model, opt, sched, state, to_flax, mean, std = _ccn_one_batch()
    step = train.make_multi_train_step(model, opt, sched, "regression", mean,
                                       std, n_inner=3)
    jstep = jtrain.make_multi_train_step("regression", mean, std, n_inner=3)
    for call in range(2):
        m = step(batch)
        state, jm_ = jstep(state, jbatch)
        for k in ("loss", "mae"):
            np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=1e-5,
                                       err_msg=f"call {call} {k}")
        want = dict(_leaves(_np(state.params)))
        for path, p in _leaves(to_flax(model.state_dict())["params"]):
            np.testing.assert_allclose(p, want[path], rtol=0, atol=1e-6,
                                       err_msg=f"call {call} {path}")
    assert sched.last_epoch == 6
    assert opt.param_groups[0]["lr"] == pytest.approx(OCFG["lr"] / 2)


def test_time_scan_steps_returns_a_step_timing():
    batch, _, model, opt, sched, *_ = _ccn_one_batch()
    step = train.make_multi_train_step(model, opt, sched, n_inner=2)
    timing = profiling.time_scan_steps(step, batch, steps=3, warmup=1)
    assert isinstance(timing, profiling.StepTiming)
    assert timing.steps == 3 and timing.total_s > 0
    assert sched.last_epoch == 2 * (3 + 1)


@pytest.mark.parametrize("name", ["adamax", "adam", "sgd"])
def test_reset_equals_a_rebuilt_optimizer(name):
    """optim.reset (fit's reset_each_epoch, in place so that captured
    steps keep their tensors) trains on exactly as a rebuilt optimizer
    and schedule do (optax's tx.init)."""
    mine, _, _, model, *_ = _setup("gnn", n=16)
    cfg = OptimConfig(optim=name, lr=1e-2, lr_damping=0.5, epoch_step=1)
    runs = []
    for rebuild in (True, False):
        m = models.GNNSimple(in_features=5, n_features=2, n_layers=2)
        m.load_state_dict(model.state_dict())
        opt, sched = optim.build_optimizer(cfg, 1, m.parameters())
        for b in mine:
            train.train_step(m, opt, sched, b)
        if rebuild:
            opt, sched = optim.build_optimizer(cfg, 1, m.parameters())
        else:
            optim.reset(opt, sched)
        assert opt.param_groups[0]["lr"] == cfg.lr and sched.last_epoch == 0
        for b in mine:
            train.train_step(m, opt, sched, b)
        runs.append(m.state_dict())
    for k, v in runs[0].items():
        torch.testing.assert_close(runs[1][k], v, rtol=0, atol=0, msg=k)


def test_load_state_keeps_the_optimizers_device_layout():
    """A checkpoint's optimizer state as the card writes it (a tensor lr,
    capturable, float32 step counts) loads into a CPU optimizer as a float
    lr, not capturable, and trains on exactly as the CPU's own state."""
    mine, _, _, model, *_ = _setup("gnn", n=16)
    opt, sched = optim.build_optimizer(OptimConfig(), 1, model.parameters())
    train.train_step(model, opt, sched, mine[0])
    plain = opt.state_dict()
    card = {"state": {k: {n: v.float() for n, v in s.items()}
                      for k, s in plain["state"].items()},
            "param_groups": [dict(g, lr=torch.tensor(g["lr"]), capturable=True)
                             for g in plain["param_groups"]]}
    runs = []
    for sd in (plain, card):
        m = models.GNNSimple(in_features=5, n_features=2, n_layers=2)
        m.load_state_dict(model.state_dict())
        o, s = optim.build_optimizer(OptimConfig(), 1, m.parameters())
        optim.load_state(o, copy.deepcopy(sd))
        assert isinstance(o.param_groups[0]["lr"], float)
        assert o.param_groups[0]["capturable"] is False
        train.train_step(m, o, s, mine[1])
        runs.append(m.state_dict())
    for k, v in runs[0].items():
        torch.testing.assert_close(runs[1][k], v, rtol=0, atol=0, msg=k)
