"""CCN training in the port against the JAX package, on the CPU: the
optimizers against optax, the loss with padding graphs, the loaders and
their shuffled orders, the split and target stats, the epoch batch order,
CCN1D/CCN2D training steps against make_train_step with JAX's Pallas
kernels in interpret mode, and a whole main_ccn_qm9 run against JAX's
run_experiment.

Tolerances, each f32 computed in another order by the two packages:
optimizer trajectories atol 2e-6 (see the test: optax's f32 bias
correction);
losses and step-0 gradients rtol 1e-5 (sums over a batch, gradients
relative to the tensor's largest entry); parameters after 5 Adamax steps
atol 1e-6 (each step moves a weight by about lr = 1e-3 whatever its
gradient's size, so agreement is bounded by lr times the relative error
of the ratio mu/nu, not by the weight's size); epoch histories rtol 1e-4
(means over 2 epochs of 4 steps each)."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import optax
import torch

from hgnn2_tpu.cli import main_ccn_qm9 as jmain
from hgnn2_tpu.data import batching as jbatching
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.data import stats as jstats
from hgnn2_tpu.data import synthetic as jsynthetic
from hgnn2_tpu.nn import ccn as jccn
from hgnn2_tpu.training import optim as joptim
from hgnn2_tpu.training import train as jtrain
from hgnn2_tpu.training.config import OptimConfig as JOptimConfig

from hgnn2_torch import convert
from hgnn2_torch.cli import common, main_ccn_qm9
from hgnn2_torch.data import batching, qm9, stats, synthetic
from hgnn2_torch.nn import ccn
from hgnn2_torch.parallel import spmd
from hgnn2_torch.training import optim, train
from hgnn2_torch.training.checkpoint import Checkpointer
from hgnn2_torch.training.config import OptimConfig, TrainConfig

torch.set_num_threads(2)


def _assert_batches_equal(mine, ref):
    assert mine.n_graphs == ref.n_graphs
    for f in dataclasses.fields(mine):
        if f.name != "n_graphs":
            np.testing.assert_array_equal(getattr(mine, f.name).numpy(),
                                          np.asarray(getattr(ref, f.name)),
                                          err_msg=f.name)


@pytest.mark.parametrize("name", ["adamax", "adam", "sgd"])
def test_build_optimizer_matches_optax(name):
    """12 steps at 2 steps an epoch with the lr halved every 2 epochs: the
    schedule crosses its boundary at steps 4 and 8, so reading the lr one
    count late would move the weights by lr / 2 = 5e-3 there.

    Tolerance atol 2e-6: optax takes the bias correction 1 - b^t in f32,
    where b2 = 0.999 rounds to 0.99900001, so Adam's 1 - b2^t is off by
    up to 1.3e-5 relative at small t (torch takes it in double); over 12
    steps of about lr = 0.01 that is under 2e-6."""
    kw = dict(optim=name, lr=0.01, lr_damping=0.5, epoch_step=2, momentum=0.9)
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((3, 5)).astype(np.float32)
    grads = rng.standard_normal((12, 3, 5)).astype(np.float32)
    grads[:, 0, 0] = 0.0  # a weight that never gets a gradient
    tx = joptim.build_optimizer(JOptimConfig(**kw), 2)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = optim.build_optimizer(OptimConfig(**kw), 2, [w])
    lr_sched = joptim.stepped_decay(0.01, 0.5, 2, 2)
    for t in range(12):
        assert opt.param_groups[0]["lr"] == pytest.approx(lr_sched(t), rel=1e-12)
        upd, state = tx.update(jnp.asarray(grads[t]), state, jp)
        jp = optax.apply_updates(jp, upd)
        w.grad = torch.from_numpy(grads[t].copy())
        opt.step()
        sched.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=2e-6, err_msg=f"step {t}")


@pytest.mark.parametrize("kind", ["regression", "classification"])
def test_loss_and_metrics_with_padding_graphs(kind):
    rng = np.random.default_rng(1)
    gmask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    if kind == "regression":
        out = rng.standard_normal((6, 1)).astype(np.float32)
        y = (rng.standard_normal(6) * 3 + 1.5).astype(np.float32) * gmask
    else:
        out = rng.standard_normal((6, 2)).astype(np.float32)
        y = rng.integers(0, 2, 6).astype(np.int32)
    t_out = torch.from_numpy(out).requires_grad_()
    loss, mets = train._loss_and_metrics(t_out, torch.from_numpy(y),
                                         torch.from_numpy(gmask), kind, 1.5, 3.0)
    jloss, jmets = jtrain._loss_and_metrics(jnp.asarray(out), jnp.asarray(y),
                                            jnp.asarray(gmask), kind, 1.5, 3.0)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    assert mets.keys() == jmets.keys()
    for k in mets:
        np.testing.assert_allclose(mets[k].detach().item(), float(jmets[k]),
                                   rtol=1e-6)
    loss.backward()
    assert not t_out.grad[4:].any() and t_out.grad[:4].any()
    # a batch of padding alone divides by 1, not 0
    loss0, _ = train._loss_and_metrics(t_out, torch.from_numpy(y),
                                       torch.zeros(6), kind, 1.5, 3.0)
    assert loss0.item() == 0.0


def test_graph_mask_matches_jax():
    """The batch's gmask where it has one (a CCN batch), else n_nodes > 0
    (a dense batch, which has no gmask), padding graphs included."""
    import types

    n_nodes = np.array([5, 0, 3, 0, 9, 1], np.int32)
    gmask = np.array([1, 0, 1, 1, 0, 1], np.float32)  # differs from n_nodes > 0
    for fields in ({"gmask": gmask, "n_nodes": n_nodes}, {"n_nodes": n_nodes}):
        mine = train._graph_mask(types.SimpleNamespace(
            **{k: torch.from_numpy(v) for k, v in fields.items()}))
        ref = jtrain._graph_mask(types.SimpleNamespace(
            **{k: jnp.asarray(v) for k, v in fields.items()}))
        assert mine.dtype == torch.float32
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(mine.numpy(), [1, 0, 1, 0, 1, 1])


def test_cached_ccn_loader_matches_jax():
    """Batches, the seed + epoch order shuffle, peek_sample and a re-deal
    every 2 iterations from a shuffling inner loader, over 3 epochs."""
    kw = dict(task=0, shuffle=True, seed=1)
    mine = batching.CachedLoader(
        batching.CCNLoader(qm9.synthetic_qm9_like(30, seed=2), 8,
                           device="cpu", **kw), shuffle=True, seed=5,
        redeal_every=2)
    ref = jbatching.CachedLoader(
        jbatching.CCNLoader(jqm9.synthetic_qm9_like(30, seed=2), 8, **kw),
        shuffle=True, seed=5, redeal_every=2)
    assert len(mine) == len(ref) == 4
    _assert_batches_equal(mine.peek_sample(), ref.peek_sample())
    for _ in range(3):
        got, want = list(mine), list(ref)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            _assert_batches_equal(a, b)
    assert mine.batches()[0].x.device.type == "cpu"


@pytest.mark.parametrize("shuffle", [False, True])
def test_split_and_target_stats_match_jax(shuffle):
    recs, jrecs = qm9.synthetic_qm9_like(37, seed=3), jqm9.synthetic_qm9_like(37, seed=3)
    mine = synthetic.split_80_10_10(recs, shuffle=shuffle, seed=4)
    ref = jsynthetic.split_80_10_10(jrecs, shuffle=shuffle, seed=4)
    assert [len(s) for s in mine] == [len(s) for s in ref] == [29, 3, 5]
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(np.stack([r.y for r in a]),
                                      np.stack([r.y for r in b]))
    st, jst = stats.compute_target_stats(recs), jstats.compute_target_stats(jrecs)
    for field in ("mean", "std", "accuracy"):
        np.testing.assert_array_equal(getattr(st, field), getattr(jst, field))


@pytest.mark.parametrize("scan", [True, False])
def test_fit_epoch_order_matches_jax(monkeypatch, scan):
    """fit visits the batches in JAX's order: its scanned-epoch order
    (shape groups and their members shuffled by one default_rng(seed))
    with scan_epochs, CachedLoader's order without."""
    recs, jrecs = qm9.synthetic_qm9_like(30, seed=6), jqm9.synthetic_qm9_like(30, seed=6)
    loader = batching.CachedLoader(  # vertex buckets 64 and 128, interleaved
        batching.CCNLoader(recs, 5, task=0, device="cpu"), shuffle=True, seed=7)
    seen = []

    def record(model, opt, batch, *args):  # every train program's body
        seen.append(batch.y.numpy())
        return {"loss": torch.zeros(())}

    monkeypatch.setattr(train, "_train_body", record)
    cfg = TrainConfig(batch_size=5, epochs=3, seed=7, scan_epochs=scan)
    train.fit(ccn.CCN1D(n_features=5, hidden=2, n_layers=1),
              lambda split: loader if split == "train" else None, cfg)

    jloader = jbatching.CachedLoader(jbatching.CCNLoader(jrecs, 5, task=0),
                                     shuffle=True, seed=7)
    want = []
    if scan:
        groups = jtrain.group_stacked_batches(jloader.batches())
        assert len(groups) >= 2

        def scan_fn(state, stacked, order):
            want.extend(np.asarray(stacked.y[i]) for i in np.asarray(order))
            return state, {"count": jnp.float32(1.0)}

        rng = np.random.default_rng(7)
        for _ in range(3):
            jtrain.run_epoch_scanned(None, groups, scan_fn, rng)
    else:
        for _ in range(3):
            want.extend(np.asarray(b.y) for b in jloader)
    assert len(seen) == len(want) == 3 * 6
    for a, b in zip(seen, want):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def train_batches():
    """Two same-shape batches of 12 molecules in both packages (graphs of
    at most 33 vertices, so JAX's kernels fit their halo of 32)."""
    kw = dict(task=0, vertex_buckets=(256,))
    mine = list(batching.CCNLoader(qm9.synthetic_qm9_like(24, seed=1), 12,
                                   device="cpu", **kw))
    ref = list(jbatching.CCNLoader(jqm9.synthetic_qm9_like(24, seed=1), 12, **kw))
    ys = np.concatenate([np.asarray(b.y) for b in ref])
    return mine, ref, float(ys.mean()), float(ys.std())


@pytest.mark.parametrize("arch,n_layers,compat", [
    ("ccn1d", 3, False), ("ccn2d", 2, False), ("ccn2d", 2, True)])
def test_training_steps_match_jax(train_batches, arch, n_layers, compat):
    """Step-0 gradients, the loss of 5 Adamax steps (alternating batches,
    lr halved every epoch of 2 steps) and the final weights, from flax
    weights carried over, against make_train_step's body (_train_body)
    with JAX's Pallas kernels in interpret mode, jitted with the step's
    gradient beside it so that one program compiles; the port runs its
    autograd Functions, whose wrappers take the plain path on the CPU."""
    mine, ref, mean, std = train_batches
    if arch == "ccn1d":
        jkw, cls, kw = {}, ccn.CCN1D, {}
        jbase = jccn.CCN1D(hidden=2, n_layers=n_layers)
        jker = jccn.CCN1D(hidden=2, n_layers=n_layers, pallas_kernel=True,
                          kernel_halo=32, interpret=True)
    else:
        kw = dict(compat_contractions=compat)
        cls = ccn.CCN2D
        jbase = jccn.CCN2D(hidden=2, n_layers=n_layers, **kw)
        jker = jccn.CCN2D(hidden=2, n_layers=n_layers, pallas_kernel=True,
                          kernel_halo=32, interpret=True, **kw)
    ocfg = dict(optim="adamax", lr=1e-3, lr_damping=0.5, epoch_step=1)
    tx = joptim.build_optimizer(JOptimConfig(**ocfg), 2)
    state = jtrain.TrainState.create(jbase, ref[0], tx, jax.random.key(0))
    state = state.replace(apply_fn=jker.apply)
    model = cls(n_features=5, hidden=2, n_layers=n_layers, kernel=True, **kw)
    model.load_state_dict(convert.ccn_params_from_flax(
        jax.tree.map(np.asarray, state.params)))
    opt, sched = optim.build_optimizer(OptimConfig(**ocfg), 2, model.parameters())

    @jax.jit
    def step(state, batch):
        grads = jax.grad(lambda p: jtrain._loss_and_metrics(
            jker.apply({"params": p}, batch), batch.y, batch.gmask,
            "regression", mean, std)[0])(state.params)
        return *jtrain._train_body(state, batch, "regression", mean, std), grads

    for t in range(5):
        state, jm, jgrads = step(state, ref[t % 2])
        m = train.train_step(model, opt, sched, mine[t % 2], mean=mean, std=std)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {t}")
        np.testing.assert_allclose(float(m["mae"]), float(jm["mae"]), rtol=1e-5)
        if t == 0:
            grads = convert.ccn_params_to_flax(
                {n: p.grad for n, p in model.named_parameters()})
            for name, g in grads.items():
                for field in ("kernel", "bias"):
                    want = np.asarray(jgrads[name][field])
                    np.testing.assert_allclose(
                        g[field], want, rtol=1e-5,
                        atol=1e-5 * np.abs(want).max(), err_msg=name)
    final = convert.ccn_params_to_flax(model.state_dict())
    for name, p in final.items():
        for field in ("kernel", "bias"):
            np.testing.assert_allclose(p[field],
                                       np.asarray(state.params[name][field]),
                                       atol=1e-6, err_msg=name)


def test_ccn_params_to_flax_inverts_from_flax():
    model = ccn.CCN2D(n_features=5, hidden=2, n_layers=2,
                      generator=torch.Generator().manual_seed(0))
    back = convert.ccn_params_from_flax(convert.ccn_params_to_flax(model.state_dict()))
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v)


def test_main_ccn_qm9_matches_jax_run_experiment(tmp_path, monkeypatch):
    """The README quickstart (CCN-2D, L=2, h=2) on 64 synthetic molecules,
    2 epochs of batch 16: the port's CLI on the CPU against JAX's, both
    from JAX's initial weights, epoch by epoch."""
    argv = ["--k", "2", "--L", "2", "--h", "2", "--bs", "16", "--epochs", "2",
            "--n_synthetic", "64"]
    created = []
    create = jtrain.TrainState.create

    def record_init(*args, **kwargs):
        created.append(create(*args, **kwargs))
        return created[-1]

    monkeypatch.setattr(jtrain.TrainState, "create", record_init)
    _, want = jmain.main(argv + ["--log_path", str(tmp_path / "jax")])
    params = jax.tree.map(np.asarray, created[0].params)

    run = common.run_experiment
    monkeypatch.setattr(common, "run_experiment",
                        lambda cfg: run(cfg, init_params=params))
    model, got = main_ccn_qm9.main(
        argv + ["--device", "cpu", "--log_path", str(tmp_path / "torch")])
    assert isinstance(model, ccn.CCN2D) and not model.kernel
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            if k != "epoch_time_s":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    assert (tmp_path / "torch" / "results.jsonl").exists()
    assert (tmp_path / "torch" / "target_stats.npz").exists()


@pytest.mark.parametrize("field,value", [
    ("checkpointer", object()), ("mesh", object()), ("bn_recalibrate", True),
    ("resume", True)])
def test_fit_refuses_options_of_later_slices(tmp_path, field, value):
    """Named for the refusals it held before the training extras and the
    parallel modes were ported: a mesh in this process now trains (data
    parallelism, tests/test_torch_dp.py holds it to JAX's) and only a
    grid over processes raises; a checkpointer, BN recalibration and
    resume now run on a CCN1D, which has no BN, so recalibration appends
    no row (tests/test_torch_train_extras.py holds each to JAX's)."""
    cfg = TrainConfig(batch_size=4, epochs=1)
    model = ccn.CCN1D(n_features=5, hidden=2, n_layers=1)
    loader = batching.CCNLoader(qm9.synthetic_qm9_like(8, seed=0), 4, task=0,
                                device="cpu")
    if field == "mesh":
        over = spmd.RankGrid(2, 1, "cpu", groups={"data": None},
                             local=(1, 1), n_processes=2)
        with pytest.raises(NotImplementedError):
            train.fit(model, lambda split: None, cfg, mesh=over)
        _, history = train.fit(
            model, lambda split: loader if split == "train" else None, cfg,
            mesh=spmd.make_mesh(2, devices="cpu"))
        assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
        return
    ckpt = Checkpointer(str(tmp_path))
    if field != "checkpointer":
        setattr(cfg, field, value)
    for epochs in ((1, 2) if field == "resume" else (1,)):
        cfg.epochs = epochs
        _, history = train.fit(
            model, lambda split: loader if split == "train" else None, cfg,
            checkpointer=ckpt)
        assert len(history) == 1 and ckpt.latest_step() == epochs
        assert np.isfinite(history[0]["train_loss"])


@pytest.mark.parametrize("change", ["dp", "dataset", "arch"])
def test_run_experiment_refuses_configs_of_later_slices(tmp_path, change):
    """Named for the refusals it held before QM9 ingestion and the
    parallel modes were ported: dp without edge shards raises JAX's
    ValueError for CCN, which it cannot shard batch-wise
    (tests/test_torch_dp.py holds the message to JAX's; dense gnn/lggnn
    train); a QM9 cache at data_path now trains
    (tests/test_torch_ingest.py and tests/test_torch_export_predict.py
    hold ingestion to JAX's), and so does a packed model over edge shards
    (tests/test_torch_sharded.py holds it to JAX's)."""
    cfg = TrainConfig(batch_size=4, epochs=1, device="cpu",
                      log_path=str(tmp_path))
    cfg.data.dataset, cfg.data.n_synthetic = "qm9_synthetic", 8
    cfg.model.arch = "ccn1d"
    if change == "dataset":
        cfg.data.dataset, cfg.data.data_path = "qm9", str(tmp_path / "qm9.npz")
        qm9.save_cache(qm9.synthetic_qm9_like(10, seed=1), cfg.data.data_path)
        model, history = common.run_experiment(cfg)
        assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
        return
    if change == "arch":  # --packed over edge shards: the sharded trainer
        cfg.model.arch, cfg.model.packed, cfg.edge_shards = "gnn", True, 2
        model, history = common.run_experiment(cfg)
        assert model.layer0_bn.axis_name == "edge"
        assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
        return
    cfg.dp = 2
    with pytest.raises(ValueError, match="scale CCN with --edge_shards"):
        common.run_experiment(cfg)
