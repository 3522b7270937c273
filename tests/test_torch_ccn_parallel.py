"""Vertex-sharded CCN training (--edge_shards, --dp M --edge_shards N on
CCN-1D and CCN-2D) in the port against the JAX package on the CPU, JAX's
shard_maps running on the 8 virtual CPU devices and the port's ranks all
on the CPU: make_ccn_shards and ShardedCCNLoader bit-equal (empty shards
and the overflow error included); make_sharded_ccn_apply, sharded_ccn_loss
and its gradients; whole run_experiment runs; the kernels only when
asked for; scanned against stepwise epochs; resume after a checkpoint;
the flattening of the ranks' CCN tables (the -1 sentinels, graph-id
padding). JAX's sharded CCN runs on its XLA path (its sharded dispatch
comes before the kernels' auto rule); the port's kernel wrappers run
their plain versions on the CPU. Weights are JAX's init, carried over by
hgnn2_torch.convert.

Tolerances: outputs atol 1e-5 (JAX's kernel-off test, ops in another
order); losses rtol 1e-5; gradients within 1e-5 x the largest |grad|;
epoch histories rtol 1e-4 (no BN, so no metric walks)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import torch
from jax.sharding import Mesh

from hgnn2_tpu.cli import common as jcommon
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import ccn as jccn
from hgnn2_tpu.parallel import ccn_parallel as jccn_parallel
from hgnn2_tpu.training import sharded as jsharded
from hgnn2_tpu.training.config import TrainConfig as JTrainConfig

from hgnn2_torch import convert
from hgnn2_torch.cli import common
from hgnn2_torch.data import qm9
from hgnn2_torch.nn import ccn
from hgnn2_torch.parallel import ccn_parallel, spmd
from hgnn2_torch.training import sharded
from hgnn2_torch.training.config import TrainConfig

torch.set_num_threads(2)

CB_FIELDS = ("x", "nbr", "chi_idx", "rslot", "deg", "row_mask", "vmask",
             "gid", "y", "gmask")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mesh(dp, S):
    return Mesh(np.array(jax.devices()[:dp * S]).reshape(dp, S),
                ("data", "edge"))


def _assert_stacks_equal(got, want):
    assert got.n_graphs == want.n_graphs
    for name in CB_FIELDS:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("n,S", [(9, 2), (3, 4)])
def test_make_ccn_shards_bit_equal(n, S):
    """3 molecules over 4 shards leaves one all-padding shard."""
    kw = dict(k_max=6, vertex_capacity=140, graphs_per_shard=5, task=0)
    got = ccn_parallel.make_ccn_shards(qm9.synthetic_qm9_like(n, seed=2), S,
                                       device="cpu", **kw)
    want = jccn_parallel.make_ccn_shards(jqm9.synthetic_qm9_like(n, seed=2),
                                         S, **kw)
    assert got.x.shape[0] == S
    _assert_stacks_equal(got, want)
    if n < S:
        assert float(got.gmask[-1].sum()) == 0.0
        assert bool((got.chi_idx[-1] == -1).all())
    with pytest.raises(ValueError, match="graphs_per_shard"):  # pigeonholes
        ccn_parallel.make_ccn_shards(qm9.synthetic_qm9_like(n, seed=2), S,
                                     device="cpu",
                                     **{**kw, "graphs_per_shard": -(-n // S) - 1})


@pytest.mark.parametrize("n_data,S", [(1, 4), (2, 2)])
def test_sharded_ccn_loader_bit_equal(n_data, S):
    kw = dict(task=0, shuffle=True, seed=5, n_data=n_data)
    loader = sharded.ShardedCCNLoader(qm9.synthetic_qm9_like(29, seed=3), 10, S,
                                      device="cpu", **kw)
    jloader = jsharded.ShardedCCNLoader(jqm9.synthetic_qm9_like(29, seed=3), 10,
                                        S, **kw)
    assert len(loader) == len(jloader) == 3
    for got, want in zip(loader.batches(), jloader.batches()):
        _assert_stacks_equal(got, want)
    for _ in range(2):
        np.testing.assert_array_equal(loader.epoch_order(),
                                      jloader.epoch_order())


@pytest.fixture(scope="module")
def shards():
    """12 molecules over 2 and 4 shards, K = 6."""
    out = {}
    for S in (2, 4):
        kw = dict(k_max=6, vertex_capacity=128, graphs_per_shard=6, task=0)
        out[S] = (ccn_parallel.make_ccn_shards(qm9.synthetic_qm9_like(12, seed=1),
                                               S, device="cpu", **kw),
                  jccn_parallel.make_ccn_shards(
                      jqm9.synthetic_qm9_like(12, seed=1), S, **kw))
    return out


@pytest.mark.parametrize("arch,S", [("ccn1d", 2), ("ccn2d", 4)])
def test_sharded_ccn_apply_loss_and_grads_match_jax(shards, arch, S):
    stacked, jstacked = shards[S]
    jcls, cls = ((jccn.CCN1D, ccn.CCN1D) if arch == "ccn1d"
                 else (jccn.CCN2D, ccn.CCN2D))
    jmodel = jcls(hidden=2, n_layers=2, dim_output=1)
    variables = _np(jmodel.init(jax.random.key(3),
                                jax.tree.map(lambda v: v[0], jstacked),
                                train=True))
    model = cls(n_features=5, hidden=2, n_layers=2)
    model.load_state_dict(convert.ccn_params_from_flax(variables))
    mesh = _mesh(1, S)
    mean, std = 0.3, 1.7
    with jax.sharding.set_mesh(mesh):
        want_out = np.asarray(jax.jit(jccn_parallel.make_sharded_ccn_apply(
            jmodel, mesh))(variables, jstacked))
        jloss = jccn_parallel.sharded_ccn_loss(jmodel, mesh, "regression",
                                               mean, std)
        want, jgrads = jax.jit(jax.value_and_grad(jloss))(variables, jstacked)
    grid = spmd.RankGrid(1, S, "cpu")
    with torch.no_grad():
        out = ccn_parallel.make_sharded_ccn_apply(model, grid)(stacked)
    assert out.shape == want_out.shape == (S, 6, 1)
    np.testing.assert_allclose(out.numpy(), want_out, atol=1e-5)
    loss = ccn_parallel.sharded_ccn_loss(model, grid, "regression", mean,
                                         std)(stacked)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    grads = convert.ccn_params_to_flax({f"{n}": p.grad
                                        for n, p in model.named_parameters()})
    jgrads = _np(jgrads)["params"]
    top = max(np.abs(v).max() for d in jgrads.values() for v in d.values())
    assert grads.keys() == jgrads.keys()
    for name, d in grads.items():
        for f, g in d.items():
            np.testing.assert_allclose(g, jgrads[name][f], rtol=0,
                                       atol=1e-5 * top, err_msg=f"{name}.{f}")


def _cfgs(tmp_path, tag, arch, dp, es, **extra):
    """JAX's and the port's TrainConfig of one sharded CCN run at JAX's
    test sizes (tests/test_parallel.py): 48 molecules in batches of 16,
    L=2, h=3, 2 epochs of SGD at lr 1e-4."""
    cfgs = []
    for cls, dev in ((JTrainConfig, None), (TrainConfig, "cpu")):
        cfg = cls(batch_size=16, epochs=2, dp=dp, edge_shards=es,
                  log_path=str(tmp_path / f"{tag}_{dev or 'jax'}"), **extra)
        if dev:
            cfg.device = dev
        cfg.model.arch, cfg.model.n_layers, cfg.model.n_features = arch, 2, 3
        cfg.optim.optim, cfg.optim.lr, cfg.optim.momentum = "sgd", 1e-4, 0.0
        cfg.data.dataset, cfg.data.n_synthetic = "qm9_synthetic", 48
        cfgs.append(cfg)
    return cfgs


def _recorded_inits(monkeypatch):
    """The initial variables of every JAX CCN model init that follows."""
    inits = []
    for cls in (jccn.CCN1D, jccn.CCN2D):
        orig = cls.init

        def record(self, *args, orig=orig, **kwargs):
            inits.append(_np(orig(self, *args, **kwargs)))
            return inits[-1]

        monkeypatch.setattr(cls, "init", record)
    return inits


def _assert_histories(got, want, rtol=1e-4):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            if k != "epoch_time_s":
                np.testing.assert_allclose(a[k], b[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("arch,dp,es,chunks", [
    pytest.param("ccn1d", 1, 2, 1, id="ccn1d-1-2"),
    pytest.param("ccn1d", 2, 2, 1, id="ccn1d-2-2"),
    pytest.param("ccn2d", 1, 4, 1, id="ccn2d-1-4"),
    pytest.param("ccn2d", 1, 2, 2, id="ccn2d-1-2-chunks2")])
def test_run_experiment_sharded_ccn_matches_jax(tmp_path, monkeypatch, arch,
                                                dp, es, chunks):
    """--chunks 2 under --edge_shards 2 runs on 72 molecules, whose shards
    hold 90, 36 and 44 vertices in the three splits: JAX applies the
    model a shard at a time and needs each count divisible by the chunks."""
    inits = _recorded_inits(monkeypatch)
    jcfg, cfg = _cfgs(tmp_path, "run", arch, dp, es)
    if chunks > 1:
        for c in (jcfg, cfg):
            c.model.vertex_chunks, c.data.n_synthetic = chunks, 72
    _, want = jcommon.run_experiment(jcfg)
    model, got = common.run_experiment(cfg, init_params=inits[0])
    assert isinstance(model, ccn.CCN1D if arch == "ccn1d" else ccn.CCN2D)
    assert not model.kernel and cfg.model.ccn_kernel is None
    assert getattr(model, "vertex_chunks", 1) == chunks
    _assert_histories(got, want)


def test_sharded_ccn_kernel_only_when_asked(tmp_path):
    """--ccn_kernel unset: the plain path, as JAX's sharded dispatch runs
    before the kernels' auto rule; given, the kernels' wrappers (their
    plain versions on the CPU), with the same trajectory."""
    runs = []
    for flag in (None, True):
        _, cfg = _cfgs(tmp_path, f"k{flag}", "ccn2d", 1, 2)
        cfg.model.ccn_kernel = flag
        model, history = common.run_experiment(cfg)
        assert model.kernel is bool(flag)
        runs.append(history)
    _assert_histories(runs[1], runs[0], rtol=1e-6)


def test_sharded_ccn_scanned_equals_stepwise(tmp_path):
    runs = []
    for scan in (True, False):
        _, cfg = _cfgs(tmp_path, f"scan{scan}", "ccn1d", 2, 2, scan_epochs=scan)
        model, history = common.run_experiment(cfg)
        runs.append((model.state_dict(), history))
    (sa, ha), (sb, hb) = runs
    _assert_histories(ha, hb, rtol=1e-6)
    for k, v in sa.items():
        torch.testing.assert_close(v, sb[k], rtol=0, atol=1e-7, msg=k)


def test_sharded_resume_matches_jax(tmp_path, monkeypatch):
    """One epoch with --ckpt, then --resume to two, in both packages:
    each run's rows, the resumed one's batch order drawn afresh, as in
    JAX."""
    inits = _recorded_inits(monkeypatch)
    hist = {}
    for epochs, resume in ((1, False), (2, True)):
        jcfg, cfg = _cfgs(tmp_path, f"res{epochs}", "ccn1d", 1, 2)
        for c, d in ((jcfg, "jax"), (cfg, "torch")):
            c.epochs, c.resume = epochs, resume
            c.checkpoint_path = str(tmp_path / f"ckpt_{d}")
        _, hist[("jax", epochs)] = jcommon.run_experiment(jcfg)
        _, hist[("torch", epochs)] = common.run_experiment(
            cfg, init_params=inits[0])
    assert len(hist[("torch", 2)]) == 1
    for epochs in (1, 2):
        _assert_histories(hist[("torch", epochs)], hist[("jax", epochs)])


def test_flatten_ccn_shards_traps():
    """5 molecules over 4 shards of 3 graph slots: the chi_idx and rslot
    tables (slots, with -1 sentinels) are unchanged, nbr moves by its
    shard's block (padding slots to the shard's first vertex, where
    chi_idx = -1 keeps them out), graph-id padding goes to the one drop
    slot R Gl; an eval forward over the flattened batch, kernels' path
    included, equals one a shard."""
    S, Gl, Vl = 4, 3, 60
    stacked = ccn_parallel.make_ccn_shards(qm9.synthetic_qm9_like(5, seed=9), S,
                                           k_max=6, vertex_capacity=Vl,
                                           graphs_per_shard=Gl, task=0,
                                           device="cpu")
    flat = spmd.flatten_shards(stacked)
    assert flat.n_graphs == S * Gl
    assert torch.equal(flat.chi_idx, stacked.chi_idx.reshape(S * Vl, 6, 6))
    assert torch.equal(flat.rslot, stacked.rslot.reshape(S * Vl, 6))
    for r in range(S):
        v = slice(r * Vl, (r + 1) * Vl)
        assert torch.equal(flat.nbr[v], stacked.nbr[r] + r * Vl)
        real = stacked.vmask[r] > 0
        assert torch.equal(flat.gid[v][real], stacked.gid[r][real] + r * Gl)
        assert bool((flat.gid[v][~real] == S * Gl).all())
    for cls in (ccn.CCN1D, ccn.CCN2D):
        for kernel in (False, True):
            model = cls(n_features=5, hidden=2, n_layers=2, kernel=kernel,
                        generator=torch.Generator().manual_seed(2))
            with torch.no_grad():
                got = model(flat).reshape(S, Gl, -1)
                for r in range(S):
                    one = ccn.CCNBatch(**{f: getattr(stacked, f)[r]
                                          for f in CB_FIELDS}, n_graphs=Gl)
                    torch.testing.assert_close(got[r], model(one), rtol=1e-6,
                                               atol=1e-6)
