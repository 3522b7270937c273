"""CCN-2D's two memory-bounded strategies for high K in the port, against
the JAX package on the CPU: the scan over neighbour slots
(contractions.promote_contract_18_fused, CCN2D(scan_promotion=True)) and
the vertex chunks (CCN2D(vertex_chunks=N), _chunked_layer).

Tolerances, none looser than the JAX package's own tests of the two
paths (tests/test_ccn.py): the scan's values atol 1e-5 and its gradient
in f atol 1e-4 / rtol 1e-5; whole models forward atol 1e-4 / rtol 1e-5
and parameter gradients atol 1e-4 (of mean(out^2), on the QM9-shaped
batch, as there). The scan runs on QM9-shaped molecules (K = 5) and on
complete graphs (K = 12), made from seeds with numpy. An output sums up
to n K^2 state entries, so the complete graphs' states are drawn at a
fifth of the QM9 batch's scale: both batches' outputs then reach about
29 in magnitude, where atol 1e-5 is a few float32 ulps (at unit scale
the complete graphs' reach 144, whose ulp is 1.5e-5). The scan's
gradient is that of sum(out * g) for a standard normal cotangent g: its
entries reach 57 and 286 on the two batches (those of sum(out^2) reach
2.9e4 on the complete graphs, where f32 sums of that size round by more
than 1e-4).

The saved-tensor test records what autograd keeps for the backward: the
scan path keeps no tensor of V K^3 or more elements and, all together,
fewer than V K^3 elements, where the materialized composition
contract_18(promote_2d(...)) keeps its (V, K, K, K) gather indices.
The crossover ladder (hgnn2_torch/scripts/ccn_crossover.py) runs at a
tiny size on the CPU."""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from hgnn2_tpu import graphs as jgraphs
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import ccn as jccn
from hgnn2_tpu.ops import contractions as jct

from hgnn2_torch import convert, graphs
from hgnn2_torch.data import qm9
from hgnn2_torch.nn import ccn
from hgnn2_torch.ops import ccn_fused
from hgnn2_torch.ops import contractions as ct

torch.set_num_threads(2)

VALUE_ATOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-5)


def _complete(sizes, seed, n_feat=3):
    """Complete graphs of the given sizes, n_feat random features a node."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        adj = np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)
        out.append((rng.standard_normal((n, n_feat)).astype(np.float32), adj,
                    np.float32(0.1)))
    return out


def _batches(name):
    """The same batch in both packages: (port CCNBatch, JAX CCNBatch)."""
    if name == "qm9":
        recs = qm9.synthetic_qm9_like(6, seed=9)
        jrecs = jqm9.synthetic_qm9_like(6, seed=9)
        kw = dict(task=0, vertex_capacity=128)
    else:  # complete graphs of 12, 9 and 12 nodes (K = 12), padded to 36
        raw = _complete((12, 9, 12), seed=4)
        recs = [graphs.GraphRecord(x=x, adj=a, y=y) for x, a, y in raw]
        jrecs = [jgraphs.GraphRecord(x=x, adj=a, y=y) for x, a, y in raw]
        kw = dict(vertex_capacity=36)
    return (ccn.make_ccn_batch(recs, device="cpu", **kw),
            jccn.make_ccn_batch(jrecs, **kw))


@pytest.fixture(scope="module", params=["qm9", "complete"])
def batches(request):
    return _batches(request.param)


def _state(cb, C, seed):
    """A (V, K, K, C) state, zero outside each vertex's receptive field;
    standard normal at K <= 5, a fifth of that above."""
    V, K = cb.nbr.shape
    f = np.random.default_rng(seed).standard_normal((V, K, K, C))
    f *= 1.0 if K <= 5 else 0.2
    m = cb.row_mask.numpy()
    return (f * (m[:, :, None] * m[:, None, :])[..., None]).astype(np.float32)


def _scan(cb, f, compat=False):
    return ct.promote_contract_18_fused(cb.chi_idx, cb.nbr, f, cb.deg,
                                        cb.row_mask, compat=compat)


def _jscan(jb, f, compat=False):
    return jct.promote_contract_18_fused(jb.chi_idx, jb.nbr, f, jb.deg,
                                         jb.row_mask, compat=compat)


def _cotangent(cb):
    V, K = cb.nbr.shape
    return np.random.default_rng(7).standard_normal((V, K, K, 54)).astype(
        np.float32)


@pytest.mark.parametrize("compat", [False, True])
def test_scan_matches_jax(batches, compat):
    """(a) promote_contract_18_fused against JAX's: the values, and the
    gradient in f of sum(out * g)."""
    cb, jb = batches
    f, g = _state(cb, 3, seed=0), _cotangent(cb)
    ft = torch.from_numpy(f).requires_grad_()
    got = _scan(cb, ft, compat)
    want = _jscan(jb, jnp.asarray(f), compat)
    assert got.shape == want.shape == (*cb.nbr.shape, cb.nbr.shape[1], 54)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=VALUE_ATOL)
    (got * torch.from_numpy(g)).sum().backward()
    g_want = jax.grad(lambda x: (_jscan(jb, x, compat) * g).sum())(
        jnp.asarray(f))
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(g_want), **GRAD_TOL)


@pytest.mark.parametrize("compat", [False, True])
def test_scan_matches_materialized(batches, compat):
    """(b) promote_contract_18_fused against the port's own
    contract_18(promote_2d(...)) with the gather-form promotion backward:
    the values, and the gradient in f of sum(out * g)."""
    cb, _ = batches
    f, g = _state(cb, 3, seed=1), torch.from_numpy(_cotangent(cb))
    fs = torch.from_numpy(f).requires_grad_()
    fm = torch.from_numpy(f).requires_grad_()
    got = _scan(cb, fs, compat)
    want = ct.contract_18(ct.promote_2d(cb.chi_idx, cb.nbr, fm, rslot=cb.rslot),
                          cb.deg, cb.row_mask, compat=compat)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=VALUE_ATOL)
    (got * g).sum().backward()
    (want * g).sum().backward()
    np.testing.assert_allclose(fs.grad.numpy(), fm.grad.numpy(), **GRAD_TOL)
    with torch.inference_mode():  # the eval path runs no checkpoint
        np.testing.assert_allclose(_scan(cb, fs.detach(), compat).numpy(),
                                   got.detach().numpy(), rtol=0, atol=0)


def _port(variables, n_features, **kw):
    model = ccn.CCN2D(n_features=n_features, hidden=2, n_layers=2, **kw)
    model.load_state_dict(convert.ccn_params_from_flax(
        jax.tree.map(np.asarray, variables)))
    return model


@pytest.mark.parametrize("strategy,compat", [
    ("scan_promotion", False), ("scan_promotion", True),
    ("vertex_chunks", False), ("vertex_chunks", True)])
def test_models_match_jax(strategy, compat):
    """(c) CCN2D(scan_promotion=True) and CCN2D(vertex_chunks=4) against
    the JAX models of the same flags on the QM9-shaped batch (V = 128),
    JAX's initial weights carried by hgnn2_torch.convert (the parameter
    names and shapes, w1, w2 and fc, are those of the default model): the
    forward and the gradient of every parameter of mean(out^2)."""
    cb, jb = _batches("qm9")
    flag = dict(scan_promotion=True) if strategy == "scan_promotion" else dict(
        vertex_chunks=4)
    jmodel = jccn.CCN2D(hidden=2, n_layers=2, compat_contractions=compat,
                        **flag)
    variables = jccn.CCN2D(hidden=2, n_layers=2).init(jax.random.key(3), jb,
                                                      train=True)
    want = np.asarray(jmodel.apply(variables, jb, train=True))
    jgrads = jax.grad(lambda p: (jmodel.apply({"params": p}, jb, train=True)
                                 ** 2).mean())(variables["params"])

    model = _port(variables, cb.x.shape[1], compat_contractions=compat,
                  **flag)
    out = model(cb)
    np.testing.assert_allclose(out.detach().numpy(), want, **MODEL_TOL)
    (out ** 2).mean().backward()
    want_g = convert.ccn_params_from_flax(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   atol=1e-4, err_msg=name)
    with torch.inference_mode():
        np.testing.assert_allclose(model(cb).numpy(), out.detach().numpy(),
                                   rtol=0, atol=0)


def test_chunks_not_dividing_the_vertices_raise_as_jax():
    """(c) a vertex count that the chunk count does not divide raises
    JAX's ValueError, with JAX's message."""
    cb, jb = _batches("complete")  # V = 36
    jmodel = jccn.CCN2D(hidden=2, n_layers=2, vertex_chunks=5)
    with pytest.raises(ValueError, match="vertex count 36 not divisible by 5") \
            as jerr:
        jmodel.init(jax.random.key(0), jb, train=True)
    model = ccn.CCN2D(n_features=3, vertex_chunks=5)
    with pytest.raises(ValueError) as err:
        model(cb)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("kernel,scan,chunks,expect", [
    (True, True, 4, "kernel"), (False, True, 4, "scan"),
    (False, False, 4, "chunks"), (False, False, 1, "materialized")])
def test_strategy_precedence_as_jax(monkeypatch, kernel, scan, chunks, expect):
    """The first that applies runs, as in the JAX package: the kernels
    (their plain versions on the CPU; K = 5), then the scan, then the
    vertex chunks, else the materialized path."""
    cb, _ = _batches("qm9")
    seen = []

    def spy(name, fn):
        def run(*args, **kw):
            seen.append(name)
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(ccn_fused, "promote_contract_18",
                        spy("kernel", ccn_fused.promote_contract_18))
    monkeypatch.setattr(ct, "promote_contract_18_fused",
                        spy("scan", ct.promote_contract_18_fused))
    monkeypatch.setattr(ccn.CCN2D, "_chunked_layer",
                        spy("chunks", ccn.CCN2D._chunked_layer))
    monkeypatch.setattr(ct, "contract_18", spy("materialized", ct.contract_18))
    model = ccn.CCN2D(n_features=cb.x.shape[1], kernel=kernel,
                      scan_promotion=scan, vertex_chunks=chunks)
    with torch.inference_mode():
        model(cb)
    # the chunks run contract_18 a slice each
    assert seen[0] == expect and set(seen) <= {expect, "materialized"}


def _saved(fn):
    """The tensors autograd saves while fn() runs: (numel, dtype) of each,
    and the elements of the distinct ones together."""
    seen, storages = [], {}

    def pack(t):
        seen.append((t.numel(), t.dtype))
        storages[(t.untyped_storage().data_ptr(), t.dtype)] = t.numel()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return seen, sum(storages.values())


def test_scan_saves_no_tensor_of_v_k_cubed():
    """(d) On complete graphs of 20 nodes (K = 20, V = 60, C = 1): the
    scan path saves no tensor of V K^3 or more elements and fewer than V
    K^3 elements all together, and keeps no slot's slice alive past its
    slot (K slots of saved (V, K, K) gather indices
    would be V K^3); the materialized composition saves its (V, K, K, K)
    indices, so the check can fail. The model's materialized path (with
    rslot) saves only the index tables; its V K^3 tensors are live at
    once instead, which chip_smoke.py's peak memory shows on the card."""
    raw = _complete((20, 20, 20), seed=5)
    cb = ccn.make_ccn_batch([graphs.GraphRecord(x=x, adj=a, y=y)
                             for x, a, y in raw], device="cpu")
    V, K = cb.nbr.shape
    assert (V, K) == (60, 20)
    f = torch.from_numpy(_state(cb, 1, seed=2)).requires_grad_()
    cube = V * K ** 3

    scan, scan_total = _saved(lambda: _scan(cb, f).sum().backward())
    assert scan and max(n for n, _ in scan) < cube
    assert scan_total < cube, (scan_total, cube)

    mat, _ = _saved(lambda: ct.contract_18(
        ct.promote_2d(cb.chi_idx, cb.nbr, f), cb.deg, cb.row_mask
    ).sum().backward())
    assert (cube, torch.int64) in mat

    # nor live at once: a slot's reductions own their storage, so its
    # (V, K, K, C) slice dies at the slot's end
    va = cb.chi_idx >= 0
    ia = torch.where(va, cb.chi_idx, 0).long()
    t_k, *reductions = ct._promote_slot(f.detach().reshape(V * K * K, 1),
                                        cb.nbr.long()[:, 3], ia[:, 3],
                                        va[:, 3], 3)
    assert t_k.shape == (V, K, K, 1)
    own = t_k.untyped_storage().data_ptr()
    assert all(r.untyped_storage().data_ptr() != own for r in reductions)

    # the whole model (1 input channel, hidden 1: a layer's z has 18 V K^2
    # < V K^3 elements)
    raw = _complete((20, 20, 20), seed=6, n_feat=1)
    cb1 = ccn.make_ccn_batch([graphs.GraphRecord(x=x, adj=a, y=y)
                              for x, a, y in raw], device="cpu")
    model = ccn.CCN2D(n_features=1, hidden=1, n_layers=2, scan_promotion=True)
    whole, _ = _saved(lambda: model(cb1).sum().backward())
    assert max(n for n, _ in whole) < cube


def test_crossover_ladder_on_the_cpu(tmp_path):
    """hgnn2_torch.scripts.ccn_crossover at a tiny size on the CPU: the
    JAX script's graphs (rng 7, 3 features, target 0.1), each path's row
    with the JAX script's fields, peak_bytes null off the card, and the
    error line a failed configuration records."""
    from hgnn2_torch.scripts import ccn_crossover

    rng = np.random.default_rng(7)
    for r in ccn_crossover.complete_graphs(6, 2):
        np.testing.assert_array_equal(
            r.x, rng.standard_normal((6, 3)).astype(np.float32))
        assert r.adj.sum() == 30 and float(r.y) == np.float32(0.1)

    rows = ccn_crossover.main(["--ks", "6", "--graphs", "2", "--device",
                               "cpu", "--out", str(tmp_path)])
    assert [r["mode"] for r in rows] == ["materialized", "scan"]
    for r in rows:
        assert "failed" not in r, r
        assert (r["K"], r["V"], r["n_graphs"]) == (6, 12, 2)
        assert r["materialized_T_bytes_fwd"] == 12 * 6 ** 3 * 8
        assert r["ms_per_step"] > 0 and r["peak_bytes"] is None
        assert r["device"] == "cpu"
    on_disk = json.loads((tmp_path / "results.json").read_text())
    assert on_disk["rows"] == rows

    stderr = ("Traceback (most recent call last):\n  File x\n"
              "torch.OutOfMemoryError: CUDA out of memory. Tried to "
              "allocate 34.00 GiB\n")
    err, tail = ccn_crossover.failure_evidence(stderr)
    assert err.startswith("torch.OutOfMemoryError: CUDA out of memory")
    assert tail.endswith("34.00 GiB")
