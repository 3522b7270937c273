"""Dense and packed serving bundles of the port against the JAX package's
on the CPU: bundles of the same weights (JAX's init with its BN running
stats after one train-mode step, carried over by hgnn2_torch.convert)
against JAX bundles exported with platforms=("cpu",); bucket routing
across several buckets, call for call, for dense, packed and CCN
bundles; call(arrays); the meta that rebuilds each model; and the
refusal of oversized records and of mismatched specs.

Predictions agree within 1e-5 x max |pred| before denormalization: the
packed models' segment sums and the dense matmuls add in another order
than XLA's."""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import torch

from hgnn2_tpu import graphs as jgraphs
from hgnn2_tpu import serving as jserving
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import ccn as jccn
from hgnn2_tpu.nn import models as jmodels
from hgnn2_tpu.nn import packed as jpacked
from hgnn2_tpu.nn.layers import CompatConfig as JCompatConfig

from hgnn2_torch import convert, graphs, serving
from hgnn2_torch.data import qm9
from hgnn2_torch.nn import ccn, models, packed
from hgnn2_torch.nn.layers import CompatConfig

torch.set_num_threads(2)

PRED_RTOL = 1e-5  # times max |pred|, before denormalization
MEAN, STD = 2.5, 1.5
PACKED_CAPS = {4: (80, 160), 8: (160, 320), 16: (320, 640)}


@pytest.fixture(scope="module")
def records():
    return qm9.synthetic_qm9_like(21, seed=0)


@pytest.fixture(scope="module")
def jrecords():
    return jqm9.synthetic_qm9_like(21, seed=0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(layout, arch, recs, jrecs, slots, n_max=32, m_max=None,
             caps=PACKED_CAPS):
    """The example batch of each bucket in both packages."""
    m_max = m_max or max(r.n_dir_edges for r in recs)
    out = []
    for mod, rs, kw in ((graphs, recs, {"device": "cpu"}), (jgraphs, jrecs, {})):
        if layout == "dense":
            out.append([mod.make_dense_batch(
                rs[:b], n_max=n_max, m_max=m_max if arch == "lggnn" else None,
                batch_size=b, with_line_graph=arch == "lggnn", task=0, **kw)
                for b in slots])
        elif layout == "packed":
            out.append([mod.make_packed_batch(
                rs[:b], node_capacity=caps[b][0], edge_capacity=caps[b][1],
                batch_size=b, task=0, **kw)
                for b in slots])
        else:
            cm = ccn if mod is graphs else jccn
            k_all = max(r.max_degree() for r in rs) + 1
            out.append([cm.make_ccn_batch(
                rs[:b], k_max=k_all,
                vertex_capacity=sum(r.n_nodes for r in rs[:b]) + 8,
                task=0, batch_size=b, **kw) for b in slots])
    return out


def _models(layout, arch, jbatch, seed, compat=False, **kw):
    """A JAX model with its variables (BN running stats after one
    train-mode step), and the port's model of the same weights."""
    jc = JCompatConfig.reference() if compat else JCompatConfig()
    c = CompatConfig.reference() if compat else CompatConfig()
    if layout == "ccn":
        jm = jccn.CCN1D(hidden=2, n_layers=2)
        m = ccn.CCN1D(n_features=5, hidden=2, n_layers=2)
    elif layout == "packed":
        jcls, cls = ((jpacked.PackedLGGNN, packed.PackedLGGNN) if arch == "lggnn"
                     else (jpacked.PackedGNN, packed.PackedGNN))
        jm = jcls(n_features=2, n_layers=3, J=1, compat=jc, **kw)
        m = cls(n_features=2, n_layers=3, in_features=5, J=1, compat=c, **kw)
    else:
        jcls, cls = ((jmodels.GNNLineGraph, models.GNNLineGraph) if arch == "lggnn"
                     else (jmodels.GNNSimple, models.GNNSimple))
        kw = dict({"J": 1}, **kw)
        jm = jcls(n_features=2, n_layers=3, compat=jc, **kw)
        m = cls(in_features=5, n_features=2, n_layers=3, compat=c, **kw)
    variables = jm.init(jax.random.key(seed), jbatch, train=False)
    if "batch_stats" in variables:
        _, upd = jm.apply(variables, jbatch, train=True, mutable=["batch_stats"])
        variables = dict(variables, batch_stats=upd["batch_stats"])
    variables = _np(variables)
    if layout == "ccn":
        m.load_state_dict(convert.ccn_params_from_flax(variables))
    else:
        m.load_state_dict(convert.dense_variables_from_flax(variables))
    return jm, variables, m.eval()


def _bundles(tmp_path, layout, arch, recs, jrecs, slots, seed=0, **kw):
    """The same weights saved as a JAX bundle and as the port's, buckets
    in ``slots`` order. Returns (port ServingModel, JAX ServingModel,
    port model, port example batches, JAX example batches)."""
    tb, jb = _batches(layout, arch, recs, jrecs, slots, **kw)
    jm, variables, m = _models(layout, arch, jb[0], seed)
    kind = {"ccn": "ccn", "packed": "packed"}.get(layout, "dense")
    exps = [jserving.export_model(jm, variables, b, platforms=("cpu",))
            for b in jb]
    jserving.save_bundle(str(tmp_path / "jax"), exps if len(exps) > 1 else exps[0],
                         kind=kind, task=0, mean=MEAN, std=STD)
    serving.save_bundle(str(tmp_path / "torch"), m, tb, task=0, mean=MEAN,
                        std=STD)
    return (serving.load_bundle(str(tmp_path / "torch"), device="cpu"),
            jserving.load_bundle(str(tmp_path / "jax")), m, tb, jb)


def _assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= PRED_RTOL * np.abs(want).max()


CASES = [("dense", "gnn"), ("dense", "lggnn"), ("packed", "gnn"),
         ("packed", "lggnn")]


@pytest.mark.parametrize("layout,arch", CASES)
def test_bundle_predictions_match_jax(tmp_path, records, jrecords, layout, arch):
    """21 requests through one bucket of 8 (dense) or 4 (packed) slots:
    two or more full chunks and a padded tail."""
    sm, jsm, *_ = _bundles(tmp_path, layout, arch, records, jrecords,
                           [8] if layout == "dense" else [4])
    assert sm.kind == jsm.kind and sm.input_spec == jsm.input_spec
    got, want = sm.predict(records), jsm.predict(jrecords)
    assert got.dtype == np.float32 and got.shape == (21,)
    _assert_close((got - MEAN) / STD, (want - MEAN) / STD)
    assert sm.predict([]).shape == (0,)


def _count_calls(sm, key):
    """Wraps each bucket program with a call counter keyed by slot count
    (the JAX package's own routing test does this)."""
    counts = {}

    def wrap(spec, program):
        k = key(spec)

        def call(arrays, _p=program, _k=k):
            counts[_k] = counts.get(_k, 0) + 1
            return _p(arrays)

        return spec, call

    sm._programs = [wrap(*p) for p in sm._programs]
    return counts


@pytest.mark.parametrize("layout,slots", [("dense", [4, 16]),
                                          ("packed", [16, 4]),
                                          ("ccn", [4, 16]),
                                          ("dense", [4, 8, 16])])
def test_routing_matches_jax(tmp_path, records, jrecords, layout, slots):
    """Requests of several sizes through bundles of several buckets: each
    bucket is called as often in the port as in JAX, and predictions
    agree."""
    arch = "lggnn" if layout == "packed" else "gnn"
    sm, jsm, *_ = _bundles(tmp_path, layout, arch, records, jrecords, slots)
    assert [s for s, _ in sm.buckets] == sorted(slots, reverse=True)
    counts = _count_calls(sm, serving._slots)
    jcounts = _count_calls(jsm, jserving.ServingModel._slots)
    for n in (21, 3, 18, 16, 5, 1):
        counts.clear()
        jcounts.clear()
        got, want = sm.predict(records[:n]), jsm.predict(jrecords[:n])
        assert counts == jcounts, (n, counts, jcounts)
        _assert_close((got - MEAN) / STD, (want - MEAN) / STD)


@pytest.mark.parametrize("layout,arch", CASES + [("ccn", "ccn1d")])
def test_call_matches_model_and_jax(tmp_path, records, jrecords, layout, arch):
    """call(arrays) on each bucket's batch: labels dropped, numpy or
    tensors, routed by x's shape; equal to the model's eval forward and
    close to JAX's call."""
    slots = [4, 8]
    sm, jsm, m, tb, jb = _bundles(tmp_path, layout, arch, records, jrecords,
                                  slots)
    for b, jbatch in zip(tb, jb):
        with torch.inference_mode():
            want = m(b)
        got = sm.call(serving.batch_to_arrays(b))
        assert torch.equal(got, want)
        unlabeled = {k: v.numpy() for k, v in serving.batch_to_arrays(
            b, exclude=serving.EXPORT_EXCLUDE).items()}
        assert torch.equal(sm.call(unlabeled), want)
        _assert_close(got, jsm.call(jserving.batch_to_arrays(jbatch)))
    spec = serving.input_spec(tb[0])
    assert "y" not in spec and spec == jsm.input_spec
    assert sm.meta["static"][0]["y"] == [list(tb[0].y.shape), "float32"]


def test_call_refuses_arrays_of_no_bucket(tmp_path, records, jrecords):
    sm, _, _, tb, _ = _bundles(tmp_path, "packed", "gnn", records, jrecords,
                               [4, 8])
    arrays = serving.batch_to_arrays(tb[0])
    with pytest.raises(ValueError, match="fits no serving bucket"):
        sm.call(dict(arrays, x=arrays["x"][:-1]))
    with pytest.raises(ValueError, match="missing"):
        sm.call({k: v for k, v in arrays.items() if k != "src"})
    with pytest.raises(ValueError, match="'src' is int64"):
        sm.call(dict(arrays, src=arrays["src"].long()))
    with pytest.raises(ValueError, match="'w' is float32"):
        sm.call(dict(arrays, w=arrays["w"][:-1]))


def _raises_like_jax(call, jcall, match):
    with pytest.raises(ValueError, match=match) as mine:
        call()
    with pytest.raises(ValueError) as theirs:
        jcall()
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("case", ["nodes", "edges", "packed"])
def test_predict_refuses_oversized_records_as_jax(tmp_path, records, jrecords,
                                                  case):
    """A record beyond the bucket's n_max, m_max or packed capacities
    raises JAX's message."""
    if case == "packed":
        small = sorted(range(21), key=lambda i: records[i].n_dir_edges)[:2]
        cap = sum(records[i].n_dir_edges for i in small) + 2
        recs = [records[i] for i in small] + list(records)
        jrecs = [jrecords[i] for i in small] + list(jrecords)
        sm, jsm, *_ = _bundles(tmp_path, "packed", "gnn", recs, jrecs, [2],
                               caps={2: (48, cap)})
        match = "packed capacities"
    elif case == "nodes":
        small = [i for i in range(21) if records[i].n_nodes <= 16]
        recs = [records[i] for i in small] + list(records)
        jrecs = [jrecords[i] for i in small] + list(jrecords)
        sm, jsm, *_ = _bundles(tmp_path, "dense", "gnn", recs, jrecs, [4],
                               n_max=16)
        match = "serving bucket"
    else:  # m_max of the 4 records with the fewest edges
        order = sorted(range(21), key=lambda i: records[i].n_dir_edges)
        recs = [records[i] for i in order]
        jrecs = [jrecords[i] for i in order]
        m_max = recs[3].n_dir_edges
        assert recs[-1].n_dir_edges > m_max
        sm, jsm, *_ = _bundles(tmp_path, "dense", "lggnn", recs, jrecs, [4],
                               m_max=m_max)
        match = "directed edges"
    _raises_like_jax(lambda: sm.predict(recs), lambda: jsm.predict(jrecs), match)


def test_save_refuses_mismatched_specs(tmp_path, records, jrecords):
    """Several buckets share one signature, and differ only in each
    input's leading dim (JAX's check); a bucket's batch must be of the
    model's layout."""
    small = [r for r in records if r.n_nodes <= 16]
    m = models.GNNSimple(in_features=5, n_features=2, n_layers=3)
    b32 = graphs.make_dense_batch(records[:4], n_max=32, batch_size=4,
                                  task=0, device="cpu")
    b16 = graphs.make_dense_batch(small[:8], n_max=16, batch_size=8, task=0,
                                  device="cpu")
    lg = graphs.make_dense_batch(records[:4], n_max=32, batch_size=8, task=0,
                                 with_line_graph=True, device="cpu")
    with pytest.raises(ValueError, match="capacity dim"):
        serving.save_bundle(str(tmp_path / "a"), m, [b32, b16])
    with pytest.raises(ValueError, match="one input signature"):
        serving.save_bundle(str(tmp_path / "b"), m, [b32, lg])
    pb = graphs.make_packed_batch(records[:4], device="cpu")
    with pytest.raises(TypeError, match="DenseGraphBatch"):
        serving.save_bundle(str(tmp_path / "c"), m, [pb])
    with pytest.raises(ValueError, match="CCN models"):
        serving.save_bundle(str(tmp_path / "d"), m, [(4, 64)], k_max=5)
    bf16 = models.GNNSimple(in_features=5, n_features=2, n_layers=3,
                            dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32 model"):
        serving.save_bundle(str(tmp_path / "e"), bf16, [b32])
    assert not (tmp_path / "a").exists()


@pytest.mark.parametrize("arch,kw", [
    ("gnn", dict(J=2, gru=True)), ("lggnn", dict(J=2, order=3)),
    ("packed_lggnn", dict(J=2, order=1))])
def test_meta_rebuilds_the_model(tmp_path, records, arch, kw):
    """The meta carries what rebuilds the model (reference compat flags
    included); the loaded bundle computes what the saved model does. A
    line-graph meta written with a fused_ops entry (bundles exported while
    GNNLineGraph had that option) loads and predicts the same."""
    gen = torch.Generator().manual_seed(3)
    c = CompatConfig.reference()
    if arch == "packed_lggnn":
        m = packed.PackedLGGNN(n_features=2, n_layers=3, in_features=5,
                               compat=c, generator=gen, **kw)
        b = graphs.make_packed_batch(records[:6], batch_size=8, task=0,
                                     device="cpu")
    else:
        cls = models.GNNLineGraph if arch == "lggnn" else models.GNNSimple
        m = cls(in_features=5, n_features=2, n_layers=3, compat=c,
                generator=gen, **kw)
        b = graphs.make_dense_batch(records[:6], batch_size=8, task=0,
                                    with_line_graph=arch == "lggnn",
                                    device="cpu")
    with torch.no_grad():  # BN running stats off their init
        m.train()(b)
    m.eval()
    serving.save_bundle(str(tmp_path / "b"), m, [b], task=0,
                        extra={"epoch": 7})
    meta = json.loads((tmp_path / "b" / "meta.json").read_text())
    for key in ("arch", "in_features", "n_features", "n_layers", "J", "order",
                "gru", "compat_reference", "dim_output", "static"):
        assert key in meta, key
    assert meta["compat_reference"] and meta["epoch"] == 7
    assert meta["J"] == 2 and meta["in_features"] == 5
    if arch == "lggnn":
        meta["fused_ops"] = True
        (tmp_path / "b" / "meta.json").write_text(json.dumps(meta))
    sm = serving.load_bundle(str(tmp_path / "b"), device="cpu")
    assert type(sm.model) is type(m)
    assert sm.model.compat == c and sm.model.J == 2
    for k in ("order", "gru"):
        if k in kw:
            assert getattr(sm.model, k) == kw[k], k
    with torch.inference_mode():
        want = m(b)
    assert torch.equal(sm.call(serving.batch_to_arrays(b)), want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serving.load_bundle(str(tmp_path / "b"))
