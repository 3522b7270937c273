"""The port's CCN serving bundles on the CPU: save, load, chunk requests
across buckets, denormalize; and the greedy span packer against the JAX
package's."""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

import torch

from hgnn2_tpu import serving as jserving

from hgnn2_torch import serving
from hgnn2_torch.data import qm9
from hgnn2_torch.nn import ccn

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def records():
    return qm9.synthetic_qm9_like(18, seed=0)


@pytest.mark.parametrize("seed", range(4))
def test_greedy_spans_match_jax(seed):
    rng = np.random.default_rng(seed)
    n, k = int(rng.integers(1, 60)), int(rng.integers(1, 3))
    sizes = rng.integers(1, 30, size=(n, k))
    caps = rng.integers(30, 120, size=k)
    bsz = int(rng.integers(1, 12))
    mine = list(serving._greedy_spans(sizes, caps, bsz))
    assert mine == list(jserving._greedy_spans(sizes, caps, bsz))
    assert mine[0][0] == 0 and mine[-1][1] == n


@pytest.mark.parametrize("arch", ["ccn1d", "ccn2d"])
def test_bundle_roundtrip_chunks_across_buckets(tmp_path, records, arch):
    """18 records against buckets of 8 and 2 slots: two full 8-slot chunks,
    then a 2-record tail routed to the small bucket. Per-graph readouts are
    independent, so a one-record batch is the oracle for each prediction."""
    mean, std = 2.0, 3.0
    k_max = max(r.max_degree() + 1 for r in records)
    gen = torch.Generator().manual_seed(0)
    if arch == "ccn1d":
        model = ccn.CCN1D(n_features=5, hidden=3, n_layers=2, generator=gen)
    else:
        model = ccn.CCN2D(n_features=5, hidden=2, n_layers=2,
                          compat_contractions=True, generator=gen)
    model.eval()
    buckets = [(8, 256), (2, 64)]
    serving.save_bundle(str(tmp_path / "b"), model, buckets, k_max=k_max,
                        task=0, mean=mean, std=std)
    meta = json.loads((tmp_path / "b" / "meta.json").read_text())
    for key in ("kind", "arch", "task", "mean", "std", "input_spec",
                "add_self_loops", "n_layers", "hidden", "compat_contractions"):
        assert key in meta, key
    assert meta["input_spec"]["x"][0] == [256, 5]
    assert meta["extra_buckets"][0]["gmask"][0] == [2]

    sm = serving.load_bundle(str(tmp_path / "b"), device="cpu")
    assert sm.kind == "ccn" and sm.buckets == [(8, 256), (2, 64)]
    assert not sm.model.kernel
    spans = list(serving._greedy_spans(
        np.array([[r.n_nodes] for r in records]), (256,), 8))
    assert [hi - lo for lo, hi in spans] == [8, 8, 2]
    assert sum(r.n_nodes for r in records[16:]) <= 64

    preds = sm.predict(records)
    assert preds.shape == (len(records),) and np.isfinite(preds).all()
    with torch.inference_mode():
        for i, r in enumerate(records):
            b = ccn.make_ccn_batch([r], k_max=k_max, vertex_capacity=64,
                                   task=0, batch_size=2, device="cpu")
            o = float(model(b)[0, 0])
            np.testing.assert_allclose(preds[i], o * std + mean, rtol=1e-5,
                                       atol=1e-6)


def test_predict_rejects_oversized_records(tmp_path, records):
    model = ccn.CCN1D(n_features=5, hidden=2, n_layers=1)
    serving.save_bundle(str(tmp_path / "b"), model, [(4, 16)], k_max=3)
    sm = serving.load_bundle(str(tmp_path / "b"), device="cpu")
    with pytest.raises(ValueError, match="exceeds the bundle's K=3"):
        sm.predict(records)
    serving.save_bundle(str(tmp_path / "c"), model, [(4, 16)], k_max=8)
    sm = serving.load_bundle(str(tmp_path / "c"), device="cpu")
    big = [r for r in records if r.n_nodes > 16]
    with pytest.raises(ValueError, match="vertex capacity 16"):
        sm.predict(big)
    assert sm.predict([]).shape == (0,)


def test_save_rejects_non_monotone_buckets(tmp_path):
    model = ccn.CCN1D(n_features=5, hidden=2, n_layers=1)
    with pytest.raises(ValueError, match="not monotone"):
        serving.save_bundle(str(tmp_path / "b"), model, [(8, 64), (2, 128)],
                            k_max=5)


def test_load_defaults_to_cuda(tmp_path):
    model = ccn.CCN1D(n_features=5, hidden=2, n_layers=1)
    serving.save_bundle(str(tmp_path / "b"), model, [(4, 64)], k_max=5)
    if torch.cuda.is_available():
        assert serving.load_bundle(str(tmp_path / "b")).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            serving.load_bundle(str(tmp_path / "b"))


def test_bundle_keeps_vertex_chunks(tmp_path, records):
    """A CCN2D(vertex_chunks=4) bundle loads with its chunks (the JAX
    package's export freezes the chunked program) and predicts what the
    unchunked model of the same weights predicts; a bundle whose meta
    names no chunks (written before CCN2D had them) loads with 1."""
    gen = torch.Generator().manual_seed(1)
    chunked = ccn.CCN2D(n_features=5, hidden=2, n_layers=2, vertex_chunks=4,
                        generator=gen).eval()
    whole = ccn.CCN2D(n_features=5, hidden=2, n_layers=2).eval()
    whole.load_state_dict(chunked.state_dict())
    k_max = max(r.max_degree() + 1 for r in records)
    preds = {}
    for name, model in (("chunked", chunked), ("whole", whole)):
        serving.save_bundle(str(tmp_path / name), model, [(8, 256), (2, 64)],
                            k_max=k_max, task=0, mean=2.0, std=3.0)
        sm = serving.load_bundle(str(tmp_path / name), device="cpu")
        assert sm.model.vertex_chunks == model.vertex_chunks
        preds[name] = sm.predict(records)
    np.testing.assert_allclose(preds["chunked"], preds["whole"], rtol=1e-6,
                               atol=1e-6)

    meta_path = tmp_path / "chunked" / "meta.json"
    meta = json.loads(meta_path.read_text())
    assert meta["vertex_chunks"] == 4
    del meta["vertex_chunks"]
    meta_path.write_text(json.dumps(meta))
    assert serving.load_bundle(str(tmp_path / "chunked"),
                               device="cpu").model.vertex_chunks == 1
