"""hgnn2_torch/scripts/bench_serving.py against scripts/bench_serving.py
on the CPU: JAX's build_bundles (its weights recorded as it exports
them) and the port's build_bundles from the same weights, held request
for request at 1, 64 and 300 records (predictions within 1e-5 x max
|pred| before denormalization; the dense matmuls and the packed and CCN
segment sums add in another order than XLA's), each bucket called as
often in the port as in JAX, and JAX's keys in bench_requests' rows and
in main's results.json. JAX's script is imported from scripts/ with
importlib, runtime.setup stubbed out, its main never run."""

import importlib.util
import json
import os
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")

import jax

from hgnn2_tpu import runtime as jruntime
from hgnn2_tpu import serving as jserving
from hgnn2_tpu.data import qm9 as jqm9

from hgnn2_torch import serving
from hgnn2_torch.data import qm9
from hgnn2_torch.scripts import bench_serving

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRED_RTOL = 1e-5  # times max |pred|, before denormalization
MEAN, STD = 1.0, 2.0  # the scripts' bundles
N = 320


def jax_script(name: str):
    """scripts/<name>.py as a module, without its runtime.setup()."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(jruntime, "setup", lambda *a, **k: None):
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """(the port's ServingModels, JAX's, the records of each) from the
    same weights: JAX's init, recorded while its build_bundles exports
    each model."""
    jbs = jax_script("bench_serving")
    recs, jrecs = qm9.synthetic_qm9_like(N, seed=0), jqm9.synthetic_qm9_like(N, seed=0)
    seen = []
    export = jserving.export_model

    def spy(model, variables, sample, *a, **k):
        seen.append(jax.tree.map(np.asarray, variables))
        return export(model, variables, sample, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jserving, "export_model", spy)
        jpaths = jbs.build_bundles(jrecs, str(tmp_path_factory.mktemp("jax")))
    # one export a bucket: dense, packed, ccn in turn
    init = {"dense": seen[0], "packed": seen[3], "ccn": seen[6]}
    paths = bench_serving.build_bundles(
        recs, str(tmp_path_factory.mktemp("torch")), init_params=init)
    assert list(paths) == list(jpaths)
    mine = {k: serving.load_bundle(p, device="cpu") for k, p in paths.items()}
    theirs = {k: jserving.load_bundle(p) for k, p in jpaths.items()}
    return mine, theirs, recs, jrecs, jbs


def _count_calls(sm, key):
    """Wraps each bucket program with a call counter keyed by slot count."""
    counts = {}

    def wrap(spec, program):
        k = key(spec)

        def call(arrays, _p=program, _k=k):
            counts[_k] = counts.get(_k, 0) + 1
            return _p(arrays)

        return spec, call

    sm._programs = [wrap(*p) for p in sm._programs]
    return counts


@pytest.mark.parametrize("name", ["dense_gnn_L15", "dense_gnn_L15_single256",
                                  "packed_lggnn_L5", "ccn2d_L2"])
def test_bundles_match_jax_request_for_request(bundles, name):
    """Requests of 1, 64 and 300 records (from several offsets): the same
    buckets, each called as often as in JAX, and JAX's predictions."""
    mine, theirs, recs, jrecs, _ = bundles
    sm, jsm = mine[name], theirs[name]
    assert sm.kind == jsm.kind and sm.input_spec == jsm.input_spec
    assert [s for s, _ in sm.buckets] == [
        jserving.ServingModel._slots(spec) for spec, _ in jsm._programs]
    counts = _count_calls(sm, serving._slots)
    jcounts = _count_calls(jsm, jserving.ServingModel._slots)
    for size, lo in ((1, 0), (64, 5), (300, 17)):
        counts.clear()
        jcounts.clear()
        got = sm.predict(recs[lo:lo + size])
        want = jsm.predict(jrecs[lo:lo + size])
        assert counts == jcounts, (size, counts, jcounts)
        got, want = (got - MEAN) / STD, (np.asarray(want) - MEAN) / STD
        assert got.shape == want.shape == (size,)
        assert np.abs(got - want).max() <= PRED_RTOL * np.abs(want).max()


def test_bench_requests_rows_have_jaxs_keys(bundles):
    mine, theirs, recs, jrecs, jbs = bundles
    row = bench_serving.bench_requests(mine["ccn2d_L2"], recs, 64, 3)
    jrow = jbs.bench_requests(theirs["ccn2d_L2"], jrecs, 64, 3)
    assert list(row) == list(jrow)
    assert row["request_records"] == 64 and row["repeats"] == 3
    assert row["latency_ms_p50"] <= row["latency_ms_p99"]
    assert row["throughput_molecules_per_s"] > 0


def test_main_writes_jaxs_results(tmp_path, monkeypatch, capsys):
    """main at 200 records and request sizes 1 and 64 on the CPU:
    results.json with JAX's keys, a row a size, the four bundles, and the
    kernels' launches on a line before the last (none on the CPU)."""
    monkeypatch.setattr(bench_serving, "N_RECORDS", 200)
    monkeypatch.setattr(bench_serving, "SIZES", (1, 64))
    results = bench_serving.main(["--repeats", "2", "--device", "cpu",
                                  "--out", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-2]) == {"launches": dict.fromkeys(
        ("K1", "K2", "K3", "K4"), 0)}
    assert json.loads(lines[-1]) == {k: v[-1] for k, v in
                                     results["bundles"].items()}
    with open(os.path.join(ROOT, "runs", "bench_serving", "results.json")) as f:
        want = json.load(f)
    with open(tmp_path / "results.json") as f:
        assert json.load(f) == results
    assert list(results) == list(want)
    assert list(results["bundles"]) == list(want["bundles"])
    assert results["device"] == "cpu" and results["rtt_floor_ms"] > 0
    for rows in results["bundles"].values():
        assert [list(r) for r in rows] == [list(want["bundles"]["ccn2d_L2"][0])] * 2
        assert [r["request_records"] for r in rows] == [1, 64]
