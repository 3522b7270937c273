"""hgnn2_torch/scripts/packed_crossover.py against
scripts/packed_crossover.py on the CPU: run_config's scan groups for
GNN and LGGNN, dense and packed, with and without uniform_caps (JAX's
init and epochs stubbed out: its groups are built from the loader
alone); JAX's
row and findings.json keys (the committed runs/packed_crossover/
findings.json fixes them); and the epochs' losses of run_config from
JAX's init, for LGGNN dense and GNN packed, within 1e-4 relative (the
packed segment sums and BN statistics add in another order than XLA's).
JAX's script is imported from scripts/ with importlib, runtime.setup
stubbed out, its main never run."""

import importlib.util
import json
import os
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import torch

from hgnn2_tpu import runtime as jruntime
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.data import stats as jstats
from hgnn2_tpu.training import train as jtrain

from hgnn2_torch.data import qm9, stats
from hgnn2_torch.scripts import packed_crossover
from hgnn2_torch.training import train

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BS = 48, 16  # three batches, several node and edge buckets
LOSS_RTOL = 1e-4


def jax_script(name: str):
    """scripts/<name>.py as a module, without its runtime.setup()."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(jruntime, "setup", lambda *a, **k: None):
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data():
    recs, jrecs = qm9.synthetic_qm9_like(N, seed=0), jqm9.synthetic_qm9_like(N, seed=0)
    return (recs, stats.compute_target_stats(recs), jrecs,
            jstats.compute_target_stats(jrecs), jax_script("packed_crossover"))


def _committed() -> dict:
    with open(os.path.join(ROOT, "runs", "packed_crossover", "findings.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("family,layout,uniform", [
    ("gnn", "dense", True), ("gnn", "packed", True), ("gnn", "packed", False),
    ("lggnn", "dense", True), ("lggnn", "packed", True),
    ("lggnn", "packed", False)])
def test_scan_bucket_groups_match_jax(data, family, layout, uniform):
    recs, ts, jrecs, jts, jpc = data
    row = packed_crossover.run_config(recs, ts, family, 2, layout, BS, 1,
                                      uniform_caps=uniform, device="cpu")
    with mock.patch.object(jtrain.TrainState, "create", lambda *a, **k: None), \
            mock.patch.object(jtrain, "run_epoch_scanned",
                              lambda state, *a: (state, {"loss": 0.0})):
        jrow = jpc.run_config(jrecs, jts, family, 2, layout, BS, 1,
                              uniform_caps=uniform)
    assert row["scan_bucket_groups"] == jrow["scan_bucket_groups"]
    if layout == "packed" and uniform:
        assert row["scan_bucket_groups"] == 1
    assert list(row) == list(jrow)
    want = _committed()["rows"][0 if layout == "dense" else 1]
    assert list(row) == list(want)
    assert np.isfinite(row["loss"]) and len(row["epoch_s_all"]) == 1


def test_uniform_caps_consolidate_the_groups(data):
    recs, ts, *_ = data
    ladder = packed_crossover.run_config(recs, ts, "gnn", 1, "packed", BS, 1,
                                         uniform_caps=False, device="cpu")
    assert ladder["scan_bucket_groups"] > 1 and not ladder["uniform_caps"]


@pytest.mark.parametrize("family,layout", [("lggnn", "dense"),
                                           ("gnn", "packed")])
def test_epoch_losses_match_jax(data, family, layout):
    """run_config's two epochs (the capture epoch and one measured) from
    JAX's init, in JAX's order (default_rng(0)), give JAX's losses."""
    recs, ts, jrecs, jts, jpc = data
    states, jlosses, losses = [], [], []
    create, jrun, run = (jtrain.TrainState.create, jtrain.run_epoch_scanned,
                         train.run_epoch_scanned)

    def spy_create(*a, **k):
        states.append(create(*a, **k))
        return states[-1]

    def spy_jrun(*a, **k):
        state, mets = jrun(*a, **k)
        jlosses.append(float(mets["loss"]))
        return state, mets

    def spy_run(*a, **k):
        mets = run(*a, **k)
        losses.append(mets["loss"])
        return mets

    with mock.patch.object(jtrain.TrainState, "create", spy_create), \
            mock.patch.object(jtrain, "run_epoch_scanned", spy_jrun):
        jrow = jpc.run_config(jrecs, jts, family, 2, layout, BS, 1)
    init = jax.tree.map(np.asarray, {"params": states[0].params,
                                     "batch_stats": states[0].batch_stats})
    with mock.patch.object(train, "run_epoch_scanned", spy_run):
        row = packed_crossover.run_config(recs, ts, family, 2, layout, BS, 1,
                                          device="cpu", init_params=init)
    assert len(losses) == len(jlosses) == 2
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert row["scan_bucket_groups"] == jrow["scan_bucket_groups"]


def test_main_writes_jaxs_findings(tmp_path, monkeypatch):
    """main at one width on the CPU: JAX's keys, the card, 2 families x 2
    layouts and the uniform_caps=False row."""
    monkeypatch.setattr(packed_crossover, "HS", (1,))
    out = packed_crossover.main(["--molecules", str(N), "--bs", str(BS),
                                 "--epochs", "1", "--device", "cpu",
                                 "--out", str(tmp_path)])
    with open(tmp_path / "findings.json") as f:
        assert json.load(f) == out
    want = _committed()
    assert set(out) == set(want) | {"card"} and out["card"] == "cpu"
    assert set(out["config"]) == set(want["config"])
    assert [(r["family"], r["layout"], r.get("uniform_caps")) for r in out["rows"]] == [
        ("gnn", "dense", None), ("gnn", "packed", True),
        ("lggnn", "dense", None), ("lggnn", "packed", True),
        ("gnn", "packed", False)]
