"""The checks that decide ``correct``, on the CPU: the control (the
reference in TF32) fails each cell's limits at the cell's own sizes, and a
run with the timed path broken underneath comes out not correct, once for
each fault a cell can have. A one-card cell has no exchange between cards
to leave out.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import control, run
from benchmark.drivers import train as train_driver

SEEDS = (2**31 + 101, 7, 3_000_000_019)
TRAIN = ("gnn_L15_h1.train_b1024", "ccn2d_L2_h2.train_b256")
SERVE = ("ccn2d_L2_h2.serve_open", "gnn_L15_h1.serve_open")
# smaller pools for the CPU; three batches or more of one shape remain
SMALL = {"gnn_L15_h1.train_b1024": {"config": {"train_molecules": 8192},
                                    "traffic": {"warm_seconds": 0.2}},
         "ccn2d_L2_h2.train_b256": {"config": {"train_molecules": 2048},
                                    "traffic": {"warm_seconds": 0.2}},
         "ccn2d_L2_h2.serve_open": {"traffic": {"rate_per_s": 20, "pool": 2048}},
         "gnn_L15_h1.serve_open": {"traffic": {"rate_per_s": 20, "pool": 2048}}}


def with_serve_cells(spec: dict) -> dict:
    """The spec with the serving cells that BENCHMARK.json leaves out
    (serve_cells.json, their entries as measured), so that the serving
    driver is tested as a cell would run it."""
    frag = json.loads((Path(__file__).parent / "serve_cells.json").read_text())
    return {**spec, **{k: spec[k] + frag[k] for k in frag}}


SPEC = with_serve_cells(run.benchmark_spec())


def _files(cell: str):
    c = run.find_cell(SPEC, cell)
    return (run.load_json("configs", f"{c['config']}.json"),
            run.load_json("traffic", f"{c['traffic']}.json"),
            run.load_json("limits", f"{cell}.json"))


def _fails(readings: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in readings.items() if k in limits)


def test_moved_leaves_leave_out_rounding():
    """Leaves under a thousandth of the median leaf's gradient go; where
    most leaves are dead and the median is 0, those under 1e-5 of the
    largest leaf's go too (a float32 gradient of rounding alone)."""
    live = {"a": 1.0, "b": 0.5, "c": 0.2, "d": 1e-4, "e": 0.3}
    assert train_driver.moved_leaves(live) == ["a", "b", "c", "e"]
    dead = {"a": 1.0, "b": 0.5, "c": 2e-7, "d": 0.0, "e": 0.0, "f": 0.0, "g": 0.0}
    assert train_driver.moved_leaves(dead) == ["a", "b"]


@pytest.mark.parametrize("cell", TRAIN)
def test_train_control_fails(cell):
    cfg, traffic, limits = _files(cell)
    for seed in SEEDS:
        r = control.train_readings(cfg, traffic, seed, torch.device("cpu"))
        assert _fails(r["control"], limits), (seed, r["control"], limits)
        assert _fails(r["half_batch"], limits), (seed, r["half_batch"], limits)


@pytest.mark.parametrize("cell", SERVE)
def test_serve_control_fails(cell):
    cfg, traffic, limits = _files(cell)
    for seed in SEEDS:
        r = control.serve_readings(cfg, {**traffic, "rate_per_s": 20}, seed, 5.0,
                                   torch.device("cpu"))
        assert _fails(r["control"], limits), (seed, r["control"], limits)


def _run(cell: str) -> dict:
    return run.run_cell(cell, SEEDS[0], 0.3, False, "cpu",
                        overrides=SMALL[cell], t_start=time.perf_counter(),
                        spec=SPEC)


@pytest.mark.parametrize("cell", TRAIN)
def test_train_faults_come_out_not_correct(cell, monkeypatch):
    from hgnn2_torch.training import train

    assert _run(cell)["correct"]  # the sound run

    # a step that returns its state unchanged
    r = control.unchanged_readings(cell, SEEDS[0], "cpu", SPEC, SMALL[cell])
    _, _, limits = _files(cell)
    assert _fails(r, limits), (r, limits)

    graph_mask = train._graph_mask

    def half(batch):  # half the batch left out, the mean over the rest
        g = graph_mask(batch).clone()
        real = int((g > 0).sum())
        g[real // 2:] = 0.0
        return g

    with monkeypatch.context() as m:
        m.setattr(train, "_graph_mask", half)
        assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", SERVE)
def test_serve_faults_come_out_not_correct(cell, monkeypatch):
    from hgnn2_torch import serving

    assert _run(cell)["correct"]  # the sound run
    produce = serving.ServingModel._run

    def altered(self, records, spec, program):  # one answer altered
        pred = produce(self, records, spec, program)
        pred[0] *= np.float32(1.01)
        return pred

    with monkeypatch.context() as m:
        m.setattr(serving.ServingModel, "_run", altered)
        assert not _run(cell)["correct"]

    calls = [0]

    def lost(self, records):  # an answer that never comes
        calls[0] += 1
        if calls[0] == 12:  # past the warm-up's calls
            raise RuntimeError("lost")
        return predict(self, records)

    predict = serving.ServingModel.predict
    with monkeypatch.context() as m:
        m.setattr(serving.ServingModel, "predict", lost)
        r = _run(cell)
        assert r["failed"] == 1 and not r["correct"]
