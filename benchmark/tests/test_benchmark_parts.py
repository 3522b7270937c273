"""CPU tests of the benchmark's pieces: the traffic generator, the frozen
copies, the work counts, the references against the port, and the
registry of configurations, mixes and metrics by file name.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import arrivals, frozen, run
from benchmark.metrics.work import ccn2d as work_ccn2d
from benchmark.metrics.work import gnn as work_gnn
from benchmark.reference import ccn2d as ref_ccn2d
from benchmark.reference import common
from benchmark.reference import gnn as ref_gnn

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 17  # past 32 signed bits, as a run's seed may be


def _cfg(name: str) -> dict:
    return run.load_json("configs", f"{name}.json")


def test_arrivals_are_the_seeds_and_keep_the_work():
    t = {"rate_per_s": 50, "min_records": 1, "max_records": 256}
    a = arrivals.requests(t, SEED, 20, 8192)
    assert a == arrivals.requests(t, SEED, 20, 8192)
    b = arrivals.requests(t, SEED + 1, 20, 8192)
    assert a != b
    assert len(a) == len(b) == 1000
    # the same sizes and gaps, in another order
    assert sorted(r[2] for r in a) == sorted(r[2] for r in b)
    gaps = lambda q: sorted(np.round(np.diff([r[0] for r in q] + [20.0]), 9))
    np.testing.assert_allclose(gaps(a), gaps(b), rtol=1e-9)
    assert a[0][0] == 0.0 and all(0 <= r[0] < 20 for r in a)
    assert all(0 <= r[1] and r[1] + r[2] <= 8192 for r in a)
    sizes = np.array([r[2] for r in a])
    assert sizes.min() == 1 and 250 <= sizes.max() <= 256
    assert 40 < sizes.mean() < 52  # log-uniform over [1, 256]: 46


def test_frozen_molecules_are_the_ports():
    from hgnn2_torch.data import qm9

    mine = frozen.synthetic_qm9_like(200, SEED)
    port = qm9.synthetic_qm9_like(200, seed=SEED)
    for m, p in zip(mine, port):
        np.testing.assert_array_equal(m.x, p.x)
        np.testing.assert_array_equal(m.adj, p.adj)
        np.testing.assert_array_equal(m.y, p.y)


def _chain(n: int) -> frozen.Molecule:
    adj = np.zeros((n, n), np.float32)
    for i in range(n - 1):
        adj[i, i + 1] = adj[i + 1, i] = 1.0
    return frozen.Molecule(x=np.eye(n, 5, dtype=np.float32), adj=adj,
                           y=np.zeros(13, np.float32))


def test_gnn_work_by_hand():
    cfg = dict(L=2, h=1, J=1, in_features=5, dim_output=1)
    # one layer at width 5: A X 2*3*3*5 = 90, two Linear 2*2*3*15*1 = 180;
    # the readout at width 2: A X 2*3*3*2 = 36, fc 2*3*6*1 = 36
    assert work_gnn.batch_work(cfg, [_chain(3)], 3)["flops"] == 3 * (90 + 180 + 36 + 36)


def test_ccn2d_work_by_hand():
    cfg = dict(L=2, h=2, in_features=5, dim_output=1)
    mol = _chain(2)  # each vertex sees both: d = 2, K = 2
    w = work_ccn2d.batch_work(cfg, [mol], 2)
    # per vertex, layer of width C: C (2*8 + 22*4) + 2*4*18C*2
    fwd = sum(2 * (c * (16 + 88) + 2 * 4 * 18 * c * 2) for c in (5, 2))
    assert w["flops"] == 3 * fwd
    V, K = 2, 2
    b3 = lambda c: 4 * (V * K * K + V * K + V * K * K * c + V + V * K
                        + V * K * K * 18 * c)
    # K4 of layer 2: every slot valid (S = 4), chi all valid (P = 8, Q = 16)
    b4 = 4 * (V * K * K * 36 + V + V * K + V * K * K + 2 * V * K + V * K * K * 2)
    ops4 = 2 * (12 * K * 4 + (4 * K + 12) * 8 + 6 * 16)
    want = (frozen.bound_s(b3(5), V * 5 * (2 * 8 + 22 * 4))[0]
            + frozen.bound_s(b3(2), V * 2 * (2 * 8 + 22 * 4))[0]
            + frozen.bound_s(b4, ops4)[0])
    assert w["bounds"]["ccn2d_contract"] == pytest.approx(want, rel=1e-12)


def test_ccn2d_tables_are_the_ports():
    from hgnn2_torch.graphs import GraphRecord
    from hgnn2_torch.nn import ccn

    mols = frozen.synthetic_qm9_like(40, SEED)
    t = ref_ccn2d.tables(mols)
    K = t["nbr"].shape[1]
    b = ccn.make_ccn_batch([GraphRecord(x=m.x, adj=m.adj, y=m.y) for m in mols],
                           k_max=K, task=0, device="cpu")
    np.testing.assert_array_equal(t["chi"], b.chi_idx.numpy())
    np.testing.assert_array_equal(np.where(t["nbr"] >= 0, t["nbr"], 0),
                                  b.nbr.numpy())
    np.testing.assert_array_equal(t["deg"], b.deg.numpy())


@pytest.mark.parametrize("name", ["gnn_L15_h1", "ccn2d_L2_h2"])
def test_reference_agrees_with_the_port(name):
    """Forward in train and eval mode, loss and gradients, at a small size:
    the reference from the molecules, the port from its own batches."""
    from hgnn2_torch.graphs import GraphRecord
    from hgnn2_torch.training import train

    cfg = _cfg(name)
    port = __import__(f"benchmark.models.{cfg['model']}", fromlist=["x"])
    ref = ref_gnn if cfg["model"] == "gnn" else ref_ccn2d
    mols = frozen.synthetic_qm9_like(96, SEED)
    recs = [GraphRecord(x=m.x, adj=m.adj, y=m.y) for m in mols]
    params, buffers = common.draw_weights(ref.param_spec(cfg),
                                          ref.buffer_spec(cfg), SEED, "cpu")
    loader = port.train_loader(recs, 32, cfg, "cpu")
    model = port.build(cfg, "cpu", getattr(loader, "k_max", None))
    model.load_state_dict({**params, **buffers})
    deal = port.deal(mols, 32)
    mean, std = common.target_stats(mols, 0)
    for batch, idx in zip(loader, deal):
        chunk = [mols[i] for i in idx]
        inp = ref.inputs(chunk, "cpu")
        for train_mode in (True, False):
            model.load_state_dict({**params, **buffers})  # BN's running stats
            model.train(train_mode)
            got = model(batch)[: len(chunk)]
            p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            want = ref.forward(p, buffers, inp, train_mode, common.matmul)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        model.train()
        model.zero_grad()
        out = model(batch)
        loss_p, _ = train._loss_and_metrics(out, batch.y, train._graph_mask(batch),
                                            "regression", mean, std)
        loss_p.backward()
        y = torch.tensor([m.y[0] for m in chunk])
        loss_r = common.loss_fn(ref.forward(p, buffers, inp, True, common.matmul),
                                y, mean, std)
        grads = dict(zip(p, torch.autograd.grad(loss_r, list(p.values()),
                                                allow_unused=True)))
        torch.testing.assert_close(loss_p, loss_r, rtol=1e-4, atol=1e-6)
        named = dict(model.named_parameters())
        for k, g in grads.items():
            g = torch.zeros_like(p[k]) if g is None else g
            torch.testing.assert_close(named[k].grad, g, rtol=1e-3, atol=1e-5)


def test_tf32_round():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10, -(1.0 + 3 * 2**-12),
                      1.0 + 2**-12, 0.0])
    r = common.tf32_round(x)
    # 10 mantissa bits kept, to nearest (ties away from zero)
    assert r.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -(1.0 + 2**-10), 1.0, 0.0]


def _copy_benchmark(tmp: Path) -> Path:
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp


def _run_in(tmp: Path, code: str) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": f"{tmp}{os.pathsep}{ROOT}"}
    return subprocess.run([sys.executable, "-c", code], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=600)


def test_new_config_mix_and_metric_are_new_files(tmp_path):
    """A configuration, a traffic mix, a cell's limits and a per-layer
    metric added as new files and entries run without an edit of the
    harness."""
    tmp = _copy_benchmark(tmp_path)
    b = tmp / "benchmark"
    cfg = json.loads((b / "configs" / "gnn_L15_h1.json").read_text())
    cfg.update(name="gnn_L3_h2", L=3, h=2, train_molecules=1024)
    (b / "configs" / "gnn_L3_h2.json").write_text(json.dumps(cfg))
    (b / "traffic" / "train_b64.json").write_text(json.dumps(
        {"kind": "train", "batch": 64, "trace_steps": 16, "why": "test"}))
    (b / "limits" / "gnn_L3_h2.train_b64.json").write_text(json.dumps(
        {"loss_gap": 1e-3, "grad_gap_median": 1e-3, "change_gap_median": 1e-3}))
    (b / "metrics" / "train.slice_steps.py").write_text(
        "def read(ctx):\n    return ctx.trace.units if ctx.trace else None\n")
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "gnn_L3_h2", "source": "test",
                            "file": "benchmark/configs/gnn_L3_h2.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "gnn_L3_h2.train_b64", "config": "gnn_L3_h2",
                              "traffic": "train_b64", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "gnn_L15_h1.train_b1024" in m["workloads"]:
            m["workloads"].append("gnn_L3_h2.train_b64")
    spec["per_layer"].append({"name": "train.slice_steps", "unit": "steps",
                              "better": "higher", "source": "device_trace",
                              "layer": "training programs",
                              "moves": "train_molecules_per_s",
                              "workloads": ["gnn_L3_h2.train_b64"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, time; from benchmark import run; "
            "r = run.run_cell('gnn_L3_h2.train_b64', 5, 0.2, {t}, 'cpu', "
            "t_start=time.perf_counter()); print(json.dumps(r))")
    for trace, want in ((False, "train_molecules_per_s"), (True, "train.slice_steps")):
        p = _run_in(tmp, code.format(t=trace))
        assert p.returncode == 0, p.stderr[-3000:]
        res = json.loads(p.stdout.strip().splitlines()[-1])
        assert want in res["metrics"], res
        assert res["correct"], res
    assert res["metrics"]["train.slice_steps"]["value"] == 16


def test_no_banned_module_loads(tmp_path):
    """Every module of the benchmark imported and a training and a serving
    cell run: no module of top-level name jax, jaxlib, flax or hgnn2_tpu is
    loaded."""
    frag = ROOT / "benchmark" / "tests" / "serve_cells.json"
    code = ("import importlib, pkgutil, time, json, sys, benchmark; "
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "benchmark.__path__, 'benchmark.') if '.tests' not in m.name]; "
            "from benchmark import run; "
            "spec = run.benchmark_spec(); "
            f"frag = json.load(open({str(frag)!r})); "
            "spec = {**spec, **{k: spec[k] + frag[k] for k in frag}}; "
            "run.run_cell('gnn_L15_h1.train_b1024', 3, 0.5, True, 'cpu', "
            "overrides={'config': {'train_molecules': 1024}, 'traffic': "
            "{'batch': 128, 'trace_steps': 8, 'warm_seconds': 0.2}}, t_start=time.perf_counter(), "
            "spec=spec); "
            "run.run_cell('gnn_L15_h1.serve_open', 3, 0.5, True, 'cpu', "
            "overrides={'traffic': {'pool': 128, 'rate_per_s': 10, "
            "'max_records': 16, 'trace_requests': 2}}, t_start=time.perf_counter(), "
            "spec=spec); "
            "print(json.dumps(run.banned_modules()))")
    p = _run_in(_copy_benchmark(tmp_path), code)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
    assert set(run.BANNED) == {"jax", "jaxlib", "flax", "hgnn2_tpu"}


def test_exits_without_the_port(tmp_path):
    """In a directory of BENCHMARK.json and the benchmark alone the command
    fails and prints no result."""
    tmp = _copy_benchmark(tmp_path)
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "gnn_L15_h1.train_b1024", "--seed", "1", "--seconds", "1"],
                       cwd=tmp, env={**os.environ, "PYTHONPATH": str(tmp)},
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_trace_summary():
    """The device's busy time is the union of its work, a host range's
    shadow on the device's timeline is no work, each idle gap is put to the
    host event running in it, and the kernel table gives the launches."""
    from types import SimpleNamespace as NS

    from benchmark import tracing

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, s, e, dev, annotation=False):
        return NS(name=name, time_range=NS(start=s, end=e), device_type=dev,
                  is_user_annotation=annotation)

    events = [ev(tracing.SLICE, 0.0, 1000.0, cpu),
              ev(tracing.SLICE, 0.0, 1000.0, cuda, annotation=True),
              ev("aten::copy_", 400.0, 700.0, cpu),
              ev("k1", 100.0, 300.0, cuda), ev("k2", 250.0, 400.0, cuda),
              ev("k1", 404.0, 500.0, cuda), ev("Memcpy HtoD", 800.0, 900.0, cuda)]
    rows = [{"category": "kernel", "op_name": "k1", "occurrences": 2, "total_time": 296.0},
            {"category": "kernel", "op_name": "k2", "occurrences": 1, "total_time": 150.0},
            {"category": "memcpy", "op_name": "Memcpy HtoD", "occurrences": 1,
             "total_time": 100.0},
            {"category": "kernel", "op_name": tracing.SLICE, "occurrences": 1,
             "total_time": 1000.0}]
    s = tracing.summarize(events, rows, units=2)
    assert s.busy_s == pytest.approx(496e-6)  # 100-400, 404-500, 800-900
    assert s.window_s == pytest.approx(1e-3)
    assert s.launches == 3
    assert s.kernel_us == {"k1": 296.0, "k2": 150.0, "Memcpy HtoD": 100.0}
    gaps = dict(s.idle_gaps)
    assert gaps["host: aten::copy_"] == pytest.approx(300e-6)  # 500-800
    assert gaps["device: launch gap (< 10 us)"] == pytest.approx(4e-6)
    assert gaps["host: python between ops"] == pytest.approx(200e-6)  # 0-100, 900-1000
