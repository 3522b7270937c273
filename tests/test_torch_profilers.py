"""The port's profilers against the JAX package's, on the CPU:
profiling.trace (JAX's default directory, the trace kept when the block
raises, nothing written in the working tree), parse_kernel_stats on a CPU
profile and on device events, hgnn2_torch/scripts/profile_lggnn.py's
build against scripts/profile_lggnn.py's (dense, packed, and JAX's fused
dense build against the port's one dense build: one scanned epoch from
JAX's init, the group counts), both profilers' main
at a tiny size writing JAX's files and keys (the committed
runs/profile_lggnn/ and runs/profile_ccn1d/ outputs fix them), and a
CCN1D step of profile_ccn1d's against JAX's make_train_step from JAX's
weights. JAX's script functions are imported from scripts/ with
importlib, runtime.setup stubbed out (it would set up a compilation
cache), their main never run.

Tolerances: a scanned epoch's loss rtol 1e-5 dense, 1e-4 packed (its
segment sums add in another order); a CCN1D step's loss rtol 1e-5."""

import importlib.util
import inspect
import json
import os
import tempfile
import types
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import torch

from hgnn2_tpu import profiling as jprofiling
from hgnn2_tpu import runtime as jruntime
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.data import stats as jstats
from hgnn2_tpu.nn import ccn as jccn
from hgnn2_tpu.training import optim as joptim
from hgnn2_tpu.training import train as jtrain
from hgnn2_tpu.training.config import OptimConfig as JOptimConfig

from hgnn2_torch import convert, profiling
from hgnn2_torch.data import qm9, stats
from hgnn2_torch.nn import ccn
from hgnn2_torch.scripts import profile_ccn1d, profile_lggnn
from hgnn2_torch.scripts import profile_ccn1d_util as util
from hgnn2_torch.training import train

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_KEYS = {"rank", "category", "op_name", "occurrences", "total_time",
            "avg_time"}


def jax_script(name: str):
    """scripts/<name>.py as a module, without its runtime.setup()."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(jruntime, "setup", lambda *a, **k: None):
        spec.loader.exec_module(mod)
    return mod


def _committed(*path):
    with open(os.path.join(ROOT, "runs", *path)) as f:
        return f.read() if path[-1].endswith(".md") else json.load(f)


def test_trace_defaults_to_jaxs_directory():
    """JAX's /tmp/hgnn2_trace, under this platform's temporary directory."""
    mine = inspect.signature(profiling.trace).parameters["log_dir"].default
    want = inspect.signature(jprofiling.trace).parameters["log_dir"].default
    assert want == "/tmp/hgnn2_trace"
    assert mine == os.path.join(tempfile.gettempdir(), "hgnn2_trace")
    assert mine == want.replace("/tmp", tempfile.gettempdir(), 1)


def test_trace_keeps_its_trace_when_the_block_raises(tmp_path):
    log_dir = str(tmp_path / "t")
    with pytest.raises(ValueError, match="inside the trace"):
        with profiling.trace(log_dir) as prof:
            torch.ones(64, 64) @ torch.ones(64, 64)
            raise ValueError("inside the trace")
    with open(os.path.join(log_dir, "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    top, rows = util.parse_kernel_stats(prof)
    assert any("mm" in r["op_name"] for r in rows)


def test_trace_writes_nothing_in_the_working_tree(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    default = inspect.signature(profiling.trace).parameters["log_dir"].default
    path = os.path.join(default, "trace.json")
    with profiling.trace() as prof:
        torch.arange(10.0).sum()
    assert prof is not None and os.path.exists(path)
    assert not os.listdir(tmp_path)
    os.remove(path)


def test_parse_kernel_stats_on_a_cpu_profile():
    """Rows sorted by self time, JAX's keys, ranks from 1; a CPU profile
    has no kernels."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            (x @ x).relu().sum()
    top, rows = util.parse_kernel_stats(prof, top_n=3)
    assert len(top) == 3 and top == rows[:3]
    times = [r["total_time"] for r in rows]
    assert times == sorted(times, reverse=True)
    assert [r["rank"] for r in rows] == list(range(1, len(rows) + 1))
    for r in rows:
        assert set(r) == ROW_KEYS and r["category"] == "cpu"
        assert r["avg_time"] == pytest.approx(r["total_time"] / r["occurrences"])
    assert any(r["op_name"] == "aten::mm" and r["occurrences"] == 3 for r in rows)
    assert util.kernel_launches(rows) == 0
    assert set(top[0]) - {"op_name"} <= set(
        _committed("profile_lggnn", "summary_dense_h1.json")["top_ops"][0])


def test_parse_kernel_stats_keeps_device_events_only():
    """With device events, the CPU ops drop out; kineto's Memcpy and
    Memset names are their categories, every other device event a
    kernel, and only kernels count as launches."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(key, dev, count, t):
        return types.SimpleNamespace(key=key, device_type=dev, count=count,
                                     self_device_time_total=t,
                                     self_cpu_time_total=10 * t)

    prof = types.SimpleNamespace(key_averages=lambda: [
        event("aten::mm", cpu, 2, 0.0), event("cudaGraphLaunch", cpu, 3, 0.0),
        event("Memcpy HtoD (Pageable -> Device)", cuda, 4, 5.0),
        event("Memset (Device)", cuda, 1, 1.0),
        event("void at::native::vectorized_elementwise_kernel<4>", cuda, 30, 60.0),
        event("sm90_xmma_gemm_f32f32", cuda, 6, 90.0)])
    top, rows = util.parse_kernel_stats(prof, top_n=2)
    assert [(r["op_name"][:14], r["category"]) for r in rows] == [
        ("sm90_xmma_gemm", "kernel"), ("void at::nativ", "kernel"),
        ("Memcpy HtoD (P", "memcpy"), ("Memset (Device", "memset")]
    assert top == rows[:2] and rows[1]["avg_time"] == 2.0
    assert util.kernel_launches(rows) == 36


def _variables(state) -> dict:
    return jax.tree.map(np.asarray, {"params": state.params,
                                     "batch_stats": state.batch_stats})


@pytest.fixture(scope="module")
def lg_records():
    recs, jrecs = qm9.synthetic_qm9_like(64, seed=0), jqm9.synthetic_qm9_like(64, seed=0)
    return recs, stats.compute_target_stats(recs), jrecs, jstats.compute_target_stats(jrecs)


@pytest.mark.parametrize("use_packed,fused,rtol", [
    (False, False, 1e-5), (True, False, 1e-4), (False, True, 1e-5)])
def test_build_matches_jax(lg_records, use_packed, fused, rtol):
    """build at 64 molecules, batch 32, h=2: the same groups, and one
    scanned epoch from JAX's init gives JAX's loss; fused sets JAX's
    fused_ops, the port's dense build has one exchange."""
    recs, ts, jrecs, jts = lg_records
    jstate, jgroups, jscan, jn = jax_script("profile_lggnn").build(
        jrecs, jts, 2, 32, use_packed, fused)
    model, groups, scan_fn, n = profile_lggnn.build(
        recs, ts, 2, 32, use_packed, "cpu", init_params=_variables(jstate))
    assert n == jn == 2 and len(groups) == len(jgroups)
    _, want = jtrain.run_epoch_scanned(jstate, jgroups, jscan)
    got = train.run_epoch_scanned(groups, scan_fn)
    np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=rtol)


def test_profile_lggnn_main_writes_jaxs_files(tmp_path):
    out = str(tmp_path)
    argv = ["--molecules", "64", "--batch_size", "32", "--device", "cpu",
            "--out", out]
    summary = profile_lggnn.main(argv)
    sweep = profile_lggnn.main(argv + ["--packed", "--sweep_h", "1", "2"])
    want = _committed("profile_lggnn", "summary_dense_h1.json")
    with open(os.path.join(out, "summary_dense_h1.json")) as f:
        assert json.load(f) == json.loads(json.dumps(summary))
    assert set(summary) == set(want) | {"n_kernels_per_step", "card"}
    assert summary["card"] == "cpu" and summary["steps_per_epoch"] == 2
    assert summary["n_kernels_per_step"] == 0.0  # CPU rows are ops
    assert all(set(r) == ROW_KEYS for r in summary["top_ops"])
    table = (tmp_path / "op_table_dense_h1.md").read_text().splitlines()
    assert table[4] == _committed("profile_lggnn",
                                  "op_table_dense_h1.md").splitlines()[4]
    assert len(table) == 6 + len(summary["top_ops"])
    jrow = _committed("profile_lggnn", "h_sweep_dense.json")[0]
    with open(os.path.join(out, "h_sweep_packed.json")) as f:
        rows = json.load(f)
    assert rows == json.loads(json.dumps(sweep))
    assert [set(r) for r in rows] == [set(jrow)] * 2
    assert [(r["layout"], r["h"]) for r in rows] == [("packed", 1), ("packed", 2)]
    assert os.path.exists(os.path.join(out, "trace_dense_h1", "trace.json"))


def test_profile_ccn1d_main_writes_jaxs_files(tmp_path):
    findings = profile_ccn1d.main(["--molecules", "16", "--layers", "2",
                                   "--sweep_h", "2", "--device", "cpu",
                                   "--out", str(tmp_path)])
    want = _committed("profile_ccn1d", "findings.json")
    with open(tmp_path / "findings.json") as f:
        assert json.load(f) == json.loads(json.dumps(findings))
    assert set(findings) == set(want) | {"kernel_trace"}
    assert set(findings["config"]) == set(want["config"]) | {"paths", "card"}
    assert set(findings["config"]["paths"]) == {"xla", "pallas_kernel"}
    for key in ("step_ms", "molecules_per_s"):
        assert set(findings[key]) == set(want[key])
    for key in ("xla_trace", "kernel_trace"):
        assert set(findings[key]) == set(want["xla_trace"])
    assert [set(r) for r in findings["h_sweep"]] == [set(want["h_sweep"][0])]
    jtable = _committed("profile_ccn1d", "op_table_xla.md").splitlines()
    for name in ("xla", "kernel"):
        table = (tmp_path / f"op_table_{name}.md").read_text().splitlines()
        assert table[0].startswith("# CCN-1D L=2 h=2 ")
        assert table[4].split("|")[1:4] == jtable[4].split("|")[1:4]


def test_ccn1d_train_step_matches_jax():
    """Two of profile_ccn1d's train steps (Adamax lr 1e-3) from JAX's
    init against JAX's make_train_step, on both of its paths (the
    kernel path runs the plain ops on the CPU)."""
    recs, jrecs = qm9.synthetic_qm9_like(16, seed=0), jqm9.synthetic_qm9_like(16, seed=0)
    ts, jts = stats.compute_target_stats(recs), jstats.compute_target_stats(jrecs)
    jcb = jccn.make_ccn_batch(jrecs, task=0)
    tx = joptim.build_optimizer(JOptimConfig(optim="adamax", lr=1e-3),
                                steps_per_epoch=100)
    state = jtrain.TrainState.create(jccn.CCN1D(hidden=2, n_layers=2), jcb,
                                     tx, jax.random.key(0))
    params = jax.tree.map(np.asarray, state.params)
    one = jtrain.make_train_step("regression", float(jts.mean[0]),
                                 float(jts.std[0]))
    want = []
    for _ in range(2):
        state, m = one(state, jcb)
        want.append(float(m["loss"]))
    cb = ccn.make_ccn_batch(recs, task=0, device="cpu")
    for kernel in (False, True):
        model = profile_ccn1d.make_model(cb, 2, 2, kernel)
        model.load_state_dict(convert.ccn_params_from_flax(params))
        step = profile_ccn1d.train_step(model, ts)
        got = [float(step(cb)["loss"]) for _ in range(2)]
        np.testing.assert_allclose(got, want, rtol=1e-5)
