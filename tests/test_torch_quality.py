"""The port's quality harnesses against the JAX package's, on the CPU:
hgnn2_torch/scripts/regression_floor.py against scripts/regression_floor.py
and JAX's committed floor.json files, run_validation.py's nine configs
field by field against JAX's, its bands and gap ratios derived again from
JAX's committed results.jsonl, 2-epoch runs at a tiny n (cls_gnn,
reg_gnn_recal, reg_gnn_control, reg_ccn2d) against JAX's run_experiment
from JAX's initial weights, range_split_eval and diagnose_quality_gap.py's
linear probe and BN modes against JAX's from the same weights,
validation_draws.py's draw 0 against run_validation's run, and both mains
writing only the port's runs/*_torch directories. JAX's scripts are
imported from scripts/ with importlib, runtime.setup stubbed out, their
main never run except regression_floor's (into a temporary directory).
Run as a script (python tests/test_torch_quality.py NAME [OUT]) it trains
JAX's run and the port's from JAX's initial weights at full length on
the CPU and judges both against the band (from_jax_init).

Tolerances: floors rtol 1e-9 (the same records, float64 numpy); histories
rtol 1e-4 (epoch means of f32 steps in another order), epoch_time_s
excluded, but a BN model's valid and test metrics rtol 1e-2 (EVAL_RTOL,
also against the port's own run on 4 CPU threads); range-split counts
exact, ratios rtol 1e-4; the probe's ratios after 3 epochs rtol 1e-5;
BN-mode ratios rtol 1e-4; the port's BN running statistics bit-equal
before and after the train-mode pass."""

import dataclasses
import importlib.util
import json
import os
import sys
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import torch

from hgnn2_tpu import runtime as jruntime
from hgnn2_tpu.cli import common as jcommon
from hgnn2_tpu.data import synthetic as jsynthetic
from hgnn2_tpu.training import train as jtrain

from hgnn2_torch import convert
from hgnn2_torch.cli import common
from hgnn2_torch.data import synthetic
from hgnn2_torch.scripts import diagnose_quality_gap as dq
from hgnn2_torch.scripts import regression_floor as rf
from hgnn2_torch.scripts import run_validation as rv

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The valid and test metrics of a run of a BN model (gnn h=64): a conv
# bias whose ReLU is on at every real node has an exact gradient of zero,
# and Adamax moves it by up to about lr with its rounding's sign, in each
# package on its own (tests/test_torch_trajectory_slack.py). Train-mode BN
# subtracts that walk, eval-mode BN's running mean does not: after the
# first epoch (2 steps) reg_gnn_control's test_loss parts from JAX's by
# 3.8e-3 relative, and the port's own runs on 2 and 4 CPU threads part by
# 4.3e-3, while the train metrics agree within 2e-6. The packed
# line-graph CLI runs carry the same bar (tests/test_torch_packed_train.py).
EVAL_RTOL = 1e-2


def jax_script(name: str, **modules):
    """scripts/<name>.py as a module, without its runtime.setup();
    modules: stand-ins for the script's imports of its siblings."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(jruntime, "setup", lambda *a, **k: None), \
            mock.patch.dict(sys.modules, modules):
        spec.loader.exec_module(mod)
    return mod


JRV = jax_script("run_validation")
JDQ = jax_script("diagnose_quality_gap", run_validation=JRV)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_close(got: dict, want: dict, rtol: float):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for k, v in got.items():
        if isinstance(v, (str, type(None))) or isinstance(want[k], str):
            assert v == want[k], k
        else:
            np.testing.assert_allclose(v, want[k], rtol=rtol, err_msg=str(k))


def _committed(*path):
    with open(os.path.join(ROOT, "runs", *path)) as f:
        return json.load(f)


@pytest.mark.parametrize("n,committed", [
    (2000, "validation_reg_floor"), (8000, "validation_reg_floor_8000")])
def test_regression_floor_matches_jax(tmp_path, monkeypatch, n, committed):
    """floor.json at n = 2000 and 8000: JAX's script's file and the
    committed one, to rtol 1e-9 (train error ratio 0.017119 and 0.017362)."""
    monkeypatch.setattr(sys, "argv", ["regression_floor.py", "--n", str(n),
                                      "--out", str(tmp_path / "jax")])
    jax_script("regression_floor").main()
    with open(tmp_path / "jax" / "floor.json") as f:
        want = json.load(f)
    got = rf.main(["--n", str(n), "--out", str(tmp_path / "torch")])
    with open(tmp_path / "torch" / "floor.json") as f:
        assert json.load(f) == got
    _assert_close(got, want, 1e-9)
    _assert_close(got, _committed(committed, "floor.json"), 1e-9)


def test_outputs_stay_out_of_jaxs_runs():
    """Every default output path is a port directory (*_torch), and a
    JAX run's directory is never cleared."""
    assert rf.DEFAULT_OUT == os.path.join("runs", "validation_reg_floor_torch")
    assert [out for _, out in rv.FLOORS] == [
        os.path.join("runs", "validation_reg_floor_torch"),
        os.path.join("runs", "validation_reg_floor_8000_torch")]
    for name in rv.RUNS:
        assert rv.out_dir(name) == os.path.join("runs", f"{name}_torch")
        with pytest.raises(ValueError, match="not a port run"):
            rv._clear(os.path.join("runs", name))
    assert dq.CONTROL in rv.RUNS and set(rv.RUNS) == set(JRV.RUNS)


@pytest.mark.parametrize("name", list(JRV.RUNS))
def test_runs_config_matches_jax(name):
    """Each RUNS entry, field by field, is JAX's (the port's config adds
    only the device, cuda by default)."""
    got = dataclasses.asdict(rv.RUNS[name]())
    assert got.pop("device") == "cuda"
    assert got == dataclasses.asdict(JRV.RUNS[name]())


def test_bands_follow_from_jaxs_committed_runs():
    """BANDS and GAP, derived again from JAX's runs/<name>/results.jsonl
    by the rule of run_validation's docstring (last 20 rows)."""
    assert set(rv.BANDS) == set(rv.RUNS)
    for name, bands in rv.BANDS.items():
        with open(os.path.join(ROOT, "runs", name, "results.jsonl")) as f:
            rows = [json.loads(line) for line in f][-rv.LAST:]
        meds = {}
        for metric, band in bands.items():
            v = np.array([r[metric] for r in rows])
            meds[metric] = float(np.median(v))
            if metric.endswith("accuracy"):
                want = (float(v.min()) - 0.03, None)
            else:
                m = meds[metric]
                want = (float(v.min()) - 0.15 * m, float(v.max()) + 0.15 * m)
            assert band == want, (name, metric)
        if name in rv.GAP:
            assert rv.GAP[name] == (meds["valid_error_ratio"]
                                    / meds["train_error_ratio"])
    assert set(rv.GAP) == {n for n in rv.RUNS
                           if n.startswith("validation_reg") and "ccn" not in n}


def _tiny(cfg):
    """A RUNS config cut for the CPU: 2 epochs over a few molecules."""
    cfg.epochs = 2
    cfg.data.n_synthetic = 160 if cfg.data.dataset == "synthetic" else 120
    return cfg


def _jax_run(cfg, monkeypatch, log_path):
    """JAX's run_experiment of cfg; returns its state, its history and its
    initial variables (numpy; params only for CCN)."""
    created = []
    create = jtrain.TrainState.create

    def record_init(*args, **kwargs):
        created.append(create(*args, **kwargs))
        return created[-1]

    cfg.log_path = str(log_path)
    with monkeypatch.context() as m:
        m.setattr(jtrain.TrainState, "create", record_init)
        state, history = jcommon.run_experiment(cfg)
    init = jax.tree.map(np.asarray, {"params": created[0].params,
                                     "batch_stats": created[0].batch_stats})
    if cfg.model.arch.startswith("ccn"):
        init = init["params"]
    return state, history, init


@pytest.mark.parametrize("name", ["validation_cls_gnn",
                                  "validation_reg_gnn_recal",
                                  "validation_reg_gnn_control",
                                  "validation_reg_ccn2d"])
def test_run_matches_jax(tmp_path, monkeypatch, name):
    """run_one's 2-epoch run at a tiny n on the CPU, from JAX's initial
    weights, against JAX's run_experiment of JAX's config: the histories
    (the recalibration row included), the files of the run and its
    record (no band: this is not a full-length run). A BN model's valid
    and test metrics are held at EVAL_RTOL, against JAX's run and against
    the port's own run on 4 CPU threads in place of 2."""
    _, want, init = _jax_run(_tiny(JRV.RUNS[name]()), monkeypatch,
                             tmp_path / "jax")
    cfg = _tiny(rv.RUNS[name]())
    cfg.device, cfg.log_path = "cpu", str(tmp_path / f"{name}_torch")
    _, got, record = rv.run_one(name, cfg, banded=False, init_params=init)
    bn = cfg.model.arch == "gnn"
    runs = [(got, want)]
    if bn:
        torch.set_num_threads(4)
        try:
            cfg.log_path = str(tmp_path / f"{name}_4_torch")
            runs.append((rv.run_one(name, cfg, banded=False,
                                    init_params=init)[1], got))
        finally:
            torch.set_num_threads(2)
    assert len(got) == len(want) == 2 + cfg.bn_recalibrate
    for one, other in runs:
        for a, b in zip(one, other):
            assert a.keys() == b.keys()
            for k in a:
                if k != "epoch_time_s":
                    rtol = (EVAL_RTOL if bn and k.startswith(("valid_", "test_"))
                            else 1e-4)
                    np.testing.assert_allclose(a[k], b[k], rtol=rtol,
                                               err_msg=k)
    assert record["card"] == "cpu" and record["rows"] == len(got)
    assert record["launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    if name == "validation_reg_ccn2d":
        assert record["K"] == 5 and record["ccn_kernel"] is False
    assert (tmp_path / f"{name}_torch" / "results.jsonl").exists()
    assert not (tmp_path / f"{name}_torch" / "quality.json").exists()


@pytest.fixture(scope="module")
def control(tmp_path_factory):
    """JAX's control run cut to 2 epochs over 200 molecules, its state
    and the port's GNNSimple with its final weights and BN statistics."""
    cfg = _tiny(JRV.RUNS[dq.CONTROL]())
    cfg.data.n_synthetic = 200
    with pytest.MonkeyPatch.context() as m:
        state, _, _ = _jax_run(cfg, m, tmp_path_factory.mktemp("jax"))
    mine = _tiny(rv.RUNS[dq.CONTROL]())
    mine.data.n_synthetic, mine.device = 200, "cpu"
    records, kind, _, _ = common.load_records(mine)
    model = common.build_model(mine, kind, records[0].x.shape[1])
    model.load_state_dict(convert.dense_variables_from_flax(jax.tree.map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats})))
    return cfg, state, mine, model


def test_range_split_eval_matches_jax(control, tmp_path):
    """From the same trained weights: exact counts, ratios rtol 1e-4."""
    cfg, state, mine, model = control
    (tmp_path / "jax").mkdir()
    JRV.range_split_eval(cfg, state, str(tmp_path / "jax"))
    with open(tmp_path / "jax" / "range_split.json") as f:
        want = json.load(f)
    got = rv.range_split_eval(mine, model, str(tmp_path / "torch"))
    with open(tmp_path / "torch" / "range_split.json") as f:
        assert json.load(f) == got
    for k in ("val_count", "val_in_range_count", "val_out_of_range_count"):
        assert got[k] == want[k], k
    assert got["val_count"] == 20
    _assert_close(got, want, 1e-4)


def test_bn_mode_eval_matches_jax(control):
    """Eval-mode and train-mode BN over the valid split from the same
    weights, rtol 1e-4; the port's running statistics bit-equal after."""
    cfg, state, mine, model = control
    records, _, ts, _ = jcommon.load_records(cfg)
    _, jva, _ = jsynthetic.split_80_10_10(records)
    want = JDQ.bn_mode_eval(cfg, state, jva, ts)
    records, _, ts, _ = common.load_records(mine)
    _, va, _ = synthetic.split_80_10_10(records)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = dq.bn_mode_eval(mine, model, va, ts)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    _assert_close(got, want, 1e-4)
    assert got["val_error_ratio_train_stats"] != got["val_error_ratio_eval"]


def test_linear_probe_matches_jax():
    """The probe of the control's features at 3 epochs over 400
    molecules, against JAX's (optax.adamax, f32), rtol 1e-5."""
    cfg = JRV.RUNS[dq.CONTROL]()
    cfg.epochs, cfg.data.n_synthetic = 3, 400
    records, _, ts, _ = jcommon.load_records(cfg)
    tr, va, _ = jsynthetic.split_80_10_10(records)
    want = JDQ.linear_probe(cfg, tr, va, ts)
    mine = rv.RUNS[dq.CONTROL]()
    mine.epochs, mine.data.n_synthetic = 3, 400
    records, _, ts, _ = common.load_records(mine)
    tr, va, _ = synthetic.split_80_10_10(records)
    got = dq.linear_probe(mine, tr, va, ts, "cpu")
    _assert_close(got, want, 1e-5)


def test_mains_write_only_port_directories(tmp_path, monkeypatch):
    """run_validation.main with no --only (the floors, then the runs) and
    diagnose_quality_gap.main, on the CPU at a tiny size in an empty
    directory: the files land under runs/*_torch and runs/_diag_control_torch,
    each run's quality.json judged against its band, the diagnosis with
    the probe, the retrain and both BN modes."""
    monkeypatch.chdir(tmp_path)
    small = {n: (lambda mk=rv.RUNS[n]: _tiny(mk())) for n in
             ("validation_cls_gnn", dq.CONTROL)}
    monkeypatch.setattr(rv, "FLOORS", tuple(
        (200, out) for _, out in rv.FLOORS))
    monkeypatch.setattr(rv, "RUNS", small)
    monkeypatch.setattr(dq, "RUNS", small)
    records = rv.main(["--device", "cpu"])
    assert set(records) == set(small)
    assert records[dq.CONTROL]["range_split"]["val_count"] == 12
    diag = dq.main(["--device", "cpu"])
    assert diag["card"] == "cpu" and diag["A_linear_probe"]["epochs"] == 2
    assert {"val_error_ratio_eval", "val_error_ratio_train_stats"} <= set(diag)
    made = sorted(os.listdir(tmp_path / "runs"))
    assert made == ["_diag_control_torch", "validation_cls_gnn_torch",
                    "validation_reg_floor_8000_torch",
                    "validation_reg_floor_torch",
                    "validation_reg_gnn_control_torch"]
    quality = json.loads((tmp_path / "runs" / "validation_cls_gnn_torch"
                          / "quality.json").read_text())
    assert quality["metrics"]["valid_accuracy"]["band"] == [
        rv.BANDS["validation_cls_gnn"]["valid_accuracy"][0], None]
    assert (tmp_path / "runs" / "validation_reg_gnn_control_torch"
            / "diagnosis.json").exists()


def test_validation_draws_draw_zero_is_run_validations_run(tmp_path,
                                                          monkeypatch):
    """validation_draws' draw 0 (weights drawn by build_model under seed 0,
    passed through run_experiment's init_params) trains run_validation's
    own run, history for history, and draw 1 another; draws.json lists
    both beside JAX's first epoch, on the CPU at a tiny size."""
    from hgnn2_torch.scripts import validation_draws as vd

    monkeypatch.chdir(tmp_path)
    for name in ("validation_reg_ccn2d", "validation_reg_gnn_control"):
        cfg = _tiny(rv.RUNS[name]())
        cfg.device = "cpu"
        _, want, _ = rv.run_one(name, cfg, banded=False)
        monkeypatch.setitem(rv.RUNS, name,
                            lambda mk=rv.RUNS[name]: _tiny(mk()))
        monkeypatch.setattr(vd, "jax_first_epoch", lambda n: 1.0)
        out = vd.main(["--only", name, "--draws", "0", "1", "--device", "cpu"])
        rows = out["runs"][name]["draws"]
        assert [r["draw"] for r in rows] == [0, 1]
        assert rows[0]["first_epoch_train_loss"] == want[0]["train_loss"]
        assert rows[1]["first_epoch_train_loss"] != want[0]["train_loss"]
        assert out["card"] == "cpu" and not out["plain"]
        run = tmp_path / "runs" / f"{name}_draw1_torch"
        assert (run / "quality.json").exists()
    assert json.loads((tmp_path / "runs" / "validation_draws_torch"
                       / "draws.json").read_text())["runs"]


def from_jax_init(name: str, out: str) -> dict:
    """JAX's run of RUNS[name] on the CPU at its full length, then the
    port's run on the CPU from JAX's initial weights: both histories'
    last-20 medians judged against BANDS (run_validation.judge)."""
    with pytest.MonkeyPatch.context() as m:
        _, want, init = _jax_run(JRV.RUNS[name](), m,
                                 os.path.join(out, f"{name}_jax"))
    cfg = rv.RUNS[name]()
    cfg.device = "cpu"
    cfg.log_path = os.path.join(out, f"{name}_from_jax_init_torch")
    _, got, _ = rv.run_one(name, cfg, banded=False, init_params=init)
    return {"jax_cpu": rv.judge(name, want),
            "port_cpu_from_jax_init": rv.judge(name, got)}


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_quality.py NAME [OUT]:
    # whether a run's place against its band follows the initial weights
    # (the port from JAX's draw) or the port (a full-length CPU run each)
    print(json.dumps(from_jax_init(sys.argv[1], sys.argv[2] if len(sys.argv)
                                   > 2 else "runs"), indent=1))
