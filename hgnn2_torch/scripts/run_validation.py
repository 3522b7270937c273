"""The validation trainings of the JAX repo on the port (counterpart of
scripts/run_validation.py).

    python -m hgnn2_torch.scripts.run_validation [--only NAME ...]
        [--device cuda|cpu]

Full-length learning runs on synthetic data for every model family, each
with JAX's configuration (RUNS):

  validation_cls_gnn      power GNN, collinear-points classification
  validation_cls_lggnn    line-graph GNN, the same task
  validation_cls_ccn1d    CCN-1D, the same task
  validation_reg_gnn      power GNN, synthetic QM9-shaped regression
  validation_reg_gnn_control         ... with the target's exact features
  validation_reg_gnn_recal           ... with BN recalibration
  validation_reg_gnn_control_recal   both
  validation_reg_lggnn    line-graph GNN, the same regression
  validation_reg_ccn2d    CCN-2D, the same regression (K <= 5: the fused
                          CUDA kernels K3 and K4 on the card)

Each run writes the trainer's files (results.jsonl, final.json, ...) to
runs/<name>_torch/, clearing that directory first and no other, and
beside them quality.json: the medians of the last 20 rows of the history
against BANDS, the bands set from JAX's committed runs/<name>/results.jsonl
before the port's first full-length run, the run's minutes, the CCN
kernels' launch counts and the card's name and power limit. The two gnn
regressions also write range_split.json. With no --only the least-squares
floors for 2,000 and 8,000 molecules come first
(hgnn2_torch/scripts/regression_floor.py, to
runs/validation_reg_floor{,_8000}_torch/). Runs on the card unless given
--device cpu (no card: it raises).

The bands. For an error ratio (regression) the median of the port's last
20 rows lies within [min - 0.15 m, max + 0.15 m], min, max and median m of
JAX's last 20 rows; for an accuracy (classification) it is at least JAX's
last-20 min - 0.03. The recalibrated runs' last row is the recalibration
row, in both packages. A run outside its band is a finding: the band
stays as it is. GAP holds the regressions' generalization gap: the valid
ratio's median over the train ratio's is at least half of JAX's.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

from hgnn2_torch.cli import common
from hgnn2_torch.data import batching, synthetic
from hgnn2_torch.ops import ccn_fused
from hgnn2_torch.scripts import regression_floor
from hgnn2_torch.scripts.profile_ccn1d_util import card, harness_device
from hgnn2_torch.training.config import TrainConfig


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def cls_cfg(arch, order=1, epochs=40):
    cfg = TrainConfig(batch_size=32, epochs=epochs)
    cfg.optim.lr = 3e-3
    cfg.model.arch = arch
    cfg.model.n_features = 6
    cfg.model.n_layers = 3
    cfg.model.order = order
    cfg.data.dataset = "synthetic"
    cfg.data.n_synthetic = 2000
    cfg.data.n_max = 12
    cfg.data.dim = 4
    cfg.data.p = 0.5
    cfg.data.c = 0.4
    return cfg


def reg_cfg(arch, h, L, lr=1e-3, epochs=120, n=8000, bs=64, order=2):
    """Sized to approach the least-squares floor
    (runs/validation_reg_floor/floor.json): in JAX's probe sweeps 8,000
    molecules and wide models closed most of the generalization gap and
    32,000 added nothing."""
    cfg = TrainConfig(batch_size=bs, epochs=epochs)
    cfg.optim.lr = lr
    cfg.model.arch = arch
    cfg.model.n_features = h
    cfg.model.n_layers = L
    cfg.model.order = order
    cfg.data.dataset = "qm9_synthetic"
    cfg.data.n_synthetic = n
    return cfg


def control_cfg():
    """The quality control: the gnn regression with the generator's exact
    target features appended to the node inputs, so that the
    least-squares floor (about 0.017) is linearly reachable by the sum
    readout."""
    cfg = reg_cfg("gnn", h=64, L=5)
    cfg.data.oracle_features = True
    return cfg


def recal_cfg(base):
    """base's configuration plus BN re-estimation after training
    (--bn_recalib), which appends one row."""
    cfg = base()
    cfg.bn_recalibrate = True
    return cfg


RUNS = {
    "validation_cls_gnn": lambda: cls_cfg("gnn"),
    "validation_cls_lggnn": lambda: cls_cfg("lggnn", order=2),
    "validation_cls_ccn1d": lambda: cls_cfg("ccn1d"),
    "validation_reg_gnn": lambda: reg_cfg("gnn", h=64, L=5),
    "validation_reg_gnn_control": control_cfg,
    "validation_reg_gnn_recal": lambda: recal_cfg(
        lambda: reg_cfg("gnn", h=64, L=5)),
    "validation_reg_gnn_control_recal": lambda: recal_cfg(control_cfg),
    "validation_reg_lggnn": lambda: reg_cfg("lggnn", h=32, L=4),
    "validation_reg_ccn2d": lambda: reg_cfg(
        "ccn2d", h=6, L=3, lr=1e-3, epochs=200, n=2000, bs=32),
}

RANGE_SPLIT = ("validation_reg_gnn", "validation_reg_gnn_control")
FLOORS = ((2000, os.path.join("runs", "validation_reg_floor_torch")),
          (8000, os.path.join("runs", "validation_reg_floor_8000_torch")))
LAST = 20  # rows of a history the bands read

# Set from JAX's committed runs/<name>/results.jsonl (its last 20 rows) by
# the rule of the module docstring, before the port's first full-length
# run: (low, high) of the median of the port's last 20 rows, high None
# for accuracies. tests/test_torch_quality.py derives them again.
BANDS = {
    "validation_cls_gnn": {
        "train_accuracy": (0.9375, None),
        "valid_accuracy": (0.7849999999999999, None),
        "test_accuracy": (0.82, None)},
    "validation_cls_lggnn": {
        "train_accuracy": (0.938125, None),
        "valid_accuracy": (0.745, None),
        "test_accuracy": (0.78, None)},
    "validation_cls_ccn1d": {
        "train_accuracy": (0.9306249999999999, None),
        "valid_accuracy": (0.9249999999999999, None),
        "test_accuracy": (0.9349999999999999, None)},
    "validation_reg_gnn": {
        "train_error_ratio": (1.0130392936420758, 1.634847802521803),
        "valid_error_ratio": (6.746920840339052, 24.610042994468767),
        "test_error_ratio": (6.97022215231922, 23.163361039707645)},
    "validation_reg_gnn_control": {
        "train_error_ratio": (0.7559300387443519, 1.2274932610100873),
        "valid_error_ratio": (6.824229442712227, 17.55848694505562),
        "test_error_ratio": (7.167531850821796, 19.41234579723558)},
    "validation_reg_gnn_recal": {
        "train_error_ratio": (1.0140260773889203, 1.6338610187749585),
        "valid_error_ratio": (6.742676298280413, 24.614287536527407),
        "test_error_ratio": (6.97022215231922, 23.163361039707645)},
    "validation_reg_gnn_control_recal": {
        "train_error_ratio": (0.7559300387443519, 1.2274932610100873),
        "valid_error_ratio": (6.788248413976307, 17.59446797379154),
        "test_error_ratio": (7.163435195037199, 19.41644245302018)},
    "validation_reg_lggnn": {
        "train_error_ratio": (0.6399918517398121, 0.9789495770160526),
        "valid_error_ratio": (6.8508304630096175, 26.768244334336455),
        "test_error_ratio": (7.411004172995625, 24.674106585471236)},
    "validation_reg_ccn2d": {
        "train_error_ratio": (5.956551353583073, 8.23750658023776),
        "valid_error_ratio": (6.487811330440472, 9.536030145644693),
        "test_error_ratio": (6.6538527778707035, 9.593679037784351)},
}

# The regressions whose train ratio lies far below the valid ratio in
# JAX's runs: JAX's valid/train ratio of last-20 medians. The port's must
# be at least half of it.
GAP = {
    "validation_reg_gnn": 8.103914627177945,
    "validation_reg_gnn_control": 10.22097133666673,
    "validation_reg_gnn_recal": 8.167086639874165,
    "validation_reg_gnn_control_recal": 10.465149601582212,
    "validation_reg_lggnn": 13.585514814279994,
}

KERNELS = {"K1": ccn_fused.fused_contract_1d_forward,
           "K2": ccn_fused.fused_contract_1d_backward,
           "K3": ccn_fused.fused_contract_forward,
           "K4": ccn_fused.fused_contract_backward}


def launches() -> dict[str, int]:
    """The CCN kernels' launch counts (their wrappers count each launch;
    a replayed CUDA graph launches again without counting)."""
    return {k: fn.launches for k, fn in KERNELS.items()}


def out_dir(name: str) -> str:
    return os.path.join("runs", f"{name}_torch")


def _clear(path: str) -> None:
    """Removes a previous run's directory: the port's own only."""
    if not os.path.basename(os.path.normpath(path)).endswith("_torch"):
        raise ValueError(f"refusing to clear {path!r}: not a port run")
    if os.path.exists(path):
        shutil.rmtree(path)


def judge(name: str, history: list[dict]) -> dict:
    """The last-LAST-row medians of the banded metrics, each with its band
    and whether it lies inside, and the generalization gap where GAP
    names one."""
    rows = history[-LAST:]
    res, ok = {}, True
    for metric, (lo, hi) in BANDS[name].items():
        med = float(np.median([r[metric] for r in rows]))
        inside = med >= lo and (hi is None or med <= hi)
        res[metric] = {"median_last20": med, "band": [lo, hi],
                       "in_band": inside}
        ok &= inside
    out = {"metrics": res}
    if name in GAP:
        gap = (res["valid_error_ratio"]["median_last20"]
               / res["train_error_ratio"]["median_last20"])
        out["gap"] = {"valid_over_train": gap, "jax": GAP[name],
                      "holds": gap >= GAP[name] / 2}
        ok &= gap >= GAP[name] / 2
    out["in_band"] = ok
    return out


@torch.no_grad()
def val_errors(cfg: TrainConfig, model, va, mean: float, std: float):
    """|prediction - normalized target| and the target of every real
    molecule of va, in DenseLoader(va, bs, task, sort=True)'s order, from
    ``model`` in whichever mode it is in."""
    dev = next(model.parameters()).device
    errs, ys = [], []
    for b in batching.DenseLoader(va, cfg.batch_size, task=cfg.data.task,
                                  sort=True, device=dev):
        out = model(b)[:, 0].cpu().numpy()
        y = b.y.cpu().numpy()
        real = b.n_nodes.cpu().numpy() > 0
        errs.append(np.abs(out - (y - mean) / std)[real])
        ys.append(y[real])
    return np.concatenate(errs), np.concatenate(ys)


@torch.no_grad()
def range_split_eval(cfg: TrainConfig, model, out_dir: str) -> dict:
    """The validation error split into molecules whose target lies inside
    the train targets' range and those outside it. Evaluates the trained
    model in eval mode over DenseLoader(va, bs, task, sort=True), as JAX's
    does; writes out_dir/range_split.json."""
    records, _kind, ts, _ = common.load_records(cfg)
    tr, va, _te = synthetic.split_80_10_10(
        records, shuffle=cfg.data.shuffle_split, seed=cfg.seed)
    task = cfg.data.task
    y_tr = np.array([r.y[task] for r in tr])
    lo, hi = float(y_tr.min()), float(y_tr.max())
    mean = float(ts.mean[task])
    std = float(ts.std[task])
    acc = float(ts.accuracy[task])
    errs, ys = val_errors(cfg, model.eval(), va, mean, std)
    in_mask = (ys >= lo) & (ys <= hi)

    def ratio(mask):
        return float(errs[mask].mean() / acc) if mask.any() else None

    out = {
        "train_target_range": [lo, hi],
        "val_count": int(len(ys)),
        "val_in_range_count": int(in_mask.sum()),
        "val_out_of_range_count": int((~in_mask).sum()),
        "val_error_ratio_overall": float(errs.mean() / acc),
        "val_error_ratio_in_range": ratio(in_mask),
        "val_error_ratio_out_of_range": ratio(~in_mask),
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "range_split.json"), "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    log(f"=== range split: {out}")
    return out


def run_one(name: str, cfg: TrainConfig, banded: bool = True,
            init_params=None):
    """Trains one RUNS entry (cfg: its configuration, possibly cut) into
    cfg.log_path, default runs/<name>_torch, cleared first, from
    init_params (run_experiment's) or the seeded draw. Returns (model,
    history, record); record (quality.json when banded) holds the card,
    the minutes, the kernels' launches, K for the CCN runs and, when
    banded, judge()'s verdict."""
    cfg.log_path = cfg.log_path or out_dir(name)
    _clear(cfg.log_path)
    dev = harness_device(cfg.device)
    log(f"=== {name} ({cfg.model.arch}, {cfg.epochs} epochs)")
    before = launches()
    t0 = time.perf_counter()
    model, history = common.run_experiment(cfg, init_params=init_params)
    minutes = (time.perf_counter() - t0) / 60.0
    want = cfg.epochs + (1 if cfg.bn_recalibrate else 0)
    assert len(history) == want, (name, len(history))
    log(f"=== {name} final: "
        f"{ {k: round(v, 4) for k, v in history[-1].items()} }")
    record = {"card": card(dev), "minutes": minutes, "epochs": cfg.epochs,
              "rows": len(history),
              "launches": {k: n - before[k] for k, n in launches().items()}}
    if cfg.model.arch in ("ccn1d", "ccn2d"):
        records, *_ = common.load_records(cfg)
        train_recs = synthetic.split_80_10_10(
            records, shuffle=cfg.data.shuffle_split, seed=cfg.seed)[0]
        record["K"] = max(r.max_degree() + 1 for r in train_recs)
        record["ccn_kernel"] = bool(cfg.model.ccn_kernel)
    if name in RANGE_SPLIT:
        record["range_split"] = range_split_eval(cfg, model, cfg.log_path)
    if banded:
        record.update(judge(name, history))
        with open(os.path.join(cfg.log_path, "quality.json"), "w") as f:
            json.dump(record, f, indent=2)
            f.write("\n")
        log(f"=== {name}: in band {record['in_band']}")
    return model, history, record


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    harness_device(args.device)
    names = args.only or list(RUNS)
    if args.only is None:
        # the regression floors of both dataset sizes used below
        for n, out in FLOORS:
            regression_floor.main(["--n", str(n), "--out", out])
    records = {}
    for name in names:
        cfg = RUNS[name]()
        cfg.device = args.device
        _, _, records[name] = run_one(name, cfg)
    return records


if __name__ == "__main__":
    main()
