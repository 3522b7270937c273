"""Diagnoses the quality gap of the control run on the port (counterpart
of scripts/diagnose_quality_gap.py).

    python -m hgnn2_torch.scripts.diagnose_quality_gap [--device cuda|cpu]

The control run (validation_reg_gnn_control: the gnn regression with the
generator's exact target features appended to the node inputs, so the
least-squares floor is linearly readable through the stack's linear
branch) trains to a train error ratio near 1 and a valid ratio near 10
in JAX's runs. This script isolates where that gap comes from:

  A. linear probe: the same node-sum features, Adamax at the same lr,
     epochs, batch size and normalized targets, but a bare linear model
     y = w @ sum_n(x) + b. Landing near the floor clears the data, the
     normalization, the optimizer and the schedule: the gap arises inside
     the GNN stack.
  B. BN modes: the retrained control GNN on the valid split with
     train-mode BN (the batch's statistics) and eval-mode BN (the running
     ones). The train-mode pass runs on a copy of the model, so the
     running statistics stay as they were (JAX throws its update away).
  C. error shape: quantiles of the per-molecule error on the valid split.

Writes runs/validation_reg_gnn_control_torch/diagnosis.json, with the
card's name and power limit and the minutes of each part; the retrain
logs to runs/_diag_control_torch. Runs on the card unless given --device
cpu (no card: it raises).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np
import torch

from hgnn2_torch.cli import common
from hgnn2_torch.data import synthetic
from hgnn2_torch.scripts.profile_ccn1d_util import card, harness_device
from hgnn2_torch.scripts.run_validation import (FLOORS, RUNS, out_dir,
                                                val_errors)
from hgnn2_torch.training import optim
from hgnn2_torch.training.config import OptimConfig

CONTROL = "validation_reg_gnn_control"


def log(msg):
    print(f"[diagnose] {msg}", file=sys.stderr, flush=True)


def graph_features(records):
    """Node-sum features exactly as the sum readout would see them."""
    return np.stack([r.x.sum(axis=0) for r in records]).astype(np.float64)


def linear_probe(cfg, tr, va, ts, device="cpu"):
    """A. A bare linear model on the node-sum features, trained as JAX's
    is: Adamax at cfg's constant lr (optax.adamax, eps inside the max),
    zero init, float32, cfg.epochs epochs of the full batches of a
    default_rng(0) permutation each."""
    dev = torch.device(device)
    task = cfg.data.task
    mean, std = float(ts.mean[task]), float(ts.std[task])
    acc = float(ts.accuracy[task])
    Xtr, Xva = graph_features(tr), graph_features(va)
    ytr = (np.array([r.y[task] for r in tr]) - mean) / std
    yva = (np.array([r.y[task] for r in va]) - mean) / std
    w = torch.zeros(Xtr.shape[1], device=dev, requires_grad=True)
    b = torch.zeros((), device=dev, requires_grad=True)
    opt, _ = optim.build_optimizer(
        OptimConfig(optim="adamax", lr=cfg.optim.lr, lr_damping=1.0), 1,
        [w, b])
    Xtr_t = torch.tensor(Xtr, dtype=torch.float32, device=dev)
    ytr_t = torch.tensor(ytr, dtype=torch.float32, device=dev)
    n, bs = len(Xtr), cfg.batch_size
    rng = np.random.default_rng(0)
    for _ in range(cfg.epochs):
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        for i in range(0, n - bs + 1, bs):
            idx = order[i:i + bs]
            opt.zero_grad(set_to_none=False)
            loss = torch.mean((Xtr_t[idx] @ w + b - ytr_t[idx]) ** 2)
            loss.backward()
            opt.step()
    w_np, b_f = w.detach().cpu().numpy(), float(b.detach())

    def ratio(X, y):
        return float(np.abs(X @ w_np + b_f - y).mean() / acc)

    out = {"train_error_ratio": ratio(Xtr, ytr),
           "val_error_ratio": ratio(Xva, yva),
           "epochs": cfg.epochs, "lr": cfg.optim.lr,
           "optimizer": "adamax (same as the control run)"}
    log(f"A linear probe: {out}")
    return out


@torch.no_grad()
def bn_mode_eval(cfg, model, va, ts):
    """B/C. The trained model on the valid split with eval-mode BN and
    with train-mode BN. The train-mode pass runs on a deep copy, so
    ``model``'s BN running statistics do not move."""
    task = cfg.data.task
    mean, std = float(ts.mean[task]), float(ts.std[task])
    acc = float(ts.accuracy[task])
    res = {}
    for mode in ("eval", "train_stats"):
        m = model.eval() if mode == "eval" else copy.deepcopy(model).train()
        errs, _ = val_errors(cfg, m, va, mean, std)
        res[f"val_error_ratio_{mode}"] = float(errs.mean() / acc)
        if mode == "eval":
            q = np.quantile(errs / acc, [0.5, 0.9, 0.99, 1.0])
            res["val_error_ratio_quantiles_eval"] = {
                "p50": float(q[0]), "p90": float(q[1]),
                "p99": float(q[2]), "max": float(q[3])}
    log(f"B/C bn-mode + quantiles: {res}")
    return res


def _control_final():
    """The port's control run's last row, where it has been run."""
    path = os.path.join(out_dir(CONTROL), "final.json")
    if not os.path.exists(path):
        return None, None
    with open(path) as f:
        final = json.load(f)
    return (round(final["train_error_ratio"], 3),
            round(final["valid_error_ratio"], 3))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = harness_device(args.device)
    cfg = RUNS[CONTROL]()
    cfg.device = args.device
    cfg.log_path = os.path.join("runs", "_diag_control_torch")
    records, _kind, ts, _ = common.load_records(cfg)
    tr, va, _te = synthetic.split_80_10_10(
        records, shuffle=cfg.data.shuffle_split, seed=cfg.seed)

    train_ratio, valid_ratio = _control_final()
    diag = {"context": {
        "control_final_train_error_ratio": train_ratio,
        "control_final_val_error_ratio": valid_ratio,
        "lstsq_floor": os.path.join(FLOORS[1][1], "floor.json"),
    }, "card": card(dev)}
    t0 = time.perf_counter()
    diag["A_linear_probe"] = linear_probe(cfg, tr, va, ts, dev)
    diag["A_minutes"] = (time.perf_counter() - t0) / 60.0

    log("retraining the control GNN for the BN-mode eval "
        f"({cfg.epochs} epochs)...")
    t0 = time.perf_counter()
    model, history = common.run_experiment(cfg)
    diag["control_retrain_minutes"] = (time.perf_counter() - t0) / 60.0
    diag["control_retrain_final"] = {
        k: round(float(v), 4) for k, v in history[-1].items()}
    diag.update(bn_mode_eval(cfg, model, va, ts))

    out = out_dir(CONTROL)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "diagnosis.json"), "w") as f:
        json.dump(diag, f, indent=2, default=float)
        f.write("\n")
    log(json.dumps(diag, indent=1, default=float))
    return diag


if __name__ == "__main__":
    main()
