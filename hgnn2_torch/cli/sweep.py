"""Hyperparameter sweep harness (counterpart of hgnn2_tpu/cli/sweep.py):
short runs over a (lr, L, h) grid through run_experiment, ranked by each
point's best valid metric, written as one JSON summary.

  python -m hgnn2_torch.cli.sweep --arch gnn --epochs 1 \
      --lrs 1e-3,3e-4 --Ls 5,15 --hs 1 --out runs/sweep
  python -m hgnn2_torch.cli.sweep --arch ccn1d --Ls 2 --hs 2 --device cpu
"""

import argparse
import dataclasses
import itertools
import json
import logging
import math
import os

from hgnn2_torch.cli import common
from hgnn2_torch.training.config import TrainConfig


def _floats(s):
    return [float(x) for x in s.split(",") if x]


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def _best_epoch_metrics(history):
    """Best value over epochs for every valid_* metric (min for losses /
    error ratios, max for accuracies), each tagged with its epoch. Finite
    values only — a diverged tail does not erase an earlier good epoch."""
    best = {}
    for epoch, row in enumerate(history, 1):
        for k, v in row.items():
            if not k.startswith("valid_") or not math.isfinite(v):
                continue
            better = (
                k not in best
                or (k.endswith("accuracy") and v > best[k])
                or (not k.endswith("accuracy") and v < best[k])
            )
            if better:
                best[k] = v
                best[k + "_epoch"] = epoch
    return best


def _score(row):
    """A point's rank key: its best-epoch valid error ratio, negated
    accuracy or loss (lower is better); non-finite scores rank last."""
    f = row["best"] or row["final"]
    if "valid_error_ratio" in f:
        v = f["valid_error_ratio"]
    elif "valid_accuracy" in f:
        v = -f["valid_accuracy"]
    else:
        v = f.get("valid_loss", float("inf"))
    return v if math.isfinite(v) else float("inf")


def main(argv=None):
    p = argparse.ArgumentParser(description="hyperparameter sweep")
    p.add_argument("--arch", default="gnn", choices=["gnn", "lggnn", "ccn1d", "ccn2d"])
    p.add_argument("--lrs", type=_floats, default=[1e-3, 3e-4])
    p.add_argument("--Ls", type=_ints, default=[5])
    p.add_argument("--hs", type=_ints, default=[1])
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--bs", type=int, default=30)
    p.add_argument("--J", type=int, default=1)
    p.add_argument("--update", type=int, default=1)
    p.add_argument("--task", type=int, default=0)
    p.add_argument("--dataset", default="qm9")
    p.add_argument("--data_path", default=None)
    p.add_argument("--n_synthetic", type=int, default=256)
    p.add_argument("--out", default="runs/sweep")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    log = logging.getLogger("hgnn2_torch")

    rows = []
    for lr, L, h in itertools.product(args.lrs, args.Ls, args.hs):
        cfg = TrainConfig(batch_size=args.bs, epochs=args.epochs,
                          device=args.device)
        cfg.model.arch = args.arch
        cfg.model.n_layers = L
        cfg.model.n_features = h
        cfg.model.J = args.J
        cfg.model.order = args.update
        cfg.optim.lr = lr
        cfg.data.dataset = args.dataset
        cfg.data.data_path = args.data_path
        cfg.data.n_synthetic = args.n_synthetic
        cfg.data.task = args.task
        name = f"lr{lr:g}_L{L}_h{h}"
        cfg.log_path = os.path.join(args.out, name)
        log.info("sweep point %s", name)
        _, history = common.run_experiment(cfg)
        final = dict(history[-1]) if history else {}
        rows.append({"name": name, "lr": lr, "L": L, "h": h,
                     "config": dataclasses.asdict(cfg), "final": final,
                     "best": _best_epoch_metrics(history),
                     "history": [dict(h_) for h_ in history]})

    # rank by the BEST-epoch valid metric: a point that peaked early and
    # then overfit still beats one that never got there
    rows.sort(key=_score)
    summary = {"arch": args.arch, "epochs": args.epochs,
               "best": rows[0]["name"] if rows else None, "points": rows}
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "sweep.json")
    with open(path, "w") as f:
        f.write(json.dumps(summary, indent=1) + "\n")
    log.info("sweep done: best=%s -> %s", summary["best"], path)
    print(json.dumps({"best": summary["best"],
                      "points": [r["name"] for r in rows]}))
    return summary


if __name__ == "__main__":
    main()
