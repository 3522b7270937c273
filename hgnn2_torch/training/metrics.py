"""Metrics and experiment logging (counterpart of
hgnn2_tpu/training/metrics.py).

The run directory is never wiped; results stream to results.jsonl (and the
original implementation's results.txt format), settings go to
experiment.json.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any


class AverageMeter:
    """Streaming mean."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class RunningAverage:
    """EMA with momentum 0.1: val <- 0.9*new + 0.1*old."""

    def __init__(self, momentum: float = 0.1):
        self.momentum = momentum
        self.val = 0.0

    def update(self, val: float):
        if self.val == 0.0:
            self.val = float(val)
        else:
            self.val = (1 - self.momentum) * float(val) + self.momentum * self.val


class ExperimentLogger:
    """Writes experiment.json (settings), results.jsonl (one epoch per
    line), and results.txt under log_dir. Non-destructive."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.t0 = time.time()
        self.history: list[dict[str, Any]] = []

    def write_settings(self, cfg) -> None:
        with open(os.path.join(self.log_dir, "experiment.json"), "w") as f:
            if dataclasses.is_dataclass(cfg):
                f.write(json.dumps(dataclasses.asdict(cfg), indent=2) + "\n")
            else:
                f.write(json.dumps(cfg, indent=2) + "\n")

    def log_epoch(self, epoch: int, **metrics: float) -> dict:
        row = {"epoch": epoch, "wall_s": round(time.time() - self.t0, 2)}
        row.update({k: float(v) for k, v in metrics.items()})
        self.history.append(row)
        with open(os.path.join(self.log_dir, "results.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")
        with open(os.path.join(self.log_dir, "results.txt"), "a") as f:
            parts = " ".join(f"{k} {v:.6g}" for k, v in row.items() if k != "epoch")
            f.write(f"Epoch {epoch} : {parts}\n")
        return row

    def log_final(self, **metrics: float) -> None:
        with open(os.path.join(self.log_dir, "final.json"), "w") as f:
            f.write(json.dumps({k: float(v) for k, v in metrics.items()}, indent=2) + "\n")
