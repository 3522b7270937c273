"""Target statistics: per-task mean/std and chemical accuracy
(counterpart of hgnn2_tpu/data/stats.py). "Error ratio" = MAE on
normalized targets / chemical accuracy, the headline quality metric."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from hgnn2_torch.data.qm9 import CHEMICAL_ACCURACY
from hgnn2_torch.graphs import GraphRecord


@dataclasses.dataclass
class TargetStats:
    mean: np.ndarray  # (13,)
    std: np.ndarray  # (13,)
    accuracy: np.ndarray  # (13,)

    def normalize(self, y: np.ndarray, task: int) -> np.ndarray:
        """(y - mean) / std for one task."""
        s = self.std[task]
        if s < 1e-5:
            return y - self.mean[task]
        return (y - self.mean[task]) / s

    def error_ratio(self, mae: float, task: int) -> float:
        return float(mae / self.accuracy[task])

    def save(self, path: str) -> None:
        np.savez(path, mean=self.mean, std=self.std, accuracy=self.accuracy)

    @classmethod
    def load(cls, path: str) -> "TargetStats":
        z = np.load(path)
        return cls(mean=z["mean"], std=z["std"], accuracy=z["accuracy"])


def compute_target_stats(records: Sequence[GraphRecord]) -> TargetStats:
    ys = np.stack([r.y for r in records], axis=0)
    return TargetStats(
        mean=ys.mean(axis=0).astype(np.float32),
        std=ys.std(axis=0, ddof=1).astype(np.float32),
        accuracy=CHEMICAL_ACCURACY.copy(),
    )
