"""The work of a training step, counted from the molecules and the
model's shapes (never from the port's tables), one module a model
(work/<model>.py with ``batch_work(cfg, mols, k)``): ``flops``, the model's
forward multiply-adds x 2 times 3 (forward and backward) over the real
atoms, and ``bounds``, the least seconds of a kernel group's work at the
data-sheet peaks (benchmark.frozen.bound_s)."""

from __future__ import annotations

import importlib


def train_per_step(cfg: dict, chunks: list) -> dict:
    """The mean work of a step over one epoch's batches (lists of
    molecules)."""
    mod = importlib.import_module(f"benchmark.metrics.work.{cfg['model']}")
    k = max(mod.receptive_field(m) for ch in chunks for m in ch)
    per = [mod.batch_work(cfg, ch, k) for ch in chunks]
    names = {n for p in per for n in p["bounds"]}
    return {"flops": sum(p["flops"] for p in per) / len(per),
            "bounds": {n: sum(p["bounds"].get(n, 0.0) for p in per) / len(per)
                       for n in names}}
