"""Loss and error curves from results.jsonl (counterpart of
hgnn2_tpu/training/plots.py). Matplotlib is imported only when a plot is
drawn, so training runs where it is not installed.
"""

from __future__ import annotations

import json
import os


def load_history(log_dir: str) -> list[dict]:
    path = os.path.join(log_dir, "results.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def plot_history(log_dir: str, out_dir: str | None = None) -> list[str]:
    """Writes loss.png (and error.png / accuracy.png when those metrics
    are present). Returns the written paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    hist = load_history(log_dir)
    out_dir = out_dir or log_dir
    epochs = [h["epoch"] for h in hist]
    written = []

    groups = {
        "loss": ["train_loss", "valid_loss", "test_loss"],
        "error": ["train_mae", "valid_mae", "test_mae"],
        "accuracy": ["train_accuracy", "valid_accuracy", "test_accuracy"],
    }
    for name, keys in groups.items():
        present = [k for k in keys if any(k in h for h in hist)]
        if not present:
            continue
        fig, ax = plt.subplots(figsize=(6, 4))
        for k in present:
            ax.plot(epochs, [h.get(k) for h in hist], label=k)
        ax.set_xlabel("epoch")
        ax.set_ylabel(name)
        ax.legend()
        ax.grid(True, alpha=0.3)
        path = os.path.join(out_dir, f"{name}.png")
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        written.append(path)
    return written
