"""Checkpoints of a training run (counterpart of
hgnn2_tpu/training/checkpoint.py, which saves through orbax).

One directory a step under ``directory``, holding one torch.save file:
the model's state_dict (BN running stats included), the optimizer's and
the LR scheduler's state_dicts, the step count and the epoch. The
scheduler is saved because it holds the schedule's count (optax keeps it
inside the optimizer state); without it a resumed run would restart the
LR decay. A checkpoint is written under a temporary name and renamed
into place, so a crash leaves the previous ones whole; the latest
max_to_keep are kept. As in orbax, a step at or below the latest saved
one is not written, so a run that reuses a directory without resuming
neither overwrites the run already there nor mixes its steps with it.
Loading maps every tensor to ``map_location`` (default the CPU), so a
checkpoint written on the card restores on a machine without one.
"""

from __future__ import annotations

import logging
import os
import shutil

import torch

from hgnn2_torch.training import optim

_FILE = "checkpoint.pt"

log = logging.getLogger("hgnn2_torch")


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        """The steps with a complete checkpoint, in increasing order."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isfile(
                          os.path.join(self.directory, name, _FILE)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save_tree(self, tree: dict, step: int) -> bool:
        """Save a dict of tensors, numbers and nested dicts at ``step``,
        then drop all but the latest max_to_keep. Skips the save, with a
        warning, when ``step`` is not above the latest step; returns
        whether it saved."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            log.warning("checkpoint at step %d skipped: %s already holds "
                        "step %d", step, self.directory, latest)
            return False
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".tmp-{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(tree, os.path.join(tmp, _FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore_tree(self, map_location="cpu") -> tuple[dict, int] | None:
        """(payload, step) of the latest checkpoint, or None when there is
        none."""
        step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, str(step), _FILE)
        return torch.load(path, map_location=map_location,
                          weights_only=True), step

    def save(self, model: torch.nn.Module, optimizer, scheduler,
             epoch: int) -> bool:
        """Save the whole training state after ``epoch`` epochs, at step
        ``epoch`` (skipped as save_tree says); returns whether it saved."""
        return self.save_tree({
            "model": model.state_dict(),
            "optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict(),
            "step": scheduler.last_epoch,
            "epoch": epoch,
        }, epoch)

    def restore(self, model: torch.nn.Module, optimizer=None,
                scheduler=None, map_location="cpu") -> int | None:
        """Load the latest checkpoint into model (and optimizer and
        scheduler, when given), each onto its own tensors' device. Returns
        the epoch it was saved after, or None when there is none."""
        restored = self.restore_tree(map_location)
        if restored is None:
            return None
        payload, _ = restored
        model.load_state_dict(payload["model"])
        if optimizer is not None:  # its lr and flags stay this device's
            optim.load_state(optimizer, payload["optimizer"])
        if scheduler is not None:
            scheduler.load_state_dict(payload["scheduler"])
        return int(payload["epoch"])
