"""Optimizers and LR schedules with optax's semantics (counterpart of
hgnn2_tpu/training/optim.py).

The JAX package builds optax.adamax / adam / sgd(momentum) under a step
schedule lr * damping^(epoch // epoch_step). torch.optim's Adamax, Adam
and SGD make the same updates:

- Adamax: both take nu = max(b2 * nu, |g| + eps) (eps inside the max) and
  step by lr / (1 - b1^t) * mu / nu.
- Adam: both divide the bias-corrected mu by sqrt(bias-corrected nu) +
  eps (eps outside the square root, after the bias correction).
- SGD: both keep buf = momentum * buf + g (first buf = g) and step by
  lr * buf.

They differ only in the order of the f32 operations. optax reads the
schedule at the count BEFORE it increments, so the first update uses
sched(0): here a LambdaLR holds that factor, and the caller steps it after
every optimizer.step(). tests/test_torch_ccn_train.py holds all three
optimizers to optax across a decay boundary.
"""

from __future__ import annotations

from typing import Iterable

import torch

from hgnn2_torch.training.config import OptimConfig


def stepped_decay(lr: float, damping: float, epoch_step: int,
                  steps_per_epoch: int):
    """lr * damping^(epoch // epoch_step) as a step-count schedule."""

    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        return lr * (damping ** (epoch // max(epoch_step, 1)))

    return schedule


def build_optimizer(cfg: OptimConfig, steps_per_epoch: int,
                    params: Iterable[torch.nn.Parameter]):
    """(optimizer, scheduler) for cfg.optim in {adamax, adam, sgd}. Call
    scheduler.step() after each optimizer.step(). Rebuilding both resets
    the moments and the schedule's count, as optax's tx.init does."""
    params = list(params)
    if cfg.optim == "adamax":
        opt = torch.optim.Adamax(params, lr=cfg.lr, betas=(0.9, 0.999),
                                 eps=1e-8)
    elif cfg.optim == "adam":
        opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                               eps=1e-8)
    elif cfg.optim == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum)
    else:
        raise ValueError(f"unknown optimizer {cfg.optim!r}")
    factor = stepped_decay(1.0, cfg.lr_damping, cfg.epoch_step,
                           steps_per_epoch)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
