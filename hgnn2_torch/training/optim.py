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

On CUDA the optimizers are built for CUDA graphs (training.train's
captured steps): the lr is a tensor on the params' device, Adamax and
Adam are capturable (their step counts and bias corrections stay on the
device) and SGD reads the lr tensor on the device, so a replayed step
takes the scheduled lr and the count from the device. The schedule's
step writes each new lr into that tensor in place (torch's LRScheduler
fills a tensor lr, in 2.11 as in 2.13), and load_state keeps the tensor
through a checkpoint restore. On the CPU the lr is a float, as torch's
optimizers need there.
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


class _DeviceLRSGD(torch.optim.SGD):
    """torch's SGD with momentum, its lr a device tensor: torch's SGD turns
    a tensor lr into a host number (.item()), which a CUDA graph cannot
    capture. The update is optax's: buf = momentum * buf + g (from a zero
    buf, so the first buf is g), p -= lr * buf."""

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if "momentum_buffer" not in self.state[p]:
                    self.state[p]["momentum_buffer"] = torch.zeros_like(p)
            bufs = [self.state[p]["momentum_buffer"] for p in params]
            torch._foreach_mul_(bufs, group["momentum"])
            torch._foreach_add_(bufs, [p.grad for p in params])
            torch._foreach_sub_(params, torch._foreach_mul(bufs, group["lr"]))


def build_optimizer(cfg: OptimConfig, steps_per_epoch: int,
                    params: Iterable[torch.nn.Parameter]):
    """(optimizer, scheduler) for cfg.optim in {adamax, adam, sgd}. Call
    scheduler.step() after each optimizer.step(). Rebuilding both resets
    the moments and the schedule's count, as optax's tx.init does;
    reset() does the same in place."""
    params = list(params)
    cuda = bool(params) and params[0].is_cuda
    lr = torch.tensor(cfg.lr, device=params[0].device) if cuda else cfg.lr
    if cfg.optim == "adamax":
        opt = torch.optim.Adamax(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, capturable=cuda)
    elif cfg.optim == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                               eps=1e-8, capturable=cuda)
    elif cfg.optim == "sgd":
        opt = (_DeviceLRSGD if cuda else torch.optim.SGD)(
            params, lr=lr, momentum=cfg.momentum)
    else:
        raise ValueError(f"unknown optimizer {cfg.optim!r}")
    factor = stepped_decay(1.0, cfg.lr_damping, cfg.epoch_step,
                           steps_per_epoch)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, factor)
    # plain numbers: each step then fills the lr tensor in place with one
    # value, no device multiply (torch writes a tensor lr in place)
    sched.base_lrs = [cfg.lr] * len(opt.param_groups)
    return opt, sched


def reset(optimizer, scheduler) -> None:
    """optax's tx.init in place: every moment and step count to zero, the
    schedule's count to 0 and the lr to its first value, each in the
    tensor that holds it (a captured step reads them there). A zero moment
    updates as a fresh optimizer's does, so this equals a rebuild."""
    for state in optimizer.state.values():
        for v in state.values():
            if isinstance(v, torch.Tensor):
                v.zero_()
    scheduler.last_epoch = 0
    for g, base, fn in zip(optimizer.param_groups, scheduler.base_lrs,
                           scheduler.lr_lambdas):
        _set_lr(g, base * fn(0))


def _set_lr(group: dict, value) -> None:
    if isinstance(group["lr"], torch.Tensor):
        group["lr"].fill_(value)
    else:
        group["lr"] = float(value)


def load_state(optimizer, state_dict: dict) -> None:
    """optimizer.load_state_dict, keeping what belongs to this optimizer's
    device: its lr (the same tensor on CUDA, a float on the CPU), its
    capturable flag, and step counts on the params' device when capturable.
    So a checkpoint written on the card restores on the CPU and back."""
    held = [(g["lr"], g.get("capturable")) for g in optimizer.param_groups]
    optimizer.load_state_dict(state_dict)
    for g, (lr, capturable) in zip(optimizer.param_groups, held):
        value = g["lr"]
        g["lr"] = lr
        _set_lr(g, value.item() if isinstance(value, torch.Tensor) else value)
        if capturable is not None:
            g["capturable"] = capturable
        for p in g["params"]:
            step = optimizer.state.get(p, {}).get("step")
            if step is not None:
                optimizer.state[p]["step"] = (
                    step.to(p.device, torch.float32) if capturable
                    else step.cpu())
