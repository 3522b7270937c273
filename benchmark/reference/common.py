"""What the plain references share.

A reference model module provides:

- ``param_spec(cfg)`` and ``buffer_spec(cfg)``: (name, shape) of each
  parameter and state buffer, named as the port's state_dict names them,
  so one flat draw of weights fills both sides;
- ``inputs(mols, device)``: the batch's operators or tables, rebuilt from
  the molecules;
- ``forward(params, buffers, inp, train, mm)``: (B, 1) outputs; ``mm`` is
  the matmul every product of the model goes through (``matmul`` in
  float32, ``matmul_tf32`` for the control).

Weights: every parameter N(0, 0.1) (the models' initializer), every BN
running mean N(0, 0.1) and running std exp(N(0, 0.1)), all in one draw of
a generator seeded from the run's seed (``draw_weights``).
"""

from __future__ import annotations

import numpy as np
import torch


def draw_weights(pspec, bspec, seed: int, device) -> tuple[dict, dict]:
    """The run's weights from one normal draw on ``device``, split over
    the parameters and buffers in the order of their names."""
    spec = sorted(pspec + bspec)
    total = sum(int(np.prod(s)) for _, s in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device) * 0.1
    out, off = {}, 0
    for name, shape in spec:
        n = int(np.prod(shape))
        out[name] = flat[off:off + n].view(shape).clone()
        off += n
    pnames = {n for n, _ in pspec}
    params = {k: v for k, v in out.items() if k in pnames}
    buffers = {k: (v.exp() if k.endswith(".std") else v)
               for k, v in out.items() if k not in pnames}
    return params, buffers


# -------------------------------------------------------------- precision


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 (10 mantissa bits, to nearest), kept in float32:
    what a TF32 tensor core reads of a float32 operand."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32 and float32 sums, and the
    backward's two products the same way: a float32 matmul run with TF32
    on."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(tf32_round(a), tf32_round(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        ga = torch.matmul(g, tf32_round(b).transpose(-1, -2))
        gb = torch.matmul(tf32_round(a).transpose(-1, -2), g)
        # broadcast batch axes sum back to the operand's shape
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        return ga, gb


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _TF32MatMul.apply(a, b)


def linear(x, w, b, mm):
    return mm(x, w.t()) + b


# ------------------------------------------------------------- training


def target_stats(mols, task: int) -> tuple[float, float]:
    """Mean and sample std (ddof 1) of the task's targets, each taken over
    the float32 (molecules, 13) targets along the molecules, as a training
    pipeline standardizes its targets."""
    y = np.stack([m.y for m in mols])
    return float(y.mean(axis=0)[task]), float(y.std(axis=0, ddof=1)[task])


def loss_fn(out, y, mean: float, std: float):
    """MSE of the outputs against the standardized targets, over the
    batch's molecules."""
    err = out[:, 0] - (y - mean) / (std + 1e-8)
    return (err * err).sum() / max(out.shape[0], 1)


def lr_at(cfg: dict, count: int, steps_per_epoch: int) -> float:
    """lr * damping^(epoch // epoch_step) at optimizer step ``count``."""
    epoch = count // max(steps_per_epoch, 1)
    return cfg["lr"] * cfg["lr_damping"] ** (epoch // max(cfg["epoch_step"], 1))


def train_steps(model, cfg: dict, params: dict, buffers: dict, chunks: list,
                mean: float, std: float, steps_per_epoch: int, device,
                mm=matmul, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> dict:
    """Adamax steps (mu = b1 mu + (1 - b1) g, nu = max(b2 nu, |g| + eps),
    p -= lr / (1 - b1^t) mu / nu) from ``params``, one a chunk of
    molecules. Returns each step's loss, the first step's gradients and
    the parameters after the last step."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grads = [], None
    task = cfg["task"]
    for t, mols in enumerate(chunks, start=1):
        inp = model.inputs(mols, device)
        y = torch.tensor([m.y[task] for m in mols], dtype=torch.float32,
                         device=device)
        loss = loss_fn(model.forward(p, buffers, inp, True, mm), y, mean, std)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()),
                                                allow_unused=True)))
        grads = {k: torch.zeros_like(p[k]) if g is None else g
                 for k, g in grads.items()}
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        lr = lr_at(cfg, t - 1, steps_per_epoch)
        with torch.no_grad():
            for k in p:
                g = grads[k]
                mu[k] = b1 * mu[k] + (1 - b1) * g
                nu[k] = torch.maximum(b2 * nu[k], g.abs() + eps)
                p[k] -= lr / (1 - b1 ** t) * mu[k] / nu[k]
    return {"losses": losses, "grads": first_grads,
            "params": {k: v.detach() for k, v in p.items()}}


@torch.no_grad()
def predict(model, params: dict, buffers: dict, mols: list, mean: float,
            std: float, device, mm=matmul, block: int = 4096) -> np.ndarray:
    """Denormalized eval-mode predictions of ``mols``, ``block`` molecules
    a forward."""
    out = []
    for lo in range(0, len(mols), block):
        inp = model.inputs(mols[lo:lo + block], device)
        out.append(model.forward(params, buffers, inp, False, mm)[:, 0].cpu())
    return torch.cat(out).numpy() * std + mean
