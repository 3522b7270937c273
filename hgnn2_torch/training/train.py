"""Training/eval engine (counterpart of hgnn2_tpu/training/train.py).

PyTorch runs eagerly, so a step is a plain function over a batch on the
model's device: forward, the loss, backward, optimizer step, schedule
step. Losses follow the JAX package: MSE on mean/std-normalized targets
for regression, cross-entropy on 2 logits for classification, both
weighted by gmask (0 for batch-size padding graphs). Metrics: MAE on the
normalized scale, and error ratio = MAE / chemical accuracy. Epoch
metrics are means weighted by each batch's real-graph count.

The JAX package's default epoch is one lax.scan per same-shape group of
cached batches, and its batch order is that of the scan: groups_in_order
reproduces it, so the port's default epoch visits the batches in the same
order without a scan.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch
import torch.nn.functional as F

from hgnn2_torch.training import metrics as metrics_lib
from hgnn2_torch.training.checkpoint import Checkpointer
from hgnn2_torch.training.config import TrainConfig
from hgnn2_torch.training.optim import build_optimizer
from hgnn2_torch.training.preemption import GracefulShutdown
from hgnn2_torch.training.prefetch import prefetch

log = logging.getLogger("hgnn2_torch")


def _loss_and_metrics(out, y, gmask, kind: str, mean: float, std: float):
    denom = gmask.sum().clamp_min(1.0)
    if kind == "classification":
        ce = F.cross_entropy(out, y.long(), reduction="none")
        loss = (ce * gmask).sum() / denom
        acc = ((out.argmax(-1) == y) * gmask).sum() / denom
        return loss, {"loss": loss, "accuracy": acc}
    pred = out[:, 0]
    t = (y - mean) / (std + 1e-8)
    err = pred - t
    loss = ((err ** 2) * gmask).sum() / denom
    mae = (err.abs() * gmask).sum() / denom
    return loss, {"loss": loss, "mae": mae}


def _graph_mask(batch) -> torch.Tensor:
    """1.0 for a real graph, 0.0 for batch-size padding: the batch's gmask
    where it has one (CCN batches), else n_nodes > 0 (dense batches)."""
    if hasattr(batch, "gmask"):
        return batch.gmask
    return (batch.n_nodes > 0).float()


def train_step(model, optimizer, scheduler, batch, kind: str = "regression",
               mean: float = 0.0, std: float = 1.0) -> dict:
    """One optimizer step on one batch. Returns the batch's metrics (on
    the device, from the forward before the update)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    out = model(batch)
    loss, mets = _loss_and_metrics(out, batch.y, _graph_mask(batch), kind,
                                   mean, std)
    loss.backward()
    optimizer.step()
    scheduler.step()
    return {k: v.detach() for k, v in mets.items()}


@torch.inference_mode()
def eval_step(model, batch, kind: str = "regression", mean: float = 0.0,
              std: float = 1.0) -> dict:
    model.eval()
    out = model(batch)
    gmask = _graph_mask(batch)
    _, mets = _loss_and_metrics(out, batch.y, gmask, kind, mean, std)
    mets["count"] = gmask.sum()
    return mets


def group_batches(batches) -> list[list]:
    """Same-shape batches grouped in first-appearance order (the groups
    the JAX package stacks for its scanned epochs)."""
    groups: dict = {}
    for b in batches:
        key = tuple((f.name, tuple(getattr(b, f.name).shape))
                    for f in dataclasses.fields(b)
                    if isinstance(getattr(b, f.name), torch.Tensor))
        groups.setdefault(key, []).append(b)
    return list(groups.values())


def groups_in_order(groups: list[list], rng: np.random.Generator | None):
    """One epoch's batch order as the JAX package's run_epoch_scanned takes
    it: rng shuffles the group order, then draws each group's permutation
    in turn; rng=None keeps every order."""
    group_order = np.arange(len(groups))
    if rng is not None:
        rng.shuffle(group_order)
    for g in group_order:
        n = len(groups[g])
        order = np.arange(n) if rng is None else rng.permutation(n)
        for i in order:
            yield groups[g][i]


def run_epoch(model, optimizer, scheduler, batches, kind: str = "regression",
              mean: float = 0.0, std: float = 1.0) -> dict[str, float]:
    """One training epoch over ``batches``. Metrics stay on the device
    until the epoch ends; each batch weighs by its real-graph count."""
    device_mets: list = []
    device_counts: list = []
    for batch in batches:
        device_mets.append(train_step(model, optimizer, scheduler, batch,
                                      kind, mean, std))
        device_counts.append(_graph_mask(batch).sum())
    if not device_mets:
        return {}
    counts = torch.stack(device_counts)
    total = counts.sum().clamp_min(1.0)
    return {k: float((torch.stack([m[k] for m in device_mets]) * counts).sum()
                     / total)
            for k in device_mets[0]}


def evaluate(model, loader, kind: str = "regression", mean: float = 0.0,
             std: float = 1.0) -> dict[str, float]:
    """Metrics over a split, each batch weighted by its real-graph count.
    The sums stay on the device until the split ends: one host sync."""
    sums: dict[str, torch.Tensor] = {}
    total = None
    for batch in loader:
        mets = eval_step(model, batch, kind, mean, std)
        n = mets.pop("count")
        total = n if total is None else total + n
        for k, v in mets.items():
            sums[k] = v * n if k not in sums else sums[k] + v * n
    if total is None:
        return {}
    *values, total = torch.stack([*sums.values(), total]).tolist()
    return {k: v / max(total, 1.0) for k, v in zip(sums, values)}


def recalibrate_bn(model: torch.nn.Module, groups=None, loader=None,
                   momentum: float = 0.1) -> torch.nn.Module:
    """Replaces the BN running statistics with the average of every
    train batch's own statistics, then puts the model in eval mode.

    The running statistics are an EMA that weighs the last batch seen by
    1 - momentum = 90 %, so eval-mode metrics follow whichever batch an
    epoch ended on; this pass (BN re-estimation) removes that. Each batch
    runs one no_grad train-mode forward against zeroed running stats, so
    the update (1 - momentum) * batch + momentum * 0 leaves (1 - momentum)
    x its own statistics; those are scaled by 1 / (1 - momentum), summed
    and divided by the batch count, the JAX package's arithmetic.

    groups: lists of batches (fit's shape groups); loader: any iterable
    of batches. Give one of the two. A model without buffers (no BN) is
    left as it is."""
    bufs = dict(model.named_buffers())
    if not bufs:
        return model
    batches = (b for g in groups for b in g) if groups is not None else loader
    scale = 1.0 / (1.0 - momentum)
    totals = {k: torch.zeros_like(v) for k, v in bufs.items()}
    count = 0
    model.train()
    with torch.no_grad():
        for batch in batches:
            for v in bufs.values():
                v.zero_()
            model(batch)
            for k, v in bufs.items():
                totals[k] += v * scale
            count += 1
        if count:
            for k, v in bufs.items():
                v.copy_(totals[k] / count)
    return model.eval()


def _eval_row(row: dict, model, eval_loaders, kind, mean, std, accuracy):
    """Adds each eval split's metrics (and error ratio) to row."""
    for split in ("valid", "test"):
        loader = eval_loaders[split]
        if loader is None or len(loader) == 0:
            continue
        for k, v in evaluate(model, loader, kind, mean, std).items():
            row[f"{split}_{k}"] = v
            if k == "mae" and accuracy:
                row[f"{split}_error_ratio"] = v / accuracy


def fit(
    model: torch.nn.Module,
    make_loader,
    cfg: TrainConfig,
    kind: str = "regression",
    mean: float = 0.0,
    std: float = 1.0,
    accuracy: float | None = None,
    logger: metrics_lib.ExperimentLogger | None = None,
    checkpointer: Checkpointer | None = None,
    mesh=None,
):
    """Full training run. make_loader(split) -> iterable of batches for
    split in {"train", "valid", "test"} (or None); must yield at least one
    train batch. The model moves to the device of the train batches.
    Returns (model, history): one dict of metrics per epoch run.

    checkpointer saves the model, optimizer and schedule after every
    epoch; with cfg.resume the run starts from its latest checkpoint, at
    the epoch after it. As in the JAX package, a resumed run's shuffle
    generator and loader epoch counters start afresh, so its batch order
    is not that of an uninterrupted run. SIGTERM or SIGINT stops the run
    after the epoch under way, once it is saved. cfg.bn_recalibrate
    appends a row evaluated after recalibrate_bn. Meshes (the parallel
    slice) raise."""
    if mesh is not None:
        raise NotImplementedError("meshes come with the parallel slice")
    train_loader = make_loader("train")
    # built once: with CachedLoader the eval batches stay on the device
    eval_loaders = {split: make_loader(split) for split in ("valid", "test")}
    steps_per_epoch = len(train_loader)
    if hasattr(train_loader, "peek_sample"):
        sample = train_loader.peek_sample()
    else:  # as in the JAX package, this advances a shuffling loader's epoch
        sample = next(iter(train_loader))
    model.to(sample.x.device)
    optimizer, scheduler = build_optimizer(cfg.optim, steps_per_epoch,
                                           model.parameters())
    start_epoch = 0
    if checkpointer is not None and cfg.resume:
        restored = checkpointer.restore(model, optimizer, scheduler)
        if restored is not None:
            start_epoch = restored
            log.info("resumed from the checkpoint of epoch %d", start_epoch)

    # order-level shuffling of the grouped epochs; honour the cached
    # loader's shuffle setting (off -> deterministic batch order)
    shuffle_rng = (np.random.default_rng(cfg.seed)
                   if getattr(train_loader, "shuffle", True) else None)

    def build_train_groups():
        groups = group_batches(train_loader.batches())
        train_loader.release()  # the groups hold the batches now
        return groups

    groups = None
    if cfg.scan_epochs and hasattr(train_loader, "batches"):
        groups = build_train_groups() or None
        if groups:
            log.info("grouped epochs: %d batch shape group(s)", len(groups))
    log.info("training: %d epochs x %d steps/epoch", cfg.epochs - start_epoch,
             steps_per_epoch)
    run_err = metrics_lib.RunningAverage()
    history = []
    with GracefulShutdown() as shutdown:
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            if cfg.optim.reset_each_epoch:
                # optax's tx.init: fresh moments and a schedule back at 0
                optimizer, scheduler = build_optimizer(
                    cfg.optim, steps_per_epoch, model.parameters())
            if groups is not None:
                if (getattr(train_loader, "redeal_every", 0)
                        and train_loader.maybe_redeal()):
                    groups = build_train_groups()
                    log.info("epoch %d: re-dealt batches into %d group(s)",
                             epoch + 1, len(groups))
                batches = groups_in_order(groups, shuffle_rng)
            else:  # stepwise: the next batches built while a step runs
                batches = prefetch(train_loader)
            train_m = run_epoch(model, optimizer, scheduler, batches, kind,
                                mean, std)
            if "mae" in train_m:
                run_err.update(train_m["mae"])
            row = {f"train_{k}": v for k, v in train_m.items()}
            if (epoch + 1) % cfg.eval_every == 0:
                _eval_row(row, model, eval_loaders, kind, mean, std, accuracy)
            row["epoch_time_s"] = time.time() - t0
            log.info("epoch %d done in %.1fs: %s", epoch + 1,
                     row["epoch_time_s"],
                     {k: round(v, 4) for k, v in row.items()
                      if k != "epoch_time_s"})
            if accuracy and "mae" in train_m:
                row["train_error_ratio"] = run_err.val / accuracy
            history.append(row)
            if logger is not None:
                logger.log_epoch(epoch + 1, **row)
            if checkpointer is not None:
                checkpointer.save(model, optimizer, scheduler, epoch + 1)
            if shutdown.requested:
                log.warning("stopping after epoch %d (signal); resume with "
                            "cfg.resume", epoch + 1)
                break
    if cfg.bn_recalibrate and next(model.buffers(), None) is not None:
        recalibrate_bn(model, groups=groups,
                       loader=None if groups is not None else train_loader)
        row = dict(history[-1]) if history else {}
        _eval_row(row, model, eval_loaders, kind, mean, std, accuracy)
        row["bn_recalibrated"] = 1.0
        log.info("bn recalibrated over %d train batches: %s", steps_per_epoch,
                 {k: round(v, 4) for k, v in row.items()
                  if k.startswith(("valid_", "test_"))})
        history.append(row)
        if logger is not None:
            logger.log_epoch(cfg.epochs + 1, **row)
    return model, history
