"""Molecule-aligned sharded training (counterpart of
hgnn2_tpu/training/sharded.py): ``--edge_shards N``, composed with
batch-level data parallelism by ``--dp M --edge_shards N`` on one
(data = M, edge = N) grid of ranks.

Each minibatch is dealt into M data groups and each group into N shards,
molecules whole and edge-balanced (parallel.spmd.partition_records), and
packed per shard at capacities that are the worst shard's over the whole
split, so one static shape serves every step. No molecule spans two
shards, so every graph-operator apply stays inside its shard; the only
cross-rank sums are the BatchNorm statistics (the model is built with
bn_axis "edge", or ("data", "edge") under the hybrid) and the loss's and
metrics' sums, each through parallel.spmd.psum. So a step computes what
one global batch of the same molecules would, whatever M and N are.

Every rank sits on the run's device (cfg.device), and a step runs the
ranks of a stacked batch as one batch (spmd.flatten_shards): one set of
launches for all of them. On CUDA a step is one CUDA graph
(training.train's _Graphs), and an epoch replays it in epoch_order
(make_sharded_scan_epoch). The batch order is the JAX package's:
default_rng(seed + epoch) permutes the minibatches each epoch.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Sequence

import numpy as np
import torch

from hgnn2_torch import convert, resolve_device
from hgnn2_torch.parallel import spmd
from hgnn2_torch.training import metrics as metrics_lib
from hgnn2_torch.training import optim
from hgnn2_torch.training import train as train_lib
from hgnn2_torch.training.checkpoint import Checkpointer
from hgnn2_torch.training.config import TrainConfig
from hgnn2_torch.training.preemption import GracefulShutdown

log = logging.getLogger("hgnn2_torch")


@dataclasses.dataclass
class _ShardedLoaderBase:
    """Minibatches of molecule-aligned stacked shards, built once on
    ``device`` (default cuda) with capacities static across the split, so
    one step program serves every batch; the batch ORDER reshuffles each
    epoch. Subclasses implement _build(chunks, parts) from the per-chunk
    shard partitions.

    n_data > 1 is the hybrid layout: each minibatch splits into n_data
    data groups, each into n_shards shards, stacked to (n_data, n_shards,
    ...); with n_data == 1 the stacks are (n_shards, ...)."""

    records: Sequence
    batch_size: int
    n_shards: int
    task: int | None = None
    shuffle: bool = False
    seed: int = 0
    n_data: int = 1
    device: str | torch.device | None = None
    _batches: list = dataclasses.field(default_factory=list)
    _epoch: int = 0
    _n_batches: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)
        recs = list(self.records)
        chunks = [recs[s : s + self.batch_size]
                  for s in range(0, len(recs), self.batch_size)]
        # parts[chunk][data group][shard] -> records; data groups and
        # shards are both edge-balanced greedy partitions
        if self.n_data > 1:
            groups = [spmd.partition_records(c, self.n_data) for c in chunks]
            parts = [[spmd.partition_records(g, self.n_shards) for g in grp]
                     for grp in groups]
        else:
            parts = [[spmd.partition_records(c, self.n_shards)]
                     for c in chunks]
        self._build(chunks, parts)

    @property
    def lead(self) -> int:
        """The stacks' leading rank dims: 2 under the hybrid, else 1."""
        return 2 if self.n_data > 1 else 1

    @property
    def _row_device(self):
        """Where a data group's stack is built: the loader's device, or
        the host when the hybrid layout stacks the groups."""
        return "cpu" if self.n_data > 1 else self.device

    def _stack_rows(self, rows):
        """(n_data, n_shards, ...) when hybrid, (n_shards, ...) otherwise,
        on the loader's device."""
        if self.n_data > 1:
            return spmd.stack_shards(rows, self.device)
        return rows[0]

    def __len__(self) -> int:
        return len(self._batches) or self._n_batches

    def release(self) -> None:
        """Drop the per-batch tensors once the scanned path has stacked
        them; len() and epoch_order keep working from the recorded count.
        Iteration is the stepwise path's, which never releases."""
        self._n_batches = len(self._batches)
        self._batches = []

    def peek_sample(self):
        """The first stacked batch, without drawing an epoch's order."""
        return self._batches[0]

    def batches(self) -> list:
        """The stacked batches in deal order (empty after release())."""
        return self._batches

    def epoch_order(self) -> np.ndarray:
        """This epoch's batch permutation, default_rng(seed + epoch) when
        shuffling (which advances the epoch count), else the deal order;
        the scanned and the stepwise epochs take the same sequence."""
        order = np.arange(len(self))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
            self._epoch += 1
        return order

    def __iter__(self):
        for i in self.epoch_order():
            yield self._batches[i]


class ShardedPackedLoader(_ShardedLoaderBase):
    """Molecule-aligned packed shards for PackedGNN and PackedLGGNN."""

    def _build(self, chunks, parts):
        # static capacities: the worst shard's load over every minibatch
        # and data group
        vcap = ecap = gcap = 1
        for grp in parts:
            for part in grp:
                for shard in part:
                    vcap = max(vcap, sum(r.n_nodes for r in shard))
                    ecap = max(ecap, sum(r.n_dir_edges for r in shard))
                    gcap = max(gcap, len(shard))
        for chunk, grp in zip(chunks, parts):
            rows = [spmd.make_packed_shards(
                chunk, self.n_shards, node_capacity=vcap, edge_capacity=ecap,
                graphs_per_shard=gcap, task=self.task, parts=part,
                device=self._row_device) for part in grp]
            self._batches.append(self._stack_rows(rows))
        self.node_capacity, self.edge_capacity = vcap, ecap
        self.graphs_per_shard = gcap


class ShardedCCNLoader(_ShardedLoaderBase):
    """Vertex-sharded stacked CCN batches, molecules whole in a shard;
    K is the largest receptive field of the split's records."""

    def _build(self, chunks, parts):
        from hgnn2_torch.parallel import ccn_parallel

        k_max = max(r.max_degree() + 1 for r in self.records)
        vcap = gcap = 1
        for grp in parts:
            for part in grp:
                for shard in part:
                    vcap = max(vcap, sum(r.n_nodes for r in shard))
                    gcap = max(gcap, len(shard))
        for chunk, grp in zip(chunks, parts):
            rows = [ccn_parallel.make_ccn_shards(
                chunk, self.n_shards, k_max=k_max, vertex_capacity=vcap,
                graphs_per_shard=gcap, task=self.task, parts=part,
                device=self._row_device) for part in grp]
            self._batches.append(self._stack_rows(rows))
        self.k_max, self.vertex_capacity = k_max, vcap
        self.graphs_per_shard = gcap


def _local_metric_sums(out, batch, n_ranks: int, kind: str, mean: float,
                       std: float, axes=("edge",)):
    """spmd.metric_sums of the flattened stacked batch ``batch``, its
    graphs rank-major over n_ranks ranks: (num (2,), den), each summed
    over the ranks of ``axes``."""
    return spmd.metric_sums(out, batch.y, batch.gmask, kind, mean, std,
                            n_ranks, axes)


def _metric_names(num, den, kind: str) -> dict:
    den = den.clamp_min(1.0)
    second = "accuracy" if kind == "classification" else "mae"
    return {"loss": num[0] / den, second: num[1] / den}


def make_sharded_step_fns(model, mesh: spmd.RankGrid, optimizer, scheduler,
                          kind: str = "regression", mean: float = 0.0,
                          std: float = 1.0, axes: tuple = ("edge",)):
    """(train_step, eval_step) over stacked molecule-aligned shards.

    axes: the mesh axes of the stacks' leading dims, ("edge",) for
    (S, ...) stacks or ("data", "edge") for the hybrid (M, N, ...) layout,
    each stack checked against ``mesh`` (RankGrid.check);
    the loss's and metrics' sums and the model's BN statistics (bn_axis =
    axes) are summed over every rank of them, so the math is that of one
    global batch whatever the factorization. A grid over processes
    (multihost.global_mesh) takes this process's rows of the stack; its
    psums all-reduce across the processes, the gradients are summed over
    them (spmd.backward), and its steps run eagerly (gloo's collectives
    cannot be captured).

    train_step(stacked) -> metrics (device tensors, 'count' included):
    one optimizer step, then one schedule step; on CUDA one CUDA graph a
    batch shape, each batch copied into its static buffers.
    train_step.body(stacked) is the step's device work alone, returning
    the summed (num, den). eval_step(stacked) -> metrics with 'count'."""
    lead = len(axes)

    def body(stacked):
        model.train()
        optimizer.zero_grad(set_to_none=False)
        batch = spmd.flatten_shards(stacked, lead)
        n_ranks = batch.n_graphs // stacked.gmask.shape[lead]
        with mesh:
            num, den = _local_metric_sums(model(batch), batch, n_ranks, kind,
                                          mean, std, axes)
            spmd.backward(num[0] / den.clamp_min(1.0), mesh,
                          model.parameters())
        optimizer.step()
        return num.detach(), den.detach()

    # collectives across processes (gloo) cannot be captured: eager there
    graphs = train_lib._Graphs(model, optimizer, eager=bool(mesh.groups))
    statics: dict = {}

    def named(num, den) -> dict:
        mets = _metric_names(num, den, kind)
        mets["count"] = den
        return mets

    def train_step(stacked) -> dict:
        mesh.check(stacked, axes)
        if graphs.cuda:
            key = train_lib._batch_key(stacked)
            static = train_lib._static_batch(statics, key, stacked)
            num, den = graphs(key, lambda: body(static))
            num, den = num.clone(), den.clone()
        else:
            num, den = body(stacked)
        scheduler.step()
        return named(num, den)

    @torch.inference_mode()
    def eval_step(stacked) -> dict:
        mesh.check(stacked, axes)
        model.eval()
        batch = spmd.flatten_shards(stacked, lead)
        n_ranks = batch.n_graphs // stacked.gmask.shape[lead]
        with mesh:
            return named(*_local_metric_sums(model(batch), batch, n_ranks,
                                             kind, mean, std, axes))

    train_step.body, train_step.graphs, train_step.kind = body, graphs, kind
    train_step.model, train_step.optimizer = model, optimizer
    train_step.scheduler = scheduler
    return train_step, eval_step


def make_ccn_sharded_step_fns(model, mesh: spmd.RankGrid, optimizer,
                              scheduler, kind: str = "regression",
                              mean: float = 0.0, std: float = 1.0,
                              axes: tuple = ("edge",)):
    """(train_step, eval_step) over stacked vertex-sharded CCN batches.
    CCN models carry no batch statistics, so only the loss's and the
    metrics' sums cross ranks; the steps are make_sharded_step_fns',
    whose flattened batch runs the model's kernels (K1-K4 when it has
    them on) once for every rank."""
    return make_sharded_step_fns(model, mesh, optimizer, scheduler, kind,
                                 mean, std, axes)


def make_sharded_scan_epoch(train_step, mesh: spmd.RankGrid | None = None,
                            axes: tuple = ("edge",)):
    """Scanned epochs for the sharded trainer: (stack_batches(batches) ->
    stacked_all, run(stacked_all, order) -> the count-weighted epoch
    metric means, 0-d device tensors). The loaders give one static shape
    a run, so the epoch is one group (stack_batches checks each batch
    against ``mesh``, when given): on CUDA one CUDA graph of a sharded step
    (train_step.body), which takes its batch order[pos] from the stack on
    the device and adds the count-weighted metrics into device sums,
    replayed once a step in ``order`` with the schedule stepped on the
    host between replays; the caller fetches the means once an epoch. On
    the CPU the same body runs eagerly."""
    names = ["loss", "accuracy" if train_step.kind == "classification"
             else "mae"]

    def body(scan) -> None:
        num, den = train_step.body(scan.batch())
        mets = _metric_names(num, den, train_step.kind)
        scan.add([torch.stack([*(mets[k] * den for k in names), den])])

    scanned = train_lib._scanned(
        train_lib._Graphs(train_step.model, train_step.optimizer,
                          eager=train_step.graphs.eager), body,
        train_step.scheduler.step)

    def stack_batches(batches):
        if mesh is not None:
            for stacked in batches:
                mesh.check(stacked, axes)
        groups = train_lib.group_stacked_batches(batches)
        if len(groups) != 1:
            raise ValueError(f"sharded batches of {len(groups)} shapes; the "
                             "sharded loaders give one")
        return groups[0]

    def run(stacked_all, order) -> dict[str, torch.Tensor]:
        *sums, count = scanned(stacked_all, order).sums[0]
        return {k: v / count.clamp_min(1.0) for k, v in zip(names, sums)}

    run.graphs = scanned.graphs
    return stack_batches, run


def _eval_split(eval_step, loader) -> dict[str, float]:
    """Count-weighted means of a split's eval metrics, one host fetch."""
    parts = [eval_step(stacked) for stacked in loader]
    names = list(parts[0])
    rows = torch.stack([torch.stack([p[k] for k in names])
                        for p in parts]).tolist()
    sums, total = {}, 0.0
    for row in rows:
        mets = dict(zip(names, row))
        n = mets.pop("count")
        total += n
        for k, v in mets.items():
            sums[k] = sums.get(k, 0.0) + v * n
    return {k: v / max(total, 1.0) for k, v in sums.items()}


def fit_sharded(model: torch.nn.Module, cfg: TrainConfig, splits: dict,
                kind: str, mean: float = 0.0, std: float = 1.0,
                accuracy: float | None = None,
                logger: metrics_lib.ExperimentLogger | None = None,
                family: str = "packed", init_params=None):
    """A training run over molecule-aligned shards on cfg.dp x
    cfg.edge_shards ranks of cfg.device.

    family: "packed" (PackedGNN or PackedLGGNN built with bn_axis="edge",
    or ("data", "edge") when cfg.dp > 1) or "ccn" (CCN1D, CCN2D).
    splits: {"train": records, "valid": records, "test": records}.
    init_params: weights in the JAX models' flax layout (hgnn2_torch.
    convert; the packed models' whole variables dict) to start from in
    place of the model's own, as JAX's fit_sharded draws them from
    cfg.seed. cfg.scan_epochs replays one captured step an epoch
    (make_sharded_scan_epoch), else each step is a call of train_step;
    both take the loader's epoch_order. A checkpoint is written after
    every epoch under cfg.checkpoint_path; cfg.resume starts from the
    latest, with the loader's order drawn afresh, as in the JAX package.
    SIGTERM or SIGINT stops the run after the epoch under way, once it is
    saved. Valid and test are evaluated every cfg.eval_every epochs. As
    in the JAX package, bn_recalibrate and reset_each_epoch are not read
    here. Returns (model, history), history in fit's row schema less
    train_error_ratio, as JAX's fit_sharded."""
    n_shards = cfg.edge_shards
    n_data = max(cfg.dp, 1)
    dev = resolve_device(cfg.device)
    grid = spmd.RankGrid(n_data, n_shards, dev)
    axes = spmd.AXES if n_data > 1 else ("edge",)
    task = cfg.data.task if kind == "regression" else None
    loader_cls = ShardedCCNLoader if family == "ccn" else ShardedPackedLoader
    loaders = {
        split: loader_cls(
            recs, cfg.batch_size, n_shards, task=task,
            shuffle=split == "train" and cfg.data.shuffle_batches,
            seed=cfg.seed, n_data=n_data, device=dev) if recs else None
        for split, recs in splits.items()
    }
    train_loader = loaders["train"]
    if init_params is not None:
        model.load_state_dict(
            convert.ccn_params_from_flax(init_params) if family == "ccn"
            else convert.packed_variables_from_flax(init_params))
    model.to(dev)
    optimizer, scheduler = optim.build_optimizer(
        cfg.optim, len(train_loader), model.parameters())

    checkpointer = None
    start_epoch = 0
    if cfg.checkpoint_path:
        checkpointer = Checkpointer(cfg.checkpoint_path)
        if cfg.resume:
            restored = checkpointer.restore(model, optimizer, scheduler)
            if restored is not None:
                start_epoch = restored
                log.info("resumed edge-sharded training at epoch %d",
                         start_epoch)

    train_step, eval_step = make_sharded_step_fns(
        model, grid, optimizer, scheduler, kind, mean, std, axes)
    scan_stacked = scan_run = None
    if cfg.scan_epochs and train_loader.batches():
        stack_batches, scan_run = make_sharded_scan_epoch(train_step, grid,
                                                          axes)
        scan_stacked = stack_batches(train_loader.batches())
        train_loader.release()  # the stack holds the batches now
    history = []
    log.info("edge-sharded training: %s, %d epochs x %d steps%s",
             (f"{n_data} dp x {n_shards} shards" if n_data > 1
              else f"{n_shards} shards"),
             cfg.epochs, len(train_loader),
             " (scanned epochs)" if scan_run is not None else "")
    with GracefulShutdown() as shutdown:
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            if scan_run is not None:
                epoch_mets = scan_run(scan_stacked, train_loader.epoch_order())
            else:
                device_mets = [train_step(stacked) for stacked in train_loader]
                counts = torch.stack([m.pop("count") for m in device_mets])
                total = counts.sum().clamp_min(1.0)
                epoch_mets = {k: (torch.stack([m[k] for m in device_mets])
                                  * counts).sum() / total
                              for k in device_mets[0]}
            # count-weighted epoch means, one host fetch
            row = {f"train_{k}": v for k, v in zip(
                epoch_mets, torch.stack(list(epoch_mets.values())).tolist())}
            for split in ("valid", "test"):
                loader = loaders[split]
                if loader is None or (epoch + 1) % cfg.eval_every:
                    continue
                for k, v in _eval_split(eval_step, loader).items():
                    row[f"{split}_{k}"] = v
                    if k == "mae" and accuracy:
                        row[f"{split}_error_ratio"] = v / accuracy
            row["epoch_time_s"] = time.time() - t0
            history.append(row)
            log.info("epoch %d done in %.1fs: %s", epoch + 1,
                     row["epoch_time_s"],
                     {k: round(v, 4) for k, v in row.items()
                      if k != "epoch_time_s"})
            if logger is not None:
                logger.log_epoch(epoch + 1, **row)
            if checkpointer is not None:
                checkpointer.save(model, optimizer, scheduler, epoch + 1)
            if shutdown.requested:
                log.warning("stopping after epoch %d (signal); resume with "
                            "cfg.resume", epoch + 1)
                break
    return model, history
