"""Training/eval engine (counterpart of hgnn2_tpu/training/train.py).

A step is the forward, the loss, backward and the optimizer's update on
one batch, on the model's device. Losses follow the JAX package: MSE on
mean/std-normalized targets for regression, cross-entropy on 2 logits for
classification, both weighted by gmask (0 for batch-size padding graphs).
Metrics: MAE on the normalized scale, and error ratio = MAE / chemical
accuracy. Epoch metrics are means weighted by each batch's real-graph
count.

The JAX package compiles a step, or a whole same-shape group of steps,
into one XLA program. The port captures the same bodies as CUDA graphs
and replays them, under JAX's names:

- make_train_step: one graph a batch shape; each batch is copied into
  the graph's static buffers;
- make_multi_train_step: n_inner steps on one batch in one graph;
- make_scanned_epoch: one graph a step for each stacked shape group
  (group_stacked_batches). The graph picks its batch from the stack on
  the device (batch order[pos], then pos += 1) and adds the
  count-weighted metrics into device sums, so an epoch
  (run_epoch_scanned, in JAX's order) sends the device one permutation a
  group and no batch data, and fetches its metrics once;
- make_scanned_eval / evaluate_scanned and make_bn_recalibration /
  recalibrate_bn(groups=) do the same for eval and BN recalibration.

On the CPU each body runs eagerly: the same code, without a graph. A
graph is captured at its first call, after warm-up runs of its body on a
side stream (which build the kernels, cuBLAS's workspace and the
optimizer's lazily made state); the warm-up's changes to the parameters,
the buffers and the optimizer's state are then put back in place, so the
first replay starts from the state the eager steps would. Everything that
lives from one replay to the next (parameters, buffers, gradients,
optimizer state, the stacks, sums and positions) is allocated outside the
graphs, so the graphs of a model can share one memory pool and replay in
any order. The learning rate is a device tensor (training.optim) that the
host's schedule fills between replays.

fit trains through these programs; a capture that fails raises. The eager
train_step, run_epoch and evaluate stay as library functions.

While a torch.profiler session records, the host's part is in spans
(profiling.span): hgnn2.epoch around run_epoch_scanned, hgnn2.fetch around
its metrics fetch, hgnn2.scan around a group's run in _scanned,
hgnn2.graph.replay around each replay (each body's run on the CPU) and
hgnn2.schedule around the host's step between replays.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from hgnn2_torch import profiling
from hgnn2_torch.parallel import spmd
from hgnn2_torch.training import metrics as metrics_lib
from hgnn2_torch.training import optim
from hgnn2_torch.training.checkpoint import Checkpointer
from hgnn2_torch.training.config import TrainConfig
from hgnn2_torch.training.preemption import GracefulShutdown
from hgnn2_torch.training.prefetch import prefetch

log = logging.getLogger("hgnn2_torch")

WARMUP_RUNS = 2  # eager runs of a body on the side stream before its capture

# one CUDA graph memory pool a model, made at its first capture: a model's
# graphs replay one at a time, so they share it
_POOLS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _loss_and_metrics(out, y, gmask, kind: str, mean: float, std: float):
    """The batch's loss and metric. Their sums and the graph count pass
    through one spmd.psum over "data": the identity, unless the step runs
    inside a grid whose "data" axis spans processes."""
    if kind == "classification":
        per = F.cross_entropy(out, y.long(), reduction="none")
        name, metric = "accuracy", out.argmax(-1) == y
    else:
        err = out[:, 0] - (y - mean) / (std + 1e-8)
        per, name, metric = err ** 2, "mae", err.abs()
    sums = spmd.psum(torch.stack([(per * gmask).sum(), (metric * gmask).sum(),
                                  gmask.sum()]), "data")
    denom = sums[2].clamp_min(1.0)
    loss = sums[0] / denom
    return loss, {"loss": loss, name: sums[1] / denom}


def _graph_mask(batch) -> torch.Tensor:
    """1.0 for a real graph, 0.0 for batch-size padding: the batch's gmask
    where it has one (CCN batches), else n_nodes > 0 (dense batches)."""
    if hasattr(batch, "gmask"):
        return batch.gmask
    return (batch.n_nodes > 0).float()


def _train_body(model, optimizer, batch, kind: str, mean: float,
                std: float, grid=None) -> dict:
    """One optimizer step's device work (JAX's _train_body), the body of
    every train program. Gradients are zeroed in place, not dropped, so
    a captured step keeps writing the same gradient tensors. Inside
    ``grid`` (a parallel.spmd.RankGrid) the loss's sums cross its
    processes and spmd.backward sums the gradients once over them.
    Returns the batch's metrics from the forward before the update."""
    model.train()
    optimizer.zero_grad(set_to_none=False)
    with grid or contextlib.nullcontext():
        out = model(batch)
        loss, mets = _loss_and_metrics(out, batch.y, _graph_mask(batch), kind,
                                       mean, std)
        spmd.backward(loss, grid, model.parameters())
    optimizer.step()
    return {k: v.detach() for k, v in mets.items()}


def train_step(model, optimizer, scheduler, batch, kind: str = "regression",
               mean: float = 0.0, std: float = 1.0, grid=None) -> dict:
    """One eager optimizer step on one batch, then one schedule step.
    Returns the batch's metrics (on the device, from the forward before
    the update)."""
    mets = _train_body(model, optimizer, batch, kind, mean, std, grid)
    scheduler.step()
    return mets


@torch.inference_mode()
def eval_step(model, batch, kind: str = "regression", mean: float = 0.0,
              std: float = 1.0) -> dict:
    model.eval()
    out = model(batch)
    gmask = _graph_mask(batch)
    _, mets = _loss_and_metrics(out, batch.y, gmask, kind, mean, std)
    mets["count"] = gmask.sum()
    return mets


# ---------------------------------------------------------------- batches


def _tensor_fields(batch) -> list[str]:
    return [f.name for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), torch.Tensor)]


def _batch_key(batch) -> tuple:
    """What a program of this batch is specialised to: each tensor field's
    shape and dtype, and every other field's value (a packed batch's
    n_graphs, which the forward reads; None for an absent field)."""
    key = []
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        key.append((f.name, tuple(v.shape), v.dtype)
                   if isinstance(v, torch.Tensor) else (f.name, v))
    return tuple(key)


def group_batches(batches) -> list[list]:
    """Same-shape batches grouped in first-appearance order (the groups
    the JAX package stacks for its scanned epochs)."""
    groups: dict = {}
    for b in batches:
        groups.setdefault(_batch_key(b), []).append(b)
    return list(groups.values())


def group_stacked_batches(batches) -> list:
    """JAX's group_stacked_batches: the same-shape groups of ``batches``
    in first-appearance order, each one batch whose tensor fields are the
    group's stacked on a new leading axis, on the batches' device. JAX's
    mesh argument shards each stack's batch axis over "data"; the port's
    ranks of one process share its device, so it needs none."""
    return [dataclasses.replace(g[0], **{
        name: torch.stack([getattr(b, name) for b in g])
        for name in _tensor_fields(g[0])}) for g in group_batches(batches)]


def _group_size(stacked) -> int:
    return getattr(stacked, _tensor_fields(stacked)[0]).shape[0]


def _select(stacked, idx: torch.Tensor):
    """The batch at idx (a one-element int64 tensor on the device) of a
    stacked group: one gather a field, no host sync."""
    return dataclasses.replace(stacked, **{
        name: getattr(stacked, name).index_select(0, idx)[0]
        for name in _tensor_fields(stacked)})


def _epoch_order(sizes: list[int], rng: np.random.Generator | None):
    """(group, permutation) pairs of one epoch as JAX's run_epoch_scanned
    draws them: rng shuffles the group order, then draws each group's
    permutation in turn; rng=None keeps every order."""
    group_order = np.arange(len(sizes))
    if rng is not None:
        rng.shuffle(group_order)
    for g in group_order:
        n = sizes[g]
        yield g, np.arange(n) if rng is None else rng.permutation(n)


def groups_in_order(groups: list[list], rng: np.random.Generator | None):
    """One epoch's batches of list groups (group_batches) in JAX's scanned
    order: the eager counterpart of run_epoch_scanned."""
    for g, order in _epoch_order([len(x) for x in groups], rng):
        for i in order:
            yield groups[g][i]


# ------------------------------------------------------------- CUDA graphs


class _Graphs:
    """CUDA graphs of bodies (functions of no argument that read and write
    fixed tensors), one a key, all in the model's memory pool. On the CPU,
    or when ``eager`` (a body with collectives across processes, which
    cannot be captured), a call runs the body. capture_s, pool_bytes and
    replays are for the records."""

    def __init__(self, model: torch.nn.Module, optimizer=None,
                 eager: bool = False):
        self.model, self.optimizer, self.eager = model, optimizer, eager
        self.cuda = next(model.parameters()).is_cuda and not eager
        self.graphs: dict = {}
        self.capture_s = 0.0
        self.replays = 0

    @property
    def pool_bytes(self) -> int:
        """Device memory the model's graph pool holds: the size of its
        segments (shared by every graph of the model; 0 before a
        capture)."""
        pool = _POOLS.get(self.model)
        if pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == tuple(pool))

    def _state(self) -> list[torch.Tensor]:
        ts = [*self.model.parameters(), *self.model.buffers()]
        if self.optimizer is not None:
            ts += [v for st in self.optimizer.state.values()
                   for v in st.values() if isinstance(v, torch.Tensor)]
        return ts

    def capture(self, key, body, before_run=None) -> None:
        """Capture body under key unless it is there (CUDA only).
        before_run() is called before each warm-up run (a scan puts its
        position back at its first step)."""
        if not self.cuda or key in self.graphs:
            return
        t0 = time.perf_counter()
        saved = {id(t): t.detach().clone() for t in self._state()}
        pool = _POOLS.get(self.model)
        if pool is None:
            pool = _POOLS[self.model] = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_RUNS):
                if before_run is not None:
                    before_run()
                body()
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        # thread_local: a prefetch thread may copy batches meanwhile
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            out = body()
        with torch.no_grad():  # tensors the warm-up made start from zero
            for t in self._state():
                src = saved.get(id(t))
                t.copy_(src) if src is not None else t.zero_()
        self.graphs[key] = (graph, out)
        self.capture_s += time.perf_counter() - t0

    def __call__(self, key, body):
        """Run body: replay its graph (captured at the first call) on
        CUDA, call it on the CPU, in the span hgnn2.graph.replay. Returns
        its (static) outputs."""
        if not self.cuda:
            with profiling.span("hgnn2.graph.replay"):
                return body()
        self.capture(key, body)
        graph, out = self.graphs[key]
        with profiling.span("hgnn2.graph.replay"):
            graph.replay()
        self.replays += 1
        return out


def _static_batch(statics: dict, key, batch):
    """The static buffers of key's graph, holding ``batch``'s values."""
    static = statics.get(key)
    if static is None:
        static = statics[key] = dataclasses.replace(batch, **{
            name: getattr(batch, name).clone()
            for name in _tensor_fields(batch)})
    else:
        for name in _tensor_fields(batch):
            getattr(static, name).copy_(getattr(batch, name))
    return static


def make_train_step(model, optimizer, scheduler, kind: str = "regression",
                    mean: float = 0.0, std: float = 1.0, grid=None):
    """JAX's make_train_step: step(batch) -> the batch's metrics. On CUDA
    one graph a batch shape holds the forward, the loss, the backward and
    the optimizer's update; each batch is copied into its static buffers
    and the schedule steps after the replay. On the CPU, train_step.
    grid: a parallel.spmd.RankGrid whose "data" axis spans processes
    (spmd.make_dp_train_step); its collectives cannot be captured, so its
    steps run eagerly. step.graphs holds the graphs."""
    graphs = _Graphs(model, optimizer, eager=bool(grid and grid.groups))
    statics: dict = {}

    def step(batch) -> dict:
        if not graphs.cuda:
            return train_step(model, optimizer, scheduler, batch, kind, mean,
                              std, grid)
        key = _batch_key(batch)
        static = _static_batch(statics, key, batch)
        mets = graphs(key, lambda: _train_body(model, optimizer, static,
                                               kind, mean, std, grid))
        scheduler.step()
        return {k: v.clone() for k, v in mets.items()}

    step.graphs, step.grid = graphs, grid
    return step


def make_multi_train_step(model, optimizer, scheduler,
                          kind: str = "regression", mean: float = 0.0,
                          std: float = 1.0, n_inner: int = 10):
    """JAX's make_multi_train_step: step(batch) runs n_inner optimizer
    steps on the batch and returns the last one's metrics; on CUDA in one
    graph. Each inner step takes the schedule's lr at its own count: the
    host sends the n_inner values before the replay, the graph copies
    each into the optimizer's lr tensor before its step, and the schedule
    then advances n_inner steps. The optimizer must come from
    build_optimizer (a tensor lr on CUDA)."""
    graphs = _Graphs(model, optimizer)
    statics: dict = {}
    held: dict = {}

    def step(batch) -> dict:
        if not graphs.cuda:
            for _ in range(n_inner):
                mets = train_step(model, optimizer, scheduler, batch, kind,
                                  mean, std)
            return mets
        key = _batch_key(batch)
        static = _static_batch(statics, key, batch)
        values = torch.tensor(
            [[base * fn(scheduler.last_epoch + j) for j in range(n_inner)]
             for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)],
            dtype=torch.float32).pin_memory()
        if "lrs" not in held:
            held["lrs"] = torch.empty(values.shape, device=static.y.device)
        lrs = held["lrs"]
        lrs.copy_(values, non_blocking=True)

        def body():
            for j in range(n_inner):
                for i, g in enumerate(optimizer.param_groups):
                    g["lr"].copy_(lrs[i, j])
                mets = _train_body(model, optimizer, static, kind, mean, std)
            return mets

        mets = graphs(key, body)
        for _ in range(n_inner):
            scheduler.step()
        return {k: v.clone() for k, v in mets.items()}

    step.graphs = graphs
    return step


class _Scan:
    """The device side of one stacked group's steps: the group's order,
    the position of the next step, and the sums its steps add into."""

    def __init__(self, stacked):
        self.stacked = stacked
        self.n = _group_size(stacked)
        dev = getattr(stacked, _tensor_fields(stacked)[0]).device
        self.order = torch.arange(self.n, device=dev)
        self.pos = torch.zeros(1, dtype=torch.int64, device=dev)
        self.names: list[str] = []
        self.sums: list[torch.Tensor] | None = None

    def batch(self):
        """The step's batch, order[pos] of the stack; pos += 1."""
        idx = self.order.index_select(0, self.pos)
        self.pos.add_(1)
        return _select(self.stacked, idx)

    def add(self, values: list[torch.Tensor]) -> None:
        if self.sums is None:  # the first run, eager (a warm-up on CUDA)
            self.sums = [torch.zeros_like(v) for v in values]
        torch._foreach_add_(self.sums, values)


def _scanned(graphs: _Graphs, body, after_step=None):
    """run(stacked, order=None) -> the group's _Scan after one run of body
    a batch of the stacked group, in ``order`` (a permutation of the
    group, default the stacked order): the sums and position are reset,
    the order sent to the device once, and body replayed (called on the
    CPU) once a step, each followed by after_step() on the host (span
    hgnn2.schedule); all but the capture in the span hgnn2.scan."""
    scans: dict = {}

    def run(stacked, order=None) -> _Scan:
        scan = scans.get(id(stacked))
        if scan is None:
            scan = scans[id(stacked)] = _Scan(stacked)

        def step():
            body(scan)

        graphs.capture(id(stacked), step, scan.pos.zero_)
        with profiling.span("hgnn2.scan"):
            if order is not None:
                src = torch.from_numpy(np.asarray(order, dtype=np.int64))
                if scan.order.is_cuda:
                    src = src.pin_memory()
                scan.order.copy_(src, non_blocking=scan.order.is_cuda)
            scan.pos.zero_()
            if scan.sums is not None:
                torch._foreach_zero_(scan.sums)
            for _ in range(scan.n):
                graphs(id(stacked), step)
                if after_step is not None:
                    with profiling.span("hgnn2.schedule"):
                        after_step()
        return scan

    run.graphs = graphs
    return run


def make_scanned_epoch(model, optimizer, scheduler, kind: str = "regression",
                       mean: float = 0.0, std: float = 1.0):
    """JAX's make_scanned_epoch: run(stacked, order) -> the metric SUMS of
    one stacked group's optimizer steps in ``order``, each weighted by its
    batch's real-graph count, plus "count" (device tensors). On CUDA one
    graph a group: it selects the step's batch from the stack on the
    device, runs the step and adds the weighted metrics into the sums;
    the schedule steps on the host after each replay. run.graphs holds
    the graphs."""

    def body(scan: _Scan) -> None:
        batch = scan.batch()
        mets = _train_body(model, optimizer, batch, kind, mean, std)
        count = _graph_mask(batch).sum()
        scan.names = [*mets, "count"]
        scan.add([torch.stack([*(v * count for v in mets.values()), count])])

    scanned = _scanned(_Graphs(model, optimizer), body, scheduler.step)

    def run(stacked, order) -> dict:
        scan = scanned(stacked, order)
        return dict(zip(scan.names, scan.sums[0]))

    run.graphs = scanned.graphs
    return run


def run_epoch_scanned(groups: list, scan_fn, rng=None) -> dict[str, float]:
    """JAX's run_epoch_scanned: one training epoch over stacked groups
    (group_stacked_batches) through scan_fn (make_scanned_epoch), rng
    shuffling the group order and each group's batch order as JAX's does
    (rng=None keeps both). Metrics are means weighted by real-graph count,
    fetched from the device once (span hgnn2.fetch: the host waits there
    until the device has run the epoch; span hgnn2.epoch around it all)."""
    sums: dict = {}
    with profiling.span("hgnn2.epoch"):
        for g, order in _epoch_order([_group_size(s) for s in groups], rng):
            for k, v in scan_fn(groups[g], order).items():
                sums[k] = v if k not in sums else sums[k] + v
        if not sums:
            return {}
        with profiling.span("hgnn2.fetch"):
            values = dict(zip(sums, torch.stack(list(sums.values())).tolist()))
    denom = max(values.pop("count"), 1.0)
    return {k: v / denom for k, v in values.items()}


def make_scanned_eval(model, kind: str = "regression", mean: float = 0.0,
                      std: float = 1.0):
    """JAX's make_scanned_eval: run(stacked) -> the group's eval metric
    sums, each batch's weighted by its real-graph count, plus "count"
    (float64 device tensors; JAX sums them on the host in float64). On
    CUDA one eval-mode graph a group."""

    def body(scan: _Scan) -> None:
        with torch.no_grad():
            model.eval()
            batch = scan.batch()
            gmask = _graph_mask(batch)
            _, mets = _loss_and_metrics(model(batch), batch.y, gmask, kind,
                                        mean, std)
            n = gmask.sum()
            scan.names = [*mets, "count"]
            scan.add([torch.stack([*(v * n for v in mets.values()),
                                   n]).double()])

    scanned = _scanned(_Graphs(model), body)

    def run(stacked) -> dict:
        scan = scanned(stacked)
        return dict(zip(scan.names, scan.sums[0]))

    run.graphs = scanned.graphs
    return run


def evaluate_scanned(groups: list, scan_eval_fn) -> dict[str, float]:
    """JAX's evaluate_scanned: evaluate over stacked groups, one program
    a group and ONE host fetch for all groups' metrics."""
    parts = [scan_eval_fn(stacked) for stacked in groups]
    if not parts:
        return {}
    names = list(parts[0])
    rows = torch.stack([torch.stack([p[k] for k in names])
                        for p in parts]).tolist()
    sums = {k: sum(row[i] for row in rows) for i, k in enumerate(names)}
    total = max(sums.pop("count"), 1.0)
    return {k: v / total for k, v in sums.items()}


def run_epoch(model, optimizer, scheduler, batches, kind: str = "regression",
              mean: float = 0.0, std: float = 1.0,
              step_fn=None) -> dict[str, float]:
    """One training epoch over ``batches``, step by step: step_fn(batch)
    (make_train_step) or, by default, the eager train_step. Metrics stay
    on the device until the epoch ends; each batch weighs by its
    real-graph count."""
    device_mets: list = []
    device_counts: list = []
    for batch in batches:
        device_mets.append(
            step_fn(batch) if step_fn is not None else
            train_step(model, optimizer, scheduler, batch, kind, mean, std))
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


def _recal_body(model, batch, bufs: list, scale: float) -> list:
    """One batch's own BN statistics: a no_grad train-mode forward against
    zeroed running stats, each stat / (1 - momentum)."""
    with torch.no_grad():
        model.train()
        torch._foreach_zero_(bufs)
        model(batch)
        return torch._foreach_mul(bufs, scale)


def make_bn_recalibration(model, momentum: float = 0.1):
    """JAX's make_bn_recalibration: run(stacked) -> (the sums over the
    group's batches of each buffer's own statistic, the batch count); on
    CUDA one graph a group."""
    bufs = list(model.buffers())
    scale = 1.0 / (1.0 - momentum)

    def body(scan: _Scan) -> None:
        scan.add(_recal_body(model, scan.batch(), bufs, scale))

    scanned = _scanned(_Graphs(model), body)

    def run(stacked):
        scan = scanned(stacked)
        return scan.sums, scan.n

    run.graphs = scanned.graphs
    return run


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

    groups: stacked groups (group_stacked_batches), each one program
    (make_bn_recalibration); loader: any iterable of batches, run eagerly.
    Give one of the two. A model without buffers (no BN) is left as it
    is."""
    bufs = list(model.buffers())
    if not bufs:
        return model
    totals, count = None, 0
    if groups is not None:
        recal = make_bn_recalibration(model, momentum)
        parts = [recal(stacked) for stacked in groups]
    else:
        scale = 1.0 / (1.0 - momentum)
        parts = [(_recal_body(model, b, bufs, scale), 1) for b in loader]
    for sums, n in parts:
        totals = (list(sums) if totals is None
                  else torch._foreach_add(totals, sums))
        count += n
    if count:
        with torch.no_grad():
            for v, t in zip(bufs, totals):
                v.copy_(t / count)
    return model.eval()


# -------------------------------------------------------------------- fit


def _eval_row(row: dict, model, eval_loaders, kind, mean, std, accuracy,
              eval_groups: dict, scan_eval_fn):
    """Adds each eval split's metrics (and error ratio) to row: through
    scan_eval_fn over its stacked groups where it has them, else
    evaluate over its loader."""
    for split in ("valid", "test"):
        loader = eval_loaders[split]
        if split in eval_groups:
            split_m = evaluate_scanned(eval_groups[split], scan_eval_fn)
        elif loader is not None and len(loader) > 0:
            split_m = evaluate(model, loader, kind, mean, std)
        else:
            continue
        for k, v in split_m.items():
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

    With cfg.scan_epochs (the default) and a loader of cached batches
    (batches()), as JAX's fit: the train and eval batches are stacked by
    shape (group_stacked_batches), each epoch runs run_epoch_scanned in
    JAX's order (shape groups and their members shuffled by one
    default_rng(cfg.seed), unless the loader does not shuffle), and the
    eval splits and BN recalibration run over their groups. Otherwise
    each epoch steps through the loader (make_train_step), the next
    batches built while a step runs. On CUDA every program is a CUDA
    graph, captured after the checkpoint restore; a re-deal of the
    batches captures the new groups.

    checkpointer saves the model, optimizer and schedule after every
    epoch; with cfg.resume the run starts from its latest checkpoint, at
    the epoch after it. As in the JAX package, a resumed run's shuffle
    generator and loader epoch counters start afresh, so its batch order
    is not that of an uninterrupted run. SIGTERM or SIGINT stops the run
    after the epoch under way, once it is saved. cfg.bn_recalibrate
    appends a row evaluated after recalibrate_bn.

    mesh: a parallel.spmd.RankGrid for data parallelism (cli --dp M), as
    in JAX: the loaders yield batches sharded over its "data" ranks
    (spmd.ShardedLoader) and the model is replicated to them. Its ranks
    share one device in this process, so every program is the
    single-device one (spmd.make_dp_train_step), scanned epochs included.
    A grid over processes raises: the multi-process steps are driven
    step by step (hgnn2_torch.scripts.dryrun_multihost), as JAX's CLI
    has no multi-process trainer."""
    if mesh is not None and mesh.groups:
        raise NotImplementedError(
            "fit trains over the ranks of one process; a grid over "
            "processes is driven step by step (spmd.make_dp_train_step, "
            "training.sharded.make_sharded_step_fns)")
    train_loader = make_loader("train")
    # built once: with CachedLoader the eval batches stay on the device
    eval_loaders = {split: make_loader(split) for split in ("valid", "test")}
    steps_per_epoch = len(train_loader)
    if hasattr(train_loader, "peek_sample"):
        sample = train_loader.peek_sample()
    else:  # as in the JAX package, this advances a shuffling loader's epoch
        sample = next(iter(train_loader))
    model.to(sample.x.device)
    if mesh is not None:
        spmd.replicate(mesh, model)
    optimizer, scheduler = optim.build_optimizer(cfg.optim, steps_per_epoch,
                                                 model.parameters())
    start_epoch = 0
    if checkpointer is not None and cfg.resume:
        restored = checkpointer.restore(model, optimizer, scheduler)
        if restored is not None:
            start_epoch = restored
            log.info("resumed from the checkpoint of epoch %d", start_epoch)

    # the programs are made after the restore, which replaces the
    # optimizer's state tensors
    # order-level shuffling of the scanned epochs; honour the cached
    # loader's shuffle setting (off -> deterministic batch order)
    shuffle_rng = (np.random.default_rng(cfg.seed)
                   if getattr(train_loader, "shuffle", True) else None)

    def build_train_groups():
        groups = group_stacked_batches(train_loader.batches())
        train_loader.release()  # the stacks hold the batches now
        return groups

    groups = scan_fn = scan_eval_fn = None
    eval_groups: dict = {}
    if cfg.scan_epochs and hasattr(train_loader, "batches"):
        groups = build_train_groups() or None
    if groups:
        scan_fn = make_scanned_epoch(model, optimizer, scheduler, kind, mean,
                                     std)
        scan_eval_fn = make_scanned_eval(model, kind, mean, std)
        for split, loader in eval_loaders.items():
            if loader is not None and hasattr(loader, "batches"):
                split_bs = loader.batches()
                if split_bs:
                    eval_groups[split] = group_stacked_batches(split_bs)
                    loader.release()
        log.info("scanned epochs: %d batch shape group(s)", len(groups))
    step_fn = make_train_step(model, optimizer, scheduler, kind, mean, std)
    if mesh is not None:
        step_fn = spmd.make_dp_train_step(step_fn, mesh)
    log.info("training: %d epochs x %d steps/epoch", cfg.epochs - start_epoch,
             steps_per_epoch)
    run_err = metrics_lib.RunningAverage()
    history = []
    with GracefulShutdown() as shutdown:
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            if cfg.optim.reset_each_epoch:
                optim.reset(optimizer, scheduler)  # optax's tx.init
            if groups:
                if (getattr(train_loader, "redeal_every", 0)
                        and train_loader.maybe_redeal()):
                    groups = build_train_groups()
                    scan_fn = make_scanned_epoch(model, optimizer, scheduler,
                                                 kind, mean, std)
                    log.info("epoch %d: re-dealt batches into %d group(s)",
                             epoch + 1, len(groups))
                train_m = run_epoch_scanned(groups, scan_fn, shuffle_rng)
            else:  # stepwise: the next batches built while a step runs
                train_m = run_epoch(model, optimizer, scheduler,
                                    prefetch(train_loader), kind, mean, std,
                                    step_fn=step_fn)
            if "mae" in train_m:
                run_err.update(train_m["mae"])
            row = {f"train_{k}": v for k, v in train_m.items()}
            if (epoch + 1) % cfg.eval_every == 0:
                _eval_row(row, model, eval_loaders, kind, mean, std, accuracy,
                          eval_groups, scan_eval_fn)
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
                       loader=None if groups else train_loader)
        row = dict(history[-1]) if history else {}
        _eval_row(row, model, eval_loaders, kind, mean, std, accuracy,
                  eval_groups, scan_eval_fn)
        row["bn_recalibrated"] = 1.0
        log.info("bn recalibrated over %d train batches: %s", steps_per_epoch,
                 {k: round(v, 4) for k, v in row.items()
                  if k.startswith(("valid_", "test_"))})
        history.append(row)
        if logger is not None:
            logger.log_epoch(cfg.epochs + 1, **row)
    return model, history
