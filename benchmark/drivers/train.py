"""The training driver: the port's captured epochs (make_scanned_epoch +
run_epoch_scanned over resident batches stacked by shape, the CLI's
default path), timed over the window, then held to the plain reference.

Set-up builds one training object (model, Adamax, schedule, scan) from
the seed and warms it: one call of each shape group's scan captures its
CUDA graph, and the model, its buffers, Adamax and the schedule are then
put back to their first values (optim.reset and in-place copies, as the
port's own capture does after its warm-up). The same object then takes
its first steps through the window's own call, each group's batches in
an order drawn from the seed: one step of every smaller group, each from
the first state and put back after, then three of the largest group,
whose state the window takes on. The schedule's hook reads the program's
per-step metric sums, Adamax's moments after a run's first step and the
parameters after its last. The window runs whole epochs in the port's
order until --seconds have passed; it ends at the sync of the last
epoch's metrics fetch.

After the window and the memory reading, the reference follows each of
those runs from the same weights on the same molecules, rebuilding every
operator, and compare()'s numbers, the worst run's, are held to the
cell's limits.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import time

import numpy as np
import torch

from benchmark import frozen, tracing
from benchmark.metrics import work
from benchmark.reference import common

N_CHECKED = 3  # first steps the reference follows
BETA1 = 0.9  # Adamax's b1 (hgnn2_torch/training/optim.py)
POOL_SEED = 0  # the molecules every seed shares


@functools.lru_cache(maxsize=1)
def _pool(n: int) -> tuple:
    return tuple(frozen.synthetic_qm9_like(n, POOL_SEED))


def molecules(n: int, seed: int) -> list:
    """The training pool: the same n molecules for every seed, in an order
    drawn from the seed. So every seed has the same sizes, node buckets
    and memory (seeded pools split the GNN's batches 28 + 4 or 27 + 5 and
    its peak 289.7 or 297.8 MB), and another deal into batches. The pool
    is made once a process (control.py reads many seeds in one)."""
    mols = _pool(n)
    return [mols[i] for i in np.random.default_rng((seed, 1)).permutation(n)]


class _Hook:
    """The schedule, stepped by the scan after each replay: forwards to
    it and, while armed, reads the program's state after steps 1..n."""

    def __init__(self, sched):
        self.sched = sched
        self.armed = None

    def step(self):
        self.sched.step()
        if self.armed is None:
            return
        a = self.armed
        a["step"] += 1
        k = a["step"]
        if k <= a["n"]:
            a["sums"].append(torch.stack([v.detach().clone()
                                          for v in a["views"].values()]))
        if k == 1:
            # no moment where the optimizer kept no state: a zero gradient
            a["exp_avg"] = {n: a["opt"].state[p].get("exp_avg", torch.zeros_like(p))
                            .detach().clone() for n, p in a["named"]}
        if k == a["n"]:
            a["params"] = {n: p.detach().clone() for n, p in a["named"]}


def _members(batches, stacked) -> list[int]:
    """Indices of the batches a stacked group holds, in stack order."""
    def shapes(b, lead):
        return tuple((f.name, tuple(getattr(b, f.name).shape[lead:]))
                     for f in dataclasses.fields(b)
                     if isinstance(getattr(b, f.name), torch.Tensor))

    want = shapes(stacked, 1)
    return [i for i, b in enumerate(batches) if shapes(b, 0) == want]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx) -> dict:
    from hgnn2_torch import runtime
    from hgnn2_torch.data import batching, stats
    from hgnn2_torch.graphs import GraphRecord
    from hgnn2_torch.training import optim, train
    from hgnn2_torch.training.config import OptimConfig

    cfg, traffic, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    runtime.setup()
    ctx.phase("torch and the port imported")
    batch = traffic["batch"]
    mols = molecules(cfg["train_molecules"], seed)
    ctx.phase("molecules made")
    records = [GraphRecord(x=m.x, adj=m.adj, y=m.y) for m in mols]
    ts = stats.compute_target_stats(records)
    mean, std = float(ts.mean[cfg["task"]]), float(ts.std[cfg["task"]])
    inner = ctx.port.train_loader(records, batch, cfg, dev)
    batches = batching.CachedLoader(inner, shuffle=False).batches()
    ctx.phase("batches built")
    model = ctx.port.build(cfg, dev, getattr(inner, "k_max", None))
    ctx.phase("model built")
    params0, buffers0 = common.draw_weights(
        ctx.ref.param_spec(cfg), ctx.ref.buffer_spec(cfg), seed, dev)
    model.load_state_dict({**params0, **buffers0})
    ctx.phase("weights drawn and loaded")
    opt, sched = optim.build_optimizer(
        OptimConfig(optim=cfg["optim"], lr=cfg["lr"], lr_damping=cfg["lr_damping"],
                    epoch_step=cfg["epoch_step"]), len(batches), model.parameters())
    hook = _Hook(sched)
    scan = train.make_scanned_epoch(model, opt, hook, "regression", mean, std)
    ctx.phase("optimizer and scan built")
    groups = train.group_stacked_batches(batches)
    members = [_members(batches, g) for g in groups]
    ctx.phase("batches stacked by shape")

    # warm-up: each group's graph captured and run once, then the state
    # put back to its first values
    state0 = [t.detach().clone() for t in model.state_dict().values()]

    def put_back():
        with torch.no_grad():
            for t, t0 in zip(model.state_dict().values(), state0):
                t.copy_(t0)
        optim.reset(opt, sched)

    views = [scan(g, None) for g in groups]
    _sync(dev)
    put_back()
    ctx.phase("graphs captured")

    # the first steps, through the window's call, each group's graph held
    # to the reference: one step of every other group from the first
    # state (then put back), then three of the largest, whose state the
    # window takes on; each group's batches in an order drawn from the seed
    rng = np.random.default_rng(seed)
    g = max(range(len(groups)), key=lambda i: len(members[i]))
    if len(members[g]) < N_CHECKED:
        raise RuntimeError(f"the largest shape group holds {len(members[g])} "
                           f"batches; the check follows {N_CHECKED}")
    named = list(model.named_parameters())
    runs = []  # (batch indices, the hook's readings, metric names)
    for h in [*(h for h in range(len(groups)) if h != g), g]:
        n = N_CHECKED if h == g else 1
        perm = rng.permutation(len(members[h]))
        hook.armed = dict(step=0, n=n, views=views[h], sums=[], opt=opt,
                          named=named)
        scan(groups[h], perm)
        _sync(dev)
        runs.append(([members[h][int(j)] for j in perm[:n]], hook.armed,
                     list(views[h])))
        hook.armed = None
        if h != g:
            put_back()
    checked = [idx for idx, _, _ in runs]
    y_prog = [[batches[i].y.cpu().numpy() for i in idx] for idx in checked]
    # the mix's warm_seconds of whole epochs: the card under load before
    # the window (without, the first seconds of a window ran slower)
    warm = _epochs_for(traffic.get("warm_seconds", 0), groups, scan, rng)
    ctx.phase(f"warmed: epochs ending in each 5 s {warm}")
    setup_s = time.perf_counter() - ctx.t_start

    # the window
    steps_per_epoch = len(batches)
    n_trace = traffic.get("trace_steps", 0) if ctx.trace else 0
    trace_epochs = -(-n_trace // steps_per_epoch) if n_trace else 0
    epochs = failed = 0
    ends = []  # each epoch's end, from the window's start
    sl = tracing.Slice(False)
    t0 = time.perf_counter()
    while True:
        if trace_epochs and epochs == 1:
            with tracing.Slice(True) as sl:
                for _ in range(trace_epochs):
                    mets = train.run_epoch_scanned(groups, scan, rng)
                    epochs += 1
                    failed += 0 if np.isfinite(mets["loss"]) else steps_per_epoch
        mets = train.run_epoch_scanned(groups, scan, rng)
        epochs += 1
        failed += 0 if np.isfinite(mets["loss"]) else steps_per_epoch
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    attempted = epochs * steps_per_epoch
    ctx.log(f"window: {epochs} epochs of {steps_per_epoch} steps in "
            f"{window_s:.3f} s, last loss {mets['loss']:.6g}; setup "
            f"{setup_s:.3f} s; peak {peak} B; {len(groups)} shape groups "
            f"{[len(m) for m in members]}; epochs ending in each 5 s "
            f"{np.bincount((np.array(ends) // 5).astype(int)).tolist()}")

    # the program's readings, then its state freed
    progs = [_readings(a, names) for _, a, names in runs]
    summary = sl.summary(trace_epochs * steps_per_epoch)
    del model, opt, sched, hook, scan, groups, batches, views, runs, inner
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, one run of steps for each run of the program's
    deal = ctx.port.deal(mols, batch)
    mean_r, std_r = common.target_stats(mols, cfg["task"])
    t_ref = time.perf_counter()
    held = []
    for idx, yps, (losses, grads, params_n) in zip(checked, y_prog, progs):
        chunks = [[mols[i] for i in deal[b]] for b in idx]
        for yp, ch in zip(yps, chunks):
            want = np.array([m.y[cfg["task"]] for m in ch], np.float32)
            if not np.array_equal(yp[:len(want)], want):
                raise RuntimeError("the loader dealt other molecules than the "
                                   "benchmark's deal: the reference would "
                                   "follow other batches")
        ref = common.train_steps(ctx.ref, cfg, params0, buffers0, chunks,
                                 mean_r, std_r, steps_per_epoch, dev)
        held.append(compare(losses, grads, params_n, params0, ref))
        ctx.log(f"run of {len(idx)} step(s): losses {losses} against the "
                f"reference's {ref['losses']}")
    # the worst run's (np.max keeps a NaN)
    checks = {k: float(np.max([c[k] for c in held])) for k in held[0]}
    ctx.log(f"reference: {sum(len(i) for i in checked)} steps in "
            f"{time.perf_counter() - t_ref:.3f} s")

    per_step = None
    if summary is not None:
        per_step = work.train_per_step(cfg, [[mols[i] for i in d] for d in deal])
    done = sum(len(d) for d in deal) * epochs
    return dict(
        e2e={"train_molecules_per_s": done / window_s,
             "train_peak_mem_mb": peak / 1e6, "setup_s": setup_s},
        attempted=attempted, failed=failed, checks=checks, peak=peak,
        trace=summary, work=per_step, spans={})


def _epochs_for(seconds: float, groups, scan, rng) -> list:
    """Whole epochs until ``seconds`` have passed; the epochs that ended in
    each 5 s."""
    from hgnn2_torch.training import train

    ends = []
    t0 = time.perf_counter()
    while seconds > 0 and (not ends or ends[-1] < seconds):
        train.run_epoch_scanned(groups, scan, rng)
        ends.append(time.perf_counter() - t0)
    return np.bincount((np.array(ends) // 5).astype(int)).tolist() if ends else []


def _readings(a: dict, names: list) -> tuple:
    """The program's losses of each read step, its first gradient (Adamax's
    first moment after step 1 over 1 - b1) and its parameters after the
    last read step, from the hook's readings."""
    prev = dict.fromkeys(names, 0.0)
    losses = []
    for s in a["sums"]:
        s = dict(zip(names, s.tolist()))
        losses.append((s["loss"] - prev["loss"]) / (s["count"] - prev["count"]))
        prev = s
    grads = {n: v / (1 - BETA1) for n, v in a["exp_avg"].items()}
    return losses, grads, a["params"]


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def _worst(prog: dict, ref: dict, keys) -> float:
    """max over leaves of |norm_prog - norm_ref| / max(norm_ref, median
    leaf's norm_ref)."""
    med = float(np.median([ref[k] for k in keys]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def _median_gap(prog: dict, ref: dict, keys) -> float:
    """The median over leaves of |norm_prog - norm_ref| / norm_ref."""
    return float(np.median([abs(prog[k] - ref[k]) / max(ref[k], 1e-30)
                            for k in keys]))


MEDIAN_SHARE = 1e-3  # a moved leaf's gradient, at least, of the median's
LARGEST_SHARE = 1e-5  # ... and of the largest leaf's


def moved_leaves(g_r: dict) -> list:
    """The leaves the reference's first gradient moves: those whose norm
    is at least a thousandth of the median leaf's and 1e-5 of the largest
    leaf's. The rest are nought to rounding (a key's bias under softmax, a
    unit that no molecule turns on) and move under Adamax by round-off
    alone; where most leaves are such, the median is 0 and the second
    share leaves them out."""
    keys = sorted(g_r)
    floor = max(MEDIAN_SHARE * float(np.median([g_r[k] for k in keys])),
                LARGEST_SHARE * max(g_r.values()))
    return [k for k in keys if g_r[k] >= floor]


def compare(losses, grads, params_n, params0, ref) -> dict:
    """The numbers a cell's limits may hold: the worst step's relative loss
    gap, and the first step's alone (from the state both sides share: a
    later step's loss follows Adamax's first update, which moves elements
    whose gradient is rounding alone, near its eps, by up to lr in
    directions that the rounding picks); over the moved leaves
    (moved_leaves), the worst leaf's and the median leaf's gap in the norm
    of the first gradient, and the same for the norm of each leaf's change
    over the steps."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(losses, ref["losses"])]
    g_p, g_r = _norms(grads), _norms(ref["grads"])
    moved = moved_leaves(g_r)
    d_p = _norms({k: params_n[k] - params0[k] for k in moved})
    d_r = _norms({k: ref["params"][k] - params0[k] for k in moved})
    return {"loss_gap": max(gaps), "loss_gap_first": gaps[0],
            "grad_gap": _worst(g_p, g_r, moved),
            "grad_gap_median": _median_gap(g_p, g_r, moved),
            "change_gap": _worst(d_p, d_r, moved),
            "change_gap_median": _median_gap(d_p, d_r, moved)}
