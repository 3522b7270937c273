#!/usr/bin/env python3
"""Training throughput of the PyTorch port's models on 107,108 QM9-shaped
synthetic molecules, on one CUDA card (the port's counterpart of
bench.py): by default the main path, the power GNN GNNSimple (L=15, h=1,
J=1) at batch 2,048; with --arch lggnn the line-graph GNN GNNLineGraph
(L=5, h=1, J=1, update order 2), bench_epoch.py's lggnn_L5; with --arch
ccn1d or ccn2d CCN-1D (L=20, h=2, kernels K1 and K2) or CCN-2D (L=2,
h=2, kernels K3 and K4) at 1,024 molecules a step, bench_suite.py's CCN
rows. --layout packed trains the GNNs' packed twins PackedGNN and
PackedLGGNN over PackedLoader batches instead (bench_epoch.py's
gnn_L15_packed and lggnn_L5_packed). --edge_shards N (with --dp M, an
(M, N) grid of ranks) then also times molecule-aligned sharded training
of the same packed model over the same molecules (training/sharded.py,
every rank on the card), after and beside the unsharded run.

    python3 bench_torch.py                  # on the card
    python3 bench_torch.py --arch lggnn     # the line-graph GNN
    python3 bench_torch.py --layout packed --arch lggnn
    python3 bench_torch.py --layout packed --edge_shards 4
    python3 bench_torch.py --layout packed --dp 2 --edge_shards 2
    python3 bench_torch.py --arch ccn1d
    python3 bench_torch.py --device cpu --molecules 300 --batch 64

The pipeline is the CLI's default: CachedLoader(DenseLoader(sort=True),
with line graphs for lggnn; PackedLoader(sort=True) at one uniform
capacity; or CCNLoader) batches resident on the device, stacked by shape
(training.train.group_stacked_batches), each epoch one run_epoch_scanned
in the JAX package's order (shape groups and their members shuffled by
one default_rng(0)): on the card one captured CUDA graph a step for each
shape group, replayed, the batch picked from the stack on the device,
and the epoch's metrics fetched to the host once at its end. Adamax at
lr 3e-4 (1e-3 for CCN, as bench_suite.py). Epoch times are host-clock
times ending in that fetch. The first epoch (the captures) and one
warm-up epoch are not measured; the headline is the mean of the next 3.
The same number of eager epochs (run_epoch, one launch a kernel) follow
in the same process, for the capture's effect. Data generation and batch
building are set-up, outside the epochs, as in bench.py.

It also gives the one-resident-batch upper bound as bench.py does:
make_multi_train_step (20 steps on one batch, one graph) timed by
profiling.time_scan_steps over 15 calls after a warm-up call.

A sharded run (--edge_shards) builds ShardedPackedLoader's minibatches of
the same size, the model with its BN statistics pooled over the ranks,
and times its epochs the same way: captured, make_sharded_scan_epoch in
the loader's epoch_order (one graph of a sharded step, replayed), then
eager (the same step's body, one launch a kernel). Its row carries the
unsharded run's rates under "unsharded" and the flattened capacities
(ranks x a shard's nodes and edges) beside the unsharded batch's.

Float32 matmuls run without TF32, so the card computes what the CPU
computes. Prints exactly one JSON line on stdout (bench.py's keys less
the baseline ratios, plus the eager rate, the shape groups and graphs,
the card's name and power limit and the TF32 setting, the arch and the
layout); logs go to stderr.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from hgnn2_torch import profiling, resolve_device, runtime
from hgnn2_torch.data import batching, qm9, stats
from hgnn2_torch.nn import ccn, models, packed
from hgnn2_torch.ops import ccn_fused
from hgnn2_torch.parallel import spmd
from hgnn2_torch.training import sharded, train
from hgnn2_torch.training.config import OptimConfig
from hgnn2_torch.training.optim import build_optimizer

MOLECULES = 107108  # the original implementation's training-set size
BATCH = 2048
CCN_BATCH = 1024  # bench_suite.py's CCN rows: a quarter of its 4,096
EPOCHS = 3
UB_INNER, UB_STEPS = 20, 15  # the upper bound: bench.py's N_INNER, STEPS
LAYERS = {"gnn": 15, "lggnn": 5, "ccn1d": 20, "ccn2d": 2}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _device_info(dev: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return {"name": str(dev), "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    name, power = smi.splitlines()[dev.index or 0].split(", ")
    return {"name": name, "power_limit": power}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _model(arch: str, layout: str, k_max: int, dev: torch.device,
           bn_axis=None):
    gen = torch.Generator().manual_seed(0)
    if arch in ("ccn1d", "ccn2d"):
        cls = ccn.CCN1D if arch == "ccn1d" else ccn.CCN2D
        return cls(n_features=5, hidden=2, n_layers=LAYERS[arch],
                   kernel=ccn_fused.use_kernel(k_max, dev), generator=gen)
    kw = dict(in_features=5, n_features=1, n_layers=LAYERS[arch], J=1,
              generator=gen)
    if bn_axis is not None:
        kw["bn_axis"] = bn_axis
    if layout == "packed" and arch == "lggnn":
        return packed.PackedLGGNN(order=2, **kw)
    if layout == "packed":
        return packed.PackedGNN(**kw)
    if arch == "lggnn":
        return models.GNNLineGraph(order=2, **kw)
    return models.GNNSimple(**kw)


def _timed(run) -> tuple[float, dict]:
    t0 = time.time()
    mets = run()
    return time.time() - t0, mets


def _epochs(scanned, eager, n: int) -> tuple[list, list, dict]:
    """Host seconds of n captured epochs after a first and a warm-up one,
    then of n eager epochs after a warm-up one; the last captured
    epoch's metrics."""
    for name in ("first", "warm-up"):
        secs, _ = _timed(scanned)
        log(f"{name} epoch {secs:.2f}s")
    times = []
    for _ in range(n):
        secs, mets = _timed(scanned)
        times.append(secs)
    _timed(eager)  # its warm-up
    eager_times = [_timed(eager)[0] for _ in range(n)]
    return times, eager_times, mets


def _rates(molecules: int, n_steps: int, times: list,
           eager_times: list) -> dict:
    epoch_s = sum(times) / len(times)
    eager_s = sum(eager_times) / len(eager_times)
    return {"value": molecules / epoch_s, "epoch_s": epoch_s,
            "best_epoch_s": min(times), "ms_per_step": epoch_s / n_steps * 1e3,
            "eager_value": molecules / eager_s, "eager_epoch_s": eager_s,
            "eager_ms_per_step": eager_s / n_steps * 1e3,
            "steps_per_epoch": n_steps}


def _sharded(args, records, mean: float, std: float, batch: int,
             dev: torch.device) -> tuple[dict, object]:
    """The sharded run's rates and its loader (molecule-aligned
    shards over an (args.dp, args.edge_shards) grid of ranks on dev)."""
    n_data = max(args.dp, 1)
    axes = spmd.AXES if n_data > 1 else ("edge",)
    t0 = time.time()
    loader = sharded.ShardedPackedLoader(records, batch, args.edge_shards,
                                         task=0, shuffle=True, seed=0,
                                         n_data=n_data, device=dev)
    _sync(dev)
    log(f"sharded: {len(loader)} minibatches of {n_data} x "
        f"{args.edge_shards} shards (shard capacity {loader.node_capacity} "
        f"nodes, {loader.edge_capacity} edges, {loader.graphs_per_shard} "
        f"graphs) built in {time.time() - t0:.1f}s")
    model = _model(args.arch, "packed", 0, dev,
                   bn_axis=axes if n_data > 1 else "edge").to(dev)
    opt, sched = build_optimizer(OptimConfig(optim="adamax", lr=3e-4),
                                 len(loader), model.parameters())
    grid = spmd.RankGrid(n_data, args.edge_shards, dev)
    step, _ = sharded.make_sharded_step_fns(model, grid, opt, sched,
                                            "regression", mean, std, axes)
    stack_batches, run = sharded.make_sharded_scan_epoch(step, grid, axes)
    stacked = stack_batches(loader.batches())

    def eager():
        for i in loader.epoch_order():
            step.body(loader.batches()[i])
            sched.step()
        _sync(dev)

    def scanned() -> dict:  # ends in the epoch's one metrics fetch
        mets = run(stacked, loader.epoch_order())
        return dict(zip(mets, torch.stack(list(mets.values())).tolist()))

    times, eager_times, mets = _epochs(scanned, eager, args.epochs)
    rates = _rates(args.molecules, len(loader), times, eager_times)
    log(f"sharded: captured {times} s -> {rates['value']:,.1f} molecules/s, "
        f"{rates['ms_per_step']:.3f} ms/step, loss={mets['loss']:.4f}; eager "
        f"{eager_times} s -> {rates['eager_value']:,.1f} molecules/s, "
        f"{rates['eager_ms_per_step']:.3f} ms/step; {len(run.graphs.graphs)} "
        f"graph(s) captured in {run.graphs.capture_s:.2f}s")
    return rates, loader


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--arch", choices=tuple(LAYERS), default="gnn")
    p.add_argument("--layout", choices=("dense", "packed"), default="dense")
    p.add_argument("--molecules", type=int, default=MOLECULES)
    p.add_argument("--batch", type=int, default=None,
                   help=f"molecules a step (default {BATCH}, {CCN_BATCH} for CCN)")
    p.add_argument("--epochs", type=int, default=EPOCHS)
    p.add_argument("--edge_shards", type=int, default=1,
                   help="also time molecule-aligned sharded training over "
                        "this many shards (--layout packed)")
    p.add_argument("--dp", type=int, default=1,
                   help="with --edge_shards: data groups of the rank grid")
    args = p.parse_args(argv)
    is_ccn = args.arch in ("ccn1d", "ccn2d")
    if is_ccn and args.layout == "packed":
        p.error("--layout packed is for the GNNs")
    if (args.edge_shards > 1 or args.dp > 1) and (
            args.layout != "packed" or args.edge_shards < 2):
        p.error("--edge_shards N (N > 1, with --dp M) times the packed "
                "models: give --layout packed")
    batch = args.batch or (CCN_BATCH if is_ccn else BATCH)
    dev = resolve_device(args.device)
    runtime.setup()

    t0 = time.time()
    records = qm9.synthetic_qm9_like(args.molecules, seed=0)
    ts = stats.compute_target_stats(records)
    mean, std = float(ts.mean[0]), float(ts.std[0])
    log(f"data: {args.molecules} molecules ({time.time() - t0:.1f}s)")

    if is_ccn:
        inner = batching.CCNLoader(records, batch, task=0, device=dev)
    elif args.layout == "packed":
        inner = batching.PackedLoader(records, batch, task=0, sort=True,
                                      device=dev)
    else:
        inner = batching.DenseLoader(records, batch, task=0, sort=True,
                                     with_line_graph=args.arch == "lggnn",
                                     device=dev)
    loader = batching.CachedLoader(inner, shuffle=True, seed=0)
    t0 = time.time()
    loader.materialize()
    _sync(dev)
    log(f"built {len(loader)} batches in {time.time() - t0:.1f}s")

    model = _model(args.arch, args.layout, getattr(inner, "k_max", 0), dev)
    model.to(dev)
    lr = 1e-3 if is_ccn else 3e-4
    opt, sched = build_optimizer(OptimConfig(optim="adamax", lr=lr),
                                 len(loader), model.parameters())
    sample = loader.peek_sample()
    batches = loader.batches()
    n_steps = len(batches)
    groups = train.group_stacked_batches(batches)
    lists = train.group_batches(batches)
    scan_fn = train.make_scanned_epoch(model, opt, sched, "regression", mean,
                                       std)
    rng = np.random.default_rng(0)

    def scanned():
        return train.run_epoch_scanned(groups, scan_fn, rng)

    def eager():
        return train.run_epoch(model, opt, sched,
                               train.groups_in_order(lists, rng),
                               "regression", mean, std)

    times, eager_times, mets = _epochs(scanned, eager, args.epochs)
    graphs = scan_fn.graphs
    rates = _rates(args.molecules, n_steps, times, eager_times)
    log(f"captured epochs: {times} s -> {rates['value']:,.1f} molecules/s end "
        f"to end (mean), {rates['ms_per_step']:.3f} ms/step, "
        f"loss={mets['loss']:.4f} ({len(groups)} shape groups, "
        f"{len(graphs.graphs)} graphs captured in {graphs.capture_s:.2f}s, "
        f"pool {graphs.pool_bytes / 2**20:.1f} MiB)")
    log(f"eager epochs: {eager_times} s -> {rates['eager_value']:,.1f} "
        f"molecules/s, {rates['eager_ms_per_step']:.3f} ms/step")

    multi = train.make_multi_train_step(model, opt, sched, "regression", mean,
                                        std, n_inner=UB_INNER)
    multi(sample)
    timing = profiling.time_scan_steps(multi, sample, steps=UB_STEPS, warmup=1)
    ub_mol_per_s = batch * UB_STEPS * UB_INNER / timing.total_s
    log(f"upper bound (one resident batch): {ub_mol_per_s:,.1f} molecules/s")

    layout = "_packed" if args.layout == "packed" else ""
    result = {
        "metric": f"{args.arch}_qm9_L{LAYERS[args.arch]}{layout}"
                  "_train_throughput_end_to_end",
        "arch": args.arch,
        "layout": args.layout,
        **rates,
        "unit": "molecules/s",
        "molecules": args.molecules,
        "batch": batch,
        "shape_groups": len(groups),
        "graphs": len(graphs.graphs),
        "capture_s": graphs.capture_s,
        "graph_pool_bytes": graphs.pool_bytes,
        "methodology": "epochs in the scanned-epoch order over cached "
                       "device-resident batches stacked by shape, one "
                       "captured graph a step on the card, fresh batch "
                       "every step, metrics fetched once an epoch (the "
                       "CLI's default); headline is the MEAN of the "
                       "measured epochs after a first and a warm-up epoch; "
                       "eager_value: as many eager epochs after one warm-up; "
                       "graph_pool_bytes: the segments of the model's graph "
                       "pool after every capture (epochs' and one-batch "
                       "graphs')",
        "device_upper_bound_mol_per_s": ub_mol_per_s,
        "device": _device_info(dev),
        "tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    if args.edge_shards > 1:
        unsharded = {k: result.pop(k) for k in rates}
        del model, opt, sched, groups, lists, scan_fn, multi, graphs
        rates, sloader = _sharded(args, records, mean, std, batch, dev)
        n_ranks = max(args.dp, 1) * args.edge_shards
        result.update(
            metric=f"{args.arch}_qm9_L{LAYERS[args.arch]}_packed_dp"
                   f"{max(args.dp, 1)}_es{args.edge_shards}"
                   "_train_throughput_end_to_end",
            edge_shards=args.edge_shards, dp=max(args.dp, 1), **rates,
            unsharded=unsharded,
            flattened_capacity={
                "nodes": n_ranks * sloader.node_capacity,
                "edges": n_ranks * sloader.edge_capacity,
                "graphs": n_ranks * sloader.graphs_per_shard},
            unsharded_capacity={"nodes": sample.num_node_slots,
                                "edges": sample.num_edge_slots,
                                "graphs": sample.n_graphs})
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
