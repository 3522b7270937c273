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
gnn_L15_packed and lggnn_L5_packed).

    python3 bench_torch.py                  # on the card
    python3 bench_torch.py --arch lggnn     # the line-graph GNN
    python3 bench_torch.py --layout packed --arch lggnn
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
from hgnn2_torch.training import train
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


def _model(arch: str, layout: str, k_max: int, dev: torch.device):
    gen = torch.Generator().manual_seed(0)
    if arch in ("ccn1d", "ccn2d"):
        cls = ccn.CCN1D if arch == "ccn1d" else ccn.CCN2D
        return cls(n_features=5, hidden=2, n_layers=LAYERS[arch],
                   kernel=ccn_fused.use_kernel(k_max, dev), generator=gen)
    kw = dict(in_features=5, n_features=1, n_layers=LAYERS[arch], J=1,
              generator=gen)
    if layout == "packed" and arch == "lggnn":
        return packed.PackedLGGNN(order=2, **kw)
    if layout == "packed":
        return packed.PackedGNN(**kw)
    if arch == "lggnn":
        return models.GNNLineGraph(order=2, **kw)
    return models.GNNSimple(**kw)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--arch", choices=tuple(LAYERS), default="gnn")
    p.add_argument("--layout", choices=("dense", "packed"), default="dense")
    p.add_argument("--molecules", type=int, default=MOLECULES)
    p.add_argument("--batch", type=int, default=None,
                   help=f"molecules a step (default {BATCH}, {CCN_BATCH} for CCN)")
    p.add_argument("--epochs", type=int, default=EPOCHS)
    args = p.parse_args(argv)
    is_ccn = args.arch in ("ccn1d", "ccn2d")
    if is_ccn and args.layout == "packed":
        p.error("--layout packed is for the GNNs")
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

    def timed(run) -> tuple[float, dict]:
        t0 = time.time()
        mets = run()
        return time.time() - t0, mets

    def scanned():
        return train.run_epoch_scanned(groups, scan_fn, rng)

    def eager():
        return train.run_epoch(model, opt, sched,
                               train.groups_in_order(lists, rng),
                               "regression", mean, std)

    secs, _ = timed(scanned)
    graphs = scan_fn.graphs
    log(f"first epoch {secs:.2f}s ({len(groups)} shape groups, "
        f"{len(graphs.graphs)} graphs captured in {graphs.capture_s:.2f}s, "
        f"pool {graphs.pool_bytes / 2**20:.1f} MiB)")
    secs, _ = timed(scanned)
    log(f"warm-up epoch {secs:.2f}s")
    times = []
    for _ in range(args.epochs):
        secs, mets = timed(scanned)
        times.append(secs)
    epoch_s = sum(times) / len(times)
    mol_per_s = args.molecules / epoch_s
    log(f"captured epochs: {times} s -> {mol_per_s:,.1f} molecules/s end to "
        f"end (mean), {epoch_s / n_steps * 1e3:.3f} ms/step, "
        f"loss={mets['loss']:.4f}")

    eager_times = []
    timed(eager)  # its warm-up
    for _ in range(args.epochs):
        secs, _ = timed(eager)
        eager_times.append(secs)
    eager_s = sum(eager_times) / len(eager_times)
    log(f"eager epochs: {eager_times} s -> {args.molecules / eager_s:,.1f} "
        f"molecules/s, {eager_s / n_steps * 1e3:.3f} ms/step")

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
        "value": mol_per_s,
        "unit": "molecules/s",
        "epoch_s": epoch_s,
        "best_epoch_s": min(times),
        "eager_value": args.molecules / eager_s,
        "eager_epoch_s": eager_s,
        "molecules": args.molecules,
        "batch": batch,
        "steps_per_epoch": n_steps,
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
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
