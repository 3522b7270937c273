#!/usr/bin/env python3
"""Training throughput of the PyTorch port's GNNs on 107,108 QM9-shaped
synthetic molecules at batch 2,048, on one CUDA card (the port's
counterpart of bench.py): by default the main path, the power GNN
GNNSimple (L=15, h=1, J=1); with --arch lggnn the line-graph GNN
GNNLineGraph (L=5, h=1, J=1, update order 2), bench_epoch.py's lggnn_L5.
--layout packed trains their packed twins PackedGNN and PackedLGGNN over
PackedLoader batches instead (bench_epoch.py's gnn_L15_packed and
lggnn_L5_packed).

    python3 bench_torch.py                  # on the card
    python3 bench_torch.py --arch lggnn     # the line-graph GNN
    python3 bench_torch.py --layout packed --arch lggnn
    python3 bench_torch.py --device cpu --molecules 300 --batch 64

The pipeline is the CLI's default: CachedLoader(DenseLoader(sort=True),
with line graphs for lggnn, or PackedLoader(sort=True) at one uniform
capacity) batches resident on the device, epochs visited in the JAX package's
scanned-epoch order (training.train.groups_in_order: shape groups and
their members shuffled by one default_rng(0)), Adamax at lr 3e-4, a
fresh batch every step, and each epoch's metrics fetched to the host
once at its end. Epoch times are host-clock times ending in that fetch.
The first epoch and one warm-up epoch are not measured; the headline is
the mean of the next 3. Data generation and batch building are set-up,
outside the epochs, as in bench.py.

It also gives the one-resident-batch upper bound: 15 timed runs of 20
steps on one batch, after a warm-up run.

Float32 matmuls run without TF32, so the card computes what the CPU
computes. Prints exactly one JSON line on stdout (bench.py's keys less
the baseline ratios, plus the card's name and power limit and the TF32
setting, the arch and the layout); logs go to stderr.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from hgnn2_torch import resolve_device, runtime
from hgnn2_torch.data import batching, qm9, stats
from hgnn2_torch.nn import models, packed
from hgnn2_torch.training import train
from hgnn2_torch.training.config import OptimConfig
from hgnn2_torch.training.optim import build_optimizer

MOLECULES = 107108  # the original implementation's training-set size
BATCH = 2048
EPOCHS = 3
UB_RUNS, UB_STEPS = 15, 20  # the upper bound: runs of steps on one batch


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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--arch", choices=("gnn", "lggnn"), default="gnn")
    p.add_argument("--layout", choices=("dense", "packed"), default="dense")
    p.add_argument("--molecules", type=int, default=MOLECULES)
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--epochs", type=int, default=EPOCHS)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    runtime.setup()

    t0 = time.time()
    records = qm9.synthetic_qm9_like(args.molecules, seed=0)
    ts = stats.compute_target_stats(records)
    mean, std = float(ts.mean[0]), float(ts.std[0])
    log(f"data: {args.molecules} molecules ({time.time() - t0:.1f}s)")

    if args.layout == "packed":
        inner = batching.PackedLoader(records, args.batch, task=0, sort=True,
                                      device=dev)
    else:
        inner = batching.DenseLoader(records, args.batch, task=0, sort=True,
                                     with_line_graph=args.arch == "lggnn",
                                     device=dev)
    loader = batching.CachedLoader(inner, shuffle=True, seed=0)
    t0 = time.time()
    loader.materialize()
    _sync(dev)
    log(f"built {len(loader)} batches in {time.time() - t0:.1f}s")

    gen = torch.Generator().manual_seed(0)
    F_in = records[0].x.shape[1]
    n_layers = 5 if args.arch == "lggnn" else 15
    kw = dict(n_features=1, n_layers=n_layers, J=1, generator=gen)
    if args.layout == "packed" and args.arch == "lggnn":
        model = packed.PackedLGGNN(in_features=F_in, order=2, **kw)
    elif args.layout == "packed":
        model = packed.PackedGNN(in_features=F_in, **kw)
    elif args.arch == "lggnn":
        model = models.GNNLineGraph(in_features=F_in, order=2, **kw)
    else:
        model = models.GNNSimple(in_features=F_in, **kw)
    model.to(dev)
    opt, sched = build_optimizer(OptimConfig(optim="adamax", lr=3e-4),
                                 len(loader), model.parameters())
    sample = next(iter(loader))
    groups = train.group_batches(loader.batches())
    rng = np.random.default_rng(0)

    def epoch() -> tuple[float, dict]:
        t0 = time.time()
        mets = train.run_epoch(model, opt, sched,
                               train.groups_in_order(groups, rng),
                               "regression", mean, std)
        return time.time() - t0, mets

    secs, _ = epoch()
    log(f"first epoch {secs:.2f}s ({len(groups)} shape groups)")
    secs, _ = epoch()
    log(f"warm-up epoch {secs:.2f}s")
    times = []
    for _ in range(args.epochs):
        secs, mets = epoch()
        times.append(secs)
    epoch_s = sum(times) / len(times)
    mol_per_s = args.molecules / epoch_s
    log(f"epochs: {times} s -> {mol_per_s:,.1f} molecules/s end to end "
        f"(mean), {epoch_s / len(loader) * 1e3:.3f} ms/step, "
        f"loss={mets['loss']:.4f}")

    def run() -> None:
        for _ in range(UB_STEPS):
            train.train_step(model, opt, sched, sample, "regression", mean, std)

    run()
    _sync(dev)
    t0 = time.time()
    for _ in range(UB_RUNS):
        run()
    _sync(dev)
    ub_mol_per_s = args.batch * UB_RUNS * UB_STEPS / (time.time() - t0)
    log(f"upper bound (one resident batch): {ub_mol_per_s:,.1f} molecules/s")

    layout = "_packed" if args.layout == "packed" else ""
    result = {
        "metric": f"{args.arch}_qm9_L{n_layers}{layout}_train_throughput_end_to_end",
        "arch": args.arch,
        "layout": args.layout,
        "value": mol_per_s,
        "unit": "molecules/s",
        "epoch_s": epoch_s,
        "best_epoch_s": min(times),
        "molecules": args.molecules,
        "steps_per_epoch": len(loader),
        "methodology": "epochs in the scanned-epoch order over cached "
                       "device-resident batches, fresh batch every step, "
                       "loader and metrics fetch included (the CLI's "
                       "default); headline is the MEAN of the measured "
                       "epochs after a first and a warm-up epoch",
        "device_upper_bound_mol_per_s": ub_mol_per_s,
        "device": _device_info(dev),
        "tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
