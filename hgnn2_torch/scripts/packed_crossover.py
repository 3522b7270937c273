"""Packed against dense layout across the model width h on the card
(counterpart of scripts/packed_crossover.py).

    python -m hgnn2_torch.scripts.packed_crossover [--molecules 32768]
        [--bs 2048] [--epochs 3] [--device cuda|cpu] [--out DIR]

Trains GNN L=15 (GNNSimple against PackedGNN) and LGGNN L=5 order 2
(GNNLineGraph against PackedLGGNN) at h in HS = (1, 4, 16, 64), both
layouts through the shipped pipeline: the inner loader (DenseLoader, with
line graphs for LGGNN, or PackedLoader, sort=True) under
CachedLoader(shuffle=True, seed=0), Adamax at lr 3e-4,
group_stacked_batches, make_scanned_epoch and run_epoch_scanned(groups,
scan_fn, rng) with rng = default_rng(0), every step one replayed CUDA
graph. The first epoch holds the captures (compile_s, JAX's compile);
the mean of the next ``--epochs`` (host clock, each ending in the
metrics' fetch) is epoch_s_mean. One more row trains GNN h=1 packed with
PackedLoader(uniform_caps=False), the per-batch capacity ladder, so the
rows show what one capacity an epoch buys in scan groups and time. Each
model starts from the weights of seed 0. The records are generated once;
each configuration's batch build is logged as set-up apart from the
epochs. Writes DIR/findings.json in JAX's format, with the card's name
and power limit under "card"; DIR defaults to
runs/packed_crossover_torch. The harness runs on the card, or on the CPU
with --device cpu (no card: it raises).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from hgnn2_torch import convert
from hgnn2_torch.data import batching, qm9, stats
from hgnn2_torch.nn import models, packed
from hgnn2_torch.scripts import profile_ccn1d_util as util
from hgnn2_torch.training import optim, train
from hgnn2_torch.training.config import OptimConfig

HS = (1, 4, 16, 64)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_config(records, ts, family, h, layout, bs, epochs,
               uniform_caps=True, device=None, init_params=None):
    """One row of the crossover: JAX's run_config on ``device``.
    init_params: flax variables of the JAX model (JAX's init through
    hgnn2_torch.convert); else weights from seed 0."""
    dev = util.harness_device(device)
    lg = family == "lggnn"
    L = 5 if lg else 15
    kw = dict(in_features=records[0].x.shape[1], n_features=h, n_layers=L,
              J=1, generator=torch.Generator().manual_seed(0),
              **({"order": 2} if lg else {}))
    t0 = time.perf_counter()
    if layout == "dense":
        inner = batching.DenseLoader(records, bs, task=0, sort=True,
                                     with_line_graph=lg, device=dev)
        model = (models.GNNLineGraph if lg else models.GNNSimple)(**kw)
    else:
        inner = batching.PackedLoader(records, bs, task=0, sort=True,
                                      uniform_caps=uniform_caps, device=dev)
        model = (packed.PackedLGGNN if lg else packed.PackedGNN)(**kw)
    if init_params is not None:
        model.load_state_dict(convert.variables_from_flax(init_params))
    model.to(dev)
    loader = batching.CachedLoader(inner, shuffle=True, seed=0).materialize()
    opt, sched = optim.build_optimizer(OptimConfig(optim="adamax", lr=3e-4),
                                       len(loader), model.parameters())
    groups = train.group_stacked_batches(loader.batches())
    scan_fn = train.make_scanned_epoch(model, opt, sched, "regression",
                                       float(ts.mean[0]), float(ts.std[0]))
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    train.run_epoch_scanned(groups, scan_fn, rng)
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(epochs):
        t0 = time.perf_counter()
        mets = train.run_epoch_scanned(groups, scan_fn, rng)
        times.append(time.perf_counter() - t0)
    epoch_s = sum(times) / len(times)
    row = {
        "family": family, "h": h, "layout": layout,
        "scan_bucket_groups": len(groups),
        "epoch_s_mean": round(epoch_s, 4),
        "epoch_s_all": [round(t, 4) for t in times],
        "molecules_per_s": round(len(records) / epoch_s, 1),
        "compile_s": round(compile_s, 1),
        "loss": round(float(mets["loss"]), 4),
    }
    if layout == "packed":
        row["uniform_caps"] = uniform_caps
    log(f"{family} h={h} {layout}"
        + (f" uniform={uniform_caps}" if layout == "packed" else "")
        + f": {epoch_s:.4f} s/epoch, {len(groups)} group(s); set-up "
          f"{setup_s:.1f} s, capture epoch {compile_s:.2f} s")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--molecules", type=int, default=32768)
    ap.add_argument("--bs", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("runs",
                                                  "packed_crossover_torch"))
    args = ap.parse_args(argv)
    dev = util.harness_device(args.device)
    name = util.card(dev)
    log(name)

    t0 = time.perf_counter()
    records = qm9.synthetic_qm9_like(args.molecules, seed=0)
    ts = stats.compute_target_stats(records)
    log(f"set-up: {len(records)} records in {time.perf_counter() - t0:.1f} s")
    rows = []

    def run(*a, **kw):
        rows.append(run_config(records, ts, *a, device=dev, **kw))
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    for family in ("gnn", "lggnn"):
        for h in HS:
            run(family, h, "dense", args.bs, args.epochs)
            run(family, h, "packed", args.bs, args.epochs)
    # the ladder variant once, to quantify the group-count consolidation
    run("gnn", 1, "packed", args.bs, args.epochs, uniform_caps=False)

    os.makedirs(args.out, exist_ok=True)
    out = {
        "question": "where does the packed segment-sum layout beat the "
                    "dense one-hot layout in h on one card, and what "
                    "does capacity consolidation buy?",
        "card": name,
        "config": {"molecules": args.molecules, "bs": args.bs,
                   "epochs": args.epochs,
                   "gnn": "L=15 J=1", "lggnn": "L=5 J=1 order=2",
                   "pipeline": "CachedLoader + scanned epochs (shipped "
                               "default, one replayed CUDA graph a step), "
                               "mean of measured epochs"},
        "rows": rows,
    }
    with open(os.path.join(args.out, "findings.json"), "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps(rows[-1]))
    return out


if __name__ == "__main__":
    main()
