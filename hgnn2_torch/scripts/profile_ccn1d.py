"""Profile the CCN-1D L=20 train step on the card (counterpart of
scripts/profile_ccn1d.py).

    python -m hgnn2_torch.scripts.profile_ccn1d [--molecules 4096]
        [--layers 20] [--h 2] [--sweep_h 2 8 32] [--device cuda|cpu]
        [--out DIR]

All the molecules (synthetic, QM9-shaped) form one CCN batch
(make_ccn_batch). In the JAX script's keys, "xla" is the port's plain
PyTorch path (CCN1D(kernel=False)) and "pallas_kernel" its hand-written
CUDA kernels (CCN1D(kernel=True): K1, ops/csrc/ccn_fused.cu:
ccn1d_forward, in the forward and K2, ccn1d_backward, in the backward).

  1. the plain path: one train step (make_train_step: its CUDA graph is
     captured), a step's ms (step_ms: make_multi_train_step with 5 Adamax
     steps at lr 1e-3 in one replayed graph, timed by
     profiling.time_scan_steps over 10 calls after 2), then 3 steps under
     profiling.trace, whose kernel table (parse_kernel_stats) goes to
     DIR/op_table_xla.md and findings.json's xla_trace;
  2. the kernel path: the same step's ms, and 3 traced steps into
     DIR/op_table_kernel.md and kernel_trace, so the table shows K1's
     and K2's share of the step;
  3. the h sweep, both paths, 6 timed calls each.

Every model starts from the weights of seed 0. Writes DIR/findings.json
(JAX's keys config, xla_trace, step_ms, molecules_per_s, h_sweep; the
card's name and power limit in config) and the two tables. DIR defaults
to runs/profile_ccn1d_torch. The harness runs on the card, or on the CPU
with --device cpu, where both paths run the plain ops (the kernels exist
only on CUDA; no card: it raises).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from hgnn2_torch import profiling
from hgnn2_torch.data import qm9, stats
from hgnn2_torch.nn import ccn as ccn_mod
from hgnn2_torch.scripts import profile_ccn1d_util as util
from hgnn2_torch.training import optim, train
from hgnn2_torch.training.config import OptimConfig

PATHS = {"xla": "the plain PyTorch path, CCN1D(kernel=False)",
         "pallas_kernel": "the hand-written CUDA kernels K1 (forward) and "
                          "K2 (backward), CCN1D(kernel=True)"}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_model(cb, h, layers, kernel):
    """CCN1D of width h and depth ``layers`` on cb's device, weights of
    seed 0 (JAX's script inits every model from key 0)."""
    return ccn_mod.CCN1D(n_features=cb.x.shape[1], hidden=h, n_layers=layers,
                         kernel=kernel,
                         generator=torch.Generator().manual_seed(0)
                         ).to(cb.x.device)


def _optimizer(model):
    return optim.build_optimizer(OptimConfig(optim="adamax", lr=1e-3), 100,
                                 model.parameters())


def train_step(model, ts):
    """JAX's make_train_step for ``model`` (one graph a batch shape)."""
    return train.make_train_step(model, *_optimizer(model), "regression",
                                 float(ts.mean[0]), float(ts.std[0]))


def step_ms(model, cb, ts, steps=10, n_inner=5):
    """ms an optimizer step: make_multi_train_step(n_inner) timed over
    ``steps`` calls after 2 warm-up calls."""
    step = train.make_multi_train_step(
        model, *_optimizer(model), "regression", float(ts.mean[0]),
        float(ts.std[0]), n_inner=n_inner)
    timing = profiling.time_scan_steps(step, cb, steps=steps, warmup=2)
    return timing.per_step_s / n_inner * 1e3


def _trace(name, model, cb, ts, out, ms, title):
    """3 steps of a captured train step under profiling.trace: the
    findings entry and DIR/op_table_{name}.md."""
    one = train_step(model, ts)
    profiling.force_sync(one(cb))  # the capture, outside the trace
    with profiling.trace(os.path.join(out, f"trace_{name}")) as prof:
        for _ in range(3):
            m = one(cb)
        profiling.force_sync(m)
    top, all_rows = util.parse_kernel_stats(prof)
    dev_us = sum(r["total_time"] for r in all_rows)
    md = util.op_table(title, f"measured {ms:.3f} ms/step; traced device time "
                       f"{dev_us / 1e3:.3f} ms over 3 steps; "
                       f"{util.kernel_launches(all_rows) / 3:.1f} kernels a "
                       "step", top, dev_us, width=70)
    with open(os.path.join(out, f"op_table_{name}.md"), "w") as f:
        f.write("\n".join(md) + "\n")
    log("\n".join(md[:16]))
    return {"device_time_total_us_3steps": dev_us,
            "n_distinct_ops": len(all_rows), "top_ops": top[:12]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--molecules", type=int, default=4096)
    ap.add_argument("--layers", type=int, default=20)
    ap.add_argument("--h", type=int, default=2)
    ap.add_argument("--sweep_h", type=int, nargs="*", default=[2, 8, 32])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("runs",
                                                  "profile_ccn1d_torch"))
    args = ap.parse_args(argv)
    dev = util.harness_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    name = util.card(dev)

    records = qm9.synthetic_qm9_like(args.molecules, seed=0)
    ts = stats.compute_target_stats(records)
    cb = ccn_mod.make_ccn_batch(records, task=0, device=dev)
    V, K = int(cb.chi_idx.shape[0]), int(cb.chi_idx.shape[1])
    log(f"batch: {args.molecules} molecules, V={V}, K={K} on {name}")
    findings = {"config": {"molecules": args.molecules, "V": V, "K": K,
                           "layers": args.layers, "h": args.h,
                           "optimizer": "adamax", "paths": PATHS,
                           "card": name}}

    # 1. the plain path: measure, then trace
    xla_ms = step_ms(make_model(cb, args.h, args.layers, False), cb, ts)
    log(f"plain step: {xla_ms:.3f} ms")
    findings["xla_trace"] = _trace(
        "xla", make_model(cb, args.h, args.layers, False), cb, ts, args.out,
        xla_ms, f"# CCN-1D L={args.layers} h={args.h} plain PyTorch step "
                f"profile ({name})")

    # 2. the kernel path (K1, K2)
    ker_ms = step_ms(make_model(cb, args.h, args.layers, True), cb, ts)
    log(f"kernel step: {ker_ms:.3f} ms ({xla_ms / ker_ms:.2f}x)")
    findings["kernel_trace"] = _trace(
        "kernel", make_model(cb, args.h, args.layers, True), cb, ts, args.out,
        ker_ms, f"# CCN-1D L={args.layers} h={args.h} kernel (K1, K2) step "
                f"profile ({name})")
    findings["step_ms"] = {"xla": xla_ms, "pallas_kernel": ker_ms,
                           "speedup": xla_ms / ker_ms}
    findings["molecules_per_s"] = {
        "xla": args.molecules / (xla_ms / 1e3),
        "pallas_kernel": args.molecules / (ker_ms / 1e3),
    }

    # 3. h sweep, both paths
    sweep = []
    for h in args.sweep_h:
        x_ms = step_ms(make_model(cb, h, args.layers, False), cb, ts, steps=6)
        k_ms = step_ms(make_model(cb, h, args.layers, True), cb, ts, steps=6)
        sweep.append({"h": h, "xla_ms": x_ms, "kernel_ms": k_ms})
        log(f"h={h}: plain {x_ms:.3f} ms, kernel {k_ms:.3f} ms")
    findings["h_sweep"] = sweep

    with open(os.path.join(args.out, "findings.json"), "w") as f:
        json.dump(findings, f, indent=2)
        f.write("\n")
    print(json.dumps(findings["step_ms"]))
    return findings


if __name__ == "__main__":
    main()
