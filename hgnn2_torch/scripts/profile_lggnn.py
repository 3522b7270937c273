"""Profile the scanned line-graph GNN train step on the card (counterpart
of scripts/profile_lggnn.py).

    python -m hgnn2_torch.scripts.profile_lggnn [--molecules 16384]
        [--batch_size 2048] [--h 1] [--packed]
        [--sweep_h 1 4 16] [--split] [--device cuda|cpu] [--out DIR]

Trains GNNLineGraph (L=5, J=1, update order 2; the dense layout, whose
exchange takes the index-form kernels on the card) or PackedLGGNN
(``--packed``, the segment-sum layout) on synthetic QM9-shaped molecules through the
shipped pipeline: DenseLoader(with_line_graph=True) or PackedLoader
under CachedLoader(shuffle=False), Adamax at lr 3e-4,
group_stacked_batches and make_scanned_epoch, every step one replayed
CUDA graph. One warm-up epoch (the captures: compile_s) precedes the
best of 3 timed run_epoch_scanned epochs (host clock, each ending in the
metrics' fetch). One more epoch runs under profiling.trace into
DIR/trace_{layout}_h{h}/trace.json, and the profiler's kernel table
(profile_ccn1d_util.parse_kernel_stats: device kernels, memcpy and memset
by self device time) gives DIR/summary_{layout}_h{h}.json and
DIR/op_table_{layout}_h{h}.md, with JAX's keys plus n_kernels_per_step
(the traced epoch's kernel launches over its steps) and card (nvidia-smi's
name and power limit). ``--sweep_h`` times each width without a trace
and writes DIR/h_sweep_{layout}.json. DIR defaults to
runs/profile_lggnn_torch; set-up (records, batches) is logged apart from
the epochs. The harness runs on the card, or on the CPU with --device
cpu (no card: it raises).

``--split`` (dense layout) profiles eager train steps instead, 3 warm
and 5 profiled at each shape group (node/edge buckets) of the loader's
batches, and splits each group's device time a step into the kernels
launched inside hgnn2.lg.exchange (the forward, and the backward as the
autograd nodes whose sequence numbers are those of the forward ops
inside it), inside hgnn2.lg.bundle, the batch norm's kernels
(bn_forward and bn_backward by name) and the rest; with the host's
hgnn2.lg.build seconds over the loader's batches (built under a CPU
profiler, so its spans record). A replayed graph runs no host code, so
only eager steps attribute device time to these spans. It writes
DIR/split_dense_h{h}.json.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import torch

from hgnn2_torch import convert, profiling
from hgnn2_torch.data import batching, qm9, stats
from hgnn2_torch.nn import models, packed
from hgnn2_torch.scripts import profile_ccn1d_util as util
from hgnn2_torch.training import optim, train
from hgnn2_torch.training.config import OptimConfig


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def build(records, ts, h, bs, use_packed, device=None, init_params=None):
    """JAX's build on ``device``: (model, stacked groups, scan_fn, steps
    an epoch). init_params: flax variables of the JAX model (JAX's init
    through hgnn2_torch.convert); else weights from seed 0."""
    dev = util.harness_device(device)
    gen = torch.Generator().manual_seed(0)
    n_in = records[0].x.shape[1]
    if use_packed:
        inner = batching.PackedLoader(records, bs, task=0, sort=True,
                                      device=dev)
        model = packed.PackedLGGNN(n_features=h, n_layers=5, in_features=n_in,
                                   J=1, order=2, generator=gen)
    else:
        inner = batching.DenseLoader(records, bs, task=0,
                                     with_line_graph=True, sort=True,
                                     device=dev)
        model = models.GNNLineGraph(in_features=n_in, n_features=h,
                                    n_layers=5, J=1, order=2, generator=gen)
    if init_params is not None:
        model.load_state_dict(convert.variables_from_flax(init_params))
    model.to(dev)
    loader = batching.CachedLoader(inner, shuffle=False).materialize()
    opt, sched = optim.build_optimizer(OptimConfig(optim="adamax", lr=3e-4),
                                       len(loader), model.parameters())
    groups = train.group_stacked_batches(loader.batches())
    scan_fn = train.make_scanned_epoch(model, opt, sched, "regression",
                                       float(ts.mean[0]), float(ts.std[0]))
    return model, groups, scan_fn, len(loader)


def timed_epochs(groups, scan_fn, epochs=3):
    """(best epoch s, first epoch s, the last epoch's metrics): the first
    epoch captures the step graphs (JAX's compile)."""
    t0 = time.perf_counter()
    train.run_epoch_scanned(groups, scan_fn)
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(epochs):
        t0 = time.perf_counter()
        mets = train.run_epoch_scanned(groups, scan_fn)
        times.append(time.perf_counter() - t0)
    return min(times), compile_s, mets


def _device_us(e) -> float:
    return float(getattr(e, "device_time_total", 0.0) or 0.0)


def split(records, ts, h, bs, device=None, warm=3, steps=5) -> dict:
    """The --split profile (module docstring): the eager step's device
    time at each shape group, split by the hgnn2.lg.* spans."""
    from torch.profiler import ProfilerActivity, profile

    dev = util.harness_device(device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        batches = list(batching.DenseLoader(records, bs, task=0,
                                            with_line_graph=True, sort=True,
                                            device=dev))
        build_ns = sum(s.end_ns - s.start_ns for s in profiling.spans()
                       if s.name == "hgnn2.lg.build")
    loader_s = time.perf_counter() - t0
    model = models.GNNLineGraph(
        in_features=records[0].x.shape[1], n_features=h, n_layers=5, J=1,
        order=2, generator=torch.Generator().manual_seed(0)).to(dev).train()
    opt, _ = optim.build_optimizer(OptimConfig(optim="adamax", lr=3e-4),
                                   len(batches), model.parameters())
    mean, std = float(ts.mean[0]), float(ts.std[0])
    groups = collections.Counter()
    first = {}
    for b in batches:
        key = f"{b.x.shape[1]}/{b.lg_src.shape[1]}"
        groups[key] += 1
        first.setdefault(key, b)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    cpu = torch.autograd.DeviceType.CPU
    out = {"card": util.card(dev), "h": h, "molecules": len(records),
           "batch_size": bs, "batches": len(batches), "loader_s": loader_s,
           "lg_build_s": build_ns * 1e-9, "groups": {}}
    for key, b in first.items():
        for _ in range(warm):
            train._train_body(model, opt, b, "regression", mean, std)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        with profile(activities=acts) as prof:
            for _ in range(steps):
                train._train_body(model, opt, b, "regression", mean, std)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        evs = prof.events()
        # a user annotation's shadow on the device (Optimizer.step#...) is no work
        notes = {e.name for e in evs if getattr(e, "is_user_annotation", False)}
        rows = [e for e in prof.key_averages()
                if e.device_type != cpu and e.key not in notes]
        total = sum(float(e.self_device_time_total) for e in rows)
        bn = sum(float(e.self_device_time_total) for e in rows
                 if "bn_forward" in e.key or "bn_backward" in e.key)
        launches = sum(e.count for e in rows
                       if not e.key.startswith(("Memcpy", "Memset")))
        span_us = collections.Counter()
        span_n = collections.Counter()
        seqs = set()

        def walk(e):
            sq = getattr(e, "sequence_nr", -1)
            if sq is not None and sq >= 0:
                seqs.add(sq)
            for c in e.cpu_children:
                walk(c)

        for e in evs:
            if e.device_type != cpu or e.name not in ("hgnn2.lg.exchange",
                                                      "hgnn2.lg.bundle"):
                continue
            up = e.cpu_parent
            while up is not None and up.name != e.name:
                up = up.cpu_parent
            if up is not None:  # nested in a span of its name: counted there
                continue
            span_us[e.name] += _device_us(e)
            span_n[e.name] += 1
            if e.name == "hgnn2.lg.exchange":
                walk(e)
        bwd = [e for e in evs if e.device_type == cpu
               and e.name.startswith("autograd::engine::evaluate_function:")
               and getattr(e, "sequence_nr", -1) in seqs]
        g = {"steps": steps, "batches": groups[key],
             "device_us_a_step": total / steps,
             "launches_a_step": launches / steps,
             "exchange_spans_a_step": span_n["hgnn2.lg.exchange"] / steps,
             "exchange_fwd_us": span_us["hgnn2.lg.exchange"] / steps,
             "exchange_bwd_us": sum(_device_us(e) for e in bwd) / steps,
             "exchange_bwd_nodes": len(bwd) / steps,
             "bundle_us": span_us["hgnn2.lg.bundle"] / steps,
             "bn_us": bn / steps}
        g["rest_us"] = (g["device_us_a_step"] - g["exchange_fwd_us"]
                        - g["exchange_bwd_us"] - g["bundle_us"] - g["bn_us"])
        out["groups"][key] = g
        log(f"group {key} ({groups[key]} batches): device "
            f"{g['device_us_a_step']:.1f} us a step, "
            f"{g['launches_a_step']:.1f} launches; exchange fwd "
            f"{g['exchange_fwd_us']:.1f} bwd {g['exchange_bwd_us']:.1f}; "
            f"bundle {g['bundle_us']:.1f}; BN {g['bn_us']:.1f}; "
            f"rest {g['rest_us']:.1f}")
    log(f"loader {loader_s:.3f} s, hgnn2.lg.build {out['lg_build_s']:.3f} s "
        f"over {len(batches)} batches")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--molecules", type=int, default=16384)
    ap.add_argument("--batch_size", type=int, default=2048)
    ap.add_argument("--h", type=int, default=1)
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--sweep_h", type=int, nargs="*", default=None)
    ap.add_argument("--split", action="store_true",
                    help="eager steps' device time split by the hgnn2.lg.*"
                         " spans (dense layout)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("runs",
                                                  "profile_lggnn_torch"))
    args = ap.parse_args(argv)
    dev = util.harness_device(args.device)
    name = util.card(dev)
    log(name)

    t0 = time.perf_counter()
    records = qm9.synthetic_qm9_like(args.molecules, seed=0)
    ts = stats.compute_target_stats(records)
    log(f"set-up: {len(records)} records in {time.perf_counter() - t0:.1f} s")
    n_mol = len(records)
    layout = "packed" if args.packed else "dense"
    os.makedirs(args.out, exist_ok=True)

    if args.split:
        if args.packed:
            ap.error("--split profiles the dense layout only")
        out = split(records, ts, args.h, args.batch_size, dev)
        with open(os.path.join(args.out, f"split_dense_h{args.h}.json"),
                  "w") as f:
            json.dump(out, f, indent=2)
        print(json.dumps(out))
        return out

    if args.sweep_h:
        out = []
        for h in args.sweep_h:
            t0 = time.perf_counter()
            _, groups, scan_fn, n_steps = build(
                records, ts, h, args.batch_size, args.packed, dev)
            log(f"set-up: batches in {time.perf_counter() - t0:.1f} s")
            epoch_s, compile_s, mets = timed_epochs(groups, scan_fn)
            row = {
                "layout": layout, "h": h, "epoch_s": epoch_s,
                "per_step_ms": 1e3 * epoch_s / n_steps,
                "molecules_per_s": n_mol / epoch_s,
                "compile_s": compile_s,
                "loss": float(mets["loss"]),
            }
            out.append(row)
            log(f"h={h} [{layout}]: epoch {epoch_s:.4f} s "
                f"({row['per_step_ms']:.3f} ms/step, "
                f"{row['molecules_per_s']:,.0f} mol/s) on {name}")
            del groups, scan_fn
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        with open(os.path.join(args.out, f"h_sweep_{layout}.json"), "w") as f:
            json.dump(out, f, indent=2)
        print(json.dumps(out))
        return out

    t0 = time.perf_counter()
    _, groups, scan_fn, n_steps = build(
        records, ts, args.h, args.batch_size, args.packed, dev)
    log(f"set-up: batches in {time.perf_counter() - t0:.1f} s")
    epoch_s, compile_s, mets = timed_epochs(groups, scan_fn)
    log(f"[{layout} h={args.h}] scanned epoch {epoch_s:.4f} s over {n_steps} "
        f"steps ({1e3 * epoch_s / n_steps:.3f} ms/step, "
        f"{n_mol / epoch_s:,.0f} mol/s), capture epoch {compile_s:.2f} s")

    trace_dir = os.path.join(args.out, f"trace_{layout}_h{args.h}")
    with profiling.trace(trace_dir) as prof:
        train.run_epoch_scanned(groups, scan_fn)
    top, all_rows = util.parse_kernel_stats(prof)

    dev_total_us = sum(r["total_time"] for r in all_rows)
    summary = {
        "layout": layout,
        "h": args.h,
        "molecules": n_mol,
        "batch_size": args.batch_size,
        "steps_per_epoch": n_steps,
        "scanned_epoch_s": epoch_s,
        "per_step_ms": 1e3 * epoch_s / n_steps,
        "molecules_per_s": n_mol / epoch_s,
        "device_time_total_us": dev_total_us,
        "n_kernels_per_step": util.kernel_launches(all_rows) / n_steps,
        "card": name,
        "top_ops": top,
    }
    with open(os.path.join(args.out, f"summary_{layout}_h{args.h}.json"),
              "w") as f:
        json.dump(summary, f, indent=2)
    md = util.op_table(
        f"# Scanned LGGNN step profile ({layout}, h={args.h})",
        f"epoch {epoch_s:.4f} s / {n_steps} steps = "
        f"{1e3 * epoch_s / n_steps:.3f} ms/step; device time "
        f"{dev_total_us / 1e3:.3f} ms over the traced epoch; "
        f"{summary['n_kernels_per_step']:.1f} kernels a step; {name}", top,
        dev_total_us)
    with open(os.path.join(args.out, f"op_table_{layout}_h{args.h}.md"),
              "w") as f:
        f.write("\n".join(md) + "\n")
    log("\n".join(md[:20]))
    print(json.dumps({k: v for k, v in summary.items() if k != "top_ops"}))
    return summary


if __name__ == "__main__":
    main()
