"""CCN-2D promotion-memory crossover of the port (counterpart of
scripts/ccn_crossover.py): where the materialized path runs out of
device memory.

    python -m hgnn2_torch.scripts.ccn_crossover [--ks 64 80 88]
        [--graphs 16] [--device cuda|cpu] [--out DIR]

The materialized CCN-2D path builds the (V, K, K, K, C) promotion tensor
T in every layer; the scan path (CCN2D(scan_promotion=True),
ops/contractions.promote_contract_18_fused) keeps O(V K^2 C) live
memory. For each K of the ladder, 16 complete graphs of K nodes (so V =
16 K vertices of receptive field K, 3 random features a node) train
CCN2D(L=2, h=2) with each path: training.train.make_multi_train_step
(3 optimizer steps in one replayed CUDA graph, Adamax at lr 1e-3) timed
by profiling.time_scan_steps (1 warm-up call, 3 timed calls). Each
configuration runs in its own process and prints one JSON line with the
fields of the JAX script (K, V, mode, n_graphs, materialized_T_bytes_fwd,
ms_per_step, graphs_per_s) plus peak_bytes (torch.cuda.max_memory_allocated
over the whole call; null on the CPU) and the device's name. A
configuration that fails, out of memory above all, is a row of the ladder
with its error line and the tail of its traceback; as in the JAX script
it is tried again at half the graphs, which a failure in proportion to
memory survives. The rows go to DIR/results.json (default
runs/ccn_crossover_torch, which git ignores) and, as one JSON list, to
standard output. On CUDA the parent prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODES = ("materialized", "scan")
N_INNER = 3  # optimizer steps a replayed graph
TIMED_CALLS = 3
CHILD_TIMEOUT_S = 1800


def complete_graphs(k_nodes: int, n_graphs: int, seed: int = 7) -> list:
    """n_graphs complete graphs of k_nodes nodes, 3 standard normal
    features a node, target 0.1 (the JAX script's)."""
    import numpy as np

    from hgnn2_torch import graphs

    rng = np.random.default_rng(seed)
    adj = (np.ones((k_nodes, k_nodes), np.float32)
           - np.eye(k_nodes, dtype=np.float32))
    return [graphs.GraphRecord(
        x=rng.standard_normal((k_nodes, 3)).astype(np.float32), adj=adj,
        y=np.float32(0.1)) for _ in range(n_graphs)]


def child(k_nodes: int, mode: str, n_graphs: int, device: str) -> None:
    import torch

    from hgnn2_torch import profiling, resolve_device, runtime
    from hgnn2_torch.nn import ccn as ccn_mod
    from hgnn2_torch.training import optim
    from hgnn2_torch.training import train as train_lib
    from hgnn2_torch.training.config import OptimConfig

    runtime.setup()
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    cb = ccn_mod.make_ccn_batch(complete_graphs(k_nodes, n_graphs),
                                vertex_capacity=k_nodes * n_graphs, device=dev)
    K = int(cb.nbr.shape[1])
    V = k_nodes * n_graphs
    t_bytes = V * K ** 3 * 2 * 4  # the forward's T alone at C = 2
    print(json.dumps({"phase": "built", "K": K, "V": V, "n_graphs": n_graphs,
                      "materialized_T_bytes_fwd": t_bytes}), flush=True)
    model = ccn_mod.CCN2D(n_features=3, hidden=2, n_layers=2,
                          scan_promotion=(mode == "scan"),
                          generator=torch.Generator().manual_seed(0)).to(dev)
    opt, sched = optim.build_optimizer(OptimConfig(optim="adamax", lr=1e-3),
                                       100, model.parameters())
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    step = train_lib.make_multi_train_step(model, opt, sched, "regression",
                                           0.0, 1.0, n_inner=N_INNER)
    timing = profiling.time_scan_steps(step, cb, steps=TIMED_CALLS, warmup=1)
    per_step = timing.per_step_s / N_INNER
    print(json.dumps({
        "K": K, "V": V, "mode": mode, "n_graphs": n_graphs,
        "materialized_T_bytes_fwd": t_bytes,
        "ms_per_step": per_step * 1e3,
        "graphs_per_s": n_graphs / per_step,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
        "device": name,
    }), flush=True)


_ERROR_PATTERNS = ("OutOfMemoryError", "out of memory", "CUDA error",
                   "RuntimeError", "Error")


def failure_evidence(stderr: str) -> tuple[str, str]:
    """(the exception's line, the last 12 lines of stderr)."""
    lines = [ln for ln in stderr.strip().splitlines() if ln.strip()]
    best = None
    for pat in _ERROR_PATTERNS:
        best = next((ln for ln in reversed(lines) if pat in ln), None)
        if best:
            break
    tail = "\n".join(lines[-12:])
    return (best or (lines[-1] if lines else "?")).strip()[:400], tail


def run_one(k: int, mode: str, n_graphs: int, device: str) -> dict:
    """One configuration in its own process: its row of the ladder."""
    proc = subprocess.run(
        [sys.executable, "-m", "hgnn2_torch.scripts.ccn_crossover",
         "--child", str(k), "--mode", mode, "--graphs", str(n_graphs),
         "--device", device],
        cwd=REPO, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    row = {"k_nodes": k, "mode": mode, "n_graphs": n_graphs}
    parsed = None
    for line in proc.stdout.splitlines():
        try:
            cand = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(cand, dict) and "ms_per_step" in cand:
            parsed = cand
        elif isinstance(cand, dict) and cand.get("phase") == "built":
            row.update({k_: v for k_, v in cand.items() if k_ != "phase"})
    if proc.returncode == 0 and parsed:
        row.update(parsed)
        peak = parsed["peak_bytes"]
        print(f"K~{k} {mode} x{n_graphs}: {parsed['ms_per_step']:.1f} ms/step,"
              f" peak {'n/a' if peak is None else f'{peak / 1e9:.2f} GB'} "
              f"(T fwd {parsed['materialized_T_bytes_fwd'] / 1e9:.1f} GB) on "
              f"{parsed['device']}", file=sys.stderr, flush=True)
    else:
        err, tail = failure_evidence(proc.stderr)
        row["failed"] = err
        row["traceback_tail"] = tail
        print(f"K~{k} {mode} x{n_graphs}: FAILED {err[:160]}",
              file=sys.stderr, flush=True)
    return row


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ks", type=int, nargs="*", default=[64, 80, 88])
    ap.add_argument("--graphs", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("runs",
                                                  "ccn_crossover_torch"))
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mode", choices=MODES, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child, args.mode, args.graphs, args.device)
        return []
    if args.device.startswith("cuda"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(smi.splitlines()[0], file=sys.stderr, flush=True)
    rows = []
    for k in args.ks:
        for mode in MODES:
            row = run_one(k, mode, args.graphs, args.device)
            rows.append(row)
            if "failed" in row and args.graphs > 4:
                rows.append(run_one(k, mode, args.graphs // 2, args.device))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump({"note": "complete graphs, CCN2D L=2 h=2, "
                           f"{N_INNER} Adamax steps a replayed graph; each "
                           "configuration in its own process; a failed one "
                           "is tried again at half the graphs; 'failed' is "
                           "the exception's line, traceback_tail the last "
                           "12 lines of stderr",
                   "rows": rows}, f, indent=2)
        f.write("\n")
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
