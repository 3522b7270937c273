"""CCN-2D runs that only the card can time: vertex chunks under edge
shards, the scan at QM9's K, and the crossover ladder past K = 128.

    python -m hgnn2_torch.scripts.ccn_card_runs [--only chunks scan ladder]
        [--ks 128 160 ...] [--device cuda|cpu] [--out DIR]

  chunks  main_ccn_qm9 --k 2 --L 2 --h 2 --bs 64 --edge_shards 4 with
          --chunks 2 and with --chunks 1 (the plain path: a sharded CCN
          step runs the kernels only with --ccn_kernel), 3 epochs over
          1,000 molecules (main_ccn_qm9's default) from the same seeded
          weights; every
          metric of the two histories within CHUNK_RTOL; ms a step of each
          (the last epoch's host time over its steps, evaluation
          included) and the peak device memory.
  scan    CCN2D L=2 h=2 on bench_suite's CCN batch (the first 1,024 of
          its 4,096 molecules, k_max 5, K = 5) on the materialized path,
          with scan_promotion=True and with the kernels (K3, K4), each
          through bench_suite.train_family (10 Adamax steps a replayed
          graph) from the same seeded weights: ms a step and peak memory;
          each call's loss of the scan and kernel paths within SCAN_RTOL x
          the largest |loss| of the materialized path's (bench_suite's
          30 timed calls).
  ladder  ccn_crossover's scan rows (16 complete graphs of K nodes,
          CCN2D L=2 h=2, a process a configuration) at --ks, stopping at
          the first that fails: the largest K that trains, its ms a step
          and peak.

Each writes DIR/<name>.json (DIR by default runs/ccn_card_runs_torch; it
must end in "_torch") with the card's name and power limit. Logs go to
stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

CHUNK_ARGV = ["--k", "2", "--L", "2", "--h", "2", "--bs", "64",
              "--edge_shards", "4"]
CHUNK_RTOL = 1e-5  # --chunks 2 vs --chunks 1: every metric of every epoch
SCAN_RTOL = 1e-4  # scan vs materialized, times the largest |loss|
LADDER_KS = (128, 160, 192, 224, 256)
OUT = os.path.join("runs", "ccn_card_runs_torch")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def history_err(got: list, want: list) -> float:
    """The largest relative difference of two histories' metrics
    (epoch_time_s left out)."""
    if len(got) != len(want):
        raise AssertionError(f"histories of {len(got)} and {len(want)} rows")
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
               for a, b in zip(got, want) for k in b if k != "epoch_time_s")


def _chunk_run(c: int, epochs: int, n_synthetic: int, device: str, dev,
               steps: int, logs: str) -> dict:
    from hgnn2_torch.cli import main_ccn_qm9

    argv = CHUNK_ARGV + ["--chunks", str(c), "--epochs", str(epochs),
                         "--n_synthetic", str(n_synthetic), "--device",
                         device, "--log_path",
                         os.path.join(logs, f"chunks{c}")]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, hist = main_ccn_qm9.main(argv)
    if model.vertex_chunks != c or model.kernel:
        raise AssertionError(f"--chunks {c}: built {model}")
    run = {"history": hist, "wall_s": time.perf_counter() - t0,
           "ms_per_step": hist[-1]["epoch_time_s"] / steps * 1e3,
           "peak_bytes": (torch.cuda.max_memory_allocated()
                          if dev.type == "cuda" else None)}
    log(f"--edge_shards 4 --chunks {c}: {run['ms_per_step']:.3f} ms a step "
        f"(last epoch, host clock), peak {run['peak_bytes']}")
    return run


def chunks(device: str, epochs: int = 3, n_synthetic: int = 1000) -> dict:
    """main_ccn_qm9 --edge_shards 4 with --chunks 2 and 1 (their logs in a
    temporary directory)."""
    import tempfile

    dev = torch.device(device)
    runs = {}
    steps = -(-int(0.8 * n_synthetic) // 64)
    with tempfile.TemporaryDirectory(prefix="ccn_chunks_") as logs:
        for c in (2, 1):
            runs[c] = _chunk_run(c, epochs, n_synthetic, device, dev, steps,
                                 logs)
    err = history_err(runs[2]["history"], runs[1]["history"])
    log(f"--chunks 2 vs --chunks 1: histories max rel err {err:.3e} "
        f"(tolerance {CHUNK_RTOL})")
    if err > CHUNK_RTOL:
        raise AssertionError("--chunks 2 departs from --chunks 1")
    return {"argv": CHUNK_ARGV, "epochs": epochs, "n_synthetic": n_synthetic,
            "steps_per_epoch": steps, "max_rel_err": err,
            "tolerance": CHUNK_RTOL,
            "runs": {f"chunks{c}": r for c, r in runs.items()}}


def scan_k5(device: str, bs: int | None = None,
            steps: int | None = None) -> dict:
    """CCN2D L=2 h=2 at K = 5 on bench_suite's CCN batch: materialized,
    scan and kernel paths."""
    from hgnn2_torch.nn import ccn
    from hgnn2_torch.ops import ccn_fused
    from hgnn2_torch.scripts import bench_suite

    dev = torch.device(device)
    bs, steps = bs or bench_suite.BATCH, steps or bench_suite.STEPS
    records = bench_suite.qm9_records(bs)
    n = bs // 4
    cb = ccn.make_ccn_batch(records[:n], k_max=5, task=0,
                            vertex_capacity=1 + 12 * n, device=dev)
    K = int(cb.nbr.shape[1])
    rows = {}
    paths = (("materialized", False, False), ("scan", False, True),
             ("kernel", ccn_fused.use_kernel(K, dev), False))
    for name, kernel, scan in paths:
        rows[name] = bench_suite.train_family(
            f"ccn2d L2 K={K} {name}",
            bench_suite.ccn_model("ccn2d", records[0].x.shape[1], 2, kernel,
                                  scan).to(dev), cb, n, steps,
            bench_suite.CCN_LR)
        rows[name]["kernel"] = kernel
    top = max(abs(v) for v in rows["materialized"]["losses"])
    errs = {name: max(abs(a - b) for a, b in zip(
        rows[name]["losses"], rows["materialized"]["losses"])) / top
        for name in ("scan", "kernel")}
    log(f"K = {K}: losses against the materialized path, max err / max "
        f"|loss|: scan {errs['scan']:.3e} (tolerance {SCAN_RTOL}), kernel "
        f"{errs['kernel']:.3e}")
    if K != 5 or errs["scan"] > SCAN_RTOL:
        raise AssertionError(f"the scan at K = {K} departs from the "
                             "materialized path")
    return {"K": K, "V": int(cb.nbr.shape[0]), "molecules": n,
            "steps": steps, "n_inner": bench_suite.N_INNER,
            "max_rel_err": errs, "tolerance": SCAN_RTOL, "rows": rows}


def ladder(device: str, ks=LADDER_KS, n_graphs: int = 16) -> dict:
    """ccn_crossover's scan rows at ks until the first failure."""
    from hgnn2_torch.scripts import ccn_crossover

    rows = []
    for k in ks:
        rows.append(ccn_crossover.run_one(k, "scan", n_graphs, device))
        if "failed" in rows[-1]:
            break
    trained = [r for r in rows if "failed" not in r]
    best = max(trained, key=lambda r: r["K"]) if trained else None
    if best:
        log(f"largest K that trains: {best['K']} ({best['ms_per_step']:.1f} "
            f"ms a step, peak {best['peak_bytes']})")
    return {"n_graphs": n_graphs, "mode": "scan", "rows": rows,
            "largest_K": best and best["K"],
            "largest_K_ms_per_step": best and best["ms_per_step"],
            "largest_K_peak_bytes": best and best["peak_bytes"],
            "first_failure": next((r for r in rows if "failed" in r), None)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=["chunks", "scan", "ladder"],
                    choices=("chunks", "scan", "ladder"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ks", type=int, nargs="*", default=list(LADDER_KS))
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if not os.path.basename(os.path.normpath(args.out)).endswith("_torch"):
        ap.error("--out must end in _torch")
    from hgnn2_torch.scripts.profile_ccn1d_util import card, harness_device

    dev = harness_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    done = {}
    for name in args.only:
        if name == "chunks":
            rec = chunks(str(dev))
        elif name == "scan":
            rec = scan_k5(str(dev))
        else:
            rec = ladder(args.device, args.ks)
        rec["device"] = card(dev)
        done[name] = rec
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump(rec, f, indent=2)
            f.write("\n")
    return done


if __name__ == "__main__":
    main()
