"""The knee of a serving cell's configuration: the highest offered rate at
which the port completes at least 98 % of the offered rate and the backlog
does not grow. Run once, on the card; the rate a serve cell offers (about
0.8 x the knee) is written into its traffic file as a number.

    python3 -m benchmark.knee --workload <serve cell> --rates 40 80 ... [--seconds 15]

One set-up (the cell's bundle, warmed), then for each rate an open-loop
window of --seconds with the cell's traffic at that rate (new arrivals,
the same seed). A line of JSON per rate: offered and completed requests a
second, p50 and p95 ms, and the mean queue wait of the first and the last
fifth of the requests (a backlog that grows shows as the second far above
the first).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import numpy as np

from benchmark import arrivals, run
from benchmark.drivers import serve


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    spec = run.benchmark_spec()
    cell = run.find_cell(spec, args.workload)
    cfg = run.load_json("configs", f"{cell['config']}.json")
    traffic = run.load_json("traffic", f"{cell['traffic']}.json")
    ctx = run.Ctx(cell=cell, cfg=cfg, traffic=traffic, seed=args.seed,
                  seconds=args.seconds, trace=False,
                  device=torch.device(args.device),
                  port=importlib.import_module(f"benchmark.models.{cfg['model']}"),
                  ref=importlib.import_module(f"benchmark.reference.{cfg['model']}"),
                  t_start=time.perf_counter())
    plans = {r: arrivals.requests({**traffic, "rate_per_s": r}, args.seed,
                                  args.seconds, traffic["pool"])
             for r in args.rates}
    srv = serve.setup(ctx, [q for reqs in plans.values() for q in reqs])
    for rate, reqs in plans.items():
        w = serve.window(srv, reqs)
        n = len(reqs)
        waits = np.array(w["spans"]["queue_wait_s"]) * 1e3
        fifth = max(1, n // 5)
        ms = sorted(x * 1e3 for x in w["lat"])
        print(json.dumps({
            "rate_offered": n / args.seconds,
            "rate_completed": (n - w["failed"]) / w["window_s"],
            "p50_ms": ms[n // 2], "p95_ms": serve.p95_ms(w["lat"]),
            "wait_first_fifth_ms": float(waits[:fifth].mean()),
            "wait_last_fifth_ms": float(waits[-fifth:].mean()),
            "failed": w["failed"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
