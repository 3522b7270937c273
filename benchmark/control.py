"""The readings the limits of a cell's check are set from, at the cell's own
sizes, on the card:

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 ... [--seconds 20] [--faults 4] [--unchanged 4] [--warm 0]

For each seed, one line of JSON with the numbers the check compares (the
control's and the faults' on the first --faults seeds only):

- "program": the port's, from a run of the cell (a window of --seconds;
  a training cell's first steps do not depend on it);
- "control": the reference put in the port's place and computed in TF32
  (reference.common.matmul_tf32: every product's operands rounded to 10
  mantissa bits), held to the float32 reference;
- "half_batch" (training cells): the reference with the second half of
  each batch left out and the mean taken over the rest;
- "state_unchanged" (training cells; the first --unchanged seeds of
  those, all by default): the port's, from a run of the cell whose
  optimizer step returns the state unchanged (Adamax.step a no-op, so
  the captured graphs hold no update).

--warm 0 leaves out the mix's warm-up of the card: a training cell's
checked steps come before it.

The benchmark's own runs never run this; tests/test_benchmark_checks.py
holds the control to the limits at a size a test run holds.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import numpy as np

from benchmark import arrivals, frozen, run
from benchmark.drivers import serve, train
from benchmark.reference import common


def train_readings(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The control's and the half-batch fault's numbers against the float32
    reference, over three batches of the cell's deal drawn from the seed."""
    ref = importlib.import_module(f"benchmark.reference.{cfg['model']}")
    port_deal = importlib.import_module(f"benchmark.models.{cfg['model']}").deal
    mols = train.molecules(cfg["train_molecules"], seed)
    deal = port_deal(mols, traffic["batch"])
    pick = np.random.default_rng(seed).permutation(len(deal))[:train.N_CHECKED]
    chunks = [[mols[i] for i in deal[j]] for j in pick]
    params, buffers = common.draw_weights(ref.param_spec(cfg),
                                          ref.buffer_spec(cfg), seed, device)
    mean, std = common.target_stats(mols, cfg["task"])

    def steps(chs, mm=common.matmul):
        return common.train_steps(ref, cfg, params, buffers, chs, mean, std,
                                  len(deal), device, mm=mm)

    base = steps(chunks)

    def held(r):
        return train.compare(r["losses"], r["grads"], r["params"], params, base)

    return {"control": held(steps(chunks, common.matmul_tf32)),
            "half_batch": held(steps([c[:len(c) // 2] for c in chunks]))}


def unchanged_readings(workload: str, seed: int, device, spec=None,
                       overrides=None) -> dict:
    """The check's numbers of a run of the cell whose Adamax step returns
    its state unchanged (a window of one second: the check reads the
    steps before it)."""
    import torch

    readings: dict = {}
    step = torch.optim.Adamax.step
    torch.optim.Adamax.step = lambda self, closure=None: None
    try:
        run.run_cell(workload, seed, 1.0, False, device, overrides=overrides,
                     t_start=time.perf_counter(), spec=spec, readings=readings)
    finally:
        torch.optim.Adamax.step = step
    return readings


def serve_readings(cfg: dict, traffic: dict, seed: int, seconds: float,
                   device) -> dict:
    """The control's numbers over the molecules of a run's requests."""
    ref = importlib.import_module(f"benchmark.reference.{cfg['model']}")
    mols = frozen.synthetic_qm9_like(traffic["pool"], seed)
    reqs = arrivals.requests(traffic, seed, seconds, len(mols))
    flat = [m for _, lo, k in reqs for m in mols[lo:lo + k]]
    params, buffers = common.draw_weights(ref.param_spec(cfg),
                                          ref.buffer_spec(cfg), seed, device)
    mean, std = common.target_stats(mols, cfg["task"])
    want = common.predict(ref, params, buffers, flat, mean, std, device)
    got = common.predict(ref, params, buffers, flat, mean, std, device,
                         mm=common.matmul_tf32)
    return {"control": {"pred_gap": serve.gap(got, want)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--faults", type=int, default=None,
                   help="seeds that read the control and faults too (all)")
    p.add_argument("--unchanged", type=int, default=None,
                   help="of those, seeds that read a state left unchanged (all)")
    p.add_argument("--warm", type=float, default=None,
                   help="the mix's warm_seconds in place of its own")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from hgnn2_torch import runtime

    runtime.setup()
    spec = run.benchmark_spec()
    cell = run.find_cell(spec, args.workload)
    cfg = run.load_json("configs", f"{cell['config']}.json")
    traffic = run.load_json("traffic", f"{cell['traffic']}.json")
    dev = torch.device(args.device)
    overrides = ({} if args.warm is None
                 else {"traffic": {"warm_seconds": args.warm}})
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        readings: dict = {}
        res = run.run_cell(args.workload, seed, args.seconds, False, dev,
                           overrides=overrides, t_start=t0, spec=spec,
                           readings=readings)
        line = {"seed": seed, "correct": res["correct"], "program": readings,
                "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
        faults = args.faults is None or i < args.faults
        if faults and traffic["kind"] == "train":
            line.update(train_readings(cfg, traffic, seed, dev))
            if args.unchanged is None or i < args.unchanged:
                line["state_unchanged"] = unchanged_readings(
                    args.workload, seed, dev, spec, overrides)
        elif faults:
            line.update(serve_readings(cfg, traffic, seed, args.seconds, dev))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
