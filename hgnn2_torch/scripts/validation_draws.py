"""The validation runs from other weight draws, their data fixed: how far
a run's quality rests on its initial weights (a diagnosis of runs that
land outside their bands).

    python -m hgnn2_torch.scripts.validation_draws --only NAME ...
        [--draws 0 1 2 3] [--plain] [--device cuda|cpu]

For each run_validation RUNS entry named and each draw d, the entry's
configuration and data (its seed, 0) with the weights build_model draws
under seed d (draw 0 is run_validation's own run), trained through
run_validation.run_one into runs/<name>_draw<d>_torch/ (quality.json
included). --plain puts the CCN models on the plain path (no K1-K4).
Writes runs/validation_draws_torch/draws.json: per run and draw, the
first epoch's train loss (JAX's committed run's beside it), the last-20
medians against BANDS, the minutes and the kernels' launches, with the
card's name and power limit. Runs on the card unless given --device cpu
(no card: it raises).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from hgnn2_torch import convert
from hgnn2_torch.cli import common
from hgnn2_torch.scripts import run_validation as rv
from hgnn2_torch.scripts.profile_ccn1d_util import card, harness_device

OUT = os.path.join("runs", "validation_draws_torch")


def draw(cfg, seed: int):
    """The initial weights build_model draws under ``seed`` for cfg, in
    run_experiment's init_params layout (flax)."""
    records, kind, _, _ = common.load_records(cfg)
    model = common.build_model(dataclasses.replace(cfg, seed=seed), kind,
                               records[0].x.shape[1])
    if cfg.model.arch in ("ccn1d", "ccn2d"):
        return convert.ccn_params_to_flax(model.state_dict())
    return convert.dense_variables_to_flax(model.state_dict())


def jax_first_epoch(name: str):
    """The first epoch's train loss of JAX's committed run, if present."""
    path = os.path.join("runs", name, "results.jsonl")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.loads(f.readline())["train_loss"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", required=True, choices=list(rv.RUNS))
    ap.add_argument("--draws", nargs="+", type=int, default=[0, 1, 2, 3])
    ap.add_argument("--plain", action="store_true",
                    help="CCN models on the plain path (no fused kernels)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = harness_device(args.device)
    out = {"card": card(dev), "plain": args.plain, "runs": {}}
    tag = "_plain" if args.plain else ""
    for name in args.only:
        rows = []
        for d in args.draws:
            cfg = rv.RUNS[name]()
            cfg.device = args.device
            if args.plain:
                cfg.model.ccn_kernel = False
            cfg.log_path = os.path.join("runs", f"{name}_draw{d}{tag}_torch")
            _, history, rec = rv.run_one(name, cfg,
                                         init_params=draw(cfg, d))
            rows.append({
                "draw": d, "first_epoch_train_loss": history[0]["train_loss"],
                "in_band": rec["in_band"], "minutes": rec["minutes"],
                "launches": rec["launches"],
                "medians_last20": {m: v["median_last20"]
                                   for m, v in rec["metrics"].items()}})
            print(json.dumps({name: rows[-1]}), file=sys.stderr, flush=True)
        out["runs"][name] = {"jax_first_epoch_train_loss":
                             jax_first_epoch(name), "draws": rows}
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"draws{tag}.json"), "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
