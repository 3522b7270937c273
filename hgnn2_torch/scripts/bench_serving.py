"""Serving latency and throughput on the card (counterpart of
scripts/bench_serving.py).

    python -m hgnn2_torch.scripts.bench_serving [--repeats 30]
        [--device cuda|cpu] [--out DIR]

Saves the JAX script's bundles with hgnn2_torch.serving.save_bundle
(the port exports no program: a bundle is the model's weights and each
bucket's input spec) and measures request latency (p50/p99 over
repeated requests) and throughput at request sizes 1, 64 and 2,048,
end to end through ServingModel.predict: the host's greedy packing and
batch build, the copy to the card, the eager forward under
inference_mode and the fetch of the predictions (the returned ndarray
is the sync). Each request size is served twice before it is timed, as
JAX warms it, so p50 leaves out first calls. The bundles, with JAX's
widths and buckets (256, 16, 2048 graph slots, primary first):

- dense_gnn_L15: GNNSimple n_features 2, L=15, J=1 (dense batches, n_max
  32), and dense_gnn_L15_single256, the same weights with the 256
  bucket only (the routing control);
- packed_lggnn_L5: PackedLGGNN n_features 2, L=5, order 2, JAX's packed
  capacities (each bucket's records plus 8 nodes and 8 edges);
- ccn2d_L2: CCN2D h=2, L=2 at JAX's (slots, vertex capacity) buckets
  and receptive field k_all; on the card every layer runs K3
  (ops/csrc/ccn_fused.cu:ccn2d_forward).

Weights come from seeds 0, 1 and 2, or from init_params (JAX's flax
variables through hgnn2_torch.convert). rtt_floor_ms is the host time of
(x + 1).cpu() on a 4-float tensor of the device, the least a synchronous
request pays. Writes DIR/results.json in JAX's format (device: the
card's name and power limit) and prints, before the last line, the K1-K4
launches of the whole run as {"launches": {...}}. DIR defaults to
runs/bench_serving_torch. The harness runs on the card, or on the CPU
with --device cpu (no card: it raises).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from hgnn2_torch import convert, graphs, serving
from hgnn2_torch.data import qm9
from hgnn2_torch.nn import ccn as ccn_mod
from hgnn2_torch.nn import models, packed
from hgnn2_torch.ops import ccn_fused
from hgnn2_torch.scripts import profile_ccn1d_util as util

BUCKETS = (256, 16, 2048)  # primary, small-tail, big-request
N_RECORDS = 4096
SIZES = (1, 64, 2048)
METHODOLOGY = (
    "ServingModel.predict end-to-end: greedy host packing + each chunk's "
    "padded batch built on the host and copied to the device + eager "
    "forward under inference_mode + host fetch; p50/p99 over per-request "
    "wall-clock, each size served twice before it is timed. Bundles are "
    "multi-bucket (16/256/2048 slots): predict routes each chunk to the "
    "smallest bucket that holds the rest of the request, so a 2048-record "
    "request is one chunk instead of eight (the *_single256 control row "
    "shows the difference; every synchronous request pays >= rtt_floor_ms)")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _model(cls, init_params, seed, from_flax, **kw):
    model = cls(**kw, generator=torch.Generator().manual_seed(seed))
    if init_params is not None:
        model.load_state_dict(from_flax(init_params))
    return model.eval()


def build_bundles(records, out_root, init_params=None):
    """JAX's bundles, written under out_root: {name: path}. init_params:
    {"dense", "packed", "ccn"} -> flax variables of JAX's models."""
    init_params = init_params or {}
    n_in = records[0].x.shape[1]
    paths = {}

    def dense_sample(b):
        return graphs.make_dense_batch(records[:b], n_max=32, batch_size=b,
                                       task=0, device="cpu")

    m = _model(models.GNNSimple, init_params.get("dense"), 0,
               convert.dense_variables_from_flax, in_features=n_in,
               n_features=2, n_layers=15, J=1)
    samples = [dense_sample(b) for b in BUCKETS]
    p = os.path.join(out_root, "dense")
    serving.save_bundle(p, m, samples, task=0, mean=1.0, std=2.0)
    paths["dense_gnn_L15"] = p
    p = os.path.join(out_root, "dense1")
    serving.save_bundle(p, m, samples[:1], task=0, mean=1.0, std=2.0)
    paths["dense_gnn_L15_single256"] = p

    def packed_sample(b):
        return graphs.make_packed_batch(
            records[:b],
            node_capacity=sum(r.n_nodes for r in records[:b]) + 8,
            edge_capacity=sum(r.n_dir_edges for r in records[:b]) + 8,
            task=0, batch_size=b, device="cpu")

    pm = _model(packed.PackedLGGNN, init_params.get("packed"), 1,
                convert.packed_variables_from_flax, n_features=2, n_layers=5,
                in_features=n_in, J=1, order=2)
    p = os.path.join(out_root, "packed")
    serving.save_bundle(p, pm, [packed_sample(b) for b in BUCKETS], task=0,
                        mean=1.0, std=2.0)
    paths["packed_lggnn_L5"] = p

    k_all = max(r.max_degree() for r in records) + 1
    cm = _model(ccn_mod.CCN2D, init_params.get("ccn"), 2,
                convert.ccn_params_from_flax, n_features=n_in, hidden=2,
                n_layers=2)
    p = os.path.join(out_root, "ccn")
    serving.save_bundle(
        p, cm, [(b, sum(r.n_nodes for r in records[:b]) + 8) for b in BUCKETS],
        k_max=k_all, task=0, mean=1.0, std=2.0)
    paths["ccn2d_L2"] = p
    return paths


def bench_requests(sm, records, size, repeats):
    """JAX's bench_requests: ``repeats`` requests of ``size`` records,
    after two warm-up requests; predictions must be finite."""
    reqs = [records[(i * size) % (len(records) - size)
                    : (i * size) % (len(records) - size) + size]
            for i in range(repeats)]
    sm.predict(reqs[0])  # first calls: kernels, cuBLAS handles, allocations
    sm.predict(reqs[0])
    lat = []
    t_all = time.perf_counter()
    for r in reqs:
        t0 = time.perf_counter()
        out = sm.predict(r)  # returns a host ndarray -> full sync
        lat.append(time.perf_counter() - t0)
        if not np.isfinite(out).all():
            raise ValueError(f"non-finite predictions for a {size}-record "
                             "request")
    wall = time.perf_counter() - t_all
    lat_ms = np.array(lat) * 1e3
    return {
        "request_records": size,
        "repeats": repeats,
        "latency_ms_p50": round(float(np.percentile(lat_ms, 50)), 3),
        "latency_ms_p99": round(float(np.percentile(lat_ms, 99)), 3),
        "latency_ms_mean": round(float(lat_ms.mean()), 3),
        "throughput_molecules_per_s": round(size * repeats / wall, 1),
    }


def rtt_floor_ms(dev) -> float:
    """Host ms of one tiny device op and its fetch, (x + 1).cpu() on a
    4-float tensor: 30 calls after one."""
    x = torch.zeros(4, device=dev)
    (x + 1).cpu()
    t0 = time.perf_counter()
    for _ in range(30):
        (x + 1).cpu()
    return (time.perf_counter() - t0) / 30 * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("runs",
                                                  "bench_serving_torch"))
    args = ap.parse_args(argv)
    dev = util.harness_device(args.device)

    records = qm9.synthetic_qm9_like(N_RECORDS, seed=0)
    rtt_ms = rtt_floor_ms(dev)
    name = util.card(dev)
    log(f"dispatch+fetch RTT floor: {rtt_ms:.4f} ms on {name}")
    results = {"device": name, "rtt_floor_ms": round(rtt_ms, 4),
               "methodology": METHODOLOGY, "bundles": {}}
    counters = {"K1": ccn_fused.fused_contract_1d_forward,
                "K2": ccn_fused.fused_contract_1d_backward,
                "K3": ccn_fused.fused_contract_forward,
                "K4": ccn_fused.fused_contract_backward}
    before = {k: c.launches for k, c in counters.items()}
    with tempfile.TemporaryDirectory() as tmp:
        for bundle, path in build_bundles(records, tmp).items():
            sm = serving.load_bundle(path, device=dev)
            rows = []
            for size in SIZES:
                reps = args.repeats if size < 2048 else max(
                    5, args.repeats // 5)
                row = bench_requests(sm, records, size, reps)
                rows.append(row)
                log(f"{bundle} x{size}: p50 {row['latency_ms_p50']} ms, "
                    f"p99 {row['latency_ms_p99']} ms, "
                    f"{row['throughput_molecules_per_s']:,.1f} mol/s")
            results["bundles"][bundle] = rows

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
        f.write("\n")
    print(json.dumps({"launches": {k: c.launches - before[k]
                                   for k, c in counters.items()}}))
    print(json.dumps({k: v[-1] for k, v in results["bundles"].items()}))
    return results


if __name__ == "__main__":
    main()
