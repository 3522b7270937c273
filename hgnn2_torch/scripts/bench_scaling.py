"""Scaling harness of the port (counterpart of bench_scaling.py at the repo
root): PackedLGGNN (L=3, h=8, order 2) training steps at 1, 2, 4 and 8
ranks in four partitioning modes, a bare edge-partitioned SpMM, and the
no-overlap projection from exact comm bytes.

    python -m hgnn2_torch.scripts.bench_scaling [--ranks 8]
        [--device cuda|cpu] [--link_gbps 450] [--project_from JSON]
        [--out DIR]

The modes, as in the JAX script:
  * molecule_aligned (the headline): molecules never span ranks
    (spmd.make_packed_shards); the only collectives are the BN
    statistics' and the loss's sums and one gradient all-reduce;
  * hybrid_dp_x_edge: 2 data groups x d/2 edge shards
    (training.sharded.ShardedPackedLoader and make_sharded_step_fns), at
    d >= 4 and even;
  * halo_giant_graph: one giant graph (--nodes nodes, a ring of
    neighbourhoods plus long-range edges) in contiguous node ranges,
    exchanging only halo rows (parallel/halo.py);
  * psum_fallback: replicated node state and one (V, F) all-reduce per
    operator apply (spmd.PartitionedPackedOps), 17 a forward.
Each step is SGD at lr 1e-3 (optax.sgd's update), on the card one
captured CUDA graph (training.train._Graphs), timed by
profiling.time_steps on the host clock. Weights are drawn from seed 0,
the same at every rank count.

Where the ranks run. The JAX script runs d virtual CPU devices in one
process. Here the d ranks share the one device in one process, as every
RankGrid and EdgeMesh of one process does (ranks on one device). So
efficiency_vs_linear measures the ranks' overhead on one card, not
scaling. The comm bytes are shape arithmetic, exact whatever runs them,
and equal the JAX script's: molecule_aligned and hybrid count 2 ring
all-reduces of the BN statistics' and the loss's floats a step and one
of the parameters; halo_giant_graph the halo exchanges of one forward
(halo.halo_comm_bytes) doubled for the backward; psum_fallback the
(V, width) all-reduces of one forward (PartitionedPackedOps.
comm_bytes_per_step) doubled.

The projection bounds real multi-card efficiency with no overlap: eff(d)
>= (t1/d) / (t1/d + bytes(d) / BW), t1 this run's one-rank step time.
BW is --link_gbps GB/s, by default the H100 SXM's NVLink 4 specification
of 450 GB/s a direction: an assumed figure from the data sheet, not a
measurement, written to the JSON as assumed_link_bytes_per_s with
"source": "spec". --project_from JSON re-anchors the rows of an earlier
run of this script on this run's one-rank step times (counts [1] only).

Writes DIR/scaling.json (DIR by default runs/bench_scaling_torch; it must
end in "_torch", so nothing here writes over the JAX script's
BENCH_SCALING.json). Logs go to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

COUNTS = (1, 2, 4, 8)
L, H = 3, 8
LR = 1e-3
LINK_GBPS = 450.0  # NVLink 4, H100 SXM data sheet: 900 GB/s both ways
OUT = os.path.join("runs", "bench_scaling_torch")
NOTE = ("every rank of a mode shares the one device in one process: "
        "efficiency_vs_linear measures the ranks' overhead on this device, "
        "not scaling; comm_bytes_per_step is exact shape arithmetic")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ------------------------------------------------------------ the inputs


def molecules(n: int) -> list:
    """The JAX script's molecules: synthetic_qm9_like(n, seed=1)."""
    from hgnn2_torch.data import qm9

    return qm9.synthetic_qm9_like(n, seed=1)


def giant_graph(V: int):
    """(the JAX script's giant graph, the generator after it): a ring of
    V nodes each joined to its next 3, plus V // 64 random long-range
    edges, symmetrised; 5 features a node, default_rng(0). The bare
    SpMM's inputs come from the same generator after it."""
    from hgnn2_torch import graphs

    rng = np.random.default_rng(0)
    a = np.zeros((V, V), np.float32)
    for v in range(V):
        for dd in range(1, 4):
            a[v, (v + dd) % V] = 1.0
    for _ in range(V // 64):
        i, j = rng.integers(0, V, 2)
        if i != j:
            a[i, j] = 1.0
    a = np.maximum(np.triu(a, 1), np.triu(a.T, 1))
    a = a + a.T
    rec = graphs.GraphRecord(x=rng.standard_normal((V, 5)).astype(np.float32),
                             adj=a, y=np.array([1.0] * 13, np.float32))
    return rec, rng


def bare_spmm_inputs(rng, V: int, E: int, features: int):
    """The bare SpMM's (src, dst, w, x), numpy, from giant_graph's rng."""
    src = np.sort(rng.integers(0, V, E)).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    w = rng.random(E).astype(np.float32)
    x = rng.standard_normal((V, features)).astype(np.float32)
    return src, dst, w, x


# ------------------------------------------------------- steps and bytes


def lggnn(bn_axis=None, state_dict=None):
    """PackedLGGNN(L, H, J=1, order 2) drawn from seed 0, or holding
    state_dict (the port's layout)."""
    from hgnn2_torch.nn import packed

    model = packed.PackedLGGNN(in_features=5, n_features=H, n_layers=L, J=1,
                               order=2, bn_axis=bn_axis,
                               generator=torch.Generator().manual_seed(0))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def _sgd(model):
    from hgnn2_torch.training.config import OptimConfig
    from hgnn2_torch.training.optim import build_optimizer

    return build_optimizer(OptimConfig(optim="sgd", lr=LR, momentum=0.0,
                                       lr_damping=1.0), 1, model.parameters())


def sgd_step(model, loss_of):
    """step() -> the loss: one SGD step on loss_of()'s gradient (optax.sgd:
    p -= lr g), on CUDA one captured graph, replayed."""
    from hgnn2_torch.training import train

    opt, _ = _sgd(model)
    graphs = train._Graphs(model, opt)

    def body():
        opt.zero_grad(set_to_none=False)
        loss = loss_of()
        loss.backward()
        opt.step()
        return loss.detach()

    def step():
        return graphs("step", body).clone()

    step.graphs = graphs
    return step


def n_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def bn_comm_bytes(d: int, params: int) -> float:
    """A molecule-aligned step's all-reduced bytes a rank: each BN train
    call psums its count (1), sums (2H) and squares (2H), two BNs a
    non-final layer, the loss 2 scalars, each in a ring all-reduce
    (2 (d-1)/d), the backward transposing each; plus one all-reduce of
    the replicated parameters' gradients."""
    ring = 2.0 * (d - 1) / d
    fwd_floats = 2 * (L - 1) * (4 * H + 1) + 2
    return 2 * ring * fwd_floats * 4 + ring * 4 * params


def molecule_aligned(records, d: int, dev, state_dict=None):
    """(step, comm bytes) of the molecule-aligned mode over d ranks."""
    from hgnn2_torch.parallel import spmd

    tot_v = sum(r.n_nodes for r in records)
    tot_e = sum(r.n_dir_edges for r in records)
    stacked = spmd.make_packed_shards(
        records, d, node_capacity=-(-tot_v // d) + 32,
        edge_capacity=-(-tot_e // d) + 32,
        graphs_per_shard=-(-len(records) // d) + 8, task=0, device=dev)
    model = lggnn("edge", state_dict).to(dev)
    loss_fn = spmd.sharded_packed_loss(model, spmd.RankGrid(1, d, dev))
    return sgd_step(model, lambda: loss_fn(stacked)), bn_comm_bytes(
        d, n_params(model))


def hybrid(records, d: int, dev, state_dict=None):
    """(step, comm bytes, mesh shape) of the hybrid mode: 2 data groups x
    d/2 edge shards of one batch of every molecule."""
    from hgnn2_torch.parallel import spmd
    from hgnn2_torch.training import sharded

    n_dp, n_es = 2, d // 2
    loader = sharded.ShardedPackedLoader(records, batch_size=len(records),
                                         n_shards=n_es, task=0, n_data=n_dp,
                                         device=dev)
    stacked = loader.peek_sample()
    model = lggnn(("data", "edge"), state_dict).to(dev)
    opt, sched = _sgd(model)
    train_step, _ = sharded.make_sharded_step_fns(
        model, spmd.RankGrid(n_dp, n_es, dev), opt, sched,
        axes=("data", "edge"))

    def step():
        return train_step(stacked)["loss"]

    return step, bn_comm_bytes(d, n_params(model)), [n_dp, n_es]


def halo_giant(pbg, d: int, dev, state_dict=None):
    """(step, halo_comm_bytes' accounting) of the halo mode: the giant
    graph's packed batch in d contiguous node ranges."""
    from hgnn2_torch.parallel import halo, spmd

    bundle = halo.build_halo_lg_bundle(pbg, d, device=dev)
    model = lggnn("edge", state_dict).to(dev)
    mesh = spmd.RankGrid(1, d, dev)
    log_ = halo.new_comm_log()
    with torch.no_grad():  # one forward fills the exchanges' log
        halo.halo_packed_loss(model, mesh, bundle, comm_log=log_)()
    if state_dict is not None:  # the forward moved the BN running stats
        model.load_state_dict(state_dict)
    acct = halo.halo_comm_bytes(log_, bundle, d)
    loss_fn = halo.halo_packed_loss(model, mesh, bundle)
    return sgd_step(model, loss_fn), acct


def psum_fallback(pbig, d: int, dev, state_dict=None):
    """(step, PartitionedPackedOps' accounting) of the fallback: the
    whole batch replicated, its edges split over d ranks, every operator
    apply's (V, width) partials all-reduced."""
    from hgnn2_torch.parallel import spmd

    ops = spmd.PartitionedPackedOps(spmd.EdgeMesh([dev] * d), pbig, J=1)
    model = lggnn(None, state_dict).to(dev).train()

    def loss_of():
        per = (model(pbig, ops=ops)[:, 0] - pbig.y) ** 2
        return (per * pbig.gmask).sum() / pbig.gmask.sum()

    ops.psum_widths.clear()  # count one forward's collectives only
    with torch.no_grad():
        loss_of()
    acct = ops.comm_bytes_per_step()
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return sgd_step(model, loss_of), acct


def bare_spmm(inputs, V: int, d: int, dev):
    """f() -> (V, F): the edge-partitioned SpMM over d ranks of an
    EdgeMesh, its edges padded to a multiple of d."""
    from hgnn2_torch.parallel import spmd

    src, dst, w, x = inputs
    padded = spmd.pad_edges_for_partition({"src": src, "dst": dst, "w": w},
                                          d, V)
    spmm = spmd.partitioned_spmm(spmd.EdgeMesh([dev] * d), V)
    args = [torch.from_numpy(padded[k]).to(dev) for k in ("src", "dst", "w")]
    xt = torch.from_numpy(x).to(dev)
    return lambda: spmm(*args, xt)


def project(t1, per_dev: dict, bw: float) -> dict:
    """The no-overlap efficiency bound at each d > 1 of per_dev's rows."""
    out = {}
    for d, row in per_dev.items():
        if d == 1 or t1 is None:
            continue
        compute = t1 / d
        comm = row["comm_bytes_per_step"] / bw
        out[d] = {"compute_s": compute, "comm_s": comm,
                  "projected_efficiency_lower_bound":
                      compute / (compute + comm)}
    return out


# ------------------------------------------------------------- the runs


def _timed(step, steps: int, warmup: int = 2) -> float:
    from hgnn2_torch import profiling

    return profiling.time_steps(step, steps=steps, warmup=warmup).per_step_s


def _rows(mode: str, counts, build, steps: int, items: int, extra) -> tuple:
    """Every d's row of one mode: build(d) -> (step, acct) or None to skip
    d; extra(acct) -> the row's comm fields. Returns (rows, t1)."""
    rows, base, t1 = {}, None, None
    for d in counts:
        built = build(d)
        if built is None:
            continue
        step, acct = built[0], built[1:]
        per_step = _timed(step, steps, warmup=1 if mode == "hybrid" else 2)
        del step
        eps = items / per_step
        if base is None:
            base, t1 = eps, per_step
        rows[d] = {"edges_per_s": eps,
                   "efficiency_vs_linear": eps / (d * base), **extra(*acct)}
        log(f"  {mode} {d} ranks: {eps:,.0f} edges/s, {per_step * 1e3:.3f} ms "
            f"a step, eff {rows[d]['efficiency_vs_linear']:.2%}, "
            f"{rows[d]['comm_bytes_per_step']:,.0f} B/step")
    return rows, t1


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=8,
                    help="largest rank count of [1, 2, 4, 8]")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=2048)
    ap.add_argument("--avg_degree", type=int, default=16)
    ap.add_argument("--features", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--molecules", type=int, default=1024,
                    help="molecules of the LGGNN train-step runs")
    ap.add_argument("--link_gbps", type=float, default=LINK_GBPS,
                    help="assumed link bandwidth a card and direction, GB/s, "
                         "for the projection (default: the H100 SXM's NVLink "
                         "4 specification)")
    ap.add_argument("--project_from", default=None,
                    help="an earlier scaling.json of this script whose comm "
                         "rows are re-anchored on this run's one-rank step "
                         "times")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if not os.path.basename(os.path.normpath(args.out)).endswith("_torch"):
        ap.error("--out must end in _torch (JAX's results are not the "
                 "port's to write)")
    from hgnn2_torch import graphs
    from hgnn2_torch.scripts.profile_ccn1d_util import card, harness_device

    dev = harness_device(args.device)
    log(f"NOTE: {NOTE}")
    counts = [d for d in COUNTS if d <= args.ranks]
    prior = None
    if args.project_from:
        with open(args.project_from) as f:
            prior = json.load(f)
        counts = [1]
    bw = args.link_gbps * 1e9
    link = {"value": bw, "source": "spec",
            "what": "NVLink 4 bandwidth a direction, H100 SXM data sheet; "
                    "assumed, not measured"}
    results = {"headline_mode": "molecule_aligned",
               "assumed_link_bytes_per_s": link, "note": NOTE,
               "device": card(dev), "torch": torch.__version__,
               "lggnn": {}, "bare_spmm": {}, "projection": {}}

    records = molecules(args.molecules)
    tot_v = sum(r.n_nodes for r in records)
    tot_e = sum(r.n_dir_edges for r in records)
    results["lggnn"].update(molecules=args.molecules, dir_edges=tot_e)

    log("LGGNN train step, molecule-aligned shards (headline):")
    mode_a, t1_mol = _rows(
        "molecule_aligned", counts,
        lambda d: molecule_aligned(records, d, dev), args.steps, tot_e,
        lambda comm: {"comm_bytes_per_step": comm})
    results["lggnn"]["molecule_aligned"] = {"devices": mode_a}
    base_mol = mode_a[1]["edges_per_s"]

    log("LGGNN train step, hybrid dp x edge shards:")
    mode_h, _ = _rows(
        "hybrid", counts,
        lambda d: None if d < 4 or d % 2 else hybrid(records, d, dev),
        args.steps, tot_e,
        lambda comm, mesh: {"mesh": mesh, "comm_bytes_per_step": comm})
    for d, row in mode_h.items():  # efficiency against the one-rank step
        row["efficiency_vs_linear"] = row["edges_per_s"] / (d * base_mol)
    results["lggnn"]["hybrid_dp_x_edge"] = {"devices": mode_h}

    log("LGGNN train step, halo-partitioned giant graph:")
    giant, rng = giant_graph(args.nodes)
    pbg = graphs.make_packed_batch([giant], task=0, device=dev)
    mode_b, t1_halo = _rows(
        "halo_giant_graph", counts,
        lambda d: None if args.nodes % d else halo_giant(pbg, d, dev),
        args.steps, pbg.num_edge_slots,
        lambda acct: {"comm_bytes_per_step": acct["train_step_bytes_per_chip"],
                      "halo_rows_node": acct["node_halo_rows"],
                      "halo_rows_edge": acct["edge_halo_rows"]})
    results["lggnn"]["halo_giant_graph"] = {
        "nodes": args.nodes, "dir_edges": pbg.num_edge_slots,
        "devices": mode_b}

    log("LGGNN train step, psum-replicated fallback:")
    pbig = graphs.make_packed_batch(
        records, node_capacity=((tot_v + 63) // 64) * 64,
        edge_capacity=((tot_e + 63) // 64) * 64, task=0, device=dev)
    mode_c, t1_ps = _rows(
        "psum_fallback", counts,
        lambda d: (None if pbig.num_edge_slots % d
                   else psum_fallback(pbig, d, dev)),
        args.steps, tot_e,
        lambda acct: {"comm_bytes_per_step": acct["train_step_bytes_per_chip"],
                      "allreduces_fwd": acct["n_allreduce_fwd"]})
    results["lggnn"]["psum_fallback"] = {"devices": mode_c}

    V, F = args.nodes, args.features
    E = V * args.avg_degree
    inputs = bare_spmm_inputs(rng, V, E, F)
    results["bare_spmm"] = {"edges": E, "nodes": V, "features": F,
                            "devices": {}}
    base = None
    for d in counts:
        eps = E / _timed(bare_spmm(inputs, V, d, dev), args.steps)
        base = base or eps
        results["bare_spmm"]["devices"][d] = {
            "edges_per_s": eps, "efficiency_vs_linear": eps / (d * base)}

    if prior is not None:
        def rows_of(mode):
            dev_rows = prior["lggnn"].get(mode, {}).get("devices", {})
            return {int(k): v for k, v in dev_rows.items()}

        mode_a, mode_b, mode_c, mode_h = (
            rows_of("molecule_aligned"), rows_of("halo_giant_graph"),
            rows_of("psum_fallback"), rows_of("hybrid_dp_x_edge"))
        prior["t1_this_backend_s"] = {
            "molecule_aligned": t1_mol, "halo_giant_graph": t1_halo,
            "psum_fallback": t1_ps, "device": card(dev)}
        prior["assumed_link_bytes_per_s"] = link
        results = prior

    results["projection"] = {
        "molecule_aligned": project(t1_mol, mode_a, bw),
        # the hybrid shards the same molecules over as many ranks
        "hybrid_dp_x_edge": project(t1_mol, mode_h, bw),
        "halo_giant_graph": project(t1_halo, mode_b, bw),
        "psum_fallback": project(t1_ps, mode_c, bw),
        "note": "no-overlap bound: eff >= (t1/d)/(t1/d + bytes/BW); t1 = "
                "measured one-rank step time on this device; BW assumed "
                "(assumed_link_bytes_per_s)"}
    for mode, proj in results["projection"].items():
        if isinstance(proj, dict) and proj:
            dmax = max(proj)
            log(f"projection {mode} @{dmax} ranks: eff >= "
                f"{proj[dmax]['projected_efficiency_lower_bound']:.2%}")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "scaling.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
        f.write("\n")
    log(f"wrote {path}")
    return results


if __name__ == "__main__":
    main()
