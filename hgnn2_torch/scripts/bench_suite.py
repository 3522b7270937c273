"""Benchmark suite of the port (counterpart of bench_suite.py at the repo
root): each family's chained training step, the CCN kernels at K = 8, the
high-K CCN-2D paths, the halo table build, the bf16 GNN step and the
SpMM roofline, on one CUDA card.

    python -m hgnn2_torch.scripts.bench_suite [--quick] [--device cuda|cpu]
        [--out DIR]

Sizes are the JAX script's: 4,096 QM9-shaped molecules (synthetic_qm9_like,
seed 0) and 30 timed calls a row, or with --quick 1,024 and 10. The
records, batches and graphs come from the JAX script's generators and
seeds, so every count (K, halo rows, edges, bytes an edge) is the JAX
script's. The sizes are the module's constants; chip_smoke.py calls the
sections at a cut, and the CPU tests patch the constants (the K = 8 and
K = 32 batches must keep their K).

Timing. A training row is training.train.make_multi_train_step (10
optimizer steps in one replayed CUDA graph, Adamax at lr 3e-4 for the
GNNs and 1e-3 for CCN) timed by profiling.time_scan_steps (2 warm-up
calls, then the timed calls; host clock, both ends waiting for the
card). A pure op is time_chained_op: n dependent calls captured as one
CUDA graph, one replay timed between CUDA events, divided by n. On the
CPU both run eagerly.

Each row's peak device memory (torch.cuda.max_memory_allocated over the
row) goes to config["rows"], beside its ms a step and, for the training
rows, its first and last call's loss. The packed SpMM (ops/sparse.spmm)
materialises w * x[dst] as an (E, F) tensor before its index_add_; at
scale (E = 2^24, F = 128) that is 8.6 GB an application, which the
peak shows and neither traffic model counts.

Keys. JAX's key names, with three changes:
  * "xla" becomes "plain" (the PyTorch path without the kernels):
    ccn1d_plain_molecules_per_s, ccn2d_kernel_speedup_vs_plain,
    ccn2d_K8_plain_steps_per_s, ...;
  * no *_vs_reference ratios (bench_torch.py leaves out bench.py's
    baseline ratios as well);
  * no XLA cost-analysis rows (XLA_COST_KEYS): PyTorch has no count of a
    compiled program's logical bytes.
to_jax_key maps a key of this script to JAX's name. "config" holds the
batch, the steps, the card's name and power limit, the torch version,
the TF32 setting and the rows' peaks.

The results go to DIR/details.json (details_quick.json with --quick),
DIR by default runs/bench_suite_torch; DIR must end in "_torch", so that
nothing here writes over or merges into the JAX script's
BENCH_DETAILS.json. Logs go to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

N_INNER = 10  # optimizer steps a replayed graph (JAX's N_INNER)
BATCH, QUICK_BATCH = 4096, 1024  # molecules
STEPS, QUICK_STEPS = 30, 10  # timed calls a row
LARGE_NODES = 1 << 20  # the packed SpMM at scale, 16 x as many edges
HALO_NODES, HALO_SHARDS, HALO_EDGES = 1 << 18, 8, 4_000_000
K8_GRAPHS, DENSE_GRAPHS = 256, 64
GNN_LR, CCN_LR = 3e-4, 1e-3
F = 128  # the SpMM roofline's feature width
K8, HIGH_K = 8, 32  # the K of the K = 8 and high-K batches (JAX's)
XLA_COST_KEYS = ("packed_spmm_bytes_accessed_xla",
                 "packed_spmm_xla_bytes_over_peak_time",
                 "packed_spmm_large_bytes_accessed_xla",
                 "packed_spmm_large_hbm_utilization_xla_bytes")
OUT = os.path.join("runs", "bench_suite_torch")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def to_jax_key(key: str) -> str:
    """The JAX script's name of a key of this one."""
    return key.replace("plain", "xla")


def ported_jax_keys(jax_keys) -> set:
    """The keys of the JAX script's results that this script writes (under
    to_jax_key's names): all but the reference ratios and XLA_COST_KEYS."""
    return {k for k in jax_keys
            if not k.endswith("_vs_reference") and k not in XLA_COST_KEYS}


# ------------------------------------------------------------ the inputs


def qm9_records(n: int) -> list:
    """The JAX script's molecules: synthetic_qm9_like(n, seed=0)."""
    from hgnn2_torch.data import qm9

    return qm9.synthetic_qm9_like(n, seed=0)


def k8_records(n_graphs: int = 256) -> list:
    """The JAX script's graphs at the kernels' K = 8 boundary: 10-16
    nodes, degree capped at 7, default_rng(11); the first n_graphs."""
    from hgnn2_torch import graphs

    rng = np.random.default_rng(11)
    recs = []
    for _ in range(256):
        n = int(rng.integers(10, 17))
        a = np.zeros((n, n), np.float32)
        for u in range(n):
            for v in rng.permutation(n)[:3]:
                if u != v and a[u].sum() < 7 and a[v].sum() < 7:
                    a[u, v] = a[v, u] = 1.0
        recs.append(graphs.GraphRecord(
            x=rng.standard_normal((n, 3)).astype(np.float32), adj=a,
            y=np.float32(0.1)))
    return recs[:n_graphs]


def dense_records(n_graphs: int = 64, n_dense: int = 32) -> list:
    """The JAX script's high-K graphs: n_dense nodes at edge density 0.9,
    default_rng(7) (receptive fields K ~ 32); the first n_graphs."""
    from hgnn2_torch import graphs

    rng = np.random.default_rng(7)
    recs = []
    for _ in range(64):
        a = (rng.random((n_dense, n_dense)) < 0.9).astype(np.float32)
        a = np.triu(a, 1)
        a = a + a.T
        x = rng.standard_normal((n_dense, 3)).astype(np.float32)
        recs.append(graphs.GraphRecord(x=x, adj=a, y=np.float32(0.1)))
    return recs[:n_graphs]


def halo_edges(V: int, E: int):
    """The JAX script's million-edge graph: local edges within +-64 of
    their source, 1 % long-range, default_rng(0). (src, dst, w) numpy."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, V, E)
    dst = (src + rng.integers(-64, 65, E)) % V
    far = rng.random(E) < 0.01
    dst[far] = rng.integers(0, V, int(far.sum()))
    w = rng.random(E).astype(np.float32)
    return src, dst, w


def large_spmm_inputs(V: int, E: int, features: int = F):
    """The JAX script's packed SpMM at scale, default_rng(5): sorted src,
    random dst, weights and an (V, features) x, numpy."""
    rng = np.random.default_rng(5)
    src = np.sort(rng.integers(0, V, E)).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    w = rng.random(E).astype(np.float32)
    x = rng.standard_normal((V, features)).astype(np.float32)
    return src, dst, w, x


# ------------------------------------------------------------- the timers


def _reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev: torch.device) -> int | None:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def time_chained_op(fn, x0: torch.Tensor, n: int = 20):
    """(seconds a call, x_n) of x <- fn(x).to(x0.dtype) chained n times
    (the cast lets a bf16-in, f32-out op chain, as in the JAX script). On
    CUDA the n calls are captured as one CUDA graph (after one eager
    chain on a side stream, which warms the libraries up), the graph is
    replayed once to warm up and once between CUDA events: the n
    dependent executions' device time, divided by n. On the CPU the
    chain runs eagerly, host clock."""

    def chain(x):
        for _ in range(n):
            x = fn(x).to(x0.dtype)
        return x

    if x0.device.type != "cuda":
        t0 = time.perf_counter()
        out = chain(x0)
        return (time.perf_counter() - t0) / n, out
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        chain(x0)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chain(x0)
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n, out


def train_family(name: str, model, batch, n_mol: int, steps: int,
                 lr: float) -> dict:
    """One training row: make_multi_train_step(N_INNER) with Adamax at lr
    (the JAX script's _train_state: 1,000 steps an epoch) on one resident
    batch, timed by time_scan_steps (2 warm-up calls, ``steps`` timed).
    Returns ms_per_step (a call over N_INNER), the rate, each call's
    last inner step's loss (losses[0]: the first warm-up call's) and the
    peak device memory."""
    from hgnn2_torch import profiling
    from hgnn2_torch.training import train
    from hgnn2_torch.training.config import OptimConfig
    from hgnn2_torch.training.optim import build_optimizer

    dev = next(model.parameters()).device
    _reset_peak(dev)
    opt, sched = build_optimizer(OptimConfig(optim="adamax", lr=lr), 1000,
                                 model.parameters())
    step = train.make_multi_train_step(model, opt, sched, "regression", 0.0,
                                       1.0, n_inner=N_INNER)
    losses = []

    def recorded(b):
        mets = step(b)
        losses.append(mets["loss"])
        return mets

    t0 = time.perf_counter()
    timing = profiling.time_scan_steps(recorded, batch, steps=steps)
    per_step = timing.per_step_s / N_INNER
    setup_s = time.perf_counter() - t0 - timing.total_s
    row = {"ms_per_step": per_step * 1e3, "rate": n_mol / per_step,
           "losses": [float(v) for v in losses], "peak_bytes": _peak(dev),
           "capture_and_warmup_s": setup_s}
    log(f"{name}: {per_step * 1e3:.3f} ms/step ({n_mol} molecules/step; "
        f"capture+warm-up {setup_s:.1f}s; peak {row['peak_bytes']})")
    return row


# ----------------------------------------------------------- the sections


def _gen():
    return torch.Generator().manual_seed(0)


def gnn_model(in_features: int, dtype=None):
    from hgnn2_torch.nn import models

    return models.GNNSimple(in_features=in_features, n_features=1,
                            n_layers=15, J=1, dtype=dtype, generator=_gen())


def lggnn_model(in_features: int):
    from hgnn2_torch.nn import models

    return models.GNNLineGraph(in_features=in_features, n_features=1,
                               n_layers=5, J=1, order=2, generator=_gen())


def ccn_model(arch: str, in_features: int, n_layers: int, kernel: bool,
              scan: bool = False):
    from hgnn2_torch.nn import ccn

    if arch == "ccn1d":
        return ccn.CCN1D(n_features=in_features, hidden=2, n_layers=n_layers,
                         kernel=kernel, generator=_gen())
    return ccn.CCN2D(n_features=in_features, hidden=2, n_layers=n_layers,
                     kernel=kernel, scan_promotion=scan, generator=_gen())


def gnn_section(records, bs: int, steps: int, dev, results: dict,
                rows: dict):
    """GNNSimple L=15 h=1 J=1 and GNNLineGraph L=5 h=1 order 2 on dense
    batches (n_max 32, m_max 64). Returns the GNN's dense batch."""
    from hgnn2_torch import graphs

    f_in = records[0].x.shape[1]
    batch = graphs.make_dense_batch(records, n_max=32, batch_size=bs, task=0,
                                    device=dev)
    rows["gnn"] = train_family("gnn L15", gnn_model(f_in).to(dev), batch, bs,
                               steps, GNN_LR)
    results["gnn_molecules_per_s"] = rows["gnn"]["rate"]
    lg_batch = graphs.make_dense_batch(records, n_max=32, m_max=64,
                                       with_line_graph=True, batch_size=bs,
                                       task=0, device=dev)
    rows["lggnn"] = train_family("lggnn L5", lggnn_model(f_in).to(dev),
                                 lg_batch, bs, steps, GNN_LR)
    results["lggnn_molecules_per_s"] = rows["lggnn"]["rate"]
    del lg_batch
    return batch


def ccn_section(records, bs: int, steps: int, dev, results: dict,
                rows: dict) -> None:
    """CCN-1D L=20 h=2 and CCN-2D L=2 h=2 on a quarter of the molecules
    (k_max 5), each with its kernels (K1/K2, K3/K4) and on the plain
    path."""
    from hgnn2_torch.nn import ccn

    n = bs // 4
    cb = ccn.make_ccn_batch(records[:n], k_max=5, task=0,
                            vertex_capacity=1 + 12 * n, device=dev)
    f_in = records[0].x.shape[1]
    for arch, L in (("ccn1d", 20), ("ccn2d", 2)):
        for kernel in (True, False):
            key = f"{arch}_molecules_per_s" if kernel else \
                f"{arch}_plain_molecules_per_s"
            name = f"{arch} L{L} {'kernel' if kernel else 'plain'}"
            row = train_family(name, ccn_model(arch, f_in, L, kernel).to(dev),
                               cb, n, steps, CCN_LR)
            rows[name.replace(" ", "_")] = row
            results[key] = row["rate"]
            results[key.replace("molecules_per_s", "steps_per_s")] = (
                row["rate"] / n)
        results[f"{arch}_kernel_speedup_vs_plain"] = (
            results[f"{arch}_molecules_per_s"]
            / results[f"{arch}_plain_molecules_per_s"])


def k8_section(recs8, steps: int, dev, results: dict, rows: dict) -> None:
    """CCN-2D L=2 h=2 at the kernels' K = 8 boundary, kernel and plain;
    raises unless the batch's K is 8."""
    from hgnn2_torch.nn import ccn

    cb8 = ccn.make_ccn_batch(recs8, task=None, vertex_capacity=4096,
                             device=dev)
    K = int(cb8.nbr.shape[1])
    if K != K8:
        raise AssertionError(f"the K = 8 batch has K = {K}")
    results["ccn2d_K8_K"] = K
    for label, kernel in (("kernel_", True), ("plain_", False)):
        row = train_family(f"ccn2d K=8 {label}step",
                           ccn_model("ccn2d", 3, 2, kernel).to(dev), cb8,
                           len(recs8), max(3, steps // 3), CCN_LR)
        rows[f"ccn2d_K8_{label}"] = row
        results[f"ccn2d_K8_{label}steps_per_s"] = 1e3 / row["ms_per_step"]


def high_k_section(dense_recs, steps: int, dev, results: dict,
                   rows: dict) -> None:
    """CCN-2D L=2 h=2 at K = 32: K3's refusal recorded, then the
    materialized and the scan (scan_promotion) paths; raises unless the
    batch's K is 32."""
    from hgnn2_torch.nn import ccn
    from hgnn2_torch.ops import ccn_fused

    n_dense = dense_recs[0].n_nodes
    n_graphs = len(dense_recs)
    cbk = ccn.make_ccn_batch(dense_recs, vertex_capacity=n_dense * n_graphs,
                             device=dev)
    K = int(cbk.nbr.shape[1])
    if K != HIGH_K:
        raise AssertionError(f"the high-K batch has K = {K}")
    results["ccn2d_highK_K"] = K
    try:
        ccn_fused.fused_contract_forward(
            cbk.chi_idx, cbk.nbr, torch.zeros(tuple(cbk.chi_idx.shape) + (2,),
                                              device=dev),
            cbk.deg, cbk.row_mask)
        results["ccn2d_highK_kernel"] = "unexpectedly ran"
    except ValueError as e:
        results["ccn2d_highK_kernel"] = f"refused: {e}"
    for label, scan in (("", False), ("scan_", True)):
        row = train_family(
            f"ccn2d highK {label or 'materialized_'}(K={K}, "
            f"V={n_dense * n_graphs})", ccn_model("ccn2d", 3, 2, False,
                                                  scan).to(dev),
            cbk, n_graphs, max(3, steps // 3), CCN_LR)
        rows[f"ccn2d_highK_{label or 'materialized_'}"] = row
        results[f"ccn2d_highK_{label}molecules_per_s"] = row["rate"]
        results[f"ccn2d_highK_{label}steps_per_s"] = 1e3 / row["ms_per_step"]


def halo_section(V: int, S: int, E: int, results: dict):
    """The halo partition's host build at E edges over S shards. Returns
    the partition (numpy tables)."""
    from hgnn2_torch.parallel import halo

    src, dst, w = halo_edges(V, E)
    t0 = time.perf_counter()
    part = halo.build_halo_partition(src, dst, w, V, S, to_device=False)
    build_s = time.perf_counter() - t0
    results["halo_partition_build_edges"] = E
    results["halo_partition_build_s"] = build_s
    results["halo_partition_build_edges_per_s"] = E / build_s
    results["halo_partition_halo_rows_per_shard"] = int(part.n_imports)
    log(f"halo partition build: {E:,} edges, {V:,} nodes, {S} shards -> "
        f"{build_s:.2f}s host-side, {part.n_imports} halo rows a shard")
    return part


def bf16_section(batch, bs: int, steps: int, dev, results: dict,
                 rows: dict) -> None:
    """GNNSimple L=15 in bf16 (f32 parameters and statistics) on the GNN
    row's batch, and its rate over the f32 row's."""
    rows["gnn_bf16"] = train_family(
        "gnn L15 bf16", gnn_model(batch.x.shape[-1], torch.bfloat16).to(dev),
        batch, bs, steps, GNN_LR)
    results["gnn_bf16_molecules_per_s"] = rows["gnn_bf16"]["rate"]
    results["gnn_bf16_speedup_vs_fp32"] = (rows["gnn_bf16"]["rate"]
                                           / results["gnn_molecules_per_s"])


def traffic_bytes(n_edges: int, n_nodes: int, features: int = F):
    """(compulsory, no-reuse) bytes of one packed SpMM, the JAX script's
    two models that bracket it: compulsory, every array once (3E index
    and weight words, x read, out written); no-reuse, a whole x row read
    an edge. Neither counts the port's (E, F) temporary."""
    return (4 * (3 * n_edges + 2 * n_nodes * features),
            4 * (3 * n_edges + (n_edges + n_nodes) * features))


def _chained(name, fn, x0, n, rows, keep, dev):
    _reset_peak(dev)
    t, out = time_chained_op(fn, x0, n)
    rows[name] = {"ms_per_step": t * 1e3, "peak_bytes": _peak(dev), "n": n}
    if keep is not None:
        keep[name] = (fn, x0, n, out)
    return t


def spmm_section(records, batch, bs: int, steps: int, dev, large_nodes: int,
                 results: dict, rows: dict, keep: dict | None = None) -> None:
    """The SpMM roofline: dense blocks (torch.bmm; JAX's einsum is outside
    any Pallas kernel) in f32 and bf16 with MFU; the packed segment-sum
    (ops/sparse.spmm) with the compulsory and no-reuse traffic models and
    HBM utilization; packed at scale (large_nodes nodes, 16 x as many
    edges); bf16 packed; 4 molecules a 128-row block in f32 and bf16.
    keep, when a dict, receives each chained op's (fn, x0, n, x_n)."""
    from hgnn2_torch import graphs, profiling
    from hgnn2_torch.ops import sparse

    dev = torch.device(dev)
    n_edges = sum(r.n_dir_edges for r in records)
    n_atoms = sum(r.n_nodes for r in records)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (bs, 32, F)).astype(np.float32)).to(dev)
    flops = 2 * bs * 32 * 32 * F
    for dt, label in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        adj_t = batch.adj.to(dt)
        t = _chained(f"dense_block_{label}",
                     lambda xc, a=adj_t: torch.bmm(a, xc), x.to(dt), steps,
                     rows, keep, dev)
        key = "dense_block_spmm" + ("" if dt == torch.float32 else "_bf16")
        results[f"{key}_edges_per_s"] = n_edges / t
        results[f"{key}_flops_per_s"] = flops / t
        u = profiling.mfu(flops / t, "float32" if dt == torch.float32
                          else "bfloat16")
        if u is not None:
            results[f"{key}_mfu"] = u
        log(f"dense-block SpMM {label} (F={F}): {t * 1e3:.4f} ms -> "
            f"{n_edges / t:,.0f} real edges/s, {flops / t / 1e12:.3f} padded "
            f"TFLOP/s" + (f", MFU {u:.2%}" if u is not None else ""))

    pb = graphs.make_packed_batch(records, node_capacity=n_atoms + 1,
                                  edge_capacity=n_edges, task=0, device=dev)
    V = pb.num_node_slots
    xp = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (V, F)).astype(np.float32)).to(dev)
    t = _chained("packed", lambda xc: sparse.spmm(pb.src, pb.dst, pb.w, xc, V),
                 xp, steps, rows, keep, dev)
    results["packed_spmm_edges_per_s"] = n_edges / t
    b_compulsory, b_noreuse = traffic_bytes(n_edges, V)
    results["packed_spmm_hbm_utilization"] = profiling.hbm_utilization(
        b_compulsory / t)
    results["packed_spmm_hbm_utilization_noreuse_model"] = (
        profiling.hbm_utilization(b_noreuse / t))
    results["packed_spmm_bytes_per_edge_compulsory"] = b_compulsory / n_edges
    log(f"packed segment-sum SpMM (F={F}): {t * 1e3:.4f} ms -> "
        f"{n_edges / t:,.0f} edges/s; {b_compulsory / n_edges:.4f} compulsory "
        f"bytes an edge")

    Vb, Eb = large_nodes, 16 * large_nodes
    src_b, dst_b, w_b, x_b = (torch.from_numpy(a).to(dev)
                              for a in large_spmm_inputs(Vb, Eb))
    tb = _chained("packed_large",
                  lambda xc, s=src_b, d=dst_b, w=w_b: sparse.spmm(
                      s, d, w, xc, Vb), x_b, max(5, steps // 3), rows, keep,
                  dev)
    results["packed_spmm_large_edges"] = Eb
    results["packed_spmm_large_nodes"] = Vb
    results["packed_spmm_large_edges_per_s"] = Eb / tb
    u_big = profiling.hbm_utilization(traffic_bytes(Eb, Vb)[0] / tb)
    results["packed_spmm_large_hbm_utilization"] = u_big
    log(f"packed SpMM at scale (V={Vb:,}, E={Eb:,}, F={F}): {tb * 1e3:.3f} ms "
        f"-> {Eb / tb / 1e9:.3f}G edges/s, peak "
        f"{rows['packed_large']['peak_bytes']}"
        + (f", compulsory-model HBM utilization {u_big:.2%}" if u_big else ""))
    del src_b, dst_b, w_b, x_b

    w16 = pb.w.to(torch.bfloat16)
    t16 = _chained("packed_bf16",
                   lambda xc: sparse.spmm(pb.src, pb.dst, w16, xc, V),
                   xp.to(torch.bfloat16), steps, rows, keep, dev)
    results["packed_spmm_bf16_edges_per_s"] = n_edges / t16
    results["packed_spmm_bf16_speedup"] = t / t16
    log(f"packed SpMM bf16: {t16 * 1e3:.4f} ms ({t / t16:.2f}x fp32)")

    # 4 molecules block-diagonally in one 128-row block
    adj128 = np.zeros((bs // 4, 128, 128), np.float32)
    a_np = batch.adj.cpu().numpy()
    for g in range(bs):
        blk, off = divmod(g, 4)
        adj128[blk, off * 32:(off + 1) * 32, off * 32:(off + 1) * 32] = a_np[g]
    x128 = x.reshape(bs // 4, 128, F)
    flops128 = 2 * (bs // 4) * 128 * 128 * F
    for dt, label in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        a128 = torch.from_numpy(adj128).to(dev, dt)
        t1 = _chained(f"dense_block128_{label}",
                      lambda xc, a=a128: torch.bmm(a, xc), x128.to(dt), steps,
                      rows, keep, dev)
        key = "dense_block128_spmm" + ("" if dt == torch.float32 else "_bf16")
        results[f"{key}_edges_per_s"] = n_edges / t1
        u = profiling.mfu(flops128 / t1, "float32" if dt == torch.float32
                          else "bfloat16")
        if u is not None:
            results[f"{key}_mfu"] = u
        log(f"dense-block-128 SpMM {label}: {t1 * 1e3:.4f} ms -> "
            f"{n_edges / t1:,.0f} real edges/s"
            + (f", MFU {u:.2%}" if u is not None else ""))
    results["dense_block128_bf16_speedup"] = (
        results["dense_block128_spmm_bf16_edges_per_s"]
        / results["dense_block128_spmm_edges_per_s"])


def _card(dev: torch.device) -> dict:
    from hgnn2_torch.scripts.profile_ccn1d_util import card

    line = card(dev)
    name, _, power = line.partition(", ")
    return {"device": line, "name": name, "power_limit": power or None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if not os.path.basename(os.path.normpath(args.out)).endswith("_torch"):
        ap.error("--out must end in _torch (JAX's results are not the "
                 "port's to write)")
    from hgnn2_torch.scripts.profile_ccn1d_util import harness_device

    dev = harness_device(args.device)
    steps = QUICK_STEPS if args.quick else STEPS
    bs = QUICK_BATCH if args.quick else BATCH
    results, rows = {}, {}

    records = qm9_records(bs)
    log(f"dataset: {bs} molecules, {sum(r.n_nodes for r in records)} atoms, "
        f"{sum(r.n_dir_edges for r in records)} directed edges")
    batch = gnn_section(records, bs, steps, dev, results, rows)
    ccn_section(records, bs, steps, dev, results, rows)
    k8_section(k8_records(K8_GRAPHS), steps, dev, results, rows)
    high_k_section(dense_records(DENSE_GRAPHS), steps, dev, results, rows)
    halo_section(HALO_NODES, HALO_SHARDS, HALO_EDGES, results)
    bf16_section(batch, bs, steps, dev, results, rows)
    spmm_section(records, batch, bs, steps, dev, LARGE_NODES, results, rows)
    results["config"] = {
        "batch": bs, "steps": steps, "n_inner": N_INNER, **_card(dev),
        "torch": torch.__version__,
        "tf32": torch.backends.cuda.matmul.allow_tf32,
        "large_nodes": LARGE_NODES, "halo_edges": HALO_EDGES,
        "k8_graphs": K8_GRAPHS, "dense_graphs": DENSE_GRAPHS, "rows": rows}
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out,
                        "details_quick.json" if args.quick else "details.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
        f.write("\n")
    log(f"wrote {path}")
    for k, v in results.items():
        if isinstance(v, float):
            log(f"  {k}: {v:,.4f}")
    return results


if __name__ == "__main__":
    main()
