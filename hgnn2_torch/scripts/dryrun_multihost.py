"""Multi-process dry run of the port (counterpart of
scripts/dryrun_multihost.py): N real processes, one grid of ranks, the
training modes of the parallel slice, and the edge-partitioned and halo
paths with one rank a process (F4; bench_scaling.py's modes).

    python -m hgnn2_torch.scripts.dryrun_multihost [--processes 2]
        [--local_ranks 2] [--steps 2] [--device cuda|cpu] [--backend gloo]
        [--phases dp edge hybrid ring psum_fallback halo_giant_graph]

The parent binds port 0 for a free port and starts N child processes,
each with its own timeout; each joins the process group
(parallel.multihost.setup_distributed) and runs the chosen phases
(default: dp, edge, hybrid):

  1. dp: data parallelism over the global "data" axis, one rank a
     process: per-process record shards (shard_records) into dense batches
     of pinned buckets (n_max 32, the edge bucket of the whole set), and
     GNNLineGraph (order 2) train steps whose BN statistics and loss sums
     all-reduce across the processes (spmd.make_dp_train_step);
  2. edge: molecule-aligned edge sharding over the global "edge" axis:
     every process builds the same global partition
     (spmd.partition_records, make_packed_shards), keeps its local rows
     lo:hi of the stacked shards and trains PackedLGGNN
     (training.sharded.make_sharded_step_fns), BN's and the loss's sums
     crossing the process boundary;
  3. hybrid: a (data = processes, edge = local ranks) grid, the composed
     --dp M --edge_shards N program across processes; each child also runs
     the same step function over the whole batch as one shard in its own
     process and holds the hybrid loss to that control (1e-4 relative,
     as the JAX dry run asserts);
  4. ring: K5 across processes (ring.ProcessRing over an EdgeMesh of one
     rank a process, multihost.edge_mesh): each process's sum equal bit
     for bit to ring_psum_reference(all parts)[r] and to the plain
     version (process_ring_reference) at the packed path's node blocks
     (V x 1, 5, 16), a --ring_big x 16 block, an odd unaligned view and
     RING_CALLS calls in a row with fresh inputs (the slots reused); on
     a card the kernel's device ms alone, each process in turn, and the
     host ms of a whole call, of the plain version and of gloo's
     all_reduce of the same tensor; then the --ring_models (default PackedLGGNN h=8 L=3 order 2 and
     PackedGNN h=1 L=15, bench_scaling.py's and chip_smoke.py phase 5's)
     over --packed_molecules molecules, use_ring=True: a train-mode and
     an eval forward under no_grad, ProcessRing's launches counted;
  5. psum_fallback: --steps SGD steps (lr FALLBACK_LR) of the
     --fallback_models (default PackedLGGNN h=8 L=3 J=1 order 2,
     bench_scaling.py:291-330) over the same molecules, every all-reduce
     the differentiable plain one (spmd._AllReduce), the gradient by
     spmd.backward, each step under runtime.deterministic (the
     replicated node-level work's segment sums in a fixed order);
  6. halo_giant_graph: one giant graph of --halo_nodes nodes
     (bench_scaling.py's) over the processes as halo ranks
     (global_mesh(("edge",))), the --halo_models (default PackedLGGNN
     L=5 h=1 order 2 and PackedGNN L=15 h=1) through halo_packed_loss and
     spmd.backward, --steps evaluations of loss and gradients.

Every step is SGD (no momentum; Adamax's sign-like update would amplify
reduction-order noise), at DP_LR in phase dp and PACKED_LR in the
others. The parent asserts that every process reports the same finite
loss in each phase, to 1e-6 (phase ring: the eval forward's mean
prediction, to REPLICA_RTOL relative, since each process keeps its own
replica of every sum, which rounds differently). Each child prints its
losses and, a phase, its host ms a step (a ring call in phase ring) and
the cross-process traffic a step (calls and bytes: psum's forward and
backward, the gradient sum, the halo's gathers; phase ring: the ring's
calls and the bytes read from peers, in all). --out DIR saves each
phase's record (losses or outputs, step-0 gradients, the state after
the steps) as DIR/{phase}_{process}.pt; --weights DIR starts each
phase's model from DIR/{phase}.pt (a state_dict; the new phases:
DIR/{phase}_{arch}.pt) in place of its seeded init. control() runs a
phase on the global data in one process, for comparisons. On a card the
parent builds the ring kernel and the line-graph exchange's before it
starts the children, which load them and never run nvcc
(HGNN2_PREBUILT).

--device cuda (the default) --backend gloo puts every process on the
one card (NCCL refuses two ranks on one device); --backend nccl gives
process p card p; --device cpu --backend gloo runs on the CPU. No
multi-process CLI exists: the JAX CLI has none.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PHASES = {"dp": "MHLOSS", "edge": "MHESLOSS", "hybrid": "MHHYLOSS"}  # default
PROCESS_PHASES = {"ring": "MHRING", "psum_fallback": "MHFBLOSS",  # F4's
                  "halo_giant_graph": "MHHALOLOSS"}
TAGS = {**PHASES, **PROCESS_PHASES}  # every phase's line tag
MODEL_ARGS = {"ring": "ring_models", "psum_fallback": "fallback_models",
              "halo_giant_graph": "halo_models"}  # each F4 phase's models
AGREE = 1e-6  # processes' losses, absolute (the JAX dry run's bar)
REPLICA_RTOL = 1e-5  # phase ring: processes' mean predictions, relative
CONTROL_RTOL = 1e-4  # hybrid vs its in-child control, x max(1, |loss|)
N_MAX = 32  # node bucket of every dense batch
DP_LR = 1e-3  # SGD lr of phase dp
PACKED_LR = 1e-5  # SGD lr of the packed phases
FALLBACK_LR = 1e-3  # SGD lr of phase psum_fallback (bench_scaling.py's)
PACKED_SEED = 1  # the molecules of phases ring and psum_fallback
RING_CALLS = 8  # phase ring: calls in a row, each slot written 4 times
SPIN_CYCLES = 20_000_000  # device spin before a timed launch (about 10 ms)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--local_ranks", type=int, default=2,
                    help="ranks a process in the edge and hybrid phases")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--backend", default="gloo", help="gloo or nccl")
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--features", type=int, default=2)
    ap.add_argument("--dp_molecules", type=int, default=16,
                    help="molecules a process, phase dp")
    ap.add_argument("--edge_molecules", type=int, default=8,
                    help="molecules a global rank, phase edge")
    ap.add_argument("--hybrid_molecules", type=int, default=6,
                    help="molecules a global rank, phase hybrid")
    ap.add_argument("--phases", nargs="+", default=list(PHASES),
                    choices=list(TAGS))
    ap.add_argument("--packed_molecules", type=int, default=1024,
                    help="molecules of phases ring and psum_fallback")
    ap.add_argument("--ring_models", nargs="+", default=["lggnn:8:3",
                                                         "gnn:1:15"],
                    help="arch:h:L of phase ring's models")
    ap.add_argument("--fallback_models", nargs="+", default=["lggnn:8:3"],
                    help="arch:h:L of phase psum_fallback's models")
    ap.add_argument("--halo_models", nargs="+", default=["lggnn:1:5",
                                                         "gnn:1:15"],
                    help="arch:h:L of phase halo_giant_graph's models")
    ap.add_argument("--ring_big", type=int, default=2 ** 20,
                    help="rows (16 wide) of phase ring's large block")
    ap.add_argument("--halo_nodes", type=int, default=8192)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a child may take")
    ap.add_argument("--out", default=None)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--child", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    return ap.parse_args(argv)


# ------------------------------------------------------------- the data


def _m_max(records) -> int:
    from hgnn2_torch import graphs
    from hgnn2_torch.data import batching

    return graphs.pad_to_bucket(max(r.n_dir_edges for r in records),
                                batching.DEFAULT_EDGE_BUCKETS)


def dp_batches(args) -> list:
    """Each process's dense batch of phase dp, on the host: its strided
    shard of args.dp_molecules x processes molecules, padded to N_MAX
    nodes, the edge bucket of the whole set and args.dp_molecules graphs,
    so every process's shapes are equal."""
    from hgnn2_torch import graphs
    from hgnn2_torch.data import qm9
    from hgnn2_torch.parallel import multihost

    P = args.processes
    records = qm9.synthetic_qm9_like(args.dp_molecules * P, seed=0)
    m_max = _m_max(records)
    return [graphs.make_dense_batch(
        multihost.shard_records(records, P, p), n_max=N_MAX, m_max=m_max,
        with_line_graph=True, batch_size=args.dp_molecules, task=0,
        device="cpu") for p in range(P)]


def _caps(parts) -> dict:
    return dict(node_capacity=max(sum(r.n_nodes for r in s) for s in parts),
                edge_capacity=max(sum(r.n_dir_edges for r in s) for s in parts),
                graphs_per_shard=max(len(s) for s in parts))


def edge_stacked(args):
    """Phase edge's global stack of processes x local_ranks
    molecule-aligned shards (S, ...), on the host."""
    from hgnn2_torch.data import qm9
    from hgnn2_torch.parallel import spmd

    n = args.processes * args.local_ranks
    records = qm9.synthetic_qm9_like(args.edge_molecules * n, seed=1)
    parts = spmd.partition_records(records, n)
    return spmd.make_packed_shards(records, n, task=0, parts=parts,
                                   device="cpu", **_caps(parts))


def hybrid_data(args):
    """Phase hybrid's records and global stack (processes, local_ranks,
    ...), on the host: the molecules dealt into data groups, each into
    edge shards, at the worst shard's capacities."""
    from hgnn2_torch.data import qm9
    from hgnn2_torch.parallel import spmd

    M, N = args.processes, args.local_ranks
    records = qm9.synthetic_qm9_like(args.hybrid_molecules * M * N, seed=2)
    groups = spmd.partition_records(records, M)
    parts = [spmd.partition_records(g, N) for g in groups]
    caps = _caps([s for p in parts for s in p])
    rows = [spmd.make_packed_shards(g, N, task=0, parts=p, device="cpu",
                                    **caps) for g, p in zip(groups, parts)]
    return records, spmd.stack_shards(rows)


def rows(stacked, lo: int, hi: int):
    """Rows lo:hi of a stacked batch's leading axis."""
    from hgnn2_torch.parallel import spmd

    return dataclasses.replace(stacked, **{
        n: getattr(stacked, n)[lo:hi] for n in spmd._tensor_fields(stacked)})


def _caps64(records) -> dict:
    """Node and edge capacities rounded up to multiples of 64, as
    bench_scaling.py packs its molecules (so 2, 4 or 8 ranks divide the
    edge slots)."""
    tot_v = sum(r.n_nodes for r in records)
    tot_e = sum(r.n_dir_edges for r in records)
    return dict(node_capacity=-(-tot_v // 64) * 64,
                edge_capacity=-(-tot_e // 64) * 64)


def packed_batch(args):
    """Phases ring's and psum_fallback's one packed batch of
    args.packed_molecules QM9-shaped molecules, on the host (every
    process builds the same)."""
    from hgnn2_torch import graphs
    from hgnn2_torch.data import qm9

    records = qm9.synthetic_qm9_like(args.packed_molecules, seed=PACKED_SEED)
    return graphs.make_packed_batch(records, task=0, device="cpu",
                                    **_caps64(records))


def giant_record(n_nodes: int):
    """bench_scaling.py's giant graph: a ring where each node links to
    the next 3, plus n/64 random long-range edges, symmetric; 5 random
    features a node."""
    import numpy as np

    from hgnn2_torch import graphs

    rng = np.random.default_rng(0)
    a = np.zeros((n_nodes, n_nodes), np.float32)
    for v in range(n_nodes):
        for dd in range(1, 4):
            a[v, (v + dd) % n_nodes] = 1.0
    for _ in range(n_nodes // 64):  # sparse long-range edges
        i, j = rng.integers(0, n_nodes, 2)
        if i != j:
            a[i, j] = 1.0
    a = np.maximum(np.triu(a, 1), np.triu(a.T, 1))
    a = a + a.T
    return graphs.GraphRecord(
        x=rng.standard_normal((n_nodes, 5)).astype(np.float32), adj=a,
        y=np.array([1.0] * 13, np.float32))


def halo_batch(args):
    """Phase halo_giant_graph's giant graph as one packed batch, on the
    host."""
    from hgnn2_torch import graphs

    rec = giant_record(args.halo_nodes)
    return graphs.make_packed_batch([rec], task=0, device="cpu",
                                    **_caps64([rec]))


def ring_inputs(S: int, shape: tuple, seed: int, device):
    """S ranks' parts of ``shape``, drawn on ``device`` from ``seed`` (every
    process draws all S, so each knows the sum it must get)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device)
            for _ in range(S)]


def ring_cases(args, V: int) -> list:
    """Phase ring's checks, in order: (label, shape, view, seed). The
    slots grow at the first and at the large block; view=True passes
    rank r's part as an odd-sized view one float into its buffer."""
    cases = [(f"V={V} F={F}", (V, F), False, F) for F in (1, 5, 16)]
    cases += [(f"n={args.ring_big} x 16", (args.ring_big, 16), False, 17),
              ("odd unaligned view (3003,)", (3004,), True, 18),
              ("(1001, 3)", (1001, 3), False, 19)]
    cases += [(f"call {k} V={V} F=16", (V, 16), False, 100 + k)
              for k in range(RING_CALLS)]
    return cases


# ------------------------------------------------------------ the runs


def build_model(phase: str, args, in_features: int, bn_axis):
    """Phase dp's GNNLineGraph or the packed phases' PackedLGGNN (J 1,
    order 2, args.layers x args.features), seeded, with BN over bn_axis;
    its weights from args.weights/{phase}.pt when given."""
    import torch

    from hgnn2_torch.nn import models, packed

    gen = torch.Generator().manual_seed(list(TAGS).index(phase))
    kw = dict(in_features=in_features, n_features=args.features,
              n_layers=args.layers, J=1, order=2, bn_axis=bn_axis,
              generator=gen)
    model = (models.GNNLineGraph(**kw) if phase == "dp"
             else packed.PackedLGGNN(**kw))
    if args.weights:
        model.load_state_dict(torch.load(
            os.path.join(args.weights, f"{phase}.pt"), weights_only=True))
    return model


def build_packed(phase: str, spec: str, args, in_features: int,
                 bn_axis=None):
    """A new phase's model from its spec "arch:h:L": PackedLGGNN (J 1,
    order 2) for lggnn, PackedGNN (J 1) for gnn, seeded by phase and
    arch; its weights from args.weights/{phase}_{arch}.pt when given."""
    import torch

    from hgnn2_torch.nn import packed

    arch, h, L = spec.split(":")
    if arch not in ("lggnn", "gnn"):
        raise ValueError(f"model spec {spec!r}: arch lggnn or gnn")
    gen = torch.Generator().manual_seed(
        10 * list(TAGS).index(phase) + ("lggnn", "gnn").index(arch))
    kw = dict(in_features=in_features, n_features=int(h), n_layers=int(L),
              J=1, bn_axis=bn_axis, generator=gen)
    model = (packed.PackedLGGNN(order=2, **kw) if arch == "lggnn"
             else packed.PackedGNN(**kw))
    if args.weights:
        model.load_state_dict(torch.load(
            os.path.join(args.weights, f"{phase}_{arch}.pt"),
            weights_only=True))
    return model


def _optimizer(phase: str, args, model):
    from hgnn2_torch.training import optim
    from hgnn2_torch.training.config import OptimConfig

    lr = {"dp": DP_LR, "psum_fallback": FALLBACK_LR}.get(phase, PACKED_LR)
    cfg = OptimConfig(optim="sgd", momentum=0.0, lr=lr)
    # one epoch of all the steps: the schedule keeps the lr constant
    return optim.build_optimizer(cfg, max(args.steps, 1), model.parameters())


def _run(step, model, batch, steps: int, grid) -> dict:
    """``steps`` calls of step(batch): each step's loss, the gradients
    after the first, the state after the last, host ms a step (the steps
    after the first) and the grid's cross-process traffic a step."""
    import torch

    losses, grads, times = [], None, []
    for i in range(steps):
        t0 = time.perf_counter()
        mets = step(batch)
        losses.append(float(mets["loss"]))
        times.append(time.perf_counter() - t0)
        if i == 0:
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in model.named_parameters()}
    timed = times[1:] or times
    return {"losses": losses, "grads": grads,
            "state": {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()},
            "host_ms": 1e3 * sum(timed) / len(timed),
            "comm": {k: v / max(steps, 1) for k, v in grid.comm.items()}}


def _packed_steps(phase, args, model, grid, stacked, axes) -> dict:
    from hgnn2_torch.training import sharded

    opt, sched = _optimizer(phase, args, model)
    step, _ = sharded.make_sharded_step_fns(model, grid, opt, sched,
                                            "regression", 0.0, 1.0, axes)
    return _run(step, model, stacked, args.steps, grid)


def run_phase(phase: str, args, grid, data, bn_axis) -> dict:
    """One phase's steps on ``grid`` over ``data`` (this process's dense
    batch or stacked rows, on the grid's device)."""
    from hgnn2_torch.parallel import multihost, spmd
    from hgnn2_torch.training import train

    model = build_model(phase, args, data.x.shape[-1], bn_axis)
    multihost.replicate_to_mesh(grid, model)
    if phase == "dp":
        opt, sched = _optimizer(phase, args, model)
        step = spmd.make_dp_train_step(train.make_train_step(
            model, opt, sched, "regression", 0.0, 1.0, grid=grid), grid)
        return _run(step, model, data, args.steps, grid)
    axes = ("edge",) if phase == "edge" else spmd.AXES
    return _packed_steps(phase, args, model, grid, data, axes)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host_ms(fn, dev, reps: int = 5) -> float:
    """Host ms a call of fn after one warm-up, the device synchronized."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return 1e3 * (time.perf_counter() - t0) / reps


def _device_ms(fn, n: int = 1, reps: int = 20) -> float:
    """Median device ms of one of n back-to-back calls of fn between CUDA
    events, the device spinning while the host enqueues them (so the
    interval holds the launches, not the host's Python)."""
    import numpy as np
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        if start.query():
            raise AssertionError("the device spin ended before the calls "
                                 "were enqueued")
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def _ring_checks(args, mesh, V: int, dev) -> dict:
    """Phase ring's K5-across-processes checks (ring_cases): this
    process's sum against ring_psum_reference(all parts)[r] and (but in
    the run of calls) against the plain version, each bit for bit; a
    disagreement raises. Returns {label: max_abs_err} and the outputs of
    up to 2^18 floats."""
    import torch

    from hgnn2_torch.ops import ring as ring_ops

    ring, S, r = mesh.ring, mesh.size, mesh.rank
    errs, outs = {}, {}
    for label, shape, view, seed in ring_cases(args, V):
        parts = ring_inputs(S, shape, seed, dev)
        if view:
            parts = [q[1:] for q in parts]
        want = ring_ops.ring_psum_reference(parts)[r]
        got = ring(parts[r])
        _sync(dev)
        ok = torch.equal(got, want)
        if not label.startswith("call"):
            plain = ring_ops.process_ring_reference(parts[r], ring.group)
            ok = ok and torch.equal(plain, want)
        errs[label] = float((got - want).abs().max())
        if not ok:
            raise AssertionError(f"K5 across processes, {label}, process "
                                 f"{r}: not bit-equal to its plain version "
                                 f"(max abs err {errs[label]:.3e})")
        if got.numel() <= 2 ** 18:
            outs[label] = got.cpu()
    return {"errs": errs, "outputs": outs}


def _ring_timing(mesh, V: int, dev) -> dict:
    """On a card, at (V, 16): K5 across processes' device ms of the
    kernel alone (one launch, and one of 100 back-to-back), each process
    in turn while the others wait on the host; then, all together, the
    host ms of a whole call (copy, sync, barrier, launch), of the plain
    version and of gloo's all_reduce of the same CUDA tensor."""
    import torch.distributed as dist

    from hgnn2_torch.ops import ring as ring_ops

    ring, S, r = mesh.ring, mesh.size, mesh.rank
    x = ring_inputs(S, (V, 16), 7, dev)[r]
    n = x.numel()
    out = ring(x)
    t = {"n": n, "S": S}
    for q in range(S):
        dist.barrier(group=ring.group)
        if q == r:
            t["kernel_ms"] = _device_ms(lambda: ring.reduce(n, out))
            t["kernel_ms_in_run"] = _device_ms(lambda: ring.reduce(n, out),
                                               n=100, reps=5)
    dist.barrier(group=ring.group)

    def gloo():
        y = x.clone()
        dist.all_reduce(y, group=ring.group)

    t["call_host_ms"] = _host_ms(lambda: ring(x), dev, reps=20)
    t["plain_host_ms"] = _host_ms(
        lambda: ring_ops.process_ring_reference(x, ring.group), dev)
    t["library_host_ms"] = _host_ms(gloo, dev)
    return t


def _ring_forwards(spec: str, args, mesh, pb, dev) -> dict:
    """Phase ring's model: a train-mode forward (updating the BN running
    stats), then an eval forward, each through K5 (use_ring=True) under
    no_grad; their outputs, the BN stats, the all-reduces and K5 across
    processes' launches (ProcessRing.launches from 0), and the host ms
    of an eval forward."""
    import torch

    from hgnn2_torch.ops.ring import ProcessRing
    from hgnn2_torch.parallel import spmd

    model = build_packed("ring", spec, args, pb.x.shape[1]).to(dev)
    rec, n_ar = {}, 0
    with torch.no_grad():
        ProcessRing.launches = 0
        for mode in ("train", "eval"):
            model.train(mode == "train")
            ops = spmd.partitioned_packed_ops(mesh, pb, model.J, use_ring=True)
            rec[f"{mode}_out"] = model(pb, ops=ops).cpu()
            n_ar += ops.comm_bytes_per_step()["n_allreduce_fwd"]
            if mode == "train":
                rec["state"] = {k: v.detach().cpu().clone()
                                for k, v in model.state_dict().items()}
        rec["launches"], rec["n_allreduce"] = ProcessRing.launches, n_ar
        rec["host_ms"] = _host_ms(lambda: model(
            pb, ops=spmd.partitioned_packed_ops(mesh, pb, model.J,
                                                use_ring=True)), dev)
    return rec


def run_ring(args, dev) -> dict:
    """Phase ring in this process (one rank of the edge axis over every
    process); a mesh of one process holds its ranks in it (control)."""
    import torch

    from hgnn2_torch.parallel import multihost

    mesh = multihost.edge_mesh(dev)
    pb = packed_batch(args)
    try:
        mesh.ring(torch.zeros(4, device=dev, requires_grad=True))
    except RuntimeError as err:
        if "no gradient" not in str(err):
            raise
    else:
        raise AssertionError("ProcessRing took a tensor that requires grad")
    rec = _ring_checks(args, mesh, pb.num_node_slots, dev)
    if dev.type == "cuda":
        rec["timing"] = _ring_timing(mesh, pb.num_node_slots, dev)
    x = ring_inputs(mesh.size, (pb.num_node_slots, 16), 7, dev)[mesh.rank]
    rec["host_ms"] = _host_ms(lambda: mesh.ring(x), dev)
    pb = pb.to(dev)
    rec["models"] = {spec: _ring_forwards(spec, args, mesh, pb, dev)
                     for spec in args.ring_models}
    if dev.type == "cuda":
        for spec, m in rec["models"].items():
            if m["launches"] != m["n_allreduce"]:
                raise AssertionError(f"{spec}: {m['launches']} launches of "
                                     f"K5 across processes for "
                                     f"{m['n_allreduce']} all-reduces")
    rec["losses"] = [float(m["eval_out"].mean())
                     for m in rec["models"].values()]
    rec["comm"] = dict(mesh.ring.comm)
    mesh.ring.close()
    return rec


def _fallback_steps(spec: str, args, mesh, pb, dev) -> dict:
    """Phase psum_fallback's model: args.steps SGD steps of the masked
    squared error (bench_scaling.py's loss) through the edge-partitioned
    ops with the plain, differentiable reduce, backpropagated by
    spmd.backward (the gradient summed over the processes once). Each
    step runs under runtime.deterministic: every process computes the
    node-level work after each reduce on its own replica, and the segment
    sums' atomics would round those replicas differently (a loss of 110.9
    one ulp apart on one of 4 processes sharing a card), so the processes'
    losses could not agree to AGREE; an op left without a deterministic
    form raises."""
    from hgnn2_torch import runtime
    from hgnn2_torch.parallel import spmd

    model = build_packed("psum_fallback", spec, args, pb.x.shape[1]).to(dev)
    opt, sched = _optimizer("psum_fallback", args, model)
    params = list(model.parameters())

    def step(batch):
        opt.zero_grad()
        model.train()
        with runtime.deterministic() as refused:
            ops = spmd.partitioned_packed_ops(mesh, batch, model.J)
            out = model(batch, ops=ops)
            loss = (((out[:, 0] - batch.y) ** 2 * batch.gmask).sum()
                    / batch.gmask.sum())
            spmd.backward(loss, mesh.grid, params)
        if refused:
            raise RuntimeError(f"psum_fallback: ops without a deterministic "
                               f"form: {refused}")
        opt.step()
        sched.step()
        return {"loss": loss.detach()}

    grid = mesh.grid or spmd.RankGrid(1, mesh.size, dev)
    return _run(step, model, pb, args.steps, grid)


def _halo_steps(spec: str, args, grid, bundle, dev) -> dict:
    """Phase halo_giant_graph's model (bn_axis "edge"): args.steps
    evaluations of the halo loss and its gradients (spmd.backward), no
    update, each under runtime.deterministic (the segment sums' atomics
    would make each evaluation differ from the last by several 1e-6 of
    the loss, the size of the check against the control); the first
    forward's halo exchanges (halo_comm_bytes)."""
    from hgnn2_torch import runtime
    from hgnn2_torch.parallel import halo, spmd

    model = build_packed("halo_giant_graph", spec, args,
                         bundle.arrays["x"].shape[-1], bn_axis="edge").to(dev)
    params = list(model.parameters())
    logs = []

    def step(_):
        model.zero_grad()
        log = None if logs else halo.new_comm_log()
        if log is not None:
            logs.append(log)
        with runtime.deterministic():
            loss = halo.halo_packed_loss(model, grid, bundle, comm_log=log)()
            spmd.backward(loss, grid, params)
        return {"loss": loss.detach()}

    rec = _run(step, model, None, args.steps, grid)
    rec["halo_bytes"] = halo.halo_comm_bytes(logs[0], bundle,
                                             grid.shape["edge"])
    return rec


def _models_record(runs: dict) -> dict:
    """A phase's record of several models' runs: each under "models",
    the last one's losses, host ms and traffic at the top."""
    last = list(runs.values())[-1]
    return {"models": runs, "losses": last["losses"],
            "host_ms": last["host_ms"], "comm": last["comm"]}


def run_psum_fallback(args, dev) -> dict:
    from hgnn2_torch.parallel import multihost

    pb = packed_batch(args).to(dev)
    return _models_record({spec: _fallback_steps(
        spec, args, multihost.edge_mesh(dev), pb, dev)
        for spec in args.fallback_models})


def run_halo(args, dev) -> dict:
    from hgnn2_torch.parallel import halo, multihost

    S = multihost.process_count()
    bundle = halo.build_halo_lg_bundle(halo_batch(args), S, device=dev)
    return _models_record({spec: _halo_steps(
        spec, args, multihost.global_mesh(("edge",), device=dev), bundle, dev)
        for spec in args.halo_models})


def control(phase: str, args, device) -> dict:
    """``phase`` in this one process over its global data (the processes'
    batches or rows together), every rank on ``device``: the
    single-process run the multi-process one must match."""
    import torch

    from hgnn2_torch.parallel import halo, spmd

    device = torch.device(device)
    S = args.processes
    if phase == "ring":
        mesh = spmd.EdgeMesh([device] * S)
        pb = packed_batch(args).to(device)
        return {"models": {spec: _ring_forwards(spec, args, mesh, pb, device)
                           for spec in args.ring_models}}
    if phase == "psum_fallback":
        mesh = spmd.EdgeMesh([device] * S)
        pb = packed_batch(args).to(device)
        return _models_record({spec: _fallback_steps(spec, args, mesh, pb,
                                                     device)
                               for spec in args.fallback_models})
    if phase == "halo_giant_graph":
        bundle = halo.build_halo_lg_bundle(halo_batch(args), S, device=device)
        return _models_record({spec: _halo_steps(
            spec, args, spmd.RankGrid(1, S, device), bundle, device)
            for spec in args.halo_models})
    if phase == "dp":
        parts = dp_batches(args)
        batch = dataclasses.replace(parts[0], **{
            f.name: torch.cat([getattr(b, f.name) for b in parts]).to(device)
            for f in dataclasses.fields(parts[0])})
        grid = spmd.RankGrid(args.processes, 1, device)
        return run_phase(phase, args, grid, batch, None)
    if phase == "edge":
        grid = spmd.RankGrid(1, args.processes * args.local_ranks, device)
        return run_phase(phase, args, grid, edge_stacked(args).to(device),
                         "edge")
    grid = spmd.RankGrid(args.processes, args.local_ranks, device)
    return run_phase(phase, args, grid, hybrid_data(args)[1].to(device),
                     spmd.AXES)


def _whole_batch_control(args, records, device) -> float:
    """The hybrid steps over the whole batch as one shard of a
    (1, 1) grid in this process: the final loss."""
    from hgnn2_torch.parallel import spmd

    whole = spmd.make_packed_shards(
        records, 1, node_capacity=sum(r.n_nodes for r in records),
        edge_capacity=sum(r.n_dir_edges for r in records),
        graphs_per_shard=len(records), task=0, device="cpu")
    stacked = spmd.stack_shards([whole], device)
    grid = spmd.RankGrid(1, 1, device)
    model = build_model("hybrid", args, stacked.x.shape[-1], spmd.AXES)
    return _packed_steps("hybrid", args, model.to(device), grid, stacked,
                         spmd.AXES)["losses"][-1]


def run_dp(args, dev) -> dict:
    from hgnn2_torch.parallel import multihost

    grid = multihost.global_mesh(("data",), device=dev)
    batch = multihost.make_global_batch(
        grid, dp_batches(args)[multihost.process_index()])
    return run_phase("dp", args, grid, batch, "data")


def run_edge(args, dev) -> dict:
    from hgnn2_torch.parallel import multihost

    p, R = multihost.process_index(), args.local_ranks
    grid = multihost.global_mesh(("edge",), local_ranks=R, device=dev)
    stacked = multihost.make_global_batch(
        grid, rows(edge_stacked(args), p * R, (p + 1) * R), "edge")
    return run_phase("edge", args, grid, stacked, "edge")


def run_hybrid(args, dev) -> dict:
    """The hybrid steps, their last loss held to the same steps over the
    whole batch as one shard in this process."""
    from hgnn2_torch.parallel import multihost, spmd

    p, P, R = multihost.process_index(), args.processes, args.local_ranks
    grid = multihost.global_mesh(spmd.AXES, shape=(P, R), local_ranks=R,
                                 device=dev)
    recs3, hstacked = hybrid_data(args)
    stacked = multihost.make_global_batch(grid, rows(hstacked, p, p + 1))
    rec = run_phase("hybrid", args, grid, stacked, spmd.AXES)
    hl = rec["losses"][-1]
    cl = _whole_batch_control(args, recs3, dev)
    if not (abs(hl - cl) <= CONTROL_RTOL * max(1.0, abs(cl))):
        raise AssertionError(f"hybrid-across-processes loss {hl} != "
                             f"single-process control {cl}")
    return rec


RUNS = {"dp": run_dp, "edge": run_edge, "hybrid": run_hybrid,
        "ring": run_ring, "psum_fallback": run_psum_fallback,
        "halo_giant_graph": run_halo}


def child(args) -> None:
    import torch

    from hgnn2_torch import resolve_device
    from hgnn2_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.setup_distributed(args.coordinator, args.processes, args.child,
                                backend=args.backend, timeout_s=args.timeout)
    p, P = args.child, args.processes
    assert multihost.process_count() == P and multihost.process_index() == p
    dev = resolve_device(args.device)
    if dev.type == "cuda" and args.backend == "nccl":  # a card a process
        dev = torch.device("cuda", p % torch.cuda.device_count())
    records = {phase: RUNS[phase](args, dev) for phase in args.phases}

    for phase, rec in records.items():
        print(f"{TAGS[phase]} proc={p} loss={rec['losses'][-1]!r}",
              flush=True)
        comm = " ".join(f"{k}={v:g}" for k, v in rec["comm"].items())
        print(f"MHSTAT phase={phase} proc={p} host_ms={rec['host_ms']:.3f} "
              f"{comm}", flush=True)
        if args.out:
            torch.save(rec, os.path.join(args.out, f"{phase}_{p}.pt"))
    torch.distributed.destroy_process_group()


def _child_argv(args, pid: int, port: int) -> list[str]:
    argv = [sys.executable, "-m", "hgnn2_torch.scripts.dryrun_multihost",
            "--child", str(pid), "--coordinator", f"localhost:{port}"]
    for name in ("processes", "local_ranks", "steps", "device", "backend",
                 "layers", "features", "dp_molecules", "edge_molecules",
                 "hybrid_molecules", "packed_molecules", "ring_big",
                 "halo_nodes", "timeout", "out", "weights"):
        value = getattr(args, name)
        if value is not None:
            argv += [f"--{name}", str(value)]
    for name in ("phases", "ring_models", "fallback_models", "halo_models"):
        argv += [f"--{name}", *getattr(args, name)]
    return argv


def parent(args) -> dict:
    """Starts the children, waits for each (args.timeout seconds), and
    checks that every process reports the same finite loss in each phase.
    Returns {phase: {"losses": [one a process], "host_ms": [...],
    "comm": [...]}}; raises SystemExit when a child fails or times out."""
    import math

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    # the children only load the kernels: ring's, and the line-graph
    # exchange's for phase dp's GNNLineGraph
    libs = [lib for lib, phase in (("ring", "ring"), ("lg_exchange", "dp"))
            if phase in args.phases]
    if args.device != "cpu" and libs:
        from hgnn2_torch.ops import cuda_build

        cuda_build.build_all(libs)
    env = dict(os.environ, OMP_NUM_THREADS="1", HGNN2_PREBUILT="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(_child_argv(args, pid, port), cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for pid in range(args.processes)]
    outs = []
    try:
        for pid, proc in enumerate(procs):
            try:
                out, err = proc.communicate(timeout=args.timeout)
            except subprocess.TimeoutExpired:
                raise SystemExit(f"child {pid} timed out after "
                                 f"{args.timeout} s") from None
            if proc.returncode != 0:
                sys.stderr.write(err[-4000:])
                raise SystemExit(f"child {pid} failed rc={proc.returncode}")
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    summary = {ph: {"losses": [], "host_ms": [], "comm": []}
               for ph in args.phases}
    tags = {tag: ph for ph, tag in TAGS.items()}
    for out in outs:
        for line in out.splitlines():
            key, *fields = line.split(" ")
            kv = dict(f.split("=", 1) for f in fields)
            if key in tags:
                summary[tags[key]]["losses"].append(float(kv["loss"]))
                print(line)
            elif key == "MHSTAT":
                rec = summary[kv.pop("phase")]
                kv.pop("proc")
                rec["host_ms"].append(float(kv.pop("host_ms")))
                rec["comm"].append({k: float(v) for k, v in kv.items()})
                print(line)
    for phase, rec in summary.items():
        vals = rec["losses"]
        if len(vals) != args.processes or not all(map(math.isfinite, vals)):
            raise SystemExit(f"{phase}: losses {vals}")
        bar = (REPLICA_RTOL * max(abs(v) for v in vals) if phase == "ring"
               else AGREE)
        if any(abs(v - vals[0]) >= bar for v in vals):
            raise SystemExit(f"{phase}: processes disagree: {vals}")
    print(f"dryrun_multihost ok: {args.processes} processes x "
          f"{args.local_ranks} ranks on {args.device} ({args.backend}), "
          + " ".join(f"{ph}_loss={rec['losses'][0]!r}"
                     for ph, rec in summary.items())
          + (" (hybrid == its single-process control, asserted in-child)"
             if "hybrid" in summary else ""), flush=True)
    return summary


def main(argv=None):
    args = parse_args(argv)
    if args.child is not None:
        return child(args)
    return parent(args)


if __name__ == "__main__":
    main()
