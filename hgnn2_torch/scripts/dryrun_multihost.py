"""Multi-process dry run of the port (counterpart of
scripts/dryrun_multihost.py): N real processes, one grid of ranks, the
three training modes of the parallel slice.

    python -m hgnn2_torch.scripts.dryrun_multihost [--processes 2]
        [--local_ranks 2] [--steps 2] [--device cuda|cpu] [--backend gloo]

The parent binds port 0 for a free port and starts N child processes,
each with its own timeout; each joins the process group
(parallel.multihost.setup_distributed) and runs:

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
     as the JAX dry run asserts).

Every step is SGD (no momentum; Adamax's sign-like update would amplify
reduction-order noise), at DP_LR in phase dp and PACKED_LR in the
others. The parent asserts that every process reports the same finite
loss in each phase, to 1e-6. Each child prints its losses and, a phase,
its host ms a step and the cross-process all-reduces a step (calls and
bytes: psum's forward and backward, the gradient sum). --out DIR saves
each phase's record (losses, step-0 gradients, the state after the
steps) as DIR/{phase}_{process}.pt; --weights DIR starts each phase's
model from DIR/{phase}.pt (a state_dict) in place of its seeded init.
control() runs a phase on the global data in one process, for
comparisons.

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
PHASES = {"dp": "MHLOSS", "edge": "MHESLOSS", "hybrid": "MHHYLOSS"}
AGREE = 1e-6  # processes' losses, absolute (the JAX dry run's bar)
CONTROL_RTOL = 1e-4  # hybrid vs its in-child control, x max(1, |loss|)
N_MAX = 32  # node bucket of every dense batch
DP_LR = 1e-3  # SGD lr of phase dp
PACKED_LR = 1e-5  # SGD lr of the packed phases


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


# ------------------------------------------------------------ the runs


def build_model(phase: str, args, in_features: int, bn_axis):
    """Phase dp's GNNLineGraph or the packed phases' PackedLGGNN (J 1,
    order 2, args.layers x args.features), seeded, with BN over bn_axis;
    its weights from args.weights/{phase}.pt when given."""
    import torch

    from hgnn2_torch.nn import models, packed

    gen = torch.Generator().manual_seed(list(PHASES).index(phase))
    kw = dict(in_features=in_features, n_features=args.features,
              n_layers=args.layers, J=1, order=2, bn_axis=bn_axis,
              generator=gen)
    model = (models.GNNLineGraph(**kw) if phase == "dp"
             else packed.PackedLGGNN(**kw))
    if args.weights:
        model.load_state_dict(torch.load(
            os.path.join(args.weights, f"{phase}.pt"), weights_only=True))
    return model


def _optimizer(phase: str, args, model):
    from hgnn2_torch.training import optim
    from hgnn2_torch.training.config import OptimConfig

    cfg = OptimConfig(optim="sgd", momentum=0.0,
                      lr=DP_LR if phase == "dp" else PACKED_LR)
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


def control(phase: str, args, device) -> dict:
    """``phase`` in this one process over its global data (the processes'
    batches or rows together), every rank on ``device``: the
    single-process run the multi-process one must match."""
    import torch

    from hgnn2_torch.parallel import spmd

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


def child(args) -> None:
    import torch

    from hgnn2_torch import resolve_device
    from hgnn2_torch.parallel import multihost, spmd

    torch.set_num_threads(1)
    multihost.setup_distributed(args.coordinator, args.processes, args.child,
                                backend=args.backend, timeout_s=args.timeout)
    p, P, R = args.child, args.processes, args.local_ranks
    assert multihost.process_count() == P and multihost.process_index() == p
    dev = resolve_device(args.device)
    if dev.type == "cuda" and args.backend == "nccl":  # a card a process
        dev = torch.device("cuda", p % torch.cuda.device_count())
    records = {}

    grid = multihost.global_mesh(("data",), device=dev)
    batch = multihost.make_global_batch(grid, dp_batches(args)[p])
    records["dp"] = run_phase("dp", args, grid, batch, "data")

    grid = multihost.global_mesh(("edge",), local_ranks=R, device=dev)
    stacked = multihost.make_global_batch(
        grid, rows(edge_stacked(args), p * R, (p + 1) * R), "edge")
    records["edge"] = run_phase("edge", args, grid, stacked, "edge")

    grid = multihost.global_mesh(spmd.AXES, shape=(P, R), local_ranks=R,
                                 device=dev)
    recs3, hstacked = hybrid_data(args)
    stacked = multihost.make_global_batch(grid, rows(hstacked, p, p + 1))
    records["hybrid"] = run_phase("hybrid", args, grid, stacked, spmd.AXES)
    hl = records["hybrid"]["losses"][-1]
    cl = _whole_batch_control(args, recs3, dev)
    if not (abs(hl - cl) <= CONTROL_RTOL * max(1.0, abs(cl))):
        raise AssertionError(f"hybrid-across-processes loss {hl} != "
                             f"single-process control {cl}")

    for phase, rec in records.items():
        print(f"{PHASES[phase]} proc={p} loss={rec['losses'][-1]!r}",
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
                 "hybrid_molecules", "timeout", "out", "weights"):
        value = getattr(args, name)
        if value is not None:
            argv += [f"--{name}", str(value)]
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
    env = dict(os.environ, OMP_NUM_THREADS="1",
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
    summary = {ph: {"losses": [], "host_ms": [], "comm": []} for ph in PHASES}
    tags = {tag: ph for ph, tag in PHASES.items()}
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
        if any(abs(v - vals[0]) >= AGREE for v in vals):
            raise SystemExit(f"{phase}: processes disagree: {vals}")
    print(f"dryrun_multihost ok: {args.processes} processes x "
          f"{args.local_ranks} ranks on {args.device} ({args.backend}), "
          f"dp_loss={summary['dp']['losses'][0]!r} "
          f"edge_sharded_loss={summary['edge']['losses'][0]!r} "
          f"hybrid_dpxedge_loss={summary['hybrid']['losses'][0]!r} "
          "(hybrid == its single-process control, asserted in-child)",
          flush=True)
    return summary


def main(argv=None):
    args = parse_args(argv)
    if args.child is not None:
        return child(args)
    return parent(args)


if __name__ == "__main__":
    main()
