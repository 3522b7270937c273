#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. build    compile the CUDA kernels from hgnn2_torch/ops/csrc with nvcc;
  2. kernels  time the no-op kernel (the launch floor); hold K1 (fused
              CCN-1D promotion + contraction), K3 (fused CCN-2D promotion
              + 18 contractions) and their backward kernels K2 and K4
              (K4: the whole backward g -> df, contract_18's adjoint
              included) against their plain PyTorch versions on the
              card, at the serving bucket (1,024 QM9-shaped molecules,
              V = 16,384, K = 5; C = 5 and 2, both channel layouts), at
              K = 8, on a batch whose vertex count is no multiple of a
              tile and at C = 256 on the K = 8 batch (channel tiles);
              hold the gradient through each autograd Function against
              autograd through the plain path; time each kernel (one
              launch, and a launch in a run of 100) beside its bound, the
              no-op on K1's grid, and K4's plain prologue
              (contract_18_transpose_parts) apart; hold K5 (the ring
              all-reduce) to its plain twin exactly for S = 2, 4 and 8
              ranks at the packed path's
              node blocks (V = 10,944, F = 1, 5, 16), at S = 4 with
              2^20 x 16 floats a rank, and on unaligned and odd-sized
              buffers; hold MaskedBatchNorm's two kernels (bn_forward,
              bn_backward) against its composition of PyTorch ops at the
              GNN cell's shapes and time them beside it and their bound;
              hold PowerLayer's two kernels (power_forward,
              power_backward: graph_op, both convolutions, the ReLUs and
              the batch norm) against their composition at the GNN
              cell's shapes (1,024 molecules at node buckets 16 and 32,
              fan-ins 15 and 6) and time them beside it and their bound;
              hold the line-graph exchange's six kernels (Pm/Pd, Pm^T/Pd^T
              and the NB apply, forward and backward) to their plain
              versions on the CPU bit for bit and to the one-hot
              composition at the line-graph cell's shapes (2,048
              molecules, node/edge buckets 16/32 and 32/64), and time
              them beside it and their bound;
  3. serving  save CCN2D(L=2, h=2) and CCN1D(L=20, h=2) bundles with random
              weights in flax layout (converted by hgnn2_torch.convert),
              load them on the card and predict 2,048 molecules; hold the
              predictions against the same bundles served on the CPU, and
              check through the launch counts that every layer ran its
              kernel;
  4. training train both models through cli.common.run_experiment on the
              card (5,120 synthetic molecules, 1,024 a step, 2 epochs,
              Adamax) from seeded flax-layout weights; check finite losses,
              the launch counts of all four kernels, and the first steps'
              losses and step-0 gradients against the same steps on the
              CPU; time a step and split it into forward, backward and
              optimizer;
  5. packed   edge-partitioned packed inference: PackedLGGNN(h=8, L=3,
              J=1, order=2) and PackedGNN(h=1, L=15, J=1), built by
              cli.common.build_packed_model with seeded flax-layout
              weights, over 1,024 QM9-shaped molecules in one packed
              batch split over S = 4 ranks of an EdgeMesh on the card,
              every all-reduce through K5; a train-mode forward (batch
              statistics) and an eval forward, held against the card's
              single-rank ops and the CPU's ring twin; K5 launches per
              forward (one an all-reduce); host-clock and device ms per
              forward and molecules/s for the ring, the plain reduce and
              single-rank ops;
  6. main     the main path, whose hand-written kernels are the power
              layer's two: train GNNSimple(L=15, h=1, J=1) through
              cli.common.run_experiment on the card (20,480 synthetic
              molecules, 2,048 a step, 2 epochs, Adamax at lr 3e-4) from
              seeded flax-layout weights; check the power-layer kernels'
              launches (the power layers times the train forwards; no BN
              kernel), finite losses, the first steps' losses, the step-0
              gradients and BN running stats, and eval predictions on a
              valid batch against the CPU; the same batch through
              GNNSimple(L=3, h=2) with J=2, the GRU update and the
              reference compat flags, card vs CPU; bf16 graph_op against
              f32 (the L=15 model's bf16 deviation is printed); time a
              step (host clock, device split by CUDA events, the CUDA
              kernels of each part by torch.profiler, the card's busy
              share). Phase 4 prints the same for the CCN steps;
  7. lggnn    the line-graph GNN, which runs the batch norm's kernels:
              train GNNLineGraph(L=5, h=1, J=1, update order 2) through
              cli.common.run_experiment on the card (the same 20,480
              molecules, 2,048 a step, 2 epochs, Adamax at lr 3e-4) from
              seeded flax-layout weights; check the BN kernels' launches
              (the batch norms times the train forwards), finite losses, the first
              steps' losses, the step-0 gradients and the node and edge
              BN running stats, and eval predictions on a valid batch
              against the CPU; GNNLineGraph(L=3, h=2, J=2) with update
              orders 1 and 3 and the reference compat flags on that
              batch, card vs CPU;
              bf16 lg_graph_op against f32 (the L=5 model's bf16
              deviation is printed); time a step as phase 6 does;
  8. packed   packed training (--packed), which runs no hand-written
     train    kernel: train PackedGNN(L=15, h=1, J=1), then
              PackedLGGNN(L=5, h=1, J=1, update order 2), through
              cli.common.run_experiment on the card (the same molecules,
              2,048 a step, 2 epochs) from seeded flax-layout weights;
              check finite losses, the first steps, step-0 gradients and
              BN running stats, and eval predictions on a valid batch
              against the CPU; PackedGNN's run writes a checkpoint every
              epoch: restore the latest on the CPU (bit for bit), then
              resume for one more epoch with --bn_recalib on the card and
              on the CPU and hold the two histories to each other; time a
              step as phase 6 does.
  9. serving  serving from files: assert that the native (C++) host
     from     library built; write caches of synthetic QM9-shaped
     files    molecules with qm9.save_cache (10,240 to train on, 2,048
              requests); time one 1,024-molecule batch build of each
              layout with the native library on and off (batches equal);
              train GNNSimple(L=15, h=1), GNNLineGraph(L=5, h=1, order
              2), PackedGNN(L=15, h=1), CCN2D(L=2, h=2) and CCN1D(L=20,
              h=2) for one epoch each through main_gnn_qm9 / main_ccn_qm9
              --data_path --ckpt on the card; export each with --bs 1024
              --buckets 256; serve the 2,048 requests through each bundle
              on the card (molecules/s, launches: K3 or K1 once a layer a
              chunk, none for the GNNs; the build vs forward split) and on
              the CPU; hold call(arrays) to predict on one 256-molecule
              chunk; run the predict CLI on the card and on the CPU and
              hold its predictions and MAE to each other.
 10. captured the compiled step and the scanned epoch as CUDA graphs:
              for GNNSimple(L=15, h=1), GNNLineGraph(L=5, h=1, order 2)
              and PackedGNN(L=15, h=1) at 2,048 molecules a step and
              CCN1D(L=20, h=2; K1, K2) and CCN2D(L=2, h=2; K3, K4) at
              1,024, two epochs through run_epoch_scanned (one replayed
              graph a step for each shape group) against the eager
              run_epoch from the same weights in the same order;
              evaluate_scanned against evaluate, the captured BN
              recalibration against the eager one, make_multi_train_step
              (10 steps, one graph) against 10 eager steps; host and
              device ms a step and the busy share, eager and replayed;
              graphs, shape groups, capture seconds and pool bytes.
 11. sharded  molecule-aligned sharded training: PackedGNN(L=15, h=1) over
              4 shards and over 2 dp x 2 shards, PackedLGGNN(L=5, h=1,
              order 2) over 4 shards (2,048 molecules a step), CCN1D(L=20,
              h=2) and CCN2D(L=2, h=2) over 4 shards with --ccn_kernel
              (1,024 a step), every rank on the card, each trained through
              cli.common.run_experiment for 2 epochs from seeded
              flax-layout weights (CCN: K1-K4 launches held to the layers x
              the Python-level forwards); the first steps against the
              CPU's sharded run, the first step against the unsharded
              model's on the same molecules (losses, gradients, BN stats),
              replayed against eager sharded steps (phase 10's rules), for
              CCN the kernels against the plain path on the card; host and
              device ms a step, busy share, molecules/s, and the
              flattened capacities against the unsharded batch's.

 12. dp       data parallelism: GNNSimple(L=15, h=1) through
              cli.common.run_experiment with --dp 2 (2,048 molecules a
              step split over 2 ranks of the card) against --dp 1 from the
              same weights, both replaying graphs; then
              hgnn2_torch.scripts.dryrun_multihost with 2 processes sharing
              the card through gloo (GNNLineGraph L=5 h=1 order 2 over
              1,024 molecules a process, PackedLGGNN L=5 h=1 over 2
              processes x 2 ranks, the (2, 2) hybrid): the processes agree,
              and each phase holds to its single-process control on the
              card (losses, step-0 gradients); host ms a step and the
              cross-process all-reduces a step.
 13. halo     one giant graph (8,192 nodes, bench_scaling.py's) over 4 halo
              ranks on the card: halo_partitioned_spmm against
              sparse.spmm; PackedLGGNN L=5 h=1 order 2 and PackedGNN L=15
              h=1 through halo_packed_loss against the unpartitioned model
              (loss, gradients; both under deterministic algorithms, so
              index_add_'s atomics add no run-to-run noise); halo bytes
              against the all-reduce path's; device ms of a halo step
              against the unpartitioned step.
 14. high    CCN-2D at K > 8, where no kernel runs: the reference recipe
     degree  scripts/exp_ccn_col.sh --k 2 (K = 16, L = 2, h = 12, batch
              64) through main_generate_ccn for 2 epochs of 4 steps with
              --chunks 1 and --chunks 4 (vertex chunks, C3) on the card
              and on the CPU, the histories held to each other; then
              CCN2D(L=2, h=2, scan_promotion=True) (the scan over
              neighbour slots, C2) against CCN2D() on 16 complete graphs
              of 64 nodes (K = 64, V = 1,024; the crossover ladder's
              graphs): step-0 output and gradients, each path's replayed
              steps against its eager steps, ms a step and peak device
              memory, the scan's peak below the materialized path's;
              K1-K5 launch 0 times.
 15. ranks on several processes (F4): hgnn2_torch.scripts.dryrun_multihost
     across   with 4 processes sharing the card through gloo, one edge
     processes rank a process: ring (K5 across processes, ring.ProcessRing
              over slots mapped by CUDA IPC, bit-equal to its plain version
              on every process at phase 2's shapes and over 8 calls in a
              row; PackedLGGNN h=8 L=3 and PackedGNN h=1 L=15 forwards over
              1,024 molecules through it), psum_fallback (3 SGD steps of
              PackedLGGNN h=8 L=3 through the differentiable all-reduce)
              and halo_giant_graph (phase 13's graph and models, the
              processes as halo ranks); ring again over 2 processes. Each
              held to the same run in this process on the card (forwards
              1e-5 x max |pred|, steps MH_RTOL, halo as phase 13); the
              kernel's device ms alone, host ms a call, bound, gloo's
              all_reduce and the one-device K5 on the same parts.
 16. measure- the harnesses of hgnn2_torch/scripts through their main(argv)
     ment     at reduced sizes: profile_lggnn (GNNLineGraph and
     harnesses PackedLGGNN L=5 h=1 over 8,192 molecules: the traced
              epoch's kernel table shows the replayed graphs' kernels, >= 10
              kernels, > 100 launches a step, device time 50-105 % of the
              best epoch's host time; the dense h sweep 1, 4); phase 10's
              replayed GNNSimple L=15 step, 3 replays under profiling.trace
              (top 15 kernels, launches a step, the index_select,
              index_add_, GEMM and elementwise shares); profile_ccn1d
              (2,048 molecules, h sweep 2, 8: K1 and K2 launch on the
              kernel path only, the paths' first-step losses from the same
              weights within 1e-5); bench_serving --repeats 10 in a fresh
              process, in a fresh process after a torch.profiler run (K3
              launches in its CCN-2D bundle, counted by each child) and in
              this one, beside phase 9's rates;
              packed_crossover at h = 1 and 16 over 8,192 molecules, one
              epoch (scan groups: 1 for every packed row with uniform
              capacities, the dense rows' from the records' sizes).
 17. quality  the quality harnesses of hgnn2_torch/scripts at a cut:
     harnesses regression_floor at n = 2,000 and 8,000 against JAX's
              committed floor.json files (rtol 1e-9); each of
              run_validation's nine RUNS entries for 2 epochs (JAX's data,
              models and batches; the cut set on the cfg): history length
              (the recalibration row included), finite values, the CCN
              kernels' launches against the K rule (K3 and K4 in
              reg_ccn2d at K = 5; none in cls_ccn1d at K = 11 > 8), the gnn
              range splits' 800 molecules all in range; reg_ccn2d's first
              two steps on the kernel path against the plain path from the
              same weights (1e-5); diagnose_quality_gap's linear probe (2
              epochs) and BN modes on the cut control run's model, its
              running statistics bit-equal after the train-mode pass.
 18. last     hgnn2_torch/scripts/bench_suite.py's sections at a cut
     harnesses (512 molecules, 3 timed calls, the packed SpMM at scale
              at 2^16 nodes, the halo build at 40,000 edges): the launches
              of each section against the K rule (K1-K4 in the CCN rows'
              kernel paths; K3 and K4 at K = 8, inside the captured
              10-step graphs; none on a plain path or at K = 32), K = 8
              and 32, K3's refusal at K = 32, the K = 8 kernel row's first
              loss against the plain row's (1e-5), every chained SpMM's
              graph output against its eager calls (f32 1e-5, bf16 2^-7),
              the halo rows against the CPU's count; bench_scaling.py
              (128 molecules, a 256-node giant graph, 1, 2, 4 ranks) on the
              card and on the CPU, their comm accounting equal;
              ccn_card_runs.py's chunks run (--edge_shards 4 --chunks 2
              against --chunks 1, one epoch, 1e-5) and scan run (CCN2D at
              K = 5: materialized, scan within 1e-4, kernels).

Phases 4 and 6-10 train through fit and phase 11 through fit_sharded,
whose epochs replay CUDA graphs: a kernel wrapper's launch count moves
when Python calls it (an eager step, a graph's warm-up runs and its
capture), not when a graph replays the launch it recorded. Phases 4, 6,
10 and 11 hold the counts to the layers times the Python-level forwards,
and every counted run holds the BN kernels' counts to the MaskedBatchNorm
calls that take them (train mode, CUDA, float32, no pooled statistics)
and the exchange's to the applies on index-form DenseBundles (CUDA,
float32, no fused operators);
phases 4 and 10 print the replayed launches (replays times the kernels a
graph holds) beside them.

The last three lines are JSON: the launch floor, each kernel (K5 across
processes' plain_ms and library_ms are host ms: a gloo collective each),
and {"ok": true, "device": {...}}. Exits non-zero without CUDA.

Float32 matmuls run without TF32 (runtime.setup) so that Linear layers
on the card compute what they compute on the CPU.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

TOL = dict(rtol=1e-5, atol=1e-5)  # kernel vs plain: f32 sums, other order
# gradient through a kernel pair vs autograd through the plain path:
# f32 sums of up to K^3 terms per entry in another order, so the error
# scales with the largest gradient, not with each entry
GRAD_RTOL = 1e-5
SERVE_RTOL = 1e-4  # card vs CPU predictions, relative to the largest |pred|
# card vs CPU training steps: losses and step-0 gradients. Sums over
# 16,384 vertices in another order (and the readout's atomics) differ in
# the last bits; Adamax's first steps move each weight by about lr
# whatever its gradient's size, so later losses differ a little more.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-4  # times the largest |gradient| of each tensor
GRAD_FLOOR = 1e-2  # GNNSimple: least gradient scale, x the model's max
BN_STATS_RTOL = 1e-4  # card vs CPU BN running stats, times max |stat|
# card vs CPU valid/test metrics of a whole epoch: a bias that only shifts
# what BN subtracts has a rounding-level gradient, which Adamax turns into
# steps of about lr with the rounding's sign, and eval-mode BN's running
# mean does not cancel that walk (measured 8.8e-4 to 1.5e-3 on PackedGNN's
# resumed epoch)
EVAL_RTOL = 5e-3
BF16_RTOL = 0.05  # bf16 vs f32 output, times mean |f32 output|
N_TRAIN_MOLS = 5120  # 4,096 train, 512 valid, 512 test
TRAIN_BS = 1024
TRAIN_EPOCHS = 2
CPU_STEPS = 3
N_SERVE_MOLS = 1024
N_REQUESTS = 2048
V_SERVE = 16384  # the CCN loader's vertex bucket for 10,964 vertices
SERVE_BUCKETS = [(1024, 16384), (256, 4096)]
N_PACKED_MOLS = 1024  # bench_scaling.py's --molecules default
N_MAIN_MOLS = 20480  # 16,384 train molecules: 8 steps of 2,048 an epoch
MAIN_BS = 2048  # bench.py's batch
RING_RANKS = 4
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke")


BUSY_CYCLES = 20_000_000  # about 10 ms of device spin at the H100's clock
RUN_LAUNCHES = 100  # back-to-back calls timed together (ms_in_run)


def _time_ms(fn, reps: int = 30, warmup: int = 3, busy: int = BUSY_CYCLES,
             n: int = 1) -> float:
    """Median device time of one call, by CUDA events around n
    back-to-back calls, over n, after warm-up.

    Before each run the device spins (torch.cuda._sleep) while the host
    enqueues the start event, the calls' kernels and the end event, so
    the interval holds the kernels back to back and none of the host's
    Python and launch overhead (tens of us per wrapper call, more than a
    small kernel takes). The spin outlasts the enqueue of a whole CCN-1D
    forward (20 layers, a few ms of host time); if it ended before the
    run was enqueued the interval would hold the host's gaps, so that
    raises. With n = 1 the time holds one launch's latency (``ms``)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(busy)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        if start.query():
            raise AssertionError("the device spin ended before the run of "
                                 f"{n} calls was enqueued")
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def _time_run_ms(fn) -> float:
    """One call's share of a run of RUN_LAUNCHES back-to-back calls
    (``ms_in_run``): each launch follows the last as soon as the device
    takes it, and the inputs stay in L2 from call to call, as on the
    CCN-1D path, where each layer reads the tables and the last layer's
    output."""
    return _time_ms(fn, reps=10, busy=10 * BUSY_CYCLES, n=RUN_LAUNCHES)


def _noop_launch(blocks: int = 1, threads: int = 32):
    """One launch of the no-op kernel (ccn_fused.cu:hgnn2_noop) on a grid
    of ``blocks`` blocks of ``threads`` threads, on the current stream:
    what a launch of that grid costs with no work."""
    import ctypes

    from hgnn2_torch.ops import cuda_build

    fn = cuda_build.entry("ccn_fused", "hgnn2_noop",
                          [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(blocks, threads, stream):
            raise RuntimeError("hgnn2_noop launch failed")
    return launch


def phase_floor() -> dict[str, float]:
    """The launch floor in the two readings every kernel gets: one launch
    between events after the device spin (floor_ms, beside each kernel's
    ms) and one launch of a back-to-back run (floor_ms_in_run, beside
    ms_in_run), of one block of 32 threads that does nothing."""
    noop = _noop_launch()
    floor = dict(floor_ms=_time_ms(noop), floor_ms_in_run=_time_run_ms(noop))
    print(f"  no-op kernel (1 block of 32 threads, no work): one launch "
          f"{floor['floor_ms']:.4f} ms, in a run of {RUN_LAUNCHES} "
          f"{floor['floor_ms_in_run']:.4f} ms a launch")
    return floor


def _bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    """The least time for n_bytes over the card's HBM and n_ops f32
    operations outside the tensor cores, at the data-sheet peaks of
    hgnn2_torch.profiling."""
    from hgnn2_torch import profiling

    hbm = profiling.chip_peak_hbm_bytes_per_s()
    f32 = profiling.chip_peak_flops("float32")
    if hbm is None or f32 is None:
        raise RuntimeError(f"no data-sheet peaks for "
                           f"{torch.cuda.get_device_name()}")
    t_bytes = n_bytes / hbm * 1e3
    t_ops = n_ops / f32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    ok = bool(torch.all(err <= TOL["atol"] + TOL["rtol"] * want.abs()))
    print(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(tolerance atol={TOL['atol']} rtol={TOL['rtol']}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def _ptxas_summary(log: str) -> list[str]:
    """One line per kernel instantiation of nvcc's -Xptxas -v report:
    registers and spill stores."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            k = re.search(r"(ccn[12]d_(?:for|back)ward)ILi(\d+)E", m.group(1))
            h = re.search(r"ring_allreduceILi(\d+)ELb(\d)E", m.group(1))
            b = re.search(r"(bn_(?:for|back)ward)ILi(\d)ELb(\d)E", m.group(1))
            name = (f"{k.group(1)}<K={k.group(2)}>" if k else
                    f"ring_allreduce<S={h.group(1)},vec={h.group(2)}>" if h
                    else f"{b.group(1)}<vec={b.group(2)},cached={b.group(3)}>"
                    if b else "noop" if m.group(1).endswith("4noopEv")
                    else m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{name}: {m.group(1)} registers, {spill} bytes spill stores")
    return out


def _k8_records():
    """Degree-capped random graphs (max degree 7, so K = 8 with self-loops),
    as bench_suite.py's K = 8 boundary case builds them."""
    from hgnn2_torch.graphs import GraphRecord

    rng = np.random.default_rng(11)
    recs = []
    for _ in range(256):
        n = int(rng.integers(10, 17))
        a = np.zeros((n, n), np.float32)
        for u in range(n):
            for v in rng.permutation(n)[:3]:
                if u != v and a[u].sum() < 7 and a[v].sum() < 7:
                    a[u, v] = a[v, u] = 1.0
        recs.append(GraphRecord(x=rng.standard_normal((n, 3)).astype(np.float32),
                                adj=a, y=np.float32(0.1)))
    return recs


def _grad_check(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = err <= GRAD_RTOL * scale and bool(torch.isfinite(got).all())
    print(f"  {name}: max_abs_err={err:.3e}, max |grad|={scale:.3e}, "
          f"tolerance {GRAD_RTOL} x max |grad| {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: gradient through the kernels disagrees")


def _expect_refusal(name: str, call, msg: str = "no autograd graph") -> None:
    """A raw forward wrapper returns a tensor with no autograd graph, so in
    grad mode it must refuse an f that requires grad (a model calling it
    there would train each layer on its own readout alone). The ring has
    no gradient at all, and refuses likewise."""
    try:
        call()
    except RuntimeError as e:
        if msg not in str(e):
            raise
        print(f"  {name} refuses an input that requires grad in grad mode: ok")
        return
    raise AssertionError(f"{name} accepted an input that requires grad")


def _f_grad(fn, f: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """d/df of sum(fn(f) * w) by autograd."""
    f = f.detach().clone().requires_grad_()
    (fn(f) * w).sum().backward()
    return f.grad


def phase_kernels(dev) -> dict[str, dict]:
    """K1..K4 against their plain versions, at the serving bucket for C = 5
    (the first layer) and C = 2 (later layers) and on the K = 8 batch;
    the gradients through promote_contract_1d/18 against autograd through
    the plain path. Returns each kernel's row of the kernels line, timed
    at the main path's shape: C = 5 for K1 and K3 (the first layer's
    forward), C = 2 for K2 and K4 (the backward runs from layer 2 on)."""
    from hgnn2_torch.data import qm9
    from hgnn2_torch.nn import ccn
    from hgnn2_torch.ops import ccn_fused, contractions as P

    cb = ccn.make_ccn_batch(qm9.synthetic_qm9_like(N_SERVE_MOLS, seed=0),
                            k_max=5, vertex_capacity=V_SERVE, task=0,
                            device=dev)
    cb8 = ccn.make_ccn_batch(_k8_records(), vertex_capacity=4096, device=dev)
    if cb8.nbr.shape[1] != 8:
        raise AssertionError(f"K=8 batch has K={cb8.nbr.shape[1]}")
    rng = np.random.default_rng(0)
    randn = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)).to(dev)
    V, K = cb.nbr.shape
    _expect_refusal("fused_contract_1d_forward", lambda: ccn_fused.fused_contract_1d_forward(
        cb.chi_idx, cb.nbr, randn(V, K, 2).requires_grad_()))
    _expect_refusal("fused_contract_forward", lambda: ccn_fused.fused_contract_forward(
        cb.chi_idx, cb.nbr, randn(V, K, K, 2).requires_grad_(), cb.deg, cb.row_mask))
    timed = {}  # (kernel, C) -> times at the serving bucket
    src = "hgnn2_torch/ops/csrc/ccn_fused.cu"
    pallas = "hgnn2_tpu/ops/pallas/ccn_fused.py"
    rows = {
        "K1": dict(name="fused_contract_1d_forward", route="cuda", source=src,
                   replaces=f"{pallas}:189", max_abs_err=0.0, library_ms=None),
        "K2": dict(name="fused_contract_1d_backward", route="cuda", source=src,
                   replaces=f"{pallas}:228", max_abs_err=0.0, library_ms=None),
        "K3": dict(name="fused_contract_forward", route="cuda", source=src,
                   replaces=f"{pallas}:60", max_abs_err=0.0, library_ms=None),
        "K4": dict(name="fused_contract_backward", route="cuda", source=src,
                   replaces=f"{pallas}:272", max_abs_err=0.0, library_ms=None),
    }

    def check(key, label, got, want):
        torch.cuda.synchronize()
        err = _compare(f"{key} {label}", got, want)
        rows[key]["max_abs_err"] = max(rows[key]["max_abs_err"], err)

    def check_1d(label, b, C):
        """K1, K2 and the gradient through promote_contract_1d on batch b
        at C channels, each against its plain version. Returns the two
        kernels' calls, their plain versions' and their inputs."""
        V, K = b.nbr.shape
        chi, nbr, rslot = b.chi_idx, b.nbr, b.rslot
        tiles = "(tile Vt={} Ct={}, {} B shared)".format(*ccn_fused._k12_tile(K, C))
        f1 = (randn(V, K, C) * b.row_mask[:, :, None]).contiguous()
        g1 = randn(V, K, 2 * C)
        k1 = lambda: ccn_fused.fused_contract_1d_forward(chi, nbr, f1)
        p1 = lambda: P.contract_1d(P.promote_1d(chi, nbr, f1))
        check("K1", f"{label} C={C} {tiles}", k1(), p1())
        k2 = lambda: ccn_fused.fused_contract_1d_backward(chi, rslot, nbr, g1)
        p2 = lambda: P.promote_1d_bwd(chi, rslot, nbr, P.contract_1d_transpose(g1))
        check("K2", f"{label} C={C}", k2(), p2())
        _grad_check(
            f"grad of promote_contract_1d {label} C={C}",
            _f_grad(lambda f: ccn_fused.promote_contract_1d(chi, nbr, f, rslot), f1, g1),
            _f_grad(lambda f: P.contract_1d(P.promote_1d(chi, nbr, f, rslot=rslot)), f1, g1))
        return k1, p1, k2, p2, f1, g1

    def check_k4(label, b, C, g2, compat):
        """K4 (g -> df) against promote_2d_bwd(contract_18_transpose(g))
        on batch b at C channels: it sums in the plain version's order, so
        the two should agree bit for bit. Returns K4's call, its plain
        version's and K4's output."""
        chi, nbr, rslot, m = b.chi_idx, b.nbr, b.rslot, b.row_mask
        k4 = lambda: ccn_fused.fused_contract_backward(chi, rslot, nbr, g2, b.deg, m,
                                                       compat=compat)
        p4 = lambda: P.promote_2d_bwd(chi, rslot, nbr, P.contract_18_transpose(
            g2, b.deg, m, compat=compat))
        out4, want = k4(), p4()
        tile = "(tile Vt={} Ct={}, {} B shared)".format(
            *ccn_fused._k4_tile(b.nbr.shape[1], C))
        check("K4", f"{label} C={C} compat={compat} {tile}, bit-equal "
              f"{bool(torch.equal(out4, want))}", out4, want)
        return k4, p4, out4

    prologue, grid_noop = {}, {}
    for label, b in (("serving bucket", cb), ("K=8 graphs", cb8)):
        V, K = b.nbr.shape
        label = f"{label} V={V} K={K}"
        m = b.row_mask
        chi, nbr, rslot = b.chi_idx, b.nbr, b.rslot
        va = (chi >= 0) & (rslot >= 0)[:, :, None]  # valid (u, j, p)
        n_valid_slots = int((rslot >= 0).sum())
        n_valid_1d = int(va.sum())
        n_valid_2d = int((va[:, :, :, None] & va[:, :, None, :]).sum())
        for C in (5, 2):
            f2 = (randn(V, K, K, C) * (m[:, :, None] * m[:, None, :])[..., None]).contiguous()
            g2 = randn(V, K, K, 18 * C)
            k1, p1, k2, p2, f1, g1 = check_1d(label, b, C)
            if b is cb:
                # the no-op on K1's and K2's grid: launch and block
                # scheduling without work
                vt, ct, _ = ccn_fused._k12_tile(K, C)
                blocks, threads = -(-V // vt) * -(-C // ct), vt * K * ct
                noop = _noop_launch(blocks, threads)
                grid_noop[C] = dict(ms=_time_ms(noop), ms_in_run=_time_run_ms(noop),
                                    blocks=blocks, threads=threads)
                n_ops = 2 * V * K * K * C
                bound, by = _bound(_nbytes(chi, nbr, f1, p1()), n_ops)
                timed[("K1", C)] = dict(ms=_time_ms(k1), ms_in_run=_time_run_ms(k1),
                                        plain_ms=_time_ms(p1), bound_ms=bound,
                                        bound_by=by)
                # two adds per valid (u, j, p) entry and channel
                bound, by = _bound(_nbytes(chi, rslot, nbr, g1, p2()),
                                   2 * n_valid_1d * C)
                timed[("K2", C)] = dict(ms=_time_ms(k2), ms_in_run=_time_run_ms(k2),
                                        plain_ms=_time_ms(p2), bound_ms=bound,
                                        bound_by=by)

            for compat in (False, True):
                k3 = lambda: ccn_fused.fused_contract_forward(
                    chi, nbr, f2, b.deg, m, compat=compat)
                p3 = lambda: P.contract_18(P.promote_2d(chi, nbr, f2),
                                           b.deg, m, compat=compat)
                out3 = k3()
                check("K3", f"{label} C={C} compat={compat}", out3, p3())
                k4, p4, out4 = check_k4(label, b, C, g2, compat)
                _grad_check(
                    f"grad of promote_contract_18 {label} C={C} compat={compat}",
                    _f_grad(lambda f: ccn_fused.promote_contract_18(
                        chi, nbr, f, b.deg, m, rslot, compat=compat), f2, g2),
                    _f_grad(lambda f: P.contract_18(P.promote_2d(
                        chi, nbr, f, rslot=rslot), b.deg, m, compat=compat), f2, g2))
                if b is cb and not compat:
                    # per (v, c): 2 adds for each of the K^3 promoted
                    # entries, ~22 K^2 for the reductions and 18 channels
                    n_ops = V * C * (2 * K ** 3 + 22 * K * K)
                    bound, by = _bound(_nbytes(chi, nbr, f2, b.deg, m, out3), n_ops)
                    timed[("K3", C)] = dict(
                        ms=_time_ms(k3), ms_in_run=_time_run_ms(k3),
                        plain_ms=_time_ms(p3), bound_ms=bound, bound_by=by)
                    # K4 reads g and the tables and writes df; per channel,
                    # each valid slot's 6 masked sums of K products (12 K
                    # operations), each valid (u, j, p)'s 2 more and its
                    # row terms (4 K + 12), each valid (u, j, p, q)'s
                    # entry and sum (6)
                    n_ops = C * (12 * K * n_valid_slots + (4 * K + 12) * n_valid_1d
                                 + 6 * n_valid_2d)
                    bound, by = _bound(_nbytes(g2, b.deg, m, chi, rslot, nbr, out4),
                                       n_ops)
                    timed[("K4", C)] = dict(ms=_time_ms(k4), ms_in_run=_time_run_ms(k4),
                                            plain_ms=_time_ms(p4), bound_ms=bound,
                                            bound_by=by)
                    # the plain version's prologue alone, the XLA step the
                    # TPU ran before its kernel
                    prologue[C] = _time_ms(lambda: P.contract_18_transpose_parts(
                        g2, b.deg, m))
    # K1..K4's tiles at their edges: a vertex count that is no multiple of
    # a tile (the exact vertex count of 100 molecules), and C = 256 on the
    # K = 8 batch, which splits the channels over blocks
    ragged = qm9.synthetic_qm9_like(100, seed=2)
    cbr = ccn.make_ccn_batch(ragged, k_max=5, task=0, device=dev,
                             vertex_capacity=sum(r.n_nodes for r in ragged))
    for label, b, C in ((f"ragged V={cbr.nbr.shape[0]} K=5", cbr, 5),
                        (f"ragged V={cbr.nbr.shape[0]} K=5", cbr, 2),
                        (f"K=8 graphs V={cb8.nbr.shape[0]} K=8 wide", cb8, 256)):
        check_1d(label, b, C)
    for label, b, C in ((f"ragged V={cbr.nbr.shape[0]} K=5", cbr, 5),
                        (f"ragged V={cbr.nbr.shape[0]} K=5", cbr, 2),
                        (f"K=8 graphs V={cb8.nbr.shape[0]} K=8 wide", cb8, 256)):
        V, K = b.nbr.shape
        vt, ct, smem = ccn_fused._k3_tile(K, C)
        f2 = (randn(V, K, K, C)
              * (b.row_mask[:, :, None] * b.row_mask[:, None, :])[..., None]).contiguous()
        g2 = randn(V, K, K, 18 * C)
        for compat in (False, True):
            check("K3", f"{label} C={C} compat={compat} (tile Vt={vt} Ct={ct}, "
                  f"{smem} B shared)",
                  ccn_fused.fused_contract_forward(b.chi_idx, b.nbr, f2, b.deg,
                                                   b.row_mask, compat=compat),
                  P.contract_18(P.promote_2d(b.chi_idx, b.nbr, f2), b.deg,
                                b.row_mask, compat=compat))
            check_k4(label, b, C, g2, compat)
            if C != 256:
                _grad_check(
                    f"grad of promote_contract_18 {label} C={C} compat={compat}",
                    _f_grad(lambda f: ccn_fused.promote_contract_18(
                        b.chi_idx, b.nbr, f, b.deg, b.row_mask, b.rslot,
                        compat=compat), f2, g2),
                    _f_grad(lambda f: P.contract_18(P.promote_2d(
                        b.chi_idx, b.nbr, f, rslot=b.rslot), b.deg, b.row_mask,
                        compat=compat), f2, g2))
    for (key, C), t in sorted(timed.items()):
        tile_of = {"K1": ccn_fused._k12_tile, "K2": ccn_fused._k12_tile,
                   "K3": ccn_fused._k3_tile, "K4": ccn_fused._k4_tile}.get(key)
        tile = (" (tile Vt={} Ct={}, {} B shared)".format(*tile_of(5, C))
                if tile_of else "")
        print(f"  {key} {rows[key]['name']} at V={V_SERVE} K=5 C={C}: "
              f"kernel {t['ms']:.4f} ms, {t['ms_in_run']:.4f} ms in a run of "
              f"{RUN_LAUNCHES}{tile}, plain {t['plain_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), library none")
    for C, t in sorted(grid_noop.items()):
        print(f"  no-op kernel on K1's and K2's grid at V={V_SERVE} K=5 C={C} "
              f"({t['blocks']} blocks of {t['threads']} threads, no work): "
              f"{t['ms']:.4f} ms, {t['ms_in_run']:.4f} ms in a run of {RUN_LAUNCHES}")
    for C, ms in sorted(prologue.items()):
        print(f"  K4's plain prologue contract_18_transpose_parts alone (PyTorch "
              f"ops) at V={V_SERVE} K=5 C={C}: {ms:.4f} ms; K4 does g -> df, "
              f"prologue included, in {timed[('K4', C)]['ms']:.4f} ms")
    for key, C in (("K1", 5), ("K2", 2), ("K3", 5), ("K4", 2)):
        rows[key].update(timed[(key, C)])
    rows.update(_bn_kernels(dev))
    rows.update(_power_kernels(dev))
    rows.update(_lg_kernels(dev))
    return rows


BN_SHAPES = [(1024, 16, 2), (1024, 32, 2)]  # the GNN cell's two node buckets


def _bn_launch(h: torch.Tensor) -> str:
    """The instantiation csrc/bn_fused.cu launches for h (..., F) (h's
    address standing for every row tensor's): VEC 2 where F is even and
    the rows are 8-byte aligned, else 1; cached where the rows fit the
    16 blocks' 16 register floats a thread and F / VEC one feature tile,
    else looped."""
    F = h.shape[-1]
    R = h.numel() // F
    vec = 2 if F % 2 == 0 and h.data_ptr() % 8 == 0 else 1
    lanes, slots = F // vec, 1
    while 2 * slots * lanes <= 256:
        slots *= 2
    cached = lanes <= 256 and -(-R // (16 * slots)) <= 16 // vec
    return f"16 blocks of 256 threads, VEC={vec}, {'cached' if cached else 'looped'}"


def _bn_kernels(dev) -> dict[str, dict]:
    """MaskedBatchNorm's two kernels (ops/bn_fused.py) against the plain
    composition at the GNN cell's shapes, 1,024 molecules of 16 and 32
    node slots, F = 2, about 60 % of the slots real: the output, the
    statistics and the gradients, then each kernel's time beside its byte
    bound and the composition's (forward: its ops; backward: autograd's
    through them). Returns the two rows of the kernels line, at the larger
    shape."""
    from hgnn2_torch.ops import bn_fused

    gen = torch.Generator(dev).manual_seed(0)
    src = "hgnn2_torch/ops/csrc/bn_fused.cu"
    rows = {
        "BN forward": dict(name="bn_forward", route="cuda", source=src,
                           replaces="none (XLA fuses the batch norm)",
                           max_abs_err=0.0, library_ms=None),
        "BN backward": dict(name="bn_backward", route="cuda", source=src,
                            replaces="none (XLA fuses the batch norm)",
                            max_abs_err=0.0, library_ms=None),
    }
    for shape in BN_SHAPES:
        F = shape[-1]
        h = torch.randn(shape, device=dev, generator=gen) * 1.5 + 0.3
        m = (torch.rand(shape[:-1], device=dev, generator=gen) < 0.6).float()
        g = torch.randn(shape, device=dev, generator=gen)
        scale = torch.randn(F, device=dev, generator=gen)
        bias = torch.randn(F, device=dev, generator=gen)
        rm, rs = torch.zeros(F, device=dev), torch.ones(F, device=dev)
        launch = _bn_launch(h)
        hp, sp, bp = (t.clone().requires_grad_() for t in (h, scale, bias))
        plain, _ = bn_fused.composed(hp, m, sp, bp, rm.clone(), rs.clone(),
                                     0.1, 1e-5, True)
        want = torch.autograd.grad(plain, (hp, sp, bp), g, retain_graph=True)
        hk, sk, bk = (t.clone().requires_grad_() for t in (h, scale, bias))
        out = bn_fused.masked_batch_norm(hk, m, sk, bk, rm.clone(), rs.clone(),
                                         0.1, 1e-5, True)
        got = torch.autograd.grad(out, (hk, sk, bk), g)
        torch.cuda.synchronize()
        label = f"R={shape[0] * shape[1]} F={F}"
        rows["BN forward"]["max_abs_err"] = max(
            rows["BN forward"]["max_abs_err"],
            _compare(f"BN forward {label} ({launch})", out.detach(), plain.detach()))
        for name, a, b in zip(("g_h", "g_scale", "g_bias"), got, want):
            _grad_check(f"BN backward {name} {label} ({launch})", a, b)
            rows["BN backward"]["max_abs_err"] = max(
                rows["BN backward"]["max_abs_err"], float((a - b).abs().max()))
        _, stats = bn_fused.bn_forward(h, m, scale, bias, rm.clone(), rs.clone(),
                                       0.1, 1e-5, True)
        kf = lambda: bn_fused.bn_forward(h, m, scale, bias, rm, rs, 0.1, 1e-5, True)
        kb = lambda: bn_fused.bn_backward(g, h, m, scale, stats, True)
        pf = lambda: bn_fused.composed(h, m, scale, bias, rm, rs, 0.1, 1e-5, True)
        pb = lambda: torch.autograd.grad(plain, (hp, sp, bp), g, retain_graph=True)
        # each input read once, each output written once
        fwd_bytes = _nbytes(h, m, scale, bias, rm, rs, h, stats, rm, rs)
        bwd_bytes = _nbytes(g, h, m, scale, stats, h, scale, bias)
        # the composition's 26 and 27 launches, autograd's from its engine
        # thread, enqueue behind a longer spin than one kernel's
        rows["BN forward"].update(
            ms=_time_ms(kf), ms_in_run=_time_run_ms(kf),
            plain_ms=_time_ms(pf, busy=10 * BUSY_CYCLES),
            bound_ms=_bound(fwd_bytes, 0)[0], bound_by="bytes")
        rows["BN backward"].update(
            ms=_time_ms(kb), ms_in_run=_time_run_ms(kb),
            plain_ms=_time_ms(pb, busy=10 * BUSY_CYCLES),
            bound_ms=_bound(bwd_bytes, 0)[0], bound_by="bytes")
        for key in ("BN forward", "BN backward"):
            r = rows[key]
            print(f"  {key} {r['name']} at {shape} ({label}): kernel "
                  f"{r['ms']:.4f} ms, {r['ms_in_run']:.4f} ms in a run of "
                  f"{RUN_LAUNCHES}, plain composition {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.5f} ms (bytes), library none")
    return rows


# the GNN cell's power layers: 1,024 molecules at node buckets 16 and 32,
# layer 0's input width 5 (fan-in 15) and the others' 2 (fan-in 6), h 1
POWER_SHAPES = [(1024, 16, 5), (1024, 16, 2), (1024, 32, 5), (1024, 32, 2)]


def _power_kernels(dev) -> dict[str, dict]:
    """PowerLayer's two kernels (ops/power_layer.py) against the plain
    composition at the GNN cell's shapes (POWER_SHAPES; QM9-shaped graphs
    of the synthetic pool, J = 1, h = 1): the output, z, the statistics
    and every gradient, then each kernel's time beside its byte bound and
    the composition's (forward: its ops; backward: autograd's through
    them). Returns the two rows of the kernels line, at the last shape."""
    from hgnn2_torch.data import batching, qm9
    from hgnn2_torch.ops import dense, power_layer

    gen = torch.Generator(dev).manual_seed(0)
    src = "hgnn2_torch/ops/csrc/power_layer.cu"
    replaces = "none (XLA fuses the layer)"
    rows = {
        "Power forward": dict(name="power_forward", route="cuda", source=src,
                              replaces=replaces, max_abs_err=0.0,
                              library_ms=None),
        "Power backward": dict(name="power_backward", route="cuda", source=src,
                               replaces=replaces, max_abs_err=0.0,
                               library_ms=None),
    }
    recs = sorted(qm9.synthetic_qm9_like(4096, seed=0), key=lambda r: r.n_nodes)
    for B, N, fi in POWER_SHAPES:
        chunk = recs[:B] if N == 16 else recs[-B:]
        batch = next(iter(batching.DenseLoader(chunk, B, task=0, device=dev)))
        if batch.x.shape[1] != N:
            raise AssertionError(f"the {N}-slot batch came out at {batch.x.shape[1]}")
        A, deg = dense.adjacency_powers(batch.adj, 1), dense.degrees(batch.adj)
        m = batch.node_mask
        x = torch.randn(B, N, fi, device=dev, generator=gen)
        w1, w2 = (0.3 * torch.randn(1, 3 * fi, device=dev, generator=gen)
                  for _ in range(2))
        b1, b2, scale, bias = (0.1 * torch.randn(n, device=dev, generator=gen)
                               for n in (1, 1, 2, 2))
        rm, rs = torch.zeros(2, device=dev), torch.ones(2, device=dev)
        g = torch.randn(B, N, 2, device=dev, generator=gen)
        leaves = (x, w1, b1, w2, b2, scale, bias)
        label = f"B={B} N={N} fan-in {3 * fi}"

        def args(lv):
            x_, w1_, b1_, w2_, b2_, s_, bi_ = lv
            return (x_, A, deg, m, m, w1_, b1_, w2_, b2_, s_, bi_, rm.clone(),
                    rs.clone(), 0.1, 1e-5, True)

        lp = [t.clone().requires_grad_() for t in leaves]
        plain, z_plain, _ = power_layer.composed(*args(lp))
        want = torch.autograd.grad(plain, lp, g, retain_graph=True)
        lk = [t.clone().requires_grad_() for t in leaves]
        out = power_layer.power_layer(*args(lk))
        got = torch.autograd.grad(out, lk, g)
        torch.cuda.synchronize()
        rows["Power forward"]["max_abs_err"] = max(
            rows["Power forward"]["max_abs_err"],
            _compare(f"Power forward {label}", out.detach(), plain.detach()))
        _, z, stats = power_layer.power_forward(*args(leaves))
        _compare(f"Power forward z {label}", z, z_plain.detach())
        for name, a, b in zip(("dx", "g_w1", "g_b1", "g_w2", "g_b2", "g_scale",
                               "g_bias"), got, want):
            _grad_check(f"Power backward {name} {label}", a, b)
            rows["Power backward"]["max_abs_err"] = max(
                rows["Power backward"]["max_abs_err"], float((a - b).abs().max()))
        fa = args(leaves)
        kf = lambda: power_layer.power_forward(*fa)
        kb = lambda: power_layer.power_backward(g, x, A, deg, m, m, w1, w2, scale,
                                                z, stats, True)
        pf = lambda: power_layer.composed(*fa)
        pb = lambda: torch.autograd.grad(plain, lp, g, retain_graph=True)
        # each input read once, each output written once
        fwd_bytes = _nbytes(x, A, deg, m, m, w1, b1, w2, b2, scale, bias, rm,
                            rs, z, z, stats, rm, rs)
        bwd_bytes = _nbytes(g, x, A, deg, m, m, w1, w2, scale, z, stats, x, w1,
                            b1, w2, b2, scale, bias)
        # the composition's ~20 launches each way, autograd's from its
        # engine thread, enqueue behind a longer spin than one kernel's
        rows["Power forward"].update(
            ms=_time_ms(kf), ms_in_run=_time_run_ms(kf),
            plain_ms=_time_ms(pf, busy=10 * BUSY_CYCLES),
            bound_ms=_bound(fwd_bytes, 0)[0], bound_by="bytes")
        rows["Power backward"].update(
            ms=_time_ms(kb), ms_in_run=_time_run_ms(kb),
            plain_ms=_time_ms(pb, busy=10 * BUSY_CYCLES),
            bound_ms=_bound(bwd_bytes, 0)[0], bound_by="bytes")
        for key in ("Power forward", "Power backward"):
            r = rows[key]
            print(f"  {key} {r['name']} at {label}: kernel {r['ms']:.4f} ms, "
                  f"{r['ms_in_run']:.4f} ms in a run of {RUN_LAUNCHES}, plain "
                  f"composition {r['plain_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.5f} ms (bytes), library none")
    return rows


# the line-graph cell's two shape groups (node/edge buckets), 2,048 molecules
LG_SHAPES = [(16, 32), (32, 64)]
LG_BATCH = 2048


def _lg_kernels(dev) -> dict[str, dict]:
    """The line-graph exchange's six kernels (ops/lg_exchange.py) at the
    line-graph cell's shapes, 2,048 molecules at node/edge buckets 16/32
    and 32/64, F = 2: each against its plain version on the CPU (bit for
    bit) and against the one-hot composition of ops/dense.py on the card
    (forward: its products; backward: autograd through them), then each
    kernel's time beside its byte bound (indices and features once) and
    the composition's. Returns the six rows of the kernels line, at the
    larger shape, each with both shapes under ``shapes``."""
    from hgnn2_torch import graphs
    from hgnn2_torch.data import qm9
    from hgnn2_torch.ops import dense as D
    from hgnn2_torch.ops import lg_exchange as X

    src_file = "hgnn2_torch/ops/csrc/lg_exchange.cu"
    kernels = {"LG Pm|Pd": "lg_to_nodes<pair>", "LG Pm|Pd backward": "lg_to_edges<sum>",
               "LG Pm^T|Pd^T": "lg_to_edges<pair>",
               "LG Pm^T|Pd^T backward": "lg_to_nodes<sum>",
               "LG NB": "lg_nb_forward (full)", "LG NB backward": "lg_nb_backward (full)"}
    rows = {k: dict(name=v, route="cuda", source=src_file,
                    replaces="none (XLA fuses the one-hot einsums)",
                    max_abs_err=0.0, library_ms=None, shapes={})
            for k, v in kernels.items()}
    mols = qm9.synthetic_qm9_like(8 * LG_BATCH, seed=3)
    gen = torch.Generator().manual_seed(0)
    F = 2
    for N, M in LG_SHAPES:
        recs = [r for r in mols if r.n_nodes <= N and r.n_dir_edges <= M][:LG_BATCH]
        db = graphs.make_dense_batch(recs, n_max=N, m_max=M, with_line_graph=True,
                                     task=0, device=dev)
        src, dst, rev, em, w = db.lg_src, db.lg_dst, db.lg_rev, db.edge_mask, db.lg_w
        cpu = [t.cpu() for t in (src, dst, rev, em, w)]
        s_src, s_dst = D.edge_scatter_matrices(src, dst, em, N)
        rl = rev.long()
        dl = X.nb_degrees(src, dst, rev, em, w, N)
        dl_cpu = X.nb_degrees(*cpu, N)
        B = src.shape[0]
        xl = torch.randn(B, M, F, generator=gen).to(dev)
        x = torch.randn(B, N, F, generator=gen).to(dev)
        composed = {
            "LG Pm|Pd": (xl, lambda t: torch.cat([D.incidence_apply(s_src, s_dst, t, False),
                                                  D.incidence_apply(s_src, s_dst, t, True)], -1)),
            "LG Pm^T|Pd^T": (x, lambda t: torch.cat(
                [D.incidence_t_apply(s_src, s_dst, t, False),
                 D.incidence_t_apply(s_src, s_dst, t, True)], -1)),
            "LG NB": (xl, lambda t: D.lg_graph_op(s_src, s_dst, w, rl, dl, t, 1, em)),
        }
        index = {
            "LG Pm|Pd": (lambda t: X.pm_pd_forward(src, dst, em, t, N),
                         lambda g: X.pm_pd_backward(src, dst, em, g),
                         lambda c, t: X.pm_pd_forward(*c[:2], c[3], t, N),
                         lambda c, g: X.pm_pd_backward(*c[:2], c[3], g)),
            "LG Pm^T|Pd^T": (lambda t: X.pm_pd_t_forward(src, dst, em, t),
                             lambda g: X.pm_pd_t_backward(src, dst, em, g, N),
                             lambda c, t: X.pm_pd_t_forward(*c[:2], c[3], t),
                             lambda c, g: X.pm_pd_t_backward(*c[:2], c[3], g, N)),
            "LG NB": (lambda t: X.nb_forward(src, dst, rev, em, w, t, N, dl),
                      lambda g: X.nb_backward(src, dst, rev, em, w, g, N, dl),
                      lambda c, t: X.nb_forward(*c, t, N, dl_cpu),
                      lambda c, g: X.nb_backward(*c, g, N, dl_cpu)),
        }
        label = f"B={B} N={N} M={M} F={F}"
        for key, (inp, comp) in composed.items():
            fwd, bwd, fwd_cpu, bwd_cpu = index[key]
            t = inp.clone().requires_grad_()
            plain = comp(t)
            g = torch.randn(plain.shape, generator=gen).to(dev)
            (plain_g,) = torch.autograd.grad(plain, t, g, retain_graph=True)
            out, grad = fwd(inp), bwd(g)
            torch.cuda.synchronize()
            bit = (torch.equal(out.cpu(), fwd_cpu(cpu, inp.cpu()))
                   and torch.equal(grad.cpu(), bwd_cpu(cpu, g.cpu())))
            print(f"  {key} and its backward at {label}: bit-equal to the plain "
                  f"versions on the CPU {bit}")
            if not bit:
                raise AssertionError(f"{key}: the kernels differ from their plain versions")
            bkey = f"{key} backward"
            rows[key]["max_abs_err"] = max(rows[key]["max_abs_err"], _compare(
                f"{key} {label} vs the composition", out, plain.detach()))
            _grad_check(f"{bkey} {label} vs autograd through the composition",
                        grad, plain_g)
            rows[bkey]["max_abs_err"] = max(rows[bkey]["max_abs_err"],
                                            float((grad - plain_g).abs().max()))
            idx = (src, dst, em) if key != "LG NB" else (src, dst, rev, em, w, dl)
            for k, fn, pf, nbytes in (
                    (key, lambda: fwd(inp), lambda: comp(inp),
                     _nbytes(*idx, inp, out)),
                    (bkey, lambda: bwd(g),
                     lambda: torch.autograd.grad(plain, t, g, retain_graph=True),
                     _nbytes(*idx, g, grad))):
                shape = dict(ms=_time_ms(fn), ms_in_run=_time_run_ms(fn),
                             plain_ms=_time_ms(pf, busy=10 * BUSY_CYCLES),
                             bound_ms=_bound(nbytes, 0)[0], bound_by="bytes")
                rows[k]["shapes"][f"{N}/{M}"] = shape
                rows[k].update(shape)
                print(f"  {k} {rows[k]['name']} at {label}: kernel "
                      f"{shape['ms']:.4f} ms, {shape['ms_in_run']:.4f} ms in a run "
                      f"of {RUN_LAUNCHES}, composition {shape['plain_ms']:.4f} ms, "
                      f"bound {shape['bound_ms']:.5f} ms (bytes), library none")
    return rows


def phase_ring(dev, V: int) -> dict:
    """K5 against its plain twin (equal bit for bit: the same adds in the
    same order, one launch against the twin's S - 1 hops) at the packed path's node blocks (V, F), F = 1 (degree),
    5 (input features) and 16 (the LGGNN's 2h), for S = 2, 4, 8; at
    S = 4 with 2^20 x 16 floats a rank; and on an odd-sized unaligned
    view (the scalar path). Times it at S = 4. Returns K5's row, timed
    at F = 16, the width of most of the path's all-reduces."""
    from hgnn2_torch.ops import ring

    rng = np.random.default_rng(5)
    parts_of = lambda S, shape: [torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)).to(dev) for _ in range(S)]
    row = dict(name="ring_psum", route="cuda",
               source="hgnn2_torch/ops/csrc/ring.cu",
               replaces="hgnn2_tpu/ops/pallas/ring.py:27", max_abs_err=0.0,
               library_ms=None)
    x = parts_of(2, (V, 16))
    _expect_refusal("ring_psum", lambda: ring.ring_psum(
        [x[0].requires_grad_(), x[1]]), msg="no gradient")

    def exact(label, parts):
        got = ring.ring_psum(parts)
        want = ring.ring_psum_reference(parts)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ok = err == 0.0 and all(bool(torch.isfinite(g).all()) for g in got)
        print(f"  K5 {label}: max_abs_err={err:.3e} over {len(parts)} ranks "
              f"(tolerance 0: same adds, same order) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K5 {label}: kernel disagrees with its twin")
        row["max_abs_err"] = max(row["max_abs_err"], err)

    for S in (2, 4, 8):
        for F in (1, 5, 16):
            exact(f"S={S} V={V} F={F}", parts_of(S, (V, F)))
    exact("S=4 n=2^20 x 16", parts_of(4, (2 ** 20, 16)))
    exact("S=3 odd unaligned view (scalar path)",
          [p[1:] for p in parts_of(3, (3004,))])
    exact("S=5 (1001, 3)", parts_of(5, (1001, 3)))

    S = 4
    for label, shape in ((f"V={V} F=1", (V, 1)), (f"V={V} F=5", (V, 5)),
                         (f"V={V} F=16", (V, 16)), ("n=2^20 x 16", (2 ** 20, 16))):
        parts = parts_of(S, shape)
        n = parts[0].numel()
        bound, by = _bound(2 * S * n * 4, S * (S - 1) * n)
        t = dict(ms=_time_ms(lambda: ring.ring_psum(parts)),
                 ms_in_run=_time_run_ms(lambda: ring.ring_psum(parts)),
                 plain_ms=_time_ms(lambda: ring.ring_psum_reference(parts)),
                 library_ms=_time_ms(lambda: torch.stack(parts).sum(0)),
                 bound_ms=bound, bound_by=by)
        print(f"  K5 ring_psum S={S} {label}: kernel {t['ms']:.4f} ms, "
              f"{t['ms_in_run']:.4f} ms in a run of {RUN_LAUNCHES} "
              f"(1 launch, {2 * S * n * 4} bytes: 2*S*n*4, each input read "
              f"once, each output written once), plain twin "
              f"{t['plain_ms']:.4f} ms, bound {bound:.5f} ms ({by}), library "
              f"torch.stack(parts).sum(0) {t['library_ms']:.4f} ms (computes "
              f"one replica, not S)")
        if label.endswith("F=16"):
            row.update(t)
    return row


def _flax_params(n_features: int, hidden: int, n_layers: int,
                 n_channels: int, seed: int) -> dict:
    """Random weights in the JAX models' flax layout: kernel (in, out)."""
    rng = np.random.default_rng(seed)
    dense = lambda i, o: {"kernel": rng.normal(0, 0.1, (i, o)).astype(np.float32),
                          "bias": rng.normal(0, 0.1, (o,)).astype(np.float32)}
    params, width = {}, n_features
    for i in range(n_layers):
        params[f"w{i + 1}"] = dense(n_channels * width, hidden)
        width = hidden
    params["fc"] = dense(n_features + n_layers * hidden, 1)
    return {"params": params}


def _breakdown(sm, chunk) -> None:
    """Where one full serving chunk's time goes: the host's batch build
    and host-to-device copy, then the forward, by the host clock (what
    a request waits for, launch overhead included) and as device time."""
    from hgnn2_torch.nn import ccn

    slots, cap = sm.buckets[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = ccn.make_ccn_batch(chunk, k_max=sm.k_max, vertex_capacity=cap,
                               task=0, batch_size=slots, device=sm.device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    with torch.inference_mode():
        sm.model(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sm.model(batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = _time_ms(lambda: sm.model(batch), reps=10, warmup=2,
                          busy=10 * BUSY_CYCLES)
    print(f"  breakdown of one {len(chunk)}-molecule chunk: batch build + "
          f"copy {build_s * 1e3:.2f} ms (host clock), forward "
          f"{host_ms:.3f} ms (host clock) of which {dev_ms:.3f} ms device "
          f"time (CUDA events)")


K_KEYS = ("K1", "K2", "K3", "K4", "K5")
BN_KEYS = ("BN forward", "BN backward")
POWER_KEYS = ("Power forward", "Power backward")
# the line-graph exchange's kernels (ops/lg_exchange.py), by wrapper
LG_WRAPPERS = {"LG Pm|Pd": "pm_pd_forward", "LG Pm|Pd backward": "pm_pd_backward",
               "LG Pm^T|Pd^T": "pm_pd_t_forward",
               "LG Pm^T|Pd^T backward": "pm_pd_t_backward",
               "LG NB": "nb_forward", "LG NB backward": "nb_backward"}
LG_KEYS = tuple(LG_WRAPPERS)
# each DenseBundle exchange method's forward and backward kernel
_LG_APPLIES = {"pm_pd": ("LG Pm|Pd", "LG Pm|Pd backward"),
               "pm_pd_t": ("LG Pm^T|Pd^T", "LG Pm^T|Pd^T backward"),
               "lg_graph_op": ("LG NB", "LG NB backward")}
# the MaskedBatchNorm and PowerLayer calls and the exchange's applies since
# _zero that must launch each BN, power-layer and exchange kernel, counted
# by hooks that are on from _zero to _read
_calls = dict.fromkeys(BN_KEYS + POWER_KEYS + LG_KEYS, 0)
_hooks = []


def _module_seen(module, args) -> None:
    """Counts a MaskedBatchNorm call that takes the kernels
    (bn_fused.use_kernel on its compute dtype): one bn_forward, and one
    bn_backward at its backward where it runs with grad on; and likewise a
    PowerLayer call that takes its kernels (PowerLayer.takes_kernel): one
    power_forward, and one power_backward where it runs with grad on. A
    replayed graph launches them with no Python call, and neither side
    counts it."""
    from hgnn2_torch.nn import layers
    from hgnn2_torch.ops import bn_fused

    if isinstance(module, layers.PowerLayer):
        x = args[1]
        if module.takes_kernel(args[0], x):
            _calls["Power forward"] += 1
            _calls["Power backward"] += torch.is_grad_enabled() and (
                x.requires_grad or module.cv1.weight.requires_grad)
        return
    if not isinstance(module, layers.MaskedBatchNorm):
        return
    h = args[0]
    if bn_fused.use_kernel(h.device, layers._at_least_f32(h.dtype),
                           module.training, module.axis_name):
        _calls["BN forward"] += 1
        _calls["BN backward"] += torch.is_grad_enabled() and (
            h.requires_grad or module.scale.requires_grad)


def _on_kernel(bundle) -> bool:
    """Whether the bundle's exchange launches the kernels
    (lg_exchange.use_kernel on its compute dtype)."""
    from hgnn2_torch.ops import lg_exchange

    return lg_exchange.use_kernel(bundle.w.device, bundle.w.dtype)


def _lg_seen(name, apply):
    """DenseBundle's exchange method ``name``, counting an apply on a
    bundle whose exchange takes the kernels: one forward kernel
    (lg_graph_op: one NB apply for each of AL, AL^2, AL^4 ..., 2^(J-1) in
    all), and as many backward kernels where it runs with grad on an
    input that requires grad."""
    def counted(bundle, t):
        if _on_kernel(bundle):
            fwd, bwd = _LG_APPLIES[name]
            n = 2 ** (bundle.J - 1) if name == "lg_graph_op" else 1
            _calls[fwd] += n
            _calls[bwd] += n * (torch.is_grad_enabled() and t.requires_grad)
        return apply(bundle, t)
    return counted


def _install_hooks() -> None:
    """The module hook of the batch norms and power layers, and
    DenseBundle's from_batch
    (the NB degrees of a bundle on the kernels: one NB apply) and exchange
    methods wrapped to count; each undone by _read."""
    from hgnn2_torch.nn.bundles import DenseBundle

    _hooks.append(
        torch.nn.modules.module.register_module_forward_pre_hook(
            _module_seen).remove)
    build = DenseBundle.__dict__["from_batch"]

    def from_batch(cls, *a, **k):
        b = build.__func__(cls, *a, **k)
        _calls["LG NB"] += b.has_line_graph and _on_kernel(b)
        return b

    patched = {"from_batch": classmethod(from_batch),
               **{n: _lg_seen(n, getattr(DenseBundle, n)) for n in _LG_APPLIES}}
    saved = {n: DenseBundle.__dict__[n] for n in patched}
    for n, fn in patched.items():
        setattr(DenseBundle, n, fn)
    _hooks.append(lambda: [setattr(DenseBundle, n, fn) for n, fn in saved.items()])


def _counters() -> dict:
    """The kernel wrappers whose ``launches`` the phases count: K1-K5,
    MaskedBatchNorm's two kernels, PowerLayer's two and the line-graph
    exchange's six."""
    from hgnn2_torch.ops import (bn_fused, ccn_fused, lg_exchange, power_layer,
                                 ring)

    return {"K1": ccn_fused.fused_contract_1d_forward,
            "K2": ccn_fused.fused_contract_1d_backward,
            "K3": ccn_fused.fused_contract_forward,
            "K4": ccn_fused.fused_contract_backward,
            "K5": ring.ring_psum,
            "BN forward": bn_fused.bn_forward,
            "BN backward": bn_fused.bn_backward,
            "Power forward": power_layer.power_forward,
            "Power backward": power_layer.power_backward,
            **{k: getattr(lg_exchange, w) for k, w in LG_WRAPPERS.items()}}


def _zero(counters) -> None:
    """Sets every launch count to 0, and starts counting the BN and power
    layer calls and the exchange's applies."""
    for c in counters.values():
        c.launches = 0
    _calls.update(dict.fromkeys(_calls, 0))
    if not _hooks:
        _install_hooks()


def _read(counters) -> dict[str, int]:
    """Every kernel's launches since _zero. Raises unless each BN, power
    layer and exchange kernel launched once for each call or apply that
    must launch it."""
    got = {k: c.launches for k, c in counters.items()}
    while _hooks:
        _hooks.pop()()
    if any(got[k] != _calls[k] for k in _calls):
        raise AssertionError(f"BN, power-layer and exchange kernel launches "
                             f"{got} against the MaskedBatchNorm and PowerLayer "
                             f"calls and exchange applies that take them "
                             f"{_calls}")
    return got


def _want(counters) -> dict[str, int]:
    """The launches of a path that runs none of K1-K5: each BN, power
    layer and exchange kernel's count is that of the calls that take it
    (as _read checks)."""
    return {k: _calls.get(k, 0) for k in counters}


def _ks(got: dict) -> dict[str, int]:
    """The K1-K5 part of a launch count."""
    return {k: got[k] for k in K_KEYS}


def phase_serving(dev, card: str) -> dict[str, int]:
    """Serve both CCN models through bundles on the card and on the CPU.
    Returns each kernel's launches summed over the two models' runs."""
    from hgnn2_torch import convert, serving
    from hgnn2_torch.data import qm9
    from hgnn2_torch.nn import ccn

    requests = qm9.synthetic_qm9_like(N_REQUESTS, seed=1)
    ys = np.array([r.y[0] for r in requests])
    sizes = np.array([[r.n_nodes] for r in requests])
    n_chunks = len(list(serving._greedy_spans(
        sizes, (SERVE_BUCKETS[0][1],), SERVE_BUCKETS[0][0])))
    counters = _counters()
    launches = dict.fromkeys(counters, 0)
    for name, cls, n_layers, key, seed in (
            ("CCN2D", ccn.CCN2D, 2, "K3", 1), ("CCN1D", ccn.CCN1D, 20, "K1", 2)):
        model = cls(n_features=5, hidden=2, n_layers=n_layers)
        model.load_state_dict(convert.ccn_params_from_flax(
            _flax_params(5, 2, n_layers, model.n_channels, seed)))
        path = os.path.join(OUT_DIR, name.lower())
        serving.save_bundle(path, model, SERVE_BUCKETS, k_max=5, task=0,
                            mean=float(ys.mean()), std=float(ys.std()))
        sm = serving.load_bundle(path, device=dev)
        if not sm.model.kernel:
            raise AssertionError(f"{name}: the bundle did not enable the kernels")
        sm.predict(requests[:8])  # first CUDA calls: library loads, cuBLAS

        _zero(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds = sm.predict(requests)  # the main path
        secs = time.perf_counter() - t0
        got = _read(counters)
        for k, n in got.items():
            launches[k] += n

        want = _want(counters)
        want[key] = n_layers * n_chunks
        print(f"  {name} L={n_layers} h=2: {N_REQUESTS} requests in {n_chunks} "
              f"chunks, {secs:.4f} s, {N_REQUESTS / secs:.1f} molecules/s on "
              f"{card}; launches {got} (expected {want})")
        if got != want:
            raise AssertionError(f"{name}: kernel launches {got} != {want}")
        if preds.shape != (N_REQUESTS,) or not np.isfinite(preds).all():
            raise AssertionError(f"{name}: predictions not finite or misshapen")
        _breakdown(sm, requests[:SERVE_BUCKETS[0][0]])
        ref = serving.load_bundle(path, device="cpu").predict(requests)
        scale = float(np.abs(ref).max())
        err = float(np.abs(preds - ref).max())
        print(f"  {name} card vs CPU plain path: max_abs_err={err:.3e}, "
              f"max |pred|={scale:.3e}, tolerance {SERVE_RTOL} x max |pred|")
        if err > SERVE_RTOL * scale:
            raise AssertionError(f"{name}: card and CPU predictions disagree")
    return launches


_SYNTHETIC: dict = {}


def _synthetic(n: int) -> list:
    """qm9.synthetic_qm9_like(n, seed=0), the molecules run_experiment
    draws for n, made once a run (each record memoizes its line graph)."""
    from hgnn2_torch.data import qm9

    if n not in _SYNTHETIC:
        _SYNTHETIC[n] = qm9.synthetic_qm9_like(n, seed=0)
    return _SYNTHETIC[n]


def _train_cfg(arch: str, n_layers: int, device: str, log_path: str):
    """The training phase's configuration: h = 2, 1,024 molecules a step,
    Adamax at lr 1e-3, on the synthetic QM9-shaped molecules."""
    from hgnn2_torch.training.config import TrainConfig

    cfg = TrainConfig(batch_size=TRAIN_BS, epochs=TRAIN_EPOCHS, seed=0,
                      device=device, log_path=log_path)
    cfg.optim.optim, cfg.optim.lr = "adamax", 1e-3
    cfg.model.arch, cfg.model.n_features, cfg.model.n_layers = arch, 2, n_layers
    cfg.data.dataset, cfg.data.n_synthetic = "qm9_synthetic", N_TRAIN_MOLS
    return cfg


def _train_setup(cfg, params, device, records):
    """The model (for CCN: kernels on where use_kernel says so) from the
    flax params, the optimizer, the train batches in deal order, mean and
    std: the pieces of run_experiment's first epoch, on ``device``, with
    the loader, the model constructor and the converter of cfg's arch and
    layout."""
    from hgnn2_torch import convert
    from hgnn2_torch.cli import common
    from hgnn2_torch.data import batching, stats, synthetic
    from hgnn2_torch.ops import ccn_fused
    from hgnn2_torch.training import optim

    ts = stats.compute_target_stats(records)
    train_recs = synthetic.split_80_10_10(records, seed=cfg.seed)[0]
    build = common.build_model
    if cfg.model.arch in ("gnn", "lggnn") and cfg.model.packed:
        loader = batching.PackedLoader(train_recs, cfg.batch_size, task=0,
                                       device=device)
        state = convert.packed_variables_from_flax(params)
        build = common.build_packed_model
    elif cfg.model.arch in ("gnn", "lggnn"):
        loader = batching.DenseLoader(
            train_recs, cfg.batch_size, task=0,
            with_line_graph=cfg.model.arch == "lggnn", device=device)
        state = convert.dense_variables_from_flax(params)
    else:
        loader = batching.CCNLoader(train_recs, cfg.batch_size, task=0,
                                    device=device)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, ccn_kernel=ccn_fused.use_kernel(loader.k_max, device)))
        state = convert.ccn_params_from_flax(params)
    model = build(cfg, "regression", records[0].x.shape[1])
    model.load_state_dict(state)
    model.to(device)
    opt, sched = optim.build_optimizer(cfg.optim, len(loader), model.parameters())
    return model, opt, sched, list(loader), float(ts.mean[0]), float(ts.std[0])


def _first_steps(cfg, params, device, records):
    """CPU_STEPS train steps over the first train batches on ``device``:
    each step's loss, the step-0 gradient of every parameter and the
    buffers (BN running stats) after step 0."""
    from hgnn2_torch.training import train

    model, opt, sched, batches, mean, std = _train_setup(cfg, params, device,
                                                         records)
    losses, grads, stats = [], None, None
    for batch in batches[:CPU_STEPS]:
        mets = train.train_step(model, opt, sched, batch, mean=mean, std=std)
        losses.append(float(mets["loss"]))
        if grads is None:
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in model.named_parameters()}
            stats = {n: b.detach().cpu().clone()
                     for n, b in model.named_buffers()}
    return losses, grads, stats


def _compare_steps(name: str, cfg, params, records, dev="cuda",
                   grad_floor: float = 0.0) -> None:
    """The first CPU_STEPS steps on the card (``dev``) against the CPU:
    losses, step-0 gradients and the BN running stats after step 0. Each
    gradient tensor is held against its own largest |gradient|, or
    grad_floor x the model's largest where that is more."""
    cpu_cfg = dataclasses.replace(cfg, device="cpu")
    _hold_steps(name, _first_steps(cfg, params, dev, records),
                _first_steps(cpu_cfg, params, "cpu", records), grad_floor)


def _hold_steps(name: str, card, cpu, grad_floor: float = 0.0,
                what: str = "card", against: str = "CPU") -> None:
    """Two runs' first steps, (losses, step-0 gradients, BN stats after
    step 0) each, held as _compare_steps says."""
    card_losses, card_grads, card_stats = card
    cpu_losses, cpu_grads, cpu_stats = cpu
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    top = max(float(g.abs().max()) for g in cpu_grads.values())
    scale = {k: max(float(g.abs().max()), grad_floor * top) or 1e-30
             for k, g in cpu_grads.items()}
    floor = [k for k in scale if scale[k] == grad_floor * top]
    grad_err = max(float((card_grads[k] - g).abs().max()) / scale[k]
                   for k, g in cpu_grads.items())
    stat_err = max((_rel_err(card_stats[k], v) for k, v in cpu_stats.items()),
                   default=0.0)
    floor_note = (f"; {len(floor)} tensors below {grad_floor} x the model's "
                  f"max |grad| {top:.3e} held against that" if grad_floor else "")
    stats_note = (f"; BN running stats after step 0 max err / max |stat| "
                  f"{stat_err:.3e} over {len(cpu_stats)} tensors (tolerance "
                  f"{BN_STATS_RTOL})" if cpu_stats else "")
    print(f"  {name} first {len(card_losses)} steps, {what} {card_losses} vs "
          f"{against} {cpu_losses}: max rel loss err {loss_err:.3e} (tolerance "
          f"{TRAIN_LOSS_RTOL}); step-0 gradients max err / max |grad| "
          f"{grad_err:.3e} over {len(cpu_grads)} tensors (tolerance "
          f"{TRAIN_GRAD_RTOL}{floor_note}){stats_note}")
    if (loss_err > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_RTOL
            or stat_err > BN_STATS_RTOL):
        raise AssertionError(f"{name}: {what} and {against} training steps "
                             "disagree")


def _kernels_by_part(parts) -> str:
    """The CUDA kernels each of ``parts`` (name -> call, run in turn)
    launches, by torch.profiler's device events: the count, memory copies
    and sets apart, and the most frequent kernel names."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    out, n_events = [], 0
    for name, call in parts.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        dev = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        n_events += len(dev)
        mem = sum(n.startswith(("Memcpy", "Memset")) for n in dev)
        top = Counter(n for n in dev if not n.startswith(("Memcpy", "Memset")))
        out.append(f"{name} {len(dev) - mem} kernels + {mem} copies/sets (most "
                   + ", ".join(f"{n[:48]} x{c}" for n, c in top.most_common(3))
                   + ")")
    if not n_events:
        return "not measured (the profiler saw no device events)"
    return "; ".join(out)


def _step_times(cfg, params, card: str, records) -> None:
    """Host-clock time of an epoch of train steps (what a trainer waits
    for), one step's device time split into forward (with the loss),
    backward and optimizer by CUDA events, each part timed with the device
    held busy while the host enqueues it, the CUDA kernels each part
    launches, and the card's busy share (device ms over host ms a step)."""
    from hgnn2_torch.training import train

    t0 = time.perf_counter()
    model, opt, sched, batches, mean, std = _train_setup(cfg, params, "cuda",
                                                         records)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    train.train_step(model, opt, sched, batches[0], mean=mean, std=std)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        train.train_step(model, opt, sched, batch, mean=mean, std=std)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_mols = sum(int(train._graph_mask(b).sum()) for b in batches)
    held = {}

    def forward(batch):
        model.train()
        opt.zero_grad(set_to_none=True)
        held["loss"], _ = train._loss_and_metrics(
            model(batch), batch.y, train._graph_mask(batch), "regression",
            mean, std)

    parts = {"forward+loss": forward,
             "backward": lambda batch: held["loss"].backward(),
             "optimizer": lambda batch: (opt.step(), sched.step())}
    splits = []
    for batch in batches:
        row = []
        for name, part in parts.items():  # each part behind its own spin
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(10 * BUSY_CYCLES)
            start.record()
            part(batch)
            end.record()
            if start.query():
                raise AssertionError(f"the device spin ended before the {name} "
                                     "was enqueued: its time would hold host gaps")
            end.synchronize()
            row.append(start.elapsed_time(end))
        splits.append(row)
    fwd, bwd, upd = np.median(np.array(splits), axis=0)
    kernels = _kernels_by_part({name: lambda part=part: part(batches[0])
                                for name, part in parts.items()})
    host_ms = secs / len(batches) * 1e3
    label = (f"{'packed ' if cfg.model.packed else ''}{cfg.model.arch} "
             f"L={cfg.model.n_layers} h={cfg.model.n_features}")
    print(f"  {label}: set-up {setup_s:.3f} s (host clock: target stats, "
          f"{len(batches)} train batches built and copied, model)")
    print(f"  {label}: {len(batches)} steps of {cfg.batch_size} molecules in "
          f"{secs:.4f} s (host clock): {host_ms:.3f} ms/step, "
          f"{n_mols / secs:.1f} molecules/s on {card}")
    print(f"  {label} one step, device time (CUDA events, median of "
          f"{len(splits)}): forward+loss {fwd:.3f} ms, backward {bwd:.3f} ms, "
          f"optimizer {upd:.3f} ms, total {fwd + bwd + upd:.3f} ms; busy "
          f"{(fwd + bwd + upd) / host_ms * 100:.1f} % of the host's "
          f"{host_ms:.3f} ms a step on {card}")
    print(f"  {label} CUDA kernels a step (torch.profiler): {kernels}")


def phase_training(card: str) -> dict[str, int]:
    """Train CCN2D(L=2, h=2) and CCN1D(L=20, h=2) through run_experiment on
    the card, whose fit replays captured graphs: the kernels' counts move
    at the Python-level forwards (each graph's warm-up runs and capture),
    so they are held to the layers times those forwards, and the replays
    to one a train step and an eval batch. Returns each kernel's launches
    summed over the two runs."""
    from hgnn2_torch.cli import common
    from hgnn2_torch.nn import ccn

    records = _synthetic(N_TRAIN_MOLS)  # as run_experiment's
    counters = _counters()
    launches = dict.fromkeys(counters, 0)
    n_train = int(0.8 * N_TRAIN_MOLS)
    n_eval = N_TRAIN_MOLS - n_train  # valid + test, each under one batch
    steps = TRAIN_EPOCHS * -(-n_train // TRAIN_BS)
    eval_batches = TRAIN_EPOCHS * 2 * -(-(n_eval // 2) // TRAIN_BS)
    for name, arch, n_layers, fwd, bwd, n_channels, seed in (
            ("CCN2D", "ccn2d", 2, "K3", "K4", 18, 3),
            ("CCN1D", "ccn1d", 20, "K1", "K2", 2, 4)):
        params = _flax_params(5, 2, n_layers, n_channels, seed)
        cfg = _train_cfg(arch, n_layers, "cuda",
                         os.path.join(OUT_DIR, f"train_{arch}"))
        _zero(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _Runs(ccn.CCN1D, ccn.CCN2D) as runs:
            _, history = common.run_experiment(cfg, init_params=params)  # the main path
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = _read(counters)
        for k, n in got.items():
            launches[k] += n

        want = _want(counters)
        want[fwd] = n_layers * (runs.train + runs.eval)
        want[bwd] = (n_layers - 1) * runs.train
        replayed = {fwd: n_layers * (steps + eval_batches),
                    bwd: (n_layers - 1) * steps}
        losses = [(row["train_loss"], row["valid_loss"], row["test_loss"])
                  for row in history]
        print(f"  {name} L={n_layers} h=2: run_experiment, {TRAIN_EPOCHS} epochs "
              f"x {steps // TRAIN_EPOCHS} steps of {TRAIN_BS} molecules, "
              f"{secs:.2f} s host clock on {card} (batch builds included); "
              f"(train, valid, test) loss per epoch {losses}; launches {got} "
              f"(expected {want}: {runs.train} train and {runs.eval} eval "
              f"Python-level forwards, the graphs' warm-up runs and "
              f"captures); {runs.replays} graph replays (expected "
              f"{steps + eval_batches}, one a step and an eval batch), so "
              f"{replayed} launches replayed")
        if not cfg.model.ccn_kernel:
            raise AssertionError(f"{name}: run_experiment did not enable the kernels")
        if got != want or runs.replays != steps + eval_batches:
            raise AssertionError(f"{name}: kernel launches {got} != {want} "
                                 f"or {runs.replays} replays")
        if len(history) != TRAIN_EPOCHS or not all(
                np.isfinite(v) for row in history for v in row.values()):
            raise AssertionError(f"{name}: training history not finite: {history}")

        _compare_steps(name, cfg, params, records)
        _step_times(cfg, params, card, records)
    return launches


def _packed_caps(records) -> tuple[int, int]:
    """Node and edge capacities rounded up to multiples of 64, as
    bench_scaling.py packs its 1,024 molecules."""
    tot_v = sum(r.n_nodes for r in records)
    tot_e = sum(r.n_dir_edges for r in records)
    return -(-tot_v // 64) * 64, -(-tot_e // 64) * 64


def _flax_variables(model, seed: int) -> dict:
    """Seeded weights in the flax layout of a model with batch norm (the
    packed models, GNNSimple): every kernel, bias and BN scale N(0, 0.1),
    drawn in the tree's order; batch stats at the model's init (mean 0,
    std 1, or 0 under the reference compat flags)."""
    from hgnn2_torch import convert

    rng = np.random.default_rng(seed)
    tree = convert.variables_to_flax(model.state_dict())

    def draw(node):
        return {k: draw(v) if isinstance(v, dict)
                else rng.normal(0, 0.1, v.shape).astype(np.float32)
                for k, v in node.items()}
    return {"params": draw(tree["params"]), "batch_stats": tree["batch_stats"]}


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    got, want = got.detach().cpu(), want.detach().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def phase_packed(dev, card: str, records) -> dict[str, int]:
    """Edge-partitioned packed inference of both configurations at
    S = RING_RANKS. Returns each kernel's launches over the main paths'
    runs (one eval forward of each model through the ring)."""
    from hgnn2_torch import convert, graphs
    from hgnn2_torch.cli import common
    from hgnn2_torch.nn import packed
    from hgnn2_torch.parallel import spmd
    from hgnn2_torch.training.config import TrainConfig

    S = RING_RANKS
    V, C = _packed_caps(records)
    t0 = time.perf_counter()
    pb = graphs.make_packed_batch(records, node_capacity=V, edge_capacity=C,
                                  task=0, device=dev)
    torch.cuda.synchronize()
    print(f"  {len(records)} molecules packed: V={V} node slots, C={C} edge "
          f"slots ({C // S} a rank), batch build + copy "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms (host clock)")
    pb_cpu = pb.to("cpu")
    mesh, cpu_mesh = spmd.EdgeMesh([dev] * S), spmd.EdgeMesh(["cpu"] * S)
    counters = _counters()
    launches = dict.fromkeys(counters, 0)
    for name, arch, h, n_layers, order, n_allreduce, seed in (
            ("PackedLGGNN", "lggnn", 8, 3, 2, 18, 5),
            ("PackedGNN", "gnn", 1, 15, 1, 16, 6)):
        cfg = TrainConfig(seed=seed, device="cuda")
        cfg.model.arch, cfg.model.n_features = arch, h
        cfg.model.n_layers, cfg.model.J, cfg.model.order = n_layers, 1, order
        J = cfg.model.J
        F_in = records[0].x.shape[1]
        state0 = convert.packed_variables_from_flax(_flax_variables(
            common.build_packed_model(cfg, "regression", F_in), seed))

        def model_on(device, state):
            m = common.build_packed_model(cfg, "regression", F_in)
            m.load_state_dict(state)
            return m.to(device)

        ring_ops = lambda: spmd.partitioned_packed_ops(mesh, pb, J, use_ring=True)
        plain_ops = lambda: spmd.partitioned_packed_ops(mesh, pb, J)
        single_ops = lambda: packed.SparsePackedOps(pb, J)
        cpu_ops = lambda: spmd.partitioned_packed_ops(cpu_mesh, pb_cpu, J,
                                                      use_ring=True)
        label = f"{name}(h={h}, L={n_layers}, J={J}{f', order={order}' if arch == 'lggnn' else ''})"

        # train-mode forward: batch statistics, running stats updated
        runs = {}
        with torch.no_grad():
            for key, device, batch, make_ops in (
                    ("ring", dev, pb, ring_ops), ("single", dev, pb, single_ops),
                    ("cpu", "cpu", pb_cpu, cpu_ops)):
                m = model_on(device, state0).train()
                out = m(batch, ops=make_ops())
                runs[key] = (out.cpu(), {k: v.cpu() for k, v in m.state_dict().items()})
        stat_keys = [k for k in state0 if k.endswith((".mean", ".std"))]
        for other in ("single", "cpu"):
            pred_err = _rel_err(runs["ring"][0], runs[other][0])
            stat_err = max(_rel_err(runs["ring"][1][k], runs[other][1][k])
                           for k in stat_keys)
            print(f"  {label} train-mode forward, card ring S={S} vs "
                  f"{'card single-rank ops' if other == 'single' else f'CPU ring twin S={S}'}: "
                  f"max err / max |pred| {pred_err:.3e}, updated BN stats max "
                  f"err / max |stat| {stat_err:.3e} over {len(stat_keys)} "
                  f"tensors (tolerance {SERVE_RTOL})")
            if pred_err > SERVE_RTOL or stat_err > SERVE_RTOL:
                raise AssertionError(f"{label}: train-mode forwards disagree")
        state1 = runs["ring"][1]

        # the main path: one eval forward through the ring
        model = model_on(dev, state1).eval()
        with torch.no_grad():
            model(pb, ops=ring_ops())  # first calls: cuBLAS, allocator
            _zero(counters)
            torch.cuda.synchronize()
            ops = ring_ops()
            preds = model(pb, ops=ops)
            torch.cuda.synchronize()
            got = _read(counters)
            for k, n in got.items():
                launches[k] += n
            want = _want(counters)
            want["K5"] = n_allreduce  # one launch an all-reduce
            n_ar = ops.comm_bytes_per_step()["n_allreduce_fwd"]
            print(f"  {label} eval forward over {len(records)} molecules, "
                  f"ring S={S}: {n_ar} all-reduces, launches {got} "
                  f"(expected {want})")
            if got != want or n_ar != n_allreduce:
                raise AssertionError(f"{label}: launches {got} != {want}")
            if preds.shape != (len(records), 1) or not torch.isfinite(preds).all():
                raise AssertionError(f"{label}: predictions not finite or misshapen")
            single = model(pb, ops=single_ops())
            cpu = model_on("cpu", state1).eval()(pb_cpu, ops=cpu_ops())
            for other, ref in (("card single-rank ops", single),
                               (f"CPU ring twin S={S}", cpu)):
                err = _rel_err(preds, ref)
                print(f"  {label} eval, card ring vs {other}: max err / max "
                      f"|pred| {err:.3e} (tolerance {SERVE_RTOL})")
                if err > SERVE_RTOL:
                    raise AssertionError(f"{label}: eval predictions disagree")

            for key, make_ops in (("ring", ring_ops), ("plain reduce", plain_ops),
                                  ("single-rank ops", single_ops)):
                fwd = lambda: model(pb, ops=make_ops())
                fwd()
                torch.cuda.synchronize()
                reps = 20
                t0 = time.perf_counter()
                for _ in range(reps):
                    fwd()
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) / reps * 1e3
                dev_ms = _time_ms(fwd, reps=10, warmup=1, busy=10 * BUSY_CYCLES)
                print(f"  {label} eval forward ({key}{f', S={S}' if key != 'single-rank ops' else ''}"
                      f", operator bundle built in the forward): {host_ms:.3f} ms "
                      f"host clock, {dev_ms:.3f} ms device (CUDA events), "
                      f"{len(records) / host_ms * 1e3:.1f} molecules/s on {card}")
    return launches


def _main_cfg(device: str, log_path: str | None = None, **model):
    """The main path's configuration, bench.py's model and optimizer:
    GNNSimple(L=15, h=1, J=1) at 2,048 molecules a step, Adamax at lr
    3e-4, on the synthetic QM9-shaped molecules; ``model`` overrides
    fields of cfg.model."""
    from hgnn2_torch.training.config import TrainConfig

    cfg = TrainConfig(batch_size=MAIN_BS, epochs=TRAIN_EPOCHS, seed=0,
                      device=device, log_path=log_path)
    cfg.optim.optim, cfg.optim.lr = "adamax", 3e-4
    cfg.model.arch, cfg.model.n_features, cfg.model.n_layers = "gnn", 1, 15
    for k, v in model.items():
        setattr(cfg.model, k, v)
    cfg.data.dataset, cfg.data.n_synthetic = "qm9_synthetic", N_MAIN_MOLS
    return cfg


def _forwards(model, params, batch) -> tuple:
    """A train-mode forward (batch statistics) from ``params``, the BN
    running stats it leaves and an eval forward from them."""
    from hgnn2_torch import convert

    model.load_state_dict(convert.dense_variables_from_flax(params))
    model.to(batch.x.device).train()
    with torch.no_grad():
        out = model(batch)
        stats = {k: v for k, v in model.state_dict().items()
                 if k.endswith((".mean", ".std"))}
        return out, stats, model.eval()(batch)


def _forward_errs(got: tuple, want: tuple) -> tuple[float, float, float]:
    """_forwards' three results against another run's: max err / max |value|
    of the train-mode output, of any BN running stat and of the eval output."""
    return (_rel_err(got[0], want[0]),
            max(_rel_err(got[1][k], v) for k, v in want[1].items()),
            _rel_err(got[2], want[2]))


def phase_main(dev, card: str) -> dict[str, int]:
    """Train GNNSimple(L=15, h=1, J=1) through run_experiment on the card
    (``dev``) and hold it to the CPU. Returns each kernel's launches in
    that run: the two power-layer kernels at each of the model's power
    layers, at each Python-level train forward and its backward, and none
    of K1-K5 or the BN kernels (the power layers' kernels take the batch
    norm)."""
    from hgnn2_torch.cli import common
    from hgnn2_torch.data import batching, synthetic
    from hgnn2_torch.nn import layers, models
    from hgnn2_torch.ops import dense

    records = _synthetic(N_MAIN_MOLS)  # as run_experiment's
    F_in = records[0].x.shape[1]
    cfg = _main_cfg(str(dev), os.path.join(OUT_DIR, "train_gnn"))
    params = _flax_variables(common.build_model(cfg, "regression", F_in), 7)
    n_train = int(0.8 * N_MAIN_MOLS)
    counters = _counters()
    _zero(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Runs(models.GNNSimple) as runs:
        model, history = common.run_experiment(cfg, init_params=params)  # the main path
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read(counters)
    losses = [(row["train_loss"], row["valid_loss"], row["test_loss"])
              for row in history]
    n_power = sum(isinstance(m, layers.PowerLayer) for m in model.modules())
    want = _want(counters)
    want.update(dict.fromkeys(POWER_KEYS, n_power * runs.train))
    want.update(dict.fromkeys(BN_KEYS, 0))
    print(f"  GNNSimple L=15 h=1 J=1: run_experiment, {TRAIN_EPOCHS} epochs x "
          f"{n_train // MAIN_BS} steps of {MAIN_BS} molecules, {secs:.2f} s host "
          f"clock on {card} (data generation and batch builds included); "
          f"(train, valid, test) loss per epoch {losses}; launches {launches} "
          f"(expected {want}: {n_power} power layers x {runs.train} "
          f"Python-level train forwards, the warm-up runs and captures, and "
          f"no BN kernel; {runs.replays} graph replays launch them besides)")
    if len(history) != TRAIN_EPOCHS or not all(
            np.isfinite(v) for row in history for v in row.values()):
        raise AssertionError(f"GNNSimple: training history not finite: {history}")
    if launches != want or not runs.train:
        raise AssertionError(f"GNNSimple: launches {launches} != {want}")

    # with BN, a gradient below GRAD_FLOOR x the model's largest is a
    # difference of much larger per-node terms (the bias of cv1 or cv2 of
    # a unit whose ReLU is on at almost every real node only shifts what
    # BN subtracts), so its f32 error scales with the terms, not with it
    _compare_steps("GNNSimple L=15 h=1 J=1", cfg, params, records, dev,
                   grad_floor=GRAD_FLOOR)

    # eval-mode predictions of the trained model on the first valid batch
    valid = synthetic.split_80_10_10(records, seed=0)[1]
    vb = next(iter(batching.DenseLoader(valid, MAIN_BS, task=0, device=dev)))
    vb_cpu = vb.to("cpu")
    trained = model.state_dict()
    cpu_model = common.build_model(_main_cfg("cpu"), "regression", F_in)
    cpu_model.load_state_dict(trained)
    with torch.no_grad():
        err = _rel_err(model.eval()(vb), cpu_model.eval()(vb_cpu))
    print(f"  GNNSimple L=15 eval predictions on a valid batch of "
          f"{int(vb_cpu.n_nodes.gt(0).sum())} molecules (N={vb.x.shape[1]}), "
          f"card vs CPU: max err / max |pred| {err:.3e} (tolerance {SERVE_RTOL})")
    if err > SERVE_RTOL:
        raise AssertionError("GNNSimple: card and CPU eval predictions disagree")

    # the options the main path leaves off, on the same batch, forward only
    variant = dict(n_features=2, n_layers=3, J=2, gru=True, compat_reference=True)
    vparams = _flax_variables(common.build_model(
        _main_cfg("cpu", **variant), "regression", F_in), 8)
    card_out, cpu_out = (
        _forwards(common.build_model(_main_cfg(str(device), **variant),
                                     "regression", F_in), vparams, batch)
        for device, batch in ((dev, vb), ("cpu", vb_cpu)))
    pred_err, stat_err, eval_err = _forward_errs(card_out, cpu_out)
    print(f"  GNNSimple L=3 h=2 J=2 gru compat=reference on that batch, card vs "
          f"CPU: train-mode forward max err / max |pred| {pred_err:.3e}, BN "
          f"running stats {stat_err:.3e}, eval forward {eval_err:.3e} "
          f"(tolerance {SERVE_RTOL})")
    if max(pred_err, stat_err, eval_err) > SERVE_RTOL:
        raise AssertionError("GNNSimple variant: card and CPU forwards disagree")

    # bf16 compute. graph_op, the path's one batched matmul, within bf16's
    # rounding of its inputs and output (2^-7 of max |value|). The whole
    # L=15 model against f32 is reported, not held to a bar: with random
    # weights its bf16 deviation is set by the draw (a ReLU feature that
    # is rarely on has a tiny batch std, which BN divides by), in the JAX
    # package's model as in this one
    tb = next(iter(batching.DenseLoader(synthetic.split_80_10_10(records)[0],
                                        MAIN_BS, task=0, device=dev)))
    x = torch.randn(tb.x.shape[:2] + (2,), device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    ap, deg = dense.adjacency_powers(tb.adj, 1), dense.degrees(tb.adj)
    g32 = dense.graph_op(ap, deg, x, tb.node_mask)
    g16 = dense.graph_op(ap.bfloat16(), deg.bfloat16(), x.bfloat16(), tb.node_mask)
    op_err = _rel_err(g16.float(), g32)
    outs = {}
    for dtype in (None, torch.bfloat16):
        m = models.GNNSimple(in_features=F_in, n_features=1, n_layers=15, J=1,
                             dtype=dtype)
        out, stats, _ = _forwards(m, params, tb)
        outs[dtype] = (out, list(stats.values()))
    out32, (out16, bufs16) = outs[None][0], outs[torch.bfloat16]
    scale = float(out32.abs().mean())
    dev_max = float((out16 - out32).abs().max()) / scale
    dev_mean = float((out16 - out32).abs().mean()) / scale
    ok = (op_err <= 2 ** -7 and g16.dtype == torch.bfloat16
          and out16.dtype == torch.float32 and bool(torch.isfinite(out16).all())
          and all(b.dtype == torch.float32 for b in bufs16))
    print(f"  bf16 graph_op on a train batch (N={tb.x.shape[1]}, F=2) vs f32: "
          f"max err / max |value| {op_err:.3e} (tolerance 2^-7); GNNSimple "
          f"L=15 bf16 vs f32 train-mode forward: max err {dev_max:.3e}, mean "
          f"err {dev_mean:.3e} of mean |f32 output| (reported); output "
          f"{out16.dtype}, BN stats {bufs16[0].dtype} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("GNNSimple: the bf16 path is off")

    _step_times(cfg, params, card, records)
    return launches


def phase_lggnn(dev, card: str) -> dict[str, int]:
    """Train GNNLineGraph(L=5, h=1, J=1, order 2) through run_experiment on
    the card (``dev``) and hold it to the CPU. Returns each kernel's
    launches in that run: the BN kernels at the node and edge batch
    norms, the exchange's six at its applies, none of K1-K5."""
    from hgnn2_torch.cli import common
    from hgnn2_torch.data import batching, synthetic
    from hgnn2_torch.nn import layers, models
    from hgnn2_torch.nn.bundles import DenseBundle
    from hgnn2_torch.nn.layers import CompatConfig

    records = _synthetic(N_MAIN_MOLS)  # as run_experiment's
    F_in = records[0].x.shape[1]
    lg = dict(arch="lggnn", n_layers=5, order=2)
    cfg = _main_cfg(str(dev), os.path.join(OUT_DIR, "train_lggnn"), **lg)
    params = _flax_variables(common.build_model(cfg, "regression", F_in), 9)
    n_train = int(0.8 * N_MAIN_MOLS)
    counters = _counters()
    _zero(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Runs(models.GNNLineGraph) as runs:
        model, history = common.run_experiment(cfg, init_params=params)  # the main path
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read(counters)
    losses = [(row["train_loss"], row["valid_loss"], row["test_loss"])
              for row in history]
    print(f"  GNNLineGraph L=5 h=1 J=1 order 2: run_experiment, {TRAIN_EPOCHS} "
          f"epochs x {n_train // MAIN_BS} steps of {MAIN_BS} molecules, "
          f"{secs:.2f} s host clock on {card} (data generation, line graphs "
          f"and batch builds included); (train, valid, test) loss per epoch "
          f"{losses}; launches {launches} (K1-K5 none)")
    finite = all(np.isfinite(v) for row in history for v in row.values())
    if len(history) != TRAIN_EPOCHS or not finite:
        raise AssertionError(f"GNNLineGraph: training history not finite: {history}")
    if not isinstance(model, models.GNNLineGraph):
        raise AssertionError(f"run_experiment built a {type(model).__name__}")
    if (any(_ks(launches).values()) or not launches["BN forward"]
            or not all(launches[k] for k in LG_KEYS)):
        raise AssertionError(f"GNNLineGraph launched a CCN or ring kernel, or "
                             f"missed a BN or exchange kernel: {launches}")
    # the batch norm's kernels at each of its node and edge batch norms, at
    # each Python-level train forward (warm-ups and captures) and backward
    n_bn = sum(isinstance(m, layers.MaskedBatchNorm) for m in model.modules())
    want_bn = dict.fromkeys(BN_KEYS, n_bn * runs.train)
    print(f"  BN launches {[launches[k] for k in BN_KEYS]} (expected "
          f"{n_bn} batch norms x {runs.train} Python-level train forwards; "
          f"{runs.replays} graph replays launch them besides)")
    if {k: launches[k] for k in BN_KEYS} != want_bn or not runs.train:
        raise AssertionError(f"GNNLineGraph: BN launches {launches} != {want_bn}")

    # as in phase 6: a cv1/cv2 bias that only shifts what BN subtracts has
    # a rounding-level gradient, held against GRAD_FLOOR x the model's max
    _compare_steps("GNNLineGraph L=5 h=1 J=1 order 2", cfg, params, records,
                   dev, grad_floor=GRAD_FLOOR)

    # eval-mode predictions of the trained model on the first valid batch
    valid = synthetic.split_80_10_10(records, seed=0)[1]
    vb = next(iter(batching.DenseLoader(valid, MAIN_BS, task=0,
                                        with_line_graph=True, device=dev)))
    vb_cpu = vb.to("cpu")
    cpu_model = common.build_model(_main_cfg("cpu", **lg), "regression", F_in)
    cpu_model.load_state_dict(model.state_dict())
    with torch.no_grad():
        err = _rel_err(model.eval()(vb), cpu_model.eval()(vb_cpu))
    shape = f"N={vb.x.shape[1]}, M={vb.lg_src.shape[1]}"
    print(f"  GNNLineGraph L=5 eval predictions on a valid batch of "
          f"{int(vb_cpu.n_nodes.gt(0).sum())} molecules ({shape}), card vs "
          f"CPU: max err / max |pred| {err:.3e} (tolerance {SERVE_RTOL})")
    if err > SERVE_RTOL:
        raise AssertionError("GNNLineGraph: card and CPU eval predictions disagree")

    # the other update orders, J=2 and the reference compat flags on the
    # same batch, forward only
    for order in (1, 3):
        def build():
            return models.GNNLineGraph(
                in_features=F_in, n_features=2, n_layers=3, J=2, order=order,
                compat=CompatConfig.reference())
        vparams = _flax_variables(build(), 10 + order)
        errs = _forward_errs(_forwards(build(), vparams, vb),
                             _forwards(build(), vparams, vb_cpu))
        print(f"  GNNLineGraph L=3 h=2 J=2 order {order} compat=reference on "
              f"that batch: card vs CPU train-mode forward max err / max "
              f"|pred| {errs[0]:.3e}, BN running stats {errs[1]:.3e}, eval "
              f"forward {errs[2]:.3e} (tolerance {SERVE_RTOL})")
        if max(errs) > SERVE_RTOL:
            raise AssertionError(f"GNNLineGraph order {order}: forwards disagree")

    # bf16 compute: lg_graph_op within bf16's rounding of its inputs and
    # output (2^-7 of max |value|); the whole L=5 model reported
    tb = next(iter(batching.DenseLoader(synthetic.split_80_10_10(records)[0],
                                        MAIN_BS, task=0, with_line_graph=True,
                                        device=dev)))
    xl = torch.randn(tb.lg_w.shape + (2,), device=dev,
                     generator=torch.Generator(dev).manual_seed(0))
    g32 = DenseBundle.from_batch(tb, 1, with_line_graph=True).lg_graph_op(xl)
    g16 = DenseBundle.from_batch(tb, 1, with_line_graph=True,
                                 dtype=torch.bfloat16).lg_graph_op(xl.bfloat16())
    op_err = _rel_err(g16.float(), g32)
    outs = {}
    for dtype in (None, torch.bfloat16):
        m = models.GNNLineGraph(in_features=F_in, n_features=1, n_layers=5, J=1,
                                order=2, dtype=dtype)
        out, stats, _ = _forwards(m, params, tb)
        outs[dtype] = (out, list(stats.values()))
    out32, (out16, bufs16) = outs[None][0], outs[torch.bfloat16]
    scale = float(out32.abs().mean())
    dev_max = float((out16 - out32).abs().max()) / scale
    dev_mean = float((out16 - out32).abs().mean()) / scale
    ok = (op_err <= 2 ** -7 and g16.dtype == torch.bfloat16
          and out16.dtype == torch.float32 and bool(torch.isfinite(out16).all())
          and all(b.dtype == torch.float32 for b in bufs16))
    print(f"  bf16 lg_graph_op on a train batch (N={tb.x.shape[1]}, "
          f"M={tb.lg_src.shape[1]}, F=2) vs f32: max err / max |value| "
          f"{op_err:.3e} (tolerance 2^-7); GNNLineGraph L=5 bf16 vs f32 "
          f"train-mode forward: max err {dev_max:.3e}, mean err {dev_mean:.3e} "
          f"of mean |f32 output| (reported); output {out16.dtype}, BN stats "
          f"{bufs16[0].dtype} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("GNNLineGraph: the bf16 path is off")

    _step_times(cfg, params, card, records)
    return launches


def _checkpoint_resume(name: str, cfg, params, model, F_in: int,
                       steps: int) -> None:
    """The checkpoint the card's run wrote after its last epoch, restored
    on the CPU: model, optimizer and schedule, the model bit for bit with
    the card's. Then one more epoch from it with --bn_recalib and
    --no_scan, so that its batches come through the trainer's prefetch
    thread, on the card and on the CPU (each from its own copy of the
    checkpoint), held to each other."""
    from hgnn2_torch.cli import common
    from hgnn2_torch.training import optim
    from hgnn2_torch.training.checkpoint import Checkpointer

    ckpt = Checkpointer(cfg.checkpoint_path)
    cpu_cfg = dataclasses.replace(cfg, device="cpu")
    cpu_model = common.build_packed_model(cpu_cfg, "regression", F_in)
    opt, sched = optim.build_optimizer(cfg.optim, steps, cpu_model.parameters())
    epoch = ckpt.restore(cpu_model, opt, sched)
    card_state = {k: v.cpu() for k, v in model.state_dict().items()}
    bit_equal = all(torch.equal(card_state[k], v)
                    for k, v in cpu_model.state_dict().items())
    moments = sum(torch.is_tensor(v) and v.device.type == "cpu"
                  for st in opt.state.values() for v in st.values())
    print(f"  {name}: checkpoints {ckpt.all_steps()} written on the card; the "
          f"latest restored on the CPU: epoch {epoch}, schedule count "
          f"{sched.last_epoch}, {moments} optimizer tensors on the CPU, model "
          f"bit-equal to the card's {bit_equal}")
    if (epoch != TRAIN_EPOCHS or sched.last_epoch != TRAIN_EPOCHS * steps
            or not bit_equal or not moments):
        raise AssertionError(f"{name}: the card's checkpoint did not restore "
                             "on the CPU")

    cpu_dir = cfg.checkpoint_path + "_cpu"
    shutil.rmtree(cpu_dir, ignore_errors=True)
    shutil.copytree(cfg.checkpoint_path, cpu_dir)
    card, cpu = (common.run_experiment(dataclasses.replace(
        cfg, device=device, epochs=TRAIN_EPOCHS + 1, resume=True,
        bn_recalibrate=True, scan_epochs=False, checkpoint_path=path,
        log_path=os.path.join(OUT_DIR, f"resume_{where}")),
        init_params=params)[1]
        for where, device, path in (("card", cfg.device, cfg.checkpoint_path),
                                    ("cpu", "cpu", cpu_dir)))
    keys = [k for k in cpu[0] if k != "epoch_time_s"]
    errs = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(card, cpu))
            for k in keys}
    train_err = max(v for k, v in errs.items() if k.startswith("train_"))
    eval_err = max(v for k, v in errs.items() if not k.startswith("train_"))
    rows_ok = (len(card) == len(cpu) == 2 and card[1].get("bn_recalibrated")
               == cpu[1].get("bn_recalibrated") == 1.0
               and Checkpointer(cfg.checkpoint_path).latest_step()
               == TRAIN_EPOCHS + 1)
    print(f"  {name}: resumed for epoch {TRAIN_EPOCHS + 1} with --bn_recalib "
          f"and --no_scan (stepwise, through prefetch), card vs CPU: train metrics max rel err {train_err:.3e} (tolerance "
          f"{TRAIN_LOSS_RTOL}), valid/test metrics of the epoch and of the "
          f"recalibrated row {eval_err:.3e} (tolerance {EVAL_RTOL}); rows "
          f"{'ok' if rows_ok else 'FAIL'}")
    if not rows_ok or train_err > TRAIN_LOSS_RTOL or eval_err > EVAL_RTOL:
        raise AssertionError(f"{name}: the resumed runs disagree")


def phase_packed_train(dev, card: str) -> dict[str, int]:
    """Train PackedGNN(L=15, h=1, J=1), then PackedLGGNN(L=5, h=1, J=1,
    order 2), through run_experiment with --packed on the card (``dev``)
    and hold each to the CPU; PackedGNN's run also writes checkpoints,
    restored on the CPU and resumed with --bn_recalib. Returns each
    kernel's launches in the two runs: the BN kernels, none of K1-K5."""
    from hgnn2_torch.cli import common
    from hgnn2_torch.data import batching, synthetic

    records = _synthetic(N_MAIN_MOLS)  # as run_experiment's
    F_in = records[0].x.shape[1]
    valid = synthetic.split_80_10_10(records, seed=0)[1]
    n_train = int(0.8 * N_MAIN_MOLS)
    counters = _counters()
    launches = dict.fromkeys(counters, 0)
    for name, model_kw, seed in (
            ("PackedGNN L=15 h=1 J=1", {}, 11),
            ("PackedLGGNN L=5 h=1 J=1 order 2",
             dict(arch="lggnn", n_layers=5, order=2), 12)):
        cfg = _main_cfg(str(dev), os.path.join(OUT_DIR, f"train_packed{seed}"),
                        packed=True, **model_kw)
        if seed == 11:
            cfg.checkpoint_path = os.path.join(OUT_DIR, "ckpt_packed")
            shutil.rmtree(cfg.checkpoint_path, ignore_errors=True)
        params = _flax_variables(
            common.build_packed_model(cfg, "regression", F_in), seed)
        _zero(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, history = common.run_experiment(cfg, init_params=params)  # the main path
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = _read(counters)
        for k, n in got.items():
            launches[k] += n
        losses = [(row["train_loss"], row["valid_loss"], row["test_loss"])
                  for row in history]
        print(f"  {name}: run_experiment --packed, {TRAIN_EPOCHS} epochs x "
              f"{n_train // MAIN_BS} steps of {MAIN_BS} molecules, {secs:.2f} s "
              f"host clock on {card} (data generation and batch builds "
              f"included); (train, valid, test) loss per epoch {losses}; "
              f"launches {got} (K1-K5 none)")
        finite = all(np.isfinite(v) for row in history for v in row.values())
        if len(history) != TRAIN_EPOCHS or not finite:
            raise AssertionError(f"{name}: training history not finite: {history}")
        want_type = "PackedLGGNN" if model_kw else "PackedGNN"
        if type(model).__name__ != want_type:
            raise AssertionError(f"run_experiment built a {type(model).__name__}")
        if any(_ks(got).values()) or not got["BN forward"]:
            raise AssertionError(f"{name} launched a CCN or ring kernel, or "
                                 f"no BN kernel: {got}")

        # as in phases 6 and 7: a bias that only shifts what BN subtracts
        # has a rounding-level gradient, held against GRAD_FLOOR x the max
        _compare_steps(name, cfg, params, records, dev, grad_floor=GRAD_FLOOR)

        # eval-mode predictions of the trained model on the first valid batch
        vb = next(iter(batching.PackedLoader(valid, MAIN_BS, task=0, device=dev)))
        vb_cpu = vb.to("cpu")
        cpu_model = common.build_packed_model(
            dataclasses.replace(cfg, device="cpu"), "regression", F_in)
        cpu_model.load_state_dict(model.state_dict())
        with torch.no_grad():
            err = _rel_err(model.eval()(vb), cpu_model.eval()(vb_cpu))
        print(f"  {name} eval predictions on a valid batch of "
              f"{int(vb_cpu.gmask.sum())} molecules (V={vb.num_node_slots}, "
              f"C={vb.num_edge_slots}), card vs CPU: max err / max |pred| "
              f"{err:.3e} (tolerance {SERVE_RTOL})")
        if err > SERVE_RTOL:
            raise AssertionError(f"{name}: card and CPU eval predictions disagree")

        if cfg.checkpoint_path:
            _checkpoint_resume(name, cfg, params, model, F_in,
                               -(-n_train // MAIN_BS))
        _step_times(cfg, params, card, records)
    return launches


N_FILE_MOLS = 10240  # the training cache: 8,192 train molecules
SERVE9_BUCKETS = ["--bs", "1024", "--buckets", "256"]
# phase 9's models: (name, main_* module, train argv, export/predict argv,
# the kernel a serving layer launches, layers); the GNNs train at MAIN_BS
# molecules a step, the CCN models at TRAIN_BS
SERVE9_MODELS = (
    ("GNNSimple L=15 h=1 J=1", "main_gnn_qm9", ["--L", "15", "--h", "1"],
     ["--arch", "gnn", "--L", "15", "--h", "1"], None, 15),
    ("GNNLineGraph L=5 h=1 J=1 order 2", "main_gnn_qm9",
     ["--lg", "--update", "2", "--L", "5", "--h", "1"],
     ["--arch", "lggnn", "--update", "2", "--L", "5", "--h", "1"], None, 5),
    ("PackedGNN L=15 h=1 J=1", "main_gnn_qm9", ["--packed", "--L", "15", "--h", "1"],
     ["--packed", "--arch", "gnn", "--L", "15", "--h", "1"], None, 15),
    ("CCN2D L=2 h=2", "main_ccn_qm9", ["--k", "2", "--L", "2", "--h", "2"],
     ["--arch", "ccn2d", "--L", "2", "--h", "2"], "K3", 2),
    ("CCN1D L=20 h=2", "main_ccn_qm9", ["--k", "1", "--L", "20", "--h", "2"],
     ["--arch", "ccn1d", "--L", "20", "--h", "2"], "K1", 20),
)


def _counted(counters, totals, fn):
    """fn() with every launch counter set to 0 just before and read just
    after; the launches are added to totals and returned with fn's
    result."""
    _zero(counters)
    out = fn()
    torch.cuda.synchronize()
    got = _read(counters)
    for k, n in got.items():
        totals[k] += n
    return out, got


def _serve_split(sm, requests) -> None:
    """Where a predict call's time goes: each chunk's batch build and
    host-to-device copy (host clock, synchronized), then one full chunk's
    forward (host clock and device time by CUDA events); the card's busy
    share is the chunks' device time over the whole call's host time."""
    build = sm.build_batch
    builds = []

    def timed_build(records, spec):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = build(records, spec)
        torch.cuda.synchronize()
        builds.append((time.perf_counter() - t0, len(records), batch))
        return batch

    sm.build_batch = timed_build
    try:
        t0 = time.perf_counter()
        sm.predict(requests)
        total_s = time.perf_counter() - t0
    finally:
        del sm.build_batch
    _, n, batch = builds[0]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sm.model(batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = _time_ms(lambda: sm.model(batch), reps=10, warmup=2,
                          busy=10 * BUSY_CYCLES)
    build_ms = sum(b[0] for b in builds) * 1e3
    busy = len(builds) * dev_ms / (total_s * 1e3)
    print(f"    split: {len(builds)} chunks, batch build + copy {build_ms:.2f} "
          f"ms in all (host clock; the first chunk of {n} molecules "
          f"{builds[0][0] * 1e3:.2f} ms); one full chunk's forward "
          f"{host_ms:.3f} ms host clock, {dev_ms:.4f} ms device (CUDA "
          f"events); the call {total_s * 1e3:.1f} ms, card busy about "
          f"{100 * busy:.1f} %")


def _native_builds(dev, requests) -> None:
    """The batch builds of one 1,024-molecule chunk with the native
    library on, off, off and on (host clock; the card's copy included;
    the first build of a shape also pays the allocator): CCN chi tables,
    and dense and packed batches of fresh records, whose line graphs are
    built in the call. The batches must be equal."""
    from unittest import mock

    from hgnn2_torch import graphs, native
    from hgnn2_torch.graphs import GraphRecord
    from hgnn2_torch.nn import ccn

    chunk = requests[:1024]
    builds = {
        "make_ccn_batch (K=5)": lambda rs: ccn.make_ccn_batch(
            rs, k_max=5, task=0, device=dev),
        "make_dense_batch with line graphs": lambda rs: graphs.make_dense_batch(
            rs, n_max=32, with_line_graph=True, task=0, device=dev),
        "make_packed_batch": lambda rs: graphs.make_packed_batch(
            rs, task=0, device=dev),
    }
    for name, fn in builds.items():
        ms = {True: [], False: []}
        batches = []
        for on in (True, False, False, True):
            fresh = [GraphRecord(x=r.x, adj=r.adj, y=r.y) for r in chunk]
            with mock.patch.object(native, "available", return_value=on):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                batches.append(fn(fresh))
                torch.cuda.synchronize()
                ms[on].append((time.perf_counter() - t0) * 1e3)
        for f in dataclasses.fields(batches[0]):
            a = getattr(batches[0], f.name)
            if isinstance(a, torch.Tensor) and not all(
                    torch.equal(a, getattr(b, f.name)) for b in batches[1:]):
                raise AssertionError(f"{name}: {f.name} differs with the "
                                     "native library on and off")
        print(f"  native library: {name} of {len(chunk)} molecules on "
              f"{ms[True][0]:.1f} / {ms[True][1]:.1f} ms, off "
              f"{ms[False][0]:.1f} / {ms[False][1]:.1f} ms (host clock; run "
              f"on, off, off, on), batches equal")


def phase_serve_files(dev, card: str, rates: dict | None = None
                      ) -> dict[str, int]:
    """Serving from QM9 files on the card: write a cache of synthetic
    QM9-shaped molecules, train each of SERVE9_MODELS for one epoch
    through its CLI (--data_path --ckpt), export it with --bs 1024
    --buckets 256, serve 2,048 requests through the bundle on the card and
    on the CPU, hold call(arrays) to predict on one chunk, and run the
    predict CLI on the card and on the CPU. Returns each kernel's
    launches in the card's runs; ``rates`` gets each model's molecules/s
    on the card."""
    from hgnn2_torch import native, serving
    from hgnn2_torch.cli import export, main_ccn_qm9, main_gnn_qm9, predict
    from hgnn2_torch.data import qm9

    t_phase = time.perf_counter()
    if not native.available():
        raise AssertionError("the native library did not build on this machine")
    out = os.path.join(OUT_DIR, "serve_files")
    os.makedirs(out, exist_ok=True)
    train_cache = os.path.join(out, "train.npz")
    req_cache = os.path.join(out, "requests.npz")
    qm9.save_cache(qm9.synthetic_qm9_like(N_FILE_MOLS, seed=0), train_cache)
    qm9.save_cache(qm9.synthetic_qm9_like(N_REQUESTS, seed=1), req_cache)
    requests = qm9.load_cache(req_cache)
    _native_builds(dev, requests)
    mains = {"main_gnn_qm9": main_gnn_qm9, "main_ccn_qm9": main_ccn_qm9}
    counters = _counters()
    launches = dict.fromkeys(counters, 0)
    for i, (name, main, train_argv, argv, key, n_layers) in enumerate(
            SERVE9_MODELS):
        ckpt, bundle = os.path.join(out, f"ck{i}"), os.path.join(out, f"b{i}")
        argv = argv + ["--data_path", req_cache]
        bs = TRAIN_BS if key else MAIN_BS
        t0 = time.perf_counter()
        (_, history), got = _counted(counters, launches, lambda: mains[main].main(
            train_argv + ["--data_path", train_cache, "--bs", str(bs),
                          "--epochs", "1", "--ckpt", ckpt, "--device", str(dev),
                          "--log_path", os.path.join(out, f"log{i}")]))
        train_s = time.perf_counter() - t0
        if len(history) != 1 or not all(np.isfinite(v)
                                        for v in history[0].values()):
            raise AssertionError(f"{name}: training history {history}")
        if key is None and any(_ks(got).values()):
            raise AssertionError(f"{name} launched a CCN or ring kernel: {got}")
        if key is not None:
            pair = ("K1", "K2") if key == "K1" else ("K3", "K4")
            if not all(got[k] for k in pair) or any(
                    n for k, n in _ks(got).items() if k not in pair):
                raise AssertionError(f"{name}: training launches {got}")
        with contextlib.redirect_stdout(io.StringIO()):  # the bundle's path
            _, got_export = _counted(counters, launches, lambda: export.main(
                argv + SERVE9_BUCKETS + ["--ckpt", ckpt, "--out", bundle,
                                         "--device", str(dev)]))
        sm = serving.load_bundle(bundle, device=dev)
        sm.predict(requests[:8])  # first calls: cuBLAS handles, allocations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, got_serve = _counted(counters, launches,
                                    lambda: sm.predict(requests))  # the main path
        secs = time.perf_counter() - t0
        n_chunks = len(list(serving._greedy_spans(
            np.array([[r.n_nodes] for r in requests]), (sm.buckets[0][1],),
            sm.buckets[0][0]))) if sm.kind == "ccn" else None
        want = _want(counters)
        if key is not None:
            want[key] = n_layers * n_chunks
        print(f"  {name}: trained 1 epoch in {train_s:.2f} s (host clock, "
              f"train launches {got}), exported {sm.kind} bundle buckets "
              f"{sm.buckets} (smoke call launches {got_export}); "
              f"{N_REQUESTS} requests in {secs:.4f} s, "
              f"{N_REQUESTS / secs:.1f} molecules/s on {card}; serving "
              f"launches {got_serve} (expected {want})")
        if got_serve != want:
            raise AssertionError(f"{name}: serving launches {got_serve} != {want}")
        if rates is not None:
            rates[name] = N_REQUESTS / secs
        if key is not None and got_export[key] != n_layers:
            raise AssertionError(f"{name}: export's smoke call launched "
                                 f"{got_export}")
        if preds.shape != (N_REQUESTS,) or not np.isfinite(preds).all():
            raise AssertionError(f"{name}: predictions not finite or misshapen")
        _serve_split(sm, requests)
        ref = serving.load_bundle(bundle, device="cpu").predict(requests)
        err = float(np.abs(preds - ref).max())
        scale = float(np.abs(ref).max())
        # call(arrays) against predict on the 256-slot bucket's chunk
        spec = sm._programs[-1][0]
        chunk = requests[:serving._slots(spec)]
        raw = sm.call(serving.batch_to_arrays(sm.build_batch(chunk, spec)))
        called = (raw[: len(chunk), 0].float().cpu().numpy() * sm.meta["std"]
                  + sm.meta["mean"])
        call_err = float(np.abs(called - sm.predict(chunk)).max())
        print(f"    card vs CPU bundle: max_abs_err={err:.3e}, max |pred|="
              f"{scale:.3e}; call(arrays) vs predict on {len(chunk)} "
              f"molecules: {call_err:.3e} (tolerance {SERVE_RTOL} x max |pred|)")
        if err > SERVE_RTOL * scale or call_err > SERVE_RTOL * scale:
            raise AssertionError(f"{name}: card, CPU and call disagree")
        results = []
        for j, where in enumerate((str(dev), "cpu")):
            stdout = io.StringIO()
            npz = os.path.join(out, f"p{i}_{j}.npz")
            with contextlib.redirect_stdout(stdout):
                fn = lambda: predict.main(argv + [
                    "--bs", "1024", "--ckpt", ckpt, "--device", where,
                    "--out", npz])
                if j == 0:  # the card's run
                    res, got_pred = _counted(counters, launches, fn)
                else:
                    res = fn()
            if json.loads(stdout.getvalue().strip().splitlines()[-1]) != res:
                raise AssertionError(f"{name}: predict printed another result")
            results.append((res, np.load(npz)))
        (res, npz), (cres, cnpz) = results
        perr = float(np.abs(npz["predictions"] - cnpz["predictions"]).max())
        pscale = float(np.abs(cnpz["predictions"]).max())
        print(f"    predict CLI: MAE {res['mae']:.6f} on the card, "
              f"{cres['mae']:.6f} on the CPU over {res['n']} molecules; "
              f"predictions max_abs_err={perr:.3e} (max |pred| {pscale:.3e}); "
              f"launches {got_pred}")
        if (res["n"] != cres["n"] or perr > SERVE_RTOL * pscale
                or abs(res["mae"] - cres["mae"]) > SERVE_RTOL * abs(cres["mae"])
                or not np.array_equal(npz["targets"], cnpz["targets"])):
            raise AssertionError(f"{name}: predict card vs CPU disagree")
    print(f"  phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# phase 10's models: (name, arch, packed, L, h, the kernels its steps
# launch); the GNNs on N_MAIN_MOLS molecules at MAIN_BS a step, the CCN
# models on N_TRAIN_MOLS at TRAIN_BS, 2 epochs each
PHASE10_MODELS = (
    ("GNNSimple L=15 h=1 J=1", "gnn", False, 15, 1, ()),
    ("GNNLineGraph L=5 h=1 J=1 order 2", "lggnn", False, 5, 1, ()),
    ("PackedGNN L=15 h=1 J=1", "gnn", True, 15, 1, ()),
    ("CCN1D L=20 h=2", "ccn1d", False, 20, 2, ("K1", "K2")),
    ("CCN2D L=2 h=2", "ccn2d", False, 2, 2, ("K3", "K4")),
)
DENSE_RTOL = 1e-6  # captured vs eager, dense steps: bit-equal expected
BN_RECAL_RTOL = 1e-5  # captured vs eager BN recalibration (other sum order)
MULTI_INNER = 10
# captured vs eager, steps with atomics (packed, CCN): every weight and BN
# stat entry within tol x (1 + |value|), plus lr for each eager step whose
# gradient of it was at rounding level (below QUIET_GRAD; _Slack). The two
# tols are a few times the largest readings on an H100 (PERF.md section 2):
# a model with BN parts further, since its biases' walks change the
# rounding of everything after them
ATOMIC_TOL_BN = 1e-4  # PackedGNN: weights read up to 3.3e-5, stats 2.4e-5
ATOMIC_TOL = 1e-6  # CCN, no BN: weights read up to 1.5e-8
QUIET_GRAD = 1e-6
BUSY_MAX = 1.1  # device over host ms a step above this: the timing is wrong


class _Slack:
    """Per parameter entry, the lr of each eager step whose gradient of the
    entry was at rounding level (|g| < QUIET_GRAD), summed. Adamax moves a
    weight by up to lr a step whatever its gradient's size, so where the
    gradient is rounding (a bias that only shifts what a BN subtracts) two
    runs whose atomics round differently can part by that much; where it
    is not, they may not. step_fn(step) wraps an eager step to add its
    share (five foreach ops on the device, no host sync)."""

    def __init__(self, model, sched):
        self.params = dict(model.named_parameters())
        self.sums = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.sched = sched

    def step_fn(self, step):
        def run(batch):
            sched = self.sched
            lr = sched.base_lrs[0] * sched.lr_lambdas[0](sched.last_epoch)
            mets = step(batch)
            quiet = torch._foreach_abs([p.grad for p in self.params.values()])
            torch._foreach_mul_(quiet, -1.0)
            torch._foreach_add_(quiet, QUIET_GRAD)
            torch._foreach_sign_(quiet)  # 1 where |g| < QUIET_GRAD
            torch._foreach_clamp_min_(quiet, 0.0)
            torch._foreach_add_(list(self.sums.values()), quiet, alpha=lr)
            return mets

        return run

    def of(self, name: str) -> torch.Tensor | None:
        """The slack of a state_dict entry: a parameter's own; a BN's
        running mean that of the biases of the features it averages,
        concat(cv2, cv1) as pair_conv lays them out; else None."""
        if name in self.sums:
            return self.sums[name].cpu()
        if name.endswith("bn.mean"):
            prefix = name[:-len("bn.mean")]
            parts = [self.sums.get(f"{prefix}{c}.bias") for c in ("cv2", "cv1")]
            if all(p is not None for p in parts):
                return torch.cat(parts).cpu()
        return None


def _apart(got: dict, want: dict, slack: _Slack,
           tol: float) -> tuple[bool, str]:
    """Captured (got) against eager (want) state dicts of steps with
    atomics: every entry within tol * (1 + |value|) plus its slack.
    Returns (within, the readings): where no slack applies, the largest
    difference over 1 + |value| of the weights and of the buffers (BN
    stats); where it does, the largest difference over its limit."""
    ok, worst, quiet, n_quiet = True, {True: 0.0, False: 0.0}, 0.0, 0
    for k, w in want.items():
        d = (got[k] - w).abs().float()
        scale = 1 + w.abs().float()
        s = slack.of(k)
        s = torch.zeros_like(d) if s is None else s.reshape(d.shape)
        limit = tol * scale + s
        ok &= bool((d <= limit).all())
        q = s > 0
        n_quiet += int(q.sum())
        if (~q).any():
            is_weight = k in slack.sums
            worst[is_weight] = max(worst[is_weight],
                                   float((d / scale)[~q].max()))
        if q.any():
            quiet = max(quiet, float((d / limit)[q].max()))
    return ok, (f"where no gradient was at rounding level, weights "
                f"{worst[True]:.3e} and BN stats {worst[False]:.3e} x (1 + "
                f"|value|) apart (limit {tol}); {n_quiet} entries with a "
                f"rounding-level gradient at {quiet:.3f} of their limit (plus "
                f"lr a step)")


class _Runs:
    """While active: the Python-level forwards of modules of ``classes``
    (grad mode on: train, off: eval) and the CUDA graph replays. A kernel
    wrapper's count moves at a Python-level forward (an eager step, a
    warm-up run or a capture), not at a replay."""

    def __init__(self, *classes):
        self.classes = classes

    def __enter__(self):
        self.train = self.eval = self.replays = 0
        self.hook = torch.nn.modules.module.register_module_forward_pre_hook(
            self._seen)
        self.replay = torch.cuda.CUDAGraph.replay
        runs = self

        def replay(graph):
            runs.replays += 1
            return runs.replay(graph)

        torch.cuda.CUDAGraph.replay = replay
        return self

    def _seen(self, module, args):
        if isinstance(module, self.classes):
            if torch.is_grad_enabled():
                self.train += 1
            else:
                self.eval += 1

    def __exit__(self, *exc):
        self.hook.remove()
        torch.cuda.CUDAGraph.replay = self.replay


def _spun_ms(fn, reps: int = 3, spin: int = 50 * BUSY_CYCLES) -> float:
    """Median device ms of fn() between CUDA events, the device held busy
    (about 0.5 s) while the host enqueues it, with Python's garbage
    collector held off meanwhile (raises if the spin ends first)."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        gc.collect()
        gc.disable()
        try:
            torch.cuda._sleep(spin)
            start.record()
            fn()
            end.record()
            ended = start.query()
        finally:
            gc.enable()
        if ended:
            raise AssertionError("the device spin ended before the work was "
                                 "enqueued")
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _eager_step_ms(model, opt, sched, batch, mean: float, std: float,
                   reps: int = 3, loss_of=None) -> float:
    """Median device ms of one eager train step: its forward with the
    loss, its backward and its update (optimizer and schedule), each
    behind its own spin. An eager step enqueued behind a spin waits for
    the device once its backward follows its forward (phase 10 prints
    _waits), so one spin over a whole step cannot keep the host's enqueue
    out; its parts spun apart do not wait. loss_of(batch), when given, is
    the forward with the loss (a sharded step's)."""
    from hgnn2_torch.training import train

    held = {}

    def forward():
        model.train()
        opt.zero_grad(set_to_none=False)
        held["loss"] = (loss_of(batch) if loss_of is not None else
                        train._loss_and_metrics(
                            model(batch), batch.y, train._graph_mask(batch),
                            "regression", mean, std)[0])

    parts = (forward, lambda: held["loss"].backward(),
             lambda: (opt.step(), sched.step()))
    return float(np.median([sum(_spun_ms(p, reps=1) for p in parts)
                            for _ in range(reps)]))


def _waits(fn, spin: int = 50 * BUSY_CYCLES) -> tuple[bool, float]:
    """Whether the host waits for the device while it enqueues fn(): fn is
    called behind a device spin of about 0.5 s, with Python's garbage
    collector held off; if the spin has ended when fn returns, fn's host
    side waited for the device. Returns (waited, host ms of the call)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event()
    gc.collect()
    gc.disable()
    try:
        torch.cuda._sleep(spin)
        start.record()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        waited = start.query()
    finally:
        gc.enable()
    torch.cuda.synchronize()
    return waited, host_ms


def _max_rel(a: dict, b: dict) -> float:
    """max over entries of |a - b| / max |b| (dicts of tensors or numbers)."""
    return max(float((torch.as_tensor(a[k]).float().cpu()
                      - torch.as_tensor(v).float().cpu()).abs().max())
               / max(float(torch.as_tensor(v).abs().max()), 1e-30)
               for k, v in b.items())


def _state(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def phase_captured(dev, card: str) -> dict[str, int]:
    """The compiled-program counterparts as CUDA graphs, on the card, at
    full width: for each of PHASE10_MODELS, two epochs through
    make_scanned_epoch / run_epoch_scanned (one graph a step for each
    shape group, replayed) against the eager run_epoch over the same
    batches in the same order (groups_in_order, one default_rng(0) each),
    from the same weights: per-epoch metrics and the parameters after two
    epochs; evaluate_scanned against evaluate; the captured BN
    recalibration against the eager one; make_multi_train_step
    (n_inner=10, one graph) against 10 eager steps. Dense steps are held
    within DENSE_RTOL; the packed and CCN ones, whose index_add_ atomics
    round differently from run to run, within TRAIN_LOSS_RTOL (metrics)
    and, for the weights and stats, by _apart (the eager run of such a
    model also sums its _Slack). Times: host ms a step (epoch 2, host
    clock), device ms a step (a group's steps between CUDA events, the
    device held busy while the host enqueues them), the busy share
    (device over host, raising above BUSY_MAX), eager and replayed; the
    graphs, shape groups, capture seconds and the pool's bytes.
    Returns each kernel's launches in the captured runs (warm-up runs and
    captures; each replay runs the captured launches again)."""
    from hgnn2_torch.nn import ccn, models, packed
    from hgnn2_torch.training import optim, train

    counters = _counters()
    launches = dict.fromkeys(counters, 0)
    for name, arch, is_packed, n_layers, hidden, pair in PHASE10_MODELS:
        recs = _synthetic(N_TRAIN_MOLS if pair else N_MAIN_MOLS)
        cfg = (_train_cfg(arch, n_layers, str(dev), None) if pair else
               _main_cfg(str(dev), arch=arch, n_layers=n_layers,
                         n_features=hidden, packed=is_packed,
                         order=2 if arch == "lggnn" else 1))
        if pair:
            params = _flax_params(5, 2, n_layers, 2 if arch == "ccn1d" else 18,
                                  5)
        else:
            from hgnn2_torch.cli import common

            build = common.build_packed_model if is_packed else common.build_model
            params = _flax_variables(build(cfg, "regression", 5), 9)
        t0 = time.perf_counter()
        model, opt, sched, batches, mean, std = _train_setup(cfg, params,
                                                             str(dev), recs)
        twin = copy.deepcopy(model)
        topt, tsched = optim.build_optimizer(cfg.optim, len(batches),
                                             twin.parameters())
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        bs = cfg.batch_size
        classes = (ccn.CCN1D, ccn.CCN2D, models.GNNSimple, models.GNNLineGraph,
                   packed.PackedGNN)

        # captured: the main path of this phase
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        peak0 = torch.cuda.max_memory_allocated()
        groups = train.group_stacked_batches(batches)
        scan_fn = train.make_scanned_epoch(model, opt, sched, "regression",
                                           mean, std)
        rng = np.random.default_rng(0)
        hist_c, host_c = [], []
        with _Runs(*classes) as runs:
            _zero(counters)
            for _ in range(TRAIN_EPOCHS):
                t0 = time.perf_counter()
                hist_c.append(train.run_epoch_scanned(groups, scan_fn, rng))
                host_c.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            got = _read(counters)
        for k, n in got.items():
            launches[k] += n
        graphs = scan_fn.graphs
        mem1 = torch.cuda.memory_allocated()
        peak1 = torch.cuda.max_memory_allocated()

        # eager, the same order from the same weights
        n_steps = len(batches)
        dense = not (pair or is_packed)
        lists = train.group_batches(batches)
        rng = np.random.default_rng(0)
        slack = _Slack(twin, tsched)
        step_e = None if dense else slack.step_fn(
            lambda b: train.train_step(twin, topt, tsched, b, "regression",
                                       mean, std))
        hist_e, host_e = [], []
        for _ in range(TRAIN_EPOCHS):
            t0 = time.perf_counter()
            hist_e.append(train.run_epoch(twin, topt, tsched,
                                          train.groups_in_order(lists, rng),
                                          "regression", mean, std,
                                          step_fn=step_e))
            host_e.append(time.perf_counter() - t0)

        rtol = DENSE_RTOL if dense else TRAIN_LOSS_RTOL
        met_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                      for a, b in zip(hist_c, hist_e) for k in b)
        sc, se = _state(model), _state(twin)
        par_err = max(_max_rel({k: sc[k]}, {k: v}) for k, v in se.items())
        par_abs = max(float((sc[k] - v).abs().max()) for k, v in se.items())
        bit_equal = all(torch.equal(sc[k], v) for k, v in se.items())
        tol = (ATOMIC_TOL_BN if next(model.buffers(), None) is not None
               else ATOMIC_TOL)
        par_ok, apart = ((par_err <= DENSE_RTOL, f"tolerance {DENSE_RTOL} "
                          "relative") if dense else _apart(sc, se, slack, tol))
        print(f"  {name}: {len(groups)} shape group(s) of {[train._group_size(g) for g in groups]} "
              f"steps of {bs} molecules, set-up {setup_s:.2f} s; captured vs "
              f"eager from the same weights and order, {TRAIN_EPOCHS} epochs: "
              f"losses {[(round(a['loss'], 6), round(b['loss'], 6)) for a, b in zip(hist_c, hist_e)]}, "
              f"epoch metrics max rel err {met_err:.3e} (tolerance {rtol}), "
              f"parameters and buffers max err / max |value| {par_err:.3e}, "
              f"max abs err {par_abs:.3e} ({apart}); bit-equal {bit_equal}")
        if met_err > rtol or not par_ok:
            raise AssertionError(f"{name}: captured and eager epochs disagree")

        # launches: Python-level at the warm-ups and captures, replays apart
        per_fwd = {"K1": n_layers, "K3": n_layers, "K2": n_layers - 1,
                   "K4": n_layers - 1}
        want = _want(counters)
        for k in pair:
            want[k] = per_fwd[k] * (runs.train if k in ("K2", "K4")
                                    else runs.train + runs.eval)
        replayed = {k: per_fwd[k] * runs.replays for k in pair}
        print(f"  {name}: captured run: {len(graphs.graphs)} graph(s), "
              f"{graphs.replays} replays ({runs.replays} seen; "
              f"{TRAIN_EPOCHS} x {n_steps} steps), {runs.train} Python-level "
              f"train forwards (warm-up runs and captures); kernel launches "
              f"counted {got} (expected {want}); launches replayed "
              f"(replays x kernels a graph) {replayed}")
        if got != want or not (graphs.replays == runs.replays
                                == TRAIN_EPOCHS * n_steps):
            raise AssertionError(f"{name}: launches {got} != {want} or "
                                 f"replays {runs.replays}")

        # times, with the card's name and power limit in the run's header
        big = max(range(len(groups)), key=lambda g: train._group_size(groups[g]))
        stacked, n_big = groups[big], train._group_size(groups[big])
        dev_c = _spun_ms(lambda: scan_fn(stacked, np.arange(n_big))) / n_big
        dev_e = _eager_step_ms(twin, topt, tsched, lists[big][0], mean, std)
        wait_c = _waits(lambda: scan_fn(stacked, np.arange(n_big)))
        wait_e = _waits(lambda: train.train_step(
            twin, topt, tsched, lists[big][0], "regression", mean, std))
        hc = host_c[-1] / n_steps * 1e3
        he = host_e[-1] / n_steps * 1e3
        print(f"  {name} on {card}: replayed {hc:.3f} ms/step host "
              f"(epoch 2), {dev_c:.3f} ms/step device, busy "
              f"{dev_c / hc * 100:.1f} %; eager {he:.3f} ms/step "
              f"host, {dev_e:.3f} ms/step device, busy "
              f"{dev_e / he * 100:.1f} %; epoch 2 {host_c[-1]:.4f} s vs "
              f"{host_e[-1]:.4f} s ({n_steps * bs / host_c[-1]:.1f} vs "
              f"{n_steps * bs / host_e[-1]:.1f} molecules/s); "
              f"enqueued behind a 0.5 s device spin, {n_big} replayed "
              f"steps took {wait_c[1]:.1f} ms of host and waited for the "
              f"device: {wait_c[0]}; one eager step {wait_e[1]:.1f} ms, "
              f"waited: {wait_e[0]}")
        if max(dev_c / hc, dev_e / he) > BUSY_MAX:
            raise AssertionError(f"{name}: device ms a step above the host's")
        print(f"  {name}: captures {graphs.capture_s:.3f} s (warm-up runs "
              f"included), pool {graphs.pool_bytes / 2**20:.1f} MiB (its "
              f"segments after the epochs' captures); device "
              f"memory allocated {mem0 / 2**20:.1f} -> {mem1 / 2**20:.1f} MiB, "
              f"peak {peak0 / 2**20:.1f} -> {peak1 / 2**20:.1f} MiB")

        # eval and BN recalibration, captured against eager, same weights
        ev_c = train.evaluate_scanned(groups, train.make_scanned_eval(
            model, "regression", mean, std))
        ev_e = train.evaluate(model, batches, "regression", mean, std)
        ev_err = max(abs(ev_c[k] - v) / abs(v) for k, v in ev_e.items())
        recal = copy.deepcopy(model)
        train.recalibrate_bn(model, groups=groups)
        train.recalibrate_bn(recal, loader=batches)
        bn_err = max((_max_rel({k: v}, {k: b}) for (k, v), b in zip(
            _state(model).items(), _state(recal).values())
            if k.endswith((".mean", ".std"))), default=0.0)
        print(f"  {name}: evaluate_scanned vs evaluate {ev_err:.3e} "
              f"(tolerance {DENSE_RTOL}); recalibrate_bn(groups=) vs the "
              f"eager pass, max err / max |stat| {bn_err:.3e} (tolerance "
              f"{BN_RECAL_RTOL}{'; no BN' if pair else ''})")
        if ev_err > DENSE_RTOL or bn_err > BN_RECAL_RTOL:
            raise AssertionError(f"{name}: captured eval or recalibration "
                                 "disagrees")

        # n_inner steps in one graph against as many eager steps
        one, ten = copy.deepcopy(model), copy.deepcopy(model)
        runs_ = []
        for m, multi in ((one, True), (ten, False)):
            o, s = optim.build_optimizer(cfg.optim, len(batches), m.parameters())
            if multi:
                train.make_multi_train_step(m, o, s, "regression", mean, std,
                                            MULTI_INNER)(batches[0])
            else:
                slack = _Slack(m, s)
                step = slack.step_fn(lambda b: train.train_step(
                    m, o, s, b, "regression", mean, std))
                for _ in range(MULTI_INNER):
                    step(batches[0])
            runs_.append(_state(m))
        multi_err = max(_max_rel({k: runs_[0][k]}, {k: v})
                        for k, v in runs_[1].items())
        multi_abs = max(float((runs_[0][k] - v).abs().max())
                        for k, v in runs_[1].items())
        multi_ok, apart = ((multi_err <= DENSE_RTOL, f"tolerance {DENSE_RTOL} "
                            "relative") if dense
                           else _apart(runs_[0], runs_[1], slack, tol))
        print(f"  {name}: make_multi_train_step(n_inner={MULTI_INNER}) vs "
              f"{MULTI_INNER} eager steps: max err / max |value| "
              f"{multi_err:.3e}, max abs err {multi_abs:.3e} ({apart})")
        if not multi_ok:
            raise AssertionError(f"{name}: the multi-step graph disagrees")
        del model, twin, groups, batches, one, ten, recal, scan_fn, graphs
        torch.cuda.empty_cache()
    return launches


# phase 11's runs: (name, arch, model fields, edge_shards, dp, flax seed)
PHASE11_RUNS = (
    ("PackedGNN L=15 h=1 J=1, 4 shards", "gnn", {}, 4, 1, 21),
    ("PackedGNN L=15 h=1 J=1, 2 dp x 2 shards", "gnn", {}, 2, 2, 22),
    ("PackedLGGNN L=5 h=1 J=1 order 2, 4 shards", "lggnn",
     dict(n_layers=5, order=2), 4, 1, 23),
    ("CCN1D L=20 h=2, 4 shards", "ccn1d", {}, 4, 1, 24),
    ("CCN2D L=2 h=2, 4 shards", "ccn2d", {}, 4, 1, 25),
)
CCN_LAYERS = {"ccn1d": 20, "ccn2d": 2}
CCN_PAIRS = {"ccn1d": ("K1", "K2"), "ccn2d": ("K3", "K4")}


def _sharded_cfg(arch: str, model_kw: dict, es: int, dp: int, device: str,
                 log_path: str | None = None):
    """Phase 11's configuration: phase 8's packed models at 2,048
    molecules a step, or phase 4's CCN models (h = 2, 1,024 a step) with
    the kernels asked for, over dp x es molecule-aligned shards."""
    if arch in CCN_LAYERS:
        cfg = _train_cfg(arch, CCN_LAYERS[arch], device, log_path)
        cfg.model.ccn_kernel = True
    else:
        cfg = _main_cfg(device, log_path, arch=arch, packed=True, **model_kw)
    cfg.edge_shards, cfg.dp = es, dp
    return cfg


def _sharded_params(cfg, seed: int, F_in: int) -> dict:
    from hgnn2_torch.cli import common

    if cfg.model.arch in CCN_LAYERS:
        return _flax_params(F_in, 2, cfg.model.n_layers,
                            2 if cfg.model.arch == "ccn1d" else 18, seed)
    return _flax_variables(common.build_packed_model(cfg, "regression", F_in),
                           seed)


class _Sharded:
    """fit_sharded's pieces on ``device``, from the flax params: the
    model (its BN over the grid's axes), the optimizer and schedule, the
    train split's sharded loader (shuffling with the run's seed), the
    sharded step, the axes, mean and std."""

    def __init__(self, cfg, params, device, records, loader=None):
        from hgnn2_torch import convert
        from hgnn2_torch.cli import common
        from hgnn2_torch.data import stats, synthetic
        from hgnn2_torch.parallel import spmd
        from hgnn2_torch.training import optim, sharded

        ts = stats.compute_target_stats(records)
        self.mean, self.std = float(ts.mean[0]), float(ts.std[0])
        self.train_recs = synthetic.split_80_10_10(records, seed=cfg.seed)[0]
        n_data = max(cfg.dp, 1)
        self.axes = spmd.AXES if n_data > 1 else ("edge",)
        self.lead = len(self.axes)
        F_in = records[0].x.shape[1]
        self.is_ccn = cfg.model.arch in CCN_LAYERS
        if self.is_ccn:
            self.model = common.build_model(cfg, "regression", F_in)
            self.model.load_state_dict(convert.ccn_params_from_flax(params))
            cls = sharded.ShardedCCNLoader
        else:
            self.model = common.build_packed_model(
                cfg, "regression", F_in,
                bn_axis=self.axes if n_data > 1 else "edge")
            self.model.load_state_dict(convert.packed_variables_from_flax(params))
            cls = sharded.ShardedPackedLoader
        self.model.to(device)
        self.loader = loader or cls(self.train_recs, cfg.batch_size,
                                    cfg.edge_shards, task=0, shuffle=True,
                                    seed=cfg.seed, n_data=n_data, device=device)
        self.opt, self.sched = optim.build_optimizer(
            cfg.optim, len(self.loader), self.model.parameters())
        self.grid = spmd.RankGrid(n_data, cfg.edge_shards, device)
        self.step, _ = sharded.make_sharded_step_fns(
            self.model, self.grid, self.opt, self.sched, "regression",
            self.mean, self.std, self.axes)

    def eager(self, stacked) -> tuple:
        """One eager sharded step and its schedule step: (num, den)."""
        out = self.step.body(stacked)
        self.sched.step()
        return out

    def loss_of(self, stacked):
        """The sharded forward's loss, for _eager_step_ms."""
        from hgnn2_torch.parallel import spmd
        from hgnn2_torch.training import sharded

        batch = spmd.flatten_shards(stacked, self.lead)
        num, den = sharded._local_metric_sums(
            self.model(batch), batch, batch.n_graphs // stacked.gmask.shape[
                self.lead], "regression", self.mean, self.std, self.axes)
        return num[0] / den.clamp_min(1.0)

    def first_steps(self) -> tuple:
        """CPU_STEPS eager steps over the first batches in deal order:
        each step's loss, the step-0 gradients and the BN stats after it."""
        losses, grads, stats = [], None, None
        for stacked in self.loader.batches()[:CPU_STEPS]:
            num, den = self.eager(stacked)
            losses.append(float(num[0] / den.clamp_min(1.0)))
            if grads is None:
                grads = {n: p.grad.detach().cpu().clone()
                         for n, p in self.model.named_parameters()}
                stats = {n: b.detach().cpu().clone()
                         for n, b in self.model.named_buffers()}
        return losses, grads, stats


def _grads_of(model, loss) -> tuple:
    """(loss, gradients, BN stats) after loss.backward() from zeroed
    gradients."""
    loss.backward()
    return ([float(loss.detach())],
            {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()},
            {n: b.detach().cpu().clone() for n, b in model.named_buffers()})


def _against_unsharded(name: str, cfg, params, records, dev) -> None:
    """The first sharded minibatch's step against the unsharded model's
    on one batch of the same molecules, from the same weights on the
    card: the loss, the gradients and the BN stats the step leaves."""
    from hgnn2_torch import convert, graphs
    from hgnn2_torch.cli import common
    from hgnn2_torch.nn import ccn
    from hgnn2_torch.training import train

    sh = _Sharded(cfg, params, dev, records)
    chunk = sh.train_recs[:cfg.batch_size]  # the loader's first minibatch
    F_in = records[0].x.shape[1]
    if sh.is_ccn:
        model = common.build_model(cfg, "regression", F_in)
        model.load_state_dict(convert.ccn_params_from_flax(params))
        batch = ccn.make_ccn_batch(chunk, k_max=sh.loader.k_max, task=0,
                                   device=dev)
    else:
        model = common.build_packed_model(cfg, "regression", F_in)
        model.load_state_dict(convert.packed_variables_from_flax(params))
        batch = graphs.make_packed_batch(chunk, task=0, device=dev)
    model.to(dev).train()
    sh.model.train()
    want = _grads_of(model, train._loss_and_metrics(
        model(batch), batch.y, batch.gmask, "regression", sh.mean, sh.std)[0])
    got = _grads_of(sh.model, sh.loss_of(sh.loader.batches()[0]))
    _hold_steps(name, got, want, 0.0 if sh.is_ccn else GRAD_FLOOR,
                "sharded", "unsharded on the same molecules")


def phase_sharded(dev, card: str) -> dict[str, int]:
    """Molecule-aligned sharded training (--edge_shards, --dp M
    --edge_shards N) on the card at full width, every rank on it: each
    of PHASE11_RUNS through cli.common.run_experiment from seeded
    flax-layout weights (the main path of this phase; the CCN runs with
    --ccn_kernel, whose K1-K4 launch counts are held to the layers x the
    Python-level forwards), then, apart from it: the first steps against
    the CPU's sharded run, the first step against the unsharded model's
    on the same molecules, two epochs of make_sharded_scan_epoch (one
    replayed graph a step) against eager sharded steps in the same order
    under phase 10's rules, for CCN the kernels' steps against the plain
    path's on the card; host and device ms a step, the busy share and
    molecules/s, eager and replayed; the flattened capacities against
    the unsharded batch's. Returns each kernel's launches in the
    run_experiment runs."""
    from hgnn2_torch.cli import common
    from hgnn2_torch.data import batching
    from hgnn2_torch.nn import ccn, packed
    from hgnn2_torch.training import sharded

    counters = _counters()
    launches = dict.fromkeys(counters, 0)
    t_phase = time.perf_counter()
    for name, arch, model_kw, es, dp, seed in PHASE11_RUNS:
        is_ccn = arch in CCN_LAYERS
        records = _synthetic(N_TRAIN_MOLS if is_ccn else N_MAIN_MOLS)
        F_in = records[0].x.shape[1]
        cfg = _sharded_cfg(arch, model_kw, es, dp, str(dev),
                           os.path.join(OUT_DIR, f"sharded{seed}"))
        params = _sharded_params(cfg, seed, F_in)
        n_train = int(0.8 * len(records))
        steps = -(-n_train // cfg.batch_size)
        _zero(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _Runs(ccn.CCN1D, ccn.CCN2D, packed.PackedGNN,
                   packed.PackedLGGNN) as runs:
            model, history = common.run_experiment(cfg, init_params=params)  # the main path
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = _read(counters)
        for k, n in got.items():
            launches[k] += n
        want = _want(counters)
        if is_ccn:
            fwd, bwd = CCN_PAIRS[arch]
            L = cfg.model.n_layers
            want[fwd] = L * (runs.train + runs.eval)
            want[bwd] = (L - 1) * runs.train
        losses = [(row["train_loss"], row["valid_loss"], row["test_loss"])
                  for row in history]
        print(f"  {name}: run_experiment, {TRAIN_EPOCHS} epochs x {steps} "
              f"steps of {cfg.batch_size} molecules, {secs:.2f} s host clock "
              f"on {card} (batch builds included); (train, valid, test) loss "
              f"per epoch {losses}; launches {got} (expected {want}: "
              f"{runs.train} train and {runs.eval} eval Python-level "
              f"forwards); {runs.replays} graph replays (expected "
              f"{TRAIN_EPOCHS * steps}, one a step)")
        finite = all(np.isfinite(v) for row in history for v in row.values())
        if len(history) != TRAIN_EPOCHS or not finite:
            raise AssertionError(f"{name}: training history not finite: {history}")
        if got != want or runs.replays != TRAIN_EPOCHS * steps:
            raise AssertionError(f"{name}: launches {got} != {want} or "
                                 f"{runs.replays} replays")
        if is_ccn and not model.kernel:
            raise AssertionError(f"{name}: --ccn_kernel did not reach the model")

        # the first steps, card against the CPU's sharded run
        card_run = _Sharded(cfg, params, dev, records)
        cpu_cfg = dataclasses.replace(cfg, device="cpu", model=dataclasses.replace(
            cfg.model))
        _hold_steps(name, card_run.first_steps(),
                    _Sharded(cpu_cfg, params, "cpu", records).first_steps(),
                    0.0 if is_ccn else GRAD_FLOOR)
        if is_ccn:  # the kernels' steps against the plain path's, on the card
            plain = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, ccn_kernel=False))
            _hold_steps(name, _Sharded(cfg, params, dev, records,
                                       card_run.loader).first_steps(),
                        _Sharded(plain, params, dev, records,
                                 card_run.loader).first_steps(), 0.0,
                        "kernels", "plain path")
        _against_unsharded(name, cfg, params, records, dev)

        # two epochs replayed against eager, the same order, same weights
        run = _Sharded(cfg, params, dev, records, card_run.loader)
        twin = _Sharded(cfg, params, dev, records, card_run.loader)
        loader = run.loader
        orders = [loader.epoch_order() for _ in range(TRAIN_EPOCHS)]
        stack_batches, scan = sharded.make_sharded_scan_epoch(
            run.step, run.grid, run.axes)
        stacked_all = stack_batches(loader.batches())
        hist_c, host_c = [], []
        for order in orders:
            t0 = time.perf_counter()
            hist_c.append({k: float(v) for k, v in
                           scan(stacked_all, order).items()})
            host_c.append(time.perf_counter() - t0)
        slack = _Slack(twin.model, twin.sched)
        step_e = slack.step_fn(twin.eager)
        hist_e, host_e = [], []
        for order in orders:
            t0 = time.perf_counter()
            sums = [step_e(loader.batches()[i]) for i in order]
            num = torch.stack([n for n, _ in sums])
            den = torch.stack([d for _, d in sums])
            loss = num[:, 0] / den.clamp_min(1.0)
            mae = num[:, 1] / den.clamp_min(1.0)
            total = den.sum().clamp_min(1.0)
            hist_e.append({"loss": float((loss * den).sum() / total),
                           "mae": float((mae * den).sum() / total)})
            host_e.append(time.perf_counter() - t0)
        met_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                      for a, b in zip(hist_c, hist_e) for k in b)
        tol = ATOMIC_TOL if is_ccn else ATOMIC_TOL_BN
        ok, apart = _apart(_state(run.model), _state(twin.model), slack, tol)
        print(f"  {name}: replayed vs eager sharded steps from the same "
              f"weights and order, {TRAIN_EPOCHS} epochs: losses "
              f"{[(round(a['loss'], 6), round(b['loss'], 6)) for a, b in zip(hist_c, hist_e)]}, "
              f"epoch metrics max rel err {met_err:.3e} (tolerance "
              f"{TRAIN_LOSS_RTOL}); {apart}")
        if met_err > TRAIN_LOSS_RTOL or not ok:
            raise AssertionError(f"{name}: replayed and eager sharded steps "
                                 "disagree")

        # times and capacities
        n_steps = len(loader)
        dev_c = _spun_ms(lambda: scan(stacked_all, np.arange(n_steps))) / n_steps
        first = loader.batches()[0]
        dev_e = _eager_step_ms(twin.model, twin.opt, twin.sched, first,
                               twin.mean, twin.std, loss_of=twin.loss_of)
        hc, he = host_c[-1] / n_steps * 1e3, host_e[-1] / n_steps * 1e3
        print(f"  {name} on {card}: replayed {hc:.3f} ms/step host (epoch 2), "
              f"{dev_c:.3f} ms/step device, busy {dev_c / hc * 100:.1f} %, "
              f"{n_train / host_c[-1]:.1f} molecules/s; eager {he:.3f} ms/step "
              f"host, {dev_e:.3f} ms/step device, busy "
              f"{dev_e / he * 100:.1f} %, {n_train / host_e[-1]:.1f} "
              f"molecules/s; {len(scan.graphs.graphs)} graph, captured in "
              f"{scan.graphs.capture_s:.3f} s")
        if max(dev_c / hc, dev_e / he) > BUSY_MAX:
            raise AssertionError(f"{name}: device ms a step above the host's")
        n_ranks = es * max(dp, 1)
        train_recs = run.train_recs
        if is_ccn:
            ub = next(iter(batching.CCNLoader(train_recs, cfg.batch_size,
                                              task=0, device="cpu")))
            caps = (f"flattened {n_ranks} x {loader.vertex_capacity} = "
                    f"{n_ranks * loader.vertex_capacity} vertices (K = "
                    f"{loader.k_max}) against the unsharded CCNLoader batch's "
                    f"{ub.x.shape[0]} (K = {ub.nbr.shape[1]})")
        else:
            ub = next(iter(batching.PackedLoader(train_recs, cfg.batch_size,
                                                 task=0, device="cpu")))
            caps = (f"flattened {n_ranks} x {loader.node_capacity} = "
                    f"{n_ranks * loader.node_capacity} nodes and {n_ranks} x "
                    f"{loader.edge_capacity} = {n_ranks * loader.edge_capacity}"
                    f" edges against the unsharded PackedLoader batch's "
                    f"{ub.num_node_slots} nodes and {ub.num_edge_slots} edges")
        print(f"  {name}: {caps}; {n_ranks} x {loader.graphs_per_shard} graph "
              f"slots for {cfg.batch_size} molecules")
        del model, card_run, run, twin, stacked_all, scan
        torch.cuda.empty_cache()
    print(f"  phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return launches


DP_RANKS = 2  # phase 12 (a): --dp 2 in one process
MH_ARGV = ["--processes", "2", "--local_ranks", "2", "--steps", "3",
           "--device", "cuda", "--backend", "gloo", "--layers", "5",
           "--features", "1", "--dp_molecules", "1024", "--edge_molecules",
           "256", "--hybrid_molecules", "256", "--timeout", "240"]
MH_RTOL = 1e-4  # dry run against the control: losses, grads x max |grad|


def _history_err(got: list, want: list) -> float:
    """max relative difference of two histories' metrics (times apart)."""
    if len(got) != len(want) or any(a.keys() != b.keys()
                                    for a, b in zip(got, want)):
        raise AssertionError(f"histories of other shapes: {got} vs {want}")
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
               for a, b in zip(got, want) for k in b if k != "epoch_time_s")


def _dry_run_vs_control(out: str, args, dev, card: str) -> None:
    """Each phase of the dry run (its records under ``out``) against the
    same phase run in this process over the global data (the control):
    every process's losses within MH_RTOL relative, its step-0 gradients
    within MH_RTOL x the control's max |grad|; host ms a step and the
    cross-process all-reduces a step."""
    from hgnn2_torch.scripts import dryrun_multihost as dry

    for phase in dry.PHASES:
        ctrl = dry.control(phase, args, dev)
        recs = [torch.load(os.path.join(out, f"{phase}_{p}.pt"),
                           weights_only=False) for p in range(args.processes)]
        top = max(float(g.abs().max()) for g in ctrl["grads"].values())
        loss_err = max(abs(a - b) / abs(b) for r in recs
                       for a, b in zip(r["losses"], ctrl["losses"]))
        grad_err = max(float((r["grads"][k] - g).abs().max()) / top
                       for r in recs for k, g in ctrl["grads"].items())
        comm = recs[0]["comm"]
        print(f"  dry run {phase}: losses {[r['losses'] for r in recs]} vs "
              f"the control's {ctrl['losses']} (one process, every rank on "
              f"{card}): max rel loss err {loss_err:.3e}, step-0 gradients max "
              f"err / max |grad| {grad_err:.3e} (tolerance {MH_RTOL} each); "
              f"host ms a step {[round(r['host_ms'], 3) for r in recs]} "
              f"(control {ctrl['host_ms']:.3f}); a step crosses processes in "
              f"{comm['psum_calls']:g} psum all-reduces ({comm['psum_bytes']:g}"
              f" B) and {comm['grad_calls']:g} gradient sum "
              f"({comm['grad_bytes']:g} B)")
        if loss_err > MH_RTOL or grad_err > MH_RTOL:
            raise AssertionError(f"dry run {phase}: the processes disagree "
                                 "with the single-process control")


def phase_dp(dev, card: str) -> dict[str, int]:
    """Data parallelism. (a) In one process: GNNSimple(L=15, h=1, J=1)
    through cli.common.run_experiment with --dp 2 (phase 10's molecules,
    2,048 a step; the batches split over 2 ranks of the card) against
    --dp 1 from the same seeded flax-layout weights: histories within
    TRAIN_LOSS_RTOL, both replaying CUDA graphs. (b) Over processes:
    hgnn2_torch.scripts.dryrun_multihost with 2 processes sharing the card
    through gloo at full width (GNNLineGraph L=5 h=1 order 2 over 1,024
    molecules a process; PackedLGGNN L=5 h=1 over 2 processes x 2 ranks;
    the (2, 2) hybrid), each phase held to its single-process control on
    the card. Returns each kernel's launches in (a) and (b) (none run
    there)."""
    from hgnn2_torch.cli import common
    from hgnn2_torch.nn import models
    from hgnn2_torch.scripts import dryrun_multihost as dry

    counters = _counters()
    launches = dict.fromkeys(counters, 0)
    t_phase = time.perf_counter()
    F_in = _synthetic(N_MAIN_MOLS)[0].x.shape[1]
    params = None
    hist, replays = {}, {}
    for dp in (DP_RANKS, 1):
        cfg = _main_cfg(str(dev), os.path.join(OUT_DIR, f"dp{dp}"))
        cfg.dp = dp
        if params is None:
            params = _flax_variables(common.build_model(cfg, "regression",
                                                        F_in), 12)
        _zero(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _Runs(models.GNNSimple) as runs:
            model, hist[dp] = common.run_experiment(cfg, init_params=params)  # the main path
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for k, n in _read(counters).items():
            launches[k] += n
        replays[dp] = runs.replays
        steps = -(-int(0.8 * N_MAIN_MOLS) // cfg.batch_size)
        print(f"  --dp {dp}: run_experiment, {TRAIN_EPOCHS} epochs x {steps} "
              f"steps of {cfg.batch_size} molecules, {secs:.2f} s host clock "
              f"on {card}; epoch 2 {hist[dp][-1]['epoch_time_s'] / steps * 1e3:.3f}"
              f" ms a step host clock (evaluation included); "
              f"{runs.replays} graph replays")
        del model
    err = _history_err(hist[DP_RANKS], hist[1])
    print(f"  --dp {DP_RANKS} vs --dp 1 from the same weights: histories max "
          f"rel err {err:.3e} (tolerance {TRAIN_LOSS_RTOL}); replays "
          f"{replays}")
    if err > TRAIN_LOSS_RTOL or not replays[1] or replays[DP_RANKS] != replays[1]:
        raise AssertionError("--dp 2 and --dp 1 runs disagree")
    t_a = time.perf_counter() - t_phase

    torch.cuda.empty_cache()
    out = os.path.join(OUT_DIR, "multihost")
    t0 = time.perf_counter()
    dry.main(MH_ARGV + ["--out", out])  # exits non-zero if a child fails
    print(f"  dry run: {time.perf_counter() - t0:.1f} s host clock, 2 "
          f"processes on {card} through gloo")
    _dry_run_vs_control(out, dry.parse_args(MH_ARGV), dev, card)
    print(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s ((a) "
          f"{t_a:.1f} s)")
    return launches


HALO_NODES = 8192
HALO_RANKS = 4
HALO_LOSS_RTOL = 1e-5
HALO_GRAD_L2 = 1e-3  # gradients' relative L2 (JAX's halo bar)
HALO_SPMM_TOL = 1e-5
HALO_RUNS = (  # name, class, keywords, seed
    ("PackedLGGNN L=5 h=1 order 2", "PackedLGGNN",
     dict(n_features=1, n_layers=5, J=1, order=2), 13),
    ("PackedGNN L=15 h=1", "PackedGNN", dict(n_features=1, n_layers=15, J=1),
     14),
)


def _flat_grads(model) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1) for p in model.parameters()])


def _grad_step(model, loss_of) -> torch.Tensor:
    """loss_of() from zeroed gradients, and its backward."""
    model.zero_grad(set_to_none=False)
    loss = loss_of()
    loss.backward()
    return loss


def _grad_step_ms(model, loss_of, reps: int = 3) -> float:
    """Median device ms of _grad_step: its forward and its backward each
    behind its own spin (an eager backward enqueued behind the forward's
    spin waits for the device; _eager_step_ms)."""
    held = {}

    def forward():
        model.zero_grad(set_to_none=False)
        held["loss"] = loss_of()

    return float(np.median([
        _spun_ms(forward, reps=1)
        + _spun_ms(lambda: held["loss"].backward(), reps=1)
        for _ in range(reps)]))


def phase_halo(dev, card: str) -> dict[str, int]:
    """The halo exchange for one giant graph (HALO_NODES nodes) split over
    HALO_RANKS ranks on the card: halo_partitioned_spmm against
    sparse.spmm; PackedLGGNN L=5 and PackedGNN L=15 (h=1, seeded
    flax-layout weights) through halo_packed_loss against the
    unpartitioned model on the same weights (loss, gradients; both under
    deterministic algorithms, so index_add_'s atomics add no run-to-run
    noise to the comparison); the halo
    exchange's bytes against the all-reduce path's; device ms of a halo
    step (forward and backward) against the unpartitioned step. Returns
    each kernel's launches (none run here)."""
    from hgnn2_torch import convert, graphs, runtime
    from hgnn2_torch.nn import packed
    from hgnn2_torch.ops import sparse
    from hgnn2_torch.parallel import halo, spmd
    from hgnn2_torch.scripts import dryrun_multihost as dry

    counters = _counters()
    _zero(counters)
    t_phase = time.perf_counter()
    rec = dry.giant_record(HALO_NODES)
    node_cap, edge_cap = _packed_caps([rec])
    pb = graphs.make_packed_batch([rec], node_capacity=node_cap,
                                  edge_capacity=edge_cap, task=0, device=dev)
    t0 = time.perf_counter()
    bundle = halo.build_halo_lg_bundle(pb, HALO_RANKS, device=dev)
    build_s = time.perf_counter() - t0
    grid = spmd.RankGrid(1, HALO_RANKS, dev)
    print(f"  giant graph: {rec.n_nodes} nodes, {rec.n_dir_edges} directed "
          f"edges, {HALO_RANKS} halo ranks on {card}; halo tables built in "
          f"{build_s * 1e3:.1f} ms (host); halo sizes {bundle.halo_sizes} "
          f"against {bundle.nodes_per_shard} nodes a rank")

    V = pb.num_node_slots
    part = halo.build_halo_partition(pb.src.cpu().numpy(), pb.dst.cpu().numpy(),
                                     pb.w.cpu().numpy(), V, HALO_RANKS,
                                     device=dev)
    x = torch.randn(V, 16, generator=torch.Generator().manual_seed(0)).to(dev)
    got = halo.halo_partitioned_spmm(grid, part)(
        x.reshape(HALO_RANKS, V // HALO_RANKS, 16)).reshape(V, 16)
    err = _rel_err(got, sparse.spmm(pb.src, pb.dst, pb.w, x, V))
    print(f"  halo_partitioned_spmm (F = 16) vs sparse.spmm: max err / max "
          f"|value| {err:.3e} (tolerance {HALO_SPMM_TOL})")
    if err > HALO_SPMM_TOL:
        raise AssertionError("halo_partitioned_spmm disagrees with sparse.spmm")

    F_in = rec.x.shape[1]
    for name, cls_name, kw, seed in HALO_RUNS:
        cls = getattr(packed, cls_name)
        model = cls(in_features=F_in, bn_axis="edge", **kw)
        params = _flax_variables(model, seed)
        single = cls(in_features=F_in, **kw)
        for m in (model, single):
            m.load_state_dict(convert.packed_variables_from_flax(params))
            m.to(dev).train()
        log = halo.new_comm_log()
        loss_fn = halo.halo_packed_loss(model, grid, bundle, comm_log=log)

        def single_loss():
            per = spmd.per_graph_loss(single(pb), pb.y, "regression", 0.0, 1.0)
            return (per * pb.gmask).sum() / pb.gmask.sum().clamp_min(1.0)

        with runtime.deterministic() as refused:
            lh = float(_grad_step(model, loss_fn).detach())
            ls = float(_grad_step(single, single_loss).detach())
            gh, gs = _flat_grads(model), _flat_grads(single)
        print(f"  {name}: deterministic algorithms on; ops without a "
              f"deterministic CUDA form: {refused or 'none'}")
        loss_err = abs(lh - ls) / abs(ls)
        grad_err = float((gh - gs).norm() / gs.norm())
        hbytes = halo.halo_comm_bytes(log, bundle, HALO_RANKS)
        ops = spmd.PartitionedPackedOps(spmd.EdgeMesh([dev] * HALO_RANKS), pb,
                                        J=kw["J"])
        with torch.no_grad():
            single(pb, ops=ops)
        pbytes = ops.comm_bytes_per_step()
        ms_h = _grad_step_ms(model, loss_fn)
        ms_s = _grad_step_ms(single, single_loss)
        print(f"  {name}: halo loss {lh:.6f} vs unpartitioned {ls:.6f}, rel "
              f"err {loss_err:.3e} (tolerance {HALO_LOSS_RTOL}); gradients "
              f"rel L2 {grad_err:.3e} (tolerance {HALO_GRAD_L2}); exchanges a "
              f"forward {hbytes['n_node_halo_fwd']} node + "
              f"{hbytes['n_edge_halo_fwd']} edge halos, "
              f"{hbytes['train_step_bytes_per_chip']:,} B a train step a rank "
              f"against the all-reduce path's "
              f"{pbytes['train_step_bytes_per_chip']:,.0f} B "
              f"({hbytes['train_step_bytes_per_chip'] / pbytes['train_step_bytes_per_chip']:.3f}x);"
              f" device ms a step (forward and backward) halo {ms_h:.3f} vs "
              f"unpartitioned {ms_s:.3f}")
        if loss_err > HALO_LOSS_RTOL or grad_err > HALO_GRAD_L2:
            raise AssertionError(f"{name}: the halo step disagrees with the "
                                 "unpartitioned one")
        del model, single, ops
    torch.cuda.empty_cache()
    print(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return _read(counters)


# phase 14: scripts/exp_ccn_col.sh --k 2 at its widths, 4 steps an epoch
COL_ARGV = ["--k", "2", "--L", "2", "--h", "12", "--bs", "64", "--Nmax", "20",
            "--n", "320", "--epochs", "2"]
COL_CHUNKS = 4
CHUNK_RTOL = 1e-5  # --chunks 4 vs --chunks 1 on the card: every metric
XO_NODES, XO_GRAPHS = 64, 16  # the crossover graphs: K = 64, V = 1,024
XO_STEPS = 3  # optimizer steps in one replayed graph
XO_RTOL = 1e-4  # scan vs materialized: forward and gradients x max |value|


def _ccn2d_shapes() -> tuple[set, object]:
    """(the (V, K) of every CCN2D forward while the hook is on, the hook)."""
    from hgnn2_torch.nn import ccn

    shapes: set = set()

    def seen(module, args):
        if isinstance(module, ccn.CCN2D):
            shapes.add(tuple(args[0].nbr.shape))

    return shapes, torch.nn.modules.module.register_module_forward_pre_hook(
        seen)


def _xo_path(name: str, model, cb, dev, card: str) -> dict:
    """One path of phase 14 (b) on the crossover batch: the step-0 output
    and gradients (eager), then XO_STEPS optimizer steps in one replayed
    graph (make_multi_train_step) against as many eager steps of a twin
    (phase 10's rules); device ms a replayed step; the peak device memory
    of the eager step and the graph's warm-ups, capture and replay."""
    from hgnn2_torch.training import optim, train
    from hgnn2_torch.training.config import OptimConfig

    cfg = OptimConfig(optim="adamax", lr=1e-3)
    twin = copy.deepcopy(model)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model.zero_grad(set_to_none=True)
    out = model(cb)
    train._loss_and_metrics(out, cb.y, train._graph_mask(cb), "regression",
                            0.0, 1.0)[0].backward()
    # drop the step's autograd graph and gradients: an AccumulateGrad node
    # of the default stream kept alive breaks the graph's capture
    out = out.detach()
    grads = {k: p.grad for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    opt, sched = optim.build_optimizer(cfg, 100, model.parameters())
    multi = train.make_multi_train_step(model, opt, sched, "regression", 0.0,
                                        1.0, XO_STEPS)
    with _Runs() as runs:
        mets = multi(cb)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    replayed = _state(model)

    topt, tsched = optim.build_optimizer(cfg, 100, twin.parameters())
    slack = _Slack(twin, tsched)
    step = slack.step_fn(lambda b: train.train_step(twin, topt, tsched, b,
                                                    "regression", 0.0, 1.0))
    for _ in range(XO_STEPS):
        eager = step(cb)
    ok, apart = _apart(replayed, _state(twin), slack, ATOMIC_TOL)
    loss_err = abs(float(mets["loss"]) - float(eager["loss"])) / abs(
        float(eager["loss"]))
    ms = _spun_ms(lambda: multi(cb)) / XO_STEPS
    print(f"  {name}: {XO_STEPS} steps in one replayed graph ({runs.replays} "
          f"replay) vs {XO_STEPS} eager steps: last loss {float(mets['loss']):.6e}"
          f" vs {float(eager['loss']):.6e}, rel err {loss_err:.3e} (tolerance "
          f"{TRAIN_LOSS_RTOL}); {apart}; {ms:.3f} ms a step device (replayed) "
          f"on {card}; peak device memory {peak:,} B ({peak - base:,} B above "
          f"the {base:,} B allocated before the path)")
    if not ok or loss_err > TRAIN_LOSS_RTOL or runs.replays != 1:
        raise AssertionError(f"{name}: replayed and eager steps disagree")
    del multi, twin, opt, topt
    return {"out": out, "grads": grads, "ms": ms, "peak": peak}


def phase_high_degree(dev, card: str) -> dict[str, int]:
    """High-degree CCN-2D, where K > MAX_K and no kernel runs. (a) The
    reference recipe scripts/exp_ccn_col.sh --k 2 (K = 16, L = 2, h = 12,
    batch 64, Nmax 20, d = 5) through main_generate_ccn on 320 graphs (4
    steps an epoch, 2 epochs) with --chunks 1 and --chunks 4 on the card
    and on the CPU: the two card runs' histories within CHUNK_RTOL, each
    within TRAIN_LOSS_RTOL of its CPU run; K and V of the batches, epoch
    2's host ms a step, the peak device memory. (b) CCN2D(L=2, h=2,
    scan_promotion=True) against CCN2D() on the crossover graphs (16
    complete graphs of 64 nodes, hgnn2_torch/scripts/ccn_crossover.py),
    the same seeded weights: the step-0 output and gradients within
    XO_RTOL x max |value|, each path's replayed steps against its eager
    steps, ms a step and peak memory, the scan's peak below the
    materialized path's. Returns each kernel's launches (none may run)."""
    from hgnn2_torch.cli import main_generate_ccn
    from hgnn2_torch.nn import ccn
    from hgnn2_torch.scripts import ccn_crossover

    counters = _counters()
    _zero(counters)
    t_phase = time.perf_counter()
    hist = {}
    for chunks in (1, COL_CHUNKS):
        for where in ("card", "cpu"):
            argv = COL_ARGV + ["--chunks", str(chunks), "--device",
                               str(dev) if where == "card" else "cpu",
                               "--log_path", os.path.join(
                                   OUT_DIR, f"col_chunks{chunks}_{where}")]
            shapes, hook = _ccn2d_shapes()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                model, hist[chunks, where] = main_generate_ccn.main(argv)
            finally:
                hook.remove()
            secs = time.perf_counter() - t0
            if model.vertex_chunks != chunks or model.kernel:
                raise AssertionError(f"--chunks {chunks}: built {model}")
            if where == "cpu":
                print(f"  --chunks {chunks} on the CPU: {secs:.1f} s")
                continue
            steps = -(-int(0.8 * 320) // 64)
            print(f"  exp_ccn_col.sh --k 2 --chunks {chunks} on {card}: "
                  f"CCN2D L=2 h=12, batches (V, K) {sorted(shapes)}, "
                  f"{secs:.1f} s host clock for 2 epochs x {steps} steps; "
                  f"epoch 2 {hist[chunks, where][-1]['epoch_time_s'] / steps * 1e3:.3f}"
                  f" ms a step host clock (replayed, evaluation included); "
                  f"peak device memory {torch.cuda.max_memory_allocated():,} B")
            if max(k for _, k in shapes) != 16:
                raise AssertionError(f"the recipe's K is not 16: {shapes}")
            del model
    card_err = _history_err(hist[COL_CHUNKS, "card"], hist[1, "card"])
    cpu_err = [_history_err(hist[c, "card"], hist[c, "cpu"])
               for c in (1, COL_CHUNKS)]
    print(f"  --chunks {COL_CHUNKS} vs --chunks 1 on {card}: histories max rel "
          f"err {card_err:.3e} (tolerance {CHUNK_RTOL}); card vs CPU "
          f"{cpu_err[0]:.3e} and {cpu_err[1]:.3e} (tolerance "
          f"{TRAIN_LOSS_RTOL}); final {hist[COL_CHUNKS, 'card'][-1]}")
    if card_err > CHUNK_RTOL or max(cpu_err) > TRAIN_LOSS_RTOL:
        raise AssertionError("the exp_ccn_col.sh runs disagree")
    t_a = time.perf_counter() - t_phase

    recs = ccn_crossover.complete_graphs(XO_NODES, XO_GRAPHS)
    V = XO_NODES * XO_GRAPHS
    cb = ccn.make_ccn_batch(recs, vertex_capacity=V, device=dev)
    K = int(cb.nbr.shape[1])
    print(f"  crossover graphs: {XO_GRAPHS} complete graphs of {XO_NODES} "
          f"nodes, V = {V}, K = {K}; CCN2D L=2 h=2; the materialized T of "
          f"layer 1 alone {V * K ** 3 * 3 * 4:,} B")
    base = ccn.CCN2D(n_features=3, hidden=2, n_layers=2,
                     generator=torch.Generator().manual_seed(0))
    paths = {}
    for name, scan in (("materialized", False), ("scan", True)):
        model = ccn.CCN2D(n_features=3, hidden=2, n_layers=2,
                          scan_promotion=scan)
        model.load_state_dict(base.state_dict())
        paths[name] = _xo_path(f"K={K} {name}", model.to(dev), cb, dev, card)
        del model
    mat, scan = paths["materialized"], paths["scan"]
    out_err = _rel_err(scan["out"], mat["out"])
    grad_err = max(_rel_err(g, mat["grads"][k])
                   for k, g in scan["grads"].items())
    print(f"  K={K} scan vs materialized: step-0 output max err / max |value| "
          f"{out_err:.3e}, gradients {grad_err:.3e} (tolerance {XO_RTOL}); "
          f"ms a step {scan['ms']:.3f} vs {mat['ms']:.3f}; peak "
          f"{scan['peak']:,} vs {mat['peak']:,} B "
          f"({scan['peak'] / mat['peak']:.3f}x)")
    if out_err > XO_RTOL or grad_err > XO_RTOL:
        raise AssertionError("the scan path disagrees with the materialized "
                             "path")
    if scan["peak"] >= mat["peak"]:
        raise AssertionError("the scan path's peak memory is not below the "
                             "materialized path's")
    launches = _read(counters)
    if any(_ks(launches).values()):
        raise AssertionError(f"a kernel launched at K > 8: {launches}")
    del cb, paths, mat, scan
    torch.cuda.empty_cache()
    print(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s ((a) "
          f"{t_a:.1f} s); K1-K5 launches {launches}")
    return launches


# phase 15: the edge-partitioned and halo paths with one rank a process
PROC_ARGV = ["--device", "cuda", "--backend", "gloo", "--steps", "3",
             "--timeout", "300"]  # the widths: dryrun_multihost's defaults
PROC_RTOL = 1e-5  # process r's ring forwards vs the one-process control


PROC_SEEDS = {"ring": (5, 6), "psum_fallback": (5,),  # phase 5's seeds
              "halo_giant_graph": (13, 14)}  # phase 13's


def _proc_weights(out: str, argv: list) -> None:
    """The new phases' models' seeded flax-layout weights (phase 5's and
    13's recipe and seeds) as out/{phase}_{arch}.pt, for --weights."""
    from hgnn2_torch import convert
    from hgnn2_torch.data import qm9
    from hgnn2_torch.scripts import dryrun_multihost as dry

    args = dry.parse_args(argv)
    F_in = qm9.synthetic_qm9_like(1, seed=dry.PACKED_SEED)[0].x.shape[1]
    os.makedirs(out, exist_ok=True)
    for phase, seeds in PROC_SEEDS.items():
        specs = getattr(args, dry.MODEL_ARGS[phase])
        bn_axis = "edge" if phase == "halo_giant_graph" else None
        for spec, seed in zip(specs, seeds):
            model = dry.build_packed(phase, spec, args, F_in, bn_axis)
            torch.save(convert.packed_variables_from_flax(
                _flax_variables(model, seed)),
                os.path.join(out, f"{phase}_{spec.split(':')[0]}.pt"))


def _proc_runs(out: str, args, phase: str) -> list:
    return [torch.load(os.path.join(out, f"{phase}_{p}.pt"),
                       weights_only=False) for p in range(args.processes)]


def _hold_ring(recs, ctrl, S: int, card: str) -> int:
    """Phase ring's records against the one-process control (S ranks of
    an EdgeMesh on the card, K5 over them): every check bit-equal (held
    in the children), each model's train-mode and eval forwards within
    PROC_RTOL x max |pred| and its BN stats within SERVE_RTOL x max
    |stat|. Returns K5 across processes' launches in the model forwards."""
    checks = recs[0]["errs"]
    err = max(e for r in recs for e in r["errs"].values())
    print(f"  K5 across {S} processes: {len(checks)} checks a process "
          f"({', '.join(checks)}), each bit-equal to "
          f"ring_psum_reference(all parts)[r] and to the plain version: max "
          f"abs err {err:.3e} (tolerance 0)")
    if err != 0.0:
        raise AssertionError("K5 across processes disagrees with its plain "
                             "version")
    launches = 0
    for spec, c in ctrl["models"].items():
        stat_keys = [k for k in c["state"] if k.endswith((".mean", ".std"))]
        for p, r in enumerate(recs):
            m = r["models"][spec]
            launches += m["launches"]
            pe = max(_rel_err(m[k], c[k]) for k in ("train_out", "eval_out"))
            se = max(_rel_err(m["state"][k], c["state"][k]) for k in stat_keys)
            ok = pe <= PROC_RTOL and se <= SERVE_RTOL
            print(f"  {spec} ring S={S}, process {p} vs the one-process S={S} "
                  f"ring on {card}: forwards max err / max |pred| {pe:.3e} "
                  f"(tolerance {PROC_RTOL}), BN stats {se:.3e} (tolerance "
                  f"{SERVE_RTOL}); {m['launches']} launches for "
                  f"{m['n_allreduce']} all-reduces; eval forward "
                  f"{m['host_ms']:.3f} ms host clock (control "
                  f"{c['host_ms']:.3f})")
            if not ok:
                raise AssertionError(f"{spec}: process {p}'s ring forwards "
                                     "disagree with the one-process control")
    return launches


def _hold_steps_to(name: str, recs, ctrl, loss_tol: float, grad_l2: float
                   | None, card: str) -> None:
    """Each process's losses and step-0 gradients against the one-process
    control's: losses within loss_tol relative; the gradients within
    MH_RTOL x max |grad| or, given grad_l2, by relative L2."""
    for spec, c in ctrl["models"].items():
        for p, r in enumerate(recs):
            m = r["models"][spec]
            le = max(abs(a - b) / abs(b) for a, b in zip(m["losses"],
                                                          c["losses"]))
            got = torch.cat([m["grads"][k].reshape(-1) for k in c["grads"]])
            want = torch.cat([g.reshape(-1) for g in c["grads"].values()])
            if grad_l2 is None:
                ge, gtol = _rel_err(got, want), MH_RTOL
            else:
                ge, gtol = float((got - want).norm() / want.norm()), grad_l2
            comm = " ".join(f"{k} {v:g}" for k, v in m["comm"].items() if v)
            print(f"  {name} {spec}, process {p} vs one process on {card}: "
                  f"losses {m['losses']} vs {c['losses']}, max rel err "
                  f"{le:.3e} (tolerance {loss_tol}); step-0 gradients "
                  f"{'rel L2' if grad_l2 else 'max err / max |grad|'} "
                  f"{ge:.3e} (tolerance {gtol}); host ms a step "
                  f"{m['host_ms']:.3f} (control {c['host_ms']:.3f}); a step "
                  f"crosses processes in {comm}")
            if le > loss_tol or ge > gtol:
                raise AssertionError(f"{name} {spec}: process {p} disagrees "
                                     "with the one-process control")


def phase_processes(dev, card: str) -> dict:
    """F4, one rank a process: hgnn2_torch.scripts.dryrun_multihost's
    phases ring, psum_fallback and halo_giant_graph over RING_RANKS
    processes sharing the card through gloo, and ring over 2, each held
    to its one-process control on the card from the same seeded weights
    (phase 5's and 13's recipe and seeds; dryrun_multihost.control): K5 across processes bit-equal to its
    plain version on every process; the ring forwards within PROC_RTOL;
    the fallback's losses and step-0 gradients within MH_RTOL; the halo
    loss within HALO_LOSS_RTOL and its gradients' rel L2 within
    HALO_GRAD_L2. Prints K5 across processes' device ms alone, host ms a
    call, its bound, gloo's all_reduce and the one-device K5 on the same
    parts. Returns K5 across processes' row (launches: the children's
    model forwards)."""
    from hgnn2_torch.ops import ring
    from hgnn2_torch.scripts import dryrun_multihost as dry

    t_phase = time.perf_counter()
    row = dict(name="ring_reduce_rank (K5 across processes)", route="cuda",
               source="hgnn2_torch/ops/csrc/ring.cu",
               replaces="hgnn2_tpu/ops/pallas/ring.py:27", launches=0,
               max_abs_err=0.0)
    weights = os.path.join(OUT_DIR, "processes_weights")
    _proc_weights(weights, PROC_ARGV)
    for S, phases in ((RING_RANKS, list(dry.PROCESS_PHASES)), (2, ["ring"])):
        out = os.path.join(OUT_DIR, f"processes{S}")
        argv = PROC_ARGV + ["--processes", str(S), "--phases", *phases,
                            "--out", out, "--weights", weights]
        t0 = time.perf_counter()
        dry.main(argv)  # exits non-zero if a child fails
        print(f"  dry run {' '.join(phases)}: {time.perf_counter() - t0:.1f} "
              f"s host clock, {S} processes on {card} through gloo")
        args = dry.parse_args(argv)
        for phase in phases:
            recs, ctrl = _proc_runs(out, args, phase), dry.control(phase, args,
                                                                    dev)
            if phase == "ring":
                row["launches"] += _hold_ring(recs, ctrl, S, card)
            elif phase == "psum_fallback":
                _hold_steps_to(phase, recs, ctrl, MH_RTOL, None, card)
            else:
                _hold_steps_to(phase, recs, ctrl, HALO_LOSS_RTOL, HALO_GRAD_L2,
                               card)
        t = _proc_runs(out, args, "ring")[0]["timing"]
        n = t["n"]
        parts = dry.ring_inputs(S, (n // 16, 16), 7, dev)
        bound, by = _bound((S + 1) * n * 4, (S - 1) * n)
        card_bound, _ = _bound(S * (S + 1) * n * 4, S * (S - 1) * n)
        one_dev = _time_ms(lambda: ring.ring_psum(parts))
        print(f"  K5 across {S} processes, process 0 at ({n // 16}, 16): "
              f"kernel alone {t['kernel_ms']:.4f} ms device (CUDA events; "
              f"{t['kernel_ms_in_run']:.4f} ms a launch in a run of 100), a "
              f"whole call (copy, sync, barrier, launch) {t['call_host_ms']:.4f}"
              f" ms host clock; bound {bound:.5f} ms ({by}: (S+1)*n*4 = "
              f"{(S + 1) * n * 4} bytes a process), {card_bound:.5f} ms for "
              f"the card's S(S+1)*n*4 when the {S} processes share it; plain "
              f"version (gloo all_gather, ring_psum_reference) "
              f"{t['plain_host_ms']:.4f} ms host; library: gloo "
              f"dist.all_reduce of the CUDA tensor {t['library_host_ms']:.4f} "
              f"ms host; the one-device K5 (ring_psum) on the same {S} parts "
              f"{one_dev:.4f} ms device")
        if S == RING_RANKS:
            row.update(ms=t["kernel_ms"], ms_in_run=t["kernel_ms_in_run"],
                       plain_ms=t["plain_host_ms"], bound_ms=bound,
                       bound_by=by, library_ms=t["library_host_ms"])
    if not row["launches"]:
        raise AssertionError("K5 across processes launched no time")
    torch.cuda.empty_cache()
    print(f"  phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return row


# phase 16: the measurement harnesses of hgnn2_torch/scripts, cut in size
HARNESS_MOLS = 8192  # profile_lggnn and packed_crossover: 4 steps an epoch
CCN1D_PROFILE_ARGV = ["--molecules", "2048", "--sweep_h", "2", "8"]
SERVING_ARGV = ["--repeats", "10"]
CROSSOVER_HS = (1, 16)
PROFILE_MIN_KERNELS = 10  # distinct device kernels among the top 15
PROFILE_MIN_PER_STEP = 100  # kernel launches a replayed LGGNN step, above
PROFILE_BUSY = (0.5, 1.05)  # traced device time over the best epoch's host s
CCN_PATHS_RTOL = 1e-5  # first-step loss, kernel path vs plain path
KERNEL_CLASSES = (  # (class, lower-case substrings of a kernel's name)
    ("index_select", ("indexselect", "index_select")),
    ("index_add_", ("indexfunc", "index_add")),
    ("GEMM", ("gemm", "xmma", "cutlass", "cublas")),
    ("elementwise", ("elementwise",)),
    ("reduction", ("reduce",)),
)


def _kernel_class(name: str) -> str:
    low = name.lower()
    return next((c for c, keys in KERNEL_CLASSES
                 if any(k in low for k in keys)), "other")


def _class_shares(rows) -> str:
    """Each kernel class's share of the device time and of the launches
    among parse_kernel_stats' rows."""
    kernels = [r for r in rows if r["category"] == "kernel"]
    total_t = sum(r["total_time"] for r in kernels) or 1.0
    total_n = sum(r["occurrences"] for r in kernels) or 1
    shares = {}
    for r in kernels:
        t, n = shares.get(_kernel_class(r["op_name"]), (0.0, 0))
        shares[_kernel_class(r["op_name"])] = (t + r["total_time"],
                                               n + r["occurrences"])
    return ", ".join(f"{c} {100 * t / total_t:.1f} % of the time, "
                     f"{100 * n / total_n:.1f} % of the launches"
                     for c, (t, n) in sorted(shares.items(),
                                             key=lambda kv: -kv[1][0]))


def _dense_groups(records, bs: int, lg: bool) -> int:
    """Shape groups of DenseLoader(sort=True) batches, from the records'
    sizes: one a distinct (node bucket, edge bucket) of the sorted chunks
    (what tests/test_torch_packed_crossover.py holds to JAX)."""
    from hgnn2_torch.data import batching
    from hgnn2_torch.graphs import pad_to_bucket

    order = np.argsort([r.n_nodes for r in records], kind="stable")
    shapes = set()
    for lo in range(0, len(order), bs):
        chunk = [records[i] for i in order[lo:lo + bs]]
        shapes.add((pad_to_bucket(max(r.n_nodes for r in chunk),
                                  batching.DEFAULT_NODE_BUCKETS),
                    pad_to_bucket(max(r.n_dir_edges for r in chunk),
                                  batching.DEFAULT_EDGE_BUCKETS) if lg else 0))
    return len(shapes)


def _quiet(fn):
    """fn() with its standard output (a harness's JSON lines) kept out of
    this script's."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def _serving_after_profiler(argv) -> None:
    """bench_serving.main(argv) in a process whose first act on the card
    is a torch.profiler run with CUDA activity (phase 16's control for
    what a profiler leaves behind in a process)."""
    from torch.profiler import ProfilerActivity, profile

    from hgnn2_torch.scripts import bench_serving

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(4, device="cuda").add_(1).cpu()
    bench_serving.main(argv)


def phase_harnesses(dev, card: str, serve9: dict) -> dict[str, int]:
    """The measurement harnesses of hgnn2_torch/scripts through their
    main(argv), at reduced sizes: profile_lggnn (dense and packed at h=1
    over HARNESS_MOLS molecules, each traced epoch's table listing the
    replayed graphs' kernels, then the dense h sweep 1, 4); the main
    path's replayed GNNSimple L=15 step (phase 10's), 3 replays under
    profiling.trace: its top kernels, launches a step and kernel classes;
    profile_ccn1d (2,048 molecules, h sweep 2, 8): K1 and K2 launch on its
    kernel path and not on its plain path, whose first-step losses from
    the same weights agree; bench_serving in a fresh process, in a fresh
    process after a torch.profiler run (K3 launches in its CCN-2D bundle,
    counted by each child) and in this one, beside phase 9's rates
    (``serve9``); packed_crossover at h = 1 and 16 over
    HARNESS_MOLS molecules, one epoch (one scan group for every packed
    row with uniform capacities, the dense rows' groups from the records'
    sizes). Returns each kernel's launches, the child's included."""
    from unittest import mock

    from hgnn2_torch import profiling
    from hgnn2_torch.cli import common
    from hgnn2_torch.data import qm9, stats
    from hgnn2_torch.nn import ccn
    from hgnn2_torch.scripts import (bench_serving, packed_crossover,
                                     profile_ccn1d, profile_lggnn)
    from hgnn2_torch.scripts import profile_ccn1d_util as util
    from hgnn2_torch.training import train

    t_phase = time.perf_counter()
    out = os.path.join(OUT_DIR, "harnesses")
    counters = _counters()
    launches = dict.fromkeys(counters, 0)

    def counted(fn):
        got_out, got = _counted(counters, launches, lambda: _quiet(fn))
        return got_out, got

    # profile_lggnn: the traced epoch replays the step graphs
    lg_argv = ["--molecules", str(HARNESS_MOLS), "--out", out]
    for extra in ([], ["--packed"]):
        summary, got = counted(lambda: profile_lggnn.main(lg_argv + extra))
        n_kernels = sum(r["category"] == "kernel" for r in summary["top_ops"])
        busy = (summary["device_time_total_us"] / 1e6
                / summary["scanned_epoch_s"])
        print(f"  profile_lggnn {summary['layout']} h=1: "
              f"{summary['per_step_ms']:.3f} ms a step (best of 3 epochs of "
              f"{summary['steps_per_epoch']} steps, host clock), "
              f"{summary['n_kernels_per_step']:.1f} kernel launches a step "
              f"in the traced epoch, {n_kernels} kernels among its top 15, "
              f"device time {summary['device_time_total_us'] / 1e3:.3f} ms = "
              f"{100 * busy:.1f} % of the best epoch's host time on {card}; "
              f"top: " + "; ".join(
                  f"{r['op_name'][:60]} {r['total_time']:.0f} us x"
                  f"{r['occurrences']}" for r in summary["top_ops"][:5]))
        if (n_kernels < PROFILE_MIN_KERNELS
                or summary["n_kernels_per_step"] <= PROFILE_MIN_PER_STEP
                or not PROFILE_BUSY[0] <= busy <= PROFILE_BUSY[1]):
            raise AssertionError(f"profile_lggnn {summary['layout']}: the "
                                 "trace misses the replayed graphs' kernels")
        if any(_ks(got).values()):
            raise AssertionError(f"profile_lggnn launched {got}")
    sweep, _ = counted(lambda: profile_lggnn.main(
        lg_argv + ["--sweep_h", "1", "4"]))
    print("  profile_lggnn dense h sweep: " + ", ".join(
        f"h={r['h']} {r['per_step_ms']:.3f} ms a step (capture epoch "
        f"{r['compile_s']:.2f} s)" for r in sweep))
    if [r["h"] for r in sweep] != [1, 4] or not all(
            np.isfinite(r["loss"]) for r in sweep):
        raise AssertionError(f"profile_lggnn sweep: {sweep}")

    # the main path's replayed step, profiled
    cfg = _main_cfg(str(dev))
    params = _flax_variables(common.build_model(cfg, "regression", 5), 9)
    model, opt, sched, batches, mean, std = _train_setup(
        cfg, params, str(dev), _synthetic(N_MAIN_MOLS))
    same = max(train.group_batches(batches), key=len)[:3]
    stacked = train.group_stacked_batches(same)[0]
    scan_fn = train.make_scanned_epoch(model, opt, sched, "regression", mean,
                                       std)
    order = np.arange(len(same))
    _, got = _counted(counters, launches, lambda: scan_fn(stacked, order))
    with profiling.trace(os.path.join(out, "trace_gnn_simple")) as prof:
        sums = scan_fn(stacked, order)
        torch.cuda.synchronize()
    top, rows = util.parse_kernel_stats(prof)
    per_step = util.kernel_launches(rows) / len(same)
    dev_ms = sum(r["total_time"] for r in rows) / 1e3 / len(same)
    print(f"  GNNSimple L=15 h=1 (phase 10's replayed step, {MAIN_BS} "
          f"molecules, loss sum {float(sums['loss']):.4f}): {len(same)} "
          f"replays traced, {per_step:.1f} kernel launches a step, "
          f"{len({r['op_name'] for r in rows if r['category'] == 'kernel'})} "
          f"distinct kernels, {dev_ms:.3f} device ms a step on {card}; "
          f"{_class_shares(rows)}")
    for line in util.op_table("  top 15:", "", top, sum(
            r["total_time"] for r in rows), width=70)[4:]:
        print("   ", line)
    if per_step <= PROFILE_MIN_PER_STEP or any(_ks(got).values()):
        raise AssertionError(f"GNNSimple trace: {per_step} launches a step, "
                             f"{got}")
    del model, opt, sched, batches, stacked, scan_fn
    torch.cuda.empty_cache()

    # profile_ccn1d: K1 and K2 on the kernel path only
    findings, got = counted(lambda: profile_ccn1d.main(
        CCN1D_PROFILE_ARGV + ["--out", out]))
    share = {k: sum(r["total_time"] for r in findings["kernel_trace"]["top_ops"]
                    if f"ccn1d_{k}" in r["op_name"])
             / findings["kernel_trace"]["device_time_total_us_3steps"]
             for k in ("forward", "backward")}
    print(f"  profile_ccn1d: {findings['config']['V']} vertices, plain "
          f"{findings['step_ms']['xla']:.3f} ms a step, kernels "
          f"{findings['step_ms']['pallas_kernel']:.3f} "
          f"({findings['step_ms']['speedup']:.3f}x); K1 {100 * share['forward']:.1f} "
          f"% and K2 {100 * share['backward']:.1f} % of the kernel path's traced "
          f"device time; h sweep " + ", ".join(
              f"h={r['h']} {r['xla_ms']:.3f} / {r['kernel_ms']:.3f} ms"
              for r in findings["h_sweep"]) + f"; launches {got}")
    if not (got["K1"] and got["K2"]) or got["K3"] or got["K4"] or got["K5"]:
        raise AssertionError(f"profile_ccn1d launches {got}")
    records = qm9.synthetic_qm9_like(int(CCN1D_PROFILE_ARGV[1]), seed=0)
    ts = stats.compute_target_stats(records)
    cb = ccn.make_ccn_batch(records, task=0, device=dev)
    losses = {}
    for kernel in (False, True):
        def first_step():
            model = profile_ccn1d.make_model(cb, 2, 20, kernel)
            return float(profile_ccn1d.train_step(model, ts)(cb)["loss"])

        losses[kernel], got = _counted(counters, launches, first_step)
        _, got_ms = _counted(counters, launches, lambda: profile_ccn1d.step_ms(
            profile_ccn1d.make_model(cb, 2, 20, kernel), cb, ts, steps=2))
        moved = bool(got["K1"] and got["K2"] and got_ms["K1"] and got_ms["K2"])
        if moved != kernel or got["K3"] or got_ms["K3"]:
            raise AssertionError(f"profile_ccn1d kernel={kernel}: launches "
                                 f"{got}, {got_ms}")
    rel = abs(losses[True] - losses[False]) / abs(losses[False])
    print(f"  profile_ccn1d first-step loss, same weights: plain "
          f"{losses[False]:.7f}, kernels {losses[True]:.7f}, rel err "
          f"{rel:.3e} (tolerance {CCN_PATHS_RTOL})")
    if rel > CCN_PATHS_RTOL:
        raise AssertionError("profile_ccn1d: the paths' first steps disagree")

    # bench_serving: a fresh process, one whose first act is a profiler
    # run, then this one
    runs = {}
    for label, note, cmd in (
            ("fresh", "a fresh process",
             ["-m", "hgnn2_torch.scripts.bench_serving"]),
            ("profiled", "a fresh process whose first act is a torch.profiler "
             "run", ["-c", "import sys, chip_smoke; chip_smoke."
                     "_serving_after_profiler(sys.argv[1:])"])):
        res_out = os.path.join(out, f"serving_{len(runs)}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, *cmd, *SERVING_ARGV, "--out", res_out],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=900)
        if proc.returncode:
            raise AssertionError(f"bench_serving ({label}) exited "
                                 f"{proc.returncode}:\n" + proc.stderr[-3000:])
        child = next(json.loads(line)["launches"]
                     for line in proc.stdout.splitlines()
                     if line.startswith('{"launches"'))
        for k, n in child.items():
            launches[k] += n
        with open(os.path.join(res_out, "results.json")) as f:
            runs[label] = json.load(f)
        print(f"  bench_serving in {note}: "
              f"{time.perf_counter() - t0:.1f} s, rtt floor "
              f"{runs[label]['rtt_floor_ms']} ms, launches {child}")
        if not child["K3"] or any(n for k, n in child.items() if k != "K3"):
            raise AssertionError(f"bench_serving launches {child}")
    runs["in this process"], got = counted(lambda: bench_serving.main(
        SERVING_ARGV + ["--out", os.path.join(out, "serving_here")]))
    if not got["K3"] or any(n for k, n in _ks(got).items() if k != "K3"):
        raise AssertionError(f"bench_serving in this process launched {got}")
    for name, rows in runs["fresh"]["bundles"].items():
        print(f"    {name}: p50 " + ", ".join(
            f"{r['latency_ms_p50']} ms x{r['request_records']}" for r in rows)
            + "; 2,048 records, molecules/s: " + ", ".join(
                f"{run['bundles'][name][-1]['throughput_molecules_per_s']} "
                f"{label}" for label, run in runs.items()))
    print("    phase 9 in this process (other models, trained; buckets 1,024 "
          "and 256): " + ", ".join(f"{k} {v:.1f}" for k, v in serve9.items())
          + " molecules/s")

    # packed_crossover: scan groups
    with mock.patch.object(packed_crossover, "HS", CROSSOVER_HS):
        res, got = counted(lambda: packed_crossover.main(
            ["--molecules", str(HARNESS_MOLS), "--epochs", "1", "--out", out]))
    records = _synthetic(HARNESS_MOLS)
    want = {fam: _dense_groups(records, 2048, fam == "lggnn")
            for fam in ("gnn", "lggnn")}
    for r in res["rows"]:
        print(f"    {r['family']} h={r['h']} {r['layout']}"
              + (f" uniform_caps={r['uniform_caps']}" if "uniform_caps" in r
                 else "")
              + f": {r['epoch_s_mean']} s an epoch, {r['molecules_per_s']} "
                f"molecules/s, {r['scan_bucket_groups']} groups")
        if r["layout"] == "dense" and r["scan_bucket_groups"] != want[r["family"]]:
            raise AssertionError(f"packed_crossover: {r} (groups {want})")
        if r.get("uniform_caps") and r["scan_bucket_groups"] != 1:
            raise AssertionError(f"packed_crossover: {r}")
    if any(_ks(got).values()):
        raise AssertionError(f"packed_crossover launched {got}")
    torch.cuda.empty_cache()
    print(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# phase 17: the quality harnesses of hgnn2_torch/scripts, cut in size
QUALITY_EPOCHS = 2  # each RUNS entry's epochs here (JAX's: 40, 120 and 200)
FLOOR_RTOL = 1e-9  # the floors against JAX's committed floor.json


def _floors_match(out: str) -> None:
    """regression_floor at n = 2,000 and 8,000 against JAX's committed
    runs/validation_reg_floor{,_8000}/floor.json."""
    from hgnn2_torch.scripts import regression_floor

    here = os.path.dirname(os.path.abspath(__file__))
    for n, committed in ((2000, "validation_reg_floor"),
                         (8000, "validation_reg_floor_8000")):
        got = _quiet(lambda: regression_floor.main(
            ["--n", str(n), "--out", os.path.join(out, f"floor_{n}_torch")]))
        with open(os.path.join(here, "runs", committed, "floor.json")) as f:
            want = json.load(f)
        worst = 0.0
        for split in ("splits", "order_blind_oracle_splits"):
            for name, row in want[split].items():
                for k, v in row.items():
                    worst = max(worst, abs(got[split][name][k] - v) / abs(v))
        print(f"  regression_floor n={n}: train error ratio "
              f"{got['splits']['train']['error_ratio']:.6f}, order-blind "
              f"{got['order_blind_oracle_splits']['train']['error_ratio']:.6f};"
              f" largest rel err against runs/{committed}/floor.json "
              f"{worst:.3e} (tolerance {FLOOR_RTOL})")
        if worst > FLOOR_RTOL:
            raise AssertionError(f"regression_floor n={n} departs from JAX's")


def _ccn2d_paths(dev, counters) -> None:
    """validation_reg_ccn2d's model (CCN2D L=3, h=6) from the same seeded
    weights on the plain path and on the kernel path (K3, K4): the losses
    of the first two Adamax steps on the run's first train batch."""
    from hgnn2_torch.cli import common
    from hgnn2_torch.data import batching, synthetic
    from hgnn2_torch.scripts.run_validation import RUNS
    from hgnn2_torch.training import optim, train

    cfg = RUNS["validation_reg_ccn2d"]()
    records, kind, ts, _ = common.load_records(cfg)
    tr = synthetic.split_80_10_10(records)[0]
    batch = next(iter(batching.CCNLoader(tr, cfg.batch_size, task=0,
                                         device=dev)))
    mean, std = float(ts.mean[0]), float(ts.std[0])
    losses, weights = {}, None
    for kernel in (False, True):
        cfg.model.ccn_kernel = kernel
        model = common.build_model(cfg, kind, records[0].x.shape[1]).to(dev)
        sd = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
        weights = weights or sd
        if any(not torch.equal(sd[k], weights[k]) for k in sd):
            raise AssertionError("reg_ccn2d: the two paths' weights differ")
        opt, sched = optim.build_optimizer(cfg.optim, 1, model.parameters())

        def steps():
            return [float(train.train_step(model, opt, sched, batch,
                                           mean=mean, std=std)["loss"])
                    for _ in range(2)]

        losses[kernel], got = _counted(counters, dict.fromkeys(counters, 0),
                                       steps)
        if bool(got["K3"] and got["K4"]) != kernel or got["K1"] or got["K2"]:
            raise AssertionError(f"reg_ccn2d kernel={kernel}: launches {got}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[True], losses[False]))
    print(f"  reg_ccn2d (CCN2D L=3 h=6, {cfg.batch_size} molecules) losses of "
          f"the first 2 steps, same weights: plain {losses[False]}, kernels "
          f"{losses[True]}, largest rel err {rel:.3e} (tolerance "
          f"{CCN_PATHS_RTOL})")
    if rel > CCN_PATHS_RTOL:
        raise AssertionError("reg_ccn2d: the paths' first steps disagree")


def phase_quality(dev, card: str) -> dict[str, int]:
    """The quality harnesses of hgnn2_torch/scripts at a cut: the floors
    against JAX's committed files; each of run_validation's nine RUNS
    entries through run_one for QUALITY_EPOCHS epochs (the cut set on the
    cfg; JAX's data sizes, models and batches), its history's length
    (the recalibration row included) and finiteness, the CCN kernels'
    launches against the K rule (K3 and K4 in reg_ccn2d at K = 5, none in
    cls_ccn1d at K = 11 > 8, none in the GNN runs) and the gnn range
    splits' counts; reg_ccn2d's kernel path against its plain path;
    diagnose_quality_gap's probe (QUALITY_EPOCHS epochs) and BN modes on
    the cut control run's model, whose running statistics the train-mode
    pass leaves bit-equal. Returns each kernel's launches in the runs."""
    from hgnn2_torch.cli import common
    from hgnn2_torch.data import synthetic
    from hgnn2_torch.ops import ccn_fused
    from hgnn2_torch.scripts import diagnose_quality_gap as dq
    from hgnn2_torch.scripts import run_validation as rv

    t_phase = time.perf_counter()
    out = os.path.join(OUT_DIR, "quality")
    counters = _counters()
    launches = dict.fromkeys(counters, 0)
    _floors_match(out)

    control = None
    for name, make in rv.RUNS.items():
        cfg = make()
        cfg.epochs, cfg.device = QUALITY_EPOCHS, str(dev)
        cfg.log_path = os.path.join(out, f"{name}_torch")
        (model, history, rec), got = _counted(
            counters, launches, lambda: rv.run_one(name, cfg, banded=False))
        rows = QUALITY_EPOCHS + cfg.bn_recalibrate
        finite = all(np.isfinite(v) for r in history for v in r.values())
        last = {k: round(v, 4) for k, v in history[-1].items()
                if k.endswith(("accuracy", "error_ratio"))}
        print(f"  {name}: {len(history)} rows, last {last}, "
              f"{60 * rec['minutes']:.1f} s"
              + (f", K = {rec['K']}" if "K" in rec else "")
              + f", launches {got}")
        if len(history) != rows or not finite:
            raise AssertionError(f"{name}: {len(history)} rows (want {rows}),"
                                 f" finite {finite}")
        if name == "validation_reg_ccn2d":
            kernel = ccn_fused.use_kernel(rec["K"], dev)
            if rec["K"] != 5 or not (kernel and got["K3"] and got["K4"]) or (
                    got["K1"] or got["K2"] or got["K5"]):
                raise AssertionError(f"{name}: K = {rec['K']}, launches {got}")
        elif name == "validation_cls_ccn1d":
            if rec["K"] <= ccn_fused.MAX_K or any(_ks(got).values()):
                raise AssertionError(f"{name}: K = {rec['K']}, launches {got}")
        elif any(_ks(got).values()):
            raise AssertionError(f"{name} launched {got}")
        if name in rv.RANGE_SPLIT:
            split = rec["range_split"]
            if (split["val_count"], split["val_out_of_range_count"]) != (800, 0):
                raise AssertionError(f"{name} range split: {split}")
        if name == dq.CONTROL:
            control = (cfg, model)
        del model
    _ccn2d_paths(dev, counters)

    cfg, model = control
    records, _, ts, _ = common.load_records(cfg)
    tr, va, _ = synthetic.split_80_10_10(records)
    t0 = time.perf_counter()
    probe = dq.linear_probe(cfg, tr, va, ts, dev)
    probe_s = time.perf_counter() - t0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    modes = dq.bn_mode_eval(cfg, model, va, ts)
    same = all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    print(f"  diagnose_quality_gap: probe ({QUALITY_EPOCHS} epochs, "
          f"{probe_s:.1f} s) train {probe['train_error_ratio']:.5f}, val "
          f"{probe['val_error_ratio']:.5f}; the cut control's BN modes: eval "
          f"{modes['val_error_ratio_eval']:.4f}, train stats "
          f"{modes['val_error_ratio_train_stats']:.4f}; running stats "
          f"bit-equal after the train-mode pass: {same}")
    if not same or not all(np.isfinite(v) for v in (
            probe["train_error_ratio"], probe["val_error_ratio"],
            modes["val_error_ratio_eval"],
            modes["val_error_ratio_train_stats"])):
        raise AssertionError("diagnose_quality_gap at the cut")
    torch.cuda.empty_cache()
    print(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


# phase 18: the JAX repo's last harnesses, and the CCN-2D runs on the card
SUITE_BS, SUITE_STEPS = 512, 3  # bench_suite's molecules and timed calls
SUITE_LARGE_NODES = 1 << 16  # the packed SpMM at scale: 2^20 edges
HALO_CUT = (40_000, 51)  # (edges, halo rows a shard) at V = 2^18, 8 shards:
# tests/test_torch_bench_suite.py holds this count to JAX's on the CPU
SCALING_ARGV = ["--molecules", "128", "--nodes", "256", "--steps", "2",
                "--ranks", "4"]
CHUNKS_CUT = dict(epochs=1, n_synthetic=1000)  # run (a): --chunks 2 vs 1
SCAN_CUT = dict(bs=SUITE_BS, steps=1)  # run (b): the scan at K = 5
SUITE_RTOL = 1e-5  # K = 8 rows' first loss; chained f32 ops, x max |value|
SUITE_BF16_TOL = 2.0 ** -7  # chained bf16 ops against their eager calls
HIGH_K_REFUSAL = r"unroll\w* over K=32 > 8"
SCALING_FIELDS = ("comm_bytes_per_step", "halo_rows_node", "halo_rows_edge",
                  "allreduces_fwd", "mesh")


def _nbytes_str(n) -> str:
    return "n/a" if n is None else f"{n:,} B"


def _launch_rule(section: str, got: dict, want: set) -> None:
    """Raises unless exactly the kernels of K1-K5 in ``want`` launched."""
    if any((n > 0) != (k in want) for k, n in _ks(got).items()):
        raise AssertionError(f"{section}: launches {got}, expected "
                             f"{sorted(want) or 'none'}")


def _chained_vs_eager(keep: dict, card: str) -> None:
    """Each chained op's graph output against n eager calls on the card."""
    for name, (fn, x0, n, out) in keep.items():
        x = x0
        for _ in range(n):
            x = fn(x).to(x0.dtype)
        want = x.float()
        err = float((out.float() - want).abs().max() / want.abs().max())
        tol = SUITE_BF16_TOL if "bf16" in name else SUITE_RTOL
        print(f"  chained {name} (n = {n}, {tuple(x0.shape)} "
              f"{str(x0.dtype).split('.')[-1]}): graph vs eager max err / "
              f"max |value| {err:.3e} (tolerance {tol:.3g}) on {card}")
        if not err <= tol:
            raise AssertionError(f"chained {name}: the graph departs from "
                                 "its eager calls")


def _scaling_rows(res: dict) -> dict:
    rows = {(mode, int(d), f): row.get(f)
            for mode, block in res["lggnn"].items() if isinstance(block, dict)
            and "devices" in block
            for d, row in block["devices"].items() for f in SCALING_FIELDS}
    return {k: v for k, v in rows.items() if v is not None}


def phase_suite(dev, card: str) -> dict[str, int]:
    """bench_suite's sections at a cut (SUITE_BS molecules, SUITE_STEPS
    timed calls, the packed SpMM at scale at SUITE_LARGE_NODES nodes, the
    halo build at HALO_CUT's edges; the K = 8 and K = 32 batches whole):
    each section's launches against the K rule (K1-K4 in the CCN rows'
    kernel paths, K3 and K4 at K = 8 inside the captured steps, none on
    the plain paths, at K = 32 or anywhere else), K = 8 and 32 and the
    high-K refusal's text, the K = 8 kernel row's first loss against the
    plain row's from the same weights (SUITE_RTOL), every chained op's
    graph output against its eager calls, the halo rows against HALO_CUT;
    bench_scaling at SCALING_ARGV on the card and on the CPU, their comm
    accounting equal; ccn_card_runs' chunks (one epoch) and scan (one
    timed call) runs within their bars. Returns each kernel's
    launches."""
    from hgnn2_torch.scripts import bench_scaling
    from hgnn2_torch.scripts import bench_suite as bs
    from hgnn2_torch.scripts import ccn_card_runs

    t_phase = time.perf_counter()
    out = os.path.join(OUT_DIR, "suite")
    counters = _counters()
    launches = dict.fromkeys(counters, 0)
    results, rows, keep = {}, {}, {}
    records = bs.qm9_records(SUITE_BS)

    def run(section, want, fn):
        res, got = _counted(counters, launches, fn)
        _launch_rule(section, got, want)
        print(f"  {section}: launches {got}")
        return res

    batch = run("bench_suite gnn rows", set(), lambda: bs.gnn_section(
        records, SUITE_BS, SUITE_STEPS, dev, results, rows))
    run("bench_suite ccn rows", {"K1", "K2", "K3", "K4"},
        lambda: bs.ccn_section(records, SUITE_BS, SUITE_STEPS, dev, results,
                               rows))
    run("bench_suite K = 8 rows", {"K3", "K4"}, lambda: bs.k8_section(
        bs.k8_records(), SUITE_STEPS, dev, results, rows))
    run("bench_suite high-K rows", set(), lambda: bs.high_k_section(
        bs.dense_records(), SUITE_STEPS, dev, results, rows))
    refusal = results["ccn2d_highK_kernel"]
    first = [rows[f"ccn2d_K8_{p}_"]["losses"][0] for p in ("kernel", "plain")]
    k8_err = abs(first[0] - first[1]) / abs(first[1])
    print(f"  K = {results['ccn2d_K8_K']} and {results['ccn2d_highK_K']}; "
          f"high K: {refusal!r}; K = 8 first call's loss kernel {first[0]:.8e}"
          f" vs plain {first[1]:.8e}, rel err {k8_err:.3e} (tolerance "
          f"{SUITE_RTOL})")
    if (results["ccn2d_K8_K"], results["ccn2d_highK_K"]) != (8, 32) or not (
            refusal.startswith("refused: ")
            and re.search(HIGH_K_REFUSAL, refusal)) or k8_err > SUITE_RTOL:
        raise AssertionError("bench_suite's K = 8 or high-K rows")
    part = bs.halo_section(bs.HALO_NODES, bs.HALO_SHARDS, HALO_CUT[0],
                           results)
    if part.n_imports != HALO_CUT[1]:
        raise AssertionError(f"halo rows {part.n_imports} at {HALO_CUT[0]} "
                             f"edges, the CPU's {HALO_CUT[1]}")
    run("bench_suite bf16 row", set(), lambda: bs.bf16_section(
        batch, SUITE_BS, SUITE_STEPS, dev, results, rows))
    run("bench_suite SpMM roofline", set(), lambda: bs.spmm_section(
        records, batch, SUITE_BS, SUITE_STEPS, dev, SUITE_LARGE_NODES,
        results, rows, keep))
    _chained_vs_eager(keep, card)
    for name, row in rows.items():
        print(f"  {name}: {row['ms_per_step']:.4f} ms a step, peak "
              f"{_nbytes_str(row['peak_bytes'])}")
    del keep, batch
    torch.cuda.empty_cache()

    sc = {}
    for where in ("card", "cpu"):
        argv = SCALING_ARGV + ["--device", str(dev) if where == "card"
                               else "cpu", "--out",
                               os.path.join(out, f"scaling_{where}_torch")]
        sc[where] = run(f"bench_scaling on the {where}", set(),
                        lambda: _quiet(lambda: bench_scaling.main(argv)))
    got, want = _scaling_rows(sc["card"]), _scaling_rows(sc["cpu"])
    aligned = [r["comm_bytes_per_step"] for r in
               sc["card"]["lggnn"]["molecule_aligned"]["devices"].values()]
    print(f"  bench_scaling {' '.join(SCALING_ARGV)}: {len(got)} accounting "
          f"fields of 4 modes at 1, 2, 4 ranks, card == CPU: {got == want}; "
          f"molecule_aligned {aligned} B a step")
    if got != want or len(got) < 20:
        raise AssertionError("bench_scaling's accounting differs from the "
                             "CPU's")

    rec = run("ccn_card_runs chunks", set(),
              lambda: _quiet(lambda: ccn_card_runs.chunks(str(dev),
                                                          **CHUNKS_CUT)))
    print(f"  run (a) --edge_shards 4 --chunks 2 vs 1, {CHUNKS_CUT['epochs']}"
          f" epoch: max rel err {rec['max_rel_err']:.3e} (tolerance "
          f"{rec['tolerance']}); ms a step "
          f"{rec['runs']['chunks2']['ms_per_step']:.3f} vs "
          f"{rec['runs']['chunks1']['ms_per_step']:.3f}")
    rec = run("ccn_card_runs scan", {"K3", "K4"},
              lambda: ccn_card_runs.scan_k5(str(dev), **SCAN_CUT))
    print(f"  run (b) the scan at K = {rec['K']} (V = {rec['V']}): losses vs "
          f"materialized {rec['max_rel_err']} (tolerance {rec['tolerance']});"
          + "".join(f" {k} {r['ms_per_step']:.3f} ms, peak "
                    f"{_nbytes_str(r['peak_bytes'])};"
                    for k, r in rec["rows"].items()))
    torch.cuda.empty_cache()
    print(f"  phase 18 took {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs the port on a CUDA card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    from hgnn2_torch import runtime
    from hgnn2_torch.ops import cuda_build

    runtime.setup()

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

    print("phase 1: build")
    t0 = time.perf_counter()
    secs = cuda_build.build_all()
    print(f"  built {secs} in {time.perf_counter() - t0:.1f} s")
    for name in secs:
        for line in _ptxas_summary(cuda_build.build_log(name)):
            print("  ptxas:", line)

    from hgnn2_torch.data import qm9

    packed_records = qm9.synthetic_qm9_like(N_PACKED_MOLS, seed=1)
    print("phase 2: kernels against their plain versions")
    floor = phase_floor()
    rows = phase_kernels(dev)
    rows["K5"] = phase_ring(dev, _packed_caps(packed_records)[0])

    print("phase 3: serving")
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    served = phase_serving(dev, card)

    print("phase 4: training")
    trained = phase_training(card)

    print("phase 5: edge-partitioned packed inference")
    packed = phase_packed(dev, card, packed_records)

    print("phase 6: main path (GNNSimple dense training)")
    main_path = phase_main(dev, card)

    print("phase 7: line-graph GNN (GNNLineGraph dense training)")
    lggnn = phase_lggnn(dev, card)

    print("phase 8: packed training (--packed) and the trainer's extras")
    packed_train = phase_packed_train(dev, card)

    print("phase 9: serving from files (preprocess cache -> train -> export "
          "-> predict)")
    serve9_rates: dict = {}
    served_files = phase_serve_files(dev, card, serve9_rates)

    print("phase 10: the compiled step and the scanned epoch as CUDA graphs, "
          "captured against eager")
    captured = phase_captured(dev, card)

    print("phase 11: molecule-aligned sharded training (--edge_shards, --dp "
          "M --edge_shards N)")
    sharded_runs = phase_sharded(dev, card)

    print("phase 12: data parallelism (--dp 2 in one process; 2 processes "
          "through gloo)")
    dp_runs = phase_dp(dev, card)

    print("phase 13: the halo exchange for one giant graph")
    halo_runs = phase_halo(dev, card)

    print("phase 14: high-degree CCN-2D (C2, C3: the scan over neighbour "
          "slots and vertex chunks)")
    high_degree = phase_high_degree(dev, card)

    print("phase 15: ranks on several processes (F4): the edge-partitioned "
          "and halo paths, one rank a process, K5 across them")
    across = phase_processes(dev, card)

    print("phase 16: the measurement harnesses (profile_lggnn, "
          "profile_ccn1d, bench_serving, packed_crossover)")
    harnesses = phase_harnesses(dev, card, serve9_rates)

    print("phase 17: the quality harnesses (regression_floor, "
          "run_validation's nine runs, diagnose_quality_gap), cut")
    quality = phase_quality(dev, card)

    print("phase 18: the last harnesses (bench_suite, bench_scaling) and the "
          "CCN-2D card runs, cut")
    suite = phase_suite(dev, card)
    for key, row in rows.items():  # launches of the main paths' runs
        row["launches"] = (served[key] + trained[key] + packed[key]
                           + main_path[key] + lggnn[key] + packed_train[key]
                           + served_files[key] + captured[key]
                           + sharded_runs[key] + dp_runs[key] + halo_runs[key]
                           + high_degree[key] + harnesses[key] + quality[key]
                           + suite[key])
    rows["K5 across processes"] = across
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "ms_in_run", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps(floor))
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
