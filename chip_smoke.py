#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. build    compile the CUDA kernels from hgnn2_torch/ops/csrc with nvcc;
  2. kernels  hold K1 (fused CCN-1D promotion + contraction), K3 (fused
              CCN-2D promotion + 18 contractions) and their backward
              kernels K2 and K4 against their plain PyTorch versions on
              the card, at the serving bucket (1,024 QM9-shaped molecules,
              V = 16,384, K = 5; C = 5 and 2, both channel layouts) and at
              K = 8; hold the gradient through each autograd Function
              against autograd through the plain path; time each kernel
              beside its bound, and K4's PyTorch prologue apart; hold K5
              (the ring all-reduce) to its plain twin exactly for S = 2,
              4 and 8 ranks at the packed path's node blocks
              (V = 10,944, F = 1, 5, 16), at S = 4 with 2^20 x 16 floats
              a rank, and on unaligned and odd-sized buffers;
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
              forward; host-clock and device ms per forward and
              molecules/s for the ring, the plain reduce and single-rank
              ops.

The last two lines are a JSON line describing each kernel and
{"ok": true, "device": {...}}. Exits non-zero without CUDA.

Float32 matmuls run without TF32 (set below) so that Linear layers on the
card compute what they compute on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
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
N_TRAIN_MOLS = 5120  # 4,096 train, 512 valid, 512 test
TRAIN_BS = 1024
TRAIN_EPOCHS = 2
CPU_STEPS = 3
N_SERVE_MOLS = 1024
N_REQUESTS = 2048
V_SERVE = 16384  # the CCN loader's vertex bucket for 10,964 vertices
SERVE_BUCKETS = [(1024, 16384), (256, 4096)]
N_PACKED_MOLS = 1024  # bench_scaling.py's --molecules default
RING_RANKS = 4
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke")


BUSY_CYCLES = 20_000_000  # about 10 ms of device spin at the H100's clock


def _time_ms(fn, reps: int = 30, warmup: int = 3,
             busy: int = BUSY_CYCLES) -> float:
    """Median device time of one call, by CUDA events, after warm-up.

    Before each call the device spins (torch.cuda._sleep) while the host
    enqueues the start event, the call's kernels and the end event, so
    the interval holds the kernels back to back and none of the host's
    Python and launch overhead (tens of us per wrapper call, more than a
    small kernel takes). The spin outlasts the enqueue of a whole CCN-1D
    forward (20 layers, a few ms of host time)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(busy)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
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
            h = re.search(r"ring_hopILb(\d)ELb(\d)E", m.group(1))
            name = (f"{k.group(1)}<K={k.group(2)}>" if k else
                    f"ring_hop<first={h.group(1)},vec={h.group(2)}>" if h
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

    prologue = {}
    for label, b in (("serving bucket", cb), ("K=8 graphs", cb8)):
        V, K = b.nbr.shape
        label = f"{label} V={V} K={K}"
        m = b.row_mask
        chi, nbr, rslot = b.chi_idx, b.nbr, b.rslot
        va = (chi >= 0) & (rslot >= 0)[:, :, None]  # valid (u, j, p)
        n_valid_1d = int(va.sum())
        n_valid_2d = int((va[:, :, :, None] & va[:, :, None, :]).sum())
        for C in (5, 2):
            f1 = (randn(V, K, C) * m[:, :, None]).contiguous()
            f2 = (randn(V, K, K, C) * (m[:, :, None] * m[:, None, :])[..., None]).contiguous()
            g1 = randn(V, K, 2 * C)
            g2 = randn(V, K, K, 18 * C)

            k1 = lambda: ccn_fused.fused_contract_1d_forward(chi, nbr, f1)
            p1 = lambda: P.contract_1d(P.promote_1d(chi, nbr, f1))
            out1 = k1()
            check("K1", f"{label} C={C}", out1, p1())
            k2 = lambda: ccn_fused.fused_contract_1d_backward(chi, rslot, nbr, g1)
            p2 = lambda: P.promote_1d_bwd(chi, rslot, nbr, P.contract_1d_transpose(g1))
            out2 = k2()
            check("K2", f"{label} C={C}", out2, p2())
            _grad_check(
                f"grad of promote_contract_1d {label} C={C}",
                _f_grad(lambda f: ccn_fused.promote_contract_1d(chi, nbr, f, rslot), f1, g1),
                _f_grad(lambda f: P.contract_1d(P.promote_1d(chi, nbr, f, rslot=rslot)), f1, g1))
            if b is cb:
                n_ops = 2 * V * K * K * C
                bound, by = _bound(_nbytes(chi, nbr, f1, out1), n_ops)
                timed[("K1", C)] = dict(ms=_time_ms(k1), plain_ms=_time_ms(p1),
                                        bound_ms=bound, bound_by=by)
                # two adds per valid (u, j, p) entry and channel
                bound, by = _bound(_nbytes(chi, rslot, nbr, g1, out2),
                                   2 * n_valid_1d * C)
                timed[("K2", C)] = dict(ms=_time_ms(k2), plain_ms=_time_ms(p2),
                                        bound_ms=bound, bound_by=by)

            for compat in (False, True):
                k3 = lambda: ccn_fused.fused_contract_forward(
                    chi, nbr, f2, b.deg, m, compat=compat)
                p3 = lambda: P.contract_18(P.promote_2d(chi, nbr, f2),
                                           b.deg, m, compat=compat)
                out3 = k3()
                check("K3", f"{label} C={C} compat={compat}", out3, p3())
                pro = lambda: [t.contiguous() for t in P.contract_18_transpose_parts(
                    g2, b.deg, m, compat=compat)]
                parts = pro()
                k4 = lambda: ccn_fused.fused_contract_backward_parts(chi, rslot, nbr, *parts)
                p4 = lambda: P.promote_2d_bwd(chi, rslot, nbr, P.gbar_from_parts(*parts))
                out4 = k4()
                check("K4", f"{label} C={C} compat={compat}", out4, p4())
                check("K4", f"{label} C={C} compat={compat} from g (prologue + K4) "
                      "vs promote_2d_bwd(contract_18_transpose(g))",
                      ccn_fused.fused_contract_backward(chi, rslot, nbr, g2, b.deg, m,
                                                        compat=compat),
                      P.promote_2d_bwd(chi, rslot, nbr, P.contract_18_transpose(
                          g2, b.deg, m, compat=compat)))
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
                        ms=_time_ms(k3), plain_ms=_time_ms(p3),
                        bound_ms=bound, bound_by=by)
                    # about four adds per valid (u, j, p, q) entry and channel
                    bound, by = _bound(_nbytes(chi, rslot, nbr, *parts, out4),
                                       4 * n_valid_2d * C)
                    timed[("K4", C)] = dict(ms=_time_ms(k4), plain_ms=_time_ms(p4),
                                            bound_ms=bound, bound_by=by)
                    # the prologue reads g and writes the four parts
                    bound, by = _bound(_nbytes(g2, b.deg, m, *parts), 0)
                    prologue[C] = dict(ms=_time_ms(pro), bound_ms=bound)
    for (key, C), t in sorted(timed.items()):
        print(f"  {key} {rows[key]['name']} at V={V_SERVE} K=5 C={C}: "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), library none")
    for C, t in sorted(prologue.items()):
        print(f"  K4 prologue contract_18_transpose_parts (PyTorch ops) at "
              f"V={V_SERVE} K=5 C={C}: {t['ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms (bytes)")
    for key, C in (("K1", 5), ("K2", 2), ("K3", 5), ("K4", 2)):
        rows[key].update(timed[(key, C)])
    return rows


def phase_ring(dev, V: int) -> dict:
    """K5 against its plain twin (equal bit for bit: the same adds in the
    same order) at the packed path's node blocks (V, F), F = 1 (degree),
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
                 plain_ms=_time_ms(lambda: ring.ring_psum_reference(parts)),
                 library_ms=_time_ms(lambda: torch.stack(parts).sum(0)),
                 bound_ms=bound, bound_by=by)
        schedule_ms = 16 * n * S * (S - 1) / HBM_BYTES_PER_S * 1e3
        print(f"  K5 ring_psum S={S} {label}: kernel {t['ms']:.4f} ms "
              f"({S - 1} launches), plain twin {t['plain_ms']:.4f} ms, "
              f"bound {bound:.5f} ms ({by}: 2*S*n*4 bytes, the function's "
              f"minimum), schedule's bytes {schedule_ms:.5f} ms "
              f"(16*n*S*(S-1)), library torch.stack(parts).sum(0) "
              f"{t['library_ms']:.4f} ms (computes one replica, not S)")
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
        dev_ms = _time_ms(lambda: sm.model(batch), reps=10, warmup=2)
    print(f"  breakdown of one {len(chunk)}-molecule chunk: batch build + "
          f"copy {build_s * 1e3:.2f} ms (host clock), forward "
          f"{host_ms:.3f} ms (host clock) of which {dev_ms:.3f} ms device "
          f"time (CUDA events)")


def _counters() -> dict:
    from hgnn2_torch.ops import ccn_fused, ring

    return {"K1": ccn_fused.fused_contract_1d_forward,
            "K2": ccn_fused.fused_contract_1d_backward,
            "K3": ccn_fused.fused_contract_forward,
            "K4": ccn_fused.fused_contract_backward,
            "K5": ring.ring_psum}


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

        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds = sm.predict(requests)  # the main path
        secs = time.perf_counter() - t0
        got = {k: c.launches for k, c in counters.items()}
        for k, n in got.items():
            launches[k] += n

        want = {k: 0 for k in counters}
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


def _train_setup(cfg, params, device):
    """The model (kernels on where use_kernel says so) from the flax
    params, the optimizer, the train batches in deal order, mean and std:
    the pieces of run_experiment's first epoch, on ``device``."""
    from hgnn2_torch import convert
    from hgnn2_torch.cli import common
    from hgnn2_torch.data import batching, qm9, stats, synthetic
    from hgnn2_torch.ops import ccn_fused
    from hgnn2_torch.training import optim

    records = qm9.synthetic_qm9_like(cfg.data.n_synthetic, seed=cfg.seed)
    ts = stats.compute_target_stats(records)
    train_recs = synthetic.split_80_10_10(records, seed=cfg.seed)[0]
    loader = batching.CCNLoader(train_recs, cfg.batch_size, task=0,
                                device=device)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, ccn_kernel=ccn_fused.use_kernel(loader.k_max, device)))
    model = common.build_model(cfg, "regression", records[0].x.shape[1])
    model.load_state_dict(convert.ccn_params_from_flax(params))
    model.to(device)
    opt, sched = optim.build_optimizer(cfg.optim, len(loader), model.parameters())
    return model, opt, sched, list(loader), float(ts.mean[0]), float(ts.std[0])


def _first_steps(cfg, params, device) -> tuple[list[float], dict]:
    """CPU_STEPS train steps over the first train batches on ``device``:
    each step's loss and the step-0 gradient of every parameter."""
    from hgnn2_torch.training import train

    model, opt, sched, batches, mean, std = _train_setup(cfg, params, device)
    losses, grads = [], None
    for batch in batches[:CPU_STEPS]:
        mets = train.train_step(model, opt, sched, batch, mean=mean, std=std)
        losses.append(float(mets["loss"]))
        if grads is None:
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in model.named_parameters()}
    return losses, grads


def _step_times(cfg, params, card: str) -> None:
    """Host-clock time of an epoch of train steps (what a trainer waits
    for), and one step's device time split into forward (with the loss),
    backward and optimizer by CUDA events, with the device held busy
    while the host enqueues the step."""
    from hgnn2_torch.training import train

    t0 = time.perf_counter()
    model, opt, sched, batches, mean, std = _train_setup(cfg, params, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    train.train_step(model, opt, sched, batches[0], mean=mean, std=std)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        train.train_step(model, opt, sched, batch, mean=mean, std=std)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_mols = sum(int(b.gmask.sum()) for b in batches)
    splits = []
    for batch in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        model.train()
        opt.zero_grad(set_to_none=True)
        torch.cuda._sleep(10 * BUSY_CYCLES)
        ev[0].record()
        out = model(batch)
        loss, _ = train._loss_and_metrics(out, batch.y, batch.gmask,
                                          "regression", mean, std)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        sched.step()
        ev[3].record()
        ev[3].synchronize()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    fwd, bwd, upd = np.median(np.array(splits), axis=0)
    print(f"  {cfg.model.arch} L={cfg.model.n_layers}: set-up {setup_s:.3f} s "
          f"(host clock: {cfg.data.n_synthetic} records generated, target "
          f"stats, {len(batches)} train batches built and copied, model)")
    print(f"  {cfg.model.arch} L={cfg.model.n_layers}: {len(batches)} steps of "
          f"{cfg.batch_size} molecules in {secs:.4f} s (host clock): "
          f"{secs / len(batches) * 1e3:.3f} ms/step, {n_mols / secs:.1f} "
          f"molecules/s on {card}")
    print(f"  {cfg.model.arch} L={cfg.model.n_layers} one step, device time "
          f"(CUDA events, median of {len(splits)}): forward+loss {fwd:.3f} ms, "
          f"backward {bwd:.3f} ms, optimizer {upd:.3f} ms, total "
          f"{fwd + bwd + upd:.3f} ms")


def phase_training(card: str) -> dict[str, int]:
    """Train CCN2D(L=2, h=2) and CCN1D(L=20, h=2) through run_experiment on
    the card. Returns each kernel's launches summed over the two runs."""
    from hgnn2_torch.cli import common

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
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, history = common.run_experiment(cfg, init_params=params)  # the main path
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: c.launches for k, c in counters.items()}
        for k, n in got.items():
            launches[k] += n

        want = dict.fromkeys(counters, 0)
        want[fwd] = n_layers * (steps + eval_batches)
        want[bwd] = (n_layers - 1) * steps
        losses = [(row["train_loss"], row["valid_loss"], row["test_loss"])
                  for row in history]
        print(f"  {name} L={n_layers} h=2: run_experiment, {TRAIN_EPOCHS} epochs "
              f"x {steps // TRAIN_EPOCHS} steps of {TRAIN_BS} molecules, "
              f"{secs:.2f} s host clock on {card} (batch builds included); "
              f"(train, valid, test) loss per epoch {losses}; launches {got} "
              f"(expected {want})")
        if not cfg.model.ccn_kernel:
            raise AssertionError(f"{name}: run_experiment did not enable the kernels")
        if got != want:
            raise AssertionError(f"{name}: kernel launches {got} != {want}")
        if len(history) != TRAIN_EPOCHS or not all(
                np.isfinite(v) for row in history for v in row.values()):
            raise AssertionError(f"{name}: training history not finite: {history}")

        card_losses, card_grads = _first_steps(cfg, params, "cuda")
        cpu_losses, cpu_grads = _first_steps(
            _train_cfg(arch, n_layers, "cpu", cfg.log_path), params, "cpu")
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
        grad_err = max(float((card_grads[k] - g).abs().max() / g.abs().max().clamp_min(1e-30))
                       for k, g in cpu_grads.items())
        print(f"  {name} first {CPU_STEPS} steps, card {card_losses} vs CPU "
              f"{cpu_losses}: max rel loss err {loss_err:.3e} (tolerance "
              f"{TRAIN_LOSS_RTOL}); step-0 gradients max err / max |grad| "
              f"{grad_err:.3e} over {len(cpu_grads)} tensors (tolerance "
              f"{TRAIN_GRAD_RTOL})")
        if loss_err > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_RTOL:
            raise AssertionError(f"{name}: card and CPU training steps disagree")
        _step_times(cfg, params, card)
    return launches


def _packed_caps(records) -> tuple[int, int]:
    """Node and edge capacities rounded up to multiples of 64, as
    bench_scaling.py packs its 1,024 molecules."""
    tot_v = sum(r.n_nodes for r in records)
    tot_e = sum(r.n_dir_edges for r in records)
    return -(-tot_v // 64) * 64, -(-tot_e // 64) * 64


def _packed_flax_variables(model, seed: int) -> dict:
    """Seeded weights in the flax layout of a packed model: every kernel,
    bias and BN scale N(0, 0.1); batch stats at flax's init (mean 0,
    std 1)."""
    from hgnn2_torch import convert

    rng = np.random.default_rng(seed)
    tree = convert.packed_variables_to_flax(model.state_dict())
    params = {name: {f: rng.normal(0, 0.1, a.shape).astype(np.float32)
                     for f, a in leaves.items()}
              for name, leaves in tree["params"].items()}
    return {"params": params, "batch_stats": tree["batch_stats"]}


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
        state0 = convert.packed_variables_from_flax(_packed_flax_variables(
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
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            ops = ring_ops()
            preds = model(pb, ops=ops)
            torch.cuda.synchronize()
            got = {k: c.launches for k, c in counters.items()}
            for k, n in got.items():
                launches[k] += n
            want = dict.fromkeys(counters, 0)
            want["K5"] = n_allreduce * (S - 1)
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs the port on a CUDA card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from hgnn2_torch.ops import cuda_build

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
    rows = phase_kernels(dev)
    rows["K5"] = phase_ring(dev, _packed_caps(packed_records)[0])

    print("phase 3: serving")
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    served = phase_serving(dev, card)

    print("phase 4: training")
    trained = phase_training(card)

    print("phase 5: edge-partitioned packed inference")
    packed = phase_packed(dev, card, packed_records)
    for key, row in rows.items():  # launches of the main paths' runs
        row["launches"] = served[key] + trained[key] + packed[key]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
