#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. build   compile the CUDA kernels from hgnn2_torch/ops/csrc with nvcc;
  2. kernels hold K1 (fused CCN-1D promotion + contraction) and K3 (fused
             CCN-2D promotion + 18 contractions) against their plain
             PyTorch versions on the card, at the serving bucket (1,024
             QM9-shaped molecules, V = 16,384, K = 5; C = 5 and 2, both
             channel layouts) and at K = 8; time each beside its bound;
  3. serving save CCN2D(L=2, h=2) and CCN1D(L=20, h=2) bundles with random
             weights in flax layout (converted by hgnn2_torch.convert),
             load them on the card and predict 2,048 molecules; hold the
             predictions against the same bundles served on the CPU, and
             check through the launch counts that every layer ran its
             kernel.

The last two lines are a JSON line describing each kernel and
{"ok": true, "device": {...}}. Exits non-zero without CUDA.

Float32 matmuls run without TF32 (set below) so that Linear layers on the
card compute what they compute on the CPU.
"""

from __future__ import annotations

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
SERVE_RTOL = 1e-4  # card vs CPU predictions, relative to the largest |pred|
N_SERVE_MOLS = 1024
N_REQUESTS = 2048
V_SERVE = 16384  # the CCN loader's vertex bucket for 10,964 vertices
SERVE_BUCKETS = [(1024, 16384), (256, 4096)]
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke")


BUSY_CYCLES = 20_000_000  # about 10 ms of device spin at the H100's clock


def _time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
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
        torch.cuda._sleep(BUSY_CYCLES)
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
            k = re.search(r"(ccn[12]d_forward)ILi(\d+)E", m.group(1))
            name = f"{k.group(1)}<K={k.group(2)}>" if k else m.group(1)
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


def phase_kernels(dev) -> dict[str, dict]:
    """K1 and K3 against their plain versions, timed at the serving bucket
    for C = 5 (first layer) and C = 2 (later layers). Returns each
    kernel's row of the kernels line, with the C = 5 times."""
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
    timed = {}  # (kernel, C) -> times at the serving bucket
    rows = {
        "K1": dict(name="fused_contract_1d_forward", route="cuda",
                   source="hgnn2_torch/ops/csrc/ccn_fused.cu",
                   replaces="hgnn2_tpu/ops/pallas/ccn_fused.py:189",
                   max_abs_err=0.0, library_ms=None),
        "K3": dict(name="fused_contract_forward", route="cuda",
                   source="hgnn2_torch/ops/csrc/ccn_fused.cu",
                   replaces="hgnn2_tpu/ops/pallas/ccn_fused.py:60",
                   max_abs_err=0.0, library_ms=None),
    }
    for label, b in (("serving bucket", cb), ("K=8 graphs", cb8)):
        V, K = b.nbr.shape
        label = f"{label} V={V} K={K}"
        m = b.row_mask
        for C in (5, 2):
            f1 = torch.from_numpy(rng.standard_normal((V, K, C), dtype=np.float32)).to(dev)
            f1 = (f1 * m[:, :, None]).contiguous()
            f2 = torch.from_numpy(rng.standard_normal((V, K, K, C), dtype=np.float32)).to(dev)
            f2 = (f2 * (m[:, :, None] * m[:, None, :])[..., None]).contiguous()

            k1 = lambda: ccn_fused.fused_contract_1d_forward(b.chi_idx, b.nbr, f1)
            p1 = lambda: P.contract_1d(P.promote_1d(b.chi_idx, b.nbr, f1))
            out1 = k1()
            torch.cuda.synchronize()
            err = _compare(f"K1 {label} C={C}", out1, p1())
            rows["K1"]["max_abs_err"] = max(rows["K1"]["max_abs_err"], err)
            if b is cb:
                n_ops = 2 * V * K * K * C
                bound, by = _bound(_nbytes(b.chi_idx, b.nbr, f1, out1), n_ops)
                timed[("K1", C)] = dict(ms=_time_ms(k1), plain_ms=_time_ms(p1),
                                        bound_ms=bound, bound_by=by)

            for compat in (False, True):
                k3 = lambda: ccn_fused.fused_contract_forward(
                    b.chi_idx, b.nbr, f2, b.deg, b.row_mask, compat=compat)
                p3 = lambda: P.contract_18(P.promote_2d(b.chi_idx, b.nbr, f2),
                                           b.deg, b.row_mask, compat=compat)
                out3 = k3()
                torch.cuda.synchronize()
                err = _compare(f"K3 {label} C={C} compat={compat}", out3, p3())
                rows["K3"]["max_abs_err"] = max(rows["K3"]["max_abs_err"], err)
                if b is cb and not compat:
                    # per (v, c): 2 adds for each of the K^3 promoted
                    # entries, ~22 K^2 for the reductions and 18 channels
                    n_ops = V * C * (2 * K ** 3 + 22 * K * K)
                    bound, by = _bound(_nbytes(b.chi_idx, b.nbr, f2, b.deg,
                                               b.row_mask, out3), n_ops)
                    timed[("K3", C)] = dict(
                        ms=_time_ms(k3), plain_ms=_time_ms(p3),
                        bound_ms=bound, bound_by=by)
    for (key, C), t in timed.items():
        print(f"  {key} {rows[key]['name']} at V={V_SERVE} K=5 C={C}: "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), library none")
    for key, row in rows.items():
        row.update(timed[(key, 5)])  # the kernels line: the first layer's shape
    return rows


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


def phase_serving(dev, card: str) -> dict[str, int]:
    """Serve both CCN models through bundles on the card and on the CPU.
    Returns the launch count of each kernel in its model's run."""
    from hgnn2_torch import convert, serving
    from hgnn2_torch.data import qm9
    from hgnn2_torch.nn import ccn
    from hgnn2_torch.ops import ccn_fused

    requests = qm9.synthetic_qm9_like(N_REQUESTS, seed=1)
    ys = np.array([r.y[0] for r in requests])
    sizes = np.array([[r.n_nodes] for r in requests])
    n_chunks = len(list(serving._greedy_spans(
        sizes, (SERVE_BUCKETS[0][1],), SERVE_BUCKETS[0][0])))
    counters = {"K1": ccn_fused.fused_contract_1d_forward,
                "K3": ccn_fused.fused_contract_forward}
    launches = {}
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
        launches[key] = got[key]

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

    print("phase 2: kernels against their plain versions")
    rows = phase_kernels(dev)

    print("phase 3: serving")
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    launches = phase_serving(dev, card)
    for key, row in rows.items():
        row["launches"] = launches[key]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
