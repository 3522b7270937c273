"""The serving driver: an open loop of requests into the port's
ServingModel.predict, from a bundle that save_bundle wrote and load_bundle
read, with the arrivals of traffic/<mix>.json (benchmark/arrivals.py).

One server thread takes the requests in due order; a request's latency
runs from its due time to the return of predict (a host array, so the
device work is done), queueing included. The window holds the requests
due in --seconds and is drained. After it, the reference predicts every
answered molecule again from the same weights, rebuilding each batch or
table, and the widest relative gap is compared.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark import arrivals, frozen, tracing
from benchmark.reference import common


@dataclasses.dataclass
class Server:
    """A loaded bundle and what the window and the check need."""

    sm: object
    mols: list
    records: list
    params: dict
    buffers: dict
    mean: float
    std: float
    built: list  # build_batch seconds of the current request
    trace: bool


def setup(ctx, reqs) -> Server:
    """The bundle of the seed's weights, saved and loaded, its batch build
    timed, and warmed on each bucket ``reqs`` reach."""
    from hgnn2_torch import runtime, serving
    from hgnn2_torch.graphs import GraphRecord

    cfg, dev, seed = ctx.cfg, ctx.device, ctx.seed
    runtime.setup()
    ctx.phase("torch and the port imported")
    mols = frozen.synthetic_qm9_like(ctx.traffic["pool"], seed)
    ctx.phase("molecules made")
    records = [GraphRecord(x=m.x, adj=m.adj, y=m.y) for m in mols]
    mean, std = common.target_stats(mols, cfg["task"])
    params, buffers = common.draw_weights(
        ctx.ref.param_spec(cfg), ctx.ref.buffer_spec(cfg), seed, dev)
    k_max = max(r.max_degree() for r in records) + 1
    model = ctx.port.build(cfg, dev, k_max)
    model.load_state_dict({**params, **buffers})
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bundle")
        ctx.port.save(path, model, records, cfg, mean, std)
        del model
        sm = serving.load_bundle(path, device=dev)
    ctx.phase("bundle saved and loaded")
    srv = Server(sm, mols, records, params, buffers, mean, std, [0.0], ctx.trace)
    orig_build = sm.build_batch

    def build_batch(recs, spec):
        t = time.perf_counter()
        with tracing.span("bench.build_batch", srv.trace):
            out = orig_build(recs, spec)
        srv.built[0] += time.perf_counter() - t
        return out

    sm.build_batch = build_batch
    # each bucket the traffic reaches, as its smallest, its largest and its
    # most-atom requests route them, twice
    sizes = sorted({1, ctx.traffic["min_records"], ctx.traffic["max_records"]})
    most = sorted(reqs, key=lambda r: -sum(m.n_nodes
                                          for m in mols[r[1]:r[1] + r[2]]))[:3]
    for _ in range(2):
        for n in sizes:
            sm.predict(records[:n])
        for _, lo, n in most:
            sm.predict(records[lo:lo + n])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return srv


def window(srv: Server, reqs, n_trace: int = 0) -> dict:
    """Serves ``reqs`` as they fall due and drains them; profiles n_trace
    requests from the first quarter's end. The profiler's start and stop
    pause the server: every later due time moves by those pauses, so the
    slice and the rest meet the cell's own load, not a backlog."""
    n = len(reqs)
    lo_trace = n // 4
    out = dict(lat=[], answers=[None] * n, late=[], failed=0,
               spans={"queue_wait_s": [], "build_s": []})
    sl = tracing.Slice(False)
    t0 = time.perf_counter()
    i = 0
    while i < n:
        if n_trace and i == lo_trace:
            t = time.perf_counter()
            sl = tracing.Slice(True).__enter__()
            t0 += time.perf_counter() - t
            for j in range(i, i + n_trace):
                _serve(srv, reqs, j, t0, out)
            t = time.perf_counter()
            sl.__exit__(None, None, None)
            t0 += time.perf_counter() - t
            i += n_trace
            continue
        _serve(srv, reqs, i, t0, out)
        i += 1
    out["window_s"] = time.perf_counter() - t0
    out["summary"] = sl.summary(n_trace)
    return out


def _serve(srv: Server, reqs, j: int, t0: float, out: dict) -> None:
    """Serves request j when it is due."""
    due_s, lo, k = reqs[j]
    due = t0 + due_s
    now = time.perf_counter()
    if now < due:
        with tracing.span("bench.wait_arrival", srv.trace):
            time.sleep(due - now)
    start = time.perf_counter()
    if now < due:
        out["late"].append(start - due)
    srv.built[0] = 0.0
    try:
        with tracing.span("bench.predict", srv.trace):
            pred = np.asarray(srv.sm.predict(srv.records[lo:lo + k]))
        ok = pred.shape == (k,)
    except (RuntimeError, ValueError) as e:
        print(f"request {j} ({k} records) failed: {e!r}", file=sys.stderr,
              flush=True)
        ok = False
    end = time.perf_counter()
    out["spans"]["queue_wait_s"].append(start - due)
    out["spans"]["build_s"].append(srv.built[0])
    if ok:
        out["lat"].append(end - due)
        out["answers"][j] = pred
    else:
        out["lat"].append(math.inf)
        out["failed"] += 1


def p95_ms(lat: list) -> float:
    """The 95th percentile (nearest rank) of the latencies, in ms."""
    ms = sorted(x * 1e3 for x in lat)
    return ms[max(0, math.ceil(0.95 * len(ms)) - 1)]


def run(ctx) -> dict:
    dev = ctx.device
    reqs = arrivals.requests(ctx.traffic, ctx.seed, ctx.seconds,
                             ctx.traffic["pool"])
    srv = setup(ctx, reqs)
    setup_s = time.perf_counter() - ctx.t_start
    n = len(reqs)
    n_trace = min(ctx.traffic["trace_requests"], n // 2) if ctx.trace else 0
    w = window(srv, reqs, n_trace)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ms = sorted(x * 1e3 for x in w["lat"])
    late = w["late"]
    ctx.log(f"window: {n} requests ({sum(r[2] for r in reqs)} molecules) in "
            f"{w['window_s']:.3f} s, p50 {ms[n // 2]:.3f} ms, p95 "
            f"{p95_ms(w['lat']):.3f} ms, max {ms[-1]:.3f} ms; generator late "
            f"(server idle) mean {1e3 * float(np.mean(late)) if late else 0.0:.4f}"
            f" ms over {len(late)} requests; setup {setup_s:.3f} s; peak {peak} B")
    srv.sm = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = {"pred_gap": check(ctx, srv, reqs, w["answers"])}
    ctx.log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    # the spans of the requests before the traced slice, which the
    # profiler's own cost does not reach
    spans = {k: v[:n // 4] if n_trace else v for k, v in w["spans"].items()}
    return dict(e2e={"serve_p95_ms": p95_ms(w["lat"]), "setup_s": setup_s},
                attempted=n, failed=w["failed"], checks=checks, peak=peak,
                trace=w["summary"], work=None, spans=spans)


def check(ctx, srv: Server, reqs, answers) -> float:
    """The widest gap of an answered molecule's prediction to the
    reference's (every answered request)."""
    done = [j for j in range(len(reqs)) if answers[j] is not None]
    if not done:
        return math.inf
    flat = [m for j in done for m in srv.mols[reqs[j][1]:reqs[j][1] + reqs[j][2]]]
    want = common.predict(ctx.ref, srv.params, srv.buffers, flat, srv.mean,
                          srv.std, ctx.device)
    return gap(np.concatenate([answers[j] for j in done]), want)


def gap(got: np.ndarray, want: np.ndarray) -> float:
    """The widest relative gap of a prediction to the reference's, each
    against the larger of its reference's magnitude and the median one."""
    med = float(np.median(np.abs(want)))
    return float(np.max(np.abs(got.astype(np.float64) - want)
                        / np.maximum(np.abs(want), max(med, 1e-30))))
