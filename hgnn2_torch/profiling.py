"""Profiling and roofline accounting (counterpart of
hgnn2_tpu/profiling.py): a step timer that waits for the device, edges/s
and bytes/edge accounting for aggregation passes, the card's data-sheet
peaks, a torch.profiler trace context, and the port's host spans
(span, spans), which record only while a torch.profiler session does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import threading
import time
from typing import Callable, NamedTuple

import torch
from torch._C._profiler import _RecordFunctionFast

# ------------------------------------------------------------------ spans

SPAN_LIMIT = 65_536  # records a profiled session keeps; later ones are dropped

_autograd_profiler = torch.autograd.profiler
_OFF = contextlib.nullcontext()


class SpanRecord(NamedTuple):
    """One span of a profiled session: its name, its start and end on
    time.perf_counter_ns's clock (end None while it is open) and the index
    of the span it opened in (None at the top)."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None


class _Session:
    """The records of one profiled session, SPAN_LIMIT at most, and the
    count of spans dropped past it."""

    def __init__(self):
        self.records: list[list] = []
        self.dropped = 0


_session = _Session()
_open = threading.local()  # each thread's open spans: (session, index)
_watching = False


def _watch_profiler_starts() -> None:
    """Start a new session of records at each profiler start, by wrapping
    the hook that every torch.profiler start calls; installed once, at the
    first span that records (the first session's records start empty)."""
    global _watching
    _watching = True
    start = _autograd_profiler._run_on_profiler_start
    if getattr(start, "hgnn2_spans", False):
        return

    def run_on_profiler_start():
        global _session
        _session = _Session()
        start()

    run_on_profiler_start.hgnn2_spans = True
    _autograd_profiler._run_on_profiler_start = run_on_profiler_start


class _Span:
    """A span while a profiler records: a CPU op on the profiler's own
    timeline (_RecordFunctionFast, not a user annotation, so no row on the
    device's) and a record of the session."""

    __slots__ = ("name", "op", "session", "index")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if not _watching:
            _watch_profiler_starts()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        session = self.session = _session
        parent = stack[-1][1] if stack and stack[-1][0] is session else None
        self.op = _RecordFunctionFast(self.name)
        self.op.__enter__()
        if len(session.records) < SPAN_LIMIT:
            self.index = len(session.records)
            session.records.append([self.name, time.perf_counter_ns(), None,
                                    parent])
        else:
            self.index = None
            session.dropped += 1
        stack.append((session, self.index))
        return self

    def __exit__(self, *exc):
        if self.index is not None:
            self.session.records[self.index][2] = time.perf_counter_ns()
        _open.stack.pop()
        self.op.__exit__(*exc)
        return False


def span(name: str):
    """``with span(name):`` records the block as a host span while a
    torch.profiler session records (profile.start() to stop()): a range
    on the profiler's timeline, so a trace shows it beside the device's
    work, and a record that spans() returns. Otherwise it costs one flag
    read and a branch, and returns a shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def spans() -> list[SpanRecord]:
    """The span records of the last profiled session (the one running,
    if any), in the order the spans opened; clears nothing."""
    return [SpanRecord(*r) for r in _session.records]


def dropped_spans() -> int:
    """Spans of the last profiled session not recorded past SPAN_LIMIT."""
    return _session.dropped


@dataclasses.dataclass
class StepTiming:
    steps: int
    total_s: float

    @property
    def per_step_s(self) -> float:
        return self.total_s / max(self.steps, 1)

    def throughput(self, items_per_step: float) -> float:
        return items_per_step * self.steps / self.total_s


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def force_sync(out) -> None:
    """Wait until the devices of every tensor in ``out`` (a tensor or a
    nested dict, list or tuple of them) have finished their queued work.
    CUDA kernels run after the call that launches them returns, so a
    host clock read without this measures the enqueue. CPU tensors need
    no wait."""
    for dev in {t.device for t in _tensors(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def time_steps(fn: Callable, *args, steps: int = 20,
               warmup: int = 2) -> StepTiming:
    """Host-clock time of ``steps`` calls of fn(*args), after ``warmup``
    calls, each end waiting for the device (force_sync on the output).
    Repeating the same arguments measures an upper bound on throughput."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    force_sync(out)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = fn(*args)
    force_sync(out)
    return StepTiming(steps=steps, total_s=time.perf_counter() - t0)


def time_scan_steps(step_fn: Callable, batch, steps: int = 20,
                    warmup: int = 2) -> StepTiming:
    """Host-clock time of ``steps`` calls of a stateful step function
    step_fn(batch) -> metrics (training.train.make_multi_train_step, whose
    state lives in the model and optimizer), after ``warmup`` calls; both
    ends wait for the device (force_sync). JAX's threads its state through
    the calls and returns it too."""
    out = None
    for _ in range(warmup):
        out = step_fn(batch)
    force_sync(out)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = step_fn(batch)
    force_sync(out)
    return StepTiming(steps=steps, total_s=time.perf_counter() - t0)


@dataclasses.dataclass
class AggregationRoofline:
    """Roofline model for one multi-operator aggregation pass."""

    n_edges: int  # real (unpadded) directed edges
    n_nodes: int
    feature_dim: int
    dense_block: tuple | None = None  # (B, N) when dense-block layout

    def flops(self, n_operators: int = 1) -> int:
        if self.dense_block:
            b, n = self.dense_block
            return 2 * b * n * n * self.feature_dim * n_operators
        return 2 * self.n_edges * self.feature_dim * n_operators

    def bytes_moved(self, dtype_bytes: int = 4) -> int:
        if self.dense_block:
            b, n = self.dense_block
            return dtype_bytes * (b * n * n + 2 * b * n * self.feature_dim)
        return dtype_bytes * (
            3 * self.n_edges + 2 * self.n_nodes * self.feature_dim
        )

    def edges_per_s(self, timing: StepTiming) -> float:
        return self.n_edges / timing.per_step_s

    def bytes_per_edge(self) -> float:
        return self.bytes_moved() / max(self.n_edges, 1)


# Peaks of the cards the port targets, keyed by a lower-case substring of
# torch.cuda.get_device_name(). NVIDIA H100 Tensor Core GPU data sheet,
# SXM part, dense rates without sparsity, at its 700 W limit: bf16 and
# fp16 989 TFLOP/s, TF32 495, float32 outside the tensor cores 67; HBM3
# 3.35 TB/s. A card set below 700 W runs slower under load.
_CARD_PEAK_FLOPS = {
    "h100 80gb hbm3": {"bfloat16": 989e12, "float16": 989e12,
                       "tf32": 495e12, "float32": 67e12},
}
_CARD_PEAK_HBM = {"h100 80gb hbm3": 3.35e12}


def _card_peak(table: dict):
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name().lower()
    return next((v for k, v in table.items() if k in name), None)


def chip_peak_flops(dtype: str = "bfloat16") -> float | None:
    """Peak FLOP/s of the current CUDA card for dtype ('bfloat16',
    'float16', 'tf32', 'float32'), or None on the CPU and on a card not in
    the table. MFU = achieved / this."""
    peaks = _card_peak(_CARD_PEAK_FLOPS)
    return None if peaks is None else peaks[dtype]


def mfu(flops_per_s: float, dtype: str = "bfloat16") -> float | None:
    """Model-FLOP utilization: achieved FLOP/s over the card's peak."""
    peak = chip_peak_flops(dtype)
    return None if peak is None else flops_per_s / peak


def chip_peak_hbm_bytes_per_s() -> float | None:
    """Peak HBM bandwidth of the current CUDA card, or None (CPU,
    unknown card)."""
    return _card_peak(_CARD_PEAK_HBM)


def hbm_utilization(bytes_per_s: float) -> float | None:
    """Achieved memory traffic over the card's peak bandwidth, the
    roofline metric of a bandwidth-bound aggregation pass."""
    peak = chip_peak_hbm_bytes_per_s()
    return None if peak is None else bytes_per_s / peak


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "hgnn2_trace")):
    """torch.profiler over the block (CPU activity, and CUDA's where there
    is a card); yields the profiler, whose key_averages() the caller reads
    after the block. The profiler stops and its chrome trace goes to
    log_dir/trace.json in a ``finally``, so a block that raises still
    leaves its trace (the exception propagates); it holds the port's
    hgnn2.* spans as CPU ops. The default directory is JAX's,
    /tmp/hgnn2_trace on Linux, outside the working tree."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
